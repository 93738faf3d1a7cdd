"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``; reference
python/mxnet/initializer.py).

An initializer fills a tensor in place, dispatching on the parameter's name
as the reference does: ``*weight`` takes the initializer's rule, ``*bias``
and ``*beta`` 0, ``*gamma`` 1, ``*moving_mean`` 0 and ``*moving_var`` 1 (and
their ``running_*`` names); a ``__init__`` attribute on the variable names
another initializer for it.  Random rules draw from an explicit
``torch.Generator`` (the ``generator`` argument, else one of the
initializer's own seeded with 0), in float32 on that generator's device, and the values are copied to the tensor's device: the same
generator gives the same values on the CPU and the card.  The global random
state is never used.

The initializers: ``Zero``, ``One``, ``Constant``, ``Uniform``, ``Normal``,
``Orthogonal``, ``Xavier``, ``MSRAPrelu``, ``Bilinear`` (an upsampling
kernel), ``LSTMBias`` (the LSTM cells' i2h bias), ``FusedRNN`` (a fused RNN
cell's packed parameters), ``Mixed`` (by name pattern) and ``Load`` (from
saved arrays).
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias", "FusedRNN", "Mixed",
           "Load", "create", "register"]

_INIT_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one"}


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, *args, **kwargs):
    """An initializer by (case-insensitive) name, or ``name`` itself if it is
    one."""
    if isinstance(name, Initializer):
        return name
    key = _ALIASES.get(name.lower(), name.lower())
    if key not in _INIT_REGISTRY:
        raise ValueError("initializer %r is not registered (have %s)"
                         % (name, sorted(_INIT_REGISTRY)))
    return _INIT_REGISTRY[key](*args, **kwargs)


class InitDesc(str):
    """A parameter's name with its attributes (reference initializer.py
    InitDesc)."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


class Initializer:
    """Base initializer with the reference's name dispatch."""

    def __init__(self, generator=None, **kwargs):
        self._kwargs = kwargs
        self._generator = generator

    def dumps(self):
        """``[name, kwargs]`` as JSON: the form a variable's ``__init__``
        attribute takes."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    @property
    def generator(self):
        if self._generator is None:
            self._generator = torch.Generator().manual_seed(0)
        return self._generator

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a str or an InitDesc")
        init = getattr(desc, "attrs", {}).get("__init__", "")
        if init:
            klass, kwargs = json.loads(init)
            create(klass, generator=self.generator, **kwargs)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith(("bias", "beta", "moving_mean", "running_mean",
                            "moving_inv_var", "moving_avg", "min", "max")):
            self._fill(arr, 0.0)
        elif name.endswith(("gamma", "moving_var", "running_var")):
            self._fill(arr, 1.0)
        else:
            raise ValueError("Unknown initialization pattern for %s: the default "
                             "initialization knows weight, bias, gamma, beta and moving "
                             "statistics" % desc)

    @staticmethod
    def _fill(arr, values):
        """Write ``values`` (a tensor on any device, or a number) into
        ``arr``."""
        with torch.no_grad():
            if isinstance(values, torch.Tensor):
                arr.copy_(values)
            else:
                arr.fill_(values)

    def _uniform(self, shape, low, high):
        return torch.empty(shape, device=self.generator.device).uniform_(
            low, high, generator=self.generator)

    def _normal(self, shape, std):
        return torch.empty(shape, device=self.generator.device).normal_(
            0.0, std, generator=self.generator)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override _init_weight")


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        self._fill(arr, 0.0)


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        self._fill(arr, 1.0)


@register
class Constant(Initializer):
    """``value``: a number, or a sequence that broadcasts to the array."""

    def __init__(self, value=0.0, generator=None):
        super().__init__(generator, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        if isinstance(self.value, (list, tuple)):
            self._fill(arr, torch.tensor(self.value, dtype=torch.float32).expand(arr.shape))
        else:
            self._fill(arr, float(self.value))


@register
class Uniform(Initializer):
    """U(−scale, scale) (reference initializer.py:442)."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._fill(arr, self._uniform(arr.shape, -self.scale, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma²)."""

    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._fill(arr, self._normal(arr.shape, self.sigma))


@register
class Orthogonal(Initializer):
    """A scaled orthogonal matrix (reference initializer.py Orthogonal): the
    left or right singular vectors (whichever has the weight's shape) of a
    U(−1, 1) (``rand_type="uniform"``) or N(0, 1) draw of (out, in)."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        if self.rand_type == "uniform":
            tmp = self._uniform((nout, nin), -1.0, 1.0)
        else:
            tmp = self._normal((nout, nin), 1.0)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        res = u if tuple(u.shape) == tuple(tmp.shape) else v
        self._fill(arr, (self.scale * res).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Xavier / Glorot (reference initializer.py:545): scale
    √(magnitude / factor), the factor the fan in, the fan out or their mean,
    each counted over the kernel's spatial size; ``rnd_type`` "uniform"
    draws U(−scale, scale), "gaussian" N(0, scale²)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3, generator=None):
        super().__init__(generator, rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = tuple(arr.shape)
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim >= 2: %s %s" % (name, shape))
        hw_scale = math.prod(shape[2:]) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in, "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._fill(arr, self._uniform(shape, -scale, scale))
        elif self.rnd_type == "gaussian":
            self._fill(arr, self._normal(shape, scale))
        else:
            raise ValueError("Unknown random type %s" % self.rnd_type)


@register
class MSRAPrelu(Xavier):
    """Kaiming He's initialization: Xavier gaussian with magnitude
    2 / (1 + slope²)."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2), generator)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel (reference initializer.py Bilinear), for
    a Deconvolution weight (C, 1, k, k): ``(1 − |x/f − c|)·(1 − |y/f −
    c|)``, f = ceil(k / 2), c = (2f − 1 − f % 2) / 2f."""

    def _init_weight(self, _, arr):
        shape = tuple(arr.shape)
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(math.prod(shape))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))).astype(np.float32)
        self._fill(arr, torch.from_numpy(weight.reshape(shape)))


@register
class LSTMBias(Initializer):
    """An LSTM cell's i2h bias (reference initializer.py LSTMBias): 0 but
    for the forget gate's quarter (the second of i, f, c, o), which is
    ``forget_bias``."""

    def __init__(self, forget_bias=1.0, generator=None):
        super().__init__(generator, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        out = torch.zeros(arr.shape, dtype=torch.float32)
        num_hidden = arr.shape[0] // 4
        out[num_hidden:2 * num_hidden] = self.forget_bias
        self._fill(arr, out)


@register
class FusedRNN(Initializer):
    """A fused RNN cell's packed parameters (reference initializer.py
    FusedRNN): ``init`` (an Initializer, or its ``dumps()``) over the whole
    vector, ``Uniform(0.07)`` without one."""

    def __init__(self, init=None, num_hidden=0, num_layers=0, mode="lstm",
                 bidirectional=False, forget_bias=1.0, generator=None):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, generator=generator, **kwargs)
        super().__init__(generator, init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers, mode=mode,
                         bidirectional=bidirectional, forget_bias=forget_bias)
        self._init = init

    def _init_weight(self, desc, arr):
        init = self._init if self._init is not None else Uniform(0.07, self.generator)
        init._init_weight(desc, arr)


class Mixed:
    """The initializer of the first pattern (a regular expression) that a
    parameter's name matches (reference initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have the same length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError("Parameter name %s did not match any pattern. Add a '.*' pattern "
                         "as fallback." % name)


@register
class Load:
    """Values by name from a dict of arrays or an ``nd.save`` file (the
    ``arg:`` / ``aux:`` prefixes dropped), ``default_init`` for the rest
    (reference initializer.py Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load
            param = nd_load(param)
        self.param = {name.replace("arg:", "").replace("aux:", ""): arr
                      for name, arr in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            p = self.param[name]
            if tuple(p.shape) != tuple(arr.shape):
                raise ValueError("Parameter %s shape mismatch: %s vs %s"
                                 % (name, tuple(p.shape), tuple(arr.shape)))
            value = p._data if hasattr(p, "_data") else torch.as_tensor(np.asarray(p))
            Initializer._fill(arr, value.to(arr.dtype))
        elif self.default_init is None:
            raise ValueError("Cannot init %s: not found and no default_init" % name)
        else:
            self.default_init(name, arr)
