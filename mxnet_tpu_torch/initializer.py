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

Ported: ``Zero``, ``One``, ``Constant``, ``Uniform``, ``Normal``, ``Xavier``,
``MSRAPrelu``.  The others (``Orthogonal``, ``Bilinear``, ``LSTMBias``,
``Mixed``, ``Load``, ``FusedRNN``) are ROADMAP A11.
"""
from __future__ import annotations

import json
import math

import torch

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform", "Normal",
           "Xavier", "MSRAPrelu", "create", "register"]

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
        raise NotImplementedError("initializer %r is not ported (ROADMAP A11); ported: %s"
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
    def __init__(self, value=0.0, generator=None):
        super().__init__(generator, value=value)
        self.value = value

    def _init_weight(self, _, arr):
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
