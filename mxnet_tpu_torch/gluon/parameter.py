"""Parameter, Constant and ParameterDict (counterpart of
``mxnet_tpu/gluon/parameter.py``; reference python/mxnet/gluon/parameter.py).

A Parameter owns one tensor of its block: a ``torch.nn.Parameter``
(``grad_req`` "write" or "add") or a buffer (``grad_req`` "null": running
statistics, frozen weights), registered on the block under the
parameter's short name, so that ``state_dict``, ``functional_call`` and the
block's own ``forward`` see the same storage.  ``data()`` is an NDArray
over that tensor; ``grad()`` the gradient buffer that ``autograd.backward``
writes.

Deferred initialization is kept: a shape with 0s (a ``Conv2D`` without
``in_channels``) is completed by the block at its first forward, and the
tensor is made then, on the device ``initialize`` was given.  A layer made
with its whole shape allocates the tensor at once; it counts as
initialized only after ``initialize``, ``set_data`` / ``load``, or the
model zoo's own initialization (``_mark_initialized``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import initializer as init_mod
from .. import random as _random
from ..base import MXNetError
from ..context import as_device
from ..ndarray import load as nd_load, save as nd_save
from ..ndarray.ndarray import NDArray
from ..ops.elemwise import to_dtype

__all__ = ["Parameter", "Constant", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(MXNetError):
    """A parameter read before its shape is known (reference parameter.py:35)."""


def _tensor_of(value):
    if isinstance(value, NDArray):
        return value._data
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


class Parameter:
    """A trainable (or auxiliary) tensor with its initializer, ``grad_req``
    and learning-rate / weight-decay multipliers (reference
    gluon/parameter.py:43)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32", lr_mult=1.0,
                 wd_mult=1.0, init=None, allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        if stype != "default" or grad_stype != "default":
            raise NotImplementedError("sparse parameters are not ported (ROADMAP A8.4)")
        self.name = name
        self.shape = None if shape is None else tuple(
            (shape,) if isinstance(shape, int) else shape)
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._grad_req = grad_req if differentiable else "null"
        self.allow_deferred_init = allow_deferred_init
        self._var = None               # NDArray over the block's tensor
        self._initialized = False
        self._deferred_init = None     # (init, device, default_init)
        self._owner = None             # (block, short name)

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self.shape, self.dtype)

    # -- ownership -------------------------------------------------------------
    def _attach(self, block, short):
        self._owner = (block, short)
        if self._var is not None:
            block._register_gluon_tensor(short, self._var._data, self._grad_req == "null")

    def _adopt(self, tensor, initialized=False):
        """Take ``tensor`` (a block's own) as this parameter's data."""
        self._var = NDArray(tensor)
        self.shape = tuple(tensor.shape)
        self._initialized = initialized
        self._deferred_init = None
        if self._grad_req != "null" and tensor.requires_grad:
            autograd._mark_variable(self._var)
            self._var._grad_req = self._grad_req

    def _make(self, device):
        """Allocate the tensor (zeros) on ``device`` and register it."""
        t = torch.zeros(self.shape, dtype=to_dtype(self.dtype), device=device)
        if self._grad_req != "null":
            t = torch.nn.Parameter(t)
        if self._owner is not None:
            block, short = self._owner
            t = block._register_gluon_tensor(short, t, self._grad_req == "null")
        self._adopt(t)

    # -- grad_req --------------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null, got %r" % req)
        self._grad_req = req
        if self._var is not None:
            self._var._grad_req = req
            if req == "null":
                self._var.grad = None
            elif self._var._data.requires_grad:
                autograd._mark_variable(self._var)

    # -- initialization ---------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None, force_reinit=False):
        """Fill the parameter from its initializer (``self.init``, else
        ``init``, else ``default_init``, else ``Uniform()``) on ``ctx``
        (None: the current context); with an unknown shape, defer to the
        block's first forward."""
        default_init = default_init or init_mod.Uniform()
        if self._initialized and not force_reinit:
            return
        device = as_device(ctx)
        if self._var is None and (self.shape is None or any(s == 0 for s in self.shape)):
            if self.allow_deferred_init:
                self._deferred_init = (init, device, default_init)
                return
            raise DeferredInitializationError(
                "Cannot initialize Parameter '%s' because it has invalid shape %s."
                % (self.name, self.shape))
        self._finish_init(init, device, default_init)

    def _finish_init(self, init, device, default_init):
        if self._var is None:
            self._make(device)
        elif self._var._data.device != device:
            raise ValueError("Parameter '%s' lives on %s; initialize(ctx=%s) cannot move it"
                             % (self.name, self._var._data.device, device))
        initializer = self.init or init or default_init
        if isinstance(initializer, str):
            initializer = init_mod.create(initializer)
        # a random rule without its own generator draws from mx.random's
        own = initializer._generator
        if own is None:
            initializer._generator = _random.generator("cpu")
        try:
            initializer(init_mod.InitDesc(self.name), self._var._data)
        finally:
            initializer._generator = own
        self._initialized = True
        self._deferred_init = None

    def _finish_deferred_init(self, shape, device=None):
        """Complete the shape (the block saw its input) and initialize."""
        self.shape = tuple(int(s) for s in shape)
        if self._deferred_init is None:
            if self._var is None:
                raise RuntimeError(
                    "Parameter '%s' has not been initialized. You should initialize "
                    "parameters with Block.initialize() before use." % self.name)
            return
        init, dev, default_init = self._deferred_init
        self._finish_init(init, dev if dev is not None else device, default_init)

    def _check_initialized(self):
        if self._var is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter '%s' has not been initialized yet because initialization "
                    "was deferred. Actual initialization happens during the first "
                    "forward pass." % self.name)
            raise RuntimeError(
                "Parameter '%s' has not been initialized. You should initialize "
                "parameters with Block.initialize() before use." % self.name)

    # -- access ------------------------------------------------------------------
    def data(self, ctx=None):
        self._check_initialized()
        return self._var

    def grad(self, ctx=None):
        """The gradient buffer (zeros until a backward writes it)."""
        self._check_initialized()
        if self._grad_req == "null":
            raise RuntimeError("Cannot get gradient array for Parameter '%s' because "
                               "grad_req='null'" % self.name)
        if self._var.grad is None:
            self._var.grad = NDArray(torch.zeros_like(self._var._data.detach()))
        return self._var.grad

    def list_ctx(self):
        self._check_initialized()
        return [self._var.context]

    def zero_grad(self):
        if self._var is not None and self._var.grad is not None:
            self._var.grad._data.zero_()

    def set_data(self, data):
        """Write ``data`` into the parameter; before initialization (a
        deferred shape) this makes the tensor, on the device
        ``initialize`` was given, else ``data``'s."""
        t = _tensor_of(data)
        if self._var is None:
            dev = self._deferred_init[1] if self._deferred_init else t.device
            self.shape = tuple(t.shape)
            self._make(dev)
        if tuple(t.shape) != self._var.shape:
            raise ValueError("Shape mismatch for Parameter '%s': expected %s, got %s"
                             % (self.name, self._var.shape, tuple(t.shape)))
        with torch.no_grad():
            self._var._data.copy_(t)
        self._initialized = True
        self._deferred_init = None



class Constant(Parameter):
    """A parameter that takes no gradient and holds ``value`` (reference
    gluon/parameter.py Constant)."""

    def __init__(self, name, value):
        t = _tensor_of(value)
        self.value = t

        class _CInit(init_mod.Initializer):
            def __call__(self, desc, arr):
                self._fill(arr, t)

        super().__init__(name, grad_req="null", shape=tuple(t.shape),
                         dtype=str(t.dtype).replace("torch.", ""), init=_CInit(),
                         differentiable=False)


class ParameterDict:
    """Ordered name -> Parameter mapping with a prefix (reference
    parameter.py:630).  ``get(name, ...)`` makes ``prefix + name`` if it
    does not exist; the dict of a block registers what it makes on it."""

    def __init__(self, prefix="", shared=None, block=None):
        self._prefix = prefix
        self._params = {}
        self._shared = shared
        self._block = block

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        return "ParameterDict '%s' (\n%s\n)" % (
            self._prefix, "\n".join("  %s" % p for p in self._params.values()))

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __contains__(self, k):
        return k in self._params

    def __getitem__(self, key):
        return self._params[key]

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name, **kwargs):
        """Get or make ``prefix + name`` (reference parameter.py:743)."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
            if self._block is not None:
                param._attach(self._block, name)
            return param
        for k, v in kwargs.items():
            if v is None:
                continue
            if k == "shape" and param.shape is not None:
                v = tuple(v)
                if len(v) != len(param.shape) or any(
                        a and b and a != b for a, b in zip(param.shape, v)):
                    raise AssertionError("Parameter '%s' already has shape %s; cannot "
                                         "re-get with shape %s" % (full, param.shape, v))
                param.shape = tuple(a if a else b for a, b in zip(param.shape, v))
            elif hasattr(param, k):
                setattr(param, k, v)
        return param

    def get_constant(self, name, value=None):
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            if value is None:
                raise KeyError("No constant named '%s'" % full)
            param = Constant(full, value)
            self._params[full] = param
            if self._block is not None:
                param._attach(self._block, name)
        return param

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def _add(self, param):
        self._params[param.name] = param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update self with other because they have "
                                 "different Parameters with the same name '%s'" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False, force_reinit=False):
        """Initialize every parameter; ``init`` is the default of those
        without their own."""
        for p in self.values():
            p.initialize(None, ctx, init or init_mod.Uniform(), force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def save(self, filename, strip_prefix=""):
        """Save the initialized parameters by name (``ndarray.save``)."""
        arg = {}
        for p in self.values():
            if p._var is None:
                continue
            name = p.name[len(strip_prefix):] if strip_prefix and \
                p.name.startswith(strip_prefix) else p.name
            arg[name] = p._var._data
        nd_save(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False, ignore_extra=False,
             restore_prefix=""):
        loaded = {restore_prefix + k: v for k, v in nd_load(filename).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise IOError("Parameter '%s' is missing in file '%s'" % (name, filename))
        for name, arr in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise IOError("Parameter '%s' loaded from file '%s' is not present in "
                                  "this ParameterDict" % (name, filename))
                continue
            self._params[name].set_data(arr)
