"""Gluon blocks as ``torch.nn.Module``s (counterpart of
``mxnet_tpu/gluon/block.py``).

Naming: a block's ``prefix`` follows Gluon's ``_BlockScope`` rules, so that
a parameter's Gluon name is the prefix of the block that owns it plus the
parameter's short name (``conv2d0_`` + ``weight``).  The weight converter
(``model_zoo/convert.py``) matches the JAX package's parameters by these
names.  The rules: a block created inside ``parent.name_scope()`` gets
``parent.prefix + prefix``, and an unnamed block the next
``<alias><count>_`` of the parent's counters.  A block created with
``prefix=""`` has no scope of its own: children created inside its
``name_scope()`` are counted in the enclosing scope.  A block created
outside every scope is a root; its prefix is ``prefix`` or "", so that
names come out relative to it, as the JAX names are once the root's
prefix is stripped.

Two ways in.  Called on tensors, a block is a plain module: the train
steps (``gluon.functional``, ``train_fused``) run it under
``functional_call`` and set its mode themselves.  Called on NDArrays (the
imperative frontend), ``__call__`` sets the block's mode from
``autograd.is_training()`` (BatchNorm's batch statistics, Dropout), runs
it with a graph only inside ``autograd.record()``, completes deferred
shapes from the inputs, and returns NDArrays.  A user block writes
``hybrid_forward(F, x, ..., **params)`` with ``F`` the port's ``nd`` and
its ``self.params.get`` parameters passed by attribute name.

``hybridize()`` (the JAX package's CachedOp) is ROADMAP A4.1 and raises.
"""
from __future__ import annotations

import contextlib
import re
import threading

import torch

from .. import autograd
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "HybridSequential", "imperative_active"]

_scope = threading.local()
_imperative = threading.local()


def imperative_active():
    """True inside a block called on NDArrays (the imperative frontend)."""
    return getattr(_imperative, "depth", 0) > 0


def _create_prefix(prefix, hint):
    parent = getattr(_scope, "block", None)
    if parent is None:
        return "" if prefix is None else prefix
    if prefix is None:
        count = parent._counter.get(hint, 0)
        parent._counter[hint] = count + 1
        prefix = "%s%d_" % (hint, count)
    return parent.prefix + prefix


def _flatten(args):
    from ..ndarray.ndarray import NDArray

    if isinstance(args, (list, tuple)):
        return [x for a in args for x in _flatten(a)]
    return [args] if isinstance(args, NDArray) else []


def _wrap(out):
    from ..ndarray.ndarray import NDArray

    if isinstance(out, torch.Tensor):
        return NDArray(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_wrap(o) for o in out)
    return out


def _unwrap(v):
    from ..ndarray.ndarray import NDArray

    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, (list, tuple)):
        return type(v)(_unwrap(x) for x in v)
    return v


class HybridBlock(torch.nn.Module):
    """``torch.nn.Module`` with a Gluon ``prefix``, ``name_scope()`` and
    Parameters.

    ``gluon_params`` names the block's own parameters and buffers by their
    Gluon short names; each is the module attribute of the same name (a
    user parameter whose short name is taken by another attribute is
    stored under ``_t_<short>``).

    A block is built in eval mode (``training`` False), as a Gluon block
    runs in predict mode outside ``autograd.record()``: BatchNorm uses its
    running statistics until a train step (or the caller's ``train()``,
    or a call on NDArrays inside ``autograd.record()``) turns training
    mode on."""

    gluon_params = ()

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self.training = False
        self._empty_prefix = prefix == ""
        self.prefix = _create_prefix(prefix, self._alias())
        self._counter = {}
        self._short2attr = {}
        self._reg_params = {}
        self._params = ParameterDict(self.prefix, shared=params, block=self)

    def _alias(self):
        return type(self).__name__.lower()

    @property
    def name(self):
        return self.prefix[:-1] if self.prefix.endswith("_") else self.prefix

    @contextlib.contextmanager
    def name_scope(self):
        if self._empty_prefix:
            yield
            return
        old = getattr(_scope, "block", None)
        _scope.block = self
        try:
            yield
        finally:
            _scope.block = old

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    # -- parameters ---------------------------------------------------------------
    @property
    def params(self):
        """This block's own Parameters (not its children's)."""
        self._sync_params()
        return self._params

    def _register_gluon_tensor(self, short, tensor, buffer):
        """Register ``tensor`` as this block's ``short`` and return it."""
        attr = self._short2attr.get(short)
        if attr is None:
            taken = short in self.__dict__ and not isinstance(
                self.__dict__[short], (torch.Tensor, type(None)))
            attr = "_t_" + short if taken else short
            self._short2attr[short] = attr
        if attr in self._parameters:
            del self._parameters[attr]
        if attr in self._buffers:
            del self._buffers[attr]
        self.__dict__.pop(attr, None)
        if buffer:
            self.register_buffer(attr, tensor.detach() if isinstance(
                tensor, torch.nn.Parameter) else tensor)
        else:
            self.register_parameter(attr, tensor if isinstance(tensor, torch.nn.Parameter)
                                    else torch.nn.Parameter(tensor))
        if short not in self.gluon_params:
            self.gluon_params = tuple(self.gluon_params) + (short,)
        return getattr(self, attr)

    def _gluon_tensor(self, short):
        return getattr(self, self._short2attr.get(short, short))

    def _declare(self, short, shape, device, fill=None, init=None, grad_req="write",
                 buffer=False):
        """A built-in layer's parameter ``short``: a ``torch.nn.Parameter``
        (with ``grad_req`` "null" one that takes no gradient) or, with
        ``buffer``, a buffer.  With ``device`` (the layer was given its
        whole shape) the tensor is made now, filled with ``fill`` (None:
        left for an initializer); else it waits for ``initialize``, or,
        with 0s in ``shape``, for the first forward."""
        p = Parameter(self.prefix + short, grad_req=grad_req, shape=shape, init=init,
                      allow_deferred_init=True)
        p._owner = (self, short)
        self._params._add(p)
        self.gluon_params = tuple(self.gluon_params) + (short,)
        if device is None:
            (self.register_buffer if buffer else self.register_parameter)(short, None)
            return p
        t = (torch.empty(shape, device=device) if fill is None
             else torch.full(shape, float(fill), device=device))
        if not buffer:
            t = torch.nn.Parameter(t, requires_grad=grad_req != "null")
        p._adopt(self._register_gluon_tensor(short, t, buffer))
        return p

    def _complete(self, in_dim, device):
        """Complete every deferred shape of this layer with the input's
        dimension ``in_dim`` and make the tensors (first forward)."""
        for short in self.gluon_params:
            p = self._params[self.prefix + short]
            if p._var is None:
                shape = tuple(in_dim if s == 0 else s for s in p.shape)
                if p._deferred_init is None and not p._initialized:
                    raise deferred_error(self)
                p._finish_deferred_init(shape, device)

    def _sync_params(self):
        """Give every tensor of ``gluon_params`` made by the layer itself
        its Parameter (a parameter made through ``params.get`` has one)."""
        for short in self.gluon_params:
            full = self.prefix + short
            t = self._gluon_tensor(short)
            p = self._params._params.get(full)
            if p is None:
                buffer = not isinstance(t, torch.nn.Parameter) or not t.requires_grad
                p = Parameter(full, grad_req="null" if buffer else "write",
                              shape=None if t is None else tuple(t.shape),
                              allow_deferred_init=True)
                p._owner = (self, short)
                self._params._add(p)
            if t is not None and (p._var is None or p._var._data is not t):
                p._adopt(t, initialized=p._initialized)

    def _mark_initialized(self):
        """Count every parameter of this block and its children as
        initialized (the model zoo's own initialization filled them)."""
        for p in self.collect_params().values():
            if p._var is not None:
                p._initialized = True

    def collect_params(self, select=None):
        """Every Parameter of this block and its children, by Gluon name
        (reference block.py:278); ``select`` a regular expression that the
        names must match."""
        ret = ParameterDict(self.prefix)
        pattern = re.compile(select) if select is not None else None
        for m in self.modules():
            if isinstance(m, HybridBlock):
                for n, p in m.params.items():
                    if pattern is None or pattern.match(n):
                        ret._params.setdefault(n, p)
        return ret

    def initialize(self, init=None, ctx=None, verbose=False, force_reinit=False):
        """Initialize every parameter on ``ctx`` (None: the current context);
        those of a deferred shape at the first forward."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def _params_with_attr_names(self, prefix=""):
        ret = {}
        for m_name, m in self.named_modules(prefix=prefix):
            if isinstance(m, HybridBlock):
                m._sync_params()
                for short in m.gluon_params:
                    p = m._params._params[m.prefix + short]
                    ret[(m_name + "." if m_name else "") + short] = p
        return ret

    def save_parameters(self, filename):
        """Save every initialized parameter, by its attribute path
        (reference block.py save_parameters)."""
        from ..ndarray import save as nd_save

        nd_save(filename, {k: p._var._data for k, p in self._params_with_attr_names().items()
                           if p._var is not None})

    def load_parameters(self, filename, ctx=None, allow_missing=False, ignore_extra=False):
        """Load ``save_parameters``' file (reference block.py:397)."""
        from ..ndarray import load as nd_load

        loaded = nd_load(filename)
        params = self._params_with_attr_names()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise IOError("Parameter '%s' is missing in file '%s'" % (name, filename))
        for name, arr in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise IOError("Parameter '%s' loaded from '%s' is not present in the "
                                  "Block" % (name, filename))
                continue
            params[name].set_data(arr)

    save_params = save_parameters
    load_params = load_parameters

    def hybridize(self, active=True, **kwargs):
        raise NotImplementedError(
            "hybridize (the JAX package's CachedOp) is not ported: ROADMAP A4.1; the "
            "block runs eagerly")

    def cast(self, dtype):
        """Cast every floating parameter and buffer (BatchNorm's running
        statistics included) to ``dtype``, a ``torch.dtype`` or its name
        (``"bfloat16"``), in place; returns the block.  Counterpart of the
        JAX ``Block.cast``, whose ``Parameter.cast`` casts the running
        statistics too."""
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        if not (isinstance(dtype, torch.dtype) and dtype.is_floating_point):
            raise ValueError("cast: a floating dtype is needed, got %r" % (dtype,))
        return self.to(dtype=dtype)

    def gluon_named_tensors(self):
        """{Gluon name relative to this block: parameter or buffer}; a
        tensor of a deferred shape not made yet is None."""
        out = {}
        for m in self.modules():
            if isinstance(m, HybridBlock):
                for short in m.gluon_params:
                    name = m.prefix + short
                    if not name.startswith(self.prefix):
                        raise ValueError("%s is outside the prefix %r"
                                         % (name, self.prefix))
                    rel = name[len(self.prefix):]
                    if rel in out:
                        raise ValueError("two tensors share the name %r" % rel)
                    out[rel] = m._gluon_tensor(short)
        return out

    # -- execution --------------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if _flatten(list(args) + list(kwargs.values())):
            return self._imperative_call(args, kwargs)
        return super().__call__(*args, **kwargs)

    def _has_hybrid_forward(self):
        return type(self).hybrid_forward is not HybridBlock.hybrid_forward

    def _imperative_call(self, args, kwargs):
        """The block on NDArrays: the mode from ``autograd``, a graph only
        while recording, NDArrays out."""
        from .. import ndarray as nd

        _imperative.depth = getattr(_imperative, "depth", 0) + 1
        try:
            if self._has_hybrid_forward():
                params = {name: p.data() for name, p in self._reg_params.items()}
                return self.hybrid_forward(nd, *args, **kwargs, **params)
            training = autograd.is_training()
            if self.training != training:
                self.train(training)
            with autograd.grad_mode():
                out = super().__call__(*_unwrap(args), **{k: _unwrap(v)
                                                          for k, v in kwargs.items()})
            return _wrap(out)
        finally:
            _imperative.depth -= 1

    def forward(self, *args, **kwargs):
        if self._has_hybrid_forward():
            raise TypeError("%s runs on NDArrays (its hybrid_forward takes F = nd): call it "
                            "on NDArrays" % type(self).__name__)
        raise NotImplementedError

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


Block = HybridBlock


class HybridSequential(HybridBlock):
    """Stack of blocks run in order (reference basic_layers.py:80)."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)


def deferred_error(block):
    return DeferredInitializationError(
        "%s: a parameter of deferred shape was never initialized; call initialize() "
        "before the first forward" % type(block).__name__)
