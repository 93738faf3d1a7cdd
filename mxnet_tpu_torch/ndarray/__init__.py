"""``mx.nd`` — the imperative operator frontend of the port (counterpart of
``mxnet_tpu/ndarray/__init__.py``; reference python/mxnet/ndarray/register.py).

One function per registered operator (aliases included), generated from
the registry as the JAX package generates its own: ``nd.<op>`` unwraps its
NDArray arguments, runs the op's PyTorch function (building an autograd
graph only inside ``autograd.record()``) and wraps the outputs; the
``_contrib_<op>`` ones also appear as ``nd.contrib.<op>``.  Attributes may
come as keywords or, past the tensor arguments, positionally.  ``ctx=``
places a creation op's result (default: the current context, the card
unless ``with mx.cpu():``), ``out=`` writes the result into an array.

The frontend fills the attributes that depend on its state: ``training``
from ``autograd.is_training()``, ``generator`` from
``mxnet_tpu_torch.random`` for the device of the call, ``device`` from the
context.

``save`` / ``load`` keep the JAX package's file layout (``utils``):
``load`` returns CPU tensors, as the port's checkpoint readers expect.
"""
from __future__ import annotations

import sys
import types

import numpy as np
import torch

from .. import autograd as _autograd
from .. import random as _random
from ..context import as_device, current_context
from ..ops import _load_all  # noqa: F401  (registers every ported op)
from ..ops import registry as _registry
from ..symbol.symbol import parse_attr
from .ndarray import NDArray, array, concatenate, empty, waitall
from .utils import load, save

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange", "concatenate",
           "waitall", "save", "load", "op", "contrib", "random", "maximum", "minimum",
           "zeros_like", "ones_like"]

# attributes of the reference's engine, taken and ignored
_IGNORED_ATTRS = frozenset({"name", "attr", "__layout__", "cudnn_tune", "cudnn_off",
                            "workspace", "layout"})

# ops whose tuple result shows fewer outputs unless an attribute asks
_VISIBLE_RULES = {
    "BatchNorm": lambda attrs: 3 if attrs.get("output_mean_var") else 1,
    "_sample_multinomial": lambda attrs: 2 if attrs.get("get_prob") else 1,
    "RNN": lambda attrs: ((3 if attrs.get("mode", "lstm") == "lstm" else 2)
                          if attrs.get("state_outputs") else 1),
}


def _unwrap(v):
    return v._data if isinstance(v, NDArray) else v


def _invoke_fn(fn, args, attrs, device=None, visible=None):
    """Run ``fn`` on the tensors of ``args`` (NDArrays or other values):
    with a graph while recording, without one otherwise; the outputs on
    ``device`` if given, wrapped."""
    with _autograd.grad_mode():
        res = fn(*[_unwrap(a) for a in args], **attrs)
    multi = isinstance(res, (tuple, list))
    outs = tuple(res) if multi else (res,)
    if device is not None:
        outs = tuple(o.to(device) for o in outs)
    nd_outs = [NDArray(o) for o in outs]
    if not multi:
        return nd_outs[0]
    if visible is not None:
        nd_outs = nd_outs[:visible]
    return nd_outs[0] if len(nd_outs) == 1 else nd_outs


def _call_device(args, ctx):
    """The device of a call: ``ctx``'s, else its first array's, else the
    current context's."""
    if ctx is not None:
        return as_device(ctx)
    for a in args:
        if isinstance(a, NDArray):
            return a._data.device
    return as_device(current_context())


def _invoke(opdef, args, kwargs):
    kwargs = dict(kwargs)
    out_arr = kwargs.pop("out", None)
    ctx = kwargs.pop("ctx", None)
    for k in _IGNORED_ATTRS & set(kwargs):
        kwargs.pop(k)
    args = list(args)
    if not opdef.variadic and opdef.arg_names:
        if len(args) > len(opdef.arg_names):
            # attributes given positionally after the tensors (nd.clip(x, 0, 1))
            extras = args[len(opdef.arg_names):]
            args = args[:len(opdef.arg_names)]
            free = [a for a in opdef.attr_names if a not in kwargs]
            if len(extras) > len(free) or any(isinstance(e, (NDArray, torch.Tensor))
                                              for e in extras):
                raise TypeError("%s takes at most %d tensor arguments (%d given)"
                                % (opdef.name, len(opdef.arg_names), len(args) + len(extras)))
            kwargs.update(zip(free, extras))
        named = dict(zip(opdef.arg_names, args))
        for an in opdef.arg_names:
            if an in kwargs:
                named[an] = kwargs.pop(an)
        args = [named.get(an, opdef.defaults.get(an)) for an in opdef.arg_names]
        while args and args[-1] is None and opdef.arg_names[len(args) - 1] not in named:
            args.pop()
    elif not opdef.arg_names and not opdef.variadic and args:
        free = [a for a in opdef.attr_names if a not in kwargs]
        kwargs.update(zip(free, args))
        args = []
    attrs = {k: parse_attr(v) if isinstance(v, str) else _unwrap(v) for k, v in kwargs.items()}
    device = None
    if "generator" in opdef.attr_names and attrs.get("generator") is None:
        attrs["generator"] = _random.generator(_call_device(args, ctx))
    if "training" in opdef.attr_names and "training" not in attrs:
        attrs["training"] = _autograd.is_training()
    if "device" in opdef.attr_names and attrs.get("device") is None:
        attrs["device"] = _call_device(args, ctx)
    elif ctx is not None:
        device = as_device(ctx)
    rule = _VISIBLE_RULES.get(opdef.name)
    result = _invoke_fn(opdef.fn, args, attrs, device=device,
                        visible=rule(attrs) if rule else None)
    if opdef.mutates:
        # the reference's mutable inputs (the optimizer updates): the extra
        # outputs are the new values of the named arguments, written back
        outs = result if isinstance(result, list) else [result]
        for i, mname in enumerate(opdef.mutates):
            idx = opdef.arg_names.index(mname)
            if idx < len(args) and isinstance(args[idx], NDArray):
                args[idx]._set_data(outs[1 + i]._data)
        result = outs[0]
    if out_arr is not None:
        out_arr._set_data((result[0] if isinstance(result, list) else result)._data)
        return out_arr
    return result


def _call(name, *args, **kwargs):
    """``nd.<name>(*args, **kwargs)``."""
    return _invoke(_registry.get(name), args, kwargs)


_SCALAR_OPS = {"add": ("_plus_scalar", "_plus_scalar"),
               "sub": ("_minus_scalar", "_rminus_scalar"),
               "mul": ("_mul_scalar", "_mul_scalar"),
               "div": ("_div_scalar", "_rdiv_scalar"),
               "mod": ("_mod_scalar", "_rmod_scalar"),
               "power": ("_power_scalar", "_rpower_scalar"),
               "maximum": ("_maximum_scalar", "_maximum_scalar"),
               "minimum": ("_minimum_scalar", "_minimum_scalar"),
               "equal": ("_equal_scalar", "_equal_scalar"),
               "not_equal": ("_not_equal_scalar", "_not_equal_scalar"),
               "greater": ("_greater_scalar", "_lesser_scalar"),
               "greater_equal": ("_greater_equal_scalar", "_lesser_equal_scalar"),
               "lesser": ("_lesser_scalar", "_greater_scalar"),
               "lesser_equal": ("_lesser_equal_scalar", "_greater_equal_scalar")}


def _binary_dispatch(name, lhs, rhs, reverse=False):
    """``lhs <name> rhs`` (``rhs <name> lhs`` with ``reverse``): the
    ``broadcast_<name>`` op for two arrays, the ``_<name>_scalar`` op (or
    its reflected form) for an array and a number, as MXNet's operators."""
    if isinstance(rhs, (int, float, bool, np.number)):
        return _call(_SCALAR_OPS[name][1 if reverse else 0], lhs, scalar=rhs.item()
                     if isinstance(rhs, np.number) else rhs)
    if not isinstance(rhs, NDArray):
        rhs = array(rhs, ctx=lhs.context, dtype=lhs._data.dtype)
    a, b = (rhs, lhs) if reverse else (lhs, rhs)
    return _call("broadcast_" + name, a, b)


def _make_op_func(opdef, public_name):
    def op_func(*args, **kwargs):
        return _invoke(opdef, args, kwargs)

    op_func.__name__ = op_func.__qualname__ = public_name.lstrip("_")
    op_func.__doc__ = opdef.__doc__
    op_func.opdef = opdef
    return op_func


_self = sys.modules[__name__]
op = types.ModuleType(__name__ + ".op")
op.__doc__ = "Every registered operator (reference mx.nd.op)."
contrib = types.ModuleType(__name__ + ".contrib")
contrib.__doc__ = "The ``_contrib_<op>`` operators as ``contrib.<op>`` (reference mx.nd.contrib)."
for _name in _registry.list_ops():
    _f = _make_op_func(_registry.get(_name), _name)
    setattr(op, _name, _f)
    if not hasattr(_self, _name):
        setattr(_self, _name, _f)
    if _name.startswith("_contrib_"):
        setattr(contrib, _name[len("_contrib_"):], _f)
sys.modules[op.__name__] = op
sys.modules[contrib.__name__] = contrib
del _f, _name


def __getattr__(name):
    """Ops registered after import resolve by name (PEP 562)."""
    if not name.startswith("__") and _registry.exists(name):
        return _make_op_func(_registry.get(name), name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


# -- creation ------------------------------------------------------------------

def zeros(shape, ctx=None, dtype="float32", **kwargs):
    return _call("_zeros", shape=shape, dtype=dtype or "float32", ctx=ctx)


def ones(shape, ctx=None, dtype="float32", **kwargs):
    return _call("_ones", shape=shape, dtype=dtype or "float32", ctx=ctx)


def full(shape, val, ctx=None, dtype="float32", **kwargs):
    return _call("_full", shape=shape, value=val, dtype=dtype or "float32", ctx=ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return _call("_arange", start=start, stop=stop, step=step, repeat=repeat,
                 dtype=dtype or "float32", ctx=ctx)


def _extremum(name):
    def f(lhs, rhs):
        if isinstance(lhs, NDArray):
            return _binary_dispatch(name, lhs, rhs)
        return _binary_dispatch(name, rhs, lhs, reverse=True)

    f.__name__ = name
    f.__doc__ = "Elementwise %s of two arrays or an array and a number." % name
    return f


maximum = _extremum("maximum")
minimum = _extremum("minimum")


def zeros_like(arr, **kw):
    return _call("zeros_like", arr, **kw)


def ones_like(arr, **kw):
    return _call("ones_like", arr, **kw)


# -- nd.random -------------------------------------------------------------------

random = types.ModuleType(__name__ + ".random")
random.__doc__ = "Random samplers (reference mx.nd.random), drawing from mx.random."


def _make_random(fname, opname, posnames):
    opdef = _registry.get(opname)

    def rnd_func(*args, **kwargs):
        for pname, val in zip(posnames, args):
            if pname in kwargs:
                raise TypeError("%s() got multiple values for '%s'" % (fname, pname))
            kwargs[pname] = val
        return _invoke(opdef, args[len(posnames):], kwargs)

    rnd_func.__name__ = fname
    rnd_func.__doc__ = opdef.__doc__
    return rnd_func


for _fname, _opname, _pos in [
        ("uniform", "_random_uniform", ("low", "high", "shape", "dtype", "ctx", "out")),
        ("normal", "_random_normal", ("loc", "scale", "shape", "dtype", "ctx", "out")),
        ("gamma", "_random_gamma", ("alpha", "beta", "shape", "dtype", "ctx", "out")),
        ("poisson", "_random_poisson", ("lam", "shape", "dtype", "ctx", "out")),
        ("negative_binomial", "_random_negative_binomial",
         ("k", "p", "shape", "dtype", "ctx", "out")),
        ("generalized_negative_binomial", "_random_generalized_negative_binomial",
         ("mu", "alpha", "shape", "dtype", "ctx", "out")),
        ("randint", "_random_randint", ("low", "high", "shape", "dtype", "ctx", "out")),
        ("multinomial", "_sample_multinomial", ()),
        ("shuffle", "_shuffle", ())]:
    setattr(random, _fname, _make_random(_fname, _opname, _pos))


def _exponential(scale=1.0, shape=(1,), dtype="float32", **kwargs):
    """Exponential of mean ``scale`` (the op takes the rate 1 / scale)."""
    return _call("_random_exponential", lam=1.0 / scale, shape=shape, dtype=dtype, **kwargs)


random.exponential = _exponential
sys.modules[random.__name__] = random

# -- fluent methods: x.log() is nd.log(x) (reference ndarray.py fluent set) -------

_FLUENT = (
    "zeros_like ones_like broadcast_axes repeat pad swapaxes slice slice_axis slice_like "
    "take one_hot pick sort topk argsort argmax argmax_channel argmin clip abs sign "
    "expand_dims tile flip sum nansum prod nanprod mean max min norm round rint fix floor "
    "ceil trunc sin cos tan arcsin arccos arctan degrees radians sinh cosh tanh arcsinh "
    "arccosh arctanh exp expm1 log log10 log2 log1p sqrt rsqrt cbrt rcbrt square "
    "reciprocal relu sigmoid softmax log_softmax squeeze broadcast_to broadcast_like"
).split()


def _make_fluent(opname):
    opdef = _registry.get(opname)

    def fluent(self, *args, **kwargs):
        return _invoke(opdef, (self,) + args, kwargs)

    fluent.__name__ = opname
    fluent.__doc__ = "nd.%s(self, ...)." % opname
    return fluent


for _fname in _FLUENT:
    if not hasattr(NDArray, _fname) and _registry.exists(_fname):
        setattr(NDArray, _fname, _make_fluent(_fname))
