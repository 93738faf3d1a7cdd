"""Elementwise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``;
reference src/operator/tensor/elemwise_* and the mshadow functors of
src/operator/mshadow_op.h).

Every name of the JAX group is registered here, with its aliases: the
binary ops (``elemwise_*`` and ``broadcast_*``, which both broadcast), the
``_*_scalar`` ops, the unary math, ``clip``, ``cast``, ``BlockGrad``,
``add_n`` and the rest.  Comparisons and logic ops return 1.0 / 0.0 in
the input's floating dtype (float32 for an integer input), never ``bool``,
as MXNet's do.
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = ["smooth_l1", "block_grad", "broadcast_add", "cmp_dtype"]


def cmp_dtype(a):
    """The dtype of a comparison's result: ``a``'s if floating, else
    float32 (``mxnet_tpu/ops/elemwise.py _cmp_dtype``)."""
    return a.dtype if a.is_floating_point() else torch.float32


def _as_cmp(mask, a):
    return mask.to(cmp_dtype(a))


def _reg(name, fn, aliases=(), doc=None):
    fn.__name__ = fn.__qualname__ = name.lstrip("_")
    fn.__doc__ = doc
    register(name, alias=tuple(aliases))(fn)
    return fn


def _unary(name, f, aliases=()):
    def op(data):
        return f(data)
    return _reg(name, op, aliases, "Elementwise %s (reference "
                "elemwise_unary_op_basic.cc)." % name)


def _binary(name, f, aliases=()):
    def op(lhs, rhs):
        return f(lhs, rhs)
    return _reg(name, op, aliases, "Elementwise %s with NumPy broadcasting "
                "(reference elemwise_binary_broadcast_op_basic.cc)." % name)


def _scalar(name, f, aliases=()):
    def op(data, *, scalar):
        return f(data, scalar)
    return _reg(name, op, aliases, "%s of a tensor and the number ``scalar`` "
                "(reference elemwise_binary_scalar_op_basic.cc)." % name)


def _hypot(a, b):
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.hypot(a, b)


def _logical(f):
    def g(a, b):
        return _as_cmp(f(a != 0, b != 0), a)
    return g


_BINARY = {
    "add": (torch.add, ("plus",)),
    "sub": (torch.sub, ("minus",)),
    "mul": (torch.mul, ()),
    "div": (torch.div, ()),
    "mod": (torch.remainder, ()),
    "power": (torch.pow, ()),
    "maximum": (torch.maximum, ()),
    "minimum": (torch.minimum, ()),
    "hypot": (_hypot, ()),
    "equal": (lambda a, b: _as_cmp(a == b, a), ()),
    "not_equal": (lambda a, b: _as_cmp(a != b, a), ()),
    "greater": (lambda a, b: _as_cmp(a > b, a), ()),
    "greater_equal": (lambda a, b: _as_cmp(a >= b, a), ()),
    "lesser": (lambda a, b: _as_cmp(a < b, a), ()),
    "lesser_equal": (lambda a, b: _as_cmp(a <= b, a), ()),
    "logical_and": (_logical(torch.logical_and), ()),
    "logical_or": (_logical(torch.logical_or), ()),
    "logical_xor": (_logical(torch.logical_xor), ()),
}

# elemwise_* / _*: the same-shape family of the reference, with the JAX
# package's names and aliases
_binary("elemwise_add", torch.add, ["_plus", "_add"])
_binary("elemwise_sub", torch.sub, ["_minus", "_sub"])
_binary("elemwise_mul", torch.mul, ["_mul"])
_binary("elemwise_div", torch.div, ["_div"])
_binary("_mod", torch.remainder)
_binary("_power", torch.pow, ["_pow"])
_binary("_maximum", torch.maximum, ["_max"])
_binary("_minimum", torch.minimum, ["_min"])
for _n in ("hypot", "equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal", "logical_and", "logical_or", "logical_xor"):
    _binary("_" + _n, _BINARY[_n][0])

for _n, (_f, _al) in _BINARY.items():
    _fn = _binary("broadcast_" + _n, _f, ["broadcast_" + a for a in _al])
    if _n == "add":
        broadcast_add = _fn


def _rmod(x, s):
    return torch.remainder(torch.full_like(x, s), x)


_scalar("_plus_scalar", lambda x, s: x + s)
_scalar("_minus_scalar", lambda x, s: x - s)
_scalar("_rminus_scalar", lambda x, s: s - x)
_scalar("_mul_scalar", lambda x, s: x * s)
_scalar("_div_scalar", lambda x, s: x / s)
_scalar("_rdiv_scalar", lambda x, s: s / x)
_scalar("_mod_scalar", torch.remainder)
_scalar("_rmod_scalar", _rmod)
_scalar("_power_scalar", torch.pow)
_scalar("_rpower_scalar", lambda x, s: torch.pow(s, x))
_scalar("_maximum_scalar", lambda x, s: torch.clamp_min(x, s))
_scalar("_minimum_scalar", lambda x, s: torch.clamp_max(x, s))
_scalar("_hypot_scalar", _hypot)
_scalar("_equal_scalar", lambda x, s: _as_cmp(x == s, x))
_scalar("_not_equal_scalar", lambda x, s: _as_cmp(x != s, x))
_scalar("_greater_scalar", lambda x, s: _as_cmp(x > s, x))
_scalar("_greater_equal_scalar", lambda x, s: _as_cmp(x >= s, x))
_scalar("_lesser_scalar", lambda x, s: _as_cmp(x < s, x))
_scalar("_lesser_equal_scalar", lambda x, s: _as_cmp(x <= s, x))
_scalar("_logical_and_scalar", lambda x, s: _as_cmp((x != 0) & bool(s != 0), x))
_scalar("_logical_or_scalar", lambda x, s: _as_cmp((x != 0) | bool(s != 0), x))
_scalar("_logical_xor_scalar", lambda x, s: _as_cmp((x != 0) ^ bool(s != 0), x))


def _cbrt(x):
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_DEG = 180.0 / math.pi

_unary("negative", torch.neg, ["_np_negative"])
_unary("reciprocal", torch.reciprocal)
_unary("abs", torch.abs)
_unary("sign", torch.sign)
_unary("round", torch.round)   # half to even, as jnp.round
_unary("rint", torch.round)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("trunc", torch.trunc)
_unary("fix", torch.trunc)
_unary("square", torch.square)
_unary("sqrt", torch.sqrt)
_unary("rsqrt", torch.rsqrt)
_unary("cbrt", _cbrt)
_unary("rcbrt", lambda x: 1.0 / _cbrt(x))
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("log10", torch.log10)
_unary("log2", torch.log2)
_unary("log1p", torch.log1p)
_unary("expm1", torch.expm1)
_unary("gamma", lambda x: torch.exp(torch.lgamma(x)))
_unary("gammaln", torch.lgamma)
_unary("erf", torch.erf)
_unary("erfinv", torch.erfinv)
_unary("sin", torch.sin)
_unary("cos", torch.cos)
_unary("tan", torch.tan)
_unary("arcsin", torch.asin)
_unary("arccos", torch.acos)
_unary("arctan", torch.atan)
_unary("degrees", lambda x: x * _DEG)
_unary("radians", lambda x: x * (math.pi / 180.0))
_unary("sinh", torch.sinh)
_unary("cosh", torch.cosh)
_unary("tanh", torch.tanh)
_unary("arcsinh", torch.asinh)
_unary("arccosh", torch.acosh)
_unary("arctanh", torch.atanh)
_unary("logical_not", lambda x: _as_cmp(x == 0, x))
_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("softsign", torch.nn.functional.softsign)
_unary("_copy", torch.clone, ["identity"])


@register("BlockGrad", alias=("stop_gradient",))
def block_grad(data):
    """The value of ``data`` with no gradient (reference BlockGrad)."""
    return data.detach()


@register("clip")
def clip(data, *, a_min, a_max):
    """Clip to [a_min, a_max] (reference matrix_op.cc clip)."""
    return torch.clamp(data, a_min, a_max)


@register("smooth_l1")
def smooth_l1(data, *, scalar=1.0):
    """Smooth-L1 transform (reference mshadow_op.h smooth_l1_loss;
    ``mxnet_tpu/ops/elemwise.py smooth_l1``, in its operation order):
    ``0.5 σ² x²`` where ``|x| < 1/σ²``, else ``|x| − 0.5/σ²``, σ = ``scalar``."""
    sigma2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / sigma2, 0.5 * sigma2 * data * data,
                       absd - 0.5 / sigma2)


@register("add_n", alias=("ElementWiseSum", "_sum"))
def add_n(*args):
    """Sum of the inputs, left to right (reference elemwise_sum.cc)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("_scatter_elemwise_div")
def scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


def to_dtype(dtype):
    """A dtype name ("float32", "int32", "bfloat16"), a numpy dtype or a
    ``torch.dtype`` -> the ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    name = {"bool": "bool", "float": "float32", "int": "int32"}.get(name, name)
    return getattr(torch, name)


@register("cast", alias=("Cast",))
def cast(data, *, dtype):
    """Cast to ``dtype`` (reference elemwise_unary_op_basic.cc Cast)."""
    return data.to(to_dtype(dtype))


@register("_zeros_like", alias=("zeros_like",))
def zeros_like(data):
    return torch.zeros_like(data)


@register("_ones_like", alias=("ones_like",))
def ones_like(data):
    return torch.ones_like(data)


@register("_maximum_mask_scalar")
def maximum_mask_scalar(data, *, scalar):
    return (data >= scalar).to(data.dtype)
