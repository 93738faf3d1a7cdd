"""Reductions (counterpart of ``mxnet_tpu/ops/reduce.py``; reference
src/operator/tensor/broadcast_reduce_op*): ``sum``, ``mean``, ``prod``,
``max``, ``min`` and the NaN-skipping pair with MXNet's
``axis`` / ``keepdims`` / ``exclude``, ``norm``, ``moments``, the index
reductions (``argmax`` as float, ``pick``), ``softmax_cross_entropy`` and
``L2Normalization``, the deploy twin's embedding head.  ``max`` and
``min`` without an axis are the global range that the int8 rewrite takes
for each quantized activation (NaN propagates, as in ``jnp.max``)."""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["max_", "min_", "l2_normalization", "norm_axis"]


def norm_axis(ndim, axis, exclude=False):
    """MXNet's ``axis`` (None, an int or a tuple) and ``exclude`` -> the
    tuple of axes to reduce (``mxnet_tpu/ops/reduce.py _norm_axis``): None
    or () is every axis, or none with ``exclude``."""
    if axis is None or axis == ():
        ax = tuple(range(ndim)) if not exclude else ()
    else:
        ax = (axis,) if isinstance(axis, int) else tuple(axis)
        ax = tuple(a % ndim for a in ax)
    if exclude:
        ax = tuple(sorted(set(range(ndim)) - set(ax)))
    return ax


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim, keepdim)


_REDUCERS = {
    "sum": (lambda x, d, k: torch.sum(x, dim=d, keepdim=k), ("sum_axis",)),
    "mean": (lambda x, d, k: torch.mean(x, dim=d, keepdim=k), ()),
    "prod": (_prod, ()),
    "nansum": (lambda x, d, k: torch.nansum(x, dim=d, keepdim=k), ()),
    "nanprod": (_nanprod, ()),
    "max": (lambda x, d, k: torch.amax(x, dim=d, keepdim=k), ("max_axis",)),
    "min": (lambda x, d, k: torch.amin(x, dim=d, keepdim=k), ("min_axis",)),
}


def _reducer(name, f, aliases):
    def op(data, *, axis=None, keepdims=False, exclude=False):
        ax = norm_axis(data.dim(), axis, exclude)
        if not ax:  # nothing to reduce (torch would read () as every axis)
            return data.clone()
        return f(data, ax, keepdims)

    op.__name__ = op.__qualname__ = name
    op.__doc__ = ("Reduce %s over ``axis`` (reference "
                  "broadcast_reduce_op_value.cc)." % name)
    register(name, alias=aliases)(op)
    return op


_OPS = {name: _reducer(name, f, al) for name, (f, al) in _REDUCERS.items()}
max_ = _OPS["max"]
min_ = _OPS["min"]


@register("norm")
def norm(data, *, ord=2, axis=None, keepdims=False):
    """L1 or L2 norm over ``axis`` (reference broadcast_reduce_op norm)."""
    ax = norm_axis(data.dim(), axis)
    if ord == 1:
        return torch.sum(torch.abs(data), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=ax, keepdim=keepdims))


def _arg(f, data, axis, keepdims):
    out = f(data, dim=axis)
    if keepdims and axis is not None:
        out = out.unsqueeze(axis)
    return out.to(torch.float32)


@register("argmax")
def argmax(data, *, axis=None, keepdims=False):
    """Index of the first maximum, as float32 (MXNet's convention;
    reference broadcast_reduce_op_index.cc); no axis: of the flat array."""
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin")
def argmin(data, *, axis=None, keepdims=False):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel")
def argmax_channel(data):
    """Argmax over axis 1, as float32."""
    return torch.argmax(data, dim=1).to(torch.float32)


@register("pick")
def pick(data, index, *, axis=-1, keepdims=False, mode="clip"):
    """``data[..., index[...], ...]`` along ``axis``; ``mode`` "clip" or
    "wrap" for indices out of range (reference
    broadcast_reduce_op_index.cc pick)."""
    ax = axis % data.dim()
    idx = index.to(torch.int64)
    n = data.shape[ax]
    idx = torch.remainder(idx, n) if mode == "wrap" else torch.clamp(idx, 0, n - 1)
    out = torch.gather(data, ax, idx.unsqueeze(ax))
    return out if keepdims else out.squeeze(ax)


_L2_AXES = {"instance": lambda nd: tuple(range(1, nd)), "channel": lambda nd: (1,),
            "spatial": lambda nd: tuple(range(2, nd))}


@register("L2Normalization")
def l2_normalization(data, *, eps=1e-10, mode="instance"):
    """``data / sqrt(sum(data²) + eps)`` over each instance, channel or
    spatial map (reference src/operator/l2_normalization.cc;
    ``mxnet_tpu/ops/reduce.py l2_normalization``, in its order)."""
    if mode not in _L2_AXES:
        raise ValueError("L2Normalization: mode must be one of %s, got %r"
                         % (sorted(_L2_AXES), mode))
    ax = _L2_AXES[mode](data.dim())
    return data / torch.sqrt(torch.sum(data * data, dim=ax, keepdim=True) + eps)


@register("moments", num_outputs=lambda attrs: 2)
def moments(data, *, axes=None, keepdims=False):
    """(mean, population variance) over ``axes``."""
    ax = norm_axis(data.dim(), axes)
    mean = torch.mean(data, dim=ax, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=ax, keepdim=keepdims)
    return (mean if keepdims else mean.squeeze(ax) if ax else mean), var


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Summed softmax cross-entropy of ``data`` (N, K) against class ids
    ``label`` (N,) (reference src/operator/loss_binary_op.cc)."""
    logp = torch.log_softmax(data, dim=-1)
    idx = label.to(torch.int64).unsqueeze(-1)
    return -torch.sum(torch.gather(logp, -1, idx))
