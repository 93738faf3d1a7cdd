"""Indexing, gather / scatter and ordering operators (counterpart of
``mxnet_tpu/ops/indexing.py``; reference src/operator/tensor/indexing_op.h
and ordering_op-inl.h): ``take``, ``batch_take``, ``Embedding``,
``one_hot``, ``gather_nd``, ``scatter_nd``, ``_scatter_set_nd``, ``sort``,
``argsort`` and ``topk``.  Index outputs come as float32 unless ``dtype``
says otherwise, as MXNet's do."""
from __future__ import annotations

import torch

from .elemwise import to_dtype
from .registry import register

__all__ = ["take", "one_hot", "topk"]


@register("take")
def take(a, indices, *, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` at ``indices`` (any shape), out of
    range indices clipped ("clip") or wrapped ("wrap") (reference
    indexing_op.h Take)."""
    ax = axis % a.dim()
    idx = indices.to(torch.int64)
    n = a.shape[ax]
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    elif mode == "clip":
        idx = torch.clamp(idx, 0, n - 1)
    out = a.index_select(ax, idx.reshape(-1))
    return out.reshape(a.shape[:ax] + idx.shape + a.shape[ax + 1:])


@register("batch_take")
def batch_take(a, indices):
    """``a[i, indices[i]]`` (reference indexing_op.h batch_take)."""
    return torch.gather(a, 1, indices.to(torch.int64)[:, None])[:, 0]


@register("Embedding",
          infer_params=lambda attrs, shapes: {"weight": (attrs["input_dim"],
                                                         attrs["output_dim"])})
def embedding(data, weight, *, input_dim, output_dim, dtype="float32", sparse_grad=False):
    """Rows of ``weight`` at the ids ``data``, clipped to the vocabulary
    (reference indexing_op.h EmbeddingOp)."""
    idx = torch.clamp(data.to(torch.int64), 0, input_dim - 1)
    return weight[idx]


@register("one_hot")
def one_hot(indices, *, depth, on_value=1.0, off_value=0.0, dtype="float32"):
    """``on_value`` at each index, ``off_value`` elsewhere; an index out of
    [0, depth) gives a row of ``off_value`` (reference indexing_op.h
    OneHot; ``jax.nn.one_hot``)."""
    oh = (indices.to(torch.int64)[..., None]
          == torch.arange(depth, device=indices.device)).to(to_dtype(dtype))
    return oh * on_value + (1.0 - oh) * off_value


def _index_tuple(indices):
    idx = indices.to(torch.int64)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd")
def gather_nd(data, indices):
    """``data[indices[0], ..., indices[M-1]]``: (M, ...) ids of the leading
    axes -> shape ``indices.shape[1:] + data.shape[M:]`` (reference
    indexing_op.h GatherND)."""
    return data[_index_tuple(indices)]


@register("scatter_nd")
def scatter_nd(data, indices, *, shape):
    """Zeros of ``shape`` with ``data`` written at ``indices`` (reference
    indexing_op.h ScatterND)."""
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_index_tuple(indices), data)


@register("_scatter_set_nd")
def scatter_set_nd(lhs, indices, rhs, *, shape=None):
    """``lhs`` with ``rhs`` written at ``indices``."""
    return lhs.index_put(_index_tuple(indices), rhs)


@register("sort")
def sort(data, *, axis=-1, is_ascend=True):
    """Values sorted along ``axis`` (reference ordering_op-inl.h SortOp)."""
    out = torch.sort(data, dim=axis).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort")
def argsort(data, *, axis=-1, is_ascend=True, dtype="float32"):
    """Indices of the stable ascending sort, reversed for descending (the
    JAX op's order of ties)."""
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(to_dtype(dtype))


@register("topk", num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both" else 1)
def topk(data, *, axis=-1, k=1, ret_typ="indices", is_ascend=False, dtype="float32"):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``, as values,
    indices, a 0/1 mask or both (reference ordering_op-inl.h TopKOp).
    Ties: the order among equal values is not specified."""
    ax = axis % data.dim()
    vals, idxs = torch.topk(data, k, dim=ax, largest=not is_ascend, sorted=True)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idxs.to(to_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(ax, idxs, 1.0)
    if ret_typ == "both":
        return vals, idxs.to(to_dtype(dtype))
    raise ValueError("topk: ret_typ must be value, indices, mask or both, got %r" % ret_typ)
