"""Miscellaneous operators (counterpart of ``mxnet_tpu/ops/misc_ops.py``):
``reshape_like`` and ``_copyto``, the two of the JAX group that the
imperative frontend's paths use.  The group's other 13 are ROADMAP A8.4."""
from __future__ import annotations

from .registry import register

__all__ = ["reshape_like", "copyto"]


@register("reshape_like")
def reshape_like(lhs, rhs):
    """``lhs`` in ``rhs``'s shape (reference elemwise_unary_op_basic.cc)."""
    return lhs.reshape(rhs.shape)


@register("_copyto", alias=("copyto",))
def copyto(data):
    """A copy of ``data`` (the nd frontend's ``ctx=`` moves it)."""
    return data.clone()
