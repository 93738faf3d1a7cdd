"""Reductions (counterpart of ``mxnet_tpu/ops/reduce.py``): the global
``min`` and ``max`` that the int8 rewrite takes as the runtime range of each
quantized activation (NaN propagates, as in ``jnp.min`` / ``jnp.max``), and
``L2Normalization``, the deploy twin's embedding head."""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["max_", "min_", "l2_normalization"]


@register("max")
def max_(data):
    """Max over every element, as a 0-d tensor (reference
    broadcast_reduce_op_value.cc with no axis)."""
    return torch.amax(data)


@register("min")
def min_(data):
    """Min over every element, as a 0-d tensor (reference
    broadcast_reduce_op_value.cc with no axis)."""
    return torch.amin(data)


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
