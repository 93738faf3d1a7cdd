"""Reductions (counterpart of ``mxnet_tpu/ops/reduce.py``): the global
``min`` and ``max`` that the int8 rewrite takes as the runtime range of each
quantized activation.  NaN propagates, as in ``jnp.min`` / ``jnp.max``."""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["max_", "min_"]


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
