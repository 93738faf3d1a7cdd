"""Elementwise operators of the ported paths (counterpart of
``mxnet_tpu/ops/elemwise.py``)."""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["smooth_l1", "block_grad", "broadcast_add"]


def smooth_l1(data, *, scalar=1.0):
    """Smooth-L1 transform (reference mshadow_op.h smooth_l1_loss;
    ``mxnet_tpu/ops/elemwise.py smooth_l1``, in its operation order):
    ``0.5 σ² x²`` where ``|x| < 1/σ²``, else ``|x| − 0.5/σ²``, σ = ``scalar``."""
    sigma2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / sigma2, 0.5 * sigma2 * data * data,
                       absd - 0.5 / sigma2)


def block_grad(data):
    """The value of ``data`` with no gradient (reference BlockGrad)."""
    return data.detach()


@register("broadcast_add")
def broadcast_add(lhs, rhs):
    """Sum with NumPy broadcasting (reference
    elemwise_binary_broadcast_op_basic.cc); ``Symbol.__add__`` builds it."""
    return torch.add(lhs, rhs)
