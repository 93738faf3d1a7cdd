"""Elementwise operators of the training path (counterpart of
``mxnet_tpu/ops/elemwise.py``)."""
from __future__ import annotations

import torch

__all__ = ["smooth_l1", "block_grad"]


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
