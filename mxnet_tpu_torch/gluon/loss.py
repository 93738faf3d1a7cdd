"""Losses (counterpart of ``mxnet_tpu/gluon/loss.py``; reference
``python/mxnet/gluon/loss.py``): the base ``Loss`` and softmax
cross-entropy, the loss of the classification train step.  Each gives one
loss per sample: the mean over every axis but ``batch_axis``."""
from __future__ import annotations

import torch

from ..ops import nn as ops_nn
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """Reference loss.py:28: per-sample, then scalar weighting."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _mean_but(loss, batch_axis):
    """Mean over every axis but ``batch_axis`` (MXNet's ``exclude=True``)."""
    axes = [i for i in range(loss.dim()) if i != batch_axis % loss.dim()]
    return torch.mean(loss, dim=axes) if axes else loss


class Loss(HybridBlock):
    """Base loss (reference loss.py:66): ``forward(pred, label,
    sample_weight=None)`` gives the per-sample losses, batch axis kept.
    ``weight`` is a scalar factor (None: 1)."""

    def __init__(self, weight, batch_axis, prefix=None):
        super().__init__(prefix=prefix)
        self._weight = weight
        self._batch_axis = batch_axis


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax and cross-entropy along ``axis`` (reference loss.py:263).

    With ``sparse_label`` the label holds class indices, of any dtype (a
    float label, as a data iterator gives it, is truncated to an integer
    and clipped to the class range, as ``pick`` does); otherwise it is a
    distribution of ``pred``'s shape.  ``from_logits`` says ``pred`` is
    already a log-softmax."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, prefix=None):
        super().__init__(weight, batch_axis, prefix=prefix)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = ops_nn.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            axis = self._axis % pred.dim()
            idx = label.to(torch.int64).clamp(0, pred.shape[axis] - 1)
            loss = -torch.gather(pred, axis, idx.unsqueeze(axis))
        else:
            loss = -torch.sum(pred * label.reshape(pred.shape), dim=self._axis,
                              keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_but(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
