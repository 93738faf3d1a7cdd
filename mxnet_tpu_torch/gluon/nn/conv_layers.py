"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``).  Shapes are known at construction,
so ``in_channels`` is required where Gluon defers it."""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...ops import nn as ops_nn
from ...ops.nn import pair
from ..block import HybridBlock

__all__ = ["Conv2D", "GlobalAvgPool2D", "MaxPool2D"]


class Conv2D(HybridBlock):
    """2-D convolution, NCHW, weight (channels, in_channels, kh, kw)
    (reference conv_layers.py Conv2D).  ``activation`` is applied after the
    bias, as Gluon's ``act`` child does.  ``device`` None means CUDA, and
    raises without it (pass ``"cpu"`` to run on the CPU)."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), activation=None, use_bias=True,
                 in_channels=0, prefix=None, device=None):
        super().__init__(prefix=prefix)
        if not in_channels:
            raise ValueError("Conv2D: in_channels is required (no deferred "
                             "shapes in the port)")
        device = resolve_device(device)
        k = pair(kernel_size)
        self._kwargs = dict(kernel=k, stride=pair(strides), dilate=pair(dilation),
                            pad=pair(padding), num_filter=channels,
                            no_bias=not use_bias)
        self._act_type = activation
        self.weight = torch.nn.Parameter(torch.empty(
            (channels, in_channels) + k, device=device))
        self.bias = (torch.nn.Parameter(torch.zeros(channels, device=device))
                     if use_bias else None)
        self.gluon_params = ("weight", "bias") if use_bias else ("weight",)

    def forward(self, x):
        out = ops_nn.convolution(x, self.weight, self.bias, **self._kwargs)
        if self._act_type is not None:
            out = ops_nn.activation(out, act_type=self._act_type)
        return out


class MaxPool2D(HybridBlock):
    """2-D max pooling (reference conv_layers.py MaxPool2D): the output size
    rounds down (``valid`` convention), or up with ``ceil_mode`` (``full``,
    the last window padded on the right)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0, ceil_mode=False,
                 prefix=None):
        super().__init__(prefix=prefix)
        pool_size = pair(pool_size)
        self._kwargs = dict(kernel=pool_size,
                            stride=pair(strides) if strides is not None else pool_size,
                            pad=pair(padding),
                            pooling_convention="full" if ceil_mode else "valid")

    def _alias(self):
        return "pool"

    def forward(self, x):
        return ops_nn.pooling(x, **self._kwargs)


class GlobalAvgPool2D(HybridBlock):
    """Mean over H and W, (N, C, H, W) -> (N, C, 1, 1) (reference
    conv_layers.py GlobalAvgPool2D); averaged in fp32 and cast back, as
    the pooling op does."""

    def _alias(self):
        return "pool"

    def forward(self, x):
        return ops_nn.pooling(x, global_pool=True, pool_type="avg")
