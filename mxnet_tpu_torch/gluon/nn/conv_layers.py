"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``).  ``in_channels`` 0 defers the
weight's shape to the first forward, as Gluon does."""
from __future__ import annotations

from ...context import as_device
from ...ops import nn as ops_nn
from ...ops.nn import pair
from ..block import HybridBlock

__all__ = ["Conv2D", "GlobalAvgPool2D", "MaxPool2D"]


class Conv2D(HybridBlock):
    """2-D convolution, NCHW, weight (channels, in_channels, kh, kw)
    (reference conv_layers.py Conv2D).  ``activation`` is applied after the
    bias, as Gluon's ``act`` child does.

    With ``in_channels`` the tensors are made at once on ``device`` (None:
    the current context, which is CUDA unless ``with mx.cpu():``; without
    a card it raises), the weight uninitialised and the bias 0.  Without
    it they wait for ``initialize`` and the first forward."""

    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), activation=None, use_bias=True,
                 in_channels=0, prefix=None, device=None, weight_initializer=None,
                 bias_initializer="zeros"):
        super().__init__(prefix=prefix)
        dev = as_device(device) if in_channels else None
        k = pair(kernel_size)
        self._kwargs = dict(kernel=k, stride=pair(strides), dilate=pair(dilation),
                            pad=pair(padding), num_filter=channels,
                            no_bias=not use_bias)
        self._act_type = activation
        self._declare("weight", (channels, in_channels) + k, dev, init=weight_initializer)
        if use_bias:
            self._declare("bias", (channels,), dev, fill=0.0, init=bias_initializer)
        else:
            self.bias = None

    def forward(self, x):
        if self.weight is None:
            self._complete(x.shape[1], x.device)
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
