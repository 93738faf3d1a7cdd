"""ResNet v1 and v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``; reference
``python/mxnet/gluon/model_zoo/vision/resnet.py``).

V1 is post-activation (He et al. 2015), V2 pre-activation (He et al.
2016).  Every block is built in the JAX model's order, so that each
parameter's Gluon name is the JAX one with the root prefix stripped
(``stage1_conv2d0_weight``, ``stage1_batchnorm0_running_var``,
``dense0_bias``).  Gluon defers ``in_channels``; the port passes it,
computed from the channel list.  As in Gluon, the 1×1 convolutions of
``BottleneckV1``'s body keep their bias.

Every constructor takes ``device`` (None means CUDA, and raises without
it; pass ``"cpu"`` to run on the CPU) and ``generator``, a
``torch.Generator`` for the initial weights, drawn on the CPU in the JAX
defaults' distributions: every weight U(−0.07, 0.07) (``Uniform()``, the
default initializer), biases and β 0, γ 1, running mean 0 and variance 1.
Nets come back in eval mode.
"""
from __future__ import annotations

import torch

from ... import nn
from ...block import HybridBlock

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet_spec", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet18_v2", "resnet34_v2", "resnet50_v2",
           "resnet101_v2", "resnet152_v2"]

IMAGE_CHANNELS = 3
UNIFORM_SCALE = 0.07


def _conv3x3(channels, stride, in_channels, device):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, device=device)


class BasicBlockV1(HybridBlock):
    """ResNet-v1 basic block (reference resnet.py:40)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, device=None):
        super().__init__(prefix=prefix)
        dev = dict(device=device)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, device))
        self.body.add(nn.BatchNorm(in_channels=channels, **dev))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, device))
        self.body.add(nn.BatchNorm(in_channels=channels, **dev))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                                          use_bias=False, in_channels=in_channels, **dev))
            self.downsample.add(nn.BatchNorm(in_channels=channels, **dev))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(residual + self.body(x))


class BottleneckV1(HybridBlock):
    """ResNet-v1 bottleneck (reference resnet.py:84)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, device=None):
        super().__init__(prefix=prefix)
        dev = dict(device=device)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                in_channels=in_channels, **dev))
        self.body.add(nn.BatchNorm(in_channels=mid, **dev))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, device))
        self.body.add(nn.BatchNorm(in_channels=mid, **dev))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=mid, **dev))
        self.body.add(nn.BatchNorm(in_channels=channels, **dev))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1, strides=stride,
                                          use_bias=False, in_channels=in_channels, **dev))
            self.downsample.add(nn.BatchNorm(in_channels=channels, **dev))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BasicBlockV2(HybridBlock):
    """ResNet-v2 basic block, pre-activation (reference resnet.py:131)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, device=None):
        super().__init__(prefix=prefix)
        self.bn1 = nn.BatchNorm(in_channels=in_channels, device=device)
        self.conv1 = _conv3x3(channels, stride, in_channels, device)
        self.bn2 = nn.BatchNorm(in_channels=channels, device=device)
        self.conv2 = _conv3x3(channels, 1, channels, device)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, device=device)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    """ResNet-v2 bottleneck, pre-activation (reference resnet.py:176)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 prefix=None, device=None):
        super().__init__(prefix=prefix)
        mid = channels // 4
        self.bn1 = nn.BatchNorm(in_channels=in_channels, device=device)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                               in_channels=in_channels, device=device)
        self.bn2 = nn.BatchNorm(in_channels=mid, device=device)
        self.conv2 = _conv3x3(mid, stride, mid, device)
        self.bn3 = nn.BatchNorm(in_channels=mid, device=device)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1, use_bias=False,
                               in_channels=mid, device=device)
        self.downsample = (nn.Conv2D(channels, 1, stride, use_bias=False,
                                     in_channels=in_channels, device=device)
                           if downsample else None)

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        x = torch.relu(self.bn3(x))
        return self.conv3(x) + residual


class _ResNet(HybridBlock):
    """What V1 and V2 share: the stages and the initial weights."""

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels, device):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, prefix="", device=device))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                prefix="", device=device))
        return layer

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """The JAX defaults' initial values, each weight drawn on the CPU
        from ``generator`` in the order of the sorted Gluon names."""
        for name, t in sorted(self.gluon_named_tensors().items()):
            if name.endswith("weight"):
                w = torch.empty(t.shape).uniform_(-UNIFORM_SCALE, UNIFORM_SCALE,
                                                  generator=generator)
                t.copy_(w)
            elif name.endswith(("gamma", "running_var")):
                t.fill_(1.0)
            else:  # bias, beta, running_mean
                t.zero_()
        self._mark_initialized()

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV1(_ResNet):
    """ResNet v1 (reference resnet.py:226): features (conv, BN, ReLU, max
    pool, four stages, global average pool), then ``output`` (Dense)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 prefix=None, device=None, generator=None):
        super().__init__(prefix=prefix)
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV1: %d stages need %d channel counts, got %d"
                             % (len(layers), len(layers) + 1, len(channels)))
        dev = dict(device=device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, IMAGE_CHANNELS, device))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                            in_channels=IMAGE_CHANNELS, **dev))
                self.features.add(nn.BatchNorm(in_channels=channels[0], **dev))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    channels[i], device))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1], **dev)
        self.reset_parameters(generator)


class ResNetV2(_ResNet):
    """ResNet v2 (reference resnet.py:288): a BatchNorm without scale or
    shift on the image, the stem, four pre-activation stages, BN, ReLU,
    global average pool, flatten, then ``output`` (Dense)."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 prefix=None, device=None, generator=None):
        super().__init__(prefix=prefix)
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV2: %d stages need %d channel counts, got %d"
                             % (len(layers), len(layers) + 1, len(channels)))
        dev = dict(device=device)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           in_channels=IMAGE_CHANNELS, **dev))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, IMAGE_CHANNELS, device))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                            in_channels=IMAGE_CHANNELS, **dev))
                self.features.add(nn.BatchNorm(in_channels=channels[0], **dev))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels, device))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(in_channels=in_channels, **dev))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels, **dev)
        self.reset_parameters(generator)


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, **kwargs):
    """ResNet ``version`` (1 or 2) with ``num_layers`` (a key of
    ``resnet_spec``) (reference resnet.py:372); ``kwargs`` go to the
    class: ``classes``, ``thumbnail``, ``device``, ``generator``.  No
    pretrained weights exist here: ``pretrained=True`` raises."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2." % version)
    if pretrained:
        raise RuntimeError("pretrained weights are not available; the port "
                           "starts from seeded random weights")
    block_type, layers, channels = resnet_spec[num_layers]
    block = resnet_block_versions[version - 1][block_type]
    return resnet_net_versions[version - 1](block, layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
