"""SSD-300 / SSD-512 with the VGG16-reduced backbone (counterpart of
``examples/ssd/vgg_ssd.py``; reference ``example/ssd/symbol/
{symbol_builder.py,vgg16_reduced.py}``, BASELINE config 5).

conv1–conv5 VGG stages (conv3's pool rounds up: 75 -> 38 at 300²), a
stride-1 pool5, dilated fc6 and 1×1 fc7, extra stride-2 stages down to 1×1
(and, at 300², two valid-conv tail stages), and per-source class and box
heads with the reference's anchor menu: 8,732 anchors at 300², 24,564 at
512².  The blocks are built in the JAX model's order, so every parameter
gets its Gluon name (``conv2d0_weight`` … ``conv2d34_bias`` at 300²: the
convs are counted in the model's scope, the ``extra_``, ``tail_``, ``cls_``
and ``box_`` sequences only hold them) and ``load_jax_params`` carries the
JAX net's weights across unchanged.

The anchors depend only on the static feature shapes: :meth:`VGGSSD.make_anchors`
builds them once with ``multibox_prior``, fp32, outside the train and score
steps (``mxnet_tpu_torch/train_ssd.py``), and a bf16 trunk never rounds them.
"""
from __future__ import annotations

import torch

from ... import initializer
from ...context import full_fp32, resolve_device
from ...ops import detection as ops_det
from .. import nn
from ..block import HybridBlock

__all__ = ["SSD300", "SSD512", "VGGSSD"]

# reference example/ssd/symbol/symbol_factory.py get_config('vgg16_reduced')
SSD300 = dict(
    sizes=[[.1, .141], [.2, .272], [.37, .447], [.54, .619],
           [.71, .79], [.88, .961]],
    ratios=[[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
            [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]],
    extra=((256, 512), (128, 256)), tail=2)
SSD512 = dict(
    sizes=[[.07, .1025], [.15, .2121], [.3, .3674], [.45, .5196],
           [.6, .6708], [.75, .8216], [.9, .9721]],
    ratios=[[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
            [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3], [1, 2, .5],
            [1, 2, .5]],
    # all five extra stages are stride-2 pad-1 convs: sources 64, 32, 16,
    # 8, 4, 2, 1 (valid-conv tails would reach 0×0)
    extra=((256, 512), (128, 256), (128, 256), (128, 256), (128, 256)),
    tail=0)


class VGGSSD(HybridBlock):
    """VGG16-reduced SSD; ``config`` is :data:`SSD300` or :data:`SSD512` (or
    a cut of one: ``sizes``, ``ratios``, ``extra`` and ``tail`` keys).

    ``width`` scales every trunk and extra channel count, at least 8 (the
    heads keep their anchor-determined outputs); the feature shapes, and so
    the anchors, do not depend on it.  ``net(x)`` with x (B, 3, S, S) ->
    (cls_preds (B, anchors, num_classes + 1), box_preds (B, anchors·4)),
    in the parameters' dtype (``cast("bfloat16")`` to serve in bf16), in
    full fp32 arithmetic (no TF32; the caller's settings restored after,
    ``context.full_fp32``).

    ``device``: where the weights live; None means CUDA, and raises without
    it (pass ``"cpu"`` to run on the CPU).  ``generator``: the
    ``torch.Generator`` of the initial weights, ``initializer.Xavier()``
    (uniform, magnitude 3, the JAX example's ``mx.init.Xavier()``) drawn
    in the order of the sorted Gluon names, biases 0.
    """

    def __init__(self, num_classes, config, width=1.0, device=None, generator=None,
                 prefix=None):
        super().__init__(prefix=prefix)
        self.device = resolve_device(device)
        self.num_classes = int(num_classes)
        self.cfg = config
        self.anchors_per = [len(s) + len(r) - 1
                            for s, r in zip(config["sizes"], config["ratios"])]
        dev = self.device

        def W(c):
            return max(8, int(round(c * width)))

        def vgg_stage(n, cin, c, pool=True, ceil=False):
            # the convs are made in the model's scope, as the JAX model's are
            blk = nn.HybridSequential()
            for i in range(n):
                blk.add(nn.Conv2D(c, 3, padding=1, activation="relu",
                                  in_channels=cin if i == 0 else c, device=dev))
            if pool:
                blk.add(nn.MaxPool2D(2, 2, ceil_mode=ceil))
            return blk

        with self.name_scope():
            self.conv1 = vgg_stage(2, 3, W(64))
            self.conv2 = vgg_stage(2, W(64), W(128))
            self.conv3 = vgg_stage(3, W(128), W(256), ceil=True)  # 75 -> 38
            self.conv4 = vgg_stage(3, W(256), W(512), pool=False)  # source 0
            self.pool4 = nn.MaxPool2D(2, 2)
            self.conv5 = vgg_stage(3, W(512), W(512), pool=False)
            self.pool5 = nn.MaxPool2D(3, 1, 1)                     # stride 1
            self.fc6 = nn.Conv2D(W(1024), 3, padding=6, dilation=6, activation="relu",
                                 in_channels=W(512), device=dev)  # atrous
            self.fc7 = nn.Conv2D(W(1024), 1, activation="relu",
                                 in_channels=W(1024), device=dev)  # source 1
            sources = [W(512), W(1024)]
            self.extras = nn.HybridSequential(prefix="extra_")
            for c1, c2 in config["extra"]:
                blk = nn.HybridSequential()
                blk.add(nn.Conv2D(W(c1), 1, activation="relu", in_channels=sources[-1],
                                  device=dev),
                        nn.Conv2D(W(c2), 3, strides=2, padding=1, activation="relu",
                                  in_channels=W(c1), device=dev))
                self.extras.add(blk)
                sources.append(W(c2))
            self.tails = nn.HybridSequential(prefix="tail_")
            for _ in range(config["tail"]):
                blk = nn.HybridSequential()
                blk.add(nn.Conv2D(W(128), 1, activation="relu", in_channels=sources[-1],
                                  device=dev),
                        nn.Conv2D(W(256), 3, activation="relu", in_channels=W(128),
                                  device=dev))  # valid conv
                self.tails.add(blk)
                sources.append(W(256))
            self.cls_heads = nn.HybridSequential(prefix="cls_")
            self.box_heads = nn.HybridSequential(prefix="box_")
            for a, c in zip(self.anchors_per, sources):
                self.cls_heads.add(nn.Conv2D(a * (self.num_classes + 1), 3, padding=1,
                                             in_channels=c, device=dev))
                self.box_heads.add(nn.Conv2D(a * 4, 3, padding=1, in_channels=c,
                                             device=dev))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Xavier weights from ``generator`` and zero biases, in the order of
        the sorted Gluon names."""
        init = initializer.Xavier(generator=generator)
        for name, t in sorted(self.gluon_named_tensors().items()):
            init(name, t)

    def _sources(self, x):
        x = self.conv3(self.conv2(self.conv1(x)))
        s0 = self.conv4(x)
        x = self.fc7(self.fc6(self.pool5(self.conv5(self.pool4(s0)))))
        sources = [s0, x]
        for blk in list(self.extras.children()) + list(self.tails.children()):
            x = blk(x)
            sources.append(x)
        return sources

    def forward(self, x):
        B = x.shape[0]
        cls_outs, box_outs = [], []
        with full_fp32():
            sources = self._sources(x)
            for s, cls, box in zip(sources, self.cls_heads.children(),
                                   self.box_heads.children()):
                cls_outs.append(cls(s).permute(0, 2, 3, 1).reshape(B, -1))
                box_outs.append(box(s).permute(0, 2, 3, 1).reshape(B, -1))
        cls_preds = torch.cat(cls_outs, dim=1).reshape(B, -1, self.num_classes + 1)
        return cls_preds, torch.cat(box_outs, dim=1)

    def feature_shapes(self, image_size):
        """The sources' static (H, W) at ``image_size``², which fix the
        anchors."""
        s = image_size
        s //= 2
        s //= 2                             # conv1, conv2
        s = -(-s // 2)                      # conv3's ceil pool
        shapes = [s]                        # conv4 source
        s //= 2                             # pool4 (pool5 and fc6 keep the size)
        shapes.append(s)
        for _ in self.cfg["extra"]:
            s = -(-s // 2)                  # stride 2, pad 1
            shapes.append(s)
        for _ in range(self.cfg["tail"]):
            s = s - 2                       # 3x3 valid conv
            shapes.append(s)
        return [(h, h) for h in shapes]

    def make_anchors(self, image_size):
        """The fp32 anchors (A, 4) at ``image_size``², the reference's
        MultiBoxPrior menu source by source, on the model's device.  Built on
        the CPU from the sources' shapes (``multibox_prior`` reads only
        them) and copied once."""
        parts = []
        for (h, w), sizes, ratios in zip(self.feature_shapes(image_size),
                                         self.cfg["sizes"], self.cfg["ratios"]):
            parts.append(ops_det.multibox_prior(
                torch.empty((1, 1, h, w)), sizes=tuple(sizes),
                ratios=tuple(ratios))[0])
        return torch.cat(parts, dim=0).to(self.device)
