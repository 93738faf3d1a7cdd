"""Detection model zoo — Deformable R-FCN (ResNet-101) and Faster R-CNN
(VGG16), inference and the training forward (counterpart of
``mxnet_tpu/gluon/model_zoo/detection.py``).  Faster R-CNN is described at
its class; the rest of this note is R-FCN's.

Architecture (Deformable-ConvNets R-FCN recipe), built as in the JAX
package, so that every block gets the same Gluon name:

* ResNet-101 trunk: conv1 + res2..res4 at stride 16, BatchNorm on running
  statistics (frozen, ``use_global_stats``) or, with ``frozen_bn=False``,
  on batch statistics in training mode; no gradient reaches conv1 and res2
  (``BlockGrad``);
* res5 at dilation 2 and stride 1, its three 3×3 convs deformable
  (num_deformable_group=4);
* RPN on res4; proposals by MultiProposal (greedy NMS, pre/post counts
  6000/300);
* R-FCN head: 1×1 ``conv_new`` (256), position-sensitive score, class-agnostic
  box and offset maps, deformable PS-ROI pooling with per-bin offsets pooled
  from the offset maps (trans_std=0.1); class scores and deltas are the bin
  means.

The training forward adds the RPN anchor targets and the sampled R-CNN
targets (``ops/rcnn_targets.py``) and returns every loss ingredient; the
losses and the optimizer step are ``mxnet_tpu_torch/train_fused.py`` (and
``train_frcnn.py`` for Faster R-CNN).
"""
from __future__ import annotations

import math

import torch

from ...context import full_fp32, resolve_device
from ...ops import detection as ops_det
from ...ops import elemwise as ops_elemwise
from ...ops import matrix as ops_matrix
from ...ops import nn as ops_nn
from ...ops import rcnn_targets
from .. import nn
from ..block import HybridBlock

__all__ = ["DeformableConv2D", "DeformableRFCN", "FasterRCNN", "faster_rcnn_vgg16",
           "rfcn_resnet101"]


class DeformableConv2D(HybridBlock):
    """3×3 deformable convolution with an offset branch (reference
    deformable_convolution-inl.h:99).  The offset conv is zero-initialised,
    so the block starts as a regular convolution.  ``device`` None means
    CUDA, and raises without it (pass ``"cpu"`` to run on the CPU)."""

    def __init__(self, channels, in_channels, kernel_size=3, strides=1,
                 padding=1, dilation=1, num_deformable_group=1, prefix=None,
                 device=None):
        super().__init__(prefix=prefix)
        device = resolve_device(device)
        self._kwargs = dict(
            kernel=(kernel_size, kernel_size), num_filter=channels,
            stride=(strides, strides), pad=(padding, padding),
            dilate=(dilation, dilation),
            num_deformable_group=num_deformable_group, no_bias=True)
        k2 = kernel_size * kernel_size
        with self.name_scope():
            self.offset = nn.Conv2D(
                2 * k2 * num_deformable_group, kernel_size, strides=strides,
                padding=padding, dilation=dilation, in_channels=in_channels,
                prefix="offset_", device=device)
        self.weight = torch.nn.Parameter(torch.empty(
            channels, in_channels, kernel_size, kernel_size, device=device))
        self.bias = None
        self.gluon_params = ("weight",)

    def forward(self, x):
        return ops_det.deformable_convolution(
            x, self.offset(x), self.weight, **self._kwargs)


class _Bottleneck(HybridBlock):
    """ResNet-v1 bottleneck with optional dilation / deformable 3×3."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 dilation=1, deformable=False, frozen_bn=True, prefix=None,
                 device=None):
        super().__init__(prefix=prefix)
        mid = channels // 4
        dev = dict(device=device)
        bn = dict(use_global_stats=frozen_bn, device=device)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(mid, 1, strides=stride, use_bias=False,
                                    in_channels=in_channels, **dev))
            self.body.add(nn.BatchNorm(in_channels=mid, **bn))
            self.body.add(nn.Activation("relu"))
            if deformable:
                self.body.add(DeformableConv2D(
                    mid, mid, 3, strides=1, padding=dilation,
                    dilation=dilation, num_deformable_group=4, **dev))
            else:
                self.body.add(nn.Conv2D(
                    mid, 3, strides=1, padding=dilation, dilation=dilation,
                    use_bias=False, in_channels=mid, **dev))
            self.body.add(nn.BatchNorm(in_channels=mid, **bn))
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(channels, 1, strides=1, use_bias=False,
                                    in_channels=mid, **dev))
            self.body.add(nn.BatchNorm(in_channels=channels, **bn))
            if downsample:
                self.downsample = nn.HybridSequential(prefix="down_")
                self.downsample.add(nn.Conv2D(
                    channels, 1, strides=stride, use_bias=False,
                    in_channels=in_channels, **dev))
                self.downsample.add(nn.BatchNorm(in_channels=channels, **bn))
            else:
                self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class _ResStage(HybridBlock):
    def __init__(self, units, channels, stride, in_channels, dilation=1,
                 deformable=False, frozen_bn=True, prefix=None, device=None):
        super().__init__(prefix=prefix)
        with self.name_scope():
            self.stage = nn.HybridSequential(prefix="")
            self.stage.add(_Bottleneck(
                channels, stride, True, in_channels=in_channels,
                dilation=dilation, deformable=deformable, frozen_bn=frozen_bn,
                prefix="unit1_", device=device))
            for i in range(units - 1):
                self.stage.add(_Bottleneck(
                    channels, 1, False, in_channels=channels,
                    dilation=dilation, deformable=deformable,
                    frozen_bn=frozen_bn, prefix="unit%d_" % (i + 2),
                    device=device))

    def forward(self, x):
        return self.stage(x)


class _RPNDetector(HybridBlock):
    """What Deformable R-FCN and Faster R-CNN share: the RPN's proposals,
    the training targets, the input checks and the two forwards.  A
    subclass builds its layers and gives ``_maps`` (data -> the RPN's input
    map and the head's), ``_rpn`` and ``_head``; ``class_agnostic`` and
    ``box_stds`` set its R-CNN targets."""

    class_agnostic = True
    box_stds = None

    def _init_rpn(self, classes, image_shape, align, scales, ratios, rpn_pre_nms,
                  rpn_post_nms, rpn_min_size, batch_rois, fg_fraction, rpn_batch,
                  max_gts):
        self.classes = int(classes)
        self.stride = 16
        self.scales = tuple(scales)
        self.ratios = tuple(ratios)
        self.num_anchors = len(self.scales) * len(self.ratios)
        self.image_shape = tuple(image_shape)
        H, W = self.image_shape
        if H % align or W % align:
            raise ValueError("image_shape must be divisible by %d, got %r"
                             % (align, self.image_shape))
        self.feat_shape = (H // self.stride, W // self.stride)
        self.rpn_pre_nms = int(rpn_pre_nms)
        self.rpn_post_nms = int(rpn_post_nms)
        self.rpn_min_size = int(rpn_min_size) or self.stride
        self.batch_rois = int(batch_rois)
        self.fg_fraction = float(fg_fraction)
        self.rpn_batch = int(rpn_batch)
        self.max_gts = int(max_gts)

    def _rpn(self, x):
        t = self.rpn_conv(x)
        return self.rpn_cls(t), self.rpn_bbox(t)

    def _proposals(self, rpn_cls, rpn_bbox, im_info):
        """MultiProposal on the RPN outputs; the rois carry no gradient."""
        Hf, Wf = self.feat_shape
        # (B,2A,Hf,Wf) -> (B,2,A·Hf,Wf): softmax over background/foreground
        score = ops_matrix.reshape(rpn_cls, (0, 2, -1, 0))
        prob = ops_nn.softmax(score, axis=1)
        prob = ops_matrix.reshape(prob, (0, 2 * self.num_anchors, Hf, Wf))
        return ops_det.multi_proposal(
            prob, rpn_bbox, im_info, rpn_pre_nms_top_n=self.rpn_pre_nms,
            rpn_post_nms_top_n=self.rpn_post_nms, threshold=0.7,
            rpn_min_size=self.rpn_min_size, scales=self.scales,
            ratios=self.ratios, feature_stride=self.stride)

    def _targets(self, rois, gt_boxes, im_info, nz_rpn, nz_prop):
        B = gt_boxes.shape[0]
        Hf, Wf = self.feat_shape
        rpn = rcnn_targets.rpn_anchor_target(
            gt_boxes, im_info, nz_rpn, feat_height=Hf, feat_width=Wf,
            feature_stride=self.stride, scales=self.scales, ratios=self.ratios,
            batch_rois=self.rpn_batch, fg_fraction=0.5)
        rcnn = rcnn_targets.proposal_target(
            rois, gt_boxes, nz_prop, num_classes=self.classes + 1, batch_images=B,
            batch_rois=self.batch_rois * B, fg_fraction=self.fg_fraction,
            class_agnostic=self.class_agnostic, box_stds=self.box_stds)
        return rpn, rcnn

    def _check(self, name, t, shape):
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s must be %s, got %s" % (name, tuple(shape),
                                                         tuple(t.shape)))
        if t.device != self.device:
            raise ValueError("inputs must be on the model's device %s"
                             % self.device)

    def _forward(self, dtype, data, im_info, gt_boxes, nz_rpn, nz_prop, head_args=()):
        """Inference without ``gt_boxes``, else the training forward; the
        head gets ``head_args`` in training."""
        H, W = self.image_shape
        B = data.shape[0]
        self._check("data", data, (B, 3, H, W))
        self._check("im_info", im_info, (B, 3))
        if data.dtype != dtype:
            raise ValueError("data is %s and the model's parameters %s: cast "
                             "one to the other" % (data.dtype, dtype))
        if gt_boxes is None:
            with torch.inference_mode(), full_fp32():
                rpn_in, head_in = self._maps(data)
                rpn_cls, rpn_bbox = self._rpn(rpn_in)
                rois = self._proposals(rpn_cls, rpn_bbox, im_info)
                cls_score, bbox_pred = self._head(
                    head_in, rois, rois_per_image=self.rpn_post_nms)
                return rois, ops_nn.softmax(cls_score, axis=-1), bbox_pred
        Hf, Wf = self.feat_shape
        self._check("gt_boxes", gt_boxes, (B, self.max_gts, 5))
        self._check("nz_rpn", nz_rpn, (B, Hf * Wf * self.num_anchors, 2))
        self._check("nz_prop", nz_prop, (B, self.rpn_post_nms + self.max_gts, 2))
        with full_fp32():
            rpn_in, head_in = self._maps(data)
            rpn_cls, rpn_bbox = self._rpn(rpn_in)
            rois = self._proposals(rpn_cls, rpn_bbox, im_info)
            (rpn_label, rpn_bt, rpn_bw), (rois_s, label, bbox_target, bbox_weight) = (
                self._targets(rois, gt_boxes, im_info, nz_rpn, nz_prop))
            cls_score, bbox_pred = self._head(head_in, rois_s, self.batch_rois,
                                              *head_args)
        return (rpn_cls, rpn_bbox, rpn_label, rpn_bt, rpn_bw,
                rois_s, label, bbox_target, bbox_weight, cls_score, bbox_pred)


class DeformableRFCN(_RPNDetector):
    """Deformable R-FCN: inference and the training forward.

    Inference: ``net(data, im_info) -> (rois, cls_prob, bbox_pred)``: data
    (B, 3, H, W) at ``image_shape``; im_info (B, 3) ``[height, width,
    scale]``; rois (B·rpn_post_nms, 5) ``[batch_idx, x1, y1, x2, y2]``;
    cls_prob (B·rpn_post_nms, classes + 1); bbox_pred (B·rpn_post_nms, 8).
    It runs under ``torch.inference_mode()``.

    Training: ``net(data, im_info, gt_boxes, nz_rpn, nz_prop)`` returns the
    JAX model's 11 loss ingredients ``(rpn_cls, rpn_bbox, rpn_label, rpn_bt,
    rpn_bw, rois, label, bbox_target, bbox_weight, cls_score, bbox_pred)``:
    gt_boxes (B, max_gts, 5) rows ``[cls, x1, y1, x2, y2]`` padded with −1;
    nz_rpn (B, Hf·Wf·A, 2) and nz_prop (B, rpn_post_nms + max_gts, 2) are
    the uniform noise that drives the target subsampling (the caller draws
    it).  The sampled rois (B·batch_rois) carry no gradient.

    Both forwards compute in the dtype of the parameters and of ``data``,
    which must agree: float32, or bfloat16 after ``cast("bfloat16")`` (or
    under the bf16 train step, which hands bf16 copies of the fp32 weights
    in).  Box and coordinate math stays fp32 either way: ``im_info``,
    ``gt_boxes`` and the noise are fp32, MultiProposal upcasts its inputs,
    so the rois and every target are fp32, and the PS-ROI sample
    coordinates are fp32.  In bf16 the rois come out fp32 and cls_prob and
    bbox_pred bf16, as the JAX model's.  Both forwards turn TF32 and
    cuBLAS's reduced-precision bf16 reductions off and restore the caller's
    settings after (``context.full_fp32``).

    Parameters
    ----------
    classes : number of foreground classes (COCO: 80).
    image_shape : static (H, W), divisible by 32.
    units : bottleneck counts per stage — (3, 4, 23, 3) = ResNet-101.
    pooled_size : PS-ROI bins per side (k).
    scales, ratios : anchor scales and aspect ratios.
    rpn_pre_nms, rpn_post_nms, rpn_min_size : MultiProposal's counts and
        minimum box size (0 means the feature stride).
    batch_rois, fg_fraction : sampled rois per image and their foreground
        share (R-CNN targets).
    rpn_batch : sampled anchors per image (RPN targets).
    max_gts : ground-truth rows per image.
    frozen_bn : every trunk BatchNorm on running statistics
        (``use_global_stats``, the default); ``False``: batch statistics in
        training mode (the train step's), folded into the running ones,
        which the net uses in eval mode (serving).  The net is built in
        eval mode.
    device : where the weights live; None means CUDA, and raises without it
        (pass ``"cpu"`` to run on the CPU).
    generator : ``torch.Generator`` for the random initial weights.
    """

    def __init__(self, classes=80, image_shape=(608, 1024),
                 units=(3, 4, 23, 3), pooled_size=7, scales=(4, 8, 16, 32),
                 ratios=(0.5, 1, 2), rpn_pre_nms=6000, rpn_post_nms=300,
                 rpn_min_size=0, batch_rois=128, fg_fraction=0.25,
                 rpn_batch=256, max_gts=100, frozen_bn=True, device=None,
                 generator=None, prefix=None):
        super().__init__(prefix=prefix)
        self.device = resolve_device(device)
        self.k = int(pooled_size)
        self._init_rpn(classes, image_shape, 32, scales, ratios, rpn_pre_nms,
                       rpn_post_nms, rpn_min_size, batch_rois, fg_fraction,
                       rpn_batch, max_gts)
        k2 = self.k * self.k
        A = self.num_anchors
        dev = dict(device=self.device)
        trunk = dict(frozen_bn=frozen_bn, **dev)
        with self.name_scope():
            self.conv1 = nn.HybridSequential(prefix="conv1_")
            self.conv1.add(nn.Conv2D(64, 7, 2, 3, use_bias=False, in_channels=3, **dev))
            self.conv1.add(nn.BatchNorm(in_channels=64, use_global_stats=frozen_bn, **dev))
            self.conv1.add(nn.Activation("relu"))
            self.conv1.add(nn.MaxPool2D(3, 2, 1))
            self.res2 = _ResStage(units[0], 256, 1, 64, prefix="res2_", **trunk)
            self.res3 = _ResStage(units[1], 512, 2, 256, prefix="res3_", **trunk)
            self.res4 = _ResStage(units[2], 1024, 2, 512, prefix="res4_", **trunk)
            self.res5 = _ResStage(units[3], 2048, 1, 1024, dilation=2,
                                  deformable=True, prefix="res5_", **trunk)
            self.rpn_conv = nn.Conv2D(512, 3, padding=1, activation="relu",
                                      in_channels=1024, prefix="rpn_conv_", **dev)
            self.rpn_cls = nn.Conv2D(2 * A, 1, in_channels=512, prefix="rpn_cls_", **dev)
            self.rpn_bbox = nn.Conv2D(4 * A, 1, in_channels=512, prefix="rpn_bbox_", **dev)
            self.conv_new = nn.Conv2D(256, 1, activation="relu", in_channels=2048,
                                      prefix="conv_new_", **dev)
            self.rfcn_cls = nn.Conv2D((self.classes + 1) * k2, 1, in_channels=256,
                                      prefix="rfcn_cls_", **dev)
            self.rfcn_bbox = nn.Conv2D(8 * k2, 1, in_channels=256,
                                       prefix="rfcn_bbox_", **dev)
            # conv-branch offset fields, zero-initialised: plain PS-ROI
            # pooling until trained
            self.rfcn_trans = nn.Conv2D(2 * k2, 1, in_channels=256,
                                        prefix="rfcn_trans_", **dev)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Random initial weights, drawn on the CPU from ``generator``.

        Trunk convs N(0, 1/fan_in), prediction convs N(0, 0.01²) (the
        recipe's head init), biases 0, BatchNorm at identity statistics;
        the deformable offset convs and ``rfcn_trans`` zero, as the JAX
        model initialises them.
        """
        heads = {id(m) for m in (self.rpn_cls, self.rpn_bbox, self.rfcn_cls,
                                 self.rfcn_bbox)}
        zero = {id(self.rfcn_trans)} | {
            id(m.offset) for m in self.modules() if isinstance(m, DeformableConv2D)}
        for m in self.modules():
            if not isinstance(m, (nn.Conv2D, DeformableConv2D)):
                continue
            w = m.weight
            if id(m) in zero:
                w.zero_()
            else:
                std = 0.01 if id(m) in heads else 1.0 / math.sqrt(w[0].numel())
                w.copy_(torch.randn(w.shape, generator=generator) * std)
            if m.bias is not None:
                m.bias.zero_()

    # -- pieces -----------------------------------------------------------

    def _features(self, x):
        # conv1 and res2 are fixed: no gradient reaches them (BlockGrad)
        c2 = ops_elemwise.block_grad(self.res2(self.conv1(x)))
        c4 = self.res4(self.res3(c2))
        return c4, self.res5(c4)

    def _maps(self, x):
        return self._features(x)

    def _head(self, c5, rois, rois_per_image=0):
        """Deformable PS-ROI scoring of ``rois`` -> (cls_score, bbox_pred);
        ``rois_per_image`` > 0 promises batch-major grouped rois."""
        k = self.k
        feat = self.conv_new(c5)
        ss = 1.0 / self.stride
        rpi = int(rois_per_image)
        # stage 1: per-bin offsets pooled from the offset fields
        trans = ops_det.deformable_psroi_pooling(
            self.rfcn_trans(feat), rois, spatial_scale=ss, output_dim=2,
            group_size=k, pooled_size=k, part_size=k, no_trans=True,
            rois_per_image=rpi)  # (R, 2, k, k)
        cls = ops_det.deformable_psroi_pooling(
            self.rfcn_cls(feat), rois, trans, spatial_scale=ss,
            output_dim=self.classes + 1, group_size=k, pooled_size=k,
            part_size=k, trans_std=0.1, rois_per_image=rpi)  # (R, C+1, k, k)
        bbox = ops_det.deformable_psroi_pooling(
            self.rfcn_bbox(feat), rois, trans, spatial_scale=ss, output_dim=8,
            group_size=k, pooled_size=k, part_size=k, trans_std=0.1,
            rois_per_image=rpi)  # (R, 8, k, k)
        cls_score = ops_matrix.reshape(cls, (0, 0, -1)).mean(dim=2)
        bbox_pred = ops_matrix.reshape(bbox, (0, 0, -1)).mean(dim=2)
        return cls_score, bbox_pred

    # -- forward ----------------------------------------------------------

    def forward(self, data, im_info, gt_boxes=None, nz_rpn=None, nz_prop=None):
        return self._forward(self.rfcn_cls.weight.dtype, data, im_info, gt_boxes,
                             nz_rpn, nz_prop)


def rfcn_resnet101(classes=80, image_shape=(608, 1024), **kwargs):
    """Deformable R-FCN with the ResNet-101 trunk; ``device=`` defaults to
    CUDA (see :class:`DeformableRFCN`)."""
    return DeformableRFCN(classes=classes, image_shape=image_shape,
                          units=(3, 4, 23, 3), **kwargs)


class FasterRCNN(_RPNDetector):
    """Faster R-CNN with a VGG trunk: inference and the training forward
    (the JAX package's ``FasterRCNN``, BASELINE config 2: the reference's
    ``example/rcnn`` end-to-end recipe, symbol ``symbol_vgg.py``).

    The trunk is ``len(units)`` = 5 stages of 3×3 convs with ReLU, a 2×2
    max-pool between stages (none after the last: stride 16); no gradient
    reaches conv1 and conv2 (``BlockGrad`` after conv2).  The RPN runs on
    conv5's map; proposals by MultiProposal.  The head is 7×7 ROIPooling at
    1/16, then fc6 and fc7 (``fc_hidden``, ReLU, each followed by dropout),
    then the class scores and the class-specific box deltas, 4·(classes +
    1) of them.

    Inference: ``net(data, im_info) -> (rois, cls_prob, bbox_pred)``, rois
    (B·rpn_post_nms, 5), cls_prob (B·rpn_post_nms, classes + 1) and
    bbox_pred (B·rpn_post_nms, 4·(classes + 1)), under
    ``torch.inference_mode()``; dropout is the identity (eval mode).

    Training: ``net(data, im_info, gt_boxes, nz_rpn, nz_prop, keep6,
    keep7)`` returns the 11 loss ingredients of :class:`DeformableRFCN`'s
    training forward, with class-specific targets normalised by
    ``box_stds``.  ``keep6`` and ``keep7`` are the two dropout layers' keep
    masks, bool (B·batch_rois, fc_hidden), which the caller draws as it
    draws the noise; in training mode without them the dropout layers draw
    from their ``generator`` (None: they raise).

    dtypes and TF32 as :class:`DeformableRFCN`; ROIPooling's bin bounds are
    fp32 whatever the data dtype.

    Parameters
    ----------
    classes : foreground classes (VOC: 20).
    image_shape : static (H, W), divisible by 16.
    filters, units : the five stages' widths and conv counts; the defaults
        are VGG16's.
    fc_hidden : fc6 and fc7 width.
    pooled_size : ROIPooling bins per side.
    scales, ratios, rpn_pre_nms, rpn_post_nms, rpn_min_size, batch_rois,
        fg_fraction, rpn_batch, max_gts : as :class:`DeformableRFCN`'s; the
        proposal counts default to the reference's TRAIN ones, 12000/2000.
    box_stds : the R-CNN box targets' divisors (None: not normalised).
    dropout : fc6's and fc7's dropout rate.
    device : where the weights live; None means CUDA, and raises without it
        (pass ``"cpu"`` to run on the CPU).
    generator : ``torch.Generator`` for the random initial weights.
    """

    class_agnostic = False

    def __init__(self, classes=20, image_shape=(608, 1024),
                 filters=(64, 128, 256, 512, 512), units=(2, 2, 3, 3, 3),
                 fc_hidden=4096, pooled_size=7, scales=(8, 16, 32),
                 ratios=(0.5, 1, 2), rpn_pre_nms=12000, rpn_post_nms=2000,
                 rpn_min_size=0, batch_rois=128, fg_fraction=0.25, rpn_batch=256,
                 max_gts=100, box_stds=(0.1, 0.1, 0.2, 0.2), dropout=0.5,
                 device=None, generator=None, prefix=None):
        super().__init__(prefix=prefix)
        if len(units) != 5 or len(filters) != 5:
            raise ValueError("FasterRCNN trunk needs exactly 5 stages (VGG "
                             "topology), got units=%r" % (units,))
        self.device = resolve_device(device)
        self._init_rpn(classes, image_shape, 16, scales, ratios, rpn_pre_nms,
                       rpn_post_nms, rpn_min_size, batch_rois, fg_fraction,
                       rpn_batch, max_gts)
        self.pooled = int(pooled_size)
        self.fc_hidden = int(fc_hidden)
        self.box_stds = tuple(box_stds) if box_stds is not None else None
        A = self.num_anchors
        C1 = self.classes + 1
        dev = dict(device=self.device)
        rpn_width = min(512, filters[-1] * 2)
        with self.name_scope():
            self.stages = []
            width = 3
            for s, (n, f) in enumerate(zip(units, filters)):
                stage = nn.HybridSequential(prefix="conv%d_" % (s + 1))
                with stage.name_scope():
                    for _ in range(n):
                        stage.add(nn.Conv2D(f, 3, padding=1, activation="relu",
                                            in_channels=width, **dev))
                        width = f
                self.stages.append(stage)
                setattr(self, "conv%d" % (s + 1), stage)
            self.rpn_conv = nn.Conv2D(rpn_width, 3, padding=1, activation="relu",
                                      in_channels=width, prefix="rpn_conv_", **dev)
            self.rpn_cls = nn.Conv2D(2 * A, 1, in_channels=rpn_width,
                                     prefix="rpn_cls_", **dev)
            self.rpn_bbox = nn.Conv2D(4 * A, 1, in_channels=rpn_width,
                                      prefix="rpn_bbox_", **dev)
            self.fc6 = nn.Dense(self.fc_hidden, activation="relu",
                                in_units=width * self.pooled ** 2, prefix="fc6_", **dev)
            self.drop6 = nn.Dropout(dropout)
            self.fc7 = nn.Dense(self.fc_hidden, activation="relu",
                                in_units=self.fc_hidden, prefix="fc7_", **dev)
            self.drop7 = nn.Dropout(dropout)
            self.cls_score = nn.Dense(C1, in_units=self.fc_hidden,
                                      prefix="cls_score_", **dev)
            self.bbox_pred = nn.Dense(4 * C1, in_units=self.fc_hidden,
                                      prefix="bbox_pred_", **dev)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Random initial weights, drawn on the CPU from ``generator``: the
        JAX example's ``build_net`` initialiser, ``Xavier(rnd_type=
        "gaussian", factor_type="in", magnitude=2)``, N(0, 2 / fan_in) with
        fan_in = in_channels·kh·kw (in_units for a dense layer); biases 0."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2D, nn.Dense)):
                w = m.weight
                std = math.sqrt(2.0 / w[0].numel())
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if m.bias is not None:
                    m.bias.zero_()

    # -- pieces -----------------------------------------------------------

    def _features(self, x):
        """The trunk -> conv5's map at stride 16.  conv1 and conv2 are the
        reference's fixed parameters: no gradient reaches them."""
        for s, stage in enumerate(self.stages):
            x = stage(x)
            if s == 1:
                x = ops_elemwise.block_grad(x)
            if s < len(self.stages) - 1:
                x = ops_nn.pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
        return x

    def _maps(self, x):
        c5 = self._features(x)
        return c5, c5

    def _head(self, c5, rois, rois_per_image=0, keep6=None, keep7=None):
        """ROIPooling -> fc6, fc7 (dropout after each) -> (cls_score,
        bbox_pred); ``rois_per_image`` > 0 promises batch-major grouped
        rois."""
        pooled = ops_det.roi_pooling(
            c5, rois, pooled_size=(self.pooled, self.pooled),
            spatial_scale=1.0 / self.stride, rois_per_image=int(rois_per_image))
        h = self.drop6(self.fc6(pooled.reshape(pooled.shape[0], -1)), keep6)
        h = self.drop7(self.fc7(h), keep7)
        return self.cls_score(h), self.bbox_pred(h)

    # -- forward ----------------------------------------------------------

    def forward(self, data, im_info, gt_boxes=None, nz_rpn=None, nz_prop=None,
                keep6=None, keep7=None):
        keeps = ()
        if (keep6 is None) != (keep7 is None):
            raise ValueError("keep6 and keep7 are given together or not at all")
        if gt_boxes is not None and keep6 is not None:
            shape = (data.shape[0] * self.batch_rois, self.fc_hidden)
            self._check("keep6", keep6, shape)
            self._check("keep7", keep7, shape)
            keeps = (keep6, keep7)
        return self._forward(self.cls_score.weight.dtype, data, im_info, gt_boxes,
                             nz_rpn, nz_prop, keeps)


def faster_rcnn_vgg16(classes=20, image_shape=(608, 1024), **kwargs):
    """Faster R-CNN with the full VGG16 trunk (BASELINE config 2);
    ``device=`` defaults to CUDA (see :class:`FasterRCNN`)."""
    return FasterRCNN(classes=classes, image_shape=image_shape,
                      filters=(64, 128, 256, 512, 512), units=(2, 2, 3, 3, 3),
                      fc_hidden=4096, **kwargs)
