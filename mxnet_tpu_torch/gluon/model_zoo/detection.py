"""Detection model zoo — Deformable R-FCN (ResNet-101), inference and the
training forward (counterpart of ``mxnet_tpu/gluon/model_zoo/detection.py``).

Architecture (Deformable-ConvNets R-FCN recipe), built as in the JAX
package, so that every block gets the same Gluon name:

* ResNet-101 trunk: conv1 + res2..res4 at stride 16, BatchNorm on running
  statistics (frozen); no gradient reaches conv1 and res2 (``BlockGrad``);
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
losses and the optimizer step are ``mxnet_tpu_torch/train_fused.py``.
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

__all__ = ["DeformableConv2D", "DeformableRFCN", "rfcn_resnet101"]


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
                 dilation=1, deformable=False, prefix=None, device=None):
        super().__init__(prefix=prefix)
        mid = channels // 4
        dev = dict(device=device)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(nn.Conv2D(mid, 1, strides=stride, use_bias=False,
                                    in_channels=in_channels, **dev))
            self.body.add(nn.BatchNorm(in_channels=mid, **dev))
            self.body.add(nn.Activation("relu"))
            if deformable:
                self.body.add(DeformableConv2D(
                    mid, mid, 3, strides=1, padding=dilation,
                    dilation=dilation, num_deformable_group=4, **dev))
            else:
                self.body.add(nn.Conv2D(
                    mid, 3, strides=1, padding=dilation, dilation=dilation,
                    use_bias=False, in_channels=mid, **dev))
            self.body.add(nn.BatchNorm(in_channels=mid, **dev))
            self.body.add(nn.Activation("relu"))
            self.body.add(nn.Conv2D(channels, 1, strides=1, use_bias=False,
                                    in_channels=mid, **dev))
            self.body.add(nn.BatchNorm(in_channels=channels, **dev))
            if downsample:
                self.downsample = nn.HybridSequential(prefix="down_")
                self.downsample.add(nn.Conv2D(
                    channels, 1, strides=stride, use_bias=False,
                    in_channels=in_channels, **dev))
                self.downsample.add(nn.BatchNorm(in_channels=channels, **dev))
            else:
                self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class _ResStage(HybridBlock):
    def __init__(self, units, channels, stride, in_channels, dilation=1,
                 deformable=False, prefix=None, device=None):
        super().__init__(prefix=prefix)
        with self.name_scope():
            self.stage = nn.HybridSequential(prefix="")
            self.stage.add(_Bottleneck(
                channels, stride, True, in_channels=in_channels,
                dilation=dilation, deformable=deformable, prefix="unit1_",
                device=device))
            for i in range(units - 1):
                self.stage.add(_Bottleneck(
                    channels, 1, False, in_channels=channels,
                    dilation=dilation, deformable=deformable,
                    prefix="unit%d_" % (i + 2), device=device))

    def forward(self, x):
        return self.stage(x)


class DeformableRFCN(HybridBlock):
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

    Both forwards compute in full fp32: they turn TF32 off for their
    convolutions and matmuls and restore the caller's setting after
    (``context.full_fp32``).

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
    frozen_bn : BatchNorm on running statistics; ``False`` (batch
        statistics) is not ported and raises.
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
        if not frozen_bn:
            raise NotImplementedError(
                "DeformableRFCN: frozen_bn=False (BatchNorm batch statistics) "
                "is not ported yet; it is ROADMAP.md item A3 (BatchNorm batch "
                "statistics)")
        self.device = resolve_device(device)
        self.classes = int(classes)
        self.k = int(pooled_size)
        self.stride = 16
        self.scales = tuple(scales)
        self.ratios = tuple(ratios)
        self.num_anchors = len(self.scales) * len(self.ratios)
        self.image_shape = tuple(image_shape)
        H, W = self.image_shape
        if H % 32 or W % 32:
            raise ValueError("image_shape must be divisible by 32, got %r"
                             % (self.image_shape,))
        self.feat_shape = (H // self.stride, W // self.stride)
        self.rpn_pre_nms = int(rpn_pre_nms)
        self.rpn_post_nms = int(rpn_post_nms)
        self.rpn_min_size = int(rpn_min_size) or self.stride
        self.batch_rois = int(batch_rois)
        self.fg_fraction = float(fg_fraction)
        self.rpn_batch = int(rpn_batch)
        self.max_gts = int(max_gts)
        k2 = self.k * self.k
        A = self.num_anchors
        dev = dict(device=self.device)
        with self.name_scope():
            self.conv1 = nn.HybridSequential(prefix="conv1_")
            self.conv1.add(nn.Conv2D(64, 7, 2, 3, use_bias=False, in_channels=3, **dev))
            self.conv1.add(nn.BatchNorm(in_channels=64, **dev))
            self.conv1.add(nn.Activation("relu"))
            self.conv1.add(nn.MaxPool2D(3, 2, 1))
            self.res2 = _ResStage(units[0], 256, 1, 64, prefix="res2_", **dev)
            self.res3 = _ResStage(units[1], 512, 2, 256, prefix="res3_", **dev)
            self.res4 = _ResStage(units[2], 1024, 2, 512, prefix="res4_", **dev)
            self.res5 = _ResStage(units[3], 2048, 1, 1024, dilation=2,
                                  deformable=True, prefix="res5_", **dev)
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

    def _rpn(self, c4):
        t = self.rpn_conv(c4)
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

    def _targets(self, rois, gt_boxes, im_info, nz_rpn, nz_prop):
        B = gt_boxes.shape[0]
        Hf, Wf = self.feat_shape
        rpn = rcnn_targets.rpn_anchor_target(
            gt_boxes, im_info, nz_rpn, feat_height=Hf, feat_width=Wf,
            feature_stride=self.stride, scales=self.scales, ratios=self.ratios,
            batch_rois=self.rpn_batch, fg_fraction=0.5)
        rcnn = rcnn_targets.proposal_target(
            rois, gt_boxes, nz_prop, batch_images=B,
            batch_rois=self.batch_rois * B, fg_fraction=self.fg_fraction)
        return rpn, rcnn

    # -- forward ----------------------------------------------------------

    def _check(self, name, t, shape):
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s must be %s, got %s" % (name, tuple(shape),
                                                         tuple(t.shape)))
        if t.device != self.device:
            raise ValueError("inputs must be on the model's device %s"
                             % self.device)

    def forward(self, data, im_info, gt_boxes=None, nz_rpn=None, nz_prop=None):
        H, W = self.image_shape
        B = data.shape[0]
        self._check("data", data, (B, 3, H, W))
        self._check("im_info", im_info, (B, 3))
        if gt_boxes is None:
            with torch.inference_mode(), full_fp32():
                c4, c5 = self._features(data)
                rpn_cls, rpn_bbox = self._rpn(c4)
                rois = self._proposals(rpn_cls, rpn_bbox, im_info)
                cls_score, bbox_pred = self._head(
                    c5, rois, rois_per_image=self.rpn_post_nms)
                return rois, ops_nn.softmax(cls_score, axis=-1), bbox_pred
        Hf, Wf = self.feat_shape
        self._check("gt_boxes", gt_boxes, (B, self.max_gts, 5))
        self._check("nz_rpn", nz_rpn, (B, Hf * Wf * self.num_anchors, 2))
        self._check("nz_prop", nz_prop, (B, self.rpn_post_nms + self.max_gts, 2))
        with full_fp32():
            c4, c5 = self._features(data)
            rpn_cls, rpn_bbox = self._rpn(c4)
            rois = self._proposals(rpn_cls, rpn_bbox, im_info)
            (rpn_label, rpn_bt, rpn_bw), (rois_s, label, bbox_target, bbox_weight) = (
                self._targets(rois, gt_boxes, im_info, nz_rpn, nz_prop))
            cls_score, bbox_pred = self._head(c5, rois_s,
                                              rois_per_image=self.batch_rois)
        return (rpn_cls, rpn_bbox, rpn_label, rpn_bt, rpn_bw,
                rois_s, label, bbox_target, bbox_weight, cls_score, bbox_pred)


def rfcn_resnet101(classes=80, image_shape=(608, 1024), **kwargs):
    """Deformable R-FCN with the ResNet-101 trunk; ``device=`` defaults to
    CUDA (see :class:`DeformableRFCN`)."""
    return DeformableRFCN(classes=classes, image_shape=image_shape,
                          units=(3, 4, 23, 3), **kwargs)
