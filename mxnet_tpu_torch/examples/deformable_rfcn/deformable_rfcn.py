"""Deformable R-FCN on the imperative frontend: a copy of
``examples/deformable_rfcn/deformable_rfcn.py`` written against
``mxnet_tpu_torch`` (``import mxnet_tpu_torch as mx``).

Backbone convs -> a deformable conv block (offsets learned by a plain conv)
-> RPN + MultiProposal -> position-sensitive score / bbox maps ->
DeformablePSROIPooling with learned per-roi ``trans`` offsets -> per-roi
classification and box deltas.  On the card ``F.contrib`` reaches the
port's CUDA kernels: ``dconv_col`` / ``dconv_col_bwd``
(DeformableConvolution), ``nms_alive`` (MultiProposal), ``psroi_abuild`` /
``psroi_abuild_bwd`` (DeformablePSROIPooling).  The parameter names are
the JAX example's (``backbone_down0_weight``, ...), so
``gluon.model_zoo.load_jax_params`` carries its weights across.
"""
from __future__ import annotations

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import HybridBlock, nn
from mxnet_tpu_torch.gluon import loss as gloss

from . import rcnn_helpers

__all__ = ["Backbone", "RPN", "DeformableRFCN", "rpn_losses", "rfcn_losses"]


class Backbone(HybridBlock):
    """Strided conv trunk ending at stride 8, with one deformable conv
    block at the end."""

    def __init__(self, channels=(16, 32, 64), defconv_filters=64, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            for i, ch in enumerate(channels):
                self.body.add(nn.Conv2D(ch, 3, strides=2, padding=1, prefix="down%d_" % i))
                self.body.add(nn.BatchNorm())
                self.body.add(nn.Activation("relu"))
            # offsets of a 3x3 deformable conv: 2*3*3 = 18 channels, zero
            # (it starts as a regular conv and learns its sampling)
            self.offset_conv = nn.Conv2D(
                18, 3, padding=1, weight_initializer="zeros",
                bias_initializer="zeros", prefix="offset_")
            self.def_weight = self.params.get(
                "defconv_weight", shape=(defconv_filters, channels[-1], 3, 3),
                init=mx.init.Xavier())
            self.def_bias = self.params.get(
                "defconv_bias", shape=(defconv_filters,), init="zeros")

    def hybrid_forward(self, F, x, def_weight, def_bias):
        feat = self.body(x)
        offsets = self.offset_conv(feat)
        return F.contrib.DeformableConvolution(
            feat, offsets, def_weight, def_bias,
            kernel=(3, 3), num_filter=def_weight.shape[0], pad=(1, 1),
            num_deformable_group=1)


class RPN(HybridBlock):
    def __init__(self, num_anchors, channels=64, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.conv = nn.Conv2D(channels, 3, padding=1, prefix="conv_")
            self.cls = nn.Conv2D(2 * num_anchors, 1, prefix="cls_")
            self.bbox = nn.Conv2D(4 * num_anchors, 1, prefix="bbox_")

    def hybrid_forward(self, F, x):
        t = F.relu(self.conv(x))
        return self.cls(t), self.bbox(t)


class DeformableRFCN(HybridBlock):
    """R-FCN head: position-sensitive maps and deformable PSROI pooling;
    the trans branch's maps are pooled without deformation first, giving
    the per-roi offsets of the second (deformable) pooling."""

    def __init__(self, num_classes=2, num_anchors=9, pooled_size=3,
                 stride=8, rpn_post_nms=32, **kw):
        super().__init__(**kw)
        self.num_classes = num_classes
        self.p = pooled_size
        self.stride = stride
        self.rpn_post_nms = rpn_post_nms
        self.num_anchors = num_anchors
        self.scales = (2, 4, 8)
        self.ratios = (0.5, 1, 2)
        with self.name_scope():
            self.backbone = Backbone(prefix="backbone_")
            self.rpn = RPN(num_anchors, prefix="rpn_")
            cpp = (num_classes + 1) * pooled_size * pooled_size
            self.ps_cls = nn.Conv2D(cpp, 1, prefix="pscls_")
            self.ps_bbox = nn.Conv2D(4 * pooled_size * pooled_size, 1, prefix="psbbox_")
            self.ps_trans = nn.Conv2D(2, 1, weight_initializer="zeros",
                                      bias_initializer="zeros", prefix="pstrans_")

    def hybrid_forward(self, F, data, im_info):
        feat = self.backbone(data)
        rpn_cls, rpn_bbox = self.rpn(feat)
        rpn_prob = F.softmax(F.Reshape(rpn_cls, shape=(0, 2, -1)), axis=1)
        rpn_prob = F.reshape_like(rpn_prob, rpn_cls)
        rois = F.contrib.MultiProposal(
            rpn_prob, rpn_bbox, im_info,
            feature_stride=self.stride, scales=(2, 4, 8), ratios=(0.5, 1, 2),
            rpn_pre_nms_top_n=128, rpn_post_nms_top_n=self.rpn_post_nms,
            threshold=0.7, rpn_min_size=4)  # (B*post, 5)
        cls_maps = self.ps_cls(feat)
        bbox_maps = self.ps_bbox(feat)
        trans_maps = self.ps_trans(feat)
        ss = 1.0 / self.stride
        trans = F.contrib.DeformablePSROIPooling(
            trans_maps, rois, spatial_scale=ss, output_dim=2,
            group_size=1, pooled_size=self.p, no_trans=True)  # (R, 2, p, p)
        cls = F.contrib.DeformablePSROIPooling(
            cls_maps, rois, trans, spatial_scale=ss,
            output_dim=self.num_classes + 1, group_size=self.p,
            pooled_size=self.p, trans_std=0.1)  # (R, C+1, p, p)
        bbox = F.contrib.DeformablePSROIPooling(
            bbox_maps, rois, trans, spatial_scale=ss, output_dim=4,
            group_size=self.p, pooled_size=self.p, trans_std=0.1)  # (R, 4, p, p)
        cls_score = F.Reshape(cls, shape=(0, 0, -1)).mean(axis=2)
        bbox_pred = F.Reshape(bbox, shape=(0, 0, -1)).mean(axis=2)
        return rois, cls_score, bbox_pred, rpn_cls, rpn_bbox


def _roi_targets(rois_np, gt_np, iou_fg=0.5):
    """Host-side per-roi class labels and box targets from IoU against
    the ground truth (no gradient)."""
    boxes = rois_np[:, 1:]
    bidx = rois_np[:, 0].astype(np.int32)
    R = boxes.shape[0]
    labels = np.zeros((R,), np.float32)
    tgt = np.zeros((R, 4), np.float32)
    for b in np.unique(bidx):
        sel = np.where(bidx == b)[0]
        g = gt_np[b]
        g = g[g[:, 0] >= 0]
        if not len(g):
            continue
        iou = rcnn_helpers._np_iou(boxes[sel], g[:, 1:])  # (r, G)
        j = iou.argmax(axis=1)
        fg = iou.max(axis=1) >= iou_fg
        labels[sel[fg]] = g[j[fg], 0] + 1  # background = 0
        bx = boxes[sel]
        gb = g[j, 1:]
        bw = np.maximum(bx[:, 2] - bx[:, 0], 1.0)
        bh = np.maximum(bx[:, 3] - bx[:, 1], 1.0)
        t = np.stack([
            ((gb[:, 0] + gb[:, 2]) / 2 - (bx[:, 0] + bx[:, 2]) / 2) / bw,
            ((gb[:, 1] + gb[:, 3]) / 2 - (bx[:, 1] + bx[:, 3]) / 2) / bh,
            np.log(np.maximum(gb[:, 2] - gb[:, 0], 1.0) / bw),
            np.log(np.maximum(gb[:, 3] - gb[:, 1], 1.0) / bh),
        ], axis=1)
        tgt[sel[fg]] = t[fg]
    return labels, tgt


def rpn_losses(net, rpn_cls, rpn_bbox, gt_boxes, im_info, anchor_rng=None):
    """RPN classification and box losses through the shared anchor
    assignment (without them the RPN gets no gradient: roi coordinates
    enter the pooling through a round())."""
    B, _, hf, wf = rpn_cls.shape
    A = net.num_anchors
    labs, bts, bws = [], [], []
    gt_np = gt_boxes.asnumpy()
    info_np = im_info.asnumpy()
    for b in range(B):
        lab, bt, bw = rcnn_helpers.assign_anchor(
            (hf, wf), gt_np[b], info_np[b], stride=net.stride,
            scales=net.scales, ratios=net.ratios, rng=anchor_rng)
        labs.append(lab)
        bts.append(bt)
        bws.append(bw)
    ctx = rpn_cls.context
    rpn_label = nd.array(np.stack(labs), ctx=ctx)
    rpn_bt = nd.array(np.stack(bts), ctx=ctx)
    rpn_bw = nd.array(np.stack(bws), ctx=ctx)

    logits = nd.transpose(
        nd.reshape(rpn_cls, shape=(B, 2, A, hf, wf)), axes=(0, 3, 4, 2, 1))
    logits = nd.reshape(logits, shape=(B, hf * wf * A, 2))
    ce = gloss.SoftmaxCrossEntropyLoss()
    valid = rpn_label >= 0
    cls_loss = (
        nd.reshape(ce(nd.reshape(logits, shape=(-1, 2)),
                      nd.reshape(nd.maximum(rpn_label, 0.0), shape=(-1,))),
                   shape=rpn_label.shape) * valid
    ).sum() / nd.maximum(valid.sum(), 1.0)

    bp = nd.transpose(nd.reshape(rpn_bbox, shape=(B, A, 4, hf, wf)), axes=(0, 3, 4, 1, 2))
    bp = nd.reshape(bp, shape=(B, hf * wf * A, 4))
    bbox_loss = rcnn_helpers.smooth_l1(bp, rpn_bt, rpn_bw, sigma=3.0)
    return cls_loss, bbox_loss


def rfcn_losses(rois, cls_score, bbox_pred, gt_boxes, num_classes, iou_fg=0.5):
    """(cls_loss, bbox_loss): targets on the host, the losses as recorded
    nd operations, so that gradients reach the score and box branches."""
    labels_np, tgt_np = _roi_targets(rois.asnumpy(), gt_boxes.asnumpy(), iou_fg)
    labels = nd.array(labels_np, ctx=cls_score.context)
    tgt = nd.array(tgt_np, ctx=cls_score.context)

    ce = gloss.SoftmaxCrossEntropyLoss()
    cls_loss = ce(cls_score, labels).mean()

    fg = nd.reshape(labels > 0, shape=(-1, 1))
    diff = nd.abs(bbox_pred - tgt)
    smooth = nd.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    bbox_loss = (smooth * fg).sum() / nd.maximum(fg.sum(), 1.0)
    return cls_loss, bbox_loss
