"""The host-side helpers that ``examples/deformable_rfcn`` takes from
``examples/rcnn/faster_rcnn.py`` (:35-140, :357-363): anchor enumeration
and assignment (reference rcnn/processing/{generate_anchor,assign_anchor},
rcnn/core/loader.py AnchorLoader), IoU, box-regression targets and the
smooth-L1 loss on NDArrays.  Numpy throughout, as the originals."""
from __future__ import annotations

import numpy as np

from ... import ndarray as nd
from ...ops.detection import generate_base_anchors

__all__ = ["generate_anchors", "assign_anchor", "smooth_l1"]


def generate_anchors(stride, scales, ratios):
    """Base anchors, the MultiProposal op's own enumeration."""
    return np.asarray(generate_base_anchors(stride, scales, ratios), np.float32)


def _shift_anchors(base, stride, hf, wf):
    sx = np.arange(wf) * stride
    sy = np.arange(hf) * stride
    sx, sy = np.meshgrid(sx, sy)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()], axis=1)
    all_anchors = base[None, :, :] + shifts[:, None, :].astype(np.float32)
    return all_anchors.reshape(-1, 4)  # (Hf*Wf*A, 4)


def _np_iou(a, b):
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(br - tl + 1, 0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0] + 1) * (a[:, 3] - a[:, 1] + 1)
    area_b = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-12)


def _bbox_transform(ex, gt):
    """Box regression targets (reference rcnn/processing/bbox_transform.py)."""
    ew = ex[:, 2] - ex[:, 0] + 1.0
    eh = ex[:, 3] - ex[:, 1] + 1.0
    ecx = ex[:, 0] + 0.5 * (ew - 1)
    ecy = ex[:, 1] + 0.5 * (eh - 1)
    gw = gt[:, 2] - gt[:, 0] + 1.0
    gh = gt[:, 3] - gt[:, 1] + 1.0
    gcx = gt[:, 0] + 0.5 * (gw - 1)
    gcy = gt[:, 1] + 0.5 * (gh - 1)
    return np.stack([(gcx - ecx) / (ew + 1e-14), (gcy - ecy) / (eh + 1e-14),
                     np.log(gw / ew), np.log(gh / eh)], axis=1).astype(np.float32)


def assign_anchor(feat_shape, gt_boxes, im_info, stride=8, scales=(2, 4, 8),
                  ratios=(0.5, 1, 2), allowed_border=0, batch_rois=256, fg_fraction=0.5,
                  pos_thresh=0.7, neg_thresh=0.3, rng=None):
    """RPN target assignment -> (label (A',), bbox_target (A', 4),
    bbox_weight (A', 4)); ``rng`` a ``RandomState`` for the subsampling
    (None: numpy's global one, as the original)."""
    rng = rng or np.random
    hf, wf = feat_shape
    anchors = _shift_anchors(generate_anchors(stride, scales, ratios), stride, hf, wf)
    total = anchors.shape[0]
    im_h, im_w = im_info[0], im_info[1]
    inds_inside = np.where(
        (anchors[:, 0] >= -allowed_border) & (anchors[:, 1] >= -allowed_border)
        & (anchors[:, 2] < im_w + allowed_border)
        & (anchors[:, 3] < im_h + allowed_border))[0]
    label = np.full(total, -1, np.float32)
    bbox_target = np.zeros((total, 4), np.float32)
    bbox_weight = np.zeros((total, 4), np.float32)
    inside = anchors[inds_inside]
    gt = gt_boxes[gt_boxes[:, 0] >= 0][:, 1:5] if gt_boxes.size else np.zeros((0, 4), np.float32)
    if gt.shape[0]:
        iou = _np_iou(inside, gt)
        argmax = iou.argmax(axis=1)
        max_iou = iou[np.arange(inside.shape[0]), argmax]
        lab_in = np.full(inside.shape[0], -1, np.float32)
        lab_in[max_iou < neg_thresh] = 0
        lab_in[iou.argmax(axis=0)] = 1  # each gt's best anchor is foreground
        lab_in[max_iou >= pos_thresh] = 1
        fg = np.where(lab_in == 1)[0]
        max_fg = int(batch_rois * fg_fraction)
        if len(fg) > max_fg:
            lab_in[rng.choice(fg, len(fg) - max_fg, replace=False)] = -1
        bg = np.where(lab_in == 0)[0]
        max_bg = batch_rois - min(len(np.where(lab_in == 1)[0]), max_fg)
        if len(bg) > max_bg:
            lab_in[rng.choice(bg, len(bg) - max_bg, replace=False)] = -1
        fg = np.where(lab_in == 1)[0]
        bbox_target[inds_inside[fg]] = _bbox_transform(inside[fg], gt[argmax[fg]])
        bbox_weight[inds_inside[fg]] = 1.0
        label[inds_inside] = lab_in
    else:
        lab_in = np.full(inside.shape[0], -1, np.float32)
        lab_in[rng.choice(inside.shape[0], min(batch_rois, inside.shape[0]),
                          replace=False)] = 0
        label[inds_inside] = lab_in
    return label, bbox_target, bbox_weight


def smooth_l1(pred, target, weight, sigma=1.0):
    """Smooth-L1 of ``(pred − target)·weight``, summed over all and
    divided by the batch size (NDArrays)."""
    d = (pred - target) * weight
    s2 = sigma * sigma
    absd = nd.abs(d)
    out = nd.where(absd < 1.0 / s2, 0.5 * s2 * d * d, absd - 0.5 / s2)
    return out.sum() / max(pred.shape[0], 1)
