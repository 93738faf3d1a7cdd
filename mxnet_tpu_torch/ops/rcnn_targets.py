"""Training targets of the RPN and the R-CNN head, on the device
(counterpart of ``mxnet_tpu/ops/rcnn_targets.py``).

Both ops have static output shapes: candidate sets are fixed capacity, and
subsampling keeps the ``limit`` candidates of lowest uniform noise (equal in
distribution to the reference's ``np.random.choice(..., replace=False)``).
The noise is an input, never drawn here.  The JAX package's ``vmap`` over
images is the leading batch dimension here.  Comparisons and selections are
made in the JAX formulas' operation order, so that the IoU thresholds fall
the same way on both sides.  The thresholds are the reference config's
(rcnn/config.py), which neither detector changes.  The R-CNN targets are
class-specific (Faster R-CNN regresses a box per class) or class-agnostic
(R-FCN regresses one box per roi).
"""
from __future__ import annotations

import functools

import torch

from . import kernels
from .detection import _anchors

__all__ = ["rpn_anchor_target", "proposal_target"]

RPN_POS_IOU = 0.7   # an anchor at or above it is foreground
RPN_NEG_IOU = 0.3   # below it, background
FG_OVERLAP = 0.5    # a roi at or above it is foreground, below it background


@functools.lru_cache(maxsize=16)
def _constant(values, dtype, device):
    """``values`` as a tensor on ``device``, copied once per value: a copy
    from host memory synchronises the stream.  Callers only read it."""
    return torch.tensor(values, dtype=dtype, device=device)


def _iou_plus_one(a, b):
    """IoU with the +1 pixel convention (reference rcnn bbox_overlaps):
    areas without clamping, then the shared dense IoU.  a (..., A, 4),
    b (..., B, 4) -> (..., A, B)."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    return kernels.iou_mat(a, area_a, b, area_b, plus_one=1.0)


def _bbox_transform(ex, gt):
    """Box regression targets of corner boxes ``ex`` towards ``gt``, both
    (..., 4) (reference rcnn/processing/bbox_transform.py)."""
    ew = ex[..., 2] - ex[..., 0] + 1.0
    eh = ex[..., 3] - ex[..., 1] + 1.0
    ecx = ex[..., 0] + 0.5 * (ew - 1.0)
    ecy = ex[..., 1] + 0.5 * (eh - 1.0)
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + 0.5 * (gw - 1.0)
    gcy = gt[..., 1] + 0.5 * (gh - 1.0)
    return torch.stack([
        (gcx - ecx) / (ew + 1e-14),
        (gcy - ecy) / (eh + 1e-14),
        torch.log(torch.clamp(gw / ew, min=1e-12)),
        torch.log(torch.clamp(gh / eh, min=1e-12)),
    ], dim=-1)


def _rank_select(mask, noise, limit):
    """Keep at most ``limit`` (an int or a (B,) tensor) True entries of each
    row of ``mask`` (B, n), those of lowest ``noise``.  Returns (kept, order):
    ``order`` lists the candidates first, in noise order, ties by index."""
    n = mask.shape[1]
    key = torch.where(mask, noise, 2.0)  # non-candidates rank last
    order = torch.argsort(key, dim=1, stable=True)
    iota = torch.arange(n, device=mask.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(1, order, iota)
    if torch.is_tensor(limit):
        limit = limit[:, None]
    return mask & (rank < limit), order


def rpn_anchor_target(gt_boxes, im_info, noise, *, feat_height, feat_width,
                      feature_stride=16, scales=(8, 16, 32), ratios=(0.5, 1, 2),
                      batch_rois=256, fg_fraction=0.5):
    """RPN anchor targets (``mxnet_tpu/ops/rcnn_targets.py
    rpn_anchor_target``; reference rcnn/io/rpn.py assign_anchor), at the
    reference config's defaults: IoU thresholds 0.7/0.3 and no border
    allowance (an anchor counts only if it lies wholly inside the image).

    gt_boxes (B, G, 5) rows [cls, x1, y1, x2, y2] padded with −1; im_info
    (B, 3); noise (B, A_total, 2) uniforms driving the fg/bg subsampling.
    Returns label (B, A_total) in {−1 ignore, 0 bg, 1 fg}, bbox_target and
    bbox_weight (B, A_total, 4), anchors in MultiProposal's order
    ``h·(W·A) + w·A + a``.
    """
    Hf, Wf = int(feat_height), int(feat_width)
    stride = float(feature_stride)
    dev = gt_boxes.device
    f32 = torch.float32
    base = _anchors(stride, tuple(scales), tuple(ratios), dev)
    A = base.shape[0]
    total = Hf * Wf * A
    B, G = gt_boxes.shape[:2]
    max_fg = int(round(batch_rois * fg_fraction))

    shift_x = torch.arange(Wf, dtype=f32, device=dev) * stride
    shift_y = torch.arange(Hf, dtype=f32, device=dev) * stride
    shifts = torch.stack([shift_x[None, :, None].expand(Hf, Wf, A),
                          shift_y[:, None, None].expand(Hf, Wf, A),
                          shift_x[None, :, None].expand(Hf, Wf, A),
                          shift_y[:, None, None].expand(Hf, Wf, A)], dim=-1)
    anchors = (shifts + base[None, None, :, :]).reshape(total, 4)

    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    inside = ((anchors[None, :, 0] >= 0) & (anchors[None, :, 1] >= 0)
              & (anchors[None, :, 2] < im_w) & (anchors[None, :, 3] < im_h))  # (B, total)
    gt_valid = gt_boxes[..., 0] >= 0                                 # (B, G)
    has_gt = (gt_valid.sum(1) > 0)[:, None]                          # (B, 1)
    iou = _iou_plus_one(anchors[None], gt_boxes[..., 1:5])           # (B, total, G)
    iou = torch.where(gt_valid[:, None, :] & inside[:, :, None], iou, -1.0)
    argmax = torch.argmax(iou, dim=2)
    max_iou = torch.clamp(iou.max(dim=2).values, min=0.0)

    fg = inside & (max_iou >= RPN_POS_IOU) & has_gt
    # each valid gt's best anchor is fg; a count, so that two gts sharing
    # a best anchor still mark it
    gt_best = torch.argmax(iou, dim=1)                               # (B, G)
    flat = (gt_best + torch.arange(B, device=dev)[:, None] * total).reshape(-1)
    hits = torch.zeros(B * total, dtype=torch.int32, device=dev).index_add_(
        0, flat, gt_valid.reshape(-1).to(torch.int32))
    fg = fg | ((hits.reshape(B, total) > 0) & inside)
    fg_kept, _ = _rank_select(fg, noise[..., 0], max_fg)
    n_fg = fg_kept.sum(1)

    bg = inside & (max_iou < RPN_NEG_IOU) & ~fg & has_gt
    bg = torch.where(has_gt, bg, inside)  # no gt: every inside anchor is bg
    max_bg = batch_rois - torch.clamp(n_fg, max=max_fg)
    bg_kept, _ = _rank_select(bg, noise[..., 1], max_bg)

    label = torch.where(fg_kept, 1.0, torch.where(bg_kept, 0.0, -1.0))
    safe_gt = torch.clamp(argmax, 0, G - 1)
    matched = torch.gather(gt_boxes[..., 1:5], 1, safe_gt[..., None].expand(B, total, 4))
    tgt = _bbox_transform(anchors[None], matched)
    w = fg_kept[..., None].to(f32)
    return label, tgt * w, w.expand(B, total, 4)


def proposal_target(rois, gt_boxes, noise, *, num_classes, batch_images,
                    batch_rois=128, fg_fraction=0.25, class_agnostic=False,
                    box_stds=None):
    """Per-roi training targets (``mxnet_tpu/ops/rcnn_targets.py
    proposal_target``; reference rcnn/symbol/proposal_target.py).

    rois (B·post, 5) batch-major; gt_boxes (B, G, 5) padded with −1; noise
    (B, post + G, 2).  The gt boxes join the candidates.  Returns rois
    (batch_rois, 5), label (batch_rois,) (0 background, else the gt class
    + 1), bbox_target and bbox_weight (batch_rois, 4·K): the box slot of
    the roi's class among K = ``num_classes`` (background included), or
    K = 2 with ``class_agnostic`` (background and foreground, the R-FCN
    head's two-class regression).  ``box_stds`` (4 floats) divides the
    targets (the reference's normalised targets).  An image short of
    background cycles its sampled candidates, each with its own label.
    """
    B = int(batch_images)
    K = 2 if class_agnostic else int(num_classes)
    per_im = int(batch_rois) // B
    if per_im * B != int(batch_rois):
        raise ValueError("batch_rois (%d) must be divisible by batch_images (%d)"
                         % (batch_rois, batch_images))
    fg_per_im = int(round(fg_fraction * per_im))
    post = rois.shape[0] // B
    G = gt_boxes.shape[1]
    dev = rois.device

    gt_valid = gt_boxes[..., 0] >= 0                                   # (B, G)
    has_gt = (gt_valid.sum(1) > 0)[:, None]
    bcol = torch.arange(B, dtype=rois.dtype, device=dev)[:, None, None].expand(B, G, 1)
    cand = torch.cat([rois.reshape(B, post, 5),
                      torch.cat([bcol, gt_boxes[..., 1:5]], dim=2)], dim=1)
    cand_valid = torch.cat([torch.ones((B, post), dtype=torch.bool, device=dev),
                            gt_valid], dim=1)                          # (B, ncand)

    iou = _iou_plus_one(cand[..., 1:5], gt_boxes[..., 1:5])            # (B, ncand, G)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    argmax = torch.clamp(torch.argmax(iou, dim=2), 0, G - 1)
    max_iou = torch.clamp(iou.max(dim=2).values, min=0.0)

    fg = cand_valid & (max_iou >= FG_OVERLAP) & has_gt
    fg_kept, fg_order = _rank_select(fg, noise[..., 0], fg_per_im)
    n_fg = torch.clamp(fg_kept.sum(1), max=fg_per_im)                  # (B,)
    bg = cand_valid & (max_iou < FG_OVERLAP)
    bg_kept, bg_order = _rank_select(bg, noise[..., 1], per_im - n_fg)
    n_bg = torch.minimum(bg_kept.sum(1), per_im - n_fg)

    # slot i: the i-th sampled fg, then the sampled bgs cycled to capacity;
    # with no bg the sampled fgs cycle instead
    slots = torch.arange(per_im, device=dev)[None, :]
    n_fg1, n_bg1 = n_fg[:, None], n_bg[:, None]
    bg_slot = (slots - n_fg1) % torch.clamp(n_bg1, min=1)
    fg_pad_slot = slots % torch.clamp(n_fg1, min=1)
    pad_idx = torch.where(n_bg1 > 0, torch.gather(bg_order, 1, bg_slot),
                          torch.gather(fg_order, 1, fg_pad_slot))
    idx = torch.where(slots < n_fg1, fg_order[:, :per_im], pad_idx)    # (B, per_im)
    sel = torch.gather(cand, 1, idx[..., None].expand(B, per_im, 5))
    sel_gt = torch.gather(argmax, 1, idx)
    is_fg = torch.gather(fg, 1, idx)
    matched = torch.gather(gt_boxes, 1, sel_gt[..., None].expand(B, per_im, 5))
    label = torch.where(is_fg, matched[..., 0] + 1.0, 0.0)

    tgt = _bbox_transform(sel[..., 1:5], matched[..., 1:5])            # (B, per_im, 4)
    if box_stds is not None:
        tgt = tgt / _constant(tuple(box_stds), tgt.dtype, dev)
    # the box slot of the roi's class (of min(label, 1) class-agnostic); a
    # compare, not F.one_hot, whose range check synchronises the stream
    kcls = (torch.clamp(label, max=1.0) if class_agnostic else label).to(torch.int64)
    onehot = (kcls[..., None] == torch.arange(K, device=dev)).to(rois.dtype)
    w = is_fg[..., None, None] * onehot[..., None]                     # (B, per_im, K, 1)
    bbox_target = (w * tgt[..., None, :]).reshape(B * per_im, 4 * K)
    bbox_weight = w.expand(B, per_im, K, 4).reshape(B * per_im, 4 * K)
    return (sel.reshape(B * per_im, 5), label.reshape(B * per_im),
            bbox_target, bbox_weight)
