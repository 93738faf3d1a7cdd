"""Detection operators of the Deformable R-FCN path (counterpart of
``mxnet_tpu/ops/detection.py``): deformable convolution, deformable PS-ROI
pooling and MultiProposal with greedy NMS.

Layouts are the JAX package's: NCHW maps, rois ``(R, 5)`` as
``[batch_idx, x1, y1, x2, y2]``, the ``(BG, N, C)`` dconv column.  Sampling
coordinates are computed in fp32 in the JAX formulas' own order; the
irregular inner loops run as the CUDA kernels of ``kernels.py`` on the card
(their plain versions on the CPU), reached as ``kernels.<name>`` so that one
forward can be observed from outside.  The two deformable ops are
differentiable: their kernels are ``torch.autograd.Function``s whose
backward is a kernel too, and every clip on a sample coordinate keeps
``jnp.clip``'s gradient (``_clip``).  The JAX package's ``vmap`` over
images is a batch dimension here, and its ``lax.scan`` over PS-ROI bins is
one kernel launch over all bins.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels
from .nn import pair

__all__ = ["deformable_convolution", "deformable_psroi_pooling",
           "generate_base_anchors", "multi_proposal"]


def _clip(v, lo, hi):
    """``jnp.clip(v, lo, hi)`` with JAX's gradient: ``min(max(v, lo), hi)``.
    Where ``v`` ties with a bound, ``maximum`` and ``minimum`` pass half the
    gradient, as JAX's do; ``torch.clamp`` would pass all of it.  The bounds
    are made on ``v``'s device (a copy from the host would synchronise)."""
    lo = torch.full((), lo, dtype=v.dtype, device=v.device)
    hi = torch.full((), hi, dtype=v.dtype, device=v.device)
    return torch.minimum(torch.maximum(v, lo), hi)


# ---------------------------------------------------------------------------
# DeformableConvolution (reference contrib/deformable_convolution-inl.h:99)
# ---------------------------------------------------------------------------


def dconv_sample_factors(offset, hw, kernel, stride, dilate, pad):
    """The bilinear sampling factors of a deformable convolution over an
    (H, W) map: corner indices y0, y1, x0, x1 (int32), lerp factors ly, lx
    and the live mask lf (float32), each (B·DG, K²·Ho·Wo) with the rows laid
    out (tap, ho, wo).  ``offset`` is (B, 2·DG·K², Ho, Wo); the arguments
    are pairs, as :func:`deformable_convolution` resolves them."""
    H, W = hw
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    B, _, Ho, Wo = offset.shape
    K2 = kh * kw
    DG = offset.shape[1] // (2 * K2)
    N = K2 * Ho * Wo
    dev = offset.device
    f32 = torch.float32
    # base sampling positions, tap order (i·kw + j) as in deformable_im2col
    ii = torch.arange(kh, device=dev)
    jj = torch.arange(kw, device=dev)
    tap_dy = (ii[:, None] * dh).repeat(1, kw).reshape(-1)       # (K2,)
    tap_dx = (jj * dw).repeat(kh)                                # (K2,)
    grid_y = (torch.arange(Ho, device=dev) * sh - ph)[:, None]   # (Ho,1)
    grid_x = (torch.arange(Wo, device=dev) * sw - pw)[None, :]   # (1,Wo)
    base_y = (grid_y[None] + tap_dy[:, None, None]).to(f32)      # (K2,Ho,1)
    base_x = (grid_x[None] + tap_dx[:, None, None]).to(f32)      # (K2,1,Wo)

    off = offset.reshape(B, DG, K2, 2, Ho, Wo)
    sy = base_y + off[:, :, :, 0]
    sx = base_x + off[:, :, :, 1]
    live = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
    syc = _clip(sy, 0.0, H - 1.0).reshape(B * DG, N)
    sxc = _clip(sx, 0.0, W - 1.0).reshape(B * DG, N)
    y0 = torch.floor(syc).to(torch.int32)
    x0 = torch.floor(sxc).to(torch.int32)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly = syc - y0.to(f32)
    lx = sxc - x0.to(f32)
    lf = live.reshape(B * DG, N).to(f32)
    return y0, y1, x0, x1, ly, lx, lf


def deformable_convolution(data, offset, weight, bias=None, *, kernel,
                           num_filter, stride=(1, 1), dilate=(1, 1),
                           pad=(0, 0), num_deformable_group=1, no_bias=False):
    """Deformable convolution v1 (reference deformable_convolution-inl.h:99,
    im2col at offset positions deformable_im2col.h:264-316).

    Tap (i, j) at output (ho, wo) samples the input bilinearly at
    ``(ho·stride − pad + i·dilate + Δy, wo·stride − pad + j·dilate + Δx)``
    with Δ from ``offset`` (B, 2·DG·K², Ho, Wo), ``[.., 0]`` = Δy.  Samples
    off the map are 0; positions past the last row or column snap to it.
    The column is the ``dconv_col`` kernel at every size; the product with
    the weight is one batched product.
    """
    kh, kw = pair(kernel)
    sh, sw = pair(stride)
    dh, dw = pair(dilate)
    ph, pw = pair(pad)
    B, C, H, W = data.shape
    Fo = int(num_filter)
    DG = int(num_deformable_group)
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    K2 = kh * kw
    cpg = C // DG
    f32 = torch.float32
    if data.dtype != f32:
        raise ValueError("DeformableConvolution: only float32 is ported, got %s"
                         % data.dtype)
    if tuple(offset.shape) != (B, 2 * DG * K2, Ho, Wo):
        raise ValueError("DeformableConvolution: offset must be %s, got %s"
                         % ((B, 2 * DG * K2, Ho, Wo), tuple(offset.shape)))

    y0, y1, x0, x1, ly, lx, lf = dconv_sample_factors(
        offset, (H, W), (kh, kw), (sh, sw), (dh, dw), (ph, pw))
    ft = (data.reshape(B, DG, cpg, H * W).transpose(2, 3)
          .reshape(B * DG, H * W, cpg).contiguous())
    col = kernels.DConvCol.apply(y0, y1, x0, x1, ly, lx, lf, ft, (H, W), (K2, Ho, Wo))
    col = (col.reshape(B, DG, K2, Ho * Wo, cpg).permute(0, 1, 4, 2, 3)
           .reshape(B, C * K2, Ho * Wo))
    # a bmm with the weight expanded over the batch, not matmul: when the
    # weight needs a gradient, matmul folds the batch into its rows, and the
    # column's gradient then reaches DConvCol.backward only through a
    # transposing copy; the bmm's arrives as a channel-major view of it
    out = torch.bmm(weight.reshape(1, Fo, C * K2).expand(B, -1, -1), col)
    out = out.reshape(B, Fo, Ho, Wo)
    if bias is not None and not no_bias:
        out = out + bias[None, :, None, None]
    return out


# ---------------------------------------------------------------------------
# DeformablePSROIPooling (reference contrib/deformable_psroi_pooling.cc:66-170)
# ---------------------------------------------------------------------------


def deformable_psroi_pooling(data, rois, trans=None, *, spatial_scale,
                             output_dim, group_size, pooled_size, part_size=0,
                             sample_per_part=4, trans_std=0.0, no_trans=False,
                             rois_per_image=0):
    """Deformable position-sensitive ROI pooling (Deformable R-FCN).

    Reference deformable_psroi_pooling.cc:95-170: roi corners round to ints
    (half to even) and map to ``[round(x)·s − 0.5, (round(x)+1)·s − 0.5]``;
    each bin averages a ``sample_per_part``² grid of bilinear samples shifted
    by ``trans`` (scaled by ``trans_std`` and the roi size); samples outside
    ``[−0.5, size − 0.5]`` are dropped; a bin with no live sample is 0.

    The bilinear footprint is separable, so every bin's accumulation matrix
    is ``A = Σ_s yv[s] ⊗ xv[s]``: one ``psroi_abuild`` launch builds it for
    all K·PH·PW bins at once, then one batched product with the bins' planes.

    ``rois_per_image``: the caller's promise that rois are batch-major
    grouped (roi r belongs to image r // rois_per_image, the MultiProposal
    layout).  That path ignores the batch_idx column, as the JAX package's
    does, and keeps the product block-diagonal over images; a value that does
    not divide R takes the general path.
    """
    PH = PW = int(pooled_size)
    group = int(group_size)
    part = int(part_size) if part_size else PH
    spp = int(sample_per_part)
    OD = int(output_dim)
    B, C, H, W = data.shape
    dev = data.device
    f32 = torch.float32
    if data.dtype != f32:
        raise ValueError("DeformablePSROIPooling: only float32 is ported, got %s"
                         % data.dtype)

    batch_idx = rois[:, 0].to(torch.int64)
    rois = rois.to(f32)
    xs = torch.round(rois[:, 1]) * spatial_scale - 0.5
    ys = torch.round(rois[:, 2]) * spatial_scale - 0.5
    xe = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    ye = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(xe - xs, min=0.1)
    roi_h = torch.clamp(ye - ys, min=0.1)
    bs_h = roi_h / PH
    bs_w = roi_w / PW
    sub_h = bs_h / spp
    sub_w = bs_w / spp

    K = 1 if no_trans or trans is None else trans.shape[1] // 2
    cpc = OD // K
    R = rois.shape[0]
    g2 = group * group
    if C != OD * g2:
        raise ValueError(
            "DeformablePSROIPooling: data has %d channels, needs output_dim"
            "*group_size^2 = %d*%d = %d" % (C, OD, g2, OD * g2))

    # channel index = c·g² + gh(ph)·g + gw(pw), c = k·cpc + within-class
    datag = data.reshape(B, K, cpc, g2, H, W).permute(0, 1, 3, 4, 5, 2)
    # index tables built on the device: a copy from host memory would
    # synchronise the stream
    ph_n = torch.arange(PH, device=dev)
    pw_n = torch.arange(PW, device=dev)
    ghs = torch.clamp((ph_n * group) // PH, 0, group - 1)
    gws = torch.clamp((pw_n * group) // PW, 0, group - 1)
    part_h = (ph_n * part) // PH
    part_w = (pw_n * part) // PW

    su = torch.arange(spp, dtype=f32, device=dev)
    r1 = (slice(None), None, None, None)  # (R,) -> (R,1,1,1)
    if no_trans or trans is None:
        tx = torch.zeros((R, K, PH, PW), dtype=f32, device=dev)
        ty = torch.zeros((R, K, PH, PW), dtype=f32, device=dev)
    else:
        t = trans.to(f32).reshape(R, K, 2, part, part)
        tx = t[:, :, 0][:, :, part_h][:, :, :, part_w] * trans_std
        ty = t[:, :, 1][:, :, part_h][:, :, :, part_w] * trans_std
    wst = pw_n.to(f32)[None, None, None, :] * bs_w[r1] + xs[r1] + tx * roi_w[r1]
    hst = ph_n.to(f32)[None, None, :, None] * bs_h[r1] + ys[r1] + ty * roi_h[r1]
    # sample grid (R, K, PH, PW, spp, spp)
    sy = hst[..., None, None] + su[:, None] * sub_h[:, None, None, None, None, None]
    sx = wst[..., None, None] + su[None, :] * sub_w[:, None, None, None, None, None]
    sy, sx = torch.broadcast_tensors(sy, sx)
    # inclusive boundary: a sample at exactly −0.5 or size − 0.5 survives
    live = (sx >= -0.5) & (sx <= W - 0.5) & (sy >= -0.5) & (sy <= H - 0.5)
    syc = _clip(sy, 0.0, H - 1.0)
    sxc = _clip(sx, 0.0, W - 1.0)
    y0 = torch.floor(syc).to(torch.int64)
    x0 = torch.floor(sxc).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly = syc - y0.to(f32)
    lx = sxc - x0.to(f32)
    lf = live.to(f32)
    cnt = lf.sum(dim=(4, 5))[..., None]  # (R, K, PH, PW, 1)

    spp2 = spp * spp
    Rb = int(rois_per_image)
    grouped = Rb > 0 and R == B * Rb
    hw = H * W
    NB = K * PH * PW
    if grouped:
        def to_bins(a):  # (R=B·Rb, K, PH, PW, spp, spp) -> (NB·B·Rb, spp2)
            return (a.reshape(B, Rb, K, PH, PW, spp2).permute(2, 3, 4, 0, 1, 5)
                    .reshape(NB * B * Rb, spp2))
        yoff = 0
        rows = H
    else:
        def to_bins(a):  # -> (NB·R, spp2)
            return (a.reshape(R, K, PH, PW, spp2).permute(1, 2, 3, 0, 4)
                    .reshape(NB * R, spp2))
        # the image rides in the row index: flat b·hw + y·W + x
        yoff = batch_idx[:, None, None, None, None, None] * H
        rows = B * H
    iota_y = torch.arange(rows, device=dev)
    iota_x = torch.arange(W, device=dev)
    lyb, lxb, lfb = to_bins(ly), to_bins(lx), to_bins(lf)
    yv = ((1.0 - lyb)[..., None] * (to_bins(y0 + yoff)[..., None] == iota_y)
          + lyb[..., None] * (to_bins(y1 + yoff)[..., None] == iota_y))
    xv = lfb[..., None] * ((1.0 - lxb)[..., None] * (to_bins(x0)[..., None] == iota_x)
                           + lxb[..., None] * (to_bins(x1)[..., None] == iota_x))
    a = kernels.PSROIABuild.apply(yv.contiguous(), xv.contiguous())  # (NB·R, rows, W)

    # per-bin planes of the position-sensitive map: (NB, B, hw, cpc)
    kb = torch.arange(K, device=dev).repeat_interleave(PH * PW)
    gb = (ghs[:, None] * group + gws[None, :]).reshape(-1).repeat(K)
    planes = datag.permute(1, 2, 0, 3, 4, 5).reshape(K, g2, B, hw, cpc)[kb, gb]
    if grouped:
        s = torch.bmm(a.reshape(NB * B, Rb, hw), planes.reshape(NB * B, hw, cpc))
        s = (s.reshape(K, PH, PW, B, Rb, cpc).permute(3, 4, 0, 1, 2, 5)
             .reshape(R, K, PH, PW, cpc))
    else:
        s = torch.bmm(a.reshape(NB, R, B * hw), planes.reshape(NB, B * hw, cpc))
        s = s.reshape(K, PH, PW, R, cpc).permute(3, 0, 1, 2, 4)
    out = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0)
    # (R, K, PH, PW, cpc) -> (R, K·cpc = OD, PH, PW)
    return out.permute(0, 1, 4, 2, 3).reshape(R, OD, PH, PW)


# ---------------------------------------------------------------------------
# MultiProposal (reference contrib/multi_proposal.cc)
# ---------------------------------------------------------------------------


def generate_base_anchors(stride, scales, ratios):
    """Classic RPN anchor enumeration (multi_proposal-inl.h:186-226): for each
    ratio then scale, snap w/h by the floor(. + 0.5) rule around the stride
    box's center.  A copy of ``mxnet_tpu/ops/detection.py
    _generate_base_anchors``; (A, 4) float32."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w = base[2] - base[0] + 1.0
    h = base[3] - base[1] + 1.0
    x_ctr = base[0] + 0.5 * (w - 1.0)
    y_ctr = base[1] + 0.5 * (h - 1.0)
    size = w * h
    out = []
    for r in ratios:
        size_ratio = np.floor(size / r)
        new_w = np.floor(np.sqrt(size_ratio) + 0.5)
        new_h = np.floor(new_w * r + 0.5)
        for s in scales:
            ws, hs = new_w * s, new_h * s
            out.append([x_ctr - 0.5 * (ws - 1.0), y_ctr - 0.5 * (hs - 1.0),
                        x_ctr + 0.5 * (ws - 1.0), y_ctr + 0.5 * (hs - 1.0)])
    return np.array(out, np.float32)


@functools.lru_cache(maxsize=16)
def _anchors(stride, scales, ratios, device):
    """Base anchors on ``device``, copied once per configuration: a copy from
    host memory synchronises the stream.  Callers only read the tensor."""
    return torch.as_tensor(generate_base_anchors(stride, scales, ratios),
                           device=device)


def _proposals(scores_fg, deltas, im_info, anchors, stride, pre_nms, post_nms,
               thresh, min_size):
    """Batched RPN proposal pipeline (``_proposal_one_image`` with the image
    as a batch dimension).  -> rois (B, post, 4)."""
    B, A, Hf, Wf = scores_fg.shape
    dev = scores_fg.device
    f32 = torch.float32
    # anchor grid in reference enumeration order: index = h·(W·A) + w·A + a
    shift_x = torch.arange(Wf, dtype=f32, device=dev) * stride
    shift_y = torch.arange(Hf, dtype=f32, device=dev) * stride
    boxes = torch.stack([
        (shift_x[None, :, None] + anchors[None, None, :, 0]).expand(Hf, Wf, A),
        (shift_y[:, None, None] + anchors[None, None, :, 1]).expand(Hf, Wf, A),
        (shift_x[None, :, None] + anchors[None, None, :, 2]).expand(Hf, Wf, A),
        (shift_y[:, None, None] + anchors[None, None, :, 3]).expand(Hf, Wf, A),
    ], dim=-1)  # (Hf, Wf, A, 4)

    # deltas (B, 4A, Hf, Wf) laid out a·4 + c -> (B, Hf, Wf, A, 4)
    d = deltas.reshape(B, A, 4, Hf, Wf).permute(0, 3, 4, 1, 2)
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * (widths - 1.0)
    ctr_y = boxes[..., 1] + 0.5 * (heights - 1.0)
    pred_ctr_x = d[..., 0] * widths + ctr_x
    pred_ctr_y = d[..., 1] * heights + ctr_y
    pred_w = torch.exp(d[..., 2]) * widths
    pred_h = torch.exp(d[..., 3]) * heights
    b5 = (slice(None), None, None, None)  # (B,) -> (B,1,1,1)
    im_h, im_w, im_scale = im_info[:, 0], im_info[:, 1], im_info[:, 2]
    zero = torch.zeros((), dtype=f32, device=dev)

    def clip(v, hi):  # jnp.clip(v, 0, hi) = min(max(v, 0), hi)
        return torch.minimum(torch.maximum(v, zero), hi[b5])

    x1 = clip(pred_ctr_x - 0.5 * (pred_w - 1.0), im_w - 1.0)
    y1 = clip(pred_ctr_y - 0.5 * (pred_h - 1.0), im_h - 1.0)
    x2 = clip(pred_ctr_x + 0.5 * (pred_w - 1.0), im_w - 1.0)
    y2 = clip(pred_ctr_y + 0.5 * (pred_h - 1.0), im_h - 1.0)

    score = scores_fg.permute(0, 2, 3, 1)  # (B, Hf, Wf, A)
    # padded rows/cols beyond the real (unpadded) feature extent score -1
    real_h = torch.ceil(im_h / stride).to(torch.int64)
    real_w = torch.ceil(im_w / stride).to(torch.int64)
    pad_mask = ((torch.arange(Hf, device=dev)[None, :, None, None] >= real_h[b5])
                | (torch.arange(Wf, device=dev)[None, None, :, None] >= real_w[b5]))
    score = torch.where(pad_mask, -1.0, score)

    # FilterBox: expand and kill tiny boxes (multi_proposal.cc:147-161)
    ms = (min_size * im_scale)[b5]
    iw = x2 - x1 + 1.0
    ih = y2 - y1 + 1.0
    tiny = (iw < ms) | (ih < ms)
    half = ms / 2.0
    x1 = torch.where(tiny, x1 - half, x1)
    y1 = torch.where(tiny, y1 - half, y1)
    x2 = torch.where(tiny, x2 + half, x2)
    y2 = torch.where(tiny, y2 + half, y2)
    score = torch.where(tiny, -1.0, score)

    props = torch.stack([x1, y1, x2, y2, score], dim=-1).reshape(B, -1, 5)
    N = props.shape[1]
    K1 = min(pre_nms, N) if pre_nms > 0 else N
    # stable: padded and tiny boxes tie at -1 and keep index order
    order = torch.argsort(-props[..., 4], dim=1, stable=True)[:, :K1]
    ordered = torch.gather(props, 1, order[..., None].expand(B, K1, 5))

    valid = torch.ones((B, K1), dtype=torch.bool, device=dev)
    alive = kernels.nms_alive(ordered[..., :4].contiguous(), valid,
                              thresh=thresh, plus_one=1.0)
    # survivors in score order, then the first post_nms of them
    keep = torch.argsort((~alive).to(torch.uint8), dim=1, stable=True)[:, :post_nms]
    out_size = torch.clamp(alive.sum(1).clamp(max=post_nms), min=1)  # (B,)
    slots = torch.arange(post_nms, device=dev)[None, :]
    # fewer survivors than post_nms: pad by cycling the kept boxes
    pick = torch.where(slots < out_size[:, None], slots, slots % out_size[:, None])
    idx = torch.gather(keep, 1, pick)
    return torch.gather(ordered[..., :4], 1, idx[..., None].expand(B, post_nms, 4))


@torch.no_grad()
def multi_proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                   feature_stride=16):
    """Batched RPN proposal generation (reference multi_proposal.cc:290-460):
    decode anchor deltas, clip, kill sub-min-size boxes, sort, greedy NMS
    (one ``nms_alive`` launch over the whole batch), emit exactly
    ``rpn_post_nms_top_n`` rois per image, padded by cycling the kept boxes.
    The rois carry no gradient (the JAX model's ``BlockGrad``), so the op
    runs under ``torch.no_grad()``.

    cls_prob (B, 2A, Hf, Wf), bbox_pred (B, 4A, Hf, Wf), im_info (B, 3)
    [height, width, scale].  Returns (B·post, 5) rois
    ``[batch_idx, x1, y1, x2, y2]``.  Box and score math runs in fp32.
    """
    f32 = torch.float32
    cls_prob = cls_prob.to(f32)
    bbox_pred = bbox_pred.to(f32)
    im_info = im_info.to(f32)
    dev = cls_prob.device
    anchors = _anchors(float(feature_stride), tuple(scales), tuple(ratios), dev)
    B = cls_prob.shape[0]
    A = anchors.shape[0]
    post = int(rpn_post_nms_top_n)
    rois = _proposals(
        cls_prob[:, A:], bbox_pred, im_info, anchors, float(feature_stride),
        int(rpn_pre_nms_top_n), post, float(threshold), float(rpn_min_size))
    batch_col = torch.arange(B, dtype=f32, device=dev).repeat_interleave(post)
    return torch.cat([batch_col[:, None], rois.reshape(B * post, 4)], dim=1)
