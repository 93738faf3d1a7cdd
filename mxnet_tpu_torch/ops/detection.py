"""Detection operators of the Deformable R-FCN, Faster R-CNN and SSD paths
(counterpart of ``mxnet_tpu/ops/detection.py``): deformable convolution,
deformable PS-ROI pooling, ROI pooling, MultiProposal and Proposal with
greedy NMS, the SSD MultiBox trio (prior, target, detection), and the
generic box ops (``box_iou``, ``box_nms``, ``bipartite_matching``).

Layouts are the JAX package's: NCHW maps, rois ``(R, 5)`` as
``[batch_idx, x1, y1, x2, y2]``, the ``(BG, N, C)`` dconv column.  The maps
may be float32 or bfloat16, and each op follows its JAX op's dtype rules.
Sampling coordinates are computed in fp32 in the JAX formulas' own order (a
bf16 deformable offset first forms its sample positions in bf16, as JAX
promotes them); the irregular inner loops run as the CUDA kernels of
``kernels.py`` on the card (their plain versions on the CPU), reached as
``kernels.<name>`` so that one forward can be observed from outside.  The two deformable ops are
differentiable: their kernels are ``torch.autograd.Function``s whose
backward is a kernel too, and every clip on a sample coordinate keeps
``jnp.clip``'s gradient (``_clip``).  The JAX package's ``vmap`` over
images is a batch dimension here, and its ``lax.scan`` over PS-ROI bins is
one kernel launch over all bins.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import kernels
from .nn import pair
from .registry import register

__all__ = ["bipartite_matching", "box_iou", "box_nms", "deformable_convolution",
           "deformable_psroi_pooling", "generate_base_anchors", "multi_proposal",
           "multibox_detection", "multibox_prior", "multibox_target", "proposal",
           "roi_pooling"]


def _float_dtype(op, t):
    """Raise unless ``t`` is float32 or bfloat16, the dtypes the deformable
    ops are ported for."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("%s: float32 and bfloat16 are ported (ROADMAP.md "
                         "A4.3), got %s" % (op, t.dtype))


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
    are pairs, as :func:`deformable_convolution` resolves them.

    As in the JAX op, the integer base position is added to the offset in
    the offset's dtype: a bf16 offset gives bf16 sample positions, which the
    live test sees; only the clip and what follows are fp32."""
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
    base_y = (grid_y[None] + tap_dy[:, None, None]).to(offset.dtype)  # (K2,Ho,1)
    base_x = (grid_x[None] + tap_dx[:, None, None]).to(offset.dtype)  # (K2,1,Wo)

    off = offset.reshape(B, DG, K2, 2, Ho, Wo)
    sy = base_y + off[:, :, :, 0]
    sx = base_x + off[:, :, :, 1]
    live = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
    syc = _clip(sy.to(f32), 0.0, H - 1.0).reshape(B * DG, N)
    sxc = _clip(sx.to(f32), 0.0, W - 1.0).reshape(B * DG, N)
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
    the weight is one batched product.  float32 or bfloat16: the column and
    the output come in ``data``'s dtype (the bf16 column as the TPU
    kernel's bf16 instance computes it), and a bf16 weight product is a
    bf16 ``torch.bmm``.
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
    _float_dtype("DeformableConvolution", data)
    if tuple(offset.shape) != (B, 2 * DG * K2, Ho, Wo):
        raise ValueError("DeformableConvolution: offset must be %s, got %s"
                         % ((B, 2 * DG * K2, Ho, Wo), tuple(offset.shape)))

    y0, y1, x0, x1, ly, lx, lf = dconv_sample_factors(
        offset, (H, W), (kh, kw), (sh, sw), (dh, dw), (ph, pw))
    ft = (data.reshape(B, DG, cpg, H * W).transpose(2, 3)
          .reshape(B * DG, H * W, cpg).contiguous())
    col = kernels.DConvCol.apply(y0, y1, x0, x1, ly, lx, lf, ft, (H, W), (K2, Ho, Wo))
    # views, no copy: the column comes stored channel-major, (BG, cpg, N)
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

    float32 or bfloat16, as the JAX op: the coordinate math is fp32, but a
    bf16 ``trans`` is scaled by ``trans_std`` in bf16 before it meets the
    fp32 roi size; A is stored in the map's dtype (``psroi_abuild``), its
    product with the planes is one product in that dtype, and the pooled
    sums are divided in fp32 and cast back to it.
    """
    PH = PW = int(pooled_size)
    group = int(group_size)
    part = int(part_size) if part_size else PH
    spp = int(sample_per_part)
    OD = int(output_dim)
    B, C, H, W = data.shape
    dev = data.device
    f32 = torch.float32
    _float_dtype("DeformablePSROIPooling", data)

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
        # t·trans_std in trans's dtype (a Python float is weakly typed in
        # JAX: a bf16 trans is scaled in bf16), then fp32 against the roi
        t = trans.reshape(R, K, 2, part, part)
        std = torch.full((), trans_std, dtype=t.dtype, device=dev)
        tx = (t[:, :, 0][:, :, part_h][:, :, :, part_w] * std).to(f32)
        ty = (t[:, :, 1][:, :, part_h][:, :, :, part_w] * std).to(f32)
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
    a = kernels.PSROIABuild.apply(yv.contiguous(), xv.contiguous(),
                                  data.dtype)  # (NB·R, rows, W)

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
    out = torch.where(cnt > 0, s.to(f32) / torch.clamp(cnt, min=1.0), 0.0)
    # (R, K, PH, PW, cpc) -> (R, K·cpc = OD, PH, PW), in the data dtype
    return out.permute(0, 1, 4, 2, 3).reshape(R, OD, PH, PW).to(data.dtype)


# ---------------------------------------------------------------------------
# ROIPooling (reference src/operator/roi_pooling.cc)
# ---------------------------------------------------------------------------

def _roi_bins(rois, spatial_scale, PH, PW, H, W):
    """Bin bounds of ``rois`` (R, 5), in fp32 whatever the data dtype, as
    the JAX op computes them under ``jax.jit``: corners ``round(coord ·
    scale)`` (half to even), bin size ``bs = extent · fp32(1/n)``, bins
    ``[floor(p·bs), ceil((p+1)·bs))`` from the corner, clipped to the map.
    The op writes ``extent / n``; XLA's simplifier turns a division by a
    constant into a product by its reciprocal, so the jitted JAX op (its
    train step and its serving forward) bins so, on the CPU as on the TPU,
    while the op run eagerly divides: the two differ at a bin end where
    ``(p+1)·bs`` is within an ulp of an integer (3/7·7 vs 3·fp32(1/7)·7).
    -> (hstart, hend) (R, PH) and (wstart, wend) (R, PW), int64."""
    f32 = torch.float32
    rois = rois.to(f32)
    xs, ys, xe, ye = (torch.round(rois[:, i] * spatial_scale).to(torch.int64)
                      for i in (1, 2, 3, 4))
    one = torch.ones((), dtype=torch.int64, device=rois.device)

    def bounds(lo, hi, n, size):
        extent = torch.maximum(hi - lo + 1, one).to(f32)
        bs = extent * float(np.float32(1) / np.float32(n))  # an fp32 value, exact
        p = torch.arange(n, dtype=f32, device=rois.device)[None, :]
        start = torch.floor(p * bs[:, None]).to(torch.int64) + lo[:, None]
        end = torch.ceil((p + 1) * bs[:, None]).to(torch.int64) + lo[:, None]
        return torch.clamp(start, 0, size), torch.clamp(end, 0, size)

    return bounds(ys, ye, PH, H) + bounds(xs, xe, PW, W)


def _row_windows(data):
    """The max of every window of rows of ``data`` (B, C, H, W): -> (B,
    H(H+1)/2, C, W), window (a, l) (rows a .. a+l-1) at ``_window(a, l,
    H)``, built by extending each window by one row."""
    B, C, H, W = data.shape
    rows = data.transpose(1, 2)  # (B, H, C, W), a view
    out = torch.empty((B, H * (H + 1) // 2, C, W), dtype=data.dtype, device=data.device)
    out[:, :H] = rows
    prev, off = 0, H
    for l in range(2, H + 1):
        n = H - l + 1
        torch.maximum(out[:, prev:prev + n], rows[:, l - 1:], out=out[:, off:off + n])
        prev, off = off, off + n
    return out


def _window(a, l, H):
    """Index of the row window (a, l) in ``_row_windows``' table."""
    return (l - 1) * (2 * H + 2 - l) // 2 + a


def _column_max(t, ws, we):
    """max of ``t`` (R, PH, C, W) over the columns [ws, we) (R, PW) of each
    bin -> (R, PH, C, PW), −inf for an empty bin: the max of two windows of
    the largest power-of-two width 2^j ≤ we − ws, the window maxima built
    level by level (a sparse table)."""
    R, PH, C, W = t.shape
    n = we - ws
    o = torch.full((R, PH, C, ws.shape[1]), float("-inf"), dtype=t.dtype, device=t.device)
    level, j = t, 0
    while (1 << j) <= W:
        span = 1 << j
        if j:
            level = torch.maximum(level[..., :-(span // 2)], level[..., span // 2:])
        top = level.shape[-1] - 1
        at = (n >= span) & (n < 2 * span)                              # (R, PW)
        a = torch.clamp(ws, 0, top)[:, None, None].expand(R, PH, C, -1)
        b = torch.clamp(we - span, 0, top)[:, None, None].expand(R, PH, C, -1)
        both = torch.maximum(torch.gather(level, 3, a), torch.gather(level, 3, b))
        o = torch.where(at[:, None, None], both, o)
        j += 1
    return o


class _ROIMax(torch.autograd.Function):
    """The JAX op's separable masked max, rows first, then columns, with
    ``jnp.max``'s gradient: at each of the two stages a bin's gradient
    splits equally among its tied maxima.

    data (B, C, H, W); img (R,) each roi's image; hs, he (R, PH) and ws,
    we (R, PW) its bins' row and column bounds.  -> (R, PH, C, PW); an
    empty bin's value is arbitrary (the caller zeroes it, and so its
    gradient).

    Forward: a bin's row max is a lookup in the table of every row
    window's max (``_row_windows``, H(H+1)/2 windows of (C, W) an image),
    its column max a sparse-table lookup (``_column_max``).  Backward, per
    stage: the column stage for each column bin; the row stage window by
    window, independent of the roi count: the gradients of the bins that
    share a row window are summed onto it, divided by the window's count
    of tied maxima (a count table built beside the max table), and handed
    to every row of the window that equals its max (``F.fold`` sums the
    windows of one length onto the rows).  Shares sum in fp32 and round
    once to the data's dtype."""

    @staticmethod
    def forward(ctx, data, img, hs, he, ws, we):
        B, C, H, W = data.shape
        R, PH = hs.shape
        valid = he > hs
        # an empty row bin reads any window: its output is zeroed
        win = _window(torch.where(valid, hs, 0), torch.where(valid, he - hs, 1), H)
        flat = (img[:, None] * (H * (H + 1) // 2) + win).reshape(-1)
        table = _row_windows(data)
        t = table.reshape(-1, C, W).index_select(0, flat).reshape(R, PH, C, W)
        o = _column_max(t, ws, we)
        ctx.save_for_backward(data, table, flat, ws, we, t, o)
        return o

    @staticmethod
    def backward(ctx, g):
        data, table, flat, ws, we, t, o = ctx.saved_tensors
        B, C, H, W = data.shape
        R, PH = t.shape[:2]
        f32 = torch.float32
        cols = torch.arange(W, device=data.device)
        mw = (cols >= ws[..., None]) & (cols < we[..., None])          # (R, PW, W)
        g_t = torch.zeros((R, PH, C, W), dtype=f32, device=data.device)
        for pw in range(o.shape[-1]):
            eq = (t == o[..., pw, None]) & mw[:, None, None, pw]
            cnt = eq.sum(dim=-1, keepdim=True).clamp_(min=1)
            g_t += torch.where(eq, g[..., pw, None] / cnt, 0)
        # the column stage's gradient in the data's dtype, as the JAX op's
        g_t = g_t.to(data.dtype).to(f32)
        # per row window: the sum of its bins' gradients
        per_window = torch.zeros((B * H * (H + 1) // 2, C, W), dtype=f32, device=data.device)
        per_window.index_add_(0, flat, g_t.reshape(R * PH, C, W))
        per_window = per_window.reshape(B, -1, C, W)
        rows = data.transpose(1, 2)                                    # (B, H, C, W)
        grad = torch.zeros((B, C * W, H, 1), dtype=f32, device=data.device)
        # int32: a uint8 count wraps at 256 tied rows
        cnt = torch.ones((B, H, C, W), dtype=torch.int32, device=data.device)
        prev = None
        for l in range(1, H + 1):
            n, off = H - l + 1, _window(0, l, H)
            top = table[:, off:off + n]                                # (B, n, C, W)
            if prev is not None:  # the window one row longer: its ties
                cnt = cnt[:, :n] * (prev[:, :n] == top) + (rows[:, l - 1:] == top)
            share = per_window[:, off:off + n] / cnt
            hit = rows.unfold(1, l, 1) == top[..., None]               # (B, n, C, W, l)
            tie = torch.where(hit, share[..., None], 0.0)
            grad += torch.nn.functional.fold(
                tie.permute(0, 2, 3, 4, 1).reshape(B, C * W * l, n),
                output_size=(H, 1), kernel_size=(l, 1))
            prev = top
        grad = grad.reshape(B, C, W, H).transpose(2, 3)
        return grad.to(data.dtype), None, None, None, None, None


def roi_pooling(data, rois, *, pooled_size, spatial_scale, rois_per_image=0):
    """Max pooling over roi bins (``mxnet_tpu/ops/detection.py roi_pooling``;
    reference roi_pooling.cc:62).  data (B, C, H, W) float32 or bfloat16;
    rois (R, 5) ``[batch_idx, x1, y1, x2, y2]`` in image coordinates.
    Returns (R, C, PH, PW) in the data's dtype; an empty bin gives 0 and
    passes no gradient.  Bin bounds as in ``_roi_bins`` (the jitted JAX
    op's); within a bin the max runs over rows, then over columns, and a
    gradient splits equally among tied maxima at each of the two stages
    (``jnp.max``'s rule; ``_ROIMax``).

    ``rois_per_image`` > 0 with R = B · rois_per_image is the caller's
    promise that the rois are batch-major grouped (roi r on image
    r // rois_per_image, the MultiProposal and proposal_target layout): the
    batch_idx column is then not read (checking it on the card would
    synchronise the host).  Otherwise each roi's image is its batch_idx.

    The JAX op's masked rows stage is (rois, PH, C, H, W), 10.5 GB for 300
    rois on a (1, 512, 38, 64) map; here each bin's rows are looked up in a
    table of row windows (97 MB an image at that size), and the backward
    works window by window (``_ROIMax``): no intermediate grows with the
    roi count beyond (rois, PH, C, W).
    """
    PH, PW = pair(pooled_size)
    B, C, H, W = data.shape
    R = rois.shape[0]
    _float_dtype("roi_pooling", data)
    hs, he, ws, we = _roi_bins(rois, spatial_scale, PH, PW, H, W)
    Rb = int(rois_per_image)
    if Rb > 0 and R == B * Rb:
        img = torch.arange(B, device=data.device).repeat_interleave(Rb)
    else:
        img = rois[:, 0].to(torch.int64)
    out = _ROIMax.apply(data, img, hs, he, ws, we).permute(0, 2, 1, 3)
    empty = (he <= hs)[:, None, :, None] | (we <= ws)[:, None, None, :]
    return torch.where(empty, torch.zeros((), dtype=data.dtype, device=data.device), out)


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
    as a batch dimension).  -> rois (B, post, 4) and their scores (B,
    post)."""
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
    picked = torch.gather(ordered, 1, idx[..., None].expand(B, post_nms, 5))
    return picked[..., :4], picked[..., 4]


@register("_contrib_MultiProposal", alias=["MultiProposal"])
@torch.no_grad()
def multi_proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                   feature_stride=16, output_score=False, iou_loss=False):
    """Batched RPN proposal generation (reference multi_proposal.cc:290-460):
    decode anchor deltas, clip, kill sub-min-size boxes, sort, greedy NMS
    (one ``nms_alive`` launch over the whole batch), emit exactly
    ``rpn_post_nms_top_n`` rois per image, padded by cycling the kept boxes.
    The rois carry no gradient (the JAX model's ``BlockGrad``), so the op
    runs under ``torch.no_grad()``.

    cls_prob (B, 2A, Hf, Wf), bbox_pred (B, 4A, Hf, Wf), im_info (B, 3)
    [height, width, scale].  Returns (B·post, 5) rois
    ``[batch_idx, x1, y1, x2, y2]`` and, with ``output_score``, their
    (B·post, 1) scores.  Box and score math runs in fp32.  ``iou_loss``
    raises, as in the JAX op.
    """
    if iou_loss:
        raise NotImplementedError("MultiProposal: iou_loss=True is not supported, "
                                  "as in the JAX package")
    f32 = torch.float32
    cls_prob = cls_prob.to(f32)
    bbox_pred = bbox_pred.to(f32)
    im_info = im_info.to(f32)
    dev = cls_prob.device
    anchors = _anchors(float(feature_stride), tuple(scales), tuple(ratios), dev)
    B = cls_prob.shape[0]
    A = anchors.shape[0]
    post = int(rpn_post_nms_top_n)
    rois, scores = _proposals(
        cls_prob[:, A:], bbox_pred, im_info, anchors, float(feature_stride),
        int(rpn_pre_nms_top_n), post, float(threshold), float(rpn_min_size))
    batch_col = torch.arange(B, dtype=f32, device=dev).repeat_interleave(post)
    out = torch.cat([batch_col[:, None], rois.reshape(B * post, 4)], dim=1)
    if output_score:
        return out, scores.reshape(B * post, 1)
    return out


# Proposal (reference contrib/proposal.cc) is MultiProposal with the same
# arguments and numerics, as the JAX op is
proposal = register("_contrib_Proposal", alias=["Proposal"])(multi_proposal)


# ---------------------------------------------------------------------------
# MultiBox trio (SSD; reference contrib/multibox_{prior,target,detection}.cc)
# ---------------------------------------------------------------------------


def _floats(v):
    return tuple(float(x) for x in (v if isinstance(v, (tuple, list)) else (v,)))


def _times_inverse(x, c):
    """``x / c`` for a Python constant ``c`` as the jitted JAX ops compute it:
    XLA's simplifier turns a division by a constant into a product by
    fp32(1 / fp32(c)), which differs from the division in the last bit of
    about one value in seven (see ``_roi_bins``)."""
    return x * float(np.float32(1) / np.float32(c))


@register("_contrib_MultiBoxPrior", alias=["MultiBoxPrior"])
def multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors (reference multibox_prior.cc:30-70) over ``data``'s (H, W)
    grid, of which only the shape is read: per cell, ``sizes`` boxes at
    ratio 1 (width corrected by H/W), then ``ratios[1:]`` at ``sizes[0]``;
    corner format, normalized coordinates, clipped to [0, 1] with ``clip``.
    -> (1, H·W·A, 4) float32 on ``data``'s device.

    As in the JAX op, the half-extents are computed in float64 on the host
    and rounded to fp32 once; the centres are ``(i + offset) · step`` in
    fp32: the anchors equal the JAX op's bit for bit."""
    H, W = data.shape[2], data.shape[3]
    if H <= 0 or W <= 0:
        raise ValueError("MultiBoxPrior: feature map is %dx%d — input too small "
                         "for this many downsampling stages" % (H, W))
    sizes, ratios = _floats(sizes), _floats(ratios)
    step_y = 1.0 / H if steps[0] <= 0 else float(steps[0])
    step_x = 1.0 / W if steps[1] <= 0 else float(steps[1])
    off_y, off_x = float(offsets[0]), float(offsets[1])
    # per-cell half-extents [w, h]: sizes at ratio 1, then sizes[0] at ratios[1:]
    hw = [(s * H / W / 2.0, s / 2.0) for s in sizes]
    hw += [(sizes[0] * H / W * np.sqrt(r) / 2.0, sizes[0] / np.sqrt(r) / 2.0)
           for r in ratios[1:]]
    dev = data.device
    f32 = torch.float32
    half = torch.as_tensor(np.array(hw, np.float32), device=dev)  # (A, 2)
    A = half.shape[0]
    cy = ((torch.arange(H, dtype=f32, device=dev) + off_y) * step_y)[:, None, None]
    cx = ((torch.arange(W, dtype=f32, device=dev) + off_x) * step_x)[None, :, None]
    out = torch.stack([(cx - half[:, 0]).expand(H, W, A), (cy - half[:, 1]).expand(H, W, A),
                       (cx + half[:, 0]).expand(H, W, A), (cy + half[:, 1]).expand(H, W, A)],
                      dim=-1).reshape(1, -1, 4)
    return torch.clamp(out, 0.0, 1.0) if clip else out


def _box_iou_corner(a, b):
    """IoU of corner boxes (..., N, 4) × (..., M, 4) -> (..., N, M), no +1
    (multibox_target-inl.h:158; ``mxnet_tpu/ops/detection.py
    _box_iou_corner``, in its operation order).  An inverted box's area is
    negative, as there; a union <= 0 gives 0."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union <= 0, 0.0, inter / torch.clamp(union, min=1e-12))


def _batch_set(t, idx, value):
    """``t[b, idx[b]] = value[b]`` for every row b of the (B, N) tensor ``t``,
    on the device (no host synchronisation)."""
    t.scatter_(1, idx[:, None], value[:, None].to(t.dtype))


def _batch_get(t, idx):
    """``t[b, idx[b]]`` for every row b of the (B, N) tensor ``t``."""
    return torch.gather(t, 1, idx[:, None])[:, 0]


@register("_contrib_MultiBoxTarget", alias=["MultiBoxTarget"])
@torch.no_grad()
def multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (reference multibox_target.cc:72-270;
    ``mxnet_tpu/ops/detection.py multibox_target``), the image a batch
    dimension.

    anchor (1, A, 4) corner boxes; label (B, L, 5) ``[cls, x1, y1, x2,
    y2]``, the valid labels a prefix (the first row whose class is -1 ends
    it); cls_pred (B, C, A) class scores.  Stage 1 takes the globally best
    (anchor, label) pair, ``min(A, L)`` rounds (the first maximum of the
    flattened (A, L) matrix, as ``jnp.argmax``); stage 2 matches the other
    anchors above ``overlap_threshold``; stage 3 mines the
    ``int(positives · negative_mining_ratio)`` hardest negatives (lowest
    background probability, a stable sort) among anchors below
    ``negative_mining_thresh``, or takes every other anchor as negative
    when the ratio is not positive.  -> (loc_target (B, A·4), loc_mask
    (B, A·4), cls_target (B, A)); class 0 is background and
    ``ignore_label`` marks the anchors that count for nothing.  An image
    without a valid label gets neither positives nor negatives.  No
    gradient: the op runs under ``torch.no_grad()``.  The encoded targets
    divide by ``variances`` as the jitted JAX op does (``_times_inverse``).
    """
    A = anchor.shape[-2]
    anchors = anchor.reshape(A, 4)
    B, L, LW = label.shape
    dev = anchors.device
    f32 = anchors.dtype
    vx, vy, vw, vh = _floats(variances)
    gt_valid = torch.cumprod((label[..., 0] != -1.0).to(torch.int32), dim=1) == 1  # (B, L)
    num_valid = gt_valid.sum(1)
    has_gt = (num_valid > 0)[:, None]
    ious = _box_iou_corner(anchors, label[..., 1:5])                # (B, A, L)
    ious = torch.where(gt_valid[:, None, :], ious, 0.0)

    # stage 1: bipartite, one (anchor, label) pair a round
    anchor_matched = torch.zeros((B, A), dtype=torch.bool, device=dev)
    gt_matched = ~gt_valid  # invalid labels count as matched
    match_gt = torch.full((B, A), -1, dtype=torch.int64, device=dev)
    match_iou = torch.full((B, A), -1.0, dtype=f32, device=dev)
    for _ in range(min(A, L)):
        m = torch.where(anchor_matched[:, :, None] | gt_matched[:, None, :], -1.0, ious)
        flat = torch.argmax(m.reshape(B, A * L), dim=1)
        i, k = flat // L, flat % L
        best = _batch_get(m.reshape(B, A * L), flat)
        ok = best > 1e-6
        _batch_set(anchor_matched, i, _batch_get(anchor_matched, i) | ok)
        _batch_set(gt_matched, k, _batch_get(gt_matched, k) | ok)
        _batch_set(match_gt, i, torch.where(ok, k, _batch_get(match_gt, i)))
        _batch_set(match_iou, i, torch.where(ok, best, _batch_get(match_iou, i)))
    positive = anchor_matched

    # stage 2: threshold matching for the other anchors
    best_gt = torch.argmax(ious, dim=2)
    best_iou = torch.gather(ious, 2, best_gt[..., None])[..., 0]
    if overlap_threshold > 0:
        thr_pos = ~positive & (best_iou > overlap_threshold) & has_gt
        match_gt = torch.where(thr_pos, best_gt, match_gt)
        match_iou = torch.where(thr_pos, best_iou, match_iou)
        positive = positive | thr_pos
    num_positive = positive.sum(1)

    # stage 3: negatives
    cand_iou = torch.where(positive, match_iou, best_iou)
    if negative_mining_ratio > 0:
        # jax.nn.softmax's steps, background row only
        x = cls_pred.to(f32)
        e = torch.exp(x - x.amax(dim=1, keepdim=True))
        prob_bg = e[:, 0] / e.sum(dim=1)                           # (B, A)
        cand = ~positive & (cand_iou < negative_mining_thresh)
        num_neg = torch.minimum(
            torch.clamp((num_positive * negative_mining_ratio).to(torch.int32),
                        min=int(minimum_negative_samples)),
            (A - num_positive).to(torch.int32))
        key = torch.where(cand, -prob_bg, -1e30)
        order = torch.argsort(-key, dim=1, stable=True)  # candidates, lowest prob first
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(A, device=dev).expand(B, A))
        negative = cand & (rank < num_neg[:, None])
    else:
        negative = ~positive
    negative = negative & has_gt
    positive = positive & has_gt

    # targets, encoded against the matched labels
    g = torch.gather(label, 1, torch.clamp(match_gt, 0, L - 1)[..., None].expand(B, A, LW))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    gw = g[..., 3] - g[..., 1]
    gh = g[..., 4] - g[..., 2]
    gx = (g[..., 1] + g[..., 3]) * 0.5
    gy = (g[..., 2] + g[..., 4]) * 0.5
    loc = torch.stack([_times_inverse((gx - ax) / aw, vx),
                       _times_inverse((gy - ay) / ah, vy),
                       _times_inverse(torch.log(torch.clamp(gw / aw, min=1e-12)), vw),
                       _times_inverse(torch.log(torch.clamp(gh / ah, min=1e-12)), vh)],
                      dim=-1)                                       # (B, A, 4)
    pos4 = positive[..., None]
    loc_target = torch.where(pos4, loc, 0.0).reshape(B, A * 4)
    loc_mask = pos4.expand(B, A, 4).to(f32).reshape(B, A * 4)
    cls_t = torch.where(positive, g[..., 0] + 1.0,
                        torch.where(negative, 0.0, float(ignore_label)))
    return loc_target, loc_mask, cls_t


@register("_contrib_MultiBoxDetection", alias=["MultiBoxDetection"])
@torch.no_grad()
def multibox_detection(cls_prob, loc_pred, anchor, *, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD decode and per-class NMS (reference multibox_detection.cc:83-190;
    ``mxnet_tpu/ops/detection.py multibox_detection``), the image a batch
    dimension.

    cls_prob (B, C, A) float32 probabilities, class 0 the background (as
    in the JAX op, ``background_id`` is not read); loc_pred (B, A·4)
    offsets; anchor (1, A, 4).  Each anchor takes its best foreground class
    (-1 below ``threshold``); the decoded boxes are clipped to [0, 1] with
    ``clip``, sorted by score (stable) and cut to the first ``nms_topk``;
    then greedy NMS at ``nms_threshold`` among boxes of one class (of all
    classes with ``force_suppress``): one ``nms_alive`` launch for the
    batch.  -> (B, A, 6) rows ``[class_id, score, x1, y1, x2, y2]``, valid
    rows first by score; a suppressed row keeps its score and box with
    class -1, and a row past the valid ones is all -1."""
    B, C, A = cls_prob.shape
    vx, vy, vw, vh = _floats(variances)
    anchors = anchor.reshape(A, 4)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5

    fg = cls_prob[:, 1:]
    score = fg.amax(dim=1)                                          # (B, A)
    cid = torch.argmax(fg, dim=1).to(cls_prob.dtype)  # 0-based class id
    cid = torch.where(score < threshold, -1.0, cid)
    lp = loc_pred.reshape(B, A, 4)
    ox = lp[..., 0] * vx * aw + ax
    oy = lp[..., 1] * vy * ah + ay
    ow = torch.exp(lp[..., 2] * vw) * aw * 0.5
    oh = torch.exp(lp[..., 3] * vh) * ah * 0.5
    coords = [ox - ow, oy - oh, ox + ow, oy + oh]
    if clip:
        coords = [torch.clamp(v, 0.0, 1.0) for v in coords]
    valid = cid >= 0
    # valid detections by score, highest first; the others sink to the end
    order = torch.argsort(-torch.where(valid, score, -math.inf), dim=1, stable=True)
    cid, score, valid = (torch.gather(v, 1, order) for v in (cid, score, valid))
    boxes = torch.gather(torch.stack(coords, dim=-1), 1, order[..., None].expand(B, A, 4))
    if nms_topk > 0:
        valid = valid & (torch.arange(A, device=valid.device) < nms_topk)
        cid = torch.where(valid, cid, torch.where(cid >= 0, -1.0, cid))
    if 0 < nms_threshold <= 1:
        alive = kernels.nms_alive(boxes, cid >= 0, None if force_suppress else cid,
                                  thresh=nms_threshold, plus_one=0.0)
        cid = torch.where(alive | (cid < 0), cid, -1.0)
    row = torch.cat([cid[..., None], score[..., None], boxes], dim=-1)
    return torch.where(valid[..., None], row, -1.0)


# ---------------------------------------------------------------------------
# Generic box ops (reference contrib/bounding_box-inl.h)
# ---------------------------------------------------------------------------


def _to_corner(box):
    x, y, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _to_center(box):
    x1, y1, x2, y2 = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


@register("_contrib_box_iou", alias=["box_iou"])
def box_iou(lhs, rhs, *, format="corner"):
    """Pairwise IoU (reference bounding_box-inl.h BoxOverlapForward): lhs
    (..., N, 4) × rhs (..., M, 4) -> (..., N, M), the leading dimensions
    paired as the JAX op's ``vmap`` pairs them; ``format`` "corner" or
    "center" (x, y, w, h)."""
    if format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    N, M = lhs.shape[-2], rhs.shape[-2]
    out = _box_iou_corner(lhs.reshape(-1, N, 4), rhs.reshape(-1, M, 4))
    return out.reshape(*lhs.shape[:-2], N, M) if lhs.dim() > 2 else out[0]


@register("_contrib_box_nms", alias=["box_nms", "_contrib_box_non_maximum_suppression"])
@torch.no_grad()
def box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1, coord_start=2,
            score_index=1, id_index=-1, force_suppress=False, in_format="corner",
            out_format="corner"):
    """Greedy NMS over rows (reference bounding_box-inl.h BoxNMSForward):
    data (..., N, K) float32, each row a score at ``score_index``, four
    coordinates from ``coord_start`` (``in_format`` "corner" or "center")
    and, with ``id_index`` >= 0, a class id: only boxes of one id suppress
    each other unless ``force_suppress``.  Rows with a score above
    ``valid_thresh`` are sorted by score (stable), the first ``topk`` kept,
    and one ``nms_alive`` launch over every leading index settles them.
    -> the same shape: surviving rows by score, coordinates in
    ``out_format``; the other rows -1."""
    shape = data.shape
    N, K = shape[-2], shape[-1]
    if N == 0:
        return data
    cs, si = int(coord_start), int(score_index)
    flat = data.reshape(-1, N, K)
    score = flat[..., si]
    valid = score > valid_thresh
    order = torch.argsort(-torch.where(valid, score, -math.inf), dim=1, stable=True)
    d = torch.gather(flat, 1, order[..., None].expand(-1, -1, K))
    valid = torch.gather(valid, 1, order)
    if topk > 0:
        valid = valid & (torch.arange(N, device=data.device) < topk)
    boxes = d[..., cs:cs + 4]
    if in_format == "center":
        boxes = _to_corner(boxes)
    ids = d[..., id_index] if id_index >= 0 and not force_suppress else None
    alive = kernels.nms_alive(boxes.contiguous(), valid, ids, thresh=overlap_thresh,
                              plus_one=0.0)
    out = d
    if out_format != in_format:
        conv = _to_corner if out_format == "corner" else _to_center
        out = torch.cat([d[..., :cs], conv(d[..., cs:cs + 4]), d[..., cs + 4:]], dim=-1)
    return torch.where((alive & valid)[..., None], out, -1.0).reshape(shape)


@register("_contrib_bipartite_matching", alias=["bipartite_matching"])
@torch.no_grad()
def bipartite_matching(data, *, threshold, is_ascend=False, topk=-1):
    """Greedy bipartite matching (reference bounding_box-inl.h
    BipartiteMatchingForward): data (..., N, M) scores; each round takes
    the best remaining pair (the first of the flattened matrix, highest
    score or with ``is_ascend`` lowest) while it passes ``threshold``, up
    to ``topk`` rounds (``min(N, M)`` when not positive).  -> (row_match
    (..., N), col_match (..., M)) in data's dtype, -1 where unmatched."""
    shape = data.shape
    N, M = shape[-2], shape[-1]
    flat = data.reshape(-1, N, M)
    Bf = flat.shape[0]
    dev = data.device
    s = flat * (1.0 if is_ascend else -1.0)  # lowest first
    rows = torch.full((Bf, N), -1.0, dtype=data.dtype, device=dev)
    cols = torch.full((Bf, M), -1.0, dtype=data.dtype, device=dev)
    rn = torch.arange(N, device=dev)
    cn = torch.arange(M, device=dev)
    k = min(N, M) if topk <= 0 else min(topk, N, M)
    for _ in range(k):
        f = torch.argmin(s.reshape(Bf, N * M), dim=1)
        i, j = f // M, f % M
        d = _batch_get(flat.reshape(Bf, N * M), f)
        passes = d <= threshold if is_ascend else d >= threshold
        ok = (_batch_get(s.reshape(Bf, N * M), f) < math.inf) & passes
        _batch_set(rows, i, torch.where(ok, j.to(data.dtype), _batch_get(rows, i)))
        _batch_set(cols, j, torch.where(ok, i.to(data.dtype), _batch_get(cols, j)))
        taken = (rn[None, :, None] == i[:, None, None]) | (cn[None, None, :] == j[:, None, None])
        s = torch.where(ok[:, None, None] & taken, math.inf, s)
    return rows.reshape(shape[:-1]), cols.reshape(*shape[:-2], M)
