"""The port's hand-written CUDA kernels: wrappers, plain versions, launch counts.

Counterpart of ``mxnet_tpu/ops/pallas_kernels.py``.  Each kernel here has

* a wrapper, which checks device, dtype, shape and contiguity, allocates
  outputs with ``torch.empty`` and launches on the current stream.  For a
  tensor on the CPU it returns the plain version's result; for a CUDA tensor
  it launches the kernel or raises;
* the plain PyTorch version of the same function (``*_plain``), which the CPU
  tests hold against the JAX package and ``chip_smoke.py`` holds the kernel
  against on the card;
* ``<wrapper>.launches``, a plain integer that the wrapper adds one to where
  it launches its kernel, and nowhere else.

The int8 pair (``quantize_int8``, ``dequantize_int8``) also takes ``meta``
tensors to its plain version, which computes nothing, and ``nms_alive``
returns an empty ``meta`` mask for them: the symbolic frontend's shape
inference runs the operators on them.

Two of the TPU kernels are dtype-generic, and so are their counterparts
here: the dconv pair takes a bfloat16 ``ft`` (and ``g``), and the A-build
pair writes A in bfloat16 (and takes a bfloat16 ``g``), each accumulating
in fp32 as the TPU kernel does.  Each bfloat16 instance is a kernel of its
own with its own wrapper and count (``dconv_col_bf16`` and so on, rows
``dconv_col[bf16]`` of :data:`KERNELS`); the dtype-generic wrapper passes a
bfloat16 call to it.  float16 raises.

Callers reach the wrappers as attributes of this module (``kernels.nms_alive``).
The kernels with a backward (``dconv_col``, ``psroi_abuild``) are also
``torch.autograd.Function``s (``DConvCol``, ``PSROIABuild``), the
counterparts of the TPU kernels' custom VJPs.  The kernel sources are under
``csrc/``; ``_build.py`` compiles them at first use.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from . import _build

__all__ = ["nms_alive", "nms_alive_plain", "dconv_col", "dconv_col_bf16",
           "dconv_col_plain", "dconv_col_bwd", "dconv_col_bwd_bf16",
           "dconv_col_bwd_plain", "channel_major", "DConvCol",
           "psroi_abuild", "psroi_abuild_bf16", "psroi_abuild_plain",
           "psroi_abuild_bwd", "psroi_abuild_bwd_bf16",
           "psroi_abuild_bwd_plain", "PSROIABuild", "quantize_int8",
           "quantize_int8_plain", "dequantize_int8", "dequantize_int8_plain",
           "Kernel", "KERNELS", "reset_launches"]


def _require(cond, what):
    if not cond:
        raise ValueError(what)


def _same_device(name, *tensors):
    dev = tensors[0].device
    _require(all(t.device == dev for t in tensors),
             "%s: all inputs must be on one device" % name)
    return dev


def _contiguous(name, **tensors):
    for k, t in tensors.items():
        _require(t.is_contiguous(), "%s: %s must be contiguous" % (name, k))


_BF16 = torch.bfloat16
_FLOATS = (torch.float32, torch.bfloat16)


def _float(name, what, t):
    """Raise unless ``t`` is float32 or bfloat16, the dtypes the kernels
    take."""
    _require(t.dtype in _FLOATS, "%s: %s must be float32 or bfloat16, got %s "
             "(ROADMAP.md A4.3 ported these two; float16 and other dtypes are "
             "not ported)" % (name, what, t.dtype))


def _launch(name, dev, entry, *args):
    """Launch C entry ``entry`` on ``dev``'s current stream; raise on a CUDA
    error, else count the launch on the kernel's wrapper (looked up in
    KERNELS, so that a caller may wrap the module attribute)."""
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.check(lib, getattr(lib, entry)(*args, stream), name)
    KERNELS[name].wrapper.launches += 1


# ---------------------------------------------------------------------------
# greedy NMS survivor mask (replaces pallas_kernels.py _nms_pallas_batched)
# ---------------------------------------------------------------------------


def box_area(boxes, plus_one):
    """Area with the ``plus_one`` rule; inverted boxes count as 0 (reference
    BoxArea), in the JAX formula's operation order."""
    return (torch.clamp(boxes[..., 2] - boxes[..., 0] + plus_one, min=0.0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1] + plus_one, min=0.0))


def iou_mat(a, a_area, b, b_area, plus_one=0.0):
    """Dense IoU (..., A, B) between corner-box sets (..., A, 4), (..., B, 4)
    (``mxnet_tpu/ops/detection.py _iou_mat``, same operation order)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(br - tl + plus_one, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a_area[..., :, None] + b_area[..., None, :] - inter
    return torch.where(union <= 0, 0.0, inter / torch.clamp(union, min=1e-12))


_NMS_TILE = 256


def nms_alive_plain(boxes, valid, ids=None, *, thresh, plus_one=1.0):
    """Plain version of :func:`nms_alive`: the blocked greedy scan of
    ``mxnet_tpu/ops/detection.py _nms_alive_blocked_xla``, batched.

    Each tile of score-ordered boxes settles its survivors by iterating the
    intra-tile suppression map to its fixed point, then kills the later
    boxes they overlap.  Survivors equal the sequential greedy scan's for
    any tile size.  A tile with no live box in any image settles nothing
    and kills nothing, and is skipped (SSD's detections are valid only in
    their first ``nms_topk`` rows).
    """
    B, N = boxes.shape[:2]
    dev = boxes.device
    if N == 0:
        return torch.zeros((B, 0), dtype=torch.bool, device=dev)
    T = min(_NMS_TILE, N)
    nb = -(-N // T)
    Np = nb * T
    boxes_p = torch.nn.functional.pad(boxes, (0, 0, 0, Np - N))
    alive = torch.zeros((B, Np), dtype=torch.bool, device=dev)
    alive[:, :N] = valid
    ids_p = None if ids is None else torch.nn.functional.pad(ids, (0, Np - N))
    area = box_area(boxes_p, plus_one)
    intra_lt = (torch.arange(T, device=dev)[:, None]
                < torch.arange(T, device=dev)[None, :])  # [j, i]: j < i
    for k in range(nb):
        sl = slice(k * T, (k + 1) * T)
        later = slice((k + 1) * T, Np)
        tb, tarea, ta = boxes_p[:, sl], area[:, sl], alive[:, sl]
        if not bool(ta.any()):
            continue
        # sup[b, j, i]: j would suppress i (j earlier in score order)
        sup = (iou_mat(tb, tarea, tb, tarea, plus_one) > thresh) & intra_lt
        if ids_p is not None:
            tid = ids_p[:, sl]
            sup &= tid[:, :, None] == tid[:, None, :]
        prev = ta
        cur = ta & ~(sup & ta[:, :, None]).any(1)
        while bool((prev != cur).any()):
            prev, cur = cur, ta & ~(sup & cur[:, :, None]).any(1)
        cross = ((iou_mat(tb, tarea, boxes_p[:, later], area[:, later], plus_one)
                  > thresh) & cur[:, :, None])
        if ids_p is not None:
            cross &= tid[:, :, None] == ids_p[:, None, later]
        alive[:, later] &= ~cross.any(1)
        alive[:, sl] = cur
    return alive[:, :N]


def nms_alive(boxes, valid, ids=None, *, thresh, plus_one=1.0):
    """Greedy-NMS survivor mask over score-ordered boxes, batched.

    boxes (B, N, 4) f32 [x1, y1, x2, y2]; valid (B, N) bool, rows dead from
    the start; ids (B, N) or None: when given, only equal-id pairs suppress
    (per-class NMS).  Returns (B, N) bool: box i survives iff valid and no
    surviving j < i has IoU > ``thresh``.  One launch for the whole batch.
    """
    _require(boxes.dim() == 3 and boxes.shape[-1] == 4,
             "nms_alive: boxes must be (B, N, 4), got %s" % (tuple(boxes.shape),))
    B, N = boxes.shape[:2]
    _require(valid.shape == (B, N) and valid.dtype == torch.bool,
             "nms_alive: valid must be bool (B, N)")
    _require(ids is None or ids.shape == (B, N),
             "nms_alive: ids must be (B, N)")
    _require(boxes.dtype == torch.float32, "nms_alive: boxes must be float32")
    tensors = (boxes, valid) if ids is None else (boxes, valid, ids)
    dev = _same_device("nms_alive", *tensors)
    if dev.type == "cpu":
        return nms_alive_plain(boxes, valid, ids, thresh=thresh,
                               plus_one=plus_one)
    if dev.type == "meta":  # shape inference: the mask's shape, no values
        return torch.empty((B, N), dtype=torch.bool, device=dev)
    _require(dev.type == "cuda", "nms_alive: unsupported device %s" % dev)
    idf = None if ids is None else ids.to(torch.float32).contiguous()
    _contiguous("nms_alive", boxes=boxes, valid=valid)
    alive = torch.empty((B, N), dtype=torch.bool, device=dev)
    if B == 0 or N == 0:
        return alive
    words = -(-N // 64)
    _require(words * 8 <= 48 * 1024, "nms_alive: N=%d exceeds the kernel's "
             "shared-memory word array (N <= 393216)" % N)
    area = box_area(boxes, plus_one).contiguous()
    mask = torch.empty((B, N, words), dtype=torch.int64, device=dev)
    _launch("nms_alive", dev, "mx_nms_alive", boxes.data_ptr(),
            area.data_ptr(), valid.data_ptr(),
            None if idf is None else idf.data_ptr(), mask.data_ptr(),
            alive.data_ptr(), B, N, float(thresh), float(plus_one))
    return alive


nms_alive.launches = 0


# ---------------------------------------------------------------------------
# deformable-conv sampling (replaces pallas_kernels.py _dconv_impl forward)
# ---------------------------------------------------------------------------


def dconv_col_plain(y0, y1, x0, x1, ly, lx, lf, ft, hw):
    """Plain version of :func:`dconv_col`: the one-hot formulation of
    ``mxnet_tpu/ops/detection.py`` (the separable path's ``one_bg``),
    building A = yv ⊗ xv in memory and multiplying it with ``ft``."""
    H, W = hw
    BG, N = y0.shape
    iy = torch.arange(H, device=y0.device)
    ix = torch.arange(W, device=y0.device)
    yv = ((1.0 - ly)[..., None] * (y0[..., None] == iy)
          + ly[..., None] * (y1[..., None] == iy))                    # (BG,N,H)
    xv = lf[..., None] * ((1.0 - lx)[..., None] * (x0[..., None] == ix)
                          + lx[..., None] * (x1[..., None] == ix))    # (BG,N,W)
    a = (yv[..., :, None] * xv[..., None, :]).reshape(BG, N, H * W)
    col = _col_empty(BG, N, ft.shape[2], ft.device, ft.dtype)
    if ft.dtype == _BF16:
        # A rounded to bf16, its product with ft summed in fp32, rounded once
        return col.copy_(torch.bmm(a.to(_BF16).float(), ft.float()))
    return col.copy_(torch.bmm(a, ft))


def _col_empty(BG, N, C, dev, dtype=torch.float32):
    """The (BG, N, C) column, stored channel-major: strides (C·N, 1, N)."""
    return torch.empty_strided((BG, N, C), (C * N, 1, N), dtype=dtype, device=dev)


def dconv_col(y0, y1, x0, x1, ly, lx, lf, ft, hw):
    """col[bg, n, :] = Σ_p A[bg, n, p] ft[bg, p, :], the bilinear sample of
    ``ft`` at one deformable tap (``dconv_col_pallas`` forward).

    y0, y1, x0, x1 (BG, N) int32 corner indices inside the (H, W) map;
    ly, lx (BG, N) f32 lerp factors; lf (BG, N) f32 live mask;
    ft (BG, H·W, C) f32 or bf16.  Returns (BG, N, C) in ft's dtype stored
    channel-major, strides (C·N, 1, N), on both devices: the layout of the
    weight product in ``deformable_convolution``, whose reshapes of it are
    then views.  A bf16 ``ft`` goes to :func:`dconv_col_bf16`.
    """
    if ft.dtype == _BF16:
        return dconv_col_bf16(y0, y1, x0, x1, ly, lx, lf, ft, hw)
    shape = _dconv_check("dconv_col", y0, y1, x0, x1, ly, lx, lf, ft, hw)
    return _dconv_col("dconv_col", "mx_dconv_col", y0, y1, x0, x1, ly, lx, lf,
                      ft, shape)


def dconv_col_bf16(y0, y1, x0, x1, ly, lx, lf, ft, hw):
    """:func:`dconv_col` for a bf16 ``ft``, to the contract of the TPU
    kernel's bf16 instance (``_dconv_fwd_kernel_factory``): A = yfac·xfac·lf
    in fp32, rounded to bf16, times ft, summed in fp32 and rounded once to
    the bf16 column."""
    shape = _dconv_check("dconv_col_bf16", y0, y1, x0, x1, ly, lx, lf, ft, hw)
    _require(ft.dtype == _BF16, "dconv_col_bf16: ft must be bfloat16")
    return _dconv_col("dconv_col[bf16]", "mx_dconv_col_bf16", y0, y1, x0, x1,
                      ly, lx, lf, ft, shape)


def _dconv_col(name, entry, y0, y1, x0, x1, ly, lx, lf, ft, shape):
    H, W, BG, N = shape
    dev = _same_device(name, y0, y1, x0, x1, ly, lx, lf, ft)
    if dev.type == "cpu":
        return dconv_col_plain(y0, y1, x0, x1, ly, lx, lf, ft, (H, W))
    _require(dev.type == "cuda", "%s: unsupported device %s" % (name, dev))
    _contiguous(name, y0=y0, y1=y1, x0=x0, x1=x1, ly=ly, lx=lx, lf=lf, ft=ft)
    C = ft.shape[2]
    col = _col_empty(BG, N, C, dev, ft.dtype)
    if col.numel() == 0:
        return col
    tensors = (y0, y1, x0, x1, ly, lx, lf, ft, col)
    _launch(name, dev, entry, *(t.data_ptr() for t in tensors),
            BG, N, H, W, C, _dconv_col_vec(tensors, N, C))
    return col


def _dconv_col_vec(tensors, N, C):
    """1 where the tiled dconv forward takes the call: its 16-byte accesses
    need whole float4s of channels and of rows, and aligned pointers."""
    return int(C % 4 == 0 and N % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


dconv_col.launches = 0
dconv_col_bf16.launches = 0


def _dconv_check(name, y0, y1, x0, x1, ly, lx, lf, ft, hw):
    """Shared argument checks of the dconv forward and backward wrappers."""
    H, W = (int(v) for v in hw)
    _require(y0.dim() == 2, "%s: factors must be (BG, N)" % name)
    BG, N = y0.shape
    for k, t in (("y0", y0), ("y1", y1), ("x0", x0), ("x1", x1)):
        _require(t.shape == (BG, N) and t.dtype == torch.int32,
                 "%s: %s must be int32 (BG, N)" % (name, k))
    for k, t in (("ly", ly), ("lx", lx), ("lf", lf)):
        _require(t.shape == (BG, N) and t.dtype == torch.float32,
                 "%s: %s must be float32 (BG, N)" % (name, k))
    _require(ft.dim() == 3 and ft.shape[:2] == (BG, H * W),
             "%s: ft must be (BG, H*W, C)" % name)
    _float(name, "ft", ft)
    return H, W, BG, N


def dconv_col_bwd_plain(y0, y1, x0, x1, ly, lx, lf, ft, g, hw, layout=None):
    """Plain version of :func:`dconv_col_bwd`: the one-hot formulation of the
    TPU kernel (``_dconv_bwd_kernel_factory``): build A, take dA = g·ftᵀ,
    reduce it against the one-hot masks, and d_ft = Aᵀ·g.  ``g`` may have
    any strides; the rows' ``layout`` does not change the result.  With a
    bf16 ``ft`` and ``g`` (``dconv_col_bwd_bf16``): dA and the row sums in
    fp32, and d_ft = bf16(A)ᵀ·g summed in fp32 and rounded once to bf16."""
    H, W = hw
    BG, N = y0.shape
    out_dtype = ft.dtype
    ft, g = ft.float(), g.float()
    iy = torch.arange(H, device=y0.device)
    ix = torch.arange(W, device=y0.device)
    e0y = (y0[..., None] == iy).to(ft.dtype)
    e1y = (y1[..., None] == iy).to(ft.dtype)
    e0x = (x0[..., None] == ix).to(ft.dtype)
    e1x = (x1[..., None] == ix).to(ft.dtype)
    yfac = (1.0 - ly)[..., None] * e0y + ly[..., None] * e1y            # (BG,N,H)
    xfac = (1.0 - lx)[..., None] * e0x + lx[..., None] * e1x            # (BG,N,W)
    da = torch.bmm(g, ft.transpose(1, 2)).reshape(BG, N, H, W)
    da_x = (da * xfac[..., None, :]).sum(3)                              # (BG,N,H)
    d_ly = (da_x * (e1y - e0y)).sum(2) * lf
    d_lx = ((da * yfac[..., :, None]).sum(2) * (e1x - e0x)).sum(2) * lf
    d_lf = (da_x * yfac).sum(2)
    a = (yfac[..., :, None] * xfac[..., None, :] * lf[..., None, None]).reshape(BG, N, H * W)
    if out_dtype == _BF16:
        a = a.to(_BF16).float()
    d_ft = torch.bmm(a.transpose(1, 2), g).to(out_dtype)
    return d_ly, d_lx, d_lf, d_ft


def channel_major(g):
    """Whether ``g`` (BG, N, C) is laid out channel-major, strides
    (C·N, 1, N): a transposed view of a contiguous (BG, C, N) tensor, which
    is how the autograd hands ``deformable_convolution``'s column gradient."""
    return g.dim() == 3 and not g.is_contiguous() and g.transpose(1, 2).is_contiguous()


def dconv_col_bwd(y0, y1, x0, x1, ly, lx, lf, ft, g, hw, layout=None):
    """Gradients of :func:`dconv_col` for the cotangent ``g`` (BG, N, C) of
    col (``dconv_col_pallas``'s custom VJP): returns (d_ly, d_lx, d_lf) as
    (BG, N) f32 and d_ft (BG, H·W, C) in ft's dtype.  The int inputs get
    none.  ``g`` has ft's dtype and is contiguous or channel-major
    (:func:`channel_major`), as the autograd hands it; the kernel reads
    either in place.  ``layout`` (K², Ho, Wo), where given, says the rows
    are laid out (tap, ho, wo), as
    :func:`~mxnet_tpu_torch.ops.detection.deformable_convolution` builds
    them: with a channel-major ``g`` the kernel then sums each tile's
    corner terms in shared memory.  A bf16 ``ft`` goes to
    :func:`dconv_col_bwd_bf16`."""
    if ft.dtype == _BF16:
        return dconv_col_bwd_bf16(y0, y1, x0, x1, ly, lx, lf, ft, g, hw, layout)
    shape = _dconv_bwd_check("dconv_col_bwd", y0, y1, x0, x1, ly, lx, lf, ft,
                             g, hw, layout)
    return _dconv_col_bwd("dconv_col_bwd", "mx_dconv_col_bwd", y0, y1, x0, x1,
                          ly, lx, lf, ft, g, shape, layout)


def dconv_col_bwd_bf16(y0, y1, x0, x1, ly, lx, lf, ft, g, hw, layout=None):
    """:func:`dconv_col_bwd` for bf16 ``ft`` and ``g``, to the contract of
    the TPU kernel's bf16 instance (``_dconv_bwd_kernel_factory``,
    ``_dconv_bwd``): dA = g·ftᵀ and the three row sums in fp32, written
    fp32; d_ft = bf16(A)ᵀ·g accumulated in fp32 over every row and rounded
    once to bf16 at the end.  One cooperative kernel launch a call, which
    zeroes, fills and rounds an fp32 buffer that the wrapper allocates; the
    wrapper raises if the card refuses the launch."""
    shape = _dconv_bwd_check("dconv_col_bwd_bf16", y0, y1, x0, x1, ly, lx, lf,
                             ft, g, hw, layout)
    _require(ft.dtype == _BF16, "dconv_col_bwd_bf16: ft and g must be bfloat16")
    return _dconv_col_bwd("dconv_col_bwd[bf16]", "mx_dconv_col_bwd_bf16", y0,
                          y1, x0, x1, ly, lx, lf, ft, g, shape, layout)


def _dconv_bwd_check(name, y0, y1, x0, x1, ly, lx, lf, ft, g, hw, layout):
    H, W, BG, N = _dconv_check(name, y0, y1, x0, x1, ly, lx, lf, ft, hw)
    C = ft.shape[2]
    _require(g.shape == (BG, N, C) and g.dtype == ft.dtype,
             "%s: g must be %s (BG, N, C), ft's dtype" % (name, str(ft.dtype)[6:]))
    _require(g.is_contiguous() or channel_major(g), "%s: g must be "
             "contiguous or channel-major (strides (C*N, 1, N)), got strides %s"
             % (name, tuple(g.stride())))
    _require(layout is None or (all(isinstance(v, int) and v > 0 for v in layout)
                                and layout[0] * layout[1] * layout[2] == N),
             "%s: layout (K2, Ho, Wo) must be positive ints with "
             "K2*Ho*Wo == N = %d, got %s" % (name, N, layout))
    return H, W, BG, N


def _dconv_col_bwd(name, entry, y0, y1, x0, x1, ly, lx, lf, ft, g, shape, layout):
    H, W, BG, N = shape
    C = ft.shape[2]
    g_row, g_chan = (C, 1) if g.is_contiguous() else (1, N)
    k2, ho, wo = (0, 0, 0) if layout is None else layout
    dev = _same_device(name, y0, y1, x0, x1, ly, lx, lf, ft, g)
    if dev.type == "cpu":
        return dconv_col_bwd_plain(y0, y1, x0, x1, ly, lx, lf, ft, g, (H, W))
    _require(dev.type == "cuda", "%s: unsupported device %s" % (name, dev))
    _contiguous(name, y0=y0, y1=y1, x0=x0, x1=x1, ly=ly, lx=lx, lf=lf, ft=ft)
    if BG * N == 0 or C == 0:  # nothing to launch: every sum is empty
        z = torch.zeros((BG, N), dtype=torch.float32, device=dev)
        return z, z.clone(), z.clone(), torch.zeros_like(ft)
    rows = [torch.empty((BG, N), dtype=torch.float32, device=dev) for _ in range(3)]
    d_ft = torch.empty_like(ft)  # fp32: zeroed by the entry, on the stream
    # the bf16 instance sums d_ft in an fp32 buffer, which its kernel zeroes
    # and rounds into d_ft
    acc = (torch.empty(ft.shape, dtype=torch.float32, device=dev)
           if ft.dtype == _BF16 else None)
    extra = () if acc is None else (acc.data_ptr(),)
    _launch(name, dev, entry, y0.data_ptr(),
            y1.data_ptr(), x0.data_ptr(), x1.data_ptr(), ly.data_ptr(),
            lx.data_ptr(), lf.data_ptr(), ft.data_ptr(), g.data_ptr(),
            *(t.data_ptr() for t in rows), d_ft.data_ptr(), *extra, BG, N, H, W,
            C, g_row, g_chan, k2, ho, wo)
    return (*rows, d_ft)


dconv_col_bwd.launches = 0
dconv_col_bwd_bf16.launches = 0


class DConvCol(torch.autograd.Function):
    """:func:`dconv_col` with its gradient from :func:`dconv_col_bwd`
    (counterpart of ``dconv_col_pallas``'s custom VJP): no gradient for the
    int corner indices, and the backward launches only when one of ly, lx,
    lf, ft needs a gradient.  A channel-major cotangent goes to the backward
    as it comes, any other is made contiguous.  An optional last argument,
    the rows' layout (K², Ho, Wo), goes to the backward wrapper.  The
    column comes out as :func:`dconv_col` stores it, channel-major.
    Both directions look the wrappers up as module attributes at call time,
    so a caller that wraps them sees every call."""

    @staticmethod
    def forward(ctx, y0, y1, x0, x1, ly, lx, lf, ft, hw, *layout):
        ctx.hw = hw
        ctx.layout = layout
        ctx.save_for_backward(y0, y1, x0, x1, ly, lx, lf, ft)
        return dconv_col(y0, y1, x0, x1, ly, lx, lf, ft, hw)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[4:8]
        rest = (None,) * (1 + len(ctx.layout))  # hw and the layout
        if not any(need):
            return (None,) * 8 + rest
        if not channel_major(g):
            g = g.contiguous()
        grads = dconv_col_bwd(*ctx.saved_tensors, g, ctx.hw, *ctx.layout)
        return (None,) * 4 + tuple(d if n else None for d, n in zip(grads, need)) + rest


# ---------------------------------------------------------------------------
# PS-ROI accumulation-matrix build (replaces pallas_kernels.py _abuild_impl)
# ---------------------------------------------------------------------------


def psroi_abuild_plain(yv, xv, out_dtype=torch.float32):
    """Plain version of :func:`psroi_abuild`: the rank-S outer-product sum,
    taken in fp32 over s in ascending order as the kernel does, and rounded
    once to ``out_dtype``."""
    a = yv[:, 0, :, None] * xv[:, 0, None, :]
    for s in range(1, yv.shape[1]):
        a = a + yv[:, s, :, None] * xv[:, s, None, :]
    return a.to(out_dtype)


def psroi_abuild(yv, xv, out_dtype=torch.float32):
    """A[n, h, w] = Σ_s yv[n, s, h]·xv[n, s, w], summed in fp32 and stored
    in ``out_dtype`` (``psroi_abuild_pallas`` forward, whose ``out_dtype``
    is the pooled map's).  yv (N, S, H), xv (N, S, W) f32; ``out_dtype``
    float32, or bfloat16 (:func:`psroi_abuild_bf16`)."""
    _require(out_dtype in _FLOATS, "psroi_abuild: out_dtype must be float32 "
             "or bfloat16, got %s (ROADMAP.md A4.3 ported these two; float16 "
             "and other dtypes are not ported)" % (out_dtype,))
    if out_dtype == _BF16:
        return psroi_abuild_bf16(yv, xv)
    _abuild_check("psroi_abuild", yv, xv)
    return _psroi_abuild("psroi_abuild", "mx_psroi_abuild", yv, xv, torch.float32)


def psroi_abuild_bf16(yv, xv):
    """:func:`psroi_abuild` with A stored in bf16: yv and xv stay fp32, the
    sum over s is fp32, and only the store rounds
    (``_abuild_fwd_kernel_factory`` with a bf16 ``out_dtype``)."""
    _abuild_check("psroi_abuild_bf16", yv, xv)
    return _psroi_abuild("psroi_abuild[bf16]", "mx_psroi_abuild_bf16", yv, xv, _BF16)


def _abuild_check(name, yv, xv):
    _require(yv.dim() == 3 and xv.dim() == 3 and yv.shape[:2] == xv.shape[:2],
             "%s: yv must be (N, S, H) and xv (N, S, W)" % name)
    _require(yv.dtype == torch.float32 and xv.dtype == torch.float32,
             "%s: yv and xv must be float32" % name)


def _psroi_abuild(name, entry, yv, xv, out_dtype):
    N, S, H = yv.shape
    W = xv.shape[2]
    _require(S >= 1, "%s: S must be at least 1" % name)
    dev = _same_device(name, yv, xv)
    if dev.type == "cpu":
        return psroi_abuild_plain(yv, xv, out_dtype)
    _require(dev.type == "cuda", "%s: unsupported device %s" % (name, dev))
    _contiguous(name, yv=yv, xv=xv)
    _require(S * (H + W) * 4 <= 227 * 1024, "%s: S*(H+W) too large "
             "for one block's shared memory" % name)
    a = torch.empty((N, H, W), dtype=out_dtype, device=dev)
    if a.numel() == 0:
        return a
    _launch(name, dev, entry, yv.data_ptr(), xv.data_ptr(), a.data_ptr(),
            N, S, H, W)
    return a


psroi_abuild.launches = 0
psroi_abuild_bf16.launches = 0


def psroi_abuild_bwd_plain(yv, xv, g):
    """Plain version of :func:`psroi_abuild_bwd`: each gradient as the
    products of its formula summed over the contracted axis, ``g`` upcast
    to fp32 first."""
    g = g.float()
    dyv = (g[:, None, :, :] * xv[:, :, None, :]).sum(3)   # sum over w
    dxv = (yv[:, :, :, None] * g[:, None, :, :]).sum(2)   # sum over h
    return dyv, dxv


def psroi_abuild_bwd(yv, xv, g):
    """Gradients of :func:`psroi_abuild` for the cotangent ``g`` (N, H, W) of
    A (``psroi_abuild_pallas``'s custom VJP): dyv[n, s, h] = Σ_w g[n, h, w]
    xv[n, s, w] and dxv[n, s, w] = Σ_h yv[n, s, h] g[n, h, w], in fp32.
    ``g`` is float32, or bfloat16 (:func:`psroi_abuild_bwd_bf16`)."""
    if g.dtype == _BF16:
        return psroi_abuild_bwd_bf16(yv, xv, g)
    shape = _abuild_bwd_check("psroi_abuild_bwd", yv, xv, g)
    return _psroi_abuild_bwd("psroi_abuild_bwd", "mx_psroi_abuild_bwd", yv, xv,
                             g, shape)


def psroi_abuild_bwd_bf16(yv, xv, g):
    """:func:`psroi_abuild_bwd` for a bf16 cotangent ``g`` (that of a bf16
    A): ``g`` is upcast to fp32 and dyv, dxv are written fp32
    (``_abuild_bwd_kernel_factory``)."""
    shape = _abuild_bwd_check("psroi_abuild_bwd_bf16", yv, xv, g)
    _require(g.dtype == _BF16, "psroi_abuild_bwd_bf16: g must be bfloat16")
    return _psroi_abuild_bwd("psroi_abuild_bwd[bf16]", "mx_psroi_abuild_bwd_bf16",
                             yv, xv, g, shape)


def _abuild_bwd_check(name, yv, xv, g):
    _abuild_check(name, yv, xv)
    N, S, H = yv.shape
    W = xv.shape[2]
    _require(g.shape == (N, H, W), "%s: g must be (N, H, W)" % name)
    _float(name, "g", g)
    return N, S, H, W


def _psroi_abuild_bwd(name, entry, yv, xv, g, shape):
    N, S, H, W = shape
    dev = _same_device(name, yv, xv, g)
    if dev.type == "cpu":
        return psroi_abuild_bwd_plain(yv, xv, g)
    _require(dev.type == "cuda", "%s: unsupported device %s" % (name, dev))
    _contiguous(name, yv=yv, xv=xv, g=g)
    _require(((H + S) * (W + 1) + S * H) * 4 <= 227 * 1024,
             "%s: H, W and S too large for one block's shared memory" % name)
    dyv = torch.empty_like(yv)
    dxv = torch.empty_like(xv)
    if N == 0 or S == 0:
        return dyv, dxv
    _launch(name, dev, entry, yv.data_ptr(), xv.data_ptr(), g.data_ptr(),
            dyv.data_ptr(), dxv.data_ptr(), N, S, H, W)
    return dyv, dxv


psroi_abuild_bwd.launches = 0
psroi_abuild_bwd_bf16.launches = 0


class PSROIABuild(torch.autograd.Function):
    """:func:`psroi_abuild` with its gradient from :func:`psroi_abuild_bwd`
    (counterpart of ``psroi_abuild_pallas``'s custom VJP).  An optional
    last argument is A's ``out_dtype``; the cotangent comes in that dtype.
    The wrappers are looked up as module attributes at call time."""

    @staticmethod
    def forward(ctx, yv, xv, out_dtype=torch.float32):
        ctx.save_for_backward(yv, xv)
        return psroi_abuild(yv, xv, out_dtype)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        if not any(need[:2]):
            return None, None, None
        dyv, dxv = psroi_abuild_bwd(*ctx.saved_tensors, g.contiguous())
        return (dyv if need[0] else None), (dxv if need[1] else None), None


# ---------------------------------------------------------------------------
# symmetric int8 quantize / dequantize (replace pallas_kernels.py
# quantize_int8_pallas and dequantize_int8_pallas)
# ---------------------------------------------------------------------------


def _fdiv(a, b):
    """a / b for 0-d float32 tensors as one correctly rounded division, the
    JAX op's.  A Python number is made a tensor on the other's device first:
    PyTorch's CUDA division by a host scalar multiplies by its reciprocal,
    and ``127.0 / t`` is ``t.reciprocal() * 127``; both round twice."""
    if not torch.is_tensor(a):
        a = torch.full((), a, dtype=torch.float32, device=b.device)
    if not torch.is_tensor(b):
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    return torch.div(a, b)


def quantize_int8_plain(x, real_range):
    """Plain version of :func:`quantize_int8`: the JAX op's expression
    (``mxnet_tpu/ops/quantization.py quantize``, int8 branch) in its order,
    with NaN made 0 before the cast as the JAX CPU path's cast does."""
    scale = _fdiv(127.0, real_range)
    q = torch.sign(x) * torch.clamp(torch.abs(x) * scale + 0.5, max=127.0)
    return torch.where(q == q, q, 0.0).to(torch.int8)


def _int8_pair_check(name, t, dtype, real_range):
    _require(t.dtype == dtype, "%s: input must be %s, got %s" % (name, dtype, t.dtype))
    _require(torch.is_tensor(real_range) and real_range.dim() == 0
             and real_range.dtype == torch.float32,
             "%s: real_range must be a 0-d float32 tensor" % name)
    dev = _same_device(name, t, real_range)
    if dev.type in ("cpu", "meta"):
        return dev
    _require(dev.type == "cuda", "%s: unsupported device %s" % (name, dev))
    _contiguous(name, input=t)
    return dev


def quantize_int8(x, real_range):
    """q = int8(sign(x)·min(|x|·127/range + 0.5, 127)), the cast truncating
    toward zero (``quantize_int8_pallas``).  x float32 of any shape;
    real_range a 0-d float32 tensor on x's device, read by the kernel on the
    device.  Returns int8 of x's shape."""
    dev = _int8_pair_check("quantize_int8", x, torch.float32, real_range)
    if dev.type != "cuda":
        return quantize_int8_plain(x, real_range)
    q = torch.empty(x.shape, dtype=torch.int8, device=dev)
    if x.numel() == 0:
        return q
    vec = int(x.data_ptr() % 16 == 0 and q.data_ptr() % 4 == 0)
    _launch("quantize_int8", dev, "mx_quantize_int8", x.data_ptr(),
            real_range.data_ptr(), q.data_ptr(), x.numel(), vec)
    return q


quantize_int8.launches = 0


def dequantize_int8_plain(q, real_range):
    """Plain version of :func:`dequantize_int8`: ``f32(q)·(range/127)``."""
    return q.to(torch.float32) * _fdiv(real_range, 127.0)


def dequantize_int8(q, real_range):
    """x = f32(q)·(range/127) (``dequantize_int8_pallas``).  q int8 of any
    shape; real_range a 0-d float32 tensor on q's device.  Returns float32
    of q's shape."""
    dev = _int8_pair_check("dequantize_int8", q, torch.int8, real_range)
    if dev.type != "cuda":
        return dequantize_int8_plain(q, real_range)
    x = torch.empty(q.shape, dtype=torch.float32, device=dev)
    if q.numel() == 0:
        return x
    vec = int(q.data_ptr() % 4 == 0 and x.data_ptr() % 16 == 0)
    _launch("dequantize_int8", dev, "mx_dequantize_int8", q.data_ptr(),
            real_range.data_ptr(), x.data_ptr(), q.numel(), vec)
    return x


dequantize_int8.launches = 0


class Kernel(NamedTuple):
    wrapper: Callable      # the launching entry; carries ``.launches``
    plain: Callable        # its plain PyTorch version
    source: str            # CUDA source, relative to the repository root
    replaces: str          # the TPU kernel it replaces, file:line


KERNELS = {
    "nms_alive": Kernel(nms_alive, nms_alive_plain,
                        "mxnet_tpu_torch/ops/csrc/nms_alive.cu",
                        "mxnet_tpu/ops/pallas_kernels.py:480"),
    "dconv_col": Kernel(dconv_col, dconv_col_plain,
                        "mxnet_tpu_torch/ops/csrc/dconv_col.cu",
                        "mxnet_tpu/ops/pallas_kernels.py:928"),
    "psroi_abuild": Kernel(psroi_abuild, psroi_abuild_plain,
                           "mxnet_tpu_torch/ops/csrc/psroi_abuild.cu",
                           "mxnet_tpu/ops/pallas_kernels.py:680"),
    "dconv_col_bwd": Kernel(dconv_col_bwd, dconv_col_bwd_plain,
                            "mxnet_tpu_torch/ops/csrc/dconv_col_bwd.cu",
                            "mxnet_tpu/ops/pallas_kernels.py:960"),
    "psroi_abuild_bwd": Kernel(psroi_abuild_bwd, psroi_abuild_bwd_plain,
                               "mxnet_tpu_torch/ops/csrc/psroi_abuild_bwd.cu",
                               "mxnet_tpu/ops/pallas_kernels.py:707"),
    "quantize_int8": Kernel(quantize_int8, quantize_int8_plain,
                            "mxnet_tpu_torch/ops/csrc/quantize_int8.cu",
                            "mxnet_tpu/ops/pallas_kernels.py:317"),
    "dequantize_int8": Kernel(dequantize_int8, dequantize_int8_plain,
                              "mxnet_tpu_torch/ops/csrc/quantize_int8.cu",
                              "mxnet_tpu/ops/pallas_kernels.py:327"),
    # the bf16 instances of the dtype-generic TPU kernels
    "dconv_col[bf16]": Kernel(dconv_col_bf16, dconv_col_plain,
                              "mxnet_tpu_torch/ops/csrc/dconv_col.cu",
                              "mxnet_tpu/ops/pallas_kernels.py:928"),
    "dconv_col_bwd[bf16]": Kernel(dconv_col_bwd_bf16, dconv_col_bwd_plain,
                                  "mxnet_tpu_torch/ops/csrc/dconv_col_bwd.cu",
                                  "mxnet_tpu/ops/pallas_kernels.py:960"),
    "psroi_abuild[bf16]": Kernel(psroi_abuild_bf16,
                                 functools.partial(psroi_abuild_plain, out_dtype=_BF16),
                                 "mxnet_tpu_torch/ops/csrc/psroi_abuild.cu",
                                 "mxnet_tpu/ops/pallas_kernels.py:680"),
    "psroi_abuild_bwd[bf16]": Kernel(psroi_abuild_bwd_bf16, psroi_abuild_bwd_plain,
                                     "mxnet_tpu_torch/ops/csrc/psroi_abuild_bwd.cu",
                                     "mxnet_tpu/ops/pallas_kernels.py:707"),
}


def reset_launches():
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.wrapper.launches = 0
