"""Contrib and legacy standalone operators (counterpart of
``mxnet_tpu/ops/contrib_ops.py``; reference src/operator/contrib/ ctc_loss.cc,
fft-inl.h, ifft-inl.h, count_sketch-inl.h, krprod.cc, quadratic_op-inl.h,
bilinear_resize-inl.h, transformer.cc, and src/operator/correlation-inl.h,
crop-inl.h), as plain PyTorch."""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = ["ctc_loss"]

_LOG_EPSILON = -1e5  # optax.ctc_loss's log(+0)


def _ctc_forward(logits, logit_pad, labels, label_pad, blank_id):
    """Per-sequence CTC loss of ``logits`` (N, T, C) against ``labels`` (N, L),
    both with 0/1 padding indicators: the log-space forward recursion of
    ``optax.ctc_loss`` (which the JAX op runs), step for step, over T.
    Its gradient is autograd's through the recursion, deterministic on
    every device."""
    n, t, _ = logits.shape
    maxlen = labels.shape[1]
    logprobs = torch.log_softmax(logits, dim=-1)
    labellens = maxlen - label_pad.sum(dim=1).to(torch.int64)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    repeat = torch.cat([repeat, repeat.new_zeros((n, 1))], dim=1)
    logprobs_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)        # (T, N, 1)
    idx = labels.to(torch.int64)[:, None, :].expand(n, t, maxlen)
    logprobs_emit = torch.gather(logprobs, 2, idx).transpose(0, 1)              # (T, N, L)
    phi = logits.new_full((n, maxlen + 1), _LOG_EPSILON)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    emit = logits.new_full((n, maxlen), _LOG_EPSILON)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=-1)

    pads = logit_pad.transpose(0, 1)
    for step in range(t):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + _LOG_EPSILON * repeat)
        lp_emit, lp_phi, pad = logprobs_emit[step], logprobs_phi[step], pads[step][:, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = prev_phi + lp_phi
        next_phi = update_phi(next_phi, emit + lp_phi + _LOG_EPSILON * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, labellens[:, None])[:, 0]


@register("_contrib_CTCLoss", alias=("_contrib_ctc_loss", "CTCLoss", "ctc_loss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None, *, use_data_lengths=False,
             use_label_lengths=False, blank_label="first"):
    """Connectionist temporal classification loss (reference
    src/operator/contrib/ctc_loss.cc:71; ``mxnet_tpu/ops/contrib_ops.py
    ctc_loss``), softmax inside.

    data (T, N, C) activations; label (N, L) class ids.  With
    ``blank_label="first"`` the blank is 0 and labels pad with 0; with
    ``"last"`` the blank is C − 1 and labels pad with −1.  The lengths,
    where used, mark the steps and labels past them as padding.  Returns
    the (N,) losses.  ``F.ctc_loss`` is not used: its padding rules differ
    and its CUDA backward is not deterministic."""
    t, n, c = data.shape
    # float32 at least (the JAX op's upcast); float64 stays float64
    logits = data.permute(1, 0, 2).to(torch.promote_types(data.dtype, torch.float32))
    label = label.to(torch.int64)
    if use_data_lengths and data_lengths is not None:
        steps = torch.arange(t, device=data.device)[None, :]
        logit_pad = (steps >= data_lengths.to(torch.int64)[:, None]).to(logits.dtype)
    else:
        logit_pad = logits.new_zeros((n, t))
    pad_value = 0 if blank_label == "first" else -1
    if use_label_lengths and label_lengths is not None:
        pos = torch.arange(label.shape[1], device=data.device)[None, :]
        label_pad = (pos >= label_lengths.to(torch.int64)[:, None]).to(logits.dtype)
    else:
        label_pad = (label == pad_value).to(logits.dtype)
    if blank_label == "first":
        blank_id, labels = 0, label
    else:
        blank_id, labels = c - 1, torch.where(label < 0, torch.zeros_like(label), label)
    return _ctc_forward(logits, logit_pad, labels, label_pad, blank_id)


@register("_contrib_fft", alias=("fft",))
def fft(data, *, compute_size=128):
    """FFT over the last axis, the complex result interleaved as
    (..., 2·d) [re, im, re, im, ...] (reference contrib/fft-inl.h)."""
    y = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.stack([y.real, y.imag], dim=-1)
    return out.reshape(*data.shape[:-1], data.shape[-1] * 2).to(data.dtype)


@register("_contrib_ifft", alias=("ifft",))
def ifft(data, *, compute_size=128):
    """Inverse FFT of interleaved complex input (..., 2·d) -> its real part
    (..., d), not scaled by 1/d, as cuFFT's (reference contrib/ifft-inl.h)."""
    d = data.shape[-1] // 2
    pairs = data.reshape(*data.shape[:-1], d, 2).to(torch.float32)
    z = torch.complex(pairs[..., 0], pairs[..., 1])
    return (torch.fft.ifft(z, dim=-1).real * d).to(data.dtype)


@register("_contrib_count_sketch", alias=("count_sketch",))
def count_sketch(data, h, s, *, out_dim, processing_batch_size=32):
    """Count-sketch projection ``out[n, h[i]] += s[i]·data[n, i]`` (reference
    contrib/count_sketch-inl.h)."""
    in_dim = data.shape[-1]
    flat = data.reshape(-1, in_dim)
    signed = flat * s.reshape(-1).to(data.dtype)[None, :]
    out = flat.new_zeros((flat.shape[0], out_dim))
    out = out.index_add(1, h.reshape(-1).to(torch.int64), signed)
    return out.reshape(*data.shape[:-1], out_dim)


@register("khatri_rao")
def khatri_rao(*matrices):
    """Column-wise Khatri-Rao product (reference contrib/krprod.cc:75)."""
    if not matrices:
        raise ValueError("khatri_rao needs at least one matrix")
    out = matrices[0]
    for m in matrices[1:]:
        k = out.shape[-1]
        if m.shape[-1] != k:
            raise ValueError("khatri_rao: column counts differ (%d, %d)" % (k, m.shape[-1]))
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, k)
    return out


@register("_contrib_quadratic", alias=("quadratic",))
def quadratic(data, *, a=0.0, b=0.0, c=0.0):
    """``a·x² + b·x + c`` (reference contrib/quadratic_op-inl.h:40)."""
    return a * data * data + b * data + c


@register("_contrib_BilinearResize2D", alias=("BilinearResize2D",))
def bilinear_resize_2d(data, *, height, width):
    """Bilinear resize of NCHW to (height, width), corners aligned
    (reference contrib/bilinear_resize-inl.h), in the JAX op's gathers."""
    ih, iw = data.shape[2:]
    if ih == height and iw == width:
        return data
    dev = data.device
    ys = torch.linspace(0.0, ih - 1.0, height, device=dev)
    xs = torch.linspace(0.0, iw - 1.0, width, device=dev)
    y0 = torch.floor(ys).to(torch.int64)
    x0 = torch.floor(xs).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=ih - 1)
    x1 = torch.clamp(x0 + 1, max=iw - 1)
    wy = (ys - y0).to(data.dtype)
    wx = (xs - x0).to(data.dtype)
    top_rows = data[:, :, y0, :]
    bot_rows = data[:, :, y1, :]
    top = top_rows[:, :, :, x0] * (1 - wx) + top_rows[:, :, :, x1] * wx
    bot = bot_rows[:, :, :, x0] * (1 - wx) + bot_rows[:, :, :, x1] * wx
    return top * (1 - wy[:, None]) + bot * wy[:, None]


@register("_contrib_div_sqrt_dim", alias=("div_sqrt_dim",))
def div_sqrt_dim(data):
    """``data / √(last dimension)`` (reference contrib/transformer.cc:34)."""
    return data / torch.sqrt(torch.full((), data.shape[-1], dtype=data.dtype,
                                        device=data.device))


@register("Correlation")
def correlation(data1, data2, *, kernel_size=1, max_displacement=1, stride1=1, stride2=1,
                pad_size=0, is_multiply=True):
    """FlowNet correlation (reference src/operator/correlation-inl.h:53; the
    JAX op's shift-and-reduce): for each displacement of the stride2 grid,
    the mean over the kernel window and the channels of ``data1 ·
    shifted data2`` (``|data1 − shifted data2|`` without ``is_multiply``).
    The shift wraps around the padded map, as the JAX op's ``roll``."""
    h, w = data1.shape[2:]
    pad = pad_size
    d1 = torch.nn.functional.pad(data1, (pad, pad, pad, pad))
    d2 = torch.nn.functional.pad(data2, (pad, pad, pad, pad))
    kr = (kernel_size - 1) // 2
    border = max_displacement + kr
    ph, pw = h + 2 * pad, w + 2 * pad
    top_h = math.ceil((ph - border * 2) / stride1)
    top_w = math.ceil((pw - border * 2) / stride1)
    grid_r = max_displacement // stride2
    ys = border + stride1 * torch.arange(top_h, device=data1.device)
    xs = border + stride1 * torch.arange(top_w, device=data1.device)

    def window_mean(x):
        if kernel_size == 1:
            return x[:, :, ys, :][:, :, :, xs]
        acc = 0.0
        for ky in range(-kr, kr + 1):
            for kx in range(-kr, kr + 1):
                acc = acc + x[:, :, ys + ky, :][:, :, :, xs + kx]
        return acc / (kernel_size * kernel_size)

    maps = []
    for dy in range(-grid_r, grid_r + 1):
        for dx in range(-grid_r, grid_r + 1):
            shifted = torch.roll(d2, shifts=(-dy * stride2, -dx * stride2), dims=(2, 3))
            prod = d1 * shifted if is_multiply else torch.abs(d1 - shifted)
            maps.append(window_mean(prod).mean(dim=1))
    return torch.stack(maps, dim=1)


def _crop_inputs(attrs):
    return ["data", "crop_like"] if attrs.get("num_args", 1) == 2 else ["data"]


@register("Crop", inputs_fn=_crop_inputs)
def crop(data, crop_like=None, *, num_args=1, offset=(0, 0), h_w=(0, 0), center_crop=False):
    """A spatial crop of NCHW to ``h_w``, or to ``crop_like``'s (H, W) with
    two inputs, at ``offset`` or centred (reference src/operator/
    crop-inl.h:52)."""
    h, w = data.shape[2:]
    th, tw = (crop_like.shape[2], crop_like.shape[3]) if crop_like is not None else h_w
    oy, ox = ((h - th) // 2, (w - tw) // 2) if center_crop else offset
    return data[:, :, oy:oy + th, ox:ox + tw]
