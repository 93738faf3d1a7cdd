"""INT8 quantization operators (counterpart of ``mxnet_tpu/ops/quantization.py``;
reference ``src/operator/quantization/``: quantize-inl.h, dequantize-inl.h,
requantize-inl.h, quantized_conv.cc, quantized_fully_connected.cc,
quantized_pooling.cc, quantized_flatten-inl.h, quantization_utils.h).

Ranges travel as (1,) float32 tensors beside the values, as the reference's
min / max companion outputs do, and stay on the device: nothing here copies
a value to the host.  The int8 branches of ``quantize`` and ``dequantize``
are the port's CUDA kernels (``kernels.quantize_int8`` /
``kernels.dequantize_int8``).  The integer products accumulate exactly in
int32, as the JAX ops do with ``conv_general_dilated`` / ``dot_general`` on
int32: an im2col of the int8 input and ``torch._int_mm`` (int8 in, int32
out; the int8 tensor cores on the card), with zero padding up to the
shapes ``_int_mm`` takes.  Integer sums are exact in any order, so the
accumulators equal the JAX package's bit for bit.

Every float32 scale is computed in the JAX op's operation order, and every
division as one IEEE division of two tensors (``kernels._fdiv``), so that
the scales round as the reference's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels
from .kernels import _fdiv
from .nn import _conv_params, _fc_params, pair, pooling
from .registry import alias, register

__all__ = ["quantize", "dequantize", "requantize", "quantized_conv",
           "quantized_fully_connected", "quantized_pooling",
           "quantized_flatten", "quantized_act"]

INT32_MAX = float(2**31 - 1)
INT32_MIN = float(-(2**31 - 1))


def _scalar(r):
    """A range input, 0-d or (1,) -> 0-d float32."""
    return r.reshape(()).to(torch.float32)


def _maxabs(a, b):
    return torch.maximum(torch.abs(a), torch.abs(b))


def _symmetric_int8(x, real):
    """sign(x)·min(|x|·127/real + 0.5, 127) cast to int8 (requantize's
    inline form of the quantize formula; NaN gives 0 as in the kernel)."""
    scale = _fdiv(127.0, real)
    q = torch.sign(x) * torch.clamp(torch.abs(x) * scale + 0.5, max=127.0)
    return torch.where(q == q, q, 0.0).to(torch.int8)


@register("_contrib_quantize")
def quantize(data, min_range, max_range, *, out_type="uint8"):
    """float32 -> quantized (reference quantize-inl.h:53-80).

    uint8: affine over [min_range, max_range]; int8: symmetric over
    [-maxabs, maxabs], through the ``quantize_int8`` kernel on the card.
    Returns (q, min_out, max_out)."""
    mn = _scalar(min_range)
    mx = _scalar(max_range)
    if out_type == "uint8":
        scale = _fdiv(255.0, mx - mn)
        q = torch.clamp((data - mn) * scale + 0.5, 0.0, 255.0).to(torch.uint8)
        return q, mn.reshape(1), mx.reshape(1)
    if out_type != "int8":
        raise ValueError("unsupported quantized type %r" % (out_type,))
    real_range = _maxabs(mn, mx)
    q = kernels.quantize_int8(data.contiguous(), real_range)
    return q, (-real_range).reshape(1), real_range.reshape(1)


@register("_contrib_dequantize")
def dequantize(data, min_range, max_range, *, out_type="float32"):
    """quantized -> float32 (reference dequantize-inl.h): uint8 affine,
    int32 accumulators over ±INT32_MAX, int8 through the
    ``dequantize_int8`` kernel on the card."""
    mn = _scalar(min_range)
    mx = _scalar(max_range)
    if data.dtype == torch.uint8:
        return data.to(torch.float32) * _fdiv(mx - mn, 255.0) + mn
    real = _maxabs(mn, mx)
    if data.dtype == torch.int32:
        return data.to(torch.float32) * _fdiv(real, INT32_MAX)
    if data.dtype == torch.int8:
        return kernels.dequantize_int8(data.contiguous(), real)
    return data.to(torch.float32) * _fdiv(real, 127.0)


@register("_contrib_requantize")
def requantize(data, min_range, max_range, *, min_calib_range=None,
               max_calib_range=None):
    """int32 -> int8 (reference requantize-inl.h).  Without calibrated
    ranges the max-abs of the tensor itself is used (the reference's runtime
    path); it stays on the device."""
    real_in = _maxabs(_scalar(min_range), _scalar(max_range))
    fval = data.to(torch.float32) * _fdiv(real_in, INT32_MAX)
    if min_calib_range is not None and max_calib_range is not None:
        real_out = torch.full((), max(abs(float(min_calib_range)),
                                      abs(float(max_calib_range))),
                              dtype=torch.float32, device=data.device)
    else:
        real_out = torch.amax(torch.abs(fval))
    q = _symmetric_int8(fval, real_out)
    return q, (-real_out).reshape(1), real_out.reshape(1)


def _float_for_one(min_r, max_r, dtype):
    """Float value of one quantized level: (max − min)/255 for uint8
    (affine, zero point min), maxabs/127 for int8 (reference
    quantization_utils.h)."""
    mn = _scalar(min_r)
    mx = _scalar(max_r)
    if dtype == torch.uint8:
        return _fdiv(mx - mn, 255.0)
    return _fdiv(_maxabs(mn, mx), 127.0)


def _range_for_mul(a_one, b_one):
    """Range of the int32 accumulator (reference quantization_utils.h
    QuantizationRangeForMultiplication)."""
    one = (a_one * b_one).to(torch.float32)
    return (one * INT32_MIN).reshape(1), (one * INT32_MAX).reshape(1)


def _int_matmul(a, w):
    """Exact int32 product ``a @ wᵀ`` of int8 matrices through
    ``torch._int_mm``.

    ``a`` holds the (M, K) left operand in row-major order under any shape
    (an im2col view is copied straight into the operand); w is (O, K).
    ``_int_mm`` takes M > 16 and K, O multiples of 8, so M, K and O are
    padded with zero rows and columns, which add nothing to any sum.
    Returns (M, O) int32.
    """
    O, K = w.shape
    M = a.numel() // K if K else 0
    Mp, Kp, Op = max(M, 17), -(-K // 8) * 8, -(-O // 8) * 8
    if (Mp, Kp) == (M, K):
        # row-major: a reshape of a permuted view can be column-major, which
        # cuBLAS's int8 product refuses
        lhs = a.reshape(M, K).contiguous()
    else:
        lhs = torch.zeros((Mp, Kp), dtype=torch.int8, device=a.device)
        lhs[:M, :K].view(a.shape).copy_(a)
    rhs = w if (Op, Kp) == (O, K) else F.pad(w, (0, Kp - K, 0, Op - O))
    return torch._int_mm(lhs, rhs.t())[:M, :O]


def _int_conv(x, w, stride, pad, dilate):
    """Exact int32 convolution of int8 x (N, C, H, W) with int8 w
    (O, C, kh, kw), zero padding, NCHW out: the windows are strided views of
    the padded input (no copy) gathered into the im2col operand of
    :func:`_int_matmul` in channels-then-taps order, which is w's."""
    N = x.shape[0]
    O, C, kh, kw = w.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    xp = F.pad(x, (pw, pw, ph, ph))
    win = xp.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    win = win[..., ::dh, ::dw].permute(0, 2, 3, 1, 4, 5)  # (N, OH, OW, C, kh, kw)
    OH, OW = win.shape[1], win.shape[2]
    out = _int_matmul(win, w.reshape(O, C * kh * kw))
    return out.reshape(N, OH, OW, O).permute(0, 3, 1, 2).contiguous()


def _qconv_inputs(attrs):
    # the bias triple trails, so that no_bias drops only trailing inputs
    base = ["data", "weight", "min_data", "max_data", "min_weight", "max_weight"]
    if not attrs.get("no_bias"):
        base += ["bias", "min_bias", "max_bias"]
    return base


def _q_minmax_shapes(attrs):
    names = ["min_data", "max_data", "min_weight", "max_weight"]
    if not attrs.get("no_bias"):
        names += ["min_bias", "max_bias"]
    return {n: (1,) for n in names}


def _qconv_params(attrs, shapes):
    out = _conv_params(attrs, shapes)
    out.update(_q_minmax_shapes(attrs))
    return out


def _qfc_params(attrs, shapes):
    out = _fc_params(attrs, shapes)
    out.update(_q_minmax_shapes(attrs))
    return out


def _check_int8_weight(name, weight):
    if weight.dtype != torch.int8:
        raise NotImplementedError("%s: only int8 weights are ported (offline "
                                  "quantization gives int8), got %s"
                                  % (name, weight.dtype))


def _add_bias(out, acc_one, bias, min_bias, max_bias, shape):
    """Rescale the int8 bias into the accumulator's level and add it."""
    bias_one = _fdiv(_maxabs(_scalar(min_bias), _scalar(max_bias)), 127.0)
    bias32 = torch.round(bias.to(torch.float32) * _fdiv(bias_one, acc_one))
    return out + bias32.to(torch.int32).reshape(shape)


@register("_contrib_quantized_conv",
          inputs_fn=_qconv_inputs, infer_params=_qconv_params)
def quantized_conv(data, weight, min_data=None, max_data=None, min_weight=None,
                   max_weight=None, bias=None, min_bias=None, max_bias=None, *,
                   kernel, num_filter, stride=None, pad=None, dilate=None,
                   no_bias=False):
    """int8 (or uint8) convolution with an exact int32 accumulator
    (reference quantized_conv.cc).  Returns (int32 out, min_out, max_out).

    uint8 data is affine with zero point min_data, except in the padding,
    which is exactly 0: the correction is the window sum of the weight at
    each position, z·conv(1, w).  On the int8 product, uint8 data enters as
    q − 128 and the 128·conv(1, w) is added back."""
    _check_int8_weight("quantized_conv", weight)
    if tuple(weight.shape[2:]) != pair(kernel) or weight.shape[0] != num_filter:
        raise ValueError("quantized_conv: weight %s does not match kernel=%s, "
                         "num_filter=%d" % (tuple(weight.shape), kernel, num_filter))
    geom = (pair(stride) if stride is not None else (1, 1),
            pair(pad) if pad is not None else (0, 0),
            pair(dilate) if dilate is not None else (1, 1))
    a_one = _float_for_one(min_data, max_data, data.dtype)
    w_one = _float_for_one(min_weight, max_weight, weight.dtype)
    if data.dtype == torch.uint8:
        win_w = _int_conv(torch.ones_like(data, dtype=torch.int8), weight, *geom)
        shifted = (data.to(torch.int16) - 128).to(torch.int8)
        out = _int_conv(shifted, weight, *geom) + 128 * win_w
        z = torch.round(_fdiv(_scalar(min_data), a_one)).to(torch.int32)
        out = out + z * win_w
    else:
        out = _int_conv(data, weight, *geom)
    acc_one = (a_one * w_one).to(torch.float32)
    mn, mx = _range_for_mul(a_one, w_one)
    if bias is not None and not no_bias:
        out = _add_bias(out, acc_one, bias, min_bias, max_bias, (1, -1, 1, 1))
    return out, mn, mx


@register("_contrib_quantized_fully_connected", inputs_fn=_qconv_inputs,
          infer_params=_qfc_params)
def quantized_fully_connected(data, weight, min_data=None, max_data=None,
                              min_weight=None, max_weight=None, bias=None,
                              min_bias=None, max_bias=None, *, num_hidden,
                              no_bias=False):
    """int8 (or uint8) dense layer on data flattened to 2-D, with an exact
    int32 accumulator (reference quantized_fully_connected.cc).  Returns
    (int32 out, min_out, max_out)."""
    _check_int8_weight("quantized_fully_connected", weight)
    x = data.reshape(data.shape[0], -1)
    if weight.shape != (num_hidden, x.shape[1]):
        raise ValueError("quantized_fully_connected: weight %s does not match "
                         "num_hidden=%d and input width %d"
                         % (tuple(weight.shape), num_hidden, x.shape[1]))
    a_one = _float_for_one(min_data, max_data, data.dtype)
    w_one = _float_for_one(min_weight, max_weight, weight.dtype)
    if data.dtype == torch.uint8:
        wsum = weight.to(torch.int32).sum(1, dtype=torch.int32)
        shifted = (x.to(torch.int16) - 128).to(torch.int8)
        out = _int_matmul(shifted, weight) + 128 * wsum
        z = torch.round(_fdiv(_scalar(min_data), a_one)).to(torch.int32)
        out = out + z * wsum
    else:
        out = _int_matmul(x, weight)
    acc_one = (a_one * w_one).to(torch.float32)
    mn, mx = _range_for_mul(a_one, w_one)
    if bias is not None and not no_bias:
        out = _add_bias(out, acc_one, bias, min_bias, max_bias, (-1,))
    return out, mn, mx


@register("_contrib_quantized_pooling")
def quantized_pooling(data, min_data, max_data, *, kernel=(1, 1), pool_type="max",
                      stride=None, pad=None, global_pool=False,
                      pooling_convention="valid", count_include_pad=True):
    """Pooling on quantized data; the range passes through (reference
    quantized_pooling.cc).  max and avg are linear in the quantized encoding,
    so the float operator applies as it is."""
    out = pooling(data, kernel=kernel, pool_type=pool_type,
                  global_pool=global_pool, stride=stride, pad=pad,
                  pooling_convention=pooling_convention,
                  count_include_pad=count_include_pad)
    return out, min_data, max_data


@register("_contrib_quantized_flatten")
def quantized_flatten(data, min_data, max_data):
    """Flatten on quantized data (reference quantized_flatten-inl.h)."""
    return data.reshape(data.shape[0], -1), min_data, max_data


@register("_contrib_quantized_act")
def quantized_act(data, min_data, max_data, *, act_type="relu"):
    """ReLU on symmetric int8 keeps the range (zero stays zero); other
    activations, and ReLU on affine uint8, need the float domain."""
    if act_type != "relu":
        raise ValueError("only relu supported in the quantized domain")
    if data.dtype == torch.uint8:
        raise ValueError("relu on affine uint8 needs the zero point; compute in float")
    return torch.clamp(data, min=0), min_data, max_data

# the JAX registry's short names of the int8 ops
alias("_contrib_quantize", "quantize")
alias("_contrib_dequantize", "dequantize")
alias("_contrib_requantize", "requantize")
for _name in ("conv", "fully_connected", "pooling", "flatten", "act"):
    alias("_contrib_quantized_" + _name, "quantized_" + _name)
del _name
