"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``): the
convolutions, normalizations, pooling, activations, the softmax family, the
loss heads, upsampling, the spatial transformer and the sequence ops.  NCHW
throughout;
plain convolutions and dense layers go to ``torch.nn.functional`` and
``torch.matmul``, as the JAX package leaves them to XLA.

The functions registered here (``@register``) are also the symbolic
frontend's operators: their keyword-only parameters are the MXNet
attributes, and the ``_*_params`` rules give the parameter shapes.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["pair", "convolution", "deconvolution", "batch_norm", "layer_norm",
           "instance_norm", "lrn", "pooling", "adaptive_avg_pooling", "activation",
           "leaky_relu", "dropout", "softmax", "log_softmax", "softmin",
           "softmax_activation", "fully_connected", "softmax_output",
           "linear_regression_output", "mae_regression_output",
           "logistic_regression_output", "make_loss", "svm_output", "upsampling",
           "bilinear_sampler", "grid_generator", "spatial_transformer"]


def pair(v):
    """An int or a 1- or 2-sequence -> an (h, w) pair of ints."""
    if isinstance(v, (int, float)):
        return (int(v), int(v))
    v = tuple(int(x) for x in v)
    return v * 2 if len(v) == 1 else v


def _fc_inputs(attrs):
    return ["data", "weight"] if attrs.get("no_bias") else ["data", "weight", "bias"]


def _fc_params(attrs, shapes):
    nh = attrs["num_hidden"]
    data = shapes["data"]
    width = math.prod(data[1:]) if attrs.get("flatten", True) else data[-1]
    return {"weight": (nh, width), "bias": (nh,)}


def _conv_params(attrs, shapes):
    nf = attrs["num_filter"]
    return {"weight": (nf, shapes["data"][1]) + pair(attrs["kernel"]), "bias": (nf,)}


def _bn_params(attrs, shapes):
    c = shapes["data"][attrs.get("axis", 1) % len(shapes["data"])]
    return {"gamma": (c,), "beta": (c,), "moving_mean": (c,), "moving_var": (c,)}


def _bn_aux_update(attrs, outputs, aux_vals):
    """The moving statistics after a training forward (``mxnet_tpu/ops/nn.py
    _bn_aux_update``): ``moving = m·moving + (1 − m)·batch``, none under
    ``use_global_stats``.  ``outputs`` is ``(out, mean, var)``."""
    if attrs.get("use_global_stats"):
        return aux_vals
    _, mean, var = outputs
    m = attrs.get("momentum", 0.9)
    out = dict(aux_vals)
    if "moving_mean" in out:
        out["moving_mean"] = m * out["moving_mean"] + (1 - m) * mean
    if "moving_var" in out:
        out["moving_var"] = m * out["moving_var"] + (1 - m) * var
    return out


def _softmax_output_label_shape(attrs, shapes):
    d = shapes["data"]
    if attrs.get("multi_output"):
        return {"label": (d[0],) + tuple(d[2:])}
    return {"label": tuple(d[:-1])}


def _dtype(name):
    """A dtype attribute ("float32", "bfloat16") -> the torch dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


def _contraction_exit(out, bias, no_bias, accum_dtype, out_dtype, bshape):
    """The tail of a dense layer or convolution: the product widened to
    ``accum_dtype`` where a bias is added in it, the bias added, the sum
    narrowed to ``out_dtype``.  (Without a bias, widening and narrowing a
    bf16 product back gives the same bits, so neither runs.)"""
    if no_bias or bias is None:
        target = out_dtype or accum_dtype
        return out if target is None else out.to(_dtype(target))
    if accum_dtype is not None:
        out = out.to(_dtype(accum_dtype))
    out = out + bias.reshape(bshape)
    if out_dtype is not None:
        out = out.to(_dtype(out_dtype))
    return out


@register("FullyConnected", inputs_fn=_fc_inputs, infer_params=_fc_params)
def fully_connected(data, weight, bias=None, *, num_hidden, no_bias=False,
                    flatten=True, accum_dtype=None, out_dtype=None):
    """Dense layer (reference src/operator/nn/fully_connected.cc) on data
    flattened to 2-D, or with ``flatten=False`` on its last axis; weight
    (num_hidden, in_dim).

    ``accum_dtype`` / ``out_dtype`` are the precision tier's hooks
    (``graph_passes/precision.py``, as in ``mxnet_tpu/ops/nn.py``): the bf16
    pass sets ``accum_dtype="float32"`` on bf16 operands, whose product
    cuBLAS sums in fp32 (``context.full_fp32`` keeps its reduced-precision
    reduction off) and rounds once to bf16; the bias is then added in fp32
    and ``out_dtype="bfloat16"`` narrows the result.  The JAX op keeps the
    fp32 accumulator through the bias add (``preferred_element_type``): the
    two differ by that one rounding.  Unset, nothing changes."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    if weight.shape != (num_hidden, x.shape[-1]):
        raise ValueError("FullyConnected: weight %s does not match "
                         "num_hidden=%d and input width %d"
                         % (tuple(weight.shape), num_hidden, x.shape[-1]))
    return _contraction_exit(torch.matmul(x, weight.T), bias, no_bias,
                             accum_dtype, out_dtype, (-1,))


@register("Convolution", inputs_fn=_fc_inputs, infer_params=_conv_params)
def convolution(data, weight, bias=None, *, kernel, num_filter, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), no_bias=False, accum_dtype=None,
                out_dtype=None):
    """2-D convolution with stride, pad and dilation (reference
    src/operator/nn/convolution.cc; ``mxnet_tpu/ops/nn.py convolution``).
    weight (num_filter, C, kh, kw).  ``accum_dtype`` / ``out_dtype`` as in
    :func:`fully_connected`: cuDNN sums bf16 products in fp32 and rounds
    once to bf16, then the bias is added in ``accum_dtype``."""
    if tuple(weight.shape[2:]) != pair(kernel) or weight.shape[0] != num_filter:
        raise ValueError("Convolution: weight %s does not match kernel=%s, "
                         "num_filter=%d" % (tuple(weight.shape), kernel,
                                            num_filter))
    conv = functools.partial(F.conv2d, data, weight, stride=pair(stride),
                             padding=pair(pad), dilation=pair(dilate))
    if accum_dtype is None and out_dtype is None:
        return conv(None if no_bias else bias)
    return _contraction_exit(conv(None), bias, no_bias, accum_dtype, out_dtype,
                             (1, -1, 1, 1))


@register("BatchNorm", aux=("moving_mean", "moving_var"), infer_params=_bn_params,
          aux_update=_bn_aux_update)
def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, training=False):
    """Batch normalization over channel axis ``axis`` (reference
    src/operator/nn/batch_norm.cc; ``mxnet_tpu/ops/nn.py batch_norm``, in
    its operation order), on data of any rank.

    With ``training`` and not ``use_global_stats`` the statistics are the
    batch's, in fp32, in the JAX op's shifted one-pass form: with the
    running mean m0 as each channel's reference, ``d = x − m0``,
    ``var = max(E[d²] − E[d]², 0)`` and ``mean = E[d] + m0``, so that the
    cancellation grows with |batch mean − m0| and not with |mean| / std.
    The variance is the biased one.  Otherwise they are the running
    statistics.  ``scale = γ / √(var + eps)`` and ``shift = β − mean·γ /
    √(var + eps)`` are cast to the data's dtype, and ``out = data·scale +
    shift``.

    Returns ``out``, or ``(out, mean, var)`` with ``output_mean_var``;
    gradients flow through ``mean`` and ``var``.  The running statistics
    are not updated here: ``momentum`` is the caller's (the Gluon layer
    folds ``m·running + (1 − m)·batch`` in after the forward, the executor
    the op's ``aux_update``).

    The defaults are the op's own (``eps=1e-3``, ``fix_gamma=True``); the
    Gluon layer passes ``1e-5`` and ``fix_gamma = not scale``.
    """
    ax = axis % data.dim()
    red = tuple(i for i in range(data.dim()) if i != ax)
    bshape = [1] * data.dim()
    bshape[ax] = data.shape[ax]
    if use_global_stats or not training:
        mean, var = moving_mean, moving_var
    else:
        m0 = moving_mean.to(torch.float32)
        d = data.to(torch.float32) - m0.reshape(bshape)
        dmean = torch.mean(d, dim=red)
        dex2 = torch.mean(d * d, dim=red)
        # torch.maximum halves the gradient at a tie, as jnp.maximum does
        var = torch.maximum(dex2 - dmean * dmean, dex2.new_zeros(()))
        mean = dmean + m0
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.sqrt(var + eps)
    scale = (g / inv).to(data.dtype).reshape(bshape)
    shift = (beta - mean * g / inv).to(data.dtype).reshape(bshape)
    out = data * scale + shift
    return (out, mean, var) if output_mean_var else out


@register("Pooling")
def pooling(data, *, kernel=(1, 1), pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True):
    """Max or average pooling over NCHW (reference
    src/operator/nn/pooling.cc, pool.h; ``mxnet_tpu/ops/nn.py pooling``).

    ``stride`` defaults to 1 and ``pad`` to 0, as the op's.  The window is
    padded explicitly, as ``lax.reduce_window`` pads: with −inf (the dtype's
    least value for integers) for max and 0 for averages, on the right by the
    extra amount the ``full`` (ceil) convention needs.  An average divides
    the fp32 window sum by the window size or, without
    ``count_include_pad``, by the count of unpadded elements; an integer
    input is averaged in fp32 and cast back, as the reference does.
    """
    if pool_type not in ("max", "avg"):
        raise NotImplementedError("Pooling: pool_type %r is not ported" % pool_type)
    if global_pool:
        if pool_type == "max":
            return torch.amax(data, dim=(2, 3), keepdim=True)
        return torch.mean(data.to(torch.float32), dim=(2, 3),
                          keepdim=True).to(data.dtype)
    k = pair(kernel)
    s = pair(stride) if stride is not None else (1, 1)
    p = pair(pad) if pad is not None else (0, 0)
    hi = list(p)
    if pooling_convention == "full":
        for i in range(2):
            x = data.shape[2 + i]
            out_sz = math.ceil((x + 2 * p[i] - k[i]) / s[i]) + 1
            hi[i] = p[i] + max((out_sz - 1) * s[i] + k[i] - (x + 2 * p[i]), 0)
    widths = (p[1], hi[1], p[0], hi[0])
    if pool_type == "max":
        floating = data.dtype.is_floating_point
        lowest = -math.inf if floating else torch.iinfo(data.dtype).min
        x = F.pad(data, widths, value=lowest)
        if floating:
            return F.max_pool2d(x, k, stride=s)
        # max picks an input, so the fp32 detour is exact for 8/16-bit ints
        return F.max_pool2d(x.to(torch.float32), k, stride=s).to(data.dtype)
    x = F.pad(data.to(torch.float32), widths)
    summed = F.avg_pool2d(x, k, stride=s, divisor_override=1)
    if count_include_pad:
        out = summed / float(math.prod(k))
    else:
        ones = F.pad(torch.ones_like(data, dtype=torch.float32), widths)
        out = summed / F.avg_pool2d(ones, k, stride=s, divisor_override=1)
    return out.to(data.dtype)


@register("Activation")
def activation(data, *, act_type):
    """Activation (reference src/operator/nn/activation.cc): ``relu``,
    ``sigmoid``, ``tanh`` (the RNN cells' gates), ``softrelu`` (softplus)
    and ``softsign``.  ``relu``'s gradient at exactly 0 is 0, the
    reference's ``relu_grad``; the JAX op's ``jnp.maximum(x, 0)`` gives 1/2
    there (ROADMAP §C)."""
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return F.softplus(data)
    if act_type == "softsign":
        return F.softsign(data)
    raise ValueError("unknown act_type %r" % (act_type,))


@register("Dropout")
def dropout(data, *, p=0.5, axes=(), training=False, keep=None, generator=None):
    """Dropout (reference src/operator/nn/dropout.cc; ``mxnet_tpu/ops/nn.py
    dropout``): ``where(keep, data / (1 − p), 0)`` in training, ``data``
    otherwise or at ``p`` = 0.

    ``keep`` (bool, ``data``'s shape, or 1 along ``axes``) is the mask of
    kept elements; without it the mask is drawn as ``uniform < 1 − p`` from
    ``generator``, a ``torch.Generator`` on ``data``'s device, the JAX
    op's ``bernoulli(key, 1 − p)``.  The global random state is never used:
    with neither, training raises.  The scale is a tensor division, one
    rounding, as the JAX op's (CUDA's division by a host scalar multiplies
    by its reciprocal)."""
    if not training or p == 0.0:
        return data
    shape = list(data.shape)
    for ax in axes or ():
        shape[ax] = 1
    if keep is None:
        if generator is None:
            raise ValueError("Dropout in training needs a keep mask or a "
                             "torch.Generator; the global random state is not used")
        keep = torch.rand(shape, generator=generator, device=data.device) < 1.0 - p
    elif keep.dtype != torch.bool or list(keep.shape) != shape:
        raise ValueError("Dropout: keep must be bool %s, got %s %s"
                         % (tuple(shape), keep.dtype, tuple(keep.shape)))
    scale = torch.full((), 1.0 - p, dtype=data.dtype, device=data.device)
    return torch.where(keep, data / scale, torch.zeros((), dtype=data.dtype,
                                                       device=data.device))


@register("softmax")
def softmax(data, *, axis=-1, temperature=None, length=None):
    """Softmax along ``axis`` (reference src/operator/nn/softmax.cc;
    ``mxnet_tpu/ops/nn.py softmax``).  A ``temperature`` other than 1 divides
    the data first; ``length`` (masked softmax) is not ported.

    In bf16 or fp16 it takes ``jax.nn.softmax``'s steps, each rounded to
    the dtype as the JAX op rounds them: x − max, exp, a sum accumulated in
    fp32 and rounded, the division.  ``torch.softmax`` rounds once at the
    end, and its bf16 probabilities then differ from the JAX op's by an ulp
    in about a third of the entries: enough to reorder RPN scores that tie
    in bf16."""
    if length is not None:
        raise NotImplementedError("softmax: length= is not ported")
    if temperature not in (None, 1.0):
        data = data / torch.full((), temperature, dtype=data.dtype, device=data.device)
    if data.dtype not in (torch.bfloat16, torch.float16):
        return torch.softmax(data, dim=axis)
    e = torch.exp(data - data.amax(dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True, dtype=torch.float32).to(data.dtype)


def _tempered(data, temperature):
    """``data / temperature`` (a tensor division), ``data`` at 1 or None."""
    if temperature in (None, 1.0):
        return data
    return data / torch.full((), temperature, dtype=data.dtype, device=data.device)


@register("log_softmax")
def log_softmax(data, *, axis=-1, temperature=None):
    """Log-softmax along ``axis`` (``mxnet_tpu/ops/nn.py log_softmax``, which
    is ``jax.nn.log_softmax``: x − max − log Σ exp(x − max))."""
    return torch.log_softmax(_tempered(data, temperature), dim=axis)


@register("softmin")
def softmin(data, *, axis=-1, temperature=None):
    """``softmax(−data)`` (``mxnet_tpu/ops/nn.py softmin``)."""
    return softmax(-data, axis=axis, temperature=temperature)


@register("SoftmaxActivation")
def softmax_activation(data, *, mode="instance"):
    """The deprecated softmax activation (reference softmax_activation.cc):
    over axis 1 with ``mode="channel"``, else over each instance's
    flattened values."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """softmax(data) forward; backward the reference's fused cross-entropy
    gradient ``(p − onehot(label))·scale`` (``mxnet_tpu/ops/nn.py
    _softmax_output_bwd``), whatever cotangent arrives: a head given ones
    and one given other values get the same gradient.  The label gets a
    zero gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, multi_output, use_ignore,
                normalization, smooth_alpha):
        out = torch.softmax(data, dim=1 if multi_output else -1)
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, ignore_label, multi_output, use_ignore, normalization,
                     smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, multi_output, use_ignore, normalization, smooth_alpha = \
            ctx.attrs
        cls_axis = 1 if multi_output else out.dim() - 1
        n_cls = out.shape[cls_axis]
        classes = torch.arange(n_cls, device=out.device).reshape(
            [n_cls if i == cls_axis else 1 for i in range(out.dim())])
        # jax.nn.one_hot: a label outside [0, n_cls) (ignore_label -1) is all 0
        onehot = (label.to(torch.int64).unsqueeze(cls_axis) == classes).to(out.dtype)
        if smooth_alpha:
            onehot = onehot * (1.0 - smooth_alpha) + smooth_alpha / (n_cls - 1) * (1.0 - onehot)
        grad = out - onehot
        if use_ignore:
            keep = (label != ignore_label).to(out.dtype)
            grad = grad * keep.unsqueeze(cls_axis)
        if normalization == "valid" and use_ignore:
            valid = torch.clamp_min(torch.sum(label != ignore_label), 1).to(out.dtype)
            # a tensor division on the device, as the JAX op's
            scale = torch.full((), grad_scale, dtype=out.dtype, device=out.device) / valid
        elif normalization == "batch":
            scale = grad_scale / out.shape[0]
        else:
            scale = grad_scale
        d_label = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad * scale, d_label, None, None, None, None, None, None


@register("SoftmaxOutput", alias=("Softmax",), infer_params=_softmax_output_label_shape)
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0, multi_output=False,
                   use_ignore=False, preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """Softmax with the reference's fused cross-entropy gradient (reference
    src/operator/softmax_output.cc; ``mxnet_tpu/ops/nn.py softmax_output``).

    Forward: softmax over the last axis, or over axis 1 with
    ``multi_output`` (label (N, d2, ...) then).  Backward:
    ``(p − onehot(label))·scale`` with ``smooth_alpha`` label smoothing,
    rows whose label is ``ignore_label`` zeroed under ``use_ignore``, and
    ``scale`` = ``grad_scale``, ``grad_scale / batch`` (``normalization=
    "batch"``) or ``grad_scale / max(valid labels, 1)`` (``"valid"`` with
    ``use_ignore``).  The incoming cotangent is not read.
    ``preserve_shape`` and ``out_grad`` are accepted and, as in the JAX op,
    ignored."""
    if not torch.is_grad_enabled() or not data.requires_grad:
        return torch.softmax(data, dim=1 if multi_output else -1)
    return _SoftmaxOutput.apply(data, label, grad_scale, ignore_label, multi_output,
                                use_ignore, normalization, smooth_alpha)


# -- sequence ops (``mxnet_tpu/ops/nn.py``: reference sequence_mask.cc,
# sequence_last.cc, sequence_reverse.cc); data is (seq, batch, ...) for axis 0

@register("SequenceMask")
def sequence_mask(data, sequence_length=None, *, use_sequence_length=False, value=0.0,
                  axis=0):
    """``value`` at the positions past each sequence's length; ``data`` as
    it is without ``use_sequence_length``."""
    if not use_sequence_length or sequence_length is None:
        return data
    pos = torch.arange(data.shape[axis], device=data.device)
    lengths = sequence_length.to(torch.int32)
    mask = pos[:, None] < lengths[None, :] if axis == 0 else pos[None, :] < lengths[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                              device=data.device))


@register("SequenceLast")
def sequence_last(data, sequence_length=None, *, use_sequence_length=False, axis=0):
    """Each sequence's last valid step (the last step without
    ``use_sequence_length``)."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, data.shape[axis] - 1)
    idx = sequence_length.to(torch.int64) - 1
    shape = list(data.shape)
    shape[axis] = 1
    view = (1, -1) if axis == 0 else (-1, 1)
    idx = idx.reshape(view + (1,) * (data.dim() - 2)).expand(shape)
    return torch.gather(data, axis, idx).squeeze(axis)


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, *, use_sequence_length=False, axis=0):
    """Each sequence reversed up to its length (the positions past it stay);
    the whole axis without ``use_sequence_length``.  With lengths the time
    axis is 0, as in the JAX op."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    lengths = sequence_length.to(torch.int64)[None, :]
    rev = torch.where(pos < lengths, lengths - 1 - pos, pos)
    rev = rev.reshape(rev.shape + (1,) * (data.dim() - 2)).expand(data.shape)
    return torch.gather(data, 0, rev)


# -- transposed convolution, the normalizations, LRN, adaptive pooling -----------

def _deconv_params(attrs, shapes):
    g = attrs.get("num_group", 1)
    nf = attrs["num_filter"]
    return {"weight": (shapes["data"][1], nf // g) + pair(attrs["kernel"]), "bias": (nf,)}


def _deconv_inputs(attrs):
    # Deconvolution's no_bias defaults to True (reference deconvolution-inl.h)
    return ["data", "weight"] if attrs.get("no_bias", True) else ["data", "weight", "bias"]


@register("Deconvolution", inputs_fn=_deconv_inputs, infer_params=_deconv_params)
def deconvolution(data, weight, bias=None, *, kernel, num_filter, stride=None, dilate=None,
                  pad=None, adj=None, target_shape=None, num_group=1, no_bias=True):
    """Transposed 2-D convolution (reference src/operator/nn/deconvolution.cc;
    ``mxnet_tpu/ops/nn.py deconvolution``): weight (C_in, num_filter /
    num_group, kh, kw), the output (H − 1)·stride − 2·pad + dilated kernel
    + adj, ``adj`` added on the bottom and right.

    ``target_shape`` (h, w), where given and not (0, 0), sets pad and adj
    as the reference's ``InferPad`` does: the surplus of the natural size
    over the target, halved (rounded up) for pad, its parity for adj.  The
    JAX op takes the attribute and ignores it."""
    k = pair(kernel)
    s = pair(stride) if stride is not None else (1, 1)
    d = pair(dilate) if dilate is not None else (1, 1)
    p = pair(pad) if pad is not None else (0, 0)
    a = pair(adj) if adj is not None else (0, 0)
    if target_shape is not None and any(int(t) for t in target_shape):
        p, a = [], []
        for i, t in enumerate(pair(target_shape)):
            surplus = s[i] * (data.shape[2 + i] - 1) + (k[i] - 1) * d[i] + 1 - t
            if surplus < 0:
                raise ValueError("Deconvolution: target_shape %s is larger than the "
                                 "output can be" % (tuple(target_shape),))
            p.append((surplus + 1) // 2)
            a.append(surplus % 2)
    if tuple(weight.shape[2:]) != k or weight.shape[1] * num_group != num_filter:
        raise ValueError("Deconvolution: weight %s does not match kernel=%s, num_filter=%d, "
                         "num_group=%d" % (tuple(weight.shape), kernel, num_filter, num_group))
    return F.conv_transpose2d(data, weight, None if no_bias else bias, stride=s,
                              padding=tuple(p), output_padding=tuple(a), groups=num_group,
                              dilation=d)


def _ln_params(attrs, shapes):
    c = shapes["data"][attrs.get("axis", -1) % len(shapes["data"])]
    return {"gamma": (c,), "beta": (c,)}


@register("LayerNorm", infer_params=_ln_params)
def layer_norm(data, gamma, beta, *, axis=-1, eps=1e-5, output_mean_var=False):
    """Layer normalization over ``axis`` (reference src/operator/nn/
    layer_norm.cc; ``mxnet_tpu/ops/nn.py layer_norm``): the statistics in
    fp32, the normalized value cast back to the data's dtype before the
    affine.  With ``output_mean_var``: (out, mean, var), ``axis`` dropped."""
    ax = axis % data.dim()
    x32 = data.to(torch.float32)
    mean = x32.mean(dim=ax, keepdim=True)
    var = torch.var(x32, dim=ax, unbiased=False, keepdim=True)
    norm = ((x32 - mean) / torch.sqrt(var + eps)).to(data.dtype)
    bshape = [data.shape[ax] if i == ax else 1 for i in range(data.dim())]
    out = norm * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return out, mean.squeeze(ax), var.squeeze(ax)
    return out


@register("InstanceNorm", infer_params=lambda attrs, shapes: {"gamma": (shapes["data"][1],),
                                                              "beta": (shapes["data"][1],)})
def instance_norm(data, gamma, beta, *, eps=1e-3):
    """Instance normalization over each channel's spatial values (reference
    src/operator/instance_norm.cc), biased variance."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = torch.var(data, dim=red, unbiased=False, keepdim=True)
    bshape = (1, data.shape[1]) + (1,) * (data.dim() - 2)
    return (data - mean) / torch.sqrt(var + eps) * gamma.reshape(bshape) + beta.reshape(bshape)


@register("LRN")
def lrn(data, *, nsize, alpha=1e-4, beta=0.75, knorm=2.0):
    """Local response normalization across channels (reference
    src/operator/nn/lrn.cc; ``mxnet_tpu/ops/nn.py lrn``): the sum of x² over
    a window of ``nsize`` channels centred on each, zero-padded at the
    ends, and ``x / (knorm + alpha·Σ / nsize)^beta``.
    ``F.local_response_norm`` pads its window by another rule
    (nsize // 2 before, (nsize − 1) // 2 after), so it is not used."""
    half = nsize // 2
    padded = F.pad(data * data, (0, 0, 0, 0, half, half))
    c = data.shape[1]
    window = padded[:, 0:c]
    for i in range(1, nsize):
        window = window + padded[:, i:i + c]
    return data / torch.pow(knorm + alpha * window / nsize, beta)


@register("_contrib_AdaptiveAvgPooling2D")
def adaptive_avg_pooling(data, *, output_size=(1, 1)):
    """Adaptive average pooling (reference src/operator/contrib/
    adaptive_avg_pooling.cc): bin i of n over a length L spans
    [floor(i·L / n), ceil((i + 1)·L / n)), the JAX op's bins."""
    return F.adaptive_avg_pool2d(data, pair(output_size))


# -- LeakyReLU's activations --------------------------------------------------------

@register("LeakyReLU",
          inputs_fn=lambda attrs: ["data", "gamma"] if attrs.get("act_type") == "prelu"
          else ["data"],
          infer_params=lambda attrs, shapes: {"gamma": (shapes["data"][1],)})
def leaky_relu(data, gamma=None, *, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334, training=False, generator=None):
    """leaky, prelu (``gamma`` per channel), elu, selu, gelu (erf) and rrelu
    (reference src/operator/leaky_relu.cc; ``mxnet_tpu/ops/nn.py
    leaky_relu``).  rrelu's negative slope is drawn U(lower, upper) per
    element in training, from ``generator`` (a ``torch.Generator`` on the
    data's device; the JAX op draws from its ``key``), and is the mean of
    the bounds otherwise."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    if act_type == "leaky":
        return torch.where(data >= zero, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.dim() == 1 and g.dim() < data.dim():
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data >= zero, data, g * data)
    if act_type == "elu":
        return torch.where(data >= zero, data, slope * (torch.exp(data) - 1.0))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= zero, data, alpha * (torch.exp(data) - 1.0))
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "rrelu":
        if not training:
            return torch.where(data >= zero, data, (lower_bound + upper_bound) / 2.0 * data)
        if generator is None:
            raise ValueError("LeakyReLU rrelu in training needs a torch.Generator; the "
                             "global random state is not used")
        r = torch.empty_like(data).uniform_(lower_bound, upper_bound, generator=generator)
        return torch.where(data >= zero, data, r * data)
    raise ValueError("unknown act_type %r" % (act_type,))


# -- output heads whose backward is their own rule -----------------------------------

class _OwnGradient(torch.autograd.Function):
    """``forward_fn(data)`` forward; backward ``grad_fn(out, data, label)``,
    whatever cotangent arrives (the reference's loss heads), the label a
    zero gradient."""

    @staticmethod
    def forward(ctx, data, label, forward_fn, grad_fn):
        out = forward_fn(data)
        ctx.save_for_backward(out, data, label)
        ctx.grad_fn = grad_fn
        return out

    @staticmethod
    def backward(ctx, g):
        out, data, label = ctx.saved_tensors
        d_label = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return ctx.grad_fn(out, data, label), d_label, None, None


def _own_gradient(data, label, forward_fn, grad_fn):
    if not torch.is_grad_enabled() or not data.requires_grad:
        return forward_fn(data)
    if label is None:
        label = torch.zeros((), dtype=data.dtype, device=data.device)
    return _OwnGradient.apply(data, label, forward_fn, grad_fn)


def _same_as_data(attrs, shapes):
    return {"label": tuple(shapes["data"])}


def _regression(data, label, grad_scale, kind):
    """The regression outputs (reference src/operator/regression_output.cc):
    identity (sigmoid for ``logistic``) forward; backward ``(out − label)``
    (its sign for ``mae``) times ``grad_scale``."""

    def grad_fn(out, _, lbl):
        diff = out - lbl.reshape(out.shape)
        return (torch.sign(diff) if kind == "mae" else diff) * grad_scale

    fwd = torch.sigmoid if kind == "logistic" else (lambda x: x)
    return _own_gradient(data, label, fwd, grad_fn)


@register("LinearRegressionOutput", infer_params=_same_as_data)
def linear_regression_output(data, label, *, grad_scale=1.0):
    """Identity forward, ``(out − label)·grad_scale`` backward."""
    return _regression(data, label, grad_scale, "linear")


@register("MAERegressionOutput", infer_params=_same_as_data)
def mae_regression_output(data, label, *, grad_scale=1.0):
    """Identity forward, ``sign(out − label)·grad_scale`` backward."""
    return _regression(data, label, grad_scale, "mae")


@register("LogisticRegressionOutput", infer_params=_same_as_data)
def logistic_regression_output(data, label, *, grad_scale=1.0):
    """Sigmoid forward, ``(out − label)·grad_scale`` backward."""
    return _regression(data, label, grad_scale, "logistic")


@register("MakeLoss", alias=("make_loss",))
def make_loss(data, *, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """A tensor as a loss head (reference src/operator/make_loss.cc): identity
    forward; backward ``grad_scale`` everywhere, divided by the batch with
    ``normalization="batch"`` and by the element count with ``"valid"``
    (the JAX op's rule, which reads no ``valid_thresh``)."""
    scale = grad_scale
    if normalization == "batch":
        scale = grad_scale / data.shape[0]
    elif normalization == "valid":
        scale = grad_scale / max(math.prod(data.shape), 1)
    return _own_gradient(data, None, lambda x: x,
                         lambda out, _, __: torch.full_like(out, scale))


@register("SVMOutput")
def svm_output(data, label, *, margin=1.0, regularization_coefficient=1.0, use_linear=False):
    """SVM output (reference src/operator/svm_output.cc): identity forward;
    backward the one-vs-rest hinge of the reference's L1_SVM / L2_SVM
    kernels (``mxnet_tpu/ops/nn.py svm_output``), c the regularization
    coefficient: the true class −c·[m > s] (L1) or −2c·(m − s)·[m > s]
    (L2), every other class +c·[m > −s] or +2c·(m + s)·[m > −s]."""
    margin, reg = float(margin), float(regularization_coefficient)

    def grad_fn(_, d, lbl):
        n, c = d.shape
        is_true = torch.arange(c, device=d.device)[None, :] == \
            lbl.reshape(n).to(torch.int32)[:, None]
        s = d.to(torch.float32)
        zero = s.new_zeros(())
        if use_linear:
            grad = torch.where(is_true, -reg * (margin > s).to(torch.float32),
                               reg * (margin > -s).to(torch.float32))
        else:
            grad = torch.where(is_true,
                               torch.where(margin > s, -2.0 * reg * (margin - s), zero),
                               torch.where(margin > -s, 2.0 * reg * (margin + s), zero))
        return grad.to(d.dtype)

    return _own_gradient(data, label, lambda x: x, grad_fn)


# -- upsampling and the spatial transformer ------------------------------------------

@register("UpSampling")
def upsampling(*args, scale, sample_type="nearest", num_args=1, num_filter=0,
               multi_input_mode="concat"):
    """Upsampling by an integer ``scale`` (reference src/operator/
    upsampling.cc).  ``nearest`` repeats each pixel; further inputs are
    brought to the first's output size and concatenated on the channels
    (``multi_input_mode="concat"``; the reference's ``"sum"`` is not
    ported, and the JAX op concatenates in either mode).  ``bilinear`` is
    the reference's grouped Deconvolution of the first input by the second
    (the weight, (C, 1, 2s − s % 2, 2s − s % 2))."""
    data = args[0]
    if sample_type == "nearest":
        if multi_input_mode != "concat" and len(args) > 1:
            raise NotImplementedError("UpSampling: multi_input_mode=%r is not ported"
                                      % (multi_input_mode,))

        def up(x, s):
            return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)

        outs = [up(data, scale)]
        for extra in args[1:]:
            outs.append(up(extra, data.shape[2] * scale // extra.shape[2]))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if sample_type == "bilinear":
        k = 2 * scale - scale % 2
        return deconvolution(data, args[1], None, kernel=(k, k), num_filter=data.shape[1],
                             stride=(scale, scale), pad=(math.ceil((scale - 1) / 2.0),) * 2,
                             num_group=data.shape[1], no_bias=True)
    raise ValueError("UpSampling: unknown sample_type %r" % (sample_type,))


def _sample_bilinear(data, gx, gy):
    """``data`` (N, C, H, W) sampled at pixel coordinates ``gx``, ``gy`` (N,
    ...) by the JAX op's gather: the four neighbours, each of weight 0 where
    it lies outside the image."""
    n, c, h, w = data.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    flat = data.reshape(n, c, h * w)

    def sample(xi, yi):
        xc = torch.clamp(xi, 0, w - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, h - 1).to(torch.int64)
        valid = ((xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)).to(data.dtype)
        idx = (yc * w + xc).reshape(n, 1, -1).expand(n, c, -1)
        vals = torch.gather(flat, 2, idx).reshape((n, c) + tuple(gx.shape[1:]))
        return vals * valid[:, None]

    v00 = sample(x0, y0)
    v01 = sample(x0 + 1, y0)
    v10 = sample(x0, y0 + 1)
    v11 = sample(x0 + 1, y0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) + v10 * (1 - wx) * wy
            + v11 * wx * wy)


@register("BilinearSampler")
def bilinear_sampler(data, grid):
    """Bilinear sampling of ``data`` (N, C, H, W) at ``grid`` (N, 2, Ho, Wo),
    x then y in [−1, 1] (reference src/operator/bilinear_sampler.cc;
    ``mxnet_tpu/ops/nn.py bilinear_sampler``): pixel ``(g + 1)·(W − 1) / 2``,
    the neighbours outside the image weighing 0.  ``F.grid_sample``'s
    corner and padding rules differ at the border, so it is not used."""
    h, w = data.shape[2:]
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    return _sample_bilinear(data, gx, gy)


@register("GridGenerator")
def grid_generator(data, *, transform_type, target_shape=(0, 0)):
    """Sampling grids (reference src/operator/grid_generator.cc): ``affine``
    maps the target's normalized (x, y, 1) by each (2, 3) matrix of
    ``data`` (N, 6); ``warp`` adds the flow ``data`` (N, 2, H, W) to the
    pixel grid and normalizes to [−1, 1]."""
    if transform_type == "affine":
        n = data.shape[0]
        h, w = pair(target_shape)
        theta = data.reshape(n, 2, 3)
        ys = torch.linspace(-1.0, 1.0, h, dtype=data.dtype, device=data.device)
        xs = torch.linspace(-1.0, 1.0, w, dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        coords = torch.stack([gx, gy, torch.ones_like(gx)], dim=0).reshape(3, -1)
        return torch.matmul(theta, coords).reshape(n, 2, h, w)
    if transform_type == "warp":
        h, w = data.shape[2:]
        gy, gx = torch.meshgrid(torch.arange(h, dtype=data.dtype, device=data.device),
                                torch.arange(w, dtype=data.dtype, device=data.device),
                                indexing="ij")
        x = (data[:, 0] + gx) * 2.0 / max(w - 1, 1) - 1.0
        y = (data[:, 1] + gy) * 2.0 / max(h - 1, 1) - 1.0
        return torch.stack([x, y], dim=1)
    raise ValueError("GridGenerator: unknown transform_type %r" % (transform_type,))


@register("SpatialTransformer")
def spatial_transformer(data, loc, *, target_shape, transform_type="affine",
                        sampler_type="bilinear"):
    """A spatial transformer (reference src/operator/spatial_transformer.cc):
    ``GridGenerator(loc)`` at ``target_shape``, then ``BilinearSampler``."""
    if sampler_type != "bilinear":
        raise ValueError("SpatialTransformer: unknown sampler_type %r" % (sampler_type,))
    grid = grid_generator(loc, transform_type=transform_type, target_shape=target_shape)
    return bilinear_sampler(data, grid)
