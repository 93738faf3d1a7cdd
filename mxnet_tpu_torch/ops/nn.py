"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``): those
of the Deformable R-FCN and Faster R-CNN paths, of the ResNet symbol and of
the Gluon ResNet.  NCHW throughout;
plain convolutions and dense layers go to ``torch.nn.functional`` and
``torch.matmul``, as the JAX package leaves them to XLA.

The functions registered here (``@register``) are also the symbolic
frontend's operators: their keyword-only parameters are the MXNet
attributes, and the ``_*_params`` rules give the parameter shapes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register

__all__ = ["pair", "convolution", "batch_norm", "pooling", "activation",
           "dropout", "softmax", "log_softmax", "fully_connected", "softmax_output"]


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


@register("FullyConnected", inputs_fn=_fc_inputs, infer_params=_fc_params)
def fully_connected(data, weight, bias=None, *, num_hidden, no_bias=False,
                    flatten=True):
    """Dense layer (reference src/operator/nn/fully_connected.cc) on data
    flattened to 2-D, or with ``flatten=False`` on its last axis; weight
    (num_hidden, in_dim)."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    if weight.shape != (num_hidden, x.shape[-1]):
        raise ValueError("FullyConnected: weight %s does not match "
                         "num_hidden=%d and input width %d"
                         % (tuple(weight.shape), num_hidden, x.shape[-1]))
    out = torch.matmul(x, weight.T)
    if not no_bias and bias is not None:
        out = out + bias
    return out


@register("Convolution", inputs_fn=_fc_inputs, infer_params=_conv_params)
def convolution(data, weight, bias=None, *, kernel, num_filter, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), no_bias=False):
    """2-D convolution with stride, pad and dilation (reference
    src/operator/nn/convolution.cc; ``mxnet_tpu/ops/nn.py convolution``).
    weight (num_filter, C, kh, kw)."""
    if tuple(weight.shape[2:]) != pair(kernel) or weight.shape[0] != num_filter:
        raise ValueError("Convolution: weight %s does not match kernel=%s, "
                         "num_filter=%d" % (tuple(weight.shape), kernel,
                                            num_filter))
    b = None if no_bias else bias
    return F.conv2d(data, weight, b, stride=pair(stride), padding=pair(pad),
                    dilation=pair(dilate))


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
    """Activation (reference src/operator/nn/activation.cc); the ported
    paths use ReLU only."""
    if act_type != "relu":
        raise NotImplementedError("Activation: only act_type='relu' is ported, "
                                  "got %r" % act_type)
    return torch.relu(data)


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


def softmax(data, *, axis=-1):
    """Softmax along ``axis`` (reference src/operator/nn/softmax.cc).

    In bf16 or fp16 it takes ``jax.nn.softmax``'s steps, each rounded to
    the dtype as the JAX op rounds them: x − max, exp, a sum accumulated in
    fp32 and rounded, the division.  ``torch.softmax`` rounds once at the
    end, and its bf16 probabilities then differ from the JAX op's by an ulp
    in about a third of the entries: enough to reorder RPN scores that tie
    in bf16."""
    if data.dtype not in (torch.bfloat16, torch.float16):
        return torch.softmax(data, dim=axis)
    e = torch.exp(data - data.amax(dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True, dtype=torch.float32).to(data.dtype)


def log_softmax(data, *, axis=-1):
    """Log-softmax along ``axis`` (``mxnet_tpu/ops/nn.py log_softmax``, which
    is ``jax.nn.log_softmax``: x − max − log Σ exp(x − max))."""
    return torch.log_softmax(data, dim=axis)


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


@register("SoftmaxOutput", infer_params=_softmax_output_label_shape)
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
