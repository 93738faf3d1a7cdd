"""Neural-network operators of the Deformable R-FCN path (counterpart of
``mxnet_tpu/ops/nn.py``).  NCHW throughout; plain convolutions go to
``torch.nn.functional.conv2d``, as the JAX package leaves them to XLA."""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pair", "convolution", "batch_norm", "pooling", "activation",
           "softmax", "log_softmax"]


def pair(v):
    """An int or a 1- or 2-sequence -> an (h, w) pair of ints."""
    if isinstance(v, (int, float)):
        return (int(v), int(v))
    v = tuple(int(x) for x in v)
    return v * 2 if len(v) == 1 else v


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


def batch_norm(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               fix_gamma=True):
    """Batch normalization over channel axis 1 with the running statistics
    (reference src/operator/nn/batch_norm.cc, ``use_global_stats``): the
    inference branch of ``mxnet_tpu/ops/nn.py batch_norm``, in its
    operation order.

    The defaults are the op's own (``eps=1e-3``, ``fix_gamma=True``); the
    Gluon layer passes ``1e-5`` and ``False``.
    """
    bshape = [1] * data.dim()
    bshape[1] = data.shape[1]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.sqrt(moving_var + eps)
    scale = (g / inv).to(data.dtype).reshape(bshape)
    shift = (beta - moving_mean * g / inv).to(data.dtype).reshape(bshape)
    return data * scale + shift


def pooling(data, *, kernel, stride=None, pad=(0, 0)):
    """Max pooling, ``valid`` convention (floor division; reference
    src/operator/nn/pooling.cc, ``pool_type="max"``).  Padding never wins a
    max, as in ``lax.reduce_window`` with a -inf init."""
    k = pair(kernel)
    return F.max_pool2d(data, k, stride=pair(stride) if stride else k,
                        padding=pair(pad), ceil_mode=False)


def activation(data, *, act_type):
    """Activation (reference src/operator/nn/activation.cc); the path
    uses ReLU only."""
    if act_type != "relu":
        raise NotImplementedError("Activation: only act_type='relu' is ported, "
                                  "got %r" % act_type)
    return torch.relu(data)


def softmax(data, *, axis=-1):
    """Softmax along ``axis`` (reference src/operator/nn/softmax.cc)."""
    return torch.softmax(data, dim=axis)


def log_softmax(data, *, axis=-1):
    """Log-softmax along ``axis`` (``mxnet_tpu/ops/nn.py log_softmax``, which
    is ``jax.nn.log_softmax``: x − max − log Σ exp(x − max))."""
    return torch.log_softmax(data, dim=axis)
