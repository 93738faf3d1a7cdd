"""Miscellaneous operators (counterpart of ``mxnet_tpu/ops/misc_ops.py``):
internal helpers the frontends emit, the image tensor ops (reference
src/operator/image/image_random.cc), the sparse-flavoured ops in their dense
form, ``IdentityAttachKLSparseReg`` (reference
src/operator/identity_attach_KL_sparse_reg-inl.h), and the v1 / cuDNN
aliases of the modern ops."""
from __future__ import annotations

import math

import torch

from .matrix import _apply_slices
from .optimizer_ops import _prep_grad
from .reduce import norm_axis
from .registry import alias, register

__all__ = ["reshape_like", "copyto"]

# the reference's pre-NNVM copies of the ops (convolution_v1.cc, ...), the
# gradient-accumulating add and the sparse-capable embedding: the same ops
alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")
alias("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm")
alias("elemwise_add", "_grad_add")
alias("Embedding", "_contrib_SparseEmbedding")


@register("reshape_like")
def reshape_like(lhs, rhs):
    """``lhs`` in ``rhs``'s shape (reference elemwise_unary_op_basic.cc)."""
    return lhs.reshape(rhs.shape)


@register("_copyto", alias=("copyto",))
def copyto(data):
    """A copy of ``data`` (the nd frontend's ``ctx=`` moves it)."""
    return data.clone()


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    """``clip(alpha·x + beta, 0, 1)`` (reference elemwise_unary_op_basic.cc),
    by ``minimum(maximum(·))`` for ``jnp.clip``'s tie gradient."""
    y = alpha * data + beta
    return torch.minimum(torch.maximum(y, y.new_zeros(())), y.new_ones(()))


@register("_identity_with_attr_like_rhs")
def identity_with_attr_like_rhs(lhs, rhs):
    """``lhs`` (the reference carries ``rhs``'s storage type; dense here)."""
    return lhs.clone()


def _shape_strides(shape):
    strides, acc = [], 1
    for s in reversed(shape):
        strides.append(acc)
        acc *= s
    return strides[::-1]


@register("_ravel_multi_index", alias=("ravel_multi_index",))
def ravel_multi_index(data, *, shape):
    """(ndim, n) indices -> (n,) flat indices into ``shape``, each clipped
    to its axis (reference src/operator/tensor/ravel.cc)."""
    shape = tuple(int(s) for s in shape)
    out = torch.zeros(data.shape[1:], dtype=torch.int64, device=data.device)
    for i, (s, st) in enumerate(zip(shape, _shape_strides(shape))):
        out = out + torch.clamp(data[i].to(torch.int64), 0, s - 1) * st
    return out.to(data.dtype)


@register("_unravel_index", alias=("unravel_index",))
def unravel_index(data, *, shape):
    """(n,) flat indices -> (ndim, n) indices into ``shape`` (reference
    src/operator/tensor/ravel.cc)."""
    shape = tuple(int(s) for s in shape)
    flat = data.to(torch.int64)
    rows = [torch.div(flat, st, rounding_mode="floor") % s
            for s, st in zip(shape, _shape_strides(shape))]
    return torch.stack(rows).to(data.dtype)


@register("_square_sum", alias=("square_sum",))
def square_sum(data, *, axis=None, keepdims=False, exclude=False):
    """Σ x² over ``axis`` (reference square_sum-inl.h)."""
    dims = norm_axis(data.dim(), axis, exclude)
    return torch.sum(data * data, dim=dims, keepdim=keepdims)


@register("_scatter_plus_scalar")
def scatter_plus_scalar(data, *, scalar=1.0):
    """``data + scalar`` (the reference keeps a sparse operand's storage)."""
    return data + scalar


@register("_scatter_minus_scalar")
def scatter_minus_scalar(data, *, scalar=1.0):
    """``data − scalar`` (the reference keeps a sparse operand's storage)."""
    return data - scalar


def _assign_slices(ndim, begin, end, step):
    begin = tuple(begin) + (None,) * (ndim - len(begin))
    end = tuple(end) + (None,) * (ndim - len(end))
    step = tuple(step or ()) + (None,) * (ndim - len(tuple(step or ())))
    return [slice(b, e, s if s != 0 else None) for b, e, s in zip(begin, end, step)]


def _slice_positions(shape, begin, end, step, device):
    """The flat positions of the elements of ``shape`` that the slices
    select, in the slices' order (a negative step too), and their shape."""
    idx = torch.arange(math.prod(shape), device=device).reshape(shape)
    sel = _apply_slices(idx, _assign_slices(len(shape), begin, end, step))
    return sel.reshape(-1), sel.shape


@register("_slice_assign", alias=("slice_assign",))
def slice_assign(lhs, rhs, *, begin, end, step=()):
    """``lhs`` with ``lhs[begin:end:step] = rhs`` (reference matrix_op
    _slice_assign, behind NDArray.__setitem__); a new tensor, gradients to
    both."""
    pos, shape = _slice_positions(lhs.shape, begin, end, step, lhs.device)
    values = rhs.to(lhs.dtype).expand(shape).reshape(-1)
    return lhs.reshape(-1).index_copy(0, pos, values).reshape(lhs.shape)


@register("_slice_assign_scalar", alias=("slice_assign_scalar",))
def slice_assign_scalar(data, *, begin, end, scalar=0.0, step=()):
    """``data`` with ``data[begin:end:step] = scalar``."""
    pos, _ = _slice_positions(data.shape, begin, end, step, data.device)
    return data.reshape(-1).index_fill(0, pos, scalar).reshape(data.shape)


@register("_image_to_tensor", alias=("image_to_tensor",))
def image_to_tensor(data):
    """HWC (or NHWC) values in [0, 255] -> CHW (NCHW) float32 in [0, 1]
    (reference src/operator/image/image_random.cc:41)."""
    x = data.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if data.dim() == 3 else x.permute(0, 3, 1, 2)


@register("_image_normalize", alias=("image_normalize",))
def image_normalize(data, *, mean=(0.0,), std=(1.0,)):
    """``(x − mean) / std`` per channel of CHW (NCHW) (reference
    src/operator/image/image_random.cc:51)."""
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    m = torch.as_tensor(mean, dtype=data.dtype, device=data.device).reshape(shape)
    s = torch.as_tensor(std, dtype=data.dtype, device=data.device).reshape(shape)
    return (data - m) / s


@register("_sparse_adagrad_update", mutates=("history",))
def sparse_adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad on dense arrays (reference optimizer_op.cc:651), as the JAX
    op: ``g = clip(rescale·grad) + wd·w``, ``h' = h + g²``, ``w − lr·g /
    (√h' + ε)`` -> (new weight, new history).  A row-sparse gradient waits
    for the sparse arrays (ROADMAP A14)."""
    if grad.layout != torch.strided:
        raise NotImplementedError("_sparse_adagrad_update of a row-sparse gradient waits "
                                  "for the sparse arrays (ROADMAP A14)")
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_hist = history + g * g
    return weight - lr * g / (torch.sqrt(new_hist) + epsilon), new_hist


class _KLSparseReg(torch.autograd.Function):
    """Identity forward; backward adds ``penalty·(−ρ/ρ̂ + (1 − ρ)/(1 − ρ̂))``,
    ρ̂ clipped to [1e-6, 1 − 1e-6]."""

    @staticmethod
    def forward(ctx, data, rho_hat, rho, penalty):
        ctx.save_for_backward(rho_hat)
        ctx.rho, ctx.penalty = rho, penalty
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        (rh,) = ctx.saved_tensors
        rh = torch.minimum(torch.maximum(rh, rh.new_full((), 1e-6)), rh.new_full((), 1 - 1e-6))
        reg = ctx.penalty * (-ctx.rho / rh + (1 - ctx.rho) / (1 - rh))
        return g + reg.expand(g.shape), None, None, None


def _kl_sparse_aux_update(attrs, outputs, aux):
    """``moving_avg`` after a training forward: ``m·avg + (1 − m)·mean of the
    output over the batch`` (reference identity_attach_KL_sparse_reg-inl.h:108)."""
    if "moving_avg" not in aux:
        return {}
    m = attrs.get("momentum", 0.9)
    out = outputs[0] if isinstance(outputs, (tuple, list)) else outputs
    return {"moving_avg": m * aux["moving_avg"] + (1 - m) * out.mean(dim=0)}


@register("IdentityAttachKLSparseReg", aux=("moving_avg",),
          inputs_fn=lambda attrs: ["data", "moving_avg"],
          infer_params=lambda attrs, shapes: {"moving_avg": (shapes["data"][1],)},
          aux_update=_kl_sparse_aux_update)
def identity_attach_kl_sparse_reg(data, moving_avg=None, *, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    """Identity forward; backward adds the KL sparseness penalty's gradient
    at the moving average of the activations (the batch mean without one;
    reference identity_attach_KL_sparse_reg-inl.h:65-111)."""
    rho_hat = moving_avg if moving_avg is not None else data.mean(dim=0)
    if not torch.is_grad_enabled() or not data.requires_grad:
        return data
    return _KLSparseReg.apply(data, rho_hat.detach(), sparseness_target, penalty)
