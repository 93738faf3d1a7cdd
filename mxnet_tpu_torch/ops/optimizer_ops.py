"""Optimizer update operators (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``;
reference src/operator/optimizer_op.cc: sgd_update, sgd_mom_update, the
mp_* variants, adam_update, ftml_update, rmsprop_update, rmspropalex_update,
ftrl_update, signsgd_update, signum_update).

The reference's kernels update the weight and state tensors in place.  As
in the JAX package each op here is a plain function returning
``(new weight, *new states)``, and the op's ``mutates`` names the inputs
that the extra outputs replace: ``mx.nd`` writes them back, so
``nd.adam_update(w, g, m, v, out=w, lr=...)`` acts as the reference's.
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = []


def _clip(g, bound):
    return g if bound is None or bound < 0 else torch.clamp(g, -bound, bound)


def _prep_grad(grad, rescale_grad, clip_gradient, wd, weight):
    """The SGD family: ``clip(rescale·grad) + wd·weight``."""
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


def _prep_grad_clip_after(grad, rescale_grad, clip_gradient, wd, weight):
    """The Adam and RMSProp family: ``clip(rescale·grad + wd·weight)``."""
    return _clip(grad * rescale_grad + wd * weight, clip_gradient)


@register("sgd_update")
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
               lazy_update=True):
    return weight - lr * _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)


@register("sgd_mom_update", mutates=("mom",))
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


@register("mp_sgd_update", mutates=("weight32",))
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """SGD on fp32 master weights, the low-precision weight their cast."""
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_w32 = weight32 - lr * g
    return new_w32.to(weight.dtype), new_w32


@register("mp_sgd_mom_update", mutates=("mom", "weight32"))
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad.float(), rescale_grad, clip_gradient, wd, weight32)
    new_mom = momentum * mom - lr * g
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


@register("adam_update", mutates=("mean", "var"))
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999, epsilon=1e-8,
                wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad_clip_after(grad, rescale_grad, clip_gradient, wd, weight)
    new_mean = beta1 * mean + (1.0 - beta1) * g
    new_var = beta2 * var + (1.0 - beta2) * g * g
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


@register("ftml_update", mutates=("d", "v", "z"))
def ftml_update(weight, grad, d, v, z, *, lr, t, beta1=0.6, beta2=0.999, epsilon=1e-8,
                wd=0.0, rescale_grad=1.0, clip_grad=-1.0):
    """FTML (Zheng & Kwok 2017)."""
    g = _clip(grad * rescale_grad + wd * weight, clip_grad)
    new_v = beta2 * v + (1.0 - beta2) * g * g
    d_t = (1.0 - beta1 ** t) / lr * (torch.sqrt(new_v / (1.0 - beta2 ** t)) + epsilon)
    sigma_t = d_t - beta1 * d
    new_z = beta1 * z + (1.0 - beta1) * g - sigma_t * weight
    return -new_z / d_t, d_t, new_v, new_z


def _clip_weights(w, bound):
    return torch.clamp(w, -bound, bound) if bound is not None and bound > 0 else w


@register("rmsprop_update", mutates=("n",))
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, clip_weights=-1.0):
    g = _prep_grad_clip_after(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1.0 - gamma1) * g * g + gamma1 * n
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(new_w, clip_weights), new_n


@register("rmspropalex_update", mutates=("n", "g", "delta"))
def rmspropalex_update(weight, grad, n, g, delta, *, lr, gamma1=0.95, gamma2=0.9,
                       epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    """RMSProp with momentum (Graves 2013)."""
    gr = _prep_grad_clip_after(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = (1.0 - gamma1) * gr * gr + gamma1 * n
    new_g = (1.0 - gamma1) * gr + gamma1 * g
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(new_n - new_g * new_g + epsilon)
    return _clip_weights(weight + new_delta, clip_weights), new_n, new_g, new_delta


@register("ftrl_update", mutates=("z", "n"))
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
                        -(new_z - torch.sign(new_z) * lamda1)
                        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


@register("signsgd_update")
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", mutates=("mom",))
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, wd_lh=0.0):
    """Signum: the sign of the momentum (Bernstein 2018)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1.0 - momentum) * (g + wd * weight)
    new_w = (1.0 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom
