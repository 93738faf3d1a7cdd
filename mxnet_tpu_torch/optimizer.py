"""Optimizers (counterpart of ``mxnet_tpu/optimizer.py``; reference
python/mxnet/optimizer.py).

The ``Optimizer`` base keeps the reference's hyperparameter logic on the
host: ``rescale_grad``, ``clip_gradient``, the learning-rate schedule by
update count, per-parameter multipliers (``set_lr_mult`` / ``set_wd_mult``,
the symbol's ``__lr_mult__`` / ``__wd_mult__``, and weight decay only on
names ending in ``_weight`` or ``_gamma``) and ``multi_precision`` (an fp32
master copy of each bf16 or fp16 weight, updated in its place and cast
back).  Each optimizer applies its JAX class's rule (the ``*_rule``
functions, in the JAX rules' order of operations) in place, one parameter
at a time; ``SGD.update_multi`` runs ``sgd_rule`` over a list of
parameters as multi-tensor ``torch._foreach_*`` operations (what
``Module.update`` runs).  A tensor divided by a number is divided by a 0-d
tensor of it (``_div``): PyTorch's CUDA division by a host scalar
multiplies by its reciprocal, which rounds twice.  Row-sparse gradients
wait for the sparse arrays (ROADMAP A14).
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "SGLD", "DCASGD", "Adam", "AdaGrad",
           "AdaDelta", "Adamax", "Nadam", "RMSProp", "Ftrl", "Ftml", "LBSGD", "Test",
           "Updater", "get_updater", "create", "register", "sgd_rule", "adam_rule"]

_OPT_REGISTRY = {}


def register(klass):
    """Register an Optimizer subclass under its lower-case name."""
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by (case-insensitive) name."""
    if name.lower() not in _OPT_REGISTRY:
        raise ValueError("Optimizer %s not registered (have %s)" % (name, sorted(_OPT_REGISTRY)))
    return _OPT_REGISTRY[name.lower()](**kwargs)


def _div(x, c):
    """``x / c`` for a tensor ``x`` and a number ``c``: one correctly rounded
    division on every device (a 0-d tensor divisor)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sgd_rule(w, g, mom, *, lr, wd, momentum=0.0):
    """One SGD step in the JAX rule's order of operations: ``g + wd·w``,
    then ``mom' = momentum·mom − lr·g`` and ``w + mom'`` (or ``w − lr·g``
    without momentum) -> (new weight, new momentum or None)."""
    g = g + wd * w
    if mom is None:
        return w - lr * g, None
    new_mom = momentum * mom - lr * g
    return w + new_mom, new_mom


def nag_rule(w, g, mom, *, lr, wd, momentum=0.0):
    """Nesterov momentum: ``mom' = momentum·mom + g``, ``w − lr·(g +
    momentum·mom')``."""
    g = g + wd * w
    new_mom = momentum * mom + g
    return w - lr * (g + momentum * new_mom), new_mom


def adam_rule(w, g, m, v, t, *, lr, wd, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """One Adam step at update count ``t`` in the JAX rule's order of
    operations: ``g + wd·w``, the two moments, then ``w − lr_t·m / (√v + ε)``
    with ``lr_t = lr·√(1 − β2ᵗ) / (1 − β1ᵗ)`` on the host -> (new weight,
    new m, new v)."""
    g = g + wd * w
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * torch.square(g)
    lr_t = lr * ((1.0 - beta2 ** t) ** 0.5) / (1.0 - beta1 ** t)
    return w - lr_t * m / (torch.sqrt(v) + epsilon), m, v


def rmsprop_rule(w, g, n, *, lr, wd, gamma1=0.9, epsilon=1e-8):
    g = g + wd * w
    n = (1 - gamma1) * torch.square(g) + gamma1 * n
    return w - lr * g / torch.sqrt(n + epsilon), n


def rmspropalex_rule(w, g, n, gavg, delta, *, lr, wd, gamma1=0.9, gamma2=0.9, epsilon=1e-8):
    """Centred RMSProp (Graves 2013)."""
    g = g + wd * w
    n = (1 - gamma1) * torch.square(g) + gamma1 * n
    gavg = (1 - gamma1) * g + gamma1 * gavg
    delta = gamma2 * delta - lr * g / torch.sqrt(n - torch.square(gavg) + epsilon)
    return w + delta, n, gavg, delta


def adagrad_rule(w, g, hist, *, lr, wd, epsilon=1e-7):
    g = g + wd * w
    hist = hist + torch.square(g)
    return w - lr * g / (torch.sqrt(hist) + epsilon), hist


def adadelta_rule(w, g, acc_g, acc_delta, *, lr, wd, rho=0.90, epsilon=1e-5):
    g = g + wd * w
    acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(acc_g + epsilon) * g
    acc_delta = rho * acc_delta + (1 - rho) * torch.square(delta)
    return w - delta, acc_g, acc_delta


def adamax_rule(w, g, m, u, t, *, lr, wd, beta1=0.9, beta2=0.999):
    g = g + wd * w
    m = beta1 * m + (1 - beta1) * g
    u = torch.maximum(beta2 * u, torch.abs(g))
    lr_t = lr / (1.0 - beta1 ** t)
    return w - lr_t * m / (u + 1e-8), m, u


def nadam_rule(w, g, m, v, t, *, lr, wd, beta1=0.9, beta2=0.999, epsilon=1e-8,
               schedule_decay=0.004):
    g = g + wd * w
    mom_t = beta1 * (1.0 - 0.5 * 0.96 ** (t * schedule_decay))
    mom_t1 = beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * schedule_decay))
    m = beta1 * m + (1 - beta1) * g
    v = beta2 * v + (1 - beta2) * torch.square(g)
    g_prime = _div(g, 1.0 - mom_t)
    m_prime = _div(m, 1.0 - beta1 ** (t + 1))
    v_prime = _div(v, 1.0 - beta2 ** t)
    m_bar = (1.0 - mom_t) * g_prime + mom_t1 * m_prime
    return w - lr * m_bar / (torch.sqrt(v_prime) + epsilon), m, v


def ftrl_rule(w, g, z, n, *, lr, wd, lamda1=0.01, beta=1.0):
    """FTRL-proximal; the weight decay enters through the proximal term."""
    new_n = n + torch.square(g)
    sigma = _div(torch.sqrt(new_n) - torch.sqrt(n), lr)
    z = z + g - sigma * w
    new_w = torch.where(torch.abs(z) > lamda1,
                        -(z - torch.sign(z) * lamda1) / (_div(beta + torch.sqrt(new_n), lr) + wd),
                        torch.zeros_like(w))
    return new_w, z, new_n


def signum_rule(w, g, mom, *, lr, wd, momentum=0.0, wd_lh=0.0):
    if mom is None:
        return (1 - lr * wd_lh) * w - lr * torch.sign(g + wd * w), None
    new_mom = momentum * mom - (1 - momentum) * (g + wd * w)
    return (1 - lr * wd_lh) * w + lr * torch.sign(new_mom), new_mom


def ftml_rule(w, g, d, v, z, t, *, lr, wd, beta1=0.6, beta2=0.999, epsilon=1e-8):
    g = g + wd * w
    v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(_div(v, 1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    z = beta1 * z + (1 - beta1) * g - sigma * w
    return -z / d_t, d_t, v, z


def _low_precision(t):
    return t.dtype in (torch.float16, torch.bfloat16)


def _dense(grad, name):
    if grad.layout != torch.strided:
        raise NotImplementedError("%s's row-sparse update waits for the sparse arrays "
                                  "(ROADMAP A14)" % name)


class Optimizer:
    """Base optimizer (reference optimizer.py:35): update counts, the
    learning rate and weight decay of each parameter index."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, sym=None, begin_num_update=0,
                 multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.param_dict = param_dict or {}
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = None
        if sym is not None:
            self.sym_info = (sym.attr_dict(), sym.list_arguments())

    def set_lr_mult(self, args_lr_mult):
        """Per-name learning-rate multipliers: the symbol's ``__lr_mult__``
        attributes, then ``args_lr_mult``."""
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Per-name weight-decay multipliers: 0 for every parameter whose
        name ends neither in ``_weight`` nor in ``_gamma`` (biases, betas),
        then the symbol's ``__wd_mult__`` attributes, then
        ``args_wd_mult``."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        self._index_update_count[index] = self._index_update_count.get(
            index, self.begin_num_update) + 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler is not None else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def create_state(self, index, weight):
        raise NotImplementedError

    def update(self, index, weight, grad, state):
        """Update ``weight`` (and ``state``) in place from ``grad``."""
        raise NotImplementedError

    def update_multi(self, indices, weights, grads, states):
        """``update_multi_precision`` over lists of parameters."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update_multi_precision(i, w, g, s)

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision`` and a bf16 or fp16 weight: (fp32 master
        copy, the optimizer's state of the master); else the state."""
        if self.multi_precision and _low_precision(weight):
            master = weight.detach().to(torch.float32)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    @torch.no_grad()
    def update_multi_precision(self, index, weight, grad, state):
        """``update``, on the fp32 master of a low-precision weight (with the
        gradient in fp32), the weight then the master's cast."""
        _dense(grad, type(self).__name__)
        if self.multi_precision and _low_precision(weight):
            master, base_state = state
            self.update(index, master, grad.to(torch.float32), base_state)
            weight.copy_(master.to(weight.dtype))
        else:
            self.update(index, weight, grad, state)

    def _preprocess(self, grad):
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g


@register
class SGD(Optimizer):
    """SGD with momentum (reference optimizer.py SGD, ``sgd_mom_update``)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_mom = sgd_rule(weight, self._preprocess(grad), state,
                                  lr=self._get_lr(index), wd=self._get_wd(index),
                                  momentum=self.momentum)
        weight.copy_(new_w)
        if state is not None:
            state.copy_(new_mom)

    @torch.no_grad()
    def update_multi(self, indices, weights, grads, states):
        """One momentum-SGD step over every parameter as multi-tensor
        operations, each in ``sgd_rule``'s order: the update counts first,
        then each parameter's learning rate and weight decay on the host.
        Every state must exist (momentum) or none (plain SGD).  A subclass
        (LBSGD) or a low-precision weight under ``multi_precision`` goes
        one parameter at a time."""
        if not weights:
            return
        if type(self) is not SGD or (self.multi_precision
                                     and any(_low_precision(w) for w in weights)):
            return super().update_multi(indices, weights, grads, states)
        for g in grads:
            _dense(g, "SGD")
        for i in indices:
            self._update_count(i)
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        g = torch._foreach_mul(grads, self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        torch._foreach_add_(g, torch._foreach_mul(weights, wds))
        torch._foreach_mul_(g, lrs)
        if states[0] is None:
            torch._foreach_sub_(weights, g)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, g)
        torch._foreach_add_(weights, states)


@register
class Adam(Optimizer):
    """Adam (reference optimizer.py Adam, ``adam_update``): ``adam_rule`` in
    place, one parameter at a time; the state is (m, v)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (torch.zeros_like(weight), torch.zeros_like(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        _dense(grad, "Adam")
        self._update_count(index)
        m, v = state
        new_w, new_m, new_v = adam_rule(
            weight, self._preprocess(grad), m, v, self._index_update_count[index],
            lr=self._get_lr(index), wd=self._get_wd(index), beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon)
        weight.copy_(new_w)
        m.copy_(new_m)
        v.copy_(new_v)


def _zeros(weight):
    return torch.zeros_like(weight)


def _write(pairs):
    """Copy each new value into its tensor: ``[(tensor, value), ...]``."""
    for dst, src in pairs:
        dst.copy_(src)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (``nag_rule``); the state is the momentum."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_mom = nag_rule(weight, self._preprocess(grad), state,
                                  lr=self._get_lr(index), wd=self._get_wd(index),
                                  momentum=self.momentum)
        _write([(weight, new_w), (state, new_mom)])


@register
class Signum(Optimizer):
    """Sign of the momentum (``signum_rule``; signSGD without momentum), with
    the decoupled weight decay ``wd_lh``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_mom = signum_rule(weight, self._preprocess(grad), state,
                                     lr=self._get_lr(index), wd=self._get_wd(index),
                                     momentum=self.momentum, wd_lh=self.wd_lh)
        weight.copy_(new_w)
        if state is not None:
            state.copy_(new_mom)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w − lr/2·(g + wd·w) +
    √lr·z``, z standard normal.  z comes from ``noise_source(index,
    weight)`` where given (a caller that holds the noise), else from
    ``mx.random``'s ``torch.Generator`` of the weight's device; the JAX
    class draws from its global key."""

    def __init__(self, noise_source=None, **kwargs):
        super().__init__(**kwargs)
        self.noise_source = noise_source

    def create_state(self, index, weight):
        return None

    def _noise(self, index, weight):
        if self.noise_source is not None:
            return self.noise_source(index, weight)
        from . import random as _random

        return torch.randn(weight.shape, dtype=weight.dtype, device=weight.device,
                           generator=_random.generator(weight.device))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad) + wd * weight
        noise = self._noise(index, weight) * math.sqrt(lr)
        weight.copy_(weight - lr / 2 * g + noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: the gradient plus ``λ·g²·(w − w_prev)``; the
    state is (momentum or None, the previous weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_zeros(weight) if self.momentum != 0.0 else None, weight.detach().clone())

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad)
        mom, prev = state
        comp = g + wd * weight + self.lamda * g * g * (weight - prev)
        if mom is not None:
            mom.copy_(self.momentum * mom - lr * comp)
            upd = mom
        else:
            upd = -lr * comp
        prev.copy_(weight)
        weight.add_(upd)


@register
class AdaGrad(Optimizer):
    """AdaGrad (``adagrad_rule``); the state is the sum of squares."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        new_w, new_h = adagrad_rule(weight, self._preprocess(grad), state,
                                    lr=self._get_lr(index), wd=self._get_wd(index),
                                    epsilon=self.float_stable_eps)
        _write([(weight, new_w), (state, new_h)])


@register
class AdaDelta(Optimizer):
    """AdaDelta (``adadelta_rule``); the state is the two running means."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        acc_g, acc_d = state
        new_w, ng, nd = adadelta_rule(weight, self._preprocess(grad), acc_g, acc_d,
                                      lr=self._get_lr(index), wd=self._get_wd(index),
                                      rho=self.rho, epsilon=self.epsilon)
        _write([(weight, new_w), (acc_g, ng), (acc_d, nd)])


@register
class Adamax(Optimizer):
    """Adamax (``adamax_rule``): Adam with the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        m, u = state
        new_w, nm, nu = adamax_rule(weight, self._preprocess(grad), m, u,
                                    self._index_update_count[index], lr=self._get_lr(index),
                                    wd=self._get_wd(index), beta1=self.beta1,
                                    beta2=self.beta2)
        _write([(weight, new_w), (m, nm), (u, nu)])


@register
class Nadam(Optimizer):
    """Nesterov Adam (``nadam_rule``) with the momentum schedule."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        m, v = state
        new_w, nm, nv = nadam_rule(weight, self._preprocess(grad), m, v,
                                   self._index_update_count[index], lr=self._get_lr(index),
                                   wd=self._get_wd(index), beta1=self.beta1,
                                   beta2=self.beta2, epsilon=self.epsilon,
                                   schedule_decay=self.schedule_decay)
        _write([(weight, new_w), (m, nm), (v, nv)])


@register
class RMSProp(Optimizer):
    """RMSProp (``rmsprop_rule``), or the centred form with ``centered``
    (``rmspropalex_rule``); ``clip_weights`` bounds the new weight."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9, epsilon=1e-8,
                 centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        g = self._preprocess(grad)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if self.centered:
            n, gavg, delta = state
            new_w, nn, ng, nd = rmspropalex_rule(weight, g, n, gavg, delta, lr=lr, wd=wd,
                                                 gamma1=self.gamma1, gamma2=self.gamma2,
                                                 epsilon=self.epsilon)
            _write([(n, nn), (gavg, ng), (delta, nd)])
        else:
            new_w, nn = rmsprop_rule(weight, g, state, lr=lr, wd=wd, gamma1=self.gamma1,
                                     epsilon=self.epsilon)
            state.copy_(nn)
        if self.clip_weights:
            c = self.clip_weights
            new_w = torch.minimum(torch.maximum(new_w, new_w.new_full((), -c)),
                                  new_w.new_full((), c))
        weight.copy_(new_w)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (``ftrl_rule``); the state is (z, n)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        new_w, nz, nn = ftrl_rule(weight, self._preprocess(grad), z, n,
                                  lr=self._get_lr(index), wd=self._get_wd(index),
                                  lamda1=self.lamda1, beta=self.beta)
        _write([(weight, new_w), (z, nz), (n, nn)])


@register
class Ftml(Optimizer):
    """Follow the moving leader (``ftml_rule``); the state is (d, v, z)."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        d, v, z = state
        new_w, nd, nv, nz = ftml_rule(weight, self._preprocess(grad), d, v, z,
                                      self._index_update_count[index],
                                      lr=self._get_lr(index), wd=self._get_wd(index),
                                      beta1=self.beta1, beta2=self.beta2,
                                      epsilon=self.epsilon)
        _write([(weight, new_w), (d, nd), (v, nv), (z, nz)])


@register
class LBSGD(SGD):
    """Large-batch SGD with the LARS layer-wise rate: ``sgd_rule`` at
    ``lr·η‖w‖ / (‖g‖ + wd‖w‖ + 1e-9)`` (1 where a norm is 0), a 0-d tensor
    on the device."""

    def __init__(self, momentum=0.0, eta=0.001, **kwargs):
        super().__init__(momentum=momentum, **kwargs)
        self.eta = eta

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = self._preprocess(grad)
        wnorm = torch.linalg.vector_norm(weight)
        gnorm = torch.linalg.vector_norm(g)
        lars = torch.where((wnorm > 0) & (gnorm > 0),
                           self.eta * wnorm / (gnorm + wd * wnorm + 1e-9),
                           torch.ones((), dtype=wnorm.dtype, device=wnorm.device))
        new_w, new_mom = sgd_rule(weight, g, state, lr=lr * lars, wd=wd,
                                  momentum=self.momentum)
        weight.copy_(new_w)
        if state is not None:
            state.copy_(new_mom)


@register
class Test(Optimizer):
    """``w − lr·g`` (the reference's unit-test optimizer); its state is
    unused."""

    def create_state(self, index, weight):
        return _zeros(weight)

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        weight.copy_(weight - self.lr * self._preprocess(grad))


def _to_numpy(state):
    """A state (a tensor, None, or a tuple of them, nested) as numpy."""
    if state is None or isinstance(state, np.ndarray):
        return state
    if isinstance(state, (tuple, list)):
        return tuple(_to_numpy(s) for s in state)
    t = state.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _from_numpy(state):
    """``_to_numpy``'s inverse on the host: numpy arrays and nested tuples."""
    if state is None or isinstance(state, np.ndarray):
        return state
    if isinstance(state, (tuple, list)):
        return tuple(_from_numpy(s) for s in state)
    return np.asarray(state)


def _has_numpy(state):
    if isinstance(state, tuple):
        return any(_has_numpy(s) for s in state)
    return isinstance(state, np.ndarray)


def _to_device(state, device):
    if state is None or isinstance(state, torch.Tensor):
        return state
    if isinstance(state, tuple):
        return tuple(_to_device(s, device) for s in state)
    return torch.as_tensor(state, device=device)


class Updater:
    """Applies an optimizer to indexed parameters, keeping their states
    (reference optimizer.py Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(index, weight)
        elif _has_numpy(self.states[index]):  # loaded by set_states
            self.states[index] = _to_device(self.states[index], weight.device)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(index, weight, grad, self._state(index, weight))

    def update_multi(self, indices, grads, weights):
        """``__call__`` over lists, in the optimizer's multi-tensor form."""
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(indices, weights, grads, states)

    def get_states(self, dump_optimizer=False):
        """The states pickled as {index: numpy array, None, or a tuple of
        them}, the JAX package's layout (with ``dump_optimizer``,
        ``(states, optimizer)``)."""
        states = {k: _to_numpy(v) for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer else states)

    def set_states(self, states_bytes):
        """Load ``get_states``' bytes (this package's, or the JAX package's
        saved without the optimizer); each state moves to its parameter's
        device at the parameter's next update."""
        data = pickle.loads(states_bytes)
        if isinstance(data, tuple):
            data, self.optimizer = data
        self.states = {k: _from_numpy(v) for k, v in data.items()}


def get_updater(optimizer):
    return Updater(optimizer)
