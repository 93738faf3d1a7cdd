"""Optimizers (counterpart of ``mxnet_tpu/optimizer.py``; reference
python/mxnet/optimizer.py).

The ``Optimizer`` base keeps the reference's hyperparameter logic on the
host: ``rescale_grad``, ``clip_gradient``, the learning-rate schedule by
update count, and per-parameter multipliers (``set_lr_mult`` /
``set_wd_mult``, the symbol's ``__lr_mult__`` / ``__wd_mult__``, and weight
decay only on names ending in ``_weight`` or ``_gamma``).  ``SGD`` applies
``sgd_rule`` in place, one parameter at a time (``update``, the ``Updater``
path) or over a list of parameters as multi-tensor ``torch._foreach_*``
operations (``update_multi``, what ``Module.update`` runs), with the same
arithmetic.  The other optimizers of the reference are ROADMAP A11.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create", "register", "sgd_rule"]

_OPT_REGISTRY = {}
# the JAX package's other optimizers, not ported yet
_NOT_PORTED = ("nag", "signum", "sgld", "adam", "adagrad", "adadelta", "adamax", "nadam",
               "rmsprop", "ftrl", "ftml", "dcasgd", "lbsgd")


def register(klass):
    """Register an Optimizer subclass under its lower-case name."""
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    """An optimizer by (case-insensitive) name."""
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError("optimizer %r is not ported (ROADMAP A11); ported: %s"
                                  % (name, sorted(_OPT_REGISTRY)))
    if key not in _OPT_REGISTRY:
        raise ValueError("Optimizer %s not registered (have %s)" % (name, sorted(_OPT_REGISTRY)))
    return _OPT_REGISTRY[key](**kwargs)


def sgd_rule(w, g, mom, *, lr, wd, momentum=0.0):
    """One SGD step in the JAX rule's order of operations: ``g + wd·w``,
    then ``mom' = momentum·mom − lr·g`` and ``w + mom'`` (or ``w − lr·g``
    without momentum) -> (new weight, new momentum or None)."""
    g = g + wd * w
    if mom is None:
        return w - lr * g, None
    new_mom = momentum * mom - lr * g
    return w + new_mom, new_mom


class Optimizer:
    """Base optimizer (reference optimizer.py:35): update counts, the
    learning rate and weight decay of each parameter index."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, lr_scheduler=None, sym=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.num_update = 0
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
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
        self._index_update_count[index] = self._index_update_count.get(index, 0) + 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler is not None else self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
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
        """``update`` over lists of parameters."""
        for i, w, g, s in zip(indices, weights, grads, states):
            self.update(i, w, g, s)

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
        Every state must exist (momentum) or none (plain SGD)."""
        if not weights:
            return
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


class Updater:
    """Applies an optimizer to indexed parameters, keeping their states
    (reference optimizer.py Updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def _state(self, index, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        elif isinstance(self.states[index], np.ndarray):  # loaded by set_states
            self.states[index] = torch.as_tensor(self.states[index], device=weight.device)
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update(index, weight, grad, self._state(index, weight))

    def update_multi(self, indices, grads, weights):
        """``__call__`` over lists, in the optimizer's multi-tensor form."""
        states = [self._state(i, w) for i, w in zip(indices, weights)]
        self.optimizer.update_multi(indices, weights, grads, states)

    def get_states(self, dump_optimizer=False):
        """The states pickled as {index: numpy array or None}, the JAX
        package's layout (with ``dump_optimizer``, ``(states, optimizer)``)."""
        states = {k: v if v is None or isinstance(v, np.ndarray) else v.detach().cpu().numpy()
                  for k, v in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer else states)

    def set_states(self, states_bytes):
        """Load ``get_states``' bytes (this package's, or the JAX package's
        saved without the optimizer); each state moves to its parameter's
        device at the parameter's next update."""
        data = pickle.loads(states_bytes)
        if isinstance(data, tuple):
            data, self.optimizer = data
        self.states = {k: None if v is None else np.asarray(v) for k, v in data.items()}


def get_updater(optimizer):
    return Updater(optimizer)
