"""Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``; reference
python/mxnet/gluon/trainer.py:27): applies an optimizer of the port's
``optimizer.py`` to a set of Parameters.

``step(batch_size)`` rescales the gradients by 1 / batch_size (a loss
head's ``backward`` sums over the batch) and updates every parameter that
takes a gradient, as multi-tensor operations where the optimizer has them
(``SGD.update_multi``).  One process, one card: ``kvstore`` may be None,
"device" or "local", and ``allreduce_grads`` has nothing to reduce; the
distributed kvstores are ROADMAP A10.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch

from .. import optimizer as opt_mod
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]

_LOCAL_KVSTORES = (None, "device", "local")


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None, kvstore="device",
                 compression_params=None, update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of Parameters")
        if kvstore not in _LOCAL_KVSTORES:
            raise NotImplementedError(
                "Trainer: kvstore %r is not ported (distributed kvstores are ROADMAP A10); "
                "use None, 'device' or 'local'" % (kvstore,))
        if compression_params:
            raise NotImplementedError("Trainer: gradient compression is ROADMAP A10")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of Parameters, "
                                 "got %s" % type(param))
            self._params.append(param)
        self._scale = 1.0
        self._init_optimizer(optimizer, optimizer_params or {})
        self._states = [None] * len(self._params)
        self._states_init = [False] * len(self._params)

    def _init_optimizer(self, optimizer, optimizer_params):
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer is an "
                                 "Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.set_lr_mult({i: p.lr_mult for i, p in enumerate(self._params)})
        self._optimizer.set_wd_mult({i: p.wd_mult for i, p in enumerate(self._params)})

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    @property
    def optimizer(self):
        return self._optimizer

    def allreduce_grads(self):
        """Sum the gradients across workers: one worker, nothing to do."""

    def step(self, batch_size, ignore_stale_grad=False):
        """``allreduce_grads`` and ``update`` (reference trainer.py:217)."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter that takes a gradient,
        the gradients scaled by 1 / batch_size."""
        self._optimizer.rescale_grad = 1.0 / batch_size
        idx, weights, grads, states = [], [], [], []
        for i, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if p._var is None:
                if not ignore_stale_grad:
                    raise UserWarning("Parameter %s is not initialized" % p.name)
                continue
            w = p.data()._data
            if not self._states_init[i]:
                self._states[i] = self._optimizer.create_state(i, w)
                self._states_init[i] = True
            elif isinstance(self._states[i], np.ndarray):  # from load_states
                self._states[i] = torch.as_tensor(self._states[i], device=w.device)
            idx.append(i)
            weights.append(w)
            grads.append(p.grad()._data)
            states.append(self._states[i])
        if not idx:
            return
        mixed = len({s is None for s in states}) > 1
        if mixed:
            for i, w, g, s in zip(idx, weights, grads, states):
                self._optimizer.update(i, w, g, s)
        else:
            self._optimizer.update_multi(idx, weights, grads, states)

    def save_states(self, fname):
        """Pickle the optimizer and its states (numpy) to ``fname``
        (reference trainer.py:339)."""
        states = [None if s is None else s if isinstance(s, np.ndarray)
                  else s.detach().cpu().numpy() for s in self._states]
        with open(fname, "wb") as f:
            pickle.dump({"optimizer": self._optimizer, "states": states,
                         "init": list(self._states_init)}, f)

    def load_states(self, fname):
        """Restore ``save_states``' file; each state moves to its
        parameter's device at the next update."""
        with open(fname, "rb") as f:
            blob = pickle.load(f)
        self._optimizer = blob["optimizer"]
        self._states = list(blob["states"])
        self._states_init = list(blob["init"])
