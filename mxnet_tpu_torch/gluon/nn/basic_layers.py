"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``).
``in_units`` / ``in_channels`` 0 defers the shapes to the first forward,
as Gluon does; given, the tensors are made at once on ``device`` (None:
the current context, which is CUDA unless ``with mx.cpu():``; without a
card it raises)."""
from __future__ import annotations

import torch

from ... import random as _random
from ...context import as_device
from ...ops import nn as ops_nn
from ..block import HybridBlock, HybridSequential, imperative_active

__all__ = ["BatchNorm", "Dense", "Dropout", "Flatten", "HybridSequential"]


class Dense(HybridBlock):
    """Fully-connected layer ``x·Wᵀ + b``, weight (units, in_units)
    (reference basic_layers.py:123).  With ``flatten`` (the default) the
    input is flattened to (batch, -1) first, else the layer acts on its
    last axis.  ``activation`` (``"relu"``) is applied after the bias, as
    Gluon's ``act`` child does.  The weight is uninitialised; the model
    initialises it."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0, prefix=None, device=None, weight_initializer=None,
                 bias_initializer="zeros"):
        super().__init__(prefix=prefix)
        dev = as_device(device) if in_units else None
        self._kwargs = dict(num_hidden=units, no_bias=not use_bias,
                            flatten=flatten)
        self._flatten_input = flatten
        self._act_type = activation
        self._declare("weight", (units, in_units), dev, init=weight_initializer)
        if use_bias:
            self._declare("bias", (units,), dev, fill=0.0, init=bias_initializer)
        else:
            self.bias = None

    def forward(self, x):
        if self.weight is None:
            in_units = x[0].numel() if self._flatten_input else x.shape[-1]
            self._complete(in_units, x.device)
        out = ops_nn.fully_connected(x, self.weight, self.bias, **self._kwargs)
        if self._act_type is not None:
            out = ops_nn.activation(out, act_type=self._act_type)
        return out


class Dropout(HybridBlock):
    """Dropout of rate ``rate`` (reference basic_layers.py:196): the
    identity in eval mode (every block is built in it); in training mode
    ``ops.nn.dropout`` with the caller's ``keep`` mask, or one drawn from
    ``generator`` (a ``torch.Generator`` on the data's device); called on
    NDArrays without either, from ``mxnet_tpu_torch.random``'s generator of
    the data's device.  Otherwise training without either raises: PyTorch's
    global random state is never used."""

    def __init__(self, rate, axes=(), generator=None, prefix=None):
        super().__init__(prefix=prefix)
        self._rate = float(rate)
        self._axes = tuple(axes)
        self.generator = generator

    def forward(self, x, keep=None):
        gen = self.generator
        if gen is None and keep is None and self.training and imperative_active():
            gen = _random.generator(x.device)
        return ops_nn.dropout(x, p=self._rate, axes=self._axes, training=self.training,
                              keep=keep, generator=gen)


class Flatten(HybridBlock):
    """Flatten to (batch, -1) (reference basic_layers.py:520)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class BatchNorm(HybridBlock):
    """Batch normalization over channel axis ``axis`` (reference
    basic_layers.py:232): the op with Gluon's defaults, ``momentum=0.9``,
    ``epsilon=1e-5`` and ``fix_gamma = not scale``.  ``gamma`` and ``beta``
    are parameters; one made with ``scale=False`` / ``center=False`` takes
    no gradient (``requires_grad`` off, Gluon's ``grad_req="null"``).
    ``running_mean`` and ``running_var`` are buffers.

    In training mode (``self.training``, which the train steps turn on;
    every block is built in eval mode) and without ``use_global_stats``,
    the layer normalises with the batch's statistics and then folds them
    into the running ones, ``m·running + (1 − m)·batch`` with the biased
    variance, in the running statistics' dtype.  The fold writes the
    buffers in place (``copy_`` under ``no_grad``) after the output is
    computed, so that a caller's buffers passed through
    ``torch.func.functional_call`` are the ones updated.  Otherwise it
    normalises with the running statistics and leaves them as they are."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0, prefix=None,
                 device=None):
        super().__init__(prefix=prefix)
        dev = as_device(device) if in_channels else None
        self._axis = axis
        self._kwargs = dict(axis=axis, eps=epsilon, fix_gamma=not scale,
                            use_global_stats=use_global_stats)
        self._momentum = momentum
        self._use_global_stats = use_global_stats
        c = (in_channels,)
        self._declare("gamma", c, dev, fill=1.0, init="ones",
                      grad_req="write" if scale else "null")
        self._declare("beta", c, dev, fill=0.0, init="zeros",
                      grad_req="write" if center else "null")
        self._declare("running_mean", c, dev, fill=0.0, init="zeros", grad_req="null",
                      buffer=True)
        self._declare("running_var", c, dev, fill=1.0, init="ones", grad_req="null",
                      buffer=True)

    def forward(self, x):
        if self.gamma is None:
            self._complete(x.shape[self._axis], x.device)
        out, mean, var = ops_nn.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            training=self.training, output_mean_var=True, **self._kwargs)
        if self.training and not self._use_global_stats:
            m = self._momentum
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean), (self.running_var, var)):
                    run.copy_(m * run + (1 - m) * batch.to(run.dtype))
        return out
