"""Basic layers (counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py``).
Shapes are known at construction, so ``in_units`` / ``in_channels`` are
required where Gluon defers them.  ``device`` None means CUDA, and raises
without it (pass ``"cpu"`` to run on the CPU)."""
from __future__ import annotations

import torch

from ...context import resolve_device
from ...ops import nn as ops_nn
from ..block import HybridBlock, HybridSequential

__all__ = ["BatchNorm", "Dense", "Dropout", "Flatten", "HybridSequential"]


class Dense(HybridBlock):
    """Fully-connected layer ``x·Wᵀ + b``, weight (units, in_units)
    (reference basic_layers.py:123).  With ``flatten`` (the default) the
    input is flattened to (batch, -1) first, else the layer acts on its
    last axis.  ``activation`` (``"relu"``) is applied after the bias, as
    Gluon's ``act`` child does.  The weight is uninitialised; the model
    initialises it."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 in_units=0, prefix=None, device=None):
        super().__init__(prefix=prefix)
        if not in_units:
            raise ValueError("Dense: in_units is required (no deferred "
                             "shapes in the port)")
        device = resolve_device(device)
        self._kwargs = dict(num_hidden=units, no_bias=not use_bias,
                            flatten=flatten)
        self._act_type = activation
        self.weight = torch.nn.Parameter(torch.empty(units, in_units, device=device))
        self.bias = (torch.nn.Parameter(torch.zeros(units, device=device))
                     if use_bias else None)
        self.gluon_params = ("weight", "bias") if use_bias else ("weight",)

    def forward(self, x):
        out = ops_nn.fully_connected(x, self.weight, self.bias, **self._kwargs)
        if self._act_type is not None:
            out = ops_nn.activation(out, act_type=self._act_type)
        return out


class Dropout(HybridBlock):
    """Dropout of rate ``rate`` (reference basic_layers.py:196): the
    identity in eval mode (every block is built in it); in training mode
    ``ops.nn.dropout`` with the caller's ``keep`` mask, or one drawn from
    ``generator`` (a ``torch.Generator`` on the data's device).  With
    neither, training raises: the global random state is never used."""

    def __init__(self, rate, axes=(), generator=None, prefix=None):
        super().__init__(prefix=prefix)
        self._rate = float(rate)
        self._axes = tuple(axes)
        self.generator = generator

    def forward(self, x, keep=None):
        return ops_nn.dropout(x, p=self._rate, axes=self._axes, training=self.training,
                              keep=keep, generator=self.generator)


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

    gluon_params = ("gamma", "beta", "running_mean", "running_var")

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0, prefix=None,
                 device=None):
        super().__init__(prefix=prefix)
        if not in_channels:
            raise ValueError("BatchNorm: in_channels is required (no deferred "
                             "shapes in the port)")
        device = resolve_device(device)
        self._kwargs = dict(axis=axis, eps=epsilon, fix_gamma=not scale,
                            use_global_stats=use_global_stats)
        self._momentum = momentum
        self._use_global_stats = use_global_stats
        self.gamma = torch.nn.Parameter(torch.ones(in_channels, device=device),
                                        requires_grad=scale)
        self.beta = torch.nn.Parameter(torch.zeros(in_channels, device=device),
                                       requires_grad=center)
        self.register_buffer("running_mean", torch.zeros(in_channels, device=device))
        self.register_buffer("running_var", torch.ones(in_channels, device=device))

    def forward(self, x):
        out, mean, var = ops_nn.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            training=self.training, output_mean_var=True, **self._kwargs)
        if self.training and not self._use_global_stats:
            m = self._momentum
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean), (self.running_var, var)):
                    run.copy_(m * run + (1 - m) * batch.to(run.dtype))
        return out
