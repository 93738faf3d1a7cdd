"""PythonModule — modules written in Python (counterpart of
``mxnet_tpu/module/python_module.py``; reference
python/mxnet/module/python_module.py): a module without a symbol, such as a
loss head whose gradient is a Python function, that joins a
``SequentialModule`` chain.  Outputs and gradients are tensors, as
``Module``'s are."""
from __future__ import annotations

import logging

import numpy as np
import torch

from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """A module of no parameters: subclass it and provide ``forward``,
    ``backward``, ``get_outputs``, ``get_input_grads`` and
    ``_compute_output_shapes`` (and ``update`` / ``update_metric`` where
    it has more to do)."""

    def __init__(self, data_names, label_names, output_names, logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if len(data_shapes) != len(self._data_names):
            raise ValueError("%d data shapes for data names %s"
                             % (len(data_shapes), self._data_names))
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd", optimizer_params=None,
                       force_init=False):
        self.optimizer_initialized = True


class PythonLossModule(PythonModule):
    """A loss head: ``forward`` keeps the scores (its output) and the labels,
    ``backward`` makes the scores' gradient as ``grad_func(scores, labels)``
    (tensors; a tensor or an array back, put on the scores' device)."""

    def __init__(self, name="pyloss", data_names=("data",), label_names=("softmax_label",),
                 logger=logging, grad_func=None):
        super().__init__(list(data_names), list(label_names), [name + "_output"],
                         logger=logger)
        if len(data_names) != 1 or len(label_names) != 1:
            raise ValueError("PythonLossModule takes one data and one label")
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._name = name
        self._scores = None
        self._labels = None
        self._scores_grad = None
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        d = self._data_shapes[0]
        return [(self._name + "_output", d.shape if hasattr(d, "shape") else d[1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label is not None:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise ValueError("PythonLossModule is a loss head: it takes no out_grads")
        if not self.for_training:
            raise RuntimeError("backward() needs a module bound for training")
        if self._grad_func is None:
            raise NotImplementedError("provide grad_func or override backward")
        grad = self._grad_func(self._scores, self._labels)
        if hasattr(grad, "_data"):
            grad = grad._data
        elif not isinstance(grad, torch.Tensor):
            grad = torch.as_tensor(np.asarray(grad))
        self._scores_grad = grad.to(self._scores.device)

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
