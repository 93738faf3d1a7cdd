"""BaseModule — the training-loop interface (counterpart of
``mxnet_tpu/module/base_module.py``; reference
python/mxnet/module/base_module.py :192-979): the intermediate-level
``forward`` / ``backward`` / ``update`` that subclasses provide, and the
high-level ``fit`` / ``score`` / ``predict`` loops over them."""
from __future__ import annotations

import logging
import time

import torch

from .. import metric as metric_mod
from .. import ndarray as nd
from ..model import BatchEndParam

__all__ = ["BaseModule"]


def _check_input_names(symbol, names, typename, throw):
    args = set(symbol.list_arguments() + symbol.list_auxiliary_states())
    for name in names:
        if name not in args:
            msg = ("You created Module with Module(..., %s_names=%s) but input with name "
                   "'%s' is not found in symbol.list_arguments()."
                   % (typename, list(names), name))
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


def _as_metric(m):
    return m if isinstance(m, metric_mod.EvalMetric) else metric_mod.create(m)


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    @property
    def symbol(self):
        return self._symbol

    # -- what subclasses provide ------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, grad_req="write"):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd", optimizer_params=None,
                       force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    # -- built on them ------------------------------------------------------------
    def prepare(self, data_batch):
        """Get ready for ``data_batch``, the batch after the current one
        (reference base_module.py prepare): nothing for a module of one
        executor, which copies a batch to its device at ``forward``; a
        ``BucketingModule`` binds the batch's bucket."""

    def forward_backward(self, data_batch):
        """A training forward, then the backward (reference
        base_module.py:192)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False, force_init=True,
                   allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init,
                         allow_extra=allow_extra)

    def save_params(self, fname):
        """The parameters as ``arg:<name>`` / ``aux:<name>`` entries of an
        ``ndarray.save`` file (the JAX package's layout)."""
        arg_params, aux_params = self.get_params()
        save_dict = {"arg:%s" % k: v for k, v in arg_params.items()}
        save_dict.update({"aux:%s" % k: v for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        arg_params, aux_params = {}, {}
        for k, v in nd.load(fname).items():
            tp, name = k.split(":", 1)
            if tp == "arg":
                arg_params[name] = v
            elif tp == "aux":
                aux_params[name] = v
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              score_end_callback=None, reset=True, epoch=0):
        """The metric over ``eval_data``'s batches, each an inference
        forward -> [(name, value)]."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("score() needs a bound module with parameters")
        eval_metric = _as_metric(eval_metric)
        eval_metric.reset()
        if reset:
            eval_data.reset()
        nbatch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                                      locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        if score_end_callback is not None:
            param = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                                  locals=locals())
            for cb in _as_list(score_end_callback):
                cb(param)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yields (outputs without the batch's padding, batch index, batch)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("iter_predict() needs a bound module with parameters")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False):
        """The outputs over ``eval_data`` without padding, concatenated over
        batches with ``merge_batches``."""
        output_list = [[o.clone() for o in outputs] for outputs, _, _ in
                       self.iter_predict(eval_data, num_batch=num_batch, reset=reset)]
        if not output_list or not merge_batches:
            return output_list
        num_outputs = len(output_list[0])
        merged = [torch.cat([out[i] for out in output_list]) for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc", epoch_end_callback=None,
            batch_end_callback=None, kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),), eval_end_callback=None,
            eval_batch_end_callback=None, initializer=None, arg_params=None,
            aux_params=None, allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None):
        """The reference training loop (base_module.py:399): bind,
        ``init_params`` (``Uniform(0.01)`` unless ``initializer``),
        ``init_optimizer``, then per epoch ``forward_backward`` / ``update``
        / ``update_metric`` per batch, the batch-end callbacks, and at the
        epoch's end the epoch-end callbacks and ``score`` on
        ``eval_data``."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        if monitor is not None:
            raise NotImplementedError("Module.fit(monitor=) is not ported (ROADMAP A10)")
        from ..initializer import Uniform

        initializer = initializer if initializer is not None else Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data, label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = _as_metric(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                self.forward_backward(data_batch)
                self.update()
                try:
                    next_data_batch = next(data_iter)
                    self.prepare(next_data_batch)
                except StopIteration:
                    end_of_batch = True
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                                          locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)
            train_data.reset()
