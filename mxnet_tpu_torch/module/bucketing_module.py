"""BucketingModule — variable-length sequence training (counterpart of
``mxnet_tpu/module/bucketing_module.py``; reference
python/mxnet/module/bucketing_module.py).

One ``Module`` per bucket key, each bound once to its bucket's shapes; every
bucket shares the default bucket's parameter tensors
(``Module.bind(shared_module=)``) and its optimizer and updater (so one
Adam state and one update count per parameter), so a step in any bucket
moves them all.
"""
from __future__ import annotations

import logging

from ..context import as_device
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    """``sym_gen(bucket_key) -> (symbol, data_names, label_names)`` builds
    each bucket's symbol; ``default_bucket_key`` is the bucket bound first,
    whose shapes ``bind`` takes.  ``context`` (a ``Context``) or ``device``
    says where the buckets run: None means CUDA, which raises without a
    card unless ``device="cpu"`` (or ``context=mx.cpu()``).
    ``state_names`` is ROADMAP A8.3; ``work_load_list`` is taken and
    ignored (one device)."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, device=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("BucketingModule needs a default_bucket_key")
        if state_names:
            raise NotImplementedError("BucketingModule(state_names=) is not ported "
                                      "(ROADMAP A8.3)")
        if context is not None and device is not None:
            raise ValueError("give context or device, not both")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._device = as_device(context) if context is not None else device
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._grad_req = "write"
        self._opt_module = None

    def _need(self, params=False):
        if not self.binded or (params and not self.params_initialized):
            raise RuntimeError("the BucketingModule needs bind()%s first"
                               % (" and init_params()" if params else ""))

    @property
    def default_bucket_key(self):
        return self._default_bucket_key

    @property
    def symbol(self):
        self._need()
        return self._curr_module.symbol

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._need()
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._need()
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._need()
        return self._curr_module.output_shapes

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      device=self._device, fixed_param_names=self._fixed_param_names)

    # -- parameters -------------------------------------------------------------
    def get_params(self):
        self._need(params=True)
        return self._curr_module.get_params()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._need()
        self._curr_module.init_params(initializer=initializer, arg_params=arg_params,
                                      aux_params=aux_params, allow_missing=allow_missing,
                                      force_init=force_init, allow_extra=allow_extra)
        self.params_initialized = True

    # -- bind / bucket switching ------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None, grad_req="write"):
        """Bind the default bucket's module to these shapes."""
        if force_rebind:
            self._buckets = {}
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise ValueError("a BucketingModule shares its parameters among its own buckets")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module the current one, binding it first if
        it is new, on the default bucket's parameters (reference
        bucketing_module.py switch_bucket)."""
        self._need()
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training, self.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._buckets[self._default_bucket_key],
                        grad_req=self._grad_req)
            if self.optimizer_initialized:
                self._borrow_optimizer(module)
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def prepare(self, data_batch):
        """Bind the next batch's bucket if it is new, keeping the current
        one (reference bucketing_module.py prepare)."""
        prev = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module = self._buckets[prev]
        self._curr_bucket_key = prev

    # -- optimizer / compute ----------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd", optimizer_params=None,
                       force_init=False):
        self._need(params=True)
        if self.optimizer_initialized and not force_init:
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        self._opt_module = self._curr_module
        self.optimizer_initialized = True
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                self._borrow_optimizer(mod)

    def _borrow_optimizer(self, module):
        """Share the optimizer's module's optimizer and updater, and so their
        states (reference bucketing_module.py borrow_optimizer)."""
        module._optimizer = self._opt_module._optimizer
        module._updater = self._opt_module._updater
        module.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._need(params=True)
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step through the current bucket's module: the
        parameters are every bucket's."""
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        raise NotImplementedError("install_monitor is not ported (ROADMAP A10)")
