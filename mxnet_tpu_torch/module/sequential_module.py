"""SequentialModule — modules in a chain, each one's outputs the next one's
inputs (counterpart of ``mxnet_tpu/module/sequential_module.py``; reference
python/mxnet/module/sequential_module.py).  ``add(module, take_labels=,
auto_wiring=)``; ``forward`` runs the chain, ``backward`` runs it back,
each module's input gradients the previous one's output gradients."""
from __future__ import annotations

import logging

from ..io import DataBatch, DataDesc
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append ``module``; ``take_labels=True`` feeds it the labels,
        ``auto_wiring=True`` names its inputs after its own data names.
        Returns self."""
        unknown = set(kwargs) - self._meta_keys
        if unknown:
            raise ValueError("Unknown meta %s (known: %s)" % (sorted(unknown),
                                                               sorted(self._meta_keys)))
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _need_modules(self):
        if not self._modules:
            raise RuntimeError("SequentialModule has no modules: add() some first")

    @property
    def data_names(self):
        self._need_modules()
        return self._modules[0].data_names

    @property
    def output_names(self):
        self._need_modules()
        return self._modules[-1].output_names

    @property
    def data_shapes(self):
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._modules[-1].output_shapes

    def get_params(self):
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise RuntimeError("call bind before initializing the parameters")
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params, allow_missing=True,
                               force_init=force_init, allow_extra=True)
        seen_args, seen_aux = {}, {}
        for i, module in enumerate(self._modules):
            arg, aux = module.get_params()
            for seen, names in ((seen_args, arg), (seen_aux, aux)):
                for name in names:
                    if name in seen:
                        raise ValueError("Duplicated parameter names: %s in modules %d and %d"
                                         % (name, seen[name], i))
                    seen[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise NotImplementedError("SequentialModule.bind(shared_module=) is not supported")
        self._need_modules()
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        my_data_shapes = data_shapes
        takes_labels = False
        for i, module in enumerate(self._modules):
            meta = self._metas[i]
            labels = label_shapes if meta.get(self.META_TAKE_LABELS) else None
            takes_labels = takes_labels or labels is not None
            module.bind(my_data_shapes, labels, for_training, inputs_need_grad or i > 0,
                        force_rebind, None, grad_req)
            if i == len(self._modules) - 1:
                break
            nxt = self._modules[i + 1]
            if self._metas[i + 1].get(self.META_AUTO_WIRING, True):
                if module.symbol is not None:
                    shapes = {(d.name if isinstance(d, DataDesc) else d[0]):
                              (d.shape if isinstance(d, DataDesc) else d[1])
                              for d in my_data_shapes}
                    out_shapes = module.symbol.infer_shape(**shapes)[1]
                else:
                    out_shapes = [s for _, s in module.output_shapes]
                if len(nxt.data_names) != len(out_shapes):
                    raise ValueError("module %d has %d outputs for the %d inputs of the next"
                                     % (i, len(out_shapes), len(nxt.data_names)))
                my_data_shapes = [DataDesc(n, s) for n, s in zip(nxt.data_names, out_shapes)]
        self._label_shapes = label_shapes if takes_labels else None
        self._data_shapes = data_shapes
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd", optimizer_params=None,
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("init_optimizer() needs a bound module with parameters")
        if self.optimizer_initialized and not force_init:
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params, force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        batch = DataBatch(data=data_batch.data, label=data_batch.label, pad=data_batch.pad,
                          provide_data=data_batch.provide_data,
                          provide_label=data_batch.provide_label)
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            batch = DataBatch(data=module.get_outputs(), label=data_batch.label,
                              pad=data_batch.pad)

    def backward(self, out_grads=None):
        for i in range(len(self._modules) - 1, -1, -1):
            module = self._modules[i]
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        if not self.optimizer_initialized:
            raise RuntimeError("update() needs init_optimizer() first")
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise RuntimeError("get_input_grads() needs bind(inputs_need_grad=True)")
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS):
                module.update_metric(eval_metric, labels)
