"""Module — the symbolic training module (counterpart of
``mxnet_tpu/module/module.py``; reference python/mxnet/module/module.py:
bind :364, init_optimizer :473, forward :572, update :643,
save_checkpoint :165).

One executor on one device; a batch of another shape re-binds it
(``reshape``), keeping the parameters.  ``update`` is one multi-tensor
optimizer step over every parameter (``Optimizer.update_multi``: for SGD,
``torch._foreach_*`` operations in ``sgd_rule``'s order, the port of the
JAX package's fused step, ``module/fused_step.py``).  Data parallelism
(``mesh=``, ``dist_*`` kvstores) is ROADMAP A10.
"""
from __future__ import annotations

import logging
import warnings

import torch

from .. import optimizer as opt_mod
from ..context import resolve_device
from ..io import DataDesc
from ..model import load_checkpoint, save_checkpoint
from .base_module import BaseModule, _check_input_names

__all__ = ["Module"]


def _as_descs(shapes):
    if shapes is None:
        return None
    return [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1]) for s in shapes]


class Module(BaseModule):
    """A symbol with its parameters, optimizer and executor on ``device``
    (None means CUDA, which raises without a card unless ``device="cpu"``)."""

    def __init__(self, symbol, data_names=("data",), label_names=("softmax_label",),
                 logger=logging, device=None, mesh=None):
        super().__init__(logger=logger)
        if mesh is not None:
            raise NotImplementedError("Module(mesh=) data parallelism is not ported "
                                      "(ROADMAP A10)")
        self._device = resolve_device(device)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        input_names = set(self._data_names + self._label_names)
        self._param_names = [n for n in symbol.list_arguments() if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._exec = None
        self._data_shapes = None
        self._label_shapes = None
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None
        self._grad_req = "write"

    # -- properties ---------------------------------------------------------------
    @property
    def device(self):
        return self._device

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

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
        outs = self._exec.outputs if self._exec is not None else []
        return [(n, tuple(o.shape)) for n, o in zip(self._output_names, outs)] or None

    # -- parameters ---------------------------------------------------------------
    def get_params(self):
        """({name: tensor} of the parameters, {name: tensor} of the auxiliary
        states): the executor's own tensors, updated in place by training."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("get_params() needs a bound module with parameters")
        self._sync_params_from_exec()
        return dict(self._arg_params), dict(self._aux_params)

    def _sync_params_from_exec(self):
        if self._exec is None:
            return
        self._arg_params = {n: self._exec.arg_dict[n] for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n] for n in self._aux_names}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        """Fill the parameters and auxiliary states: from ``arg_params`` /
        ``aux_params`` (tensors or arrays by name; after ``Module.load``, the
        loaded ones) where given, the rest by ``initializer`` (``Uniform(0.01)``
        when None), which a missing name needs ``allow_missing`` for."""
        if not self.binded:
            raise RuntimeError("call bind before initializing the parameters")
        if self.params_initialized and not force_init:
            return
        from ..initializer import InitDesc, Uniform

        initializer = initializer if initializer is not None else Uniform(0.01)
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                cached = cache[name]
                if cached is not arr:
                    if tuple(cached.shape) != tuple(arr.shape):
                        raise ValueError("shape mismatch for %s: loaded %s vs expected %s"
                                         % (name, tuple(cached.shape), tuple(arr.shape)))
                    with torch.no_grad():
                        arr.copy_(torch.as_tensor(cached))
            else:
                if cache is not None and not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                initializer(InitDesc(name, attrs.get(name)), arr)

        if arg_params is None and self._arg_params:
            arg_params, allow_missing = self._arg_params, True
        if aux_params is None and self._aux_params:
            aux_params, allow_missing = self._aux_params, True
        for name in self._param_names:
            _impl(name, self._exec.arg_dict[name], arg_params)
        for name in self._aux_names:
            _impl(name, self._exec.aux_dict[name], aux_params)
        if arg_params is not None and not allow_extra:
            for name in arg_params:
                if name not in self._param_names and \
                        name not in self._data_names + self._label_names:
                    raise ValueError("provided arg_params %s not found in symbol" % name)
        self._sync_params_from_exec()
        self.params_initialized = True

    # -- bind ---------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True, inputs_need_grad=False,
             force_rebind=False, grad_req="write"):
        """Bind the executor for these (name, shape) inputs.  With
        ``for_training`` the parameters get gradient buffers (``grad_req``:
        one request, or a dict by name), and the data too with
        ``inputs_need_grad``; labels get none.  Parameters already held
        (a re-bind, ``Module.load``) keep their tensors where the shape
        matches."""
        if force_rebind:
            self._exec = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise ValueError("inputs_need_grad needs for_training")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes = _as_descs(data_shapes)
        self._label_shapes = _as_descs(label_shapes)
        shape_dict = {d.name: d.shape for d in self._data_shapes}
        shape_dict.update({d.name: d.shape for d in self._label_shapes or []})
        arg_names = self._symbol.list_arguments()
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shape_dict)
        shape_of = dict(zip(arg_names, arg_shapes))
        zeros = lambda s: torch.zeros(s, device=self._device)

        def array(n, shape, own):
            if own is not None and n in own and tuple(own[n].shape) == tuple(shape):
                return own[n]
            return zeros(shape)

        args = {n: array(n, shape_of[n], self._arg_params) for n in arg_names}
        aux = {n: array(n, s, self._aux_params) for n, s in zip(self._aux_names, aux_shapes)}
        grads, req = None, "null"
        if for_training and grad_req != "null":
            grads, req = {}, {}
            for n in self._param_names:
                req[n] = grad_req if isinstance(grad_req, str) else grad_req.get(n, "write")
                grads[n] = zeros(shape_of[n])
            for n in self._data_names:
                req[n] = "write" if inputs_need_grad else "null"
                if inputs_need_grad:
                    grads[n] = zeros(shape_of[n])
            for n in self._label_names:
                req[n] = "null"
        self._exec = self._symbol.bind(self._device, args=args, args_grad=grads,
                                       grad_req=req, aux_states=aux)
        self.binded = True

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind for new input shapes, keeping the parameters (reference
        module.py:452)."""
        params_were_init = self.params_initialized
        if params_were_init:
            self._sync_params_from_exec()
        self.bind(data_shapes, label_shapes, self.for_training, self.inputs_need_grad,
                  force_rebind=True, grad_req=self._grad_req)
        self.params_initialized = params_were_init

    # -- optimizer ----------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd", optimizer_params=None,
                       force_init=False):
        """The optimizer by name (with ``optimizer_params``; ``rescale_grad``
        defaults to 1/batch, as the loss ops' gradients are per sample) or
        an ``Optimizer``.  One device: ``kvstore`` "local", "device" or None;
        distributed stores are ROADMAP A10."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("init_optimizer() needs a bound module with parameters")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if kvstore not in ("local", "device", None):
            raise NotImplementedError("kvstore %r is not ported: one device takes 'local', "
                                      "'device' or None (ROADMAP A10)" % (kvstore,))
        batch_size = self._data_shapes[0].shape[0]
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params or {})
            optimizer_params.setdefault("rescale_grad", 1.0 / batch_size)
            optimizer = opt_mod.create(optimizer, **optimizer_params)
        elif optimizer.rescale_grad != 1.0 / batch_size:
            warnings.warn("Optimizer created manually outside Module but rescale_grad is %g "
                          "rather than 1.0/batch_size (%g). Is this intended?"
                          % (optimizer.rescale_grad, 1.0 / batch_size))
        optimizer.idx2name = dict(enumerate(self._param_names))
        optimizer.sym_info = (self._symbol.attr_dict(), self._symbol.list_arguments())
        # the name-keyed multipliers again, now that idx2name is known
        optimizer.set_lr_mult(getattr(optimizer, "lr_mult", {}) or {})
        optimizer.set_wd_mult(getattr(optimizer, "wd_mult", {}) or {})
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # -- compute ------------------------------------------------------------------
    def _stage_batch(self, data_batch):
        """Re-bind for a batch of another shape, then feed the batch's data
        and labels into the executor (tensors already on the device in the
        bound dtype are taken as they are)."""
        provide = getattr(data_batch, "provide_data", None)
        new_descs = _as_descs(provide) if provide else [
            DataDesc(n, a.shape) for n, a in zip(self._data_names, data_batch.data)]
        if [tuple(d.shape) for d in new_descs] != [tuple(d.shape) for d in self._data_shapes]:
            if getattr(data_batch, "provide_label", None):
                new_labels = _as_descs(data_batch.provide_label)
            elif data_batch.label is not None and self._label_shapes:
                new_labels = [DataDesc(n, a.shape)
                              for n, a in zip(self._label_names, data_batch.label)]
            elif self._label_shapes:
                new_labels = [DataDesc(d.name, (new_descs[0].shape[0],) + tuple(d.shape[1:]))
                              for d in self._label_shapes]
            else:
                new_labels = None
            self.reshape(new_descs, new_labels)
        feed = dict(zip(self._data_names, data_batch.data))
        if self._label_shapes and data_batch.label is not None:
            feed.update(zip(self._label_names, data_batch.label))
        arg_dict = self._exec.arg_dict
        for k, v in feed.items():
            arg_dict[k] = torch.as_tensor(v, dtype=arg_dict[k].dtype, device=self._device)

    def forward(self, data_batch, is_train=None):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("forward() needs a bound module with parameters")
        self._stage_batch(data_batch)
        self._exec.forward(is_train=self.for_training if is_train is None else is_train)

    def backward(self, out_grads=None):
        if not (self.binded and self.params_initialized):
            raise RuntimeError("backward() needs a bound module with parameters")
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over every parameter that has a gradient, as
        one multi-tensor update (reference module.py:643)."""
        if not self.optimizer_initialized:
            raise RuntimeError("update() needs init_optimizer() first")
        grads = self._exec.grad_dict
        live = [(i, n) for i, n in enumerate(self._param_names) if n in grads]
        self._updater.update_multi([i for i, _ in live], [grads[n] for _, n in live],
                                   [self._exec.arg_dict[n] for _, n in live])

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise RuntimeError("get_input_grads() needs bind(inputs_need_grad=True)")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # -- checkpoints --------------------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states`` (reference
        module.py:165)."""
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of a checkpoint's symbol whose ``init_params`` takes the
        checkpoint's parameters (and ``init_optimizer`` its optimizer
        states)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_optimizer_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
