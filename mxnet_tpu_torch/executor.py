"""Executor — runs a bound Symbol graph (counterpart of ``mxnet_tpu/executor.py``).

The JAX executor hands the composed graph to ``jax.jit`` and takes
gradients with ``jax.vjp``; here the graph runs eagerly, node by node in
topological order, each node calling its registered op on the outputs of
its inputs, and a training forward records the autograd graph that
``backward`` differentiates.  Auxiliary states (BatchNorm's moving
statistics) are updated in place after a training forward from each op's
``aux_update``.
"""
from __future__ import annotations

import torch

from .context import full_fp32
from .symbol.symbol import _node_input_names, _sym_out_name

__all__ = ["Executor"]

_GRAD_REQS = ("write", "add", "null")
_GENERATOR_SEED = 0  # every executor's Dropout stream starts here


def _plan_step(node):
    """-> (node, input names, {is_train: attrs}, takes a generator): the
    attributes of each mode made once at bind.  A node with a ``training``
    attribute gets the mode (``graph_passes/ir.py node_call_attrs``), and in
    training a node whose op updates auxiliary states is asked for
    ``(out, mean, var)``."""
    names = node.op.attr_names
    by_mode = {}
    for is_train in (False, True):
        attrs = dict(node.attrs)
        if "training" in names and "training" not in attrs:
            attrs["training"] = is_train
        if is_train and node.op.aux_update is not None:
            attrs["output_mean_var"] = True
        by_mode[is_train] = attrs
    return (node, [_sym_out_name(i) for i in node.inputs], by_mode,
            "generator" in names and "generator" not in node.attrs)


class Executor:
    """A Symbol bound to arrays on one device (reference
    include/mxnet/executor.h:53).

    ``arg_dict`` / ``aux_dict`` / ``grad_dict`` map names to torch tensors
    on ``device``; ``outputs`` holds the last forward's results, in
    ``symbol.list_outputs()`` order.  ``grad_req`` is "write", "add" or
    "null", one for all arguments or a dict (or list) per argument; an
    argument gets a gradient when its request is not "null" and it has a
    buffer in ``grad_dict``.  Dropout nodes draw their masks from the
    executor's own ``torch.Generator``, seeded at bind with
    ``_GENERATOR_SEED`` (never from the global random state), so two binds
    of one symbol repeat the same masks."""

    def __init__(self, symbol, device, args, args_grad=None, grad_req="write",
                 aux_states=None):
        self._symbol = symbol
        self.device = device
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._out_names = symbol.list_outputs()
        self.arg_dict = dict(args)
        self.aux_dict = dict(aux_states or {})
        self.grad_dict = dict(args_grad or {})
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self._arg_names, grad_req))
        self._grad_req = dict(grad_req)
        bad = {r for r in self._grad_req.values() if r not in _GRAD_REQS}
        if bad:
            raise ValueError("grad_req must be one of %s, got %s" % (_GRAD_REQS, bad))
        self._generator = torch.Generator(device=device).manual_seed(_GENERATOR_SEED)
        self.outputs = []
        self._heads = None          # the graph of the last training forward
        self._leaves = None
        self._last_is_train = None
        self._last_rng_state = None  # the generator's state at the last forward
        self._plan = [_plan_step(node) for node in symbol._walk() if not node.is_var]

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._out_names, self.outputs))

    def _diff_names(self):
        return [n for n in self._arg_names
                if self._grad_req.get(n, "null") != "null" and n in self.grad_dict]

    def _run(self, is_train, generator, update_aux, grad_names=()):
        """One pass over the plan -> (heads, {name: leaf}), the arguments in
        ``grad_names`` entering as leaves that require a gradient.  Each
        node runs with its attributes of the mode (``_plan_step``), Dropout
        with ``generator``; the auxiliary states a training node updates are
        written after the pass when ``update_aux``."""
        leaves = {}
        env = {}
        for n in self._arg_names:
            v = self.arg_dict[n]
            if n in grad_names:
                v = leaves[n] = v.detach().requires_grad_()
            env[n] = v
        env.update(self.aux_dict)
        new_aux = {}
        is_train = bool(is_train)
        for node, in_names, attrs_by_mode, takes_generator in self._plan:
            attrs = attrs_by_mode[is_train]
            if takes_generator:
                attrs = dict(attrs, generator=generator)
            hidden = is_train and node.op.aux_update is not None
            res = node.op.fn(*[env[n] for n in in_names], **attrs)
            outs = res if isinstance(res, tuple) else (res,)
            if hidden:
                by_arg = dict(zip(_node_input_names(node), node.inputs))
                aux_in = {a: new_aux.get(by_arg[a].name, self.aux_dict[by_arg[a].name])
                          for a in node.op.aux
                          if a in by_arg and by_arg[a].is_var and by_arg[a].name in self.aux_dict}
                with torch.no_grad():
                    for a, v in node.op.aux_update(attrs, outs, aux_in).items():
                        if v is not aux_in[a]:
                            new_aux[by_arg[a].name] = v
                if node.num_outputs == 1:
                    outs = outs[:1]  # mean and var stay hidden
            for i, o in enumerate(outs[: node.num_outputs]):
                env[_sym_out_name(node[i] if node.num_outputs > 1 else node)] = o
        if update_aux:
            with torch.no_grad():
                for n, v in new_aux.items():
                    self.aux_dict[n].copy_(v)
        return [env[n] for n in self._out_names], leaves

    def forward(self, is_train=False, **feeds):
        """Run the graph (reference GraphExecutor::Forward).  ``feeds`` rebind
        arguments by name; a tensor already on the device in the bound dtype
        is taken as it is, anything else is copied there.

        Runs under ``full_fp32()`` (no TF32 in cuDNN or matmuls, as the JAX
        reference computes) and makes no host synchronisation of its own.
        The inference forward runs under ``torch.inference_mode()``.  A
        training forward records the autograd graph from the arguments that
        take a gradient, runs every op in training mode (BatchNorm on batch
        statistics, Dropout on masks from the executor's generator), and
        then updates the auxiliary states in place."""
        for k, v in feeds.items():
            if k not in self.arg_dict:
                raise ValueError("forward() got unknown argument %r; expected "
                                 "one of %s" % (k, self._arg_names))
            self.arg_dict[k] = torch.as_tensor(v, dtype=self.arg_dict[k].dtype,
                                               device=self.device)
        self._heads = self._leaves = None
        self._last_is_train = bool(is_train)
        self._last_rng_state = self._generator.get_state()
        if not is_train:
            with torch.inference_mode(), full_fp32():
                self.outputs = self._run(False, self._generator, update_aux=False)[0]
            return self.outputs
        with torch.enable_grad(), full_fp32():
            heads, leaves = self._run(True, self._generator, update_aux=True,
                                      grad_names=set(self._diff_names()))
        if leaves:
            self._heads, self._leaves = heads, leaves
        self.outputs = [h.detach() for h in heads]
        return self.outputs

    def backward(self, out_grads=None, is_train=None):
        """Gradients into ``grad_dict`` per ``grad_req`` (reference
        GraphExecutor::Backward): "write" overwrites the buffer, "add" adds
        to it, "null" leaves it.

        ``out_grads`` are the heads' cotangents (a tensor or array, or a
        list of them in ``list_outputs`` order); None gives each head ones.
        ``is_train=None`` differentiates in the mode of the last forward.
        The graph of the last training forward is used once; otherwise (a
        second backward, an inference forward before, another mode) the
        forward runs again in the mode asked for, on the same Dropout masks,
        without touching the auxiliary states, as the JAX executor's
        backward does."""
        diff = self._diff_names()
        if not diff:
            return
        if self._last_is_train is None:
            raise RuntimeError("backward() needs a forward() first")
        mode = self._last_is_train if is_train is None else bool(is_train)
        heads, leaves = self._heads, self._leaves
        self._heads = self._leaves = None
        if heads is None or not mode or set(leaves) != set(diff):
            generator = torch.Generator(device=self.device)
            generator.set_state(self._last_rng_state)
            with torch.enable_grad(), full_fp32():
                heads, leaves = self._run(mode, generator, update_aux=False,
                                          grad_names=set(diff))
        if out_grads is None:
            cts = [torch.ones_like(h) for h in heads]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cts = [torch.as_tensor(g, dtype=h.dtype, device=self.device)
                   for g, h in zip(out_grads, heads)]
        live = [(h, c) for h, c in zip(heads, cts) if h.requires_grad]
        names = list(leaves)
        with full_fp32():
            grads = torch.autograd.grad([h for h, _ in live], [leaves[n] for n in names],
                                        [c for _, c in live], allow_unused=True) \
                if live else [None] * len(names)
        with torch.no_grad():
            for n, g in zip(names, grads):
                buf = self.grad_dict[n]
                if g is None:
                    g = torch.zeros_like(buf)
                if self._grad_req[n] == "add":
                    buf.add_(g)
                else:
                    buf.copy_(g)

    def reshape(self, **shapes):
        """A new executor of the same symbol for new input shapes (reference
        GraphExecutor::Reshape): arrays whose shape is unchanged are shared,
        the others allocated anew, zero-filled; same ``grad_req``."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)

        def keep(old, shape):
            if old is not None and tuple(old.shape) == tuple(shape):
                return old
            return torch.zeros(shape, dtype=old.dtype if old is not None else torch.float32,
                               device=self.device)

        args = {n: keep(self.arg_dict.get(n), s) for n, s in zip(self._arg_names, arg_shapes)}
        grads = {n: keep(self.grad_dict[n], s) for n, s in zip(self._arg_names, arg_shapes)
                 if n in self.grad_dict}
        aux = {n: keep(self.aux_dict.get(n), s) for n, s in zip(self._aux_names, aux_shapes)}
        return Executor(self._symbol, self.device, args, grads, self._grad_req, aux)

    def copy_params_from(self, arg_params, aux_params=None, allow_extra_params=False):
        """Copy values into the bound arguments and auxiliary states by name
        (tensors or arrays, any device); an unknown name raises unless
        ``allow_extra_params``."""
        for params, bound, what in ((arg_params or {}, self.arg_dict, "argument"),
                                    (aux_params or {}, self.aux_dict, "auxiliary state")):
            for k, v in params.items():
                if k in bound:
                    with torch.no_grad():
                        bound[k].copy_(torch.as_tensor(v))
                elif not allow_extra_params:
                    raise ValueError("unknown %s %s" % (what, k))
