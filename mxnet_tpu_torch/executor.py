"""Executor — runs a bound Symbol graph (counterpart of ``mxnet_tpu/executor.py``).

The JAX executor hands the composed graph to ``jax.jit`` and takes
gradients with ``jax.vjp``; here the graph runs eagerly, node by node in
topological order, each node calling its registered op on the outputs of
its inputs, and a training forward records the autograd graph that
``backward`` differentiates.  Auxiliary states (BatchNorm's moving
statistics) are updated in place after a training forward from each op's
``aux_update``.

The plan is the JAX executor's: the captured plan (``graph_passes.capture``)
through the standard pass pipeline (``graph_passes.optimize``), for
training and inference plans alike, and on inference plans of an executor
with a precision tier the tier's passes after it.  Each mode's plan is
built at its first forward, once: its attributes made, its baked constants
moved to the executor's device.  ``MXNET_GRAPH_PASSES`` is read at bind,
so one executor never mixes raw and optimised plans; with the passes off
the captured plan runs as it is.  A tier is set per executor
(``set_precision_tier``); a bind has none.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from . import graph_passes
from .context import full_fp32
from .graph_passes.ir import node_call_attrs, node_out_names
from .symbol.symbol import _node_input_names

__all__ = ["Executor"]

_GRAD_REQS = ("write", "add", "null")
_GENERATOR_SEED = 0  # every executor's Dropout stream starts here


class _Step:
    """One node of a built plan: its input and output env names, its
    attributes in the plan's mode (``graph_passes.ir.node_call_attrs``),
    whether it takes the executor's generator, and, for a training node
    that updates auxiliary states, {op argument: auxiliary state name}."""

    __slots__ = ("node", "in_names", "out_names", "attrs", "takes_generator", "aux_vars")

    def __init__(self, node, in_names, is_train, aux_names):
        self.node = node
        self.in_names = tuple(in_names)
        self.out_names = node_out_names(node)
        self.attrs = node_call_attrs(node, None, is_train)
        self.takes_generator = "generator" in node.op.attr_names and "generator" not in node.attrs
        self.aux_vars = None
        if is_train and node.op.aux_update is not None:
            by_arg = dict(zip(_node_input_names(node), node.inputs))
            self.aux_vars = {a: by_arg[a].name for a in node.op.aux
                             if a in by_arg and by_arg[a].is_var and by_arg[a].name in aux_names}


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
        self._plan, self._head_names = graph_passes.capture(symbol)
        # the gate, read once at bind (a re-bind reads it again)
        self._graph_passes = graph_passes.enabled()
        self._precision_tier = None  # set_precision_tier
        self._calibration = None  # the int8 tier's CalibrationTable
        self._struct_cache = {}   # is_train -> the pipeline's (plan, heads, consts)
        self._opt_cache = {}      # is_train -> the plan that runs, tier included
        self._steps_cache = {}    # is_train -> ([_Step], heads, consts on device)
        self._pass_stats = {}     # "train" / "eval" -> graph_passes.optimize's stats
        self._tier_stats = None   # the tier passes' rows of the inference plan
        self._int8_sites = {}     # int8_rewrite's sites of the inference plan

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

    # -- plan -----------------------------------------------------------------
    def _structural_plan(self, is_train):
        """The standard pipeline's ``(plan, head names, constants or None)``
        for ``is_train``, before any precision tier: the plan the cast plan
        describes and calibration runs.  With the passes off, the captured
        plan itself."""
        is_train = bool(is_train)
        hit = self._struct_cache.get(is_train)
        if hit is None:
            if not self._graph_passes:
                hit = (self._plan, self._head_names, None)
            else:
                g, stats = graph_passes.optimize(self._plan, self._head_names, is_train)
                self._pass_stats[stats["mode"]] = stats
                hit = (list(g.entries), list(g.heads), g.constants or None)
            self._struct_cache[is_train] = hit
        return hit

    def _opt_plan(self, is_train):
        """The plan that runs for ``is_train``: :meth:`_structural_plan`,
        and on the inference plan of an executor with a precision tier the
        tier's passes after it (their rows appended to :meth:`pass_stats`).
        No tier, or a training plan: the structural triple itself."""
        is_train = bool(is_train)
        hit = self._opt_cache.get(is_train)
        if hit is None:
            hit = self._structural_plan(is_train)
            if self._precision_tier and not is_train:
                tctx = self._tier_context()
                if tctx is None:
                    warnings.warn("precision tier %s set but this executor has unbound "
                                  "inputs: no cast plan, tier skipped" % self._precision_tier)
                else:
                    g = graph_passes.Graph(*hit)
                    g, rows = graph_passes.precision.apply(g, self._precision_tier, tctx)
                    self._tier_stats = {"passes": rows, "nodes_post": g.n_nodes}
                    self._int8_sites = dict(tctx.int8_sites)
                    hit = (list(g.entries), list(g.heads), g.constants or None)
            self._opt_cache[is_train] = hit
        return hit

    def _tier_context(self):
        """The tier passes' :class:`~.graph_passes.precision.TierContext`:
        the structural inference plan's cast plan, the bound shapes and
        values, the calibration table; None when an input is unbound."""
        from . import analysis
        from .analysis import numerics

        ctx = analysis.executor_context(self, is_train=False, plan="structural")
        if not ctx.has_avals:
            return None
        return graph_passes.precision.TierContext(
            cast_plan=numerics.precision_plan(ctx),
            arg_names=self._arg_names, aux_names=self._aux_names,
            arg_avals=ctx.arg_avals, aux_avals=ctx.aux_avals,
            arg_values=self.arg_dict, aux_values=self.aux_dict,
            calibration=self._calibration)

    def _device_constants(self, constants):
        """Baked constants (numpy arrays or tensors) as tensors on the
        executor's device."""
        return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v,
                                   device=self.device)
                for k, v in (constants or {}).items()}

    def _steps(self, is_train):
        """The built plan of a mode, made once: ``([_Step], head names,
        {name: constant on the device})``."""
        is_train = bool(is_train)
        hit = self._steps_cache.get(is_train)
        if hit is None:
            plan, heads, consts = self._opt_plan(is_train)
            aux = set(self._aux_names)
            hit = ([_Step(node, in_names, is_train, aux) for node, in_names in plan],
                   list(heads), self._device_constants(consts))
            self._steps_cache[is_train] = hit
        return hit

    @property
    def precision_tier(self):
        """``"bf16"`` / ``"int8"``, or ``"fp32"`` when no tier is set."""
        return graph_passes.precision.tier_name(self._precision_tier)

    def set_precision_tier(self, tier, calibration=None):
        """Set this executor's tier (``Predictor.with_precision`` builds its
        twins so): ``"bf16"``,
        ``"int8"`` (with its ``calibration`` table), or None / ``"fp32"``.
        Clears the built plans."""
        if tier in (None, "fp32"):
            tier = None
        elif tier not in graph_passes.precision.VALID_TIERS:
            raise ValueError("unknown precision tier %r (valid: %s)"
                             % (tier, list(graph_passes.precision.VALID_TIERS)))
        if tier and not self._graph_passes:
            raise ValueError("precision tiers ride on the graph-pass layer — "
                             "MXNET_GRAPH_PASSES=0 executors cannot host a %r twin" % tier)
        self._precision_tier = tier
        self._calibration = calibration
        self._tier_stats = None
        self._int8_sites = {}
        self._opt_cache.clear()
        self._steps_cache.clear()

    def pass_stats(self):
        """Per-mode graph-pass results (``{"train"/"eval": stats}``) of the
        plans built so far; empty with the passes off.  A tier's pass rows
        are appended to the inference row, whose ``nodes_post`` and
        ``seconds`` are then the final plan's."""
        out = {m: dict(st) for m, st in self._pass_stats.items()}
        tier = self._tier_stats
        if tier is not None and "eval" in out:
            ev = out["eval"]
            ev["passes"] = list(ev["passes"]) + list(tier["passes"])
            ev["nodes_post"] = tier["nodes_post"]
            ev["seconds"] = round(ev["seconds"] + sum(r["seconds"] for r in tier["passes"]), 6)
        return out

    def check(self, is_train=False):
        """The graph analyzers (``analysis``) over the plan that runs for
        ``is_train`` -> [Diagnostic], most severe first; empty is clean.
        Shapes and dtypes only, on meta tensors: nothing runs."""
        from . import analysis

        return analysis.check_executor(self, bool(is_train))

    def precision_plan(self, is_train=False):
        """The cast plan (``analysis.numerics.CastPlan``) of the structural
        plan for ``is_train``: one verdict per node, fingerprinted.  Raises
        ValueError with unbound inputs."""
        from . import analysis

        return analysis.precision_plan_executor(self, bool(is_train))

    def _run(self, is_train, generator, update_aux, grad_names=()):
        """One pass over the plan of the mode -> (heads, {name: leaf}), the
        arguments in ``grad_names`` entering as leaves that require a
        gradient.  Each node runs with its attributes of the mode, a
        stochastic one with ``generator``; the auxiliary states a training
        node updates are written after the pass when ``update_aux``."""
        steps, heads, consts = self._steps(is_train)
        leaves = {}
        env = dict(consts)
        for n in self._arg_names:
            v = self.arg_dict[n]
            if n in grad_names:
                v = leaves[n] = v.detach().requires_grad_()
            env[n] = v
        env.update(self.aux_dict)
        new_aux = {}
        for step in steps:
            attrs = step.attrs
            if step.takes_generator:
                attrs = dict(attrs, generator=generator)
            res = step.node.op.fn(*[env[n] for n in step.in_names], **attrs)
            outs = res if isinstance(res, tuple) else (res,)
            if step.aux_vars is not None:
                aux_in = {a: new_aux.get(v, self.aux_dict[v]) for a, v in step.aux_vars.items()}
                with torch.no_grad():
                    for a, v in step.node.op.aux_update(attrs, outs, aux_in).items():
                        if v is not aux_in[a]:
                            new_aux[step.aux_vars[a]] = v
            if len(outs) > 1 and step.node.num_outputs == 1:
                outs = outs[:1]  # mean and var stay hidden
            env.update(zip(step.out_names, outs))
        if update_aux:
            with torch.no_grad():
                for n, v in new_aux.items():
                    self.aux_dict[n].copy_(v)
        return [env[n] for n in heads], leaves

    def forward(self, is_train=False, **feeds):
        """Run the graph (reference GraphExecutor::Forward).  ``feeds`` rebind
        arguments by name; a tensor already on the device in the bound dtype
        is taken as it is, anything else is copied there.

        Runs under ``full_fp32()`` (no TF32 in cuDNN or matmuls, as the JAX
        reference computes) and makes no host synchronisation of its own,
        but for the first forward of a mode, which builds its plan (a
        precision tier reads the bound weights to the host there).
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
        self._steps(is_train)  # built outside inference mode: constants stay usable
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
