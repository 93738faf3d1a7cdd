"""Graph analyzers (counterpart of ``mxnet_tpu/analysis/graph_analyzers.py``):
pure ``ctx -> [Diagnostic]`` checks over the plan IR, registered in run
order, with the JAX package's names, versions and diagnostic codes.

1. ``prng_safety``: every stochastic node must draw its own numbers.  The
   port's Dropout draws from the executor's one generator, node after node,
   so two plan entries share a stream only where they share a node name
   (one output would shadow the other) or an explicit mask or generator
   attribute; ``common_subexpr_merge`` must never make either.  A
   stochastic node that stays live in an inference plan is a warning.
2. ``shape_dtype``: the plan walked on meta tensors (shapes and dtypes, no
   storage, nothing launched): float64 outputs of narrower inputs, and any
   head whose shape or dtype drifted between the captured and the
   optimised plan.  Without bound shapes it reports ``analyzer-skipped``.
3. ``dead_code``: arguments and auxiliary states that no node of the plan
   reads.
4. ``numerics`` (``numerics.py``): dtype flow, intervals and the cast-plan
   verdicts.

Analyzers never change the graph, and a failing one gives one INFO
diagnostic through the manager.
"""
from __future__ import annotations

import torch

from ..graph_passes.ir import node_attr, node_call_attrs, node_out_names, stochastic
from . import register_analyzer
from .diagnostics import ERROR, INFO, WARNING, Diagnostic

__all__ = ["prng_safety", "shape_dtype", "dead_code", "skipped_no_avals"]


def skipped_no_avals(analyzer):
    """The one ``analyzer-skipped`` INFO: a context without bound shapes is
    reported, never taken for clean."""
    return Diagnostic(
        "analyzer-skipped", INFO,
        "%s skipped: context carries no bound avals (shapes/dtypes "
        "unknown) — bind arrays, or build the GraphContext with "
        "arg_avals/aux_avals, to run the abstract walk" % analyzer,
        analyzer=analyzer)


def _eval_live(node):
    """Does this stochastic node draw in an inference plan?  Dropout is the
    identity there unless forced (an explicit ``training`` attribute or
    ``mode="always"``)."""
    if getattr(node.op, "name", "") == "Dropout":
        return bool(node.attrs.get("training")) or node_attr(node, "mode") == "always"
    return True


@register_analyzer("prng_safety", version=1)
def prng_safety(ctx):
    """Shared-stream and inference-stochastic checks over the plan."""
    streams = {}  # stream id -> [node name]
    diags = []
    for node, _ in ctx.graph.entries:
        if not stochastic(node.op):
            continue
        explicit = [k for k in ("keep", "generator") if node.attrs.get(k) is not None]
        if explicit:
            sid = ("explicit", tuple(id(node.attrs[k]) for k in explicit))
        else:
            sid = ("name", node.name)
        streams.setdefault(sid, []).append(node.name)
        if not ctx.is_train and _eval_live(node):
            diags.append(Diagnostic(
                "prng-eval-stochastic", WARNING,
                "stochastic node %r (%s) samples in an EVAL plan — inference "
                "outputs are nondeterministic" % (node.name, getattr(node.op, "name", "?")),
                where=node.name))
    for (kind, _), names in streams.items():
        if len(names) > 1:
            diags.append(Diagnostic(
                "prng-shared-stream", ERROR,
                "stochastic nodes %s draw the SAME numbers (%s) — what should be "
                "independent randomness is correlated"
                % (sorted(names), "shared explicit mask or generator" if kind == "explicit"
                   else "same node name"),
                where=",".join(sorted(set(names)))))
    return diags


def _meta(v):
    """A meta tensor of ``v``'s shape and dtype (a tensor or an array)."""
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def _abstract_walk(graph, ctx, record=None):
    """Run the plan on meta tensors exactly as the executor evaluates it
    (same ``node_call_attrs``, hidden outputs trimmed, auxiliary updates
    skipped) -> [head meta tensor].  ``record(node, out_name, shape, dtype,
    in_vals, in_names)`` sees every node output."""
    env = {n: _meta(v) for n, v in graph.constants.items()}
    env.update(ctx.arg_avals)
    env.update(ctx.aux_avals)
    generator = torch.Generator()  # meta draws take any generator
    for node, in_names in graph.entries:
        attrs = node_call_attrs(node, generator, ctx.is_train)
        res = node.op.fn(*[env[n] for n in in_names], **attrs)
        outs = res if isinstance(res, tuple) else (res,)
        if len(outs) > 1 and node.num_outputs == 1:
            outs = outs[:1]
        for nm, o in zip(node_out_names(node), outs):
            env[nm] = o
            if record is not None:
                record(node, nm, tuple(o.shape), o.dtype, [env[n] for n in in_names], in_names)
    return [env[h] for h in graph.heads]


@register_analyzer("shape_dtype", version=1)
def shape_dtype(ctx):
    """float64 promotion and captured-vs-optimised head drift, on meta
    tensors."""
    if not ctx.has_avals:
        return [skipped_no_avals("shape_dtype")]
    diags = []
    f64 = torch.float64

    def record(node, nm, shape, dtype, in_vals, in_names):
        if dtype == f64 and not any(getattr(v, "dtype", None) == f64 for v in in_vals):
            diags.append(Diagnostic(
                "f64-promotion", WARNING,
                "node %r (%s) output %s promotes to float64 with no float64 "
                "input — a silent upcast" % (node.name, getattr(node.op, "name", "?"), nm),
                where=nm))

    opt_heads = _abstract_walk(ctx.graph, ctx, record=record)
    if ctx.raw is not ctx.graph:
        raw_heads = _abstract_walk(ctx.raw, ctx)
        if len(raw_heads) != len(opt_heads):
            diags.append(Diagnostic(
                "pass-drift", ERROR,
                "head COUNT drifted across the pass pipeline: captured %d -> "
                "optimized %d" % (len(raw_heads), len(opt_heads)), where="heads"))
        for i, (r, o) in enumerate(zip(raw_heads, opt_heads)):
            if tuple(r.shape) != tuple(o.shape) or r.dtype != o.dtype:
                diags.append(Diagnostic(
                    "pass-drift", ERROR,
                    "head %d drifted across the pass pipeline: captured %s%s -> "
                    "optimized %s%s" % (i, r.dtype, tuple(r.shape), o.dtype,
                                        tuple(o.shape)), where="head%d" % i))
    return diags


@register_analyzer("dead_code", version=1)
def dead_code(ctx):
    """Arguments and auxiliary states no node of the plan reads."""
    if ctx.arg_names is None:
        return []
    used = set(ctx.graph.heads)
    for _, in_names in ctx.graph.entries:
        used.update(in_names)
    mode = "train" if ctx.is_train else "eval"
    diags = [Diagnostic("unused-input", WARNING,
                        "argument %r is consumed by no node in the %s plan — it is "
                        "staged to device every forward for nothing" % (n, mode), where=n)
             for n in ctx.arg_names if n not in used]
    diags += [Diagnostic("dead-aux", WARNING,
                         "aux state %r is consumed by no node in the %s plan" % (n, mode),
                         where=n)
              for n in ctx.aux_names or () if n not in used]
    return diags
