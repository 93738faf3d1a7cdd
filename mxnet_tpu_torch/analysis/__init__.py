"""Static analysis of execution plans (counterpart of ``mxnet_tpu/analysis``,
its graph-analyzer layer).

The analyzers are pure functions over the plan IR (``graph_passes.ir``), run
by the manager below (registration order is run order, (name, version) is
an analyzer's identity, as for the passes).  They check the contracts the
pass pipeline must keep (random streams, no live stochastic node in an
inference plan, no shape or dtype drift between the captured and the
optimised plan, no dead inputs) and the precision-flow hazards behind the
cast plan's ``bf16_safe | fp32_accum | fp32_only`` verdicts
(``numerics.py``), which the precision tiers consume.  They are surfaced
as ``Executor.check()`` / ``Predictor.check()`` and
``Executor.precision_plan()`` / ``Predictor.precision_plan()``.

Where the JAX package walks a plan with ``jax.eval_shape`` over
``jax.ShapeDtypeStruct`` avals, the port walks it on tensors on
``torch.device("meta")``: shapes and dtypes, no storage, nothing launched
(the kernel wrappers return empty meta outputs there).
"""
from __future__ import annotations

import torch

from .diagnostics import ERROR, INFO, WARNING, Diagnostic, worst_severity

__all__ = ["Diagnostic", "ERROR", "WARNING", "INFO", "worst_severity",
           "register_analyzer", "analyze",
           "GraphContext", "executor_context", "check_executor",
           "precision_plan_executor"]

_ANALYZERS = []  # [(name, version, fn)]: registration order is run order


def register_analyzer(name, version=1):
    """Register a pure ``fn(ctx) -> iterable[Diagnostic]`` analyzer."""
    def _reg(fn):
        _ANALYZERS.append((str(name), int(version), fn))
        return fn
    return _reg


def analyze(ctx):
    """Run every analyzer over ``ctx`` -> [Diagnostic], most severe first.
    An analyzer that raises gives one INFO diagnostic instead."""
    out = []
    for name, version, fn in _ANALYZERS:
        try:
            diags = list(fn(ctx))
        except Exception as e:
            diags = [Diagnostic("analyzer-failed", INFO,
                                "analyzer %s:%d did not complete: %r" % (name, version, e))]
        for d in diags:
            if d.analyzer is None:
                d.analyzer = name
        out.extend(diags)
    out.sort(key=Diagnostic._sort_key)
    return out


class GraphContext:
    """What a graph analyzer may consult.

    ``graph``     the plan the executor runs (pass-optimised when
                  ``MXNET_GRAPH_PASSES`` is on, raw otherwise);
    ``raw``       the captured plan (the drift check compares the two);
    ``is_train``  the plan's mode;
    ``arg_names`` / ``aux_names``  bound argument / auxiliary-state order,
                  or None;
    ``arg_avals`` / ``aux_avals``  name -> meta tensor of the bound shape
                  and dtype, or None when shapes are unknown (the
                  abstract-walk analyzers then report that they skipped).
    """

    __slots__ = ("graph", "raw", "is_train", "arg_names", "aux_names",
                 "arg_avals", "aux_avals", "_numerics_flow")

    def __init__(self, graph, raw=None, is_train=False, arg_names=None,
                 aux_names=None, arg_avals=None, aux_avals=None):
        self._numerics_flow = None  # numerics._flow's memo, one walk per ctx
        self.graph = graph
        self.raw = raw if raw is not None else graph
        self.is_train = bool(is_train)
        self.arg_names = list(arg_names) if arg_names is not None else None
        self.aux_names = list(aux_names) if aux_names is not None else None
        self.arg_avals = arg_avals
        self.aux_avals = aux_avals

    @property
    def has_avals(self):
        """Can the abstract-walk analyzers run: names and both aval maps
        present."""
        return (self.arg_names is not None and self.arg_avals is not None
                and self.aux_avals is not None)


def _avals_of(tensors, names):
    """name -> meta tensor of each bound tensor's shape and dtype; None if
    one is missing."""
    out = {}
    for n in names:
        t = tensors.get(n)
        if t is None:
            return None
        out[n] = torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
    return out


def executor_context(exe, is_train=False, plan="lowered"):
    """A :class:`GraphContext` over a bound Executor's plan for
    ``is_train``: ``plan="lowered"`` is the plan it runs (precision tier
    included), ``plan="structural"`` the standard pipeline's result, the
    fp32 graph the tier passes rewrite."""
    from ..graph_passes import Graph

    if plan == "structural":
        entries, heads, const_env = exe._structural_plan(is_train)
    else:
        entries, heads, const_env = exe._opt_plan(is_train)
    # the raw plan only where the pipeline made another one
    raw = None if entries is exe._plan else Graph(exe._plan, exe._head_names)
    return GraphContext(
        Graph(entries, heads, const_env), raw=raw, is_train=is_train,
        arg_names=exe._arg_names, aux_names=exe._aux_names,
        arg_avals=_avals_of(exe.arg_dict, exe._arg_names),
        aux_avals=_avals_of(exe.aux_dict, exe._aux_names))


def check_executor(exe, is_train=False):
    """The analyzers over a bound Executor's plan: ``Executor.check()``."""
    return analyze(executor_context(exe, is_train))


def precision_plan_executor(exe, is_train=False):
    """The :class:`numerics.CastPlan` of a bound Executor's structural plan:
    ``Executor.precision_plan()``."""
    from . import numerics as _numerics

    return _numerics.precision_plan(executor_context(exe, is_train, plan="structural"))


from . import graph_analyzers  # noqa: E402,F401  (registers the analyzers)
from . import numerics  # noqa: E402,F401  (registers the numerics analyzer)
