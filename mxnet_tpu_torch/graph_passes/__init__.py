"""Graph passes over the captured Symbol plan (counterpart of
``mxnet_tpu/graph_passes``).

The ``Executor`` runs the registered pipeline over its execution plan
before it evaluates a node, for inference and training plans alike:
constants folded once, duplicated subgraphs merged, eval Dropout deleted
and frozen BatchNorm made a per-channel affine, dead branches swept.  The
deployment precision tiers (:mod:`.precision`) are a second pass list that
runs after it, on inference plans only.

Surface:

* :func:`enabled`: the ``MXNET_GRAPH_PASSES`` gate (default on; ``0``
  runs the captured plan as it is).  The Executor reads it at bind, so one
  executor never mixes optimised and raw plans;
* :func:`register_pass`: decorator adding a pure ``Graph -> Graph``
  function to the pipeline; registration order is run order, and the
  (name, version) list is the pipeline's fingerprint;
* :func:`optimize`: run the pipeline over a captured plan; returns the
  optimised :class:`~.ir.Graph` and per-pass node counts and seconds;
* :func:`pipeline_fingerprint`: stable identity of the configured pipeline
  (with a precision tier's), or None when the gate is off.
"""
from __future__ import annotations

import time

from ..base import env_flag

__all__ = ["enabled", "register_pass", "pipeline", "pipeline_fingerprint",
           "optimize", "Graph", "PlanNode", "SynthOp",
           "capture"]

_PASSES = []  # [(name, version, fn)]: registration order is run order


def enabled():
    """``MXNET_GRAPH_PASSES`` gate, default on."""
    return env_flag("MXNET_GRAPH_PASSES", default="1")


def register_pass(name, version=1):
    """Register a pure ``fn(graph, is_train) -> graph`` pipeline pass.  Bump
    ``version`` on any change of behaviour: it enters the fingerprint."""
    def _reg(fn):
        _PASSES.append((str(name), int(version), fn))
        return fn
    return _reg


def pipeline():
    """The registered (name, version) pipeline, in run order."""
    return tuple((n, v) for n, v, _ in _PASSES)


def pipeline_fingerprint(tier=None):
    """Stable identity of the active pipeline, or None when the gate is off.
    With a precision ``tier`` ("bf16" / "int8") the tier's fingerprint is
    appended; without, the string is the standard pipeline's alone."""
    if not enabled():
        return None
    fp = "|".join("%s:%d" % (n, v) for n, v, _ in _PASSES)
    return fp if not tier else "%s|%s" % (fp, precision.tier_fingerprint(tier))


def optimize(plan, head_names, is_train):
    """Run the pipeline over a captured plan -> ``(graph, stats)``, where
    ``stats`` is ``{"mode": "train"|"eval", "nodes_pre", "nodes_post",
    "seconds", "passes": [{"pass", "version", "nodes_in", "nodes_out",
    "seconds"}, ...]}``."""
    g = Graph(plan, head_names)
    pre = g.n_nodes
    rows = []
    t_all = time.perf_counter()
    for name, version, fn in _PASSES:
        t0 = time.perf_counter()
        n_in = g.n_nodes
        g = fn(g, bool(is_train))
        rows.append({"pass": name, "version": version, "nodes_in": n_in,
                     "nodes_out": g.n_nodes,
                     "seconds": round(time.perf_counter() - t0, 6)})
    stats = {"mode": "train" if is_train else "eval",
             "nodes_pre": pre, "nodes_post": g.n_nodes,
             "seconds": round(time.perf_counter() - t_all, 6),
             "passes": rows}
    return g, stats


from .ir import Graph, PlanNode, SynthOp, capture  # noqa: E402
from . import passes  # noqa: E402,F401  (registers the standard pipeline)
from . import precision  # noqa: E402,F401  (the deployment tiers' own pass list)
