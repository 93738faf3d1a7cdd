"""Startup warmup — take every bucket's build before traffic does
(counterpart of ``mxnet_tpu/serving/warmup.py``).

A cold serving engine pays each bucket's bind and plan build on the first
unlucky request that lands in it.  The warmup pass runs every ladder
signature on zeros at startup instead, so that after ``warmup_engine`` a
mixed-shape request stream adds **zero** new compiles (tested).

This is the JAX package's path with its compile cache off (the serial
zeros-forward loop); the ahead-of-time half (``MXNET_AOT_CACHE``) is
ROADMAP.md A9.2, and an Engine refuses to start under that gate.

    eng = serving.Engine(sym, params, {"data": (8,)}, start=False)
    report = eng.warmup()          # builds len(ladder.signatures()) plans
    eng.start()                    # begin serving, all-hot

Warmup respects the device-exclusion lock, so it is also safe on a live
engine (e.g. after enlarging the ladder) — buckets build between batches.
"""
from __future__ import annotations

import time

__all__ = ["warmup_engine"]


def warmup_engine(engine, buckets=None):
    """Build ``buckets`` (default: the engine's full ladder signature set)
    by forwarding zeros through each.  Returns the per-bucket report with
    the JAX package's keys: ``[{"bucket", "fresh", "compile_s", "lower_s",
    "aot_compile_s", "cache", "graph_nodes_pre", "graph_nodes_post",
    "check_warnings", "precision_verdicts", "precision_tier", "xla_flops",
    "xla_peak_bytes"}, ...]``.  ``fresh=False`` rows were already live
    (re-running warmup is free); ``compile_s`` is the bind and first
    forward; ``graph_nodes_*`` are the bucket plan's node counts before /
    after the graph passes (None with ``MXNET_GRAPH_PASSES=0``);
    ``precision_tier`` the tier the bucket serves.  The keys of the planes
    the port does not have read as the JAX package's do with their gates
    off: ``lower_s`` / ``aot_compile_s`` 0.0, ``cache``,
    ``check_warnings``, ``precision_verdicts`` and ``xla_*`` None.  The
    pass is also summarised in ``engine.stats()["warmup"]``."""
    if buckets is None:
        buckets = engine.ladder.signatures(engine.sample_shapes)
    t0 = time.perf_counter()
    report = [engine._warm_bucket(bucket) for bucket in buckets]
    engine._note_warmup(report, time.perf_counter() - t0)
    return report
