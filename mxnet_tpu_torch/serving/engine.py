"""The online inference Engine — queue -> micro-batcher -> device loop
(counterpart of ``mxnet_tpu/serving/engine.py``).

* ``submit()`` (any thread) validates the request, stamps its deadline,
  and enqueues through the admission gate — overload is shed HERE with
  ``ServerBusy``, never buffered into unbounded latency;
* ONE device-loop thread pulls shape-bucketed batches from the
  ``MicroBatcher``, so the engine's forwards never contend with each
  other; model failures fail that batch's requests and the loop keeps
  serving;
* a **signature cache** maps each ladder bucket to a ``Predictor``
  specialised via ``Predictor.with_shapes`` (the weights are shared
  tensors, not copies) — the whole traffic mix binds and builds exactly
  ``len(ladder.signatures())`` plans, and ``warmup()`` takes those builds
  at startup instead of on the first unlucky request.

The port's "compile" of a bucket is its bind plus its first forward, which
builds the inference plan (and, for a precision tier, reads the weights to
the host).  The replies are copied to the host as numpy arrays, as the
JAX engine's ``asnumpy()`` hands them back.

Defaults come from ``MXNET_SERVE_*``.  The gated planes the JAX engine
calls (telemetry, tracing, SLO monitor, flight recorder, ops server,
quality and cost planes) are not ported: constructing an Engine while one
of their gates is set raises (ROADMAP.md A10), as do the gates of the
compile cache, the tuned ladder and the bind-time precision tier (A9.2).
"""
from __future__ import annotations

import collections
import os
import threading
import time

import numpy as np
import torch

from ..base import env_flag
from ..predictor import Predictor
from .admission import AdmissionController, EngineClosed
from .batcher import MicroBatcher, Request
from .bucketing import BucketLadder, _volume

__all__ = ["Engine", "refuse_unported_gates"]

# Direct-dispatch (oversize) signatures are client-controlled, so their
# cache must be bounded or a shape-varying stream grows plans without
# limit; ladder signatures are finite by construction and stay pinned.
_DIRECT_CACHE_MAX = 8

# env gates of the JAX engine's planes that the port does not have, with
# the ROADMAP item that brings each; a flag gate is on by the env_flag
# rule, a value gate when it is not blank
_UNPORTED_FLAGS = {"MXNET_TELEMETRY": "A10", "MXNET_TRACE": "A10", "MXNET_SLO": "A10",
                   "MXNET_QUALITYPLANE": "A10", "MXNET_COSTPLANE": "A10",
                   "MXNET_GRAPH_ANALYZERS": "A10", "MXNET_AUTOTUNE": "A9.2"}
_UNPORTED_VALUES = {"MXNET_FLIGHTREC_DIR": "A10", "MXNET_OPS_PORT": "A10",
                    "MXNET_AOT_CACHE": "A9.2", "MXNET_PRECISION_TIER": "A9.2"}


def refuse_unported_gates(what, slo_monitor=None):
    """Raise NotImplementedError, naming the ROADMAP items, when a gate of a
    plane the port does not have is set (or ``slo_monitor`` is given): the
    JAX package would serve differently under it, and the port never
    ignores one silently."""
    on = ["%s (%s)" % (g, item) for g, item in _UNPORTED_FLAGS.items() if env_flag(g)]
    on += ["%s (%s)" % (g, item) for g, item in _UNPORTED_VALUES.items()
           if os.environ.get(g, "").strip()]
    if slo_monitor is not None:
        on.append("slo_monitor= (A10)")
    if on:
        raise NotImplementedError(
            "%s: %s not ported (ROADMAP.md A10: telemetry, tracing, SLO, flight "
            "recorder, ops server, quality and cost planes; A9.2: compile cache, "
            "tuned ladder, bind-time precision tier); unset to serve"
            % (what, ", ".join(on)))


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return float(default)


def _env_ladder():
    """MXNET_SERVE_BATCH_LADDER, never-crash: any malformed value — non-
    numeric, zero/negative rungs, empty — falls back to the default."""
    raw = os.environ.get("MXNET_SERVE_BATCH_LADDER", "1,2,4,8")
    try:
        sizes = tuple(int(x) for x in raw.replace(" ", "").split(",") if x)
    except ValueError:
        sizes = ()
    sizes = tuple(s for s in sizes if s > 0)
    return sizes or (1, 2, 4, 8)


def _to_host(t):
    """A device output -> numpy, as the JAX engine's ``asnumpy()``; a
    bfloat16 output as float32 (numpy has no bfloat16; the values are
    exact).  The precision tiers' heads are float32 in both packages."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


class Engine:
    """Serve a (symbol, params) checkpoint to concurrent callers.

    Parameters
    ----------
    symbol, params : as ``Predictor`` (Symbol/json-path, dict/params-path).
    sample_shapes : dict
        name -> PER-SAMPLE shape (no batch dim).  Request arrays always
        carry a leading sample-count dim: ``submit({"data": x})`` with
        ``x.shape == (n,) + sample_shapes["data"]``.
    ladder : BucketLadder, optional
        Defaults to ``BucketLadder(MXNET_SERVE_BATCH_LADDER)`` — batch
        bucketing only.  Pass ``shape_buckets`` in your own ladder for
        spatial bucketing (trailing dims are zero-padded up to the bucket,
        batch rows are sliced back out).
    max_wait_ms / max_queue / timeout_ms :
        Partial-batch flush deadline, admission queue bound, default
        per-request deadline (0 = none).  Env defaults:
        ``MXNET_SERVE_MAX_WAIT_MS`` (5), ``MXNET_SERVE_MAX_QUEUE`` (256),
        ``MXNET_SERVE_TIMEOUT_MS`` (0).
    device : None, str or torch.device
        As ``Predictor``: None is CUDA and raises without a card.
    max_direct_batch : int
        Sample-count cap for direct-dispatch (oversize) requests, default
        4x the top bucket; beyond it submit() raises ValueError and the
        client must chunk (one huge request would stall the single device
        loop for everyone).
    start : bool
        Start the device loop immediately (default).  ``start=False`` lets
        tests and warmup-first deployments queue/build before serving.
    proto : Predictor, optional
        Serve an ALREADY-BUILT predictor instead of loading
        ``symbol``/``params`` (which may then be None): the buckets
        specialise off it via ``with_shapes``, sharing its weight tensors
        and carrying its precision tier (the model registry's replicas).
    slo_monitor :
        Not ported (A10): anything but None raises.
    """

    def __init__(self, symbol, params, sample_shapes, ladder=None,
                 max_wait_ms=None, max_queue=None, timeout_ms=None,
                 dtype="float32", device=None, output_names=None, name="serve",
                 start=True, max_direct_batch=None, proto=None,
                 slo_monitor=None):
        refuse_unported_gates("serving.Engine", slo_monitor)
        self.name = name
        self.sample_shapes = {str(k): tuple(int(d) for d in v)
                              for k, v in sample_shapes.items()}
        if ladder is None:
            ladder = BucketLadder(_env_ladder())
        self.ladder = ladder
        if max_wait_ms is None:
            max_wait_ms = _env_float("MXNET_SERVE_MAX_WAIT_MS", 5.0)
        if max_queue is None:
            max_queue = int(_env_float("MXNET_SERVE_MAX_QUEUE", 256))
        if timeout_ms is None:
            timeout_ms = _env_float("MXNET_SERVE_TIMEOUT_MS", 0.0)
        self.max_direct_batch = (int(max_direct_batch)
                                 if max_direct_batch is not None
                                 else 4 * self.ladder.max_batch)
        self.admission = AdmissionController(
            max_queue=max_queue,
            default_timeout_s=timeout_ms / 1000.0 if timeout_ms > 0 else None)
        self._batcher = MicroBatcher(self.ladder, max_wait_s=max_wait_ms / 1000.0,
                                     on_drop=self._on_drop)
        # proto predictor: loads the checkpoint ONCE; every bucket
        # specialises off it via with_shapes (shared weights).  It is
        # seeded into the cache as its own bucket's entry — compile
        # accounting is by the separate _compiled set (first forward), so
        # seeding doesn't hide that bucket's one compile.
        proto_bucket = self.ladder.signatures(self.sample_shapes)[0]
        if proto is not None:
            self._proto = proto.with_shapes(proto_bucket.input_shapes())
        else:
            self._proto = Predictor(symbol, params, proto_bucket.input_shapes(),
                                    device=device, output_names=output_names,
                                    dtype=dtype)
        self._cache = {proto_bucket.key: self._proto}  # ladder sigs, pinned
        self._direct_cache = collections.OrderedDict()  # one-offs, LRU
        self._compiled = set()      # signatures past their first forward
        # no one of the three is taken while another is held
        self._cache_mu = threading.Lock()
        self._device_mu = threading.Lock()  # device loop + warmup exclusion
        self._stats_mu = threading.Lock()
        # "shed" lives on the AdmissionController (stats() merges it in)
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "timeouts": 0, "cancelled": 0,
                       "direct": 0, "batches": 0, "compiles": 0,
                       "cache_hits": 0, "in_flight": 0}
        # per-bucket dispatch accounting: label -> [batches, requests,
        # padding_waste_sum] (stats()["bucket_stats"] derives means)
        self._bucket_stats = {}
        self._warmup = None  # last warmup pass summary (stats() block)
        self._thread = None
        self._closed = False
        # lock-discipline checking (MXNET_LOCKCHECK=1): swap the three
        # mutexes for order-recording CheckedLocks and wrap their owned
        # containers.  Off, the locks stay plain threading.Locks and the
        # analysis module is never imported.
        if env_flag("MXNET_LOCKCHECK"):
            from ..analysis import lockcheck

            lockcheck.instrument_engine(self)
        if start:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Start (or restart after ``start=False``) the device loop."""
        if self._closed:
            raise EngineClosed("engine is closed")
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-serve-%s" % self.name,
                daemon=True)
            self._thread.start()
        return self

    def close(self):
        """Drain-free shutdown: pending requests fail with EngineClosed,
        the device loop exits after its current batch."""
        self._closed = True
        self._batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- request path --------------------------------------------------------
    def submit(self, inputs, timeout=None, klass=None):
        """Enqueue one request; returns a future-like ``Request``.

        ``inputs``: dict name -> array (numpy, or a tensor) with leading
        sample-count dim n>=1.  ``timeout``: seconds until the request is
        dropped if still queued (overrides the engine default).
        ``klass``: the request's class label (the router passes its
        priority), kept on the request.  Raises ``ServerBusy`` when the
        queue is at capacity, ``EngineClosed`` after ``close()``.
        Completed requests carry the serving precision tier as
        ``req.tier``.
        """
        arrays, n, bucket_shapes, direct = self._classify(inputs)
        req = Request(arrays, n, bucket_shapes,
                      deadline=self.admission.deadline(timeout), direct=direct)
        req.klass = klass
        # stamp stats BEFORE enqueueing (rolled back on rejection): once the
        # request is in the queue the device loop may complete it instantly,
        # and decrement-before-increment would publish in_flight = -1
        with self._stats_mu:
            self._stats["submitted"] += 1
            self._stats["in_flight"] += 1
            if direct:
                self._stats["direct"] += 1
        try:
            self._batcher.put(req, admit=self.admission.check)
        except Exception:
            with self._stats_mu:
                self._stats["submitted"] -= 1
                self._stats["in_flight"] -= 1
                if direct:
                    self._stats["direct"] -= 1
            raise
        return req

    def predict(self, inputs, timeout=None, klass=None):
        """Synchronous convenience: submit + wait -> list of output arrays
        (each sliced to this request's n rows on the batch dim).

        ``timeout`` bounds QUEUE time (the admission deadline).  Deadlines
        are enforced by the device loop, so a synchronous wait against an
        engine with no running loop would hang forever — that misuse
        fails fast here instead."""
        if self._thread is None or not self._thread.is_alive():
            raise EngineClosed(
                "engine is not serving (start() not called, or the device "
                "loop terminated) — a synchronous predict() would never "
                "complete")
        return self.submit(inputs, timeout=timeout, klass=klass).result(None)

    def _classify(self, inputs):
        """Validate one request -> (np arrays, n, padded shape class,
        direct?).  Oversize (n above the top bucket, or a sample shape no
        bucket dominates) goes to the direct-dispatch path with its exact
        shapes as a one-off signature."""
        names = set(self.sample_shapes)
        got = {str(k) for k in inputs}
        if got != names:
            raise ValueError("inputs %s != declared %s"
                             % (sorted(got), sorted(names)))
        arrays, n = {}, None
        for name, a in inputs.items():
            if isinstance(a, torch.Tensor):
                a = _to_host(a.detach())
            a = np.asarray(a)
            want_rank = len(self.sample_shapes[name]) + 1
            if a.ndim != want_rank:
                raise ValueError(
                    "input %r must carry a leading sample dim: got shape %s "
                    "for sample shape %s" % (name, a.shape,
                                             self.sample_shapes[name]))
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError("inconsistent sample counts across inputs")
            arrays[name] = a
        if n < 1:
            raise ValueError("request must carry at least one sample")
        if n > self.max_direct_batch:
            raise ValueError(
                "request with %d samples exceeds max_direct_batch=%d "
                "(one oversize request would stall the single device loop "
                "for everyone; chunk the request client-side)"
                % (n, self.max_direct_batch))
        padded = {}
        direct = n > self.ladder.max_batch
        for name, a in arrays.items():
            p = self.ladder.pad_shape(name, a.shape[1:],
                                      self.sample_shapes[name])
            if p is None:
                direct = True
                break
            padded[name] = p
        if direct:
            padded = {name: tuple(a.shape[1:])
                      for name, a in arrays.items()}
        return arrays, n, padded, direct

    # -- device loop ---------------------------------------------------------
    def _loop(self):
        reqs = ()
        try:
            while True:
                item = self._batcher.next_batch()
                if item is None:
                    return
                reqs, bucket = item
                if not reqs:
                    continue
                try:
                    self._dispatch(reqs, bucket)
                except Exception as e:  # degrade, never crash the loop
                    with self._stats_mu:
                        self._stats["failed"] += len(reqs)
                        self._stats["in_flight"] -= len(reqs)
                    for req in reqs:
                        if not req.done():
                            req.set_error(e)
                reqs = ()
        except BaseException as e:
            # loop is dying (batcher invariant broke, or a BaseException
            # like SystemExit escaped _dispatch): fail the CURRENT batch —
            # already popped from the queue, so batcher.close() alone would
            # leave its waiters blocked forever — then fail the queue
            undone = [r for r in reqs if not r.done()]
            with self._stats_mu:
                self._stats["failed"] += len(undone)
                self._stats["in_flight"] -= len(undone)
            for req in undone:
                req.set_error(EngineClosed(
                    "device loop terminated: %r" % (e,)))
            self._closed = True
            self._batcher.close()
            raise

    def _dispatch(self, reqs, bucket):
        label = self._bucket_label(bucket)
        pred, fresh = self._predictor_for(bucket)
        try:
            arrays = self._assemble(reqs, bucket)
            with self._device_mu:
                outs = [_to_host(o) for o in pred.forward(**arrays)]  # sync
        except Exception:
            self._uncompile(bucket, fresh)
            raise
        if fresh:
            self._note_compile()
        waste = self._padding_waste(reqs, bucket)
        # stats BEFORE the result events, as the batcher's drops: a caller
        # that wakes on result() never reads a stale count
        with self._stats_mu:
            self._stats["completed"] += len(reqs)
            self._stats["in_flight"] -= len(reqs)
            self._stats["batches"] += 1
            ent = self._bucket_stats.get(label)
            if ent is None:
                ent = self._bucket_stats[label] = [0, 0, 0.0]
            ent[0] += 1
            ent[1] += len(reqs)
            ent[2] += waste
        served_tier = pred.precision_tier
        off = 0
        for req in reqs:
            # the tier label is stamped BEFORE the result event, so a waiter
            # that wakes on result() reads which twin actually served it
            req.tier = served_tier
            req.set_result([o[off:off + req.n] for o in outs])
            off += req.n

    @staticmethod
    def _padding_waste(reqs, bucket):
        """Fraction of padded input elements that carry no request data
        (batch-slot padding + spatial padding combined)."""
        real = sum(r.n * _volume(a.shape[1:])
                   for r in reqs for a in r.inputs.values())
        padded = sum(bucket.batch * _volume(s) for _, s in bucket.shapes)
        return 1.0 - real / padded if padded else 0.0

    def _assemble(self, reqs, bucket):
        """The batch's inputs: each request's rows at its offset, zeros in
        every padded row and spatial margin."""
        arrays = {}
        for name, bshape in bucket.shapes:
            out = np.zeros((bucket.batch,) + bshape, np.float32)
            off = 0
            for req in reqs:
                a = req.inputs[name]
                region = (slice(off, off + req.n),) + tuple(
                    slice(0, d) for d in a.shape[1:])
                out[region] = a
                off += req.n
            arrays[name] = out
        return arrays

    # -- signature cache / warmup --------------------------------------------
    def _predictor_for(self, bucket):
        """-> (Predictor, fresh).  ``fresh`` marks a signature that has not
        taken its first forward yet: the forward about to run builds its
        plan, the one compile this signature pays.  Ladder signatures are
        pinned; direct (oversize, client-shaped) signatures live in a
        bounded LRU — an evicted one rebuilds on return, counted again."""
        with self._cache_mu:
            if bucket.direct:
                pred = self._direct_cache.get(bucket.key)
                if pred is None:
                    pred = self._proto.with_shapes(bucket.input_shapes())
                    self._direct_cache[bucket.key] = pred
                    while len(self._direct_cache) > _DIRECT_CACHE_MAX:
                        old, _ = self._direct_cache.popitem(last=False)
                        self._compiled.discard(old)
                else:
                    self._direct_cache.move_to_end(bucket.key)
            else:
                pred = self._bind_bucket(bucket)
            fresh = bucket.key not in self._compiled
            if fresh:
                self._compiled.add(bucket.key)
        if not fresh:
            with self._stats_mu:
                self._stats["cache_hits"] += 1
        return pred, fresh

    @staticmethod
    def _bucket_label(bucket):
        """Stats label.  Direct signatures are client-shaped — per
        exact-shape labels would grow without bound, so they all
        aggregate under one label."""
        return "direct" if bucket.direct else repr(bucket)

    def _note_compile(self):
        with self._stats_mu:
            self._stats["compiles"] += 1

    def _uncompile(self, bucket, fresh):
        """A fresh signature whose first forward FAILED built nothing —
        un-mark it so the successful retry's build is counted."""
        if fresh:
            with self._cache_mu:
                self._compiled.discard(bucket.key)

    def _bind_bucket(self, bucket):
        """Bind (or fetch) a LADDER bucket's Predictor (caller holds
        ``_cache_mu``) without touching the compile accounting: a rebind
        over the shared weight tensors."""
        pred = self._cache.get(bucket.key)
        if pred is None:
            pred = self._proto.with_shapes(bucket.input_shapes())
            self._cache[bucket.key] = pred
        return pred

    def _warm_bucket(self, bucket):
        """Compile one bucket by running it on zeros (device-exclusive);
        ``compile_s`` covers bind + first forward, as live dispatch.  The
        row keeps the JAX engine's keys; those of its ahead-of-time cache,
        analyzer and cost planes read as they do with their gates off."""
        t0 = time.perf_counter()
        pred, fresh = self._predictor_for(bucket)
        try:
            with self._device_mu:
                outs = pred.forward(
                    **{n: np.zeros((bucket.batch,) + s, np.float32)
                       for n, s in bucket.shapes})
                for o in outs:
                    _to_host(o)
        except Exception:
            self._uncompile(bucket, fresh)
            raise
        dt = time.perf_counter() - t0
        if fresh:
            self._note_compile()
        # the graph passes' result for this bucket's inference plan: nodes
        # captured vs nodes run — None with MXNET_GRAPH_PASSES=0
        ps = pred.pass_stats().get("eval")
        return {"bucket": repr(bucket), "fresh": fresh,
                "compile_s": round(dt, 4) if fresh else 0.0,
                "lower_s": 0.0, "aot_compile_s": 0.0, "cache": None,
                "graph_nodes_pre": ps["nodes_pre"] if ps else None,
                "graph_nodes_post": ps["nodes_post"] if ps else None,
                "check_warnings": None, "precision_verdicts": None,
                "precision_tier": pred.precision_tier,
                "xla_flops": None, "xla_peak_bytes": None}

    def _note_warmup(self, report, total_s):
        """Record the warmup pass for ``stats()["warmup"]``."""
        tiers = {r.get("precision_tier") or "fp32" for r in report}
        with self._stats_mu:
            self._warmup = {
                "buckets": len(report),
                "fresh": sum(1 for r in report if r["fresh"]),
                "cache_hits": 0, "cache_misses": 0,
                "lower_s": 0.0,
                "compile_s": round(sum(r["compile_s"] for r in report), 4),
                "aot_compile_s": 0.0,
                "check_warnings": None, "precision_verdicts": None,
                "precision_tier": (set(tiers).pop() if len(tiers) == 1
                                   else "mixed"),
                "precision_tiers": {
                    r["bucket"]: r.get("precision_tier") or "fp32"
                    for r in report},
                "xla_flops": None, "xla_peak_bytes": None,
                "total_s": round(total_s, 4)}

    def warmup(self, buckets=None):
        """Pre-build the bucket ladder (see ``serving.warmup``) ->
        per-bucket report list."""
        from .warmup import warmup_engine

        return warmup_engine(self, buckets=buckets)

    # -- introspection -------------------------------------------------------
    def _on_drop(self, req, reason):
        with self._stats_mu:
            if reason == "timeout":
                self._stats["timeouts"] += 1
            elif reason == "cancelled":
                self._stats["cancelled"] += 1
            if reason in ("timeout", "cancelled", "closed"):
                self._stats["in_flight"] -= 1

    def stats(self):
        """Point-in-time engine counters.  The keys of the JAX engine's
        planes (``slo``, ``costplane``, ``quality``) read None, as there
        with their gates off."""
        with self._stats_mu:
            out = dict(self._stats)
            out["buckets"] = {k: v[0] for k, v in self._bucket_stats.items()}
            out["bucket_stats"] = {
                k: {"batches": v[0], "requests": v[1],
                    "padding_waste": round(v[2] / v[0], 4) if v[0] else 0.0}
                for k, v in self._bucket_stats.items()}
            out["warmup"] = dict(self._warmup) if self._warmup else None
        out["shed"] = self.admission.shed_total
        out["queue_depth"] = self._batcher.depth()
        sigs = self.ladder.signatures(self.sample_shapes)
        with self._cache_mu:
            out["cache_size"] = len(self._cache) + len(self._direct_cache)
            tier_map = {repr(b): self._cache[b.key].precision_tier
                        for b in sigs if b.key in self._cache}
        out["ladder"] = [repr(b) for b in sigs]
        # the tier each bound ladder bucket serves, and one summary value
        # ("mixed" when they differ)
        out["precision_tiers"] = tier_map
        tiers = set(tier_map.values())
        out["precision_tier"] = (tiers.pop() if len(tiers) == 1
                                 else "mixed" if tiers
                                 else self._proto.precision_tier)
        out["slo"] = out["costplane"] = out["quality"] = None
        return out
