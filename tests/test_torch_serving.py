"""The port's serving Engine (mxnet_tpu_torch.serving) against the JAX
package's on the CPU: the tiny softmax MLP (8 -> 16 -> 4) and a relu
symbol for spatial buckets, written to files by the JAX package
(``Symbol.save``, ``nd.save``) and served by both.  The bucket ladder's
shape math equals the JAX package's case for case; the micro-batcher's edge
cases run deterministically (no flush window above 0.05 s is waited); a
seeded request stream through both Engines gives replies within rtol 1e-5
and one compile per ladder signature; the failure paths (timeout, cancel,
shed and recovery, model error, closed engine, input validation), the
device default, the refused gates of the planes not ported, the lock
discipline checker, and the two thread-safety repairs serving needs
(``context.full_fp32`` and the kernels' launch count).

Every wait has a bound and every engine is closed in a ``finally`` or a
``with``, so a hang fails a test instead of stalling a worker.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd
from mxnet_tpu import serving as jserving
from mxnet_tpu import symbol as jsym
from mxnet_tpu.test_utils import tiny_mlp_checkpoint as jax_tiny_mlp
from mxnet_tpu_torch import context, serving
from mxnet_tpu_torch.analysis import lockcheck
from mxnet_tpu_torch.ops import _build, kernels
from mxnet_tpu_torch.serving import (BucketLadder, MicroBatcher, Request,
                                     RequestCancelled, RequestTimeout,
                                     ServerBusy)
from mxnet_tpu_torch.test_utils import tiny_mlp_checkpoint

WAIT = 30.0                        # every result() wait's bound, seconds
STREAM = (1, 2, 3, 4, 5, 1, 3, 2, 4, 1, 2, 5)   # sample counts; 5 is direct
MLP_LADDER = (1, 2, 4)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX package's tiny MLP and relu symbols and the MLP's weights,
    as files both packages load."""
    d = tmp_path_factory.mktemp("serve")
    sym, params = jax_tiny_mlp()
    out = {"mlp": (str(d / "mlp-symbol.json"), str(d / "mlp.params"))}
    sym.save(out["mlp"][0])
    jnd.save(out["mlp"][1], params)
    relu = jsym.Activation(jsym.Variable("data"), act_type="relu", name="r")
    out["relu"] = (str(d / "relu-symbol.json"), None)
    relu.save(out["relu"][0])
    return out


def _stream(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 8).astype(np.float32) for n in STREAM]


def _serve(eng, xs):
    """Submit every request of ``xs`` to a stopped engine, start it, and
    return the replies in order."""
    reqs = [eng.submit({"data": x}) for x in xs]
    eng.start()
    return [r.result(WAIT) for r in reqs]


@pytest.fixture(scope="module")
def jax_ref(files):
    """The JAX Engine's warmup report, replies to the stream, stats and the
    spatial case's replies, built once."""
    sfile, pfile = files["mlp"]
    # each engine's stats are read after close(), which joins its loop
    with jserving.Engine(sfile, pfile, {"data": (8,)}, ladder=jserving.BucketLadder(MLP_LADDER),
                         max_wait_ms=2.0, start=False) as eng:
        report = eng.warmup()
        replies = _serve(eng, _stream())
    stats = eng.stats()
    with jserving.Engine(files["relu"][0], {}, {"data": (4,)}, ladder=jserving.BucketLadder(
            (1, 2), shape_buckets={"data": [(4,), (8,)]}), max_wait_ms=2.0,
            start=False) as sp:
        spatial = _serve(sp, _spatial_inputs())
    return dict(report=report, replies=replies, stats=stats, spatial=spatial,
                spatial_stats=sp.stats())


def _spatial_inputs():
    rng = np.random.RandomState(5)
    return [rng.randn(1, 3).astype(np.float32), rng.randn(2, 7).astype(np.float32),
            rng.randn(1, 4).astype(np.float32), rng.randn(1, 9).astype(np.float32)]


def _mlp_engine(files, **kw):
    sfile, pfile = files["mlp"]
    kw.setdefault("ladder", BucketLadder(MLP_LADDER))
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("max_queue", 64)
    kw.setdefault("device", "cpu")
    return serving.Engine(sfile, pfile, {"data": (8,)}, **kw)


def _zeros(n=1):
    return {"data": np.zeros((n, 8), np.float32)}


# -- bucket ladder: the JAX package's cases, through both ladders -------------
def _ladder_cases(s):
    """name -> function of a serving package giving a comparable result;
    the cases of tests/test_serving.py TestBucketing."""
    def signatures(lad, base):
        return [repr(b) for b in lad.signatures(base)]

    lad = s.BucketLadder((1, 2, 4, 8))
    spatial = s.BucketLadder((1, 2), shape_buckets={"data": [(3, 32, 32), (3, 64, 64)]})
    return {
        "pow2_8": lambda: s.pow2_ladder(8),
        "pow2_12": lambda: s.pow2_ladder(12),
        "pow2_1": lambda: s.pow2_ladder(1),
        "pow2_0": lambda: s.pow2_ladder(0),
        "pad_batch": lambda: [lad.pad_batch(n) for n in (1, 3, 8, 9)] + [lad.max_batch],
        "pad_shape_exact": lambda: [s.BucketLadder((1, 2)).pad_shape("data", d, (8,))
                                    for d in ((8,), (9,))],
        "pad_shape_spatial": lambda: [spatial.pad_shape("data", d, (3, 32, 32))
                                      for d in ((3, 20, 32), (3, 33, 10), (3, 65, 65))],
        "signatures_cartesian": lambda: signatures(
            s.BucketLadder((1, 4), shape_buckets={"data": [(16,), (32,)]}), {"data": (16,)}),
        "signatures_batch": lambda: signatures(s.BucketLadder((1, 2, 4)), {"data": (8,)}),
        "bucket_for": lambda: [repr(spatial.bucket_for({"data": (3, 64, 64)}, n))
                               for n in (1, 2, 3)],
        "mixed_rank": lambda: s.BucketLadder((1,), shape_buckets={"d": [(3, 4), (3, 4, 5)]}),
        "bad_sizes": lambda: s.BucketLadder((0, 2)),
    }


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the exception's type is part of the contract
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("case", sorted(_ladder_cases(serving)))
def test_ladder_math_equals_the_jax_package(case):
    got = _outcome(_ladder_cases(serving)[case])
    want = _outcome(_ladder_cases(jserving)[case])
    if got[0] == "ok" and not isinstance(got[1], (list, tuple)):
        got, want = ("ok", repr(got[1])), ("ok", repr(want[1]))
    assert got == want


# -- micro-batcher edge cases (no device, deterministic) ----------------------
def _req(n=1, shapes=None, deadline=None, direct=False):
    shapes = shapes or {"data": (8,)}
    inputs = {k: np.zeros((n,) + s, np.float32) for k, s in shapes.items()}
    return Request(inputs, n, shapes, deadline=deadline, direct=direct)


def test_batcher_empty_flush_on_deadline():
    """A wave of expired requests forms NO batch; the next live request
    goes through."""
    drops = []
    b = MicroBatcher(BucketLadder((1, 2, 4)), max_wait_s=5.0,
                     on_drop=lambda r, why: drops.append(why))
    try:
        expired = [_req(deadline=time.monotonic() - 0.01) for _ in range(2)]
        for r in expired:
            b.put(r)
        got = []
        t = threading.Thread(target=lambda: got.append(b.next_batch()), daemon=True)
        t.start()
        for r in expired:
            with pytest.raises(RequestTimeout):
                r.result(timeout=WAIT)
        assert drops == ["timeout", "timeout"] and not got
        live = _req(n=4)  # fills the top bucket: flushes at once
        b.put(live)
        t.join(timeout=WAIT)
        reqs, bucket = got[0]
        assert reqs == [live] and bucket.batch == 4
    finally:
        b.close()


def test_batcher_partial_flush_after_max_wait():
    b = MicroBatcher(BucketLadder((1, 2, 4)), max_wait_s=0.05)
    try:
        r = _req(n=1)
        b.put(r)
        t0 = time.monotonic()
        reqs, bucket = b.next_batch()
        assert reqs == [r] and bucket.batch == 1
        assert 0.04 <= time.monotonic() - t0 < 2.0
    finally:
        b.close()


def test_batcher_direct_alone_and_unservable_rejected():
    b = MicroBatcher(BucketLadder((1, 2, 4)), max_wait_s=5.0)
    try:
        small = _req(n=1)
        big = _req(n=9, direct=True)
        b.put(small)
        b.put(big)
        reqs, bucket = b.next_batch()  # no wait: direct bypasses batching
        assert reqs == [big] and bucket.direct and bucket.batch == 9
        with pytest.raises(ValueError, match="exceeds the top bucket"):
            b.put(_req(n=9, direct=False))
    finally:
        b.close()
    with pytest.raises(serving.EngineClosed):
        small.result(timeout=WAIT)


def test_batcher_never_mixes_shape_classes_nor_blocks_across_them():
    b = MicroBatcher(BucketLadder((1, 2, 4)), max_wait_s=5.0)
    try:
        young_head = _req(shapes={"data": (8,)})
        b.put(young_head)
        full = [_req(shapes={"data": (16,)}) for _ in range(4)]
        for r in full:
            b.put(r)
        t0 = time.monotonic()
        reqs, bucket = b.next_batch()
        # a full class-B batch leaves at once, behind a young class-A head
        assert reqs == full and bucket.sample_shape("data") == (16,)
        assert time.monotonic() - t0 < 1.0  # not the head's 5 s window
    finally:
        b.close()
    b = MicroBatcher(BucketLadder((1, 2, 4)), max_wait_s=0.01)
    try:
        ra, rb = _req(shapes={"data": (8,)}), _req(shapes={"data": (16,)})
        b.put(ra)
        b.put(rb)
        assert [b.next_batch()[0], b.next_batch()[0]] == [[ra], [rb]]
    finally:
        b.close()


def test_batcher_cancel_races_settle():
    r = _req()
    assert r.mark_dispatched() is True
    assert r.cancel() is False and r.cancelled() is False
    r2 = _req()
    assert r2.cancel() is True
    assert r2.mark_dispatched() is False
    b = MicroBatcher(BucketLadder((1, 2)), max_wait_s=0.01)
    try:
        r3 = _req()
        b.put(r3)
        assert r3.cancel() is True
        live = _req()
        b.put(live)
        assert b.next_batch()[0] == [live]
        with pytest.raises(RequestCancelled):
            r3.result(timeout=WAIT)
    finally:
        b.close()


# -- the Engine against the JAX Engine ----------------------------------------
def test_engine_stream_matches_the_jax_engine(files, jax_ref):
    """The same seeded stream (1-5 samples over ladder (1, 2, 4), the 5s
    dispatched directly): replies within rtol 1e-5 of the JAX Engine's;
    warmup builds every signature once, and the stream adds none but the
    direct one; the stats and warmup report keep the JAX keys."""
    eng = _mlp_engine(files, start=False)
    try:
        report = eng.warmup()
        assert [r["fresh"] for r in report] == [True] * len(MLP_LADDER)
        assert [sorted(r) for r in report] == [sorted(r) for r in jax_ref["report"]]
        for got, want in zip(report, jax_ref["report"]):
            for k in ("bucket", "fresh", "lower_s", "aot_compile_s", "cache",
                      "check_warnings", "precision_verdicts", "precision_tier"):
                assert got[k] == want[k], k
        n_sigs = len(eng.ladder.signatures(eng.sample_shapes))
        assert eng.stats()["compiles"] == n_sigs
        assert not any(r["fresh"] for r in eng.warmup())  # idempotent
        replies = _serve(eng, _stream())
    finally:
        eng.close()
    stats = eng.stats()
    assert len(replies) == len(jax_ref["replies"])
    for got, want, n in zip(replies, jax_ref["replies"], STREAM):
        assert got[0].shape == (n, 4) and got[0].dtype == want[0].dtype == np.float32
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert stats["compiles"] == n_sigs + 1  # the one direct signature
    for k in ("submitted", "completed", "direct", "failed", "in_flight", "compiles"):
        assert stats[k] == jax_ref["stats"][k], k
    assert set(jax_ref["stats"]) - set(stats) <= {"heartbeat_age_s", "busy_in_dispatch_s"}
    assert stats["buckets"]["direct"] == STREAM.count(5)


def test_spatial_buckets_match_the_jax_engine(files, jax_ref):
    """Samples of 3, 7, 4 and 9 values against buckets (4,) and (8,):
    trailing zero padding in, the bucket's shape out, and 9 dispatched
    directly."""
    eng = serving.Engine(files["relu"][0], {}, {"data": (4,)}, ladder=BucketLadder(
        (1, 2), shape_buckets={"data": [(4,), (8,)]}), max_wait_ms=2.0, device="cpu",
        start=False)
    try:
        replies = _serve(eng, _spatial_inputs())
    finally:
        eng.close()
    stats = eng.stats()
    for got, want in zip(replies, jax_ref["spatial"]):
        assert got[0].shape == want[0].shape
        np.testing.assert_array_equal(got[0], want[0])
    assert [r[0].shape[1] for r in replies] == [4, 8, 4, 9]
    assert len(stats["ladder"]) == 4
    assert stats["compiles"] == jax_ref["spatial_stats"]["compiles"]


def test_engine_takes_tensors_and_replies_with_host_arrays(files):
    x = np.random.RandomState(2).randn(3, 8).astype(np.float32)
    with _mlp_engine(files) as eng:
        a = eng.predict({"data": x})[0]
        b = eng.predict({"data": torch.from_numpy(x)})[0]
    assert isinstance(a, np.ndarray) and a.shape == (3, 4)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a.sum(1), 1.0, rtol=1e-6)


# -- failure paths -------------------------------------------------------------
def test_timeout_mid_queue_and_cancel_wake_the_batcher(files):
    """A queued request's deadline, and a cancel, act at once (not at the
    end of a 10 s flush window); the loop keeps serving."""
    with _mlp_engine(files, max_wait_ms=10000.0) as eng:
        req = eng.submit(_zeros(), timeout=0.05)
        t0 = time.monotonic()
        with pytest.raises(RequestTimeout):
            req.result(timeout=WAIT)
        assert time.monotonic() - t0 < 2.0
        req = eng.submit(_zeros())
        assert req.cancel() is True
        with pytest.raises(RequestCancelled):
            req.result(timeout=WAIT)
        assert time.monotonic() - t0 < 2.0
        assert eng.predict(_zeros(4))[0].shape == (4, 4)  # full bucket
        s = eng.stats()
    assert (s["timeouts"], s["cancelled"], s["in_flight"], s["queue_depth"]) == (1, 1, 0, 0)


def test_admission_shed_and_recovery(files):
    eng = _mlp_engine(files, max_queue=2, start=False)
    try:
        r1, r2 = eng.submit(_zeros()), eng.submit(_zeros())
        with pytest.raises(ServerBusy) as e:
            eng.submit(_zeros())
        assert e.value.code == 503 and isinstance(e.value, serving.ServingError)
        assert eng.stats()["shed"] == 1 and eng.stats()["submitted"] == 2
        eng.start()
        assert r1.result(WAIT)[0].shape == r2.result(WAIT)[0].shape == (1, 4)
        assert eng.stats()["completed"] == 2
    finally:
        eng.close()


def test_model_error_fails_its_batch_and_the_loop_serves_on(files):
    with _mlp_engine(files) as eng:
        orig = eng._assemble

        def bad_assemble(reqs, bucket):
            eng._assemble = orig
            raise RuntimeError("injected model failure")

        eng._assemble = bad_assemble
        req = eng.submit(_zeros())
        with pytest.raises(RuntimeError, match="injected"):
            req.result(WAIT)
        # the failed first forward built nothing: the retry counts it
        assert eng.stats()["compiles"] == 0 and eng.stats()["failed"] == 1
        assert eng.predict(_zeros())[0].shape == (1, 4)
        s = eng.stats()
    assert (s["compiles"], s["in_flight"]) == (1, 0)


def test_direct_cache_is_bounded(files):
    from mxnet_tpu_torch.serving.engine import _DIRECT_CACHE_MAX

    with _mlp_engine(files) as eng:
        for n in range(5, 5 + _DIRECT_CACHE_MAX + 2):  # all above the top bucket
            assert eng.predict(_zeros(n))[0].shape == (n, 4)
        s = eng.stats()
        assert s["compiles"] == s["direct"] == _DIRECT_CACHE_MAX + 2
        assert s["cache_size"] <= 1 + _DIRECT_CACHE_MAX
        eng.predict(_zeros(5))  # evicted: built again, counted again
        assert eng.stats()["compiles"] == _DIRECT_CACHE_MAX + 3


def test_closed_engine_and_stopped_loop(files):
    eng = _mlp_engine(files, start=False)
    try:
        with pytest.raises(serving.EngineClosed, match="not serving"):
            eng.predict(_zeros())
        req = eng.submit(_zeros())
    finally:
        eng.close()
    with pytest.raises(serving.EngineClosed):
        req.result(timeout=WAIT)
    with pytest.raises(serving.EngineClosed):
        eng.submit(_zeros())
    with pytest.raises(serving.EngineClosed):
        eng.start()


def test_input_validation(files):
    with _mlp_engine(files) as eng:
        with pytest.raises(ValueError, match="!= declared"):
            eng.submit({"bogus": np.zeros((1, 8), np.float32)})
        with pytest.raises(ValueError, match="leading sample dim"):
            eng.submit({"data": np.zeros((8,), np.float32)})
        with pytest.raises(ValueError, match="at least one sample"):
            eng.submit({"data": np.zeros((0, 8), np.float32)})
        with pytest.raises(ValueError, match="max_direct_batch"):
            eng.submit({"data": np.zeros((17, 8), np.float32)})
        assert eng.stats()["submitted"] == 0


def test_engine_default_device_is_cuda_and_raises_without_it(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sfile, pfile = files["mlp"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.Engine(sfile, pfile, {"data": (8,)}, start=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.ModelRegistry().register("m", sfile, pfile, {"data": (8,)})


@pytest.mark.parametrize("gate,value", [
    ("MXNET_TELEMETRY", "1"), ("MXNET_TRACE", "1"), ("MXNET_SLO", "p99<50ms"),
    ("MXNET_QUALITYPLANE", "1"), ("MXNET_COSTPLANE", "1"), ("MXNET_FLIGHTREC_DIR", "/x"),
    ("MXNET_OPS_PORT", "0"), ("MXNET_GRAPH_ANALYZERS", "1"), ("MXNET_AUTOTUNE", "1"),
    ("MXNET_AOT_CACHE", "/x"), ("MXNET_PRECISION_TIER", "bf16")])
def test_gates_of_planes_not_ported_raise(files, monkeypatch, gate, value):
    monkeypatch.setenv(gate, value)
    item = "A9.2" if gate in ("MXNET_AUTOTUNE", "MXNET_AOT_CACHE",
                              "MXNET_PRECISION_TIER") else "A10"
    with pytest.raises(NotImplementedError, match=r"%s \(%s\)" % (gate, item)):
        _mlp_engine(files, start=False)
    monkeypatch.setenv(gate, "0" if gate not in ("MXNET_FLIGHTREC_DIR", "MXNET_OPS_PORT",
                                                 "MXNET_AOT_CACHE", "MXNET_PRECISION_TIER")
                       else " ")
    _mlp_engine(files, start=False).close()  # off again: serves


def test_slo_monitor_argument_raises(files):
    with pytest.raises(NotImplementedError, match="slo_monitor"):
        _mlp_engine(files, start=False, slo_monitor=object())


def test_env_defaults(files, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_BATCH_LADDER", "2, 6,x")
    monkeypatch.setenv("MXNET_SERVE_MAX_QUEUE", "3")
    monkeypatch.setenv("MXNET_SERVE_TIMEOUT_MS", "250")
    eng = serving.Engine(*files["mlp"], {"data": (8,)}, device="cpu", start=False)
    try:
        assert eng.ladder.batch_sizes == (1, 2, 4, 8)  # malformed: the default
        assert eng.admission.max_queue == 3
        assert eng.admission.default_timeout_s == 0.25
        assert eng._batcher.max_wait_s == 0.005
    finally:
        eng.close()
    monkeypatch.setenv("MXNET_SERVE_BATCH_LADDER", "2,6")
    eng = serving.Engine(*files["mlp"], {"data": (8,)}, device="cpu", start=False)
    try:
        assert eng.ladder.batch_sizes == (2, 6) and eng.max_direct_batch == 24
    finally:
        eng.close()


# -- lock discipline (MXNET_LOCKCHECK) ------------------------------------------
@pytest.fixture
def lc_state():
    lockcheck.reset()
    yield
    lockcheck.reset()


def test_lockcheck_inversion_reentry_and_unguarded_mutation_raise(lc_state):
    a, b = lockcheck.CheckedLock("A"), lockcheck.CheckedLock("B")
    with a:
        with b:
            pass
    with b:
        with pytest.raises(lockcheck.LockDisciplineError, match="inversion"):
            with a:
                pass
    with a:
        with pytest.raises(lockcheck.LockDisciplineError, match="re-acquires"):
            a.acquire()
    mu = lockcheck.CheckedLock("mu")
    d = lockcheck.guard({"k": 1}, mu, "_stats")
    with mu:
        d["k"] = 2
    with pytest.raises(lockcheck.LockDisciplineError, match="unguarded"):
        d["k"] = 3
    with pytest.raises(lockcheck.LockDisciplineError, match="does not hold"):
        mu.release()
    assert [v.code for v in lockcheck.violations()] == [
        "lock-inversion", "lock-reentry", "lock-unguarded-mutation", "lock-bad-release"]


def test_engine_under_lockcheck_serves_a_stream_clean(files, lc_state, monkeypatch):
    """Off, the mutexes are plain locks; under MXNET_LOCKCHECK=1 three
    client threads' stream runs with no violation (one would raise in
    the device loop under pytest and fail a request)."""
    with _mlp_engine(files) as eng:
        assert type(eng._cache_mu) is type(threading.Lock())
    monkeypatch.setenv("MXNET_LOCKCHECK", "1")
    errors = []
    with _mlp_engine(files, ladder=BucketLadder((1, 2))) as eng:
        assert isinstance(eng._stats_mu, lockcheck.CheckedLock)
        eng.warmup()

        def client():
            try:
                for _ in range(5):
                    eng.submit(_zeros()).result(WAIT)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        eng.stats()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    stats = eng.stats()
    assert not errors and stats["completed"] == 15
    assert lockcheck.violations() == []


# -- the two thread-safety repairs ----------------------------------------------
def test_full_fp32_holds_across_interleaved_threads():
    """Thread A enters, B enters, A leaves: the flags stay off while B is
    inside, and come back only when both have left (a save / restore per
    block turned them back on under B)."""
    mm = torch.backends.cuda.matmul

    def flags():
        return (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
                mm.allow_bf16_reduced_precision_reduction)

    saved = flags()
    mm.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    mm.allow_bf16_reduced_precision_reduction = True
    steps = {k: threading.Event() for k in ("a_in", "b_in", "a_out")}
    seen = {}

    def a():
        with context.full_fp32():
            steps["a_in"].set()
            steps["b_in"].wait(WAIT)
        steps["a_out"].set()

    def b():
        steps["a_in"].wait(WAIT)
        with context.full_fp32():
            steps["b_in"].set()
            steps["a_out"].wait(WAIT)
            seen["b_after_a_left"] = flags()
        seen["after_both"] = flags()

    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
        assert seen == {"b_after_a_left": (False, False, False),
                        "after_both": (True, True, True)}
        with context.full_fp32():  # nested in one thread
            with context.full_fp32():
                pass
            assert flags() == (False, False, False)
        assert flags() == (True, True, True)
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved


class _YieldingCount:
    """A wrapper whose ``launches`` attribute gives the other threads a turn
    between its read and its write, as a free-threaded or preempted
    interpreter may: an unlocked ``+= 1`` then loses counts."""

    def __init__(self):
        self._n = 0

    @property
    def launches(self):
        n = self._n
        time.sleep(0)
        return n

    @launches.setter
    def launches(self, v):
        self._n = v


def test_launch_count_is_exact_under_threads(monkeypatch):
    class _Lib:
        @staticmethod
        def mx_stub(*args):
            return 0

    class _Stream:
        cuda_stream = 0

    probe = _YieldingCount()
    monkeypatch.setattr(_build, "library", lambda: _Lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: threading.Lock())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream)
    monkeypatch.setitem(kernels.KERNELS, "quantize_int8",
                        kernels.KERNELS["quantize_int8"]._replace(wrapper=probe))
    n_threads, n_launches = 8, 1000

    def launcher():
        for _ in range(n_launches):
            kernels._launch("quantize_int8", torch.device("cpu"), "mx_stub")

    threads = [threading.Thread(target=launcher) for _ in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert probe.launches == n_threads * n_launches


def test_tiny_mlp_checkpoint_equals_the_jax_package(files):
    tsym, tparams = tiny_mlp_checkpoint()
    jsym_, jparams = jax_tiny_mlp()
    assert tsym.tojson() == jsym_.tojson()
    assert list(tparams) == list(jparams)
    for k, v in jparams.items():
        np.testing.assert_array_equal(tparams[k].numpy(), v.asnumpy())
