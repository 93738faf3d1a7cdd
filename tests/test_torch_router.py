"""The port's model registry, degrade policy and Router
(mxnet_tpu_torch.serving) against the JAX package's on the CPU, over the
tiny softmax MLP written to files by the JAX package: twins share the
base's weight tensors and carry their tiers; an int8 tier without a
calibration is refused; ``seed_trace`` calibrates to the JAX package's
table; both packages' policies take the same actions on the same signal
sequences; routing labels, forced downgrade, per-priority sheds and a
pressure-driven degrade and restore; and each tier pool's replies against
the JAX Router's: fp32 within rtol 1e-5, bf16 at the tier's tolerance,
int8 (the JAX table carried across) within rtol 1e-5.

Every wait has a bound and every router is closed in a ``finally``.
"""
import numpy as np
import pytest

from mxnet_tpu import nd as jnd
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import policy as jpolicy
from mxnet_tpu.test_utils import tiny_mlp_checkpoint as jax_tiny_mlp
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.graph_passes import precision
from mxnet_tpu_torch.serving import policy as tpolicy

WAIT = 30.0
TIERS = ("fp32", "bf16", "int8")
LADDER = (1, 2, 4)


def _x(n=1, seed=0):
    return np.random.RandomState(seed).randn(n, 8).astype(np.float32)


SEED_TRACE = [{"data": _x(2, seed=10 + s)} for s in range(3)]
INPUTS = [_x(n, seed=20 + n) for n in (1, 3, 4)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("router")
    sym, params = jax_tiny_mlp()
    sfile, pfile = str(d / "mlp-symbol.json"), str(d / "mlp.params")
    sym.save(sfile)
    jnd.save(pfile, params)
    return sfile, pfile


@pytest.fixture(scope="module")
def jax_ref(files):
    """The JAX registry's int8 calibration from SEED_TRACE and each tier
    pool's replies to INPUTS through the JAX Router, built once."""
    model = jserving.ModelRegistry().register(
        "m", *files, {"data": (8,)}, tiers=TIERS, seed_trace=SEED_TRACE,
        ladder=jserving.BucketLadder(LADDER), max_wait_ms=2.0)
    r = jserving.Router(model, policy="degrade", name="jax-ref")
    try:
        replies = {t: [r.engines(t)[0].predict({"data": x})[0] for x in INPUTS]
                   for t in TIERS}
    finally:
        r.close()
    return dict(table=model.calibration, replies=replies)


def _register(files, tiers=("fp32", "bf16"), reg=None, **kw):
    kw.setdefault("ladder", serving.BucketLadder(LADDER))
    kw.setdefault("max_wait_ms", 2.0)
    kw.setdefault("max_queue", 64)
    return (reg or serving.ModelRegistry()).register(
        "m", *files, {"data": (8,)}, tiers=tiers, device="cpu", **kw)


@pytest.fixture(scope="module")
def model(files, jax_ref):
    """The port's three-tier model, the JAX table carried across."""
    t = jax_ref["table"]
    return _register(files, TIERS, calibration=precision.CalibrationTable(t.ranges, t.batches))


# -- model registry --------------------------------------------------------------
def test_twins_share_the_weights_and_carry_their_tiers(model):
    twins = {t: model.twin(t) for t in TIERS}
    assert {t: p.precision_tier for t, p in twins.items()} == dict(zip(TIERS, TIERS))
    assert model.native_tier == "fp32"
    for k, v in twins["fp32"]._arg_params.items():
        assert all(p._arg_params[k].data_ptr() == v.data_ptr() for p in twins.values()), k
    eng = model.build_engine("bf16", start=False)
    try:
        bound = eng._proto._exec.arg_dict["fc1_weight"]
        assert bound.data_ptr() == twins["fp32"]._arg_params["fc1_weight"].data_ptr()
        assert eng.stats()["precision_tier"] == "bf16" and eng.name == "m-bf16"
    finally:
        eng.close()
    with pytest.raises(KeyError):
        serving.ModelRegistry().get("m")


def test_registration_validates_tiers_and_refuses_int8_uncalibrated(files):
    for tiers in (("fp32", "fp8"), ("fp32", "bf16", "bf16"), ()):
        with pytest.raises(ValueError):
            _register(files, tiers)
    with pytest.raises(ValueError, match="calibration= or seed_trace="):
        _register(files, ("fp32", "int8"))
    reg = serving.ModelRegistry()
    _register(files, reg=reg)
    assert reg.names() == ["m"]
    reg.unregister("m")
    assert reg.names() == []


def test_seed_trace_gives_the_jax_calibration_table(files, jax_ref):
    got = _register(files, ("fp32", "int8"), seed_trace=SEED_TRACE).calibration
    want = jax_ref["table"]
    assert got.batches == want.batches == len(SEED_TRACE)
    assert sorted(got.ranges) == sorted(want.ranges)
    for k, (lo, hi) in want.ranges.items():
        np.testing.assert_allclose(got.ranges[k], (lo, hi), rtol=1e-6, atol=1e-7, err_msg=k)


# -- replies per tier against the JAX Router -------------------------------------
@pytest.mark.parametrize("tier", TIERS)
def test_tier_replies_match_the_jax_router(model, jax_ref, tier):
    tol = dict(rtol=1e-5, atol=1e-6) if tier != "bf16" else precision.tier_tolerance("bf16")
    r = serving.Router(model, policy="degrade", name="rt-%s" % tier)
    try:
        reqs = [r.engines(tier)[0].submit({"data": x}) for x in INPUTS]
        got = [q.result(WAIT)[0] for q in reqs]
        assert [q.tier for q in reqs] == [tier] * len(INPUTS)
    finally:
        r.close()
    for g, w in zip(got, jax_ref["replies"][tier]):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


# -- routing ------------------------------------------------------------------------
def test_priorities_route_native_and_label_the_tier(model):
    r = serving.Router(model, policy="degrade", name="rt-route")
    try:
        req = r.submit({"data": _x()}, priority="paid")
        assert req.result(WAIT)[0].shape == (1, 4)
        assert (req.priority, req.routed_tier, req.tier) == ("paid", "fp32", "fp32")
        assert req.engine_name == "rt-route-fp32-0"
        req = r.submit({"data": _x()}, klass="best_effort")
        req.result(WAIT)
        assert (req.priority, req.tier) == ("best_effort", "fp32")
        req = r.submit({"data": _x()}, klass="37")  # unknown: the default
        req.result(WAIT)
        assert req.priority == "best_effort"
        st = r.stats()
    finally:
        r.close()
    assert st["router"]["priorities"]["paid"]["requests"] == 1
    assert st["router"]["priorities"]["best_effort"]["requests"] == 2
    assert st["downgrades"] == 0 and st["precision_tier"] == "fp32"
    assert st["router"]["route"] == {"paid": "fp32", "best_effort": "fp32"}
    assert (st["slo"], st["quality"]) == (None, None)


def test_forced_downgrade_serves_the_cheap_twin(model):
    r = serving.Router(model, policy="degrade", name="rt-dg")
    try:
        with r._mu:
            r._route["best_effort"] = r._degrade_tier
        req = r.submit({"data": _x()}, priority="best_effort")
        req.result(WAIT)
        assert (req.routed_tier, req.tier) == ("bf16", "bf16")
        req = r.submit({"data": _x()}, priority="paid")
        req.result(WAIT)
        assert req.tier == "fp32"
        st = r.stats()["router"]["priorities"]
    finally:
        r.close()
    assert (st["best_effort"]["downgrades"], st["paid"]["downgrades"]) == (1, 0)


def test_sheds_counted_per_priority(files):
    m = _register(files, max_queue=1)
    r = serving.Router(m, policy="shed", name="rt-shed", start=False)
    try:
        first = r.submit({"data": _x()}, priority="best_effort")
        with pytest.raises(serving.ServerBusy):
            r.submit({"data": _x()}, priority="best_effort")
        st = r.stats()
        assert st["router"]["priorities"]["best_effort"]["sheds"] == 1 == st["sheds"]
        assert st["router"]["priorities"]["paid"]["sheds"] == 0 and st["shed"] == 1
        first.cancel()
    finally:
        r.close()


def test_pressure_degrades_best_effort_and_hysteresis_restores(files):
    """Queued paid work fills half the native queue: a tick degrades
    best_effort (never paid), which is then served by bf16; once the queue
    drains, the route holds for hold_s and then comes back."""
    m = _register(files, max_queue=4)
    cfg = serving.PolicyConfig(mode="degrade", hold_s=1.0, pressure=0.5)
    r = serving.Router(m, policy=cfg, name="rt-tick", start=False)
    try:
        paid = [r.submit({"data": _x()}, priority="paid") for _ in range(2)]
        assert r._policy_tick(now=0.0) == [("degrade", "best_effort")]
        assert r.stats()["router"]["route"] == {"paid": "fp32", "best_effort": "bf16"}
        be = r.submit({"data": _x()}, priority="best_effort")
        r.start()
        assert be.result(WAIT) and be.tier == "bf16"
        assert all(q.result(WAIT) and q.tier == "fp32" for q in paid)
        assert r._policy_tick(now=0.5) == []     # calm starts
        assert r._policy_tick(now=1.0) == []     # within hold_s
        assert r._policy_tick(now=1.6) == [("restore", "best_effort")]
        st = r.stats()
    finally:
        r.close()
    assert st["router"]["route"]["best_effort"] == "fp32"
    assert st["router"]["policy_counts"] == {"degrade": 1, "restore": 1}
    assert [t["action"] for t in st["router"]["transitions"]] == ["degrade", "restore"]
    assert st["downgrades"] == 1


def test_router_needs_a_degradation_target_and_refuses_unported_gates(files, monkeypatch):
    with pytest.raises(ValueError, match="degradation target"):
        serving.Router(_register(files, ("fp32",)))
    m = _register(files)
    with pytest.raises(NotImplementedError, match="slo_monitor"):
        serving.Router(m, slo_monitor=object(), start=False)
    monkeypatch.setenv("MXNET_SLO", "p99<50ms")
    with pytest.raises(NotImplementedError, match=r"MXNET_SLO \(A10\)"):
        serving.Router(m, start=False)


def test_router_warmup_builds_every_pool(model):
    r = serving.Router(model, policy="degrade", name="rt-warm", start=False)
    try:
        report = r.warmup()
        assert sorted(report) == ["rt-warm-%s-0" % t for t in sorted(TIERS)]
        st = r.stats()
        assert st["compiles"] == len(TIERS) * len(LADDER)
        assert {e["tier"] for e in st["engines"].values()} == set(TIERS)
        assert [row["precision_tier"] for row in report["rt-warm-int8-0"]] == ["int8"] * 3
        # the int8 pool's plans quantize both FullyConnected layers
        assert all(len(p.int8_sites) == 2 for p in r.engines("int8")[0]._cache.values())
    finally:
        r.close()


# -- the degrade policy, against the JAX package's ---------------------------------
SIGNALS = {
    "burn": [(0.1, 0.0, 0.0), (3.0, 0.0, 1.0), (3.0, 0.0, 2.0), (1.0, 0.0, 3.0),
             (0.1, 0.0, 31.0), (1.0, 0.0, 35.5), (0.1, 0.0, 36.0), (0.1, 0.0, 41.5)],
    "pressure": [(None, 0.9, 0.0), (None, 0.3, 1.0), (None, 0.3, 100.0),
                 (None, 0.1, 101.0), (None, 0.1, 107.0), (None, 0.6, 108.0)],
    "flapping": [(None, 0.5, 0.0), (None, 0.24, 1.0), (None, 0.5, 2.0), (None, 0.1, 3.0),
                 (None, 0.1, 4.0), (None, 0.1, 9.0), (None, 0.1, 20.0)],
}


@pytest.mark.parametrize("mode", ["degrade", "shed"])
@pytest.mark.parametrize("seq", sorted(SIGNALS))
def test_policy_takes_the_jax_package_actions(seq, mode):
    def run(pol):
        p = pol.DegradePolicy(pol.PolicyConfig(mode=mode, burn_high=2.0, burn_low=0.5,
                                               hold_s=5.0, pressure=0.5),
                              ("paid", "best_effort"), protected=("paid",))
        acts = [p.step({"burn": b, "pressure": pr}, now=t) for b, pr, t in SIGNALS[seq]]
        return acts, p.status(now=50.0)

    got, want = run(tpolicy), run(jpolicy)
    assert got == want
    assert any(got[0]) == (mode == "degrade")


def test_policy_config_from_env_matches_the_jax_package(monkeypatch):
    with pytest.raises(ValueError):
        tpolicy.PolicyConfig(mode="static")
    with pytest.raises(ValueError):
        tpolicy.PolicyConfig(burn_high=1.0, burn_low=2.0)
    monkeypatch.setenv("MXNET_ROUTER_POLICY", "sideways")
    monkeypatch.setenv("MXNET_ROUTER_BURN_HIGH", "lots")
    monkeypatch.setenv("MXNET_ROUTER_PRESSURE", "0.25")
    monkeypatch.setenv("MXNET_ROUTER_HOLD_S", "2")
    got, want = tpolicy.config_from_env(), jpolicy.config_from_env()
    assert {k: getattr(got, k) for k in got.__slots__} == \
        {k: getattr(want, k) for k in want.__slots__}
    assert (got.mode, got.burn_high, got.pressure, got.hold_s) == ("degrade", 1.0, 0.25, 2.0)
