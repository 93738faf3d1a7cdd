"""The port's graph passes, analyzers, cast plans and precision-tier plans
(mxnet_tpu_torch.graph_passes, .analysis) against the JAX package's on the
CPU, with no forward: the same symbols (the deploy twin of
``bench.py``'s ``MXNET_BENCH=predictor`` at batch 2, 16x16, and the CIFAR
ResNet-8 v2 at 16x16), built under fresh name counters, and the same
weights, give the same pass rows, plans, verdicts, fingerprints, folded
constants and tier structure.  Nothing here compiles a JAX function:
plans and cast plans are made from shapes (``jax.eval_shape``) and the
folds in numpy.
"""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd
from mxnet_tpu.analysis import numerics as jnumerics
from mxnet_tpu.graph_passes import capture as jcapture
from mxnet_tpu.graph_passes import precision as jprecision
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu.predictor import Predictor as JaxPredictor
from mxnet_tpu.test_utils import deploy_twin_checkpoint as jax_twin
from mxnet_tpu_torch import graph_passes
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.analysis import numerics
from mxnet_tpu_torch.graph_passes import passes, precision
from mxnet_tpu_torch.models import resnet_symbol
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.predictor import Predictor
from mxnet_tpu_torch.test_utils import deploy_twin_checkpoint

ROOT = Path(__file__).resolve().parents[1]
TWIN = dict(batch=2, image=16)
RESNET_SHAPE = (2, 3, 16, 16)


def _jax_resnet():
    from conftest import load_example_module

    mod = load_example_module(
        "image_classification_resnet_symbols",
        str(ROOT / "examples" / "image-classification" / "symbols" / "resnet.py"))
    with JaxNameManager():
        return mod.get_symbol(10, 8, "3,16,16")


def _resnet_params(jnet, rng):
    """He-scaled weights, BN affine around 1 and 0, moving statistics around
    0 and 1, as {"arg:<name>" / "aux:<name>": float32 array}."""
    arg_shapes, _, aux_shapes = jnet.infer_shape(data=RESNET_SHAPE)
    params = {}
    for n, s in zip(jnet.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            v = rng.randn(*s) * math.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        else:
            v = rng.randn(*s) * 0.1
        params["arg:" + n] = v.astype(np.float32)
    for n, s in zip(jnet.list_auxiliary_states(), aux_shapes):
        v = rng.uniform(0.5, 1.5, s) if n.endswith("_var") else rng.randn(*s) * 0.1
        params["aux:" + n] = v.astype(np.float32)
    return params


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{model: (JAX Predictor, port Predictor)}: each model's symbol and
    parameters written by the JAX package and read by the port from the
    files (the port's own builders are checked against them below)."""
    d = tmp_path_factory.mktemp("deploy")
    with JaxNameManager():
        jsym, jparams, shapes = jax_twin(**TWIN)
    jres = _jax_resnet()
    rparams = _resnet_params(jres, np.random.RandomState(3))
    out = {}
    for name, sym, params, in_shapes in (
            ("twin", jsym, {k: v.asnumpy() for k, v in jparams.items()}, shapes),
            ("resnet8", jres, rparams, {"data": RESNET_SHAPE})):
        sym.save(str(d / ("%s-symbol.json" % name)))
        jnd.save(str(d / ("%s.params" % name)), {k: jnd.array(v) for k, v in params.items()})
        jp = JaxPredictor(sym, {k: jnd.array(v) for k, v in params.items()}, in_shapes)
        tp = Predictor(str(d / ("%s-symbol.json" % name)), str(d / ("%s.params" % name)),
                       in_shapes, device="cpu")
        out[name] = (jp, tp)
    return out


def _plan_rows(plan):
    return [(n.name, getattr(n.op, "name", ""), tuple(ins)) for n, ins in plan]


def test_port_builders_name_nodes_as_the_jax_package():
    with JaxNameManager():
        jsym = jax_twin(**TWIN)[0]
    with tsym.NameManager():
        tsym_ = deploy_twin_checkpoint(**TWIN)[0]
    with tsym.NameManager():
        tres = resnet_symbol.get_symbol(10, 8, "3,16,16")
    for j, t in ((jsym, tsym_), (_jax_resnet(), tres)):
        assert _plan_rows(graph_passes.capture(t)[0]) == _plan_rows(jcapture(j)[0])
        assert t.list_outputs() == j.list_outputs()


@pytest.mark.parametrize("model", ["twin", "resnet8"])
@pytest.mark.parametrize("is_train", [False, True])
def test_pass_rows_plans_and_heads_equal_jax(pairs, model, is_train):
    jp, tp = pairs[model]
    jplan, jheads, jconst = jp._exec._structural_plan(is_train)
    tplan, theads, tconst = tp._exec._structural_plan(is_train)
    mode = "train" if is_train else "eval"
    rows = lambda st: [(r["pass"], r["version"], r["nodes_in"], r["nodes_out"])
                       for r in st[mode]["passes"]]
    assert rows(tp.pass_stats()) == rows(jp.pass_stats())
    assert _plan_rows(tp._exec._plan) == _plan_rows(jp._exec._plan)
    assert tp._exec._head_names == jp._exec._head_names
    assert _plan_rows(tplan) == _plan_rows(jplan)
    assert list(theads) == list(jheads)
    assert tconst is None and jconst is None


def test_cse_and_dce_merge_the_twin_heads(pairs):
    """The second pooled-feature chain is merged into the first and swept;
    eval Dropout goes, and the heads point at the surviving chain."""
    _, tp = pairs["twin"]
    plan, heads, _ = tp._exec._structural_plan(False)
    names = [n.name for n, _ in plan]
    assert "dropout0" not in names and "pooling0" not in names
    assert heads == ["prob_output", "l2normalization1_output"]
    assert [getattr(n.op, "name", "") for n, _ in plan].count("_bn_affine") == 2
    stats = tp.pass_stats()["eval"]
    assert (stats["nodes_pre"], stats["nodes_post"]) == (17, 13)


@pytest.mark.parametrize("model", ["twin", "resnet8"])
def test_cast_plan_verdicts_and_fingerprints_equal_jax(pairs, model):
    jp, tp = pairs[model]
    jcp, tcp = jp.precision_plan(), tp.precision_plan()
    assert list(tcp.rows) == list(jcp.rows)
    assert tcp.fingerprint() == jcp.fingerprint()
    assert numerics.contract_fingerprint() == jnumerics.contract_fingerprint()
    assert precision.tier_fingerprint("bf16") == jprecision.tier_fingerprint("bf16")
    assert precision.tier_fingerprint("int8") == jprecision.tier_fingerprint("int8")
    from mxnet_tpu.analysis import executor_context as jctx
    from mxnet_tpu_torch.analysis import executor_context as tctx

    assert numerics.param_verdict_classes(tctx(tp._exec, plan="structural")) == \
        jnumerics.param_verdict_classes(jctx(jp._exec, plan="structural"))


@pytest.mark.parametrize("model", ["twin", "resnet8"])
def test_check_diagnostics_equal_jax(pairs, model):
    jp, tp = pairs[model]
    key = lambda ds: [(d.code, d.severity, d.where, d.analyzer) for d in ds]
    assert key(tp.check()) == key(jp.check())
    for tier in ("bf16",):
        assert key(tp.with_precision(tier).check()) == key(jp.with_precision(tier).check())


def test_bf16_cast_structure_and_folded_constants_equal_jax(pairs):
    """The bf16 twin's plan: the same cast nodes at the same edges, the same
    accum_dtype on the same contractions, the same fp32 islands, the same
    heads; the folded weights and biases equal bit for bit."""
    for model in ("twin", "resnet8"):
        jp, tp = pairs[model]
        jplan, jheads, jconst = jp.with_precision("bf16")._exec._opt_plan(False)
        tplan, theads, tconst = tp.with_precision("bf16")._exec._opt_plan(False)
        attrs = lambda plan: [{k: v for k, v in n.attrs.items()
                               if k in ("dtype", "accum_dtype", "out_dtype")} for n, _ in plan]
        assert _plan_rows(tplan) == _plan_rows(jplan)
        assert attrs(tplan) == attrs(jplan)
        assert list(theads) == list(jheads)
        assert sorted(tconst) == sorted(jconst)
        folded = [k for k in tconst if "__folded_" in k]
        assert folded
        for k in folded:
            a, b = np.asarray(tconst[k]), np.asarray(jconst[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_int8_plan_from_the_jax_table_equals_jax(pairs):
    """With the JAX package's calibration table carried across, the int8
    twin quantizes the same sites with the same ranges and scales, and
    bakes the same int8 weights and weight scales."""
    rng = np.random.RandomState(5)
    for model, shape in (("twin", (2, 3, 16, 16)), ("resnet8", RESNET_SHAPE)):
        jp, tp = pairs[model]
        jtable = jprecision.calibrate(jp, ({"data": rng.rand(*shape).astype(np.float32)}
                                           for _ in range(2)))
        table = precision.CalibrationTable(jtable.ranges, jtable.batches)
        assert table.fingerprint() == jtable.fingerprint()
        jtwin = jp.with_precision("int8", jtable)
        ttwin = tp.with_precision("int8", table)
        jplan, _, jconst = jtwin._exec._opt_plan(False)
        tplan, _, tconst = ttwin._exec._opt_plan(False)
        assert ttwin.int8_sites == jtwin.int8_sites and ttwin.int8_sites
        assert [(n, o) for n, o, _ in _plan_rows(tplan)] == \
            [(n, o) for n, o, _ in _plan_rows(jplan)]
        for k in jconst:
            if "__int8_" in k:
                a, b = np.asarray(tconst[k]), np.asarray(jconst[k])
                assert a.dtype == b.dtype and np.array_equal(a, b), k
        rows = lambda p: [(r["pass"], r["nodes_in"], r["nodes_out"])
                          for r in p.pass_stats()["eval"]["passes"]]
        assert rows(ttwin) == rows(jtwin)


def test_bn_affine_equals_the_eval_batchnorm_bit_for_bit():
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(3, 5, 4, 4).astype(np.float32) * 3)
    g, b, m = (torch.from_numpy(rng.randn(5).astype(np.float32)) for _ in range(3))
    v = torch.from_numpy(rng.uniform(0.1, 2.0, 5).astype(np.float32))
    for fix_gamma in (True, False):
        ref = tnn.batch_norm(x, g, b, m, v, eps=2e-5, fix_gamma=fix_gamma)
        got = passes._bn_affine_fn(x, g, b, m, v, eps=2e-5, fix_gamma=fix_gamma, axis=1)
        assert torch.equal(got, ref)


def test_stochastic_nodes_are_neither_folded_nor_merged():
    """Two Dropouts on one input stay two nodes in a training plan (merged,
    they would share one mask); their Dropout takes a generator where the
    JAX op takes a key."""
    with tsym.NameManager():
        x = tsym.var("data")
        net = tsym.Group([tsym.Dropout(x, p=0.5), tsym.Dropout(x, p=0.5)])
    plan, heads = graph_passes.capture(net)
    g, _ = graph_passes.optimize(plan, heads, True)
    assert [n.name for n, _ in g.entries] == ["dropout0", "dropout1"]
    assert not passes._fold_ok(plan[0][0]) and not passes._cse_ok(plan[0][0], False)
    exe = net.simple_bind(device="cpu", grad_req="null", data=(4, 64))
    a, b = exe.forward(is_train=True, data=torch.ones(4, 64))
    assert not torch.equal(a, b)
    assert [d.code for d in exe.check(is_train=True)] == []


def test_off_path_and_gates(pairs, monkeypatch):
    """``test_off_path_plan_and_key_identity`` and
    ``test_train_plans_never_tier_rewritten`` of the JAX package's tests, in
    the port; the pipeline fingerprint equals the JAX package's with and
    without a tier; a bind has no tier (the port reads no tier from the
    environment); with ``MXNET_GRAPH_PASSES=0`` the captured plan runs as it
    is and no tier can be set."""
    from mxnet_tpu import graph_passes as jgraph_passes

    monkeypatch.delenv("MXNET_PRECISION_TIER", raising=False)
    _, tp = pairs["twin"]
    exe = tp._exec
    assert exe._precision_tier is None
    assert exe._opt_plan(False) is exe._structural_plan(False)
    fp = graph_passes.pipeline_fingerprint()
    assert fp and "tier" not in fp and fp == jgraph_passes.pipeline_fingerprint()
    twin = tp.with_precision("bf16")._exec
    assert twin._opt_plan(True) is twin._structural_plan(True)
    monkeypatch.setenv("MXNET_PRECISION_TIER", "bf16")
    assert graph_passes.pipeline_fingerprint("bf16") == jgraph_passes.pipeline_fingerprint()
    assert "tier=bf16" in graph_passes.pipeline_fingerprint("bf16")
    # a bind has no tier; a sibling keeps its predictor's (explicit) tier
    assert tp._symbol.simple_bind(device="cpu", grad_req="null",
                                  data=(1, 3, 16, 16)).precision_tier == "fp32"
    assert tp.with_shapes({"data": (1, 3, 16, 16)}).precision_tier == "fp32"
    monkeypatch.delenv("MXNET_PRECISION_TIER")
    monkeypatch.setenv("MXNET_GRAPH_PASSES", "0")
    assert graph_passes.pipeline_fingerprint() is None
    assert graph_passes.pipeline_fingerprint("int8") is None
    raw = tp.with_shapes({"data": (2, 3, 16, 16)})
    plan, heads, consts = raw._exec._opt_plan(False)
    assert plan is raw._exec._plan and consts is None and raw.pass_stats() == {}
    with pytest.raises(ValueError, match="graph-pass layer"):
        raw._exec.set_precision_tier("bf16")


def test_meta_walk_launches_nothing_and_analyzers_report_skips(pairs):
    """``check()`` and the tier passes walk the plan on meta tensors: the
    kernel wrappers give meta outputs there and count no launch."""
    from mxnet_tpu_torch.analysis import GraphContext, analyze
    from mxnet_tpu_torch.ops import kernels

    kernels.reset_launches()
    x = torch.empty(5, 7, device="meta")
    r = torch.empty((), device="meta")
    q = kernels.quantize_int8(x, r)
    assert q.device.type == "meta" and q.dtype == torch.int8 and q.shape == x.shape
    d = kernels.dequantize_int8(q, r)
    assert d.device.type == "meta" and d.dtype == torch.float32
    a = kernels.psroi_abuild(torch.empty(3, 2, 4, device="meta"),
                             torch.empty(3, 2, 5, device="meta"))
    assert a.shape == (3, 4, 5) and a.device.type == "meta"
    assert all(k.wrapper.launches == 0 for k in kernels.KERNELS.values())
    _, tp = pairs["resnet8"]
    g = graph_passes.Graph(*tp._exec._structural_plan(False))
    codes = [d.code for d in analyze(GraphContext(g))]
    assert codes.count("analyzer-skipped") == 2
