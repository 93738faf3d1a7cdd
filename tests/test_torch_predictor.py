"""The port's deployment Predictor (mxnet_tpu_torch.predictor) against the
JAX package's on the CPU: the deploy twin of ``bench.py``'s
``MXNET_BENCH=predictor`` (batch 2, 16x16) and the CIFAR ResNet-8 v2
(16x16), each written to files by the JAX package (``Symbol.save``,
``nd.save``) and served by both.  fp32 outputs agree within rtol 1e-5;
the bf16 and int8 twins are held to their own fp32 plan at the tier's
tolerance; with the JAX calibration table carried across, the int8
twin's outputs agree with the jitted JAX int8 twin's within rtol 1e-5 and
no int8 rounding flips at any site, and the int32 accumulators equal the
jitted JAX tier's bit for bit; the weights are shared by every sibling
and twin.
"""
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd
from mxnet_tpu.graph_passes import precision as jprecision
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu.predictor import Predictor as JaxPredictor
from mxnet_tpu.test_utils import deploy_twin_checkpoint as jax_twin
from mxnet_tpu_torch import predictor as tpredictor
from mxnet_tpu_torch.graph_passes import precision
from mxnet_tpu_torch.predictor import Predictor

ROOT = Path(__file__).resolve().parents[1]
TWIN_SHAPE = (2, 3, 16, 16)
RESNET_SHAPE = (2, 3, 16, 16)


def _jax_resnet():
    from conftest import load_example_module

    mod = load_example_module(
        "image_classification_resnet_symbols",
        str(ROOT / "examples" / "image-classification" / "symbols" / "resnet.py"))
    with JaxNameManager():
        return mod.get_symbol(10, 8, "3,16,16")


def _resnet_params(jnet, rng):
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
def served(tmp_path_factory):
    """{model: (JAX Predictor, port Predictor, symbol file, params file,
    JAX fp32 outputs on the model's input)}, the JAX forwards jitted once."""
    d = tmp_path_factory.mktemp("deploy")
    with JaxNameManager():
        jsym, jparams, shapes = jax_twin(batch=TWIN_SHAPE[0], image=TWIN_SHAPE[2])
    jres = _jax_resnet()
    out = {}
    for name, sym, params, in_shapes in (
            ("twin", jsym, {k: v.asnumpy() for k, v in jparams.items()}, shapes),
            ("resnet8", jres, _resnet_params(jres, np.random.RandomState(3)),
             {"data": RESNET_SHAPE})):
        sfile, pfile = str(d / ("%s-symbol.json" % name)), str(d / ("%s.params" % name))
        sym.save(sfile)
        jnd.save(pfile, {k: jnd.array(v) for k, v in params.items()})
        jp = JaxPredictor(sym, {k: jnd.array(v) for k, v in params.items()}, in_shapes)
        tp = Predictor(sfile, pfile, in_shapes, device="cpu")
        x = _input(name)
        out[name] = (jp, tp, sfile, pfile, [o.asnumpy() for o in jp.forward(data=x)])
    return out


def _input(model, seed=0):
    shape = TWIN_SHAPE if model == "twin" else RESNET_SHAPE
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _outs(pred, x):
    return [o.float().numpy() for o in pred.forward(data=torch.from_numpy(x))]


@pytest.mark.parametrize("model", ["twin", "resnet8"])
def test_fp32_outputs_match_the_jax_predictor(served, model):
    _, tp, _, _, ref = served[model]
    got = _outs(tp, _input(model))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tp.get_output(0), got[0])
    assert tp.get_output_shape(0) == got[0].shape


@pytest.mark.parametrize("model", ["twin", "resnet8"])
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_twins_within_tier_tolerance_of_their_fp32_plan(served, model, tier):
    _, tp, _, _, _ = served[model]
    x = _input(model)
    base = _outs(tp, x)
    table = None
    if tier == "int8":
        rng = np.random.RandomState(1)
        table = precision.calibrate(tp, ({"data": rng.rand(*x.shape).astype(np.float32)}
                                         for _ in range(3)))
        assert table.batches == 3 and table.ranges
    twin = tp.with_precision(tier, table)
    got = _outs(twin, x)
    tol = precision.tier_tolerance(tier)
    for a, b in zip(got, base):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, **tol)
    names = [getattr(n.op, "name", "") for n, _ in twin._exec._opt_plan(False)[0]]
    assert "_bn_affine" not in names or model == "resnet8"  # bn_data follows no conv
    if tier == "int8":
        assert twin.int8_sites and any(n.startswith("_int8_") for n in names)
    else:
        assert "_precision_cast" in names and twin.int8_sites == {}
    assert [r["pass"] for r in twin.pass_stats()["eval"]["passes"]][-2:] == \
        [n for n, _, _ in precision.tier_passes(tier)]


def test_calibration_matches_the_jax_package(served):
    jp, tp, _, _, _ = served["twin"]
    rng = np.random.RandomState(2)
    batches = [{"data": rng.rand(*TWIN_SHAPE).astype(np.float32)} for _ in range(2)]
    jt = jprecision.calibrate(jp, iter(batches))
    tt = precision.calibrate(tp, iter(batches))
    assert sorted(tt.ranges) == sorted(jt.ranges) and tt.batches == jt.batches == 2
    for k, (lo, hi) in jt.ranges.items():
        np.testing.assert_allclose(tt.ranges[k], (lo, hi), rtol=1e-5, atol=1e-6, err_msg=k)
    live = precision.observe_ranges(tp, batches[0], ["data", "conv1_output"])
    assert sorted(live) == ["conv1_output", "data"]


def _carried_table(jp, shape, seed=4):
    """(the JAX package's calibration table, the port's copy of it)."""
    rng = np.random.RandomState(seed)
    jt = jprecision.calibrate(jp, ({"data": rng.rand(*shape).astype(np.float32)}
                                   for _ in range(2)))
    return jt, precision.CalibrationTable(jt.ranges, jt.batches)


def test_int8_accumulators_bit_equal_to_the_jax_tier(served):
    """The first quantized site of the twin (conv0 on the data) with the
    JAX table carried across: the int8 activations and the int32
    accumulators equal the jitted JAX tier's bit for bit, on the model's
    input and on values at and next to every rounding tie (x = (k + 1/2) *
    a_scale), where an eager division by ``a_scale`` rounds otherwise than
    the jitted tier's product."""
    jp, tp, _, _, _ = served["twin"]
    twin = tp.with_precision("int8", _carried_table(jp, TWIN_SHAPE)[1])
    plan, _, consts = twin._exec._opt_plan(False)
    node = next(n for n, _ in plan if n.op.name == "_int8_convolution")
    site = twin.int8_sites[node.name]
    a = np.float32(site["a_scale"])
    wq = np.asarray(consts["%s__int8_weight" % node.name])
    a_inv = torch.tensor(consts["%s__int8_ainv" % node.name])
    ties = ((np.arange(-126, 126, dtype=np.float32) + np.float32(0.5)) * a).astype(np.float32)
    ties = np.concatenate([ties, np.nextafter(ties, np.float32(np.inf)),
                           np.nextafter(ties, np.float32(-np.inf))])
    x = (_input("twin", seed=5) - 0.5) * 3
    x.reshape(-1)[:ties.size] = ties
    quantize = jax.jit(lambda v: jnp.clip(jnp.round(v / site["a_scale"]), -127.0, 127.0)
                       .astype(jnp.int8))
    jxq = quantize(jnp.asarray(x))
    jacc = jax.lax.conv_general_dilated(
        jxq.astype(jnp.int32), jnp.asarray(wq).astype(jnp.int32), window_strides=(1, 1),
        padding=[(1, 1), (1, 1)], dimension_numbers=("NCHW", "OIHW", "NCHW"))
    txq = precision._quantize_activation(torch.from_numpy(x), a_inv)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    divided = np.clip(np.round(ties / a), -127, 127)
    assert (divided != np.asarray(jxq).reshape(-1)[:ties.size]).any()
    tacc = precision.int8_accumulators(torch.from_numpy(x), torch.from_numpy(wq), a_inv,
                                       "Convolution", dict(node.attrs))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))


def _node_name(out_name):
    return out_name[:-len("_output")] if out_name.endswith("_output") else out_name


@pytest.mark.parametrize("model", ["twin", "resnet8"])
def test_int8_twin_matches_the_jitted_jax_int8_twin(served, model, record_property):
    """With the JAX calibration table carried across, the port's int8 twin
    quantizes the same sites as the JAX Predictor's jitted int8 twin and
    its outputs agree within the fp32 tolerance (rtol 1e-5, atol 1e-6).
    A partial-output twin of both packages also returns every site's fp32
    input: quantized by the site's scale, no int8 value differs between
    the packages (the count is recorded as ``int8_flips``)."""
    jp, tp, sfile, pfile, _ = served[model]
    shape = TWIN_SHAPE if model == "twin" else RESNET_SHAPE
    jtable, table = _carried_table(jp, shape)
    jtwin, twin = jp.with_precision("int8", jtable), tp.with_precision("int8", table)
    x = _input(model, seed=10)
    ref = [o.asnumpy() for o in jtwin.forward(data=x)]
    got = _outs(twin, x)
    assert twin.int8_sites == jtwin.int8_sites and twin.int8_sites
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    sites = twin.int8_sites
    heads = [_node_name(h) for h in sorted({v["input"] for v in sites.values()} - {"data"})
             + tp._symbol.list_outputs()]
    jpart = JaxPredictor(sfile, pfile, {"data": shape}, output_names=heads) \
        .with_precision("int8", jtable)
    tpart = Predictor(sfile, pfile, {"data": shape}, device="cpu",
                      output_names=heads).with_precision("int8", table)
    jouts = dict(zip(heads, (o.asnumpy() for o in jpart.forward(data=x))))
    touts = dict(zip(heads, _outs(tpart, x)))
    assert tpart.int8_sites == sites
    flips = checked = 0
    for v in sites.values():
        h = _node_name(v["input"])
        if h == "data":
            continue
        inv = np.float32(1) / np.float32(v["a_scale"])
        q = lambda t: np.clip(np.round(t * inv), -127, 127)
        flips += int((q(touts[h]) != q(jouts[h])).sum())
        checked += touts[h].size
        np.testing.assert_allclose(touts[h], jouts[h], rtol=1e-5, atol=1e-6, err_msg=h)
    record_property("int8_flips", "%d of %d" % (flips, checked))
    assert checked and flips == 0, "%d of %d int8 values flipped" % (flips, checked)


def test_siblings_and_twins_share_the_weights_and_carry_the_tier(served):
    _, tp, _, _, _ = served["twin"]
    ptr = lambda p: {k: v.data_ptr() for k, v in p._exec.arg_dict.items() if k != "data"}
    twin = tp.with_precision("bf16")
    sib = twin.with_shapes({"data": (1, 3, 16, 16)})
    assert ptr(twin) == ptr(tp) == ptr(sib)
    assert sib.precision_tier == "bf16" and tp.precision_tier == "fp32"
    x1 = _input("twin")[:1]
    ref = _outs(twin, np.concatenate([x1, x1]))
    got = _outs(sib, x1)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a[0], b[0])
    rng = np.random.RandomState(6)
    table = precision.calibrate(tp, [{"data": rng.rand(*TWIN_SHAPE).astype(np.float32)}])
    q = tp.with_precision("int8", table)
    q.reshape({"data": (1, 3, 16, 16)})
    assert q.precision_tier == "int8" and ptr(q) == ptr(tp)
    assert q.forward(data=torch.from_numpy(x1))[0].shape == (1, 10) and q.int8_sites
    assert q.with_shapes({"data": (3, 3, 16, 16)})._exec._calibration is table
    plain = twin.with_precision("fp32")
    assert plain.precision_tier == "fp32" and ptr(plain) == ptr(tp)


def test_set_input_partial_outputs_and_files(served, tmp_path):
    jp, tp, sfile, pfile, _ = served["twin"]
    with pytest.raises(KeyError, match="unknown input"):
        tp.set_input("label", np.zeros(TWIN_SHAPE, np.float32))
    with pytest.raises(ValueError, match="reshape"):
        tp.set_input("data", np.zeros((1, 3, 16, 16), np.float32))
    x = _input("twin")
    tp.set_input("data", x)  # an array is copied into the bound buffer
    np.testing.assert_array_equal(tp._exec.arg_dict["data"].numpy(), x)
    # a tensor of the bound device and dtype is read in place, and a later
    # copied input never writes into it
    mine = torch.from_numpy(_input("twin", seed=7))
    kept = mine.clone()
    tp.forward(data=mine)
    assert tp._exec.arg_dict["data"] is mine
    tp.set_input("data", x)
    tp.forward(data=torch.from_numpy(x).double())
    assert torch.equal(mine, kept)
    np.testing.assert_array_equal(tp._exec.arg_dict["data"].numpy(), x)
    names = ["act0", "pool1_output"]
    part = tpredictor.create(sfile, pfile, {"data": TWIN_SHAPE}, device="cpu",
                             output_names=names)
    jpart = JaxPredictor(sfile, pfile, {"data": TWIN_SHAPE}, output_names=names)
    got, ref = _outs(part, x), [o.asnumpy() for o in jpart.forward(data=x)]
    assert [o.shape for o in got] == [o.shape for o in ref] == [(2, 16, 16, 16), (2, 32, 4, 4)]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="not in graph"):
        Predictor(sfile, pfile, {"data": TWIN_SHAPE}, device="cpu", output_names=["nope"])
    loaded = tpredictor.load_ndarray_file(pfile)
    assert sorted(loaded) == sorted(k for k in jnd.load(pfile))
    for m in ("aot_lower", "aot_warm"):
        with pytest.raises(NotImplementedError, match="A9"):
            getattr(tp, m)()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Predictor(sfile, pfile, {"data": TWIN_SHAPE})
