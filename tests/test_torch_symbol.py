"""The port's symbolic frontend, executor and int8 post-training quantization
(mxnet_tpu_torch.symbol, .executor, .contrib.quantization, .io,
.models.resnet_symbol) against the JAX package, on the CPU.

The network is the CIFAR ResNet-8 v2 of the ResNet symbol builder
(``get_symbol(10, 8, "3,32,32")``, the same builder as the ImageNet
ResNet-50 that chip_smoke.py quantizes at full width), with the same random
weights on both sides and fresh name counters, so that node names match.
"""
import functools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu import nd
from mxnet_tpu.contrib import quantization as jquant
from mxnet_tpu.ops import matrix as jmat
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.io import NDArrayIter as JaxIter
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.contrib import quantization as tquant
from mxnet_tpu_torch.gluon.model_zoo.convert import symbol_params_from_jax
from mxnet_tpu_torch.io import NDArrayIter
from mxnet_tpu_torch.models import resnet_symbol
from mxnet_tpu_torch.ops import elemwise as telem
from mxnet_tpu_torch.ops import matrix as tmat
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import reduce as tred

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (4, 3, 32, 32)


def _jax_resnet():
    from conftest import load_example_module

    mod = load_example_module(
        "image_classification_resnet_symbols",
        str(ROOT / "examples" / "image-classification" / "symbols" / "resnet.py"))
    with JaxNameManager():
        return mod.get_symbol(10, 8, "3,32,32")


def _params(jnet, rng):
    """He-scaled weights, BN affine around 1 and 0, moving statistics around
    0 and 1 (numpy, float32)."""
    arg_shapes, _, aux_shapes = jnet.infer_shape(data=SHAPE)
    args, aux = {}, {}
    for n, s in zip(jnet.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            v = rng.randn(*s) * math.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        else:
            v = rng.randn(*s) * 0.1
        args[n] = v.astype(np.float32)
    for n, s in zip(jnet.list_auxiliary_states(), aux_shapes):
        v = rng.uniform(0.5, 1.5, s) if n.endswith("_var") else rng.randn(*s) * 0.1
        aux[n] = v.astype(np.float32)
    return args, aux


def _jax_forward(sym, args, aux, x):
    exe = sym.simple_bind(grad_req="null", data=x.shape)
    for bound, params in ((exe.arg_dict, args), (exe.aux_dict, aux)):
        for k, v in params.items():
            bound[k][:] = v
    return [o.asnumpy() for o in exe.forward(is_train=False, data=nd.array(x))]


def _torch_forward(sym, args, aux, x):
    exe = sym.simple_bind(device="cpu", grad_req="null", data=x.shape)
    for bound, params in ((exe.arg_dict, args), (exe.aux_dict, aux)):
        for k, v in params.items():
            bound[k].copy_(torch.as_tensor(v))
    return [o.numpy() for o in exe.forward(data=torch.from_numpy(x))]


def _requantize_ranges(qsym):
    return {n.name: (n.attrs.get("min_calib_range"), n.attrs.get("max_calib_range"))
            for n in qsym._walk() if not n.is_var and n.op.name == "_contrib_requantize"}


POOLS = {
    "avg-3x3-s2-p1": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    "avg-full-nopad": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
                           pooling_convention="full", count_include_pad=False),
    "avg-global": dict(kernel=(7, 7), pool_type="avg", global_pool=True),
    "max-full": dict(kernel=(2, 2), stride=(2, 2), pool_type="max",
                     pooling_convention="full"),
    "max-stride1": dict(kernel=(3, 3), pool_type="max"),
}


# fp32: one window sum (or max) and one division per output; sums in
# another order
@pytest.mark.parametrize("pool", list(POOLS))
def test_pooling_matches_jax(pool):
    x = np.random.RandomState(10).randn(2, 3, 9, 7).astype(np.float32)
    ref = np.asarray(jnn.pooling(jnp.asarray(x), **POOLS[pool]))
    got = tnn.pooling(torch.from_numpy(x), **POOLS[pool]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# fp32 ops of the ResNet symbol's head: one matmul (rtol 1e-5), the rest
# exact or one exp-normalisation (rtol 1e-6)
def test_head_ops_match_jax():
    rng = np.random.RandomState(11)
    x = rng.randn(4, 8, 2, 2).astype(np.float32)
    w = rng.randn(5, 32).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_allclose(
        tnn.fully_connected(tx, torch.from_numpy(w), torch.from_numpy(b), num_hidden=5),
        np.asarray(jnn.fully_connected(jx, jnp.asarray(w), jnp.asarray(b), num_hidden=5)),
        rtol=1e-5, atol=1e-6)
    logits = rng.randn(4, 10).astype(np.float32) * 5
    np.testing.assert_allclose(
        tnn.softmax_output(torch.from_numpy(logits), torch.zeros(4)),
        np.asarray(jnn.softmax_output(jnp.asarray(logits), jnp.zeros(4))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_array_equal(tmat.flatten(tx).numpy(), np.asarray(jmat.flatten(jx)))
    np.testing.assert_array_equal(telem.broadcast_add(tx, tx[:1]).numpy(),
                                  np.asarray(jreg.get("broadcast_add").fn(jx, jx[:1])))
    assert float(tred.max_(tx)) == float(jreg.get("max").fn(jx))
    assert float(tred.min_(tx)) == float(jreg.get("min").fn(jx))


@pytest.fixture(scope="module")
def nets():
    rng = np.random.RandomState(0)
    jnet = _jax_resnet()
    with tsym.NameManager():
        tnet = resnet_symbol.get_symbol(10, 8, "3,32,32")
    args, aux = _params(jnet, rng)
    return dict(jnet=jnet, tnet=tnet, args=args, aux=aux,
                x=rng.randn(*SHAPE).astype(np.float32),
                calib=rng.randn(8, 3, 32, 32).astype(np.float32))


@pytest.fixture(scope="module")
def quantized(nets):
    """quantize_model on both sides: naive calibration over two batches of
    four, fc1 left in fp32 as upstream's ResNet example does."""
    n = nets
    jq = jquant.quantize_model(
        n["jnet"], {k: nd.array(v) for k, v in n["args"].items()},
        {k: nd.array(v) for k, v in n["aux"].items()}, excluded_sym_names=["fc1"],
        calib_mode="naive", calib_data=JaxIter(n["calib"], batch_size=4))
    tq = tquant.quantize_model(
        n["tnet"], n["args"], n["aux"], device="cpu", excluded_sym_names=["fc1"],
        calib_mode="naive", calib_data=NDArrayIter(torch.from_numpy(n["calib"]),
                                                   batch_size=4))
    return jq, tq


def test_resnet_symbol_lists_and_shapes_match(nets):
    j, t = nets["jnet"], nets["tnet"]
    assert [n.name for n in t._walk()] == [n.name for n in j._walk()]
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs() == ["softmax_output"]
    assert t.get_internals().list_outputs() == j.get_internals().list_outputs()
    js = j.infer_shape(data=SHAPE)
    ts = t.infer_shape(data=SHAPE)
    assert ts == tuple([tuple(s) for s in part] for part in js)


# fp32: the same ops, sums in another order (XLA:CPU against ATen)
def test_fp32_forward_matches(nets):
    n = nets
    internals = ["fc1_output", "stage3_unit1_conv2_output", "softmax_output"]
    jout = dict(zip(n["jnet"].get_internals().list_outputs(),
                    _jax_forward(n["jnet"].get_internals(), n["args"], n["aux"], n["x"])))
    tout = dict(zip(n["tnet"].get_internals().list_outputs(),
                    _torch_forward(n["tnet"].get_internals(), n["args"], n["aux"], n["x"])))
    for name in internals:
        np.testing.assert_allclose(tout[name], jout[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tout["softmax_output"].sum(1), 1.0, rtol=1e-6)


def test_quantize_model_rewrites_the_graph_as_jax_does(quantized):
    (jqsym, jqargs, _), (tqsym, tqargs, _) = quantized
    jnodes = [(n.name, None if n.is_var else n.op.name) for n in jqsym._walk()]
    tnodes = [(n.name, None if n.is_var else n.op.name) for n in tqsym._walk()]
    assert tnodes == jnodes
    assert tqsym.list_arguments() == jqsym.list_arguments()
    ops = [op for _, op in tnodes]
    # conv0 and the three convs of each of the 3 units; fc1 stays fp32;
    # a unit's relu1 feeds conv1 and the shortcut and is quantized once
    assert ops.count("_contrib_quantized_conv") == 10
    assert ops.count("_contrib_quantize") == 7
    assert ops.count("_contrib_dequantize") == 10
    assert ops.count("FullyConnected") == 1
    # the offline int8 weights and their ranges: exact
    assert sorted(tqargs) == sorted(jqargs)
    for k, v in jqargs.items():
        assert tqargs[k].numpy().dtype == v.asnumpy().dtype, k
        np.testing.assert_array_equal(tqargs[k].numpy(), v.asnumpy(), err_msg=k)
    assert all(tqargs[k].dtype == torch.int8 for k in tqargs if k.endswith("_quantize"))


# calibrated ranges: min / max of fp32 activations that agree to ~1e-6
def test_naive_calibration_matches(quantized):
    (jqsym, _, _), (tqsym, _, _) = quantized
    jr, tr = _requantize_ranges(jqsym), _requantize_ranges(tqsym)
    assert sorted(tr) == sorted(jr) and len(jr) == 10
    for k in jr:
        assert None not in jr[k]
        np.testing.assert_allclose(tr[k], jr[k], rtol=1e-5, err_msg=k)


# the same host-numpy KL search on the same array: equal results (1001
# histogram bins instead of 8001 keep it to a fraction of a second); then the
# port's entropy calibration of one layer uses that search on the layer's
# activations over both calibration batches
def test_entropy_calibration_matches(nets, monkeypatch):
    x = np.random.RandomState(9).standard_t(4, 20000).astype(np.float32)
    j = jquant._get_optimal_threshold(x, num_bins=1001)
    t = tquant._get_optimal_threshold(x, num_bins=1001)
    assert t == j and 0 < t[3] < np.abs(x).max()

    n = nets
    search = functools.partial(tquant._get_optimal_threshold, num_bins=1001)
    monkeypatch.setattr(tquant, "_get_optimal_threshold", search)
    qsym, _, _ = tquant.quantize_model(
        n["tnet"], n["args"], n["aux"], device="cpu", excluded_sym_names=["fc1"],
        calib_mode="entropy", calib_layer=lambda name: name == "conv0_output",
        calib_data=NDArrayIter(torch.from_numpy(n["calib"]), batch_size=4))
    internals = n["tnet"].get_internals()
    at = internals.list_outputs().index("conv0_output")
    acts = [_torch_forward(internals, n["args"], n["aux"], n["calib"][i:i + 4])[at]
            for i in (0, 4)]  # batch by batch, as the calibration ran
    th = search(np.concatenate([a.ravel() for a in acts]))[3]
    ranges = _requantize_ranges(qsym)
    assert ranges.pop("conv0_requantize") == (-th, th)
    assert set(ranges.values()) == {(None, None)}


def test_int8_forward_on_the_jax_qargs_matches_jax(nets, quantized):
    """The port's int8 graph with the JAX side's offline int8 weights and
    calibrated ranges, on the same input.  A float32 op summed in another
    order could flip one quantize level at a tie; at this seed no int8 or
    int32 value of any node differs (0 of ~1.2 M), and the probabilities
    agree to 1e-6."""
    n = nets
    (jqsym, jqargs, _), _ = quantized
    tq_none, _, _ = tquant.quantize_model(n["tnet"], n["args"], n["aux"], device="cpu",
                                          excluded_sym_names=["fc1"], calib_mode="none")
    th = {k[: -len("_requantize")] + "_output": v
          for k, v in _requantize_ranges(jqsym).items()}
    tqsym = tquant._calibrate_quantized_sym(tq_none, th)
    targs, taux = symbol_params_from_jax(
        tqsym, {k: v.asnumpy() for k, v in jqargs.items()}, n["aux"], device="cpu",
        data=SHAPE)
    jaux = {k: nd.array(v) for k, v in n["aux"].items()}
    jint = jqsym.get_internals()
    tint = tqsym.get_internals()
    assert tint.list_outputs() == jint.list_outputs()
    jouts = _jax_forward(jint, jqargs, jaux, n["x"])
    touts = _torch_forward(tint, targs, taux, n["x"])
    total = differ = 0
    for name, jo, to in zip(jint.list_outputs(), jouts, touts):
        assert to.dtype == jo.dtype, name
        if jo.dtype in (np.int8, np.int32):
            total += jo.size
            differ += int((jo != to).sum())
    assert total > 1_000_000 and differ == 0
    np.testing.assert_allclose(touts[-1], jouts[-1], rtol=0, atol=1e-6)


def test_simple_bind_allocates_int8_for_the_offline_weights(quantized):
    _, (tqsym, tqargs, _) = quantized
    exe = tqsym.simple_bind(device="cpu", grad_req="null", data=SHAPE)
    for name, t in exe.arg_dict.items():
        want = torch.int8 if name.endswith("_quantize") else torch.float32
        assert t.dtype == want, name
    for name, v in tqargs.items():
        assert exe.arg_dict[name].shape == v.shape, name
    assert all(t.device.type == "cpu" for t in exe.arg_arrays + exe.aux_arrays)


def test_executor_runs_inference_only(nets):
    """The inference forward runs under ``torch.inference_mode`` (its
    outputs are inference tensors and change no moving statistic); the
    training forward and ``backward`` now run too (the symbolic training
    path, tests/test_torch_module.py holds them against the JAX package)."""
    exe = nets["tnet"].simple_bind(device="cpu", data=SHAPE)
    for k, v in nets["args"].items():
        exe.arg_dict[k].copy_(torch.as_tensor(v))
    aux = {k: v.clone() for k, v in exe.aux_dict.items()}
    x = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    out = exe.forward(data=x)[0]
    assert out.is_inference() and all(torch.equal(v, aux[k]) for k, v in exe.aux_dict.items())
    with pytest.raises(RuntimeError, match="forward"):
        nets["tnet"].simple_bind(device="cpu", data=SHAPE).backward()
    train = exe.forward(is_train=True, data=x, softmax_label=np.arange(4.0))[0]
    assert not train.is_inference() and train.shape == out.shape
    assert any(not torch.equal(v, aux[k]) for k, v in exe.aux_dict.items())
    exe.backward()
    assert float(exe.grad_dict["fc1_weight"].abs().max()) > 0
    with pytest.raises(ValueError, match="unknown argument"):
        exe.forward(image=np.zeros(SHAPE, np.float32))


def test_symbol_structure():
    with tsym.NameManager():
        a = tsym.Variable("a")
        b = tsym.Variable("b")
        s = a + b
        t = tsym.Flatten(s) + a
        q = tsym.contrib.quantize(a, tsym.min(a, name="amin"), tsym.max(a), out_type="int8")
    assert s.name == "broadcast_add0" and t.name == "broadcast_add1"
    assert t.list_arguments() == ["a", "b"]
    assert q.list_outputs() == ["contrib_quantize0_output%d" % i for i in range(3)]
    assert q[1].list_outputs() == ["contrib_quantize0_output1"]
    assert [n.name for n in q._walk()] == ["a", "amin", "max0", "contrib_quantize0"]
    g = tsym.Group([s, q[0]])
    assert g.list_outputs() == ["broadcast_add0_output", "contrib_quantize0_output0"]
    assert g.infer_shape(a=(2, 3), b=(2, 3))[1] == [(2, 3), (2, 3)]
    assert q.infer_shape(a=(5,))[1] == [(5,), (1,), (1,)]
    with pytest.raises(ValueError, match="unknown for"):
        s.infer_shape(a=(2, 3))
    with pytest.raises(TypeError):
        a + 1.0  # noqa: B018  (_plus_scalar is not ported)


def test_ndarray_iter_pads_the_last_batch_by_wrapping():
    x = torch.arange(10.0).reshape(5, 2)
    it = NDArrayIter(x, torch.arange(5), batch_size=2)
    batches = list(it)
    assert [b.pad for b in batches] == [0, 0, 1]
    assert batches[-1].data[0].tolist() == [[8.0, 9.0], [0.0, 1.0]]
    assert batches[-1].label[0].tolist() == [4, 0]
    assert list(it) == []  # one pass
    with pytest.raises(ValueError, match="batch_size"):
        NDArrayIter(x, batch_size=6)


def test_symbol_params_from_jax_checks_names_and_shapes(nets):
    n = nets
    args, aux = symbol_params_from_jax(n["tnet"], n["args"], n["aux"], device="cpu",
                                       data=SHAPE)
    assert sorted(args) == sorted(n["args"]) and sorted(aux) == sorted(n["aux"])
    with pytest.raises(KeyError, match="extra_weight"):
        symbol_params_from_jax(n["tnet"], dict(n["args"], extra_weight=np.zeros(3)),
                               n["aux"], device="cpu", data=SHAPE)
    with pytest.raises(ValueError, match="fc1_bias"):
        symbol_params_from_jax(n["tnet"], dict(n["args"], fc1_bias=np.zeros(7)),
                               n["aux"], device="cpu", data=SHAPE)
