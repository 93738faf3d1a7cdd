"""The port's int8 quantization operators (mxnet_tpu_torch/ops/quantization.py)
and the plain versions of its int8 kernel pair (ops/kernels.py) against the
JAX package, on the CPU.

The same numpy inputs go through both sides.  Every integer output (int8,
uint8 and the int32 accumulators) and every range must be equal exactly: the
scales are computed in the same float32 operation order, and integer sums
are exact in any order.  tests/test_torch_cuda.py holds the CUDA kernels
against these plain versions on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import quantization as jq
from mxnet_tpu.ops.pallas_kernels import dequantize_int8_pallas, quantize_int8_pallas
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops import quantization as tq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps this file off the cores that
    the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _r(v):
    return np.array([v], np.float32)


def _equal(jax_outs, torch_outs):
    """Exact equality of every output, dtype included."""
    jax_outs = jax_outs if isinstance(jax_outs, tuple) else (jax_outs,)
    torch_outs = torch_outs if isinstance(torch_outs, tuple) else (torch_outs,)
    assert len(jax_outs) == len(torch_outs)
    for j, t in zip(jax_outs, torch_outs):
        j = np.asarray(j)
        assert j.dtype == t.numpy().dtype, (j.dtype, t.dtype)
        np.testing.assert_array_equal(t.numpy(), j)


def _quantized_input(rng, shape, out_type):
    x = (rng.randn(*shape) * 3).astype(np.float32)
    mn, mx = _r(x.min()), _r(x.max())
    j = jq.quantize(jnp.asarray(x), jnp.asarray(mn), jnp.asarray(mx), out_type=out_type)
    t = tq.quantize(_t(x), _t(mn), _t(mx), out_type=out_type)
    return j, t


# exact: the int8 / uint8 values and the ranges
@pytest.mark.parametrize("out_type", ["int8", "uint8"])
@pytest.mark.parametrize("shape", [(7,), (2, 5, 9, 11), (3, 8, 384)])
def test_quantize_matches_jax(out_type, shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    for mn, mx in ((x.min(), x.max()), (-0.7, 1.9)):  # the second saturates
        _equal(jq.quantize(jnp.asarray(x), jnp.asarray(_r(mn)), jnp.asarray(_r(mx)),
                           out_type=out_type),
               tq.quantize(_t(x), _t(_r(mn)), _t(_r(mx)), out_type=out_type))


# exact: one float32 multiply (uint8: and one add) per element on both sides
@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
def test_dequantize_matches_jax(dtype):
    rng = np.random.RandomState(1)
    info = np.iinfo(dtype)
    lo, hi = (-127, 128) if dtype == "int8" else (info.min // 2, info.max // 2)
    q = rng.randint(lo, hi, (3, 7, 5)).astype(dtype)
    mn, mx = _r(-2.5), _r(3.25)
    _equal(jq.dequantize(jnp.asarray(q), jnp.asarray(mn), jnp.asarray(mx)),
           tq.dequantize(_t(q), _t(mn), _t(mx)))


def _accumulator(rng, shape):
    """An int32 accumulator with its range, as quantized_conv gives them."""
    acc = rng.randint(-2**28, 2**28, shape).astype(np.int32)
    one = np.float32(3.1e-6)
    return acc, _r(one * np.float32(-(2**31 - 1))), _r(one * np.float32(2**31 - 1))


# exact: the int8 values and the output range
@pytest.mark.parametrize("calibrated", [True, False])
def test_requantize_matches_jax(calibrated):
    rng = np.random.RandomState(2)
    acc, mn, mx = _accumulator(rng, (2, 6, 5, 5))
    kw = dict(min_calib_range=-301.5, max_calib_range=287.25) if calibrated else {}
    _equal(jq.requantize(jnp.asarray(acc), jnp.asarray(mn), jnp.asarray(mx), **kw),
           tq.requantize(_t(acc), _t(mn), _t(mx), **kw))


CONV_GEOMETRY = {
    "3x3-s2-p1": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    "3x3-d2-p21": dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 1)),
    "1x1": dict(kernel=(1, 1)),
    "7x7-s2-p3": dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3)),  # K = 147
}


# exact: the int32 accumulator (zero-point and bias corrections included)
# and its range
@pytest.mark.parametrize("out_type", ["int8", "uint8"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("geom", list(CONV_GEOMETRY))
def test_quantized_conv_matches_jax(out_type, bias, geom):
    rng = np.random.RandomState(3)
    kw = dict(CONV_GEOMETRY[geom], num_filter=6, no_bias=not bias)
    jd, td = _quantized_input(rng, (2, 4, 11, 9), out_type)
    w = rng.randint(-127, 128, (6, 4) + kw["kernel"]).astype(np.int8)
    wr = (_r(-0.31), _r(0.4))
    jargs = [jd[0], jnp.asarray(w), jd[1], jd[2], *map(jnp.asarray, wr)]
    targs = [td[0], _t(w), td[1], td[2], *map(_t, wr)]
    if bias:
        b = rng.randint(-127, 128, (6,)).astype(np.int8)
        br = (_r(-0.05), _r(0.02))
        jargs += [jnp.asarray(b), *map(jnp.asarray, br)]
        targs += [_t(b), *map(_t, br)]
    _equal(jq.quantized_conv(*jargs, **kw), tq.quantized_conv(*targs, **kw))


# exact: the int32 accumulator and its range; batch 3 pads M to 17 rows,
# 45 inputs pad K to 48
@pytest.mark.parametrize("out_type", ["int8", "uint8"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("batch", [3, 40])
def test_quantized_fully_connected_matches_jax(out_type, bias, batch):
    rng = np.random.RandomState(4)
    jd, td = _quantized_input(rng, (batch, 5, 3, 3), out_type)
    w = rng.randint(-127, 128, (10, 45)).astype(np.int8)
    wr = (_r(-0.2), _r(0.25))
    jargs = [jd[0], jnp.asarray(w), jd[1], jd[2], *map(jnp.asarray, wr)]
    targs = [td[0], _t(w), td[1], td[2], *map(_t, wr)]
    if bias:
        b = rng.randint(-127, 128, (10,)).astype(np.int8)
        jargs += [jnp.asarray(b), jnp.asarray(_r(-0.1)), jnp.asarray(_r(0.1))]
        targs += [_t(b), _t(_r(-0.1)), _t(_r(0.1))]
    kw = dict(num_hidden=10, no_bias=not bias)
    _equal(jq.quantized_fully_connected(*jargs, **kw),
           tq.quantized_fully_connected(*targs, **kw))


POOLS = {
    "max": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
    "avg": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg"),
    "avg-full-nopad": dict(kernel=(2, 2), stride=(2, 2), pool_type="avg",
                           pooling_convention="full", count_include_pad=False),
    "avg-global": dict(pool_type="avg", global_pool=True),
    "max-global": dict(pool_type="max", global_pool=True),
}


# exact: max picks an input; the averages divide an exact integer sum the
# same way and truncate
@pytest.mark.parametrize("pool", list(POOLS))
def test_quantized_pooling_matches_jax(pool):
    rng = np.random.RandomState(5)
    jd, td = _quantized_input(rng, (2, 3, 7, 9), "int8")
    _equal(jq.quantized_pooling(*jd, **POOLS[pool]), tq.quantized_pooling(*td, **POOLS[pool]))


def test_quantized_flatten_and_act_match_jax():
    rng = np.random.RandomState(6)
    jd, td = _quantized_input(rng, (2, 3, 4, 5), "int8")
    _equal(jq.quantized_flatten(*jd), tq.quantized_flatten(*td))
    _equal(jq.quantized_act(*jd, act_type="relu"), tq.quantized_act(*td, act_type="relu"))
    ju, tu = _quantized_input(rng, (2, 3), "uint8")
    with pytest.raises(ValueError, match="zero point"):
        tq.quantized_act(*tu)


# exact, as tests/test_pallas_kernels.py:19 holds the Pallas kernels to the
# formula; tile-aligned shapes, which the Pallas kernels need
@pytest.mark.parametrize("shape", [(16, 256), (3, 8, 384)])
def test_int8_plain_versions_match_pallas_interpret(shape):
    rng = np.random.RandomState(7)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    x.flat[:4] = [0.0, -0.0, 1e-30, -5.0]
    for rr in (np.abs(x).max(), np.float32(2.0)):
        r = np.float32(rr)
        jqv = quantize_int8_pallas(jnp.asarray(x), jnp.asarray(r), interpret=True)
        tqv = kernels.quantize_int8_plain(_t(x), torch.tensor(r))
        _equal(jqv, tqv)
        _equal(dequantize_int8_pallas(jqv, jnp.asarray(r), interpret=True),
               kernels.dequantize_int8_plain(tqv, torch.tensor(r)))


# exact: the edge cases of the formula against the JAX op on the CPU
# (its jnp branch): ±0 and NaN give 0, a zero range on zeros gives zeros,
# infinities saturate
@pytest.mark.parametrize("case", ["signed-zeros-nan-inf", "zero-range"])
def test_int8_plain_edge_cases_match_jax(case):
    if case == "zero-range":
        x = np.zeros(37, np.float32)
        x[5] = -0.0
        mn = mx = _r(0.0)
    else:
        x = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 0.5, -0.5, 1e-30,
                      126.5, -126.5, 127.0, 300.0], np.float32)
        mn, mx = _r(-127.0), _r(127.0)
    _equal(jq.quantize(jnp.asarray(x), jnp.asarray(mn), jnp.asarray(mx), out_type="int8"),
           tq.quantize(_t(x), _t(mn), _t(mx), out_type="int8"))
    real = torch.tensor(float(max(abs(mn[0]), abs(mx[0]))))
    q = kernels.quantize_int8(_t(x), real)
    assert not bool(q[np.isnan(x)].any())


def test_int8_wrappers_take_the_plain_version_on_cpu_and_meta_and_check_args():
    kernels.reset_launches()
    x = torch.randn(5, 3)
    r = x.abs().max()
    assert torch.equal(kernels.quantize_int8(x, r), kernels.quantize_int8_plain(x, r))
    q = kernels.quantize_int8(x, r)
    assert torch.equal(kernels.dequantize_int8(q, r), kernels.dequantize_int8_plain(q, r))
    meta = kernels.quantize_int8(x.to("meta"), r.to("meta"))
    assert meta.shape == x.shape and meta.dtype == torch.int8 and meta.device.type == "meta"
    assert kernels.quantize_int8.launches == 0 and kernels.dequantize_int8.launches == 0
    with pytest.raises(ValueError, match="float32"):
        kernels.quantize_int8(x.double(), r)
    with pytest.raises(ValueError, match="0-d"):
        kernels.quantize_int8(x, r.reshape(1))
    with pytest.raises(ValueError, match="int8"):
        kernels.dequantize_int8(q.to(torch.int32), r)


def test_int_matmul_pads_to_what_int_mm_takes():
    """M <= 16, K and O not multiples of 8: the padded product equals the
    exact one (int64 numpy)."""
    rng = np.random.RandomState(8)
    for m, k, o in ((1, 3, 5), (16, 147, 64), (40, 64, 10)):
        a = rng.randint(-127, 128, (m, k)).astype(np.int8)
        w = rng.randint(-127, 128, (o, k)).astype(np.int8)
        got = tq._int_matmul(_t(a), _t(w))
        assert got.dtype == torch.int32 and got.shape == (m, o)
        np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64).T)
