"""The pieces around the port's Module (mxnet_tpu_torch: symbol JSON,
``NDArrayIter``, initializers, learning-rate schedules, metrics, the
optimizer's multipliers) against the JAX package, on the CPU.

The JSON files of either package load in the other, with equal graphs and
``infer_shape``; the iterators give equal batches; the schedules, metrics
and multipliers equal values.  The initializers draw from another random
stream than the JAX package's, so they are held to their distributions and
their name dispatch.
"""
import math

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU before mxnet_tpu)

import mxnet_tpu as mx
from mxnet_tpu import lr_scheduler as jlrs
from mxnet_tpu import metric as jmetric
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import symbol as jsymmod
from mxnet_tpu.io import NDArrayIter as JaxIter
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.io import DataDesc, NDArrayIter
from mxnet_tpu_torch.models import resnet_symbol

from conftest import load_example_module

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _resnet8():
    m = load_example_module(
        "image_classification_resnet_symbols",
        str(ROOT / "examples" / "image-classification" / "symbols" / "resnet.py"))
    with JaxNameManager():
        j = m.get_symbol(10, 8, "3,28,28")
    with tsym.NameManager():
        return j, resnet_symbol.get_symbol(10, 8, "3,28,28")


def _mlp(S):
    data = S.var("data")
    h = S.Activation(S.FullyConnected(data, name="fc1", num_hidden=16), name="a1",
                     act_type="relu")
    h = S.Dropout(h, p=0.5, name="drop")
    return S.SoftmaxOutput(S.FullyConnected(h, name="fc2", num_hidden=10), name="softmax",
                           normalization="valid", use_ignore=True)


def _mlp_pair():
    with JaxNameManager():
        j = _mlp(mx.sym)
    with tsym.NameManager():
        return j, _mlp(tsym)


# -- symbol JSON --------------------------------------------------------------


@pytest.mark.parametrize("net", ["mlp", "resnet8"])
def test_symbol_json_round_trips_both_ways(net, tmp_path):
    """The port writes the JAX package's JSON for the same graph; a file of
    either package loads in the other and writes the same JSON again; a
    JAX-written file binds in the port with the JAX symbol's shapes."""
    import json

    jsym, psym = _mlp_pair() if net == "mlp" else _resnet8()
    assert json.loads(psym.tojson()) == json.loads(jsym.tojson())
    assert jsymmod.load_json(psym.tojson()).tojson() == jsym.tojson()
    path = tmp_path / "net-symbol.json"
    jsym.save(str(path))
    loaded = tsym.load(str(path))
    assert loaded.tojson() == jsym.tojson()
    shape = (4, 128) if net == "mlp" else (4, 3, 28, 28)
    assert loaded.list_arguments() == jsym.list_arguments()
    assert loaded.list_auxiliary_states() == jsym.list_auxiliary_states()
    assert loaded.list_outputs() == jsym.list_outputs()
    assert loaded.infer_shape(data=shape) == tuple(
        [tuple(s) for s in part] for part in jsym.infer_shape(data=shape))
    exe = loaded.simple_bind(device="cpu", data=shape)
    out = exe.forward(data=torch.randn(shape, generator=torch.Generator().manual_seed(0)))
    assert out[0].shape == (4, 10) and torch.isfinite(out[0]).all()


def test_attr_dict_gives_the_optimizer_its_multipliers():
    """``__lr_mult__`` / ``__wd_mult__`` on variables reach the optimizer as
    in the JAX package; names ending neither in _weight nor _gamma get no
    weight decay."""
    def build(S):
        w = S.Variable("fc_weight", attr={"__lr_mult__": "0.5", "__wd_mult__": "2"})
        b = S.Variable("fc_bias", attr={"__lr_mult__": "3"})
        fc = S.FullyConnected(S.var("data"), weight=w, bias=b, num_hidden=4, name="fc")
        return S.BatchNorm(fc, name="bn", fix_gamma=False)

    jsym, psym = build(mx.sym), build(tsym)
    assert psym.attr_dict()["fc_weight"] == {"__lr_mult__": "0.5", "__wd_mult__": "2"}
    assert psym.attr_dict()["bn"]["fix_gamma"] == jsym.attr_dict()["bn"]["fix_gamma"]
    names = [n for n in jsym.list_arguments() if n != "data"]
    got = []
    for mod, sym in ((jopt, jsym), (topt, psym)):
        opt = mod.SGD(learning_rate=0.1, wd=0.01, sym=sym,
                      param_idx2name=dict(enumerate(names)))
        opt.set_lr_mult({})
        opt.set_wd_mult({})
        got.append([(opt._get_lr(i), opt._get_wd(i)) for i in range(len(names))])
    assert got[0] == got[1]
    want = {"fc_weight": (0.05, 0.02), "fc_bias": (0.3, 0.0), "bn_gamma": (0.1, 0.01),
            "bn_beta": (0.1, 0.0)}
    assert {k: pytest.approx(v) for k, v in zip(names, got[1])} == want


def test_dropout_in_a_bound_symbol_draws_from_the_executors_generator():
    """Dropout nodes take masks from the executor's generator, seeded at
    bind: two binds repeat the same masks, two training forwards of one
    bind draw different ones (the global random state untouched), and
    inference passes the data through."""
    _, psym = _mlp_pair()
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0.0, 1.0, -1.0, 3.0])
    runs = []
    for _ in range(2):
        exe = psym.simple_bind(device="cpu", data=(4, 8))
        for k, v in exe.arg_dict.items():
            if k.endswith("weight"):
                v.copy_(torch.randn(v.shape, generator=torch.Generator().manual_seed(1)))
        global_state = torch.get_rng_state()
        outs = [exe.forward(is_train=True, data=x, softmax_label=y)[0] for _ in range(2)]
        assert torch.equal(torch.get_rng_state(), global_state)
        exe.backward()  # the last forward's masks again: a finite gradient
        assert torch.isfinite(exe.grad_dict["fc1_weight"]).all()
        runs.append(outs)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][0], runs[0][1])
    inf = exe.forward(data=x)[0]
    assert torch.equal(exe.forward(data=x)[0], inf)  # no mask drawn
    torch.testing.assert_close(inf.sum(1), torch.ones(4))


# -- NDArrayIter ----------------------------------------------------------------


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_last_batch_handles_match_jax(handle):
    """Two epochs of 10 samples in batches of 4: the batches, their pads
    and ``provide_data`` / ``provide_label`` equal the JAX iterator's."""
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    y = np.arange(10, dtype=np.float32)
    jit = JaxIter(x, y, batch_size=4, last_batch_handle=handle)
    pit = NDArrayIter(torch.from_numpy(x), torch.from_numpy(y), batch_size=4,
                      last_batch_handle=handle)
    assert [(d.name, d.shape) for d in pit.provide_data] == \
        [(d.name, tuple(d.shape)) for d in jit.provide_data] == [("data", (4, 3))]
    assert [(d.name, d.shape) for d in pit.provide_label] == [("softmax_label", (4,))]
    for _ in range(2):
        jb, pb = list(jit), list(pit)
        assert len(pb) == len(jb) == (2 if handle == "discard" else 3)
        for a, b in zip(pb, jb):
            assert a.pad == b.pad
            np.testing.assert_array_equal(a.data[0].numpy(), b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].numpy(), b.label[0].asnumpy())
        jit.reset()
        pit.reset()


def test_ndarray_iter_shuffles_from_its_generator():
    x = torch.arange(12.0)
    order = lambda seed: torch.cat([b.data[0] for b in NDArrayIter(
        x, batch_size=4, shuffle=True, generator=torch.Generator().manual_seed(seed))])
    assert torch.equal(order(3), order(3)) and not torch.equal(order(3), order(4))
    assert sorted(order(3).tolist()) == x.tolist()
    assert DataDesc("data", [2, 3]).shape == (2, 3)


# -- initializers ------------------------------------------------------------------


def test_initializer_name_dispatch():
    init = tinit.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2,
                        generator=torch.Generator().manual_seed(0))
    t = lambda *s: torch.full(s, 7.0)
    for name, want in (("fc1_bias", 0.0), ("bn_beta", 0.0), ("bn_gamma", 1.0),
                       ("bn_moving_mean", 0.0), ("bn_moving_var", 1.0),
                       ("bn_running_var", 1.0), ("q_min", 0.0)):
        arr = t(5)
        init(tinit.InitDesc(name), arr)
        assert (arr == want).all(), name
    arr = t(4, 3)
    init(tinit.InitDesc("fc_weight", {"__init__": tinit.Constant(0.25).dumps()}), arr)
    assert (arr == 0.25).all()
    with pytest.raises(ValueError, match="Unknown initialization pattern"):
        init("mystery", t(2))
    assert isinstance(tinit.create("orthogonal"), tinit.Orthogonal)
    with pytest.raises(ValueError, match="not registered"):
        tinit.create("mystery")
    assert isinstance(tinit.create("zeros"), tinit.Zero)


@pytest.mark.parametrize("kind", ["uniform", "normal", "xavier_gaussian_in", "xavier_avg",
                                  "msra"])
def test_initializer_statistics(kind):
    """Each rule's spread over a (256, 64, 3, 3) weight, and the same values
    from the same seed."""
    shape = (256, 64, 3, 3)
    fan_in, fan_out = 64 * 9, 256 * 9
    rule, std = {
        "uniform": (lambda g: tinit.Uniform(0.07, generator=g), 0.07 / math.sqrt(3)),
        "normal": (lambda g: tinit.Normal(0.02, generator=g), 0.02),
        "xavier_gaussian_in": (lambda g: tinit.Xavier("gaussian", "in", 2, generator=g),
                               math.sqrt(2.0 / fan_in)),
        "xavier_avg": (lambda g: tinit.Xavier(generator=g),
                       math.sqrt(3.0 / ((fan_in + fan_out) / 2)) / math.sqrt(3)),
        "msra": (lambda g: tinit.MSRAPrelu(generator=g),
                 math.sqrt(2.0 / 1.0625 / ((fan_in + fan_out) / 2))),
    }[kind]
    a, b = torch.empty(shape), torch.empty(shape)
    rule(torch.Generator().manual_seed(1))("conv_weight", a)
    rule(torch.Generator().manual_seed(1))("conv_weight", b)
    assert torch.equal(a, b)
    assert abs(float(a.mean())) < 0.02 * std
    assert abs(float(a.std()) / std - 1) < 0.01
    if kind in ("uniform", "xavier_avg"):
        assert float(a.abs().max()) <= std * math.sqrt(3)


# -- schedules, metrics -----------------------------------------------------------------


def test_lr_schedulers_match_jax():
    for jsched, tsched in ((jlrs.FactorScheduler(3, 0.5, stop_factor_lr=1e-3),
                            tlrs.FactorScheduler(3, 0.5, stop_factor_lr=1e-3)),
                           (jlrs.MultiFactorScheduler([2, 5, 9], 0.1, warmup_steps=1),
                            tlrs.MultiFactorScheduler([2, 5, 9], 0.1, warmup_steps=1))):
        jsched.base_lr = tsched.base_lr = 0.05
        assert [tsched(i) for i in range(30)] == [jsched(i) for i in range(30)]
    with pytest.raises(ValueError):
        tlrs.MultiFactorScheduler([5, 2])


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.ones(6), size=20).astype(np.float32)
    labels = rng.randint(0, 6, 20).astype(np.float32)
    for make in (lambda m: m.Accuracy(), lambda m: m.TopKAccuracy(top_k=3),
                 lambda m: m.CrossEntropy(), lambda m: m.create(["acc", "ce"]),
                 lambda m: m.create("top_k_accuracy", top_k=2)):
        jm, tm = make(jmetric), make(tmetric)
        for i in (0, 10):
            jm.update([mx.nd.array(labels[i:i + 10])], [mx.nd.array(probs[i:i + 10])])
            tm.update([torch.from_numpy(labels[i:i + 10])], [torch.from_numpy(probs[i:i + 10])])
        (jn, jv), (tn, tv) = jm.get(), tm.get()
        assert tn == jn
        np.testing.assert_allclose(tv, jv, rtol=1e-6)
        tm.reset()
        assert math.isnan(tm.get_name_value()[0][1])
    assert isinstance(tmetric.create("f1"), tmetric.F1)
    with pytest.raises(ValueError, match="not registered"):
        tmetric.create("mystery")


def test_ndarray_files_cross_packages(tmp_path):
    """``ndarray.save`` of each package loads in the other: dicts, lists and
    single arrays."""
    d = {"arg:w": np.arange(6, dtype=np.float32).reshape(2, 3), "aux:m": np.ones(3, np.float32)}
    tnd.save(str(tmp_path / "t.params"), {k: torch.from_numpy(v) for k, v in d.items()})
    got = mx.nd.load(str(tmp_path / "t.params"))
    assert sorted(got) == sorted(d) and all((got[k].asnumpy() == v).all() for k, v in d.items())
    mx.nd.save(str(tmp_path / "j.params"), [mx.nd.array(v) for v in d.values()])
    back = tnd.load(str(tmp_path / "j.params"))
    assert [b.numpy().tolist() for b in back] == [v.tolist() for v in d.values()]
    tnd.save(str(tmp_path / "s.params"), torch.ones(2))
    assert [a.asnumpy().tolist() for a in mx.nd.load(str(tmp_path / "s.params"))] == [[1.0, 1.0]]
