"""The port's training vocabulary against the JAX package on the CPU: the
optimizers (three updates each, ``multi_precision`` on bf16 weights), every
registered metric, the initializers, the Poly and Cosine schedules and the
one-process kvstore.

Tolerances: the optimizers' weights and states within rtol 1e-6 (1e-5 for
Nadam and Ftml, whose powers of the update count compound), atol 1e-7;
metrics and schedules within rtol 1e-6; initializers equal, but
Orthogonal, whose random draw cannot repeat numpy's: checked for
orthogonality at its scale.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

# the 13 optimizers this slice ports, RMSProp's centred form, and
# multi_precision on bf16 weights for SGD, NAG and Adam
OPTIMIZERS = {
    "nag": dict(momentum=0.9),
    "signum": dict(momentum=0.9, wd_lh=0.01),
    "signum-nomom": dict(momentum=0.0),
    "sgld": {},
    "dcasgd": dict(momentum=0.9, lamda=0.1),
    "adagrad": dict(eps=1e-6),
    "adadelta": dict(rho=0.8),
    "adamax": {},
    "nadam": {},
    "rmsprop": dict(clip_weights=0.9),
    "rmsprop-centered": dict(centered=True),
    "ftrl": dict(lamda1=0.05),
    "ftml": {},
    "lbsgd": dict(momentum=0.9, eta=0.5),
    "test": {},
    "sgd-mp": dict(momentum=0.9, multi_precision=True),
    "nag-mp": dict(momentum=0.9, multi_precision=True),
    "adam-mp": dict(multi_precision=True),
}
COMPOUND = ("nadam", "ftml")
SHAPES = {0: ("fc_weight", (4, 5)), 1: ("fc_bias", (5,))}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    if hasattr(x, "asnumpy"):
        x = x._data
    return np.asarray(jnp.asarray(x, jnp.float32))


def _states(state):
    """A state (a tensor, NDArray, None, or a nested tuple) as a flat list
    of numpy arrays."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _states(s)]
    return [_np(state)]


@pytest.mark.parametrize("key", sorted(OPTIMIZERS))
def test_optimizer_three_updates_equal_jax(key, monkeypatch):
    name = key.split("-")[0]
    kw = dict(OPTIMIZERS[key])
    if key == "signum-nomom":
        kw["momentum"] = 0.0
    mp = kw.get("multi_precision", False)
    base = dict(learning_rate=0.05, wd=0.01, rescale_grad=0.5, clip_gradient=1.0,
                param_idx2name={i: n for i, (n, _) in SHAPES.items()})
    rng = np.random.RandomState(sum(map(ord, key)))
    w0 = {i: rng.uniform(-1, 1, s).astype(np.float32) for i, (_, s) in SHAPES.items()}
    grads = [{i: rng.uniform(-3, 3, s).astype(np.float32) for i, (_, s) in SHAPES.items()}
             for _ in range(3)]
    noise = [{i: rng.standard_normal(s).astype(np.float32) for i, (_, s) in SHAPES.items()}
             for _ in range(3)]
    dtype = jnp.bfloat16 if mp else jnp.float32
    if mp:  # bf16-representable starting weights
        w0 = {i: np.asarray(jnp.asarray(w, dtype).astype(jnp.float32)) for i, w in w0.items()}

    jopt = jmx.optimizer.create(name, **base, **kw)
    topt = tmx.optimizer.create(name, **base, **kw)
    for opt in (jopt, topt):
        opt.set_wd_mult({})
    step = {"n": 0}
    if name == "sgld":
        queue = []
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: queue.pop(0))
        topt.noise_source = lambda index, w: torch.from_numpy(noise[step["n"]][index])
    jupd, tupd = jmx.optimizer.get_updater(jopt), tmx.optimizer.get_updater(topt)
    jw = {i: jmx.nd.array(w, dtype=dtype) for i, w in w0.items()}
    # copies: a JAX array made from a numpy array on the CPU may share its
    # memory, and the port updates its weights in place
    tw = {i: torch.from_numpy(w.copy()).to(torch.bfloat16 if mp else torch.float32)
          for i, w in w0.items()}
    rtol = 1e-5 if name in COMPOUND else 1e-6
    for t in range(3):
        step["n"] = t
        for i in SHAPES:
            if name == "sgld":
                queue.append(jnp.asarray(noise[t][i]))
            jupd(i, jmx.nd.array(grads[t][i], dtype=dtype), jw[i])
            tupd(i, torch.from_numpy(grads[t][i]).to(tw[i].dtype), tw[i])
            np.testing.assert_allclose(_np(tw[i]), _np(jw[i]), rtol=rtol, atol=1e-7,
                                       err_msg="%s weight %d update %d" % (key, i, t))
            js, ts = _states(jupd.states[i]), _states(tupd.states[i])
            assert len(js) == len(ts), key
            for a, b in zip(ts, js):
                np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-7,
                                           err_msg="%s state %d update %d" % (key, i, t))


def test_create_takes_every_name_of_the_jax_registry():
    for name, klass in jmx.optimizer._OPT_REGISTRY.items():
        opt = tmx.optimizer.create(name.upper())
        assert type(opt).__name__ == klass.__name__, name


def test_optimizer_states_roundtrip_and_row_sparse_raises():
    opt = tmx.optimizer.create("adam", multi_precision=True)
    upd = tmx.optimizer.get_updater(opt)
    w = torch.ones(3, dtype=torch.bfloat16)
    upd(0, torch.full((3,), 0.5, dtype=torch.bfloat16), w)
    again = tmx.optimizer.get_updater(tmx.optimizer.create("adam", multi_precision=True))
    again.set_states(upd.get_states())
    w2 = w.clone()
    upd(0, torch.full((3,), 0.5, dtype=torch.bfloat16), w)
    again(0, torch.full((3,), 0.5, dtype=torch.bfloat16), w2)
    assert torch.equal(w, w2)
    with pytest.raises(NotImplementedError, match="A14"):
        tmx.optimizer.get_updater(tmx.optimizer.create("nag"))(
            0, torch.ones(2, 2).to_sparse(), torch.ones(2, 2))


# -- metrics ------------------------------------------------------------------

def _metric_inputs(rng):
    probs = rng.dirichlet(np.ones(4), 8).astype(np.float32)
    return {
        "class": ([rng.randint(0, 4, 8).astype(np.float32)], [probs]),
        "binary": ([rng.randint(0, 2, 8).astype(np.float32)],
                   [rng.dirichlet(np.ones(2), 8).astype(np.float32)]),
        "regression": ([rng.uniform(-1, 1, 8).astype(np.float32)],
                       [rng.uniform(-1, 1, 8).astype(np.float32)]),
    }


METRICS = {"acc": "class", "accuracy": "class", "top_k_accuracy": "class", "top_k_acc": "class",
           "ce": "class", "cross-entropy": "class", "nll_loss": "class", "perplexity": "class",
           "f1": "binary", "mcc": "binary", "mse": "regression", "rmse": "regression",
           "mae": "regression", "pearsonr": "regression", "loss": "regression",
           "np": "regression", "composite": "class"}


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_after_two_updates_equals_jax(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    batches = [_metric_inputs(rng)[METRICS[name]] for _ in range(2)]

    def make(pkg):
        if name == "np":
            return pkg.metric.np(lambda label, pred: float(np.abs(label - pred).sum()),
                                 name="abs")
        if name.startswith("top_k"):
            return pkg.metric.create(name, top_k=3)
        if name == "composite":
            return pkg.metric.create(["acc", "ce"])
        return pkg.metric.create(name)

    jm, tm = make(jmx), make(tmx)
    assert set(jmx.metric._METRIC_REGISTRY) <= set(tmx.metric._METRIC_REGISTRY)
    for labels, preds in batches:
        jm.update(labels, preds)
        tm.update([torch.from_numpy(a) for a in labels], [torch.from_numpy(a) for a in preds])
    jn, jv = jm.get()
    tn, tv = tm.get()
    assert tn == jn
    np.testing.assert_allclose(np.asarray(tv, np.float64), np.asarray(jv, np.float64),
                               rtol=1e-6)


def test_metric_create_takes_a_function():
    m = tmx.metric.create(lambda label, pred: (float(label.sum()), 2))
    m.update([np.ones(3)], [np.ones(3)])
    assert m.get() == ("custom(custom)", 1.5)


# -- initializers and schedules --------------------------------------------------

def _init_both(jinit, tinit, name, shape):
    jarr = jmx.nd.zeros(shape)
    tarr = torch.zeros(shape)
    jinit(name, jarr)
    tinit(name, tarr)
    return tarr.numpy(), jarr.asnumpy()


@pytest.mark.parametrize("shape", [(2, 1, 4, 4), (3, 1, 5, 5)])
def test_bilinear_equals_jax(shape):
    got, ref = _init_both(jmx.init.Bilinear(), tmx.init.Bilinear(), "up_weight", shape)
    np.testing.assert_array_equal(got, ref)


def test_mixed_load_and_fused_rnn_equal_jax(tmp_path):
    for pkg_init in (jmx.init, tmx.init):
        assert pkg_init.Mixed
    jm = jmx.init.Mixed([".*bias", ".*"], [jmx.init.Constant(0.5), jmx.init.Bilinear()])
    tm = tmx.init.Mixed([".*bias", ".*"], [tmx.init.Constant(0.5), tmx.init.Bilinear()])
    for name, shape in (("up_bias", (3,)), ("up_weight", (3, 1, 4, 4))):
        got, ref = _init_both(jm, tm, name, shape)
        np.testing.assert_array_equal(got, ref)
    values = {"arg:a_weight": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jl = jmx.init.Load({k: jmx.nd.array(v) for k, v in values.items()},
                       default_init=jmx.init.One())
    tl = tmx.init.Load({k: torch.from_numpy(v) for k, v in values.items()},
                       default_init=tmx.init.One())
    for name in ("a_weight", "b_weight"):
        got, ref = _init_both(jl, tl, name, (2, 3))
        np.testing.assert_array_equal(got, ref)
    with tmx.cpu():
        tmx.nd.save(str(tmp_path / "p.params"), {"arg:a_weight": tmx.nd.array(values[
            "arg:a_weight"])})
    got = torch.zeros(2, 3)
    tmx.init.Load(str(tmp_path / "p.params"))("a_weight", got)
    np.testing.assert_array_equal(got.numpy(), values["arg:a_weight"])
    with pytest.raises(ValueError):
        tmx.init.Load({})("c_weight", torch.zeros(1))
    for init in (tmx.init.Constant(0.3).dumps(), tmx.init.One()):
        jinit = jmx.init.FusedRNN(init if isinstance(init, str) else jmx.init.One(),
                                  num_hidden=4, num_layers=1, mode="lstm")
        tinit = tmx.init.FusedRNN(init, num_hidden=4, num_layers=1, mode="lstm")
        got, ref = _init_both(jinit, tinit, "lstm_parameters_weight", (40,))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(4, 6), (6, 2, 2)])
def test_orthogonal_is_orthogonal_at_its_scale(rand_type, shape):
    arr = torch.zeros(shape)
    tmx.init.Orthogonal(scale=1.5, rand_type=rand_type)("q_weight", arr)
    m = arr.reshape(shape[0], -1).double()
    gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
    np.testing.assert_allclose(gram.numpy(), 2.25 * np.eye(gram.shape[0]), atol=1e-5)
    assert tmx.init.create("orthogonal").scale == jmx.init.create("orthogonal").scale


@pytest.mark.parametrize("kind", ["poly", "cosine"])
def test_schedules_equal_jax_at_twenty_counts(kind):
    kw = dict(max_update=50, base_lr=0.2, final_lr=0.01, warmup_steps=5,
              warmup_begin_lr=0.02)
    if kind == "poly":
        jsch, tsch = (pkg.lr_scheduler.PolyScheduler(pwr=3, **kw) for pkg in (jmx, tmx))
    else:
        jsch, tsch = (pkg.lr_scheduler.CosineScheduler(**kw) for pkg in (jmx, tmx))
    counts = [0, 1, 3, 4, 5, 6, 9, 12, 17, 20, 24, 28, 31, 35, 40, 44, 48, 49, 50, 70]
    np.testing.assert_allclose([tsch(n) for n in counts], [jsch(n) for n in counts],
                               rtol=1e-6)


# -- the kvstore -------------------------------------------------------------------

def test_kvstore_push_pull_and_optimizer_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    init = {3: rng.uniform(-1, 1, (2, 3)).astype(np.float32),
            "w": rng.uniform(-1, 1, (4,)).astype(np.float32)}
    jkv, tkv = jmx.kvstore.create("device"), tmx.kvstore.create("device")
    assert (tkv.type, tkv.rank, tkv.num_workers) == (jkv.type, jkv.rank, jkv.num_workers)
    for k, v in init.items():
        jkv.init(k, jmx.nd.array(v))
        tkv.init(k, torch.from_numpy(v))
    # a list of replicas is summed; no updater: the sum is stored
    reps = [rng.uniform(-1, 1, (2, 3)).astype(np.float32) for _ in range(2)]
    jkv.push(3, [jmx.nd.array(r) for r in reps])
    tkv.push(3, [torch.from_numpy(r) for r in reps])
    jout, tout = jmx.nd.zeros((2, 3)), torch.zeros(2, 3)
    jkv.pull(3, out=jout)
    tkv.pull(3, out=tout)
    np.testing.assert_allclose(tout.numpy(), jout.asnumpy(), rtol=1e-6)
    for kv, pkg in ((jkv, jmx), (tkv, tmx)):
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1, momentum=0.9, wd=0.01))
    for t in range(3):
        g = rng.uniform(-1, 1, (4,)).astype(np.float32)
        jkv.push("w", jmx.nd.array(g))
        tkv.push("w", torch.from_numpy(g))
        jw, tw = jmx.nd.zeros((4,)), torch.zeros(4)
        jkv.pull("w", out=jw)
        tkv.pull("w", out=tw)
        np.testing.assert_allclose(tw.numpy(), jw.asnumpy(), rtol=1e-6, err_msg=str(t))
    tkv.save_optimizer_states(str(tmp_path / "kv.states"))
    tkv.load_optimizer_states(str(tmp_path / "kv.states"))
    with tmx.cpu():
        out = tmx.nd.zeros((4,))
        tkv.pushpull("w", tmx.nd.array(np.ones(4, np.float32)), out=out)
        bout = tmx.nd.zeros((2,))
        tkv.broadcast("b", tmx.nd.array(np.full(2, 7.0, np.float32)), out=bout)
        again = tmx.nd.zeros((4,))
        tkv.pull("w", out=again)
    assert out.asnumpy().tolist() == again.asnumpy().tolist() != tw.numpy().tolist()
    assert bout.asnumpy().tolist() == [7.0, 7.0]
    for name in ("dist_sync", "dist_device_sync", "dist_async", "nccl"):
        with pytest.raises(NotImplementedError, match="A10"):
            tmx.kvstore.create(name)
    with pytest.raises(NotImplementedError, match="A14"):
        tkv.row_sparse_pull("w", out=tw, row_ids=torch.tensor([0]))


def test_module_with_a_kvstore_keeps_the_fused_update(tmp_path):
    """A Module given a one-process KVStore takes the same fused step as
    with the string "device", bit for bit; the store holds the executor's
    own parameter tensors (a pull reads the module's weights, also after a
    re-bind) and shares the module's updater, so optimizer states saved
    through the store load into the module."""
    rng = np.random.RandomState(9)
    x = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(3)]
    y = [rng.randint(0, 3, 4).astype(np.float32) for _ in range(3)]
    sym = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(tmx.sym.Variable("data"),
                                                       num_hidden=3, name="fc"),
                                name="softmax")
    params = {"fc_weight": torch.from_numpy(rng.standard_normal((3, 6)).astype(np.float32)),
              "fc_bias": torch.zeros(3)}
    mods, kv = [], tmx.kvstore.create("device")
    for store in ("device", kv):
        mod = tmx.mod.Module(sym, device="cpu")
        mod.bind(data_shapes=[("data", (4, 6))], label_shapes=[("softmax_label", (4,))])
        mod.init_params(arg_params={k: v.clone() for k, v in params.items()})
        mod.init_optimizer(kvstore=store, optimizer="sgd",
                           optimizer_params=dict(learning_rate=0.1, momentum=0.9, wd=1e-3))
        for xs, ys in zip(x[:2], y[:2]):
            mod.forward_backward(tmx.io.DataBatch([torch.from_numpy(xs)],
                                                  [torch.from_numpy(ys)]))
            mod.update()
        mods.append(mod)
    for name, v in mods[0].get_params()[0].items():
        assert torch.equal(mods[1].get_params()[0][name], v), name
    out = torch.zeros(3, 6)
    kv.pull("fc_weight", out=out)
    assert torch.equal(out, mods[1].get_params()[0]["fc_weight"])
    kv.save_optimizer_states(str(tmp_path / "kv.states"))
    mods[0].load_optimizer_states(str(tmp_path / "kv.states"))
    for mod in mods:
        mod.reshape([("data", (2, 6))], [("softmax_label", (2,))])
        mod.forward_backward(tmx.io.DataBatch([torch.from_numpy(x[2][:2])],
                                              [torch.from_numpy(y[2][:2])]))
        mod.update()
    kv.pull("fc_weight", out=out)
    assert torch.equal(out, mods[1].get_params()[0]["fc_weight"])
    for name, v in mods[0].get_params()[0].items():
        assert torch.equal(mods[1].get_params()[0][name], v), name
