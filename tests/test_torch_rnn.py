"""The LSTM bucketing language model's path in the port (``ops/rnn.py``,
``mx.rnn``, ``BucketingModule``, Adam, ``Perplexity`` and the example)
against the JAX package on the CPU, on inputs made from numpy seeds.

Tolerances: the fused ``RNN`` op, forward and the gradients to every
input, within rtol 1e-5 (atol 1e-6); the cells' unrolled graphs within rtol
1e-5 (atol 1e-6); the bucketing LM, after three Adam steps that alternate
buckets, every output and parameter within rtol 1e-5 (atol 1e-6); the
iterator's batches, the vocabulary and the metric exactly or within
rtol 1e-6.
"""
import logging
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import rnn as jrnn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo.convert import symbol_params_from_jax
from mxnet_tpu_torch.ops import rnn as trnn
from xdist_shared import shared

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the fused RNN op -------------------------------------------------------------

OP_CASES = [(mode, layers, bi, clip) for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu")
            for layers, bi, clip in ((1, False, False), (2, True, mode == "lstm"))]


@pytest.mark.parametrize("mode,layers,bi,clip", OP_CASES)
def test_rnn_op_forward_and_gradients_against_jax(mode, layers, bi, clip):
    """Every output, and the gradients to data, parameters and the states
    under random cotangents on every output."""
    T, N, I, H = 5, 3, 4, 8
    d = 2 if bi else 1
    rng = np.random.RandomState(len(mode) * 10 + layers)
    size = jrnn.rnn_param_size(mode, I, H, layers, bi)
    assert trnn.rnn_param_size(mode, I, H, layers, bi) == size
    args = [rng.randn(T, N, I).astype(np.float32),
            (rng.randn(size) * 0.4).astype(np.float32),
            rng.randn(layers * d, N, H).astype(np.float32)]
    if mode == "lstm":
        args.append(rng.randn(layers * d, N, H).astype(np.float32))
    attrs = dict(state_size=H, num_layers=layers, mode=mode, bidirectional=bi)
    if clip:
        attrs.update(lstm_state_clip_min=-0.6, lstm_state_clip_max=0.6)
    jout, vjp = jax.vjp(lambda *a: jrnn.rnn(*a, **attrs), *map(jnp.asarray, args))
    cots = [rng.randn(*o.shape).astype(np.float32) for o in jout]
    jgrads = vjp(tuple(map(jnp.asarray, cots)))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    tout = trnn.rnn(*targs, **attrs)
    assert len(tout) == len(jout)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    tgrads = torch.autograd.grad(tout, targs, [torch.from_numpy(c) for c in cots])
    for name, t, j in zip(("data", "parameters", "state", "state_cell"), tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_rnn_op_dropout_between_layers():
    """Training with p > 0 drops between layers only, from the generator:
    the same seed gives the same output, the last layer's states are not
    dropped; without a generator it raises."""
    T, N, I, H = 4, 2, 3, 5
    rng = np.random.RandomState(1)
    size = trnn.rnn_param_size("gru", I, H, 2, False)
    x, p, h = (torch.from_numpy(a) for a in (rng.randn(T, N, I).astype(np.float32),
                                             (rng.randn(size) * 0.4).astype(np.float32),
                                             rng.randn(2, N, H).astype(np.float32)))
    attrs = dict(state_size=H, num_layers=2, mode="gru", p=0.5, training=True)
    a = trnn.rnn(x, p, h, generator=torch.Generator().manual_seed(3), **attrs)
    b = trnn.rnn(x, p, h, generator=torch.Generator().manual_seed(3), **attrs)
    c = trnn.rnn(x, p, h, generator=torch.Generator().manual_seed(4), **attrs)
    plain = trnn.rnn(x, p, h, state_size=H, num_layers=2, mode="gru")
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], plain[0])
    torch.testing.assert_close(a[1][0], plain[1][0], rtol=0, atol=0)  # layer 0's state
    with pytest.raises(ValueError, match="Generator"):
        trnn.rnn(x, p, h, **attrs)


# -- the cells ----------------------------------------------------------------------

def _cells(pkg):
    r = pkg.rnn
    seq = r.SequentialRNNCell()
    seq.add(r.LSTMCell(6, prefix="s0_"))
    seq.add(r.DropoutCell(0.5, prefix="sd_"))
    seq.add(r.GRUCell(6, prefix="s1_"))
    return {
        "rnn_tanh": (lambda: r.RNNCell(6, prefix="rt_"), False),
        "rnn_relu": (lambda: r.RNNCell(6, activation="relu", prefix="rr_"), True),
        "lstm": (lambda: r.LSTMCell(6, prefix="l_", forget_bias=0.5), True),
        "gru": (lambda: r.GRUCell(6, prefix="g_"), False),
        "sequential": (lambda: seq, True),
        "bidirectional": (lambda: r.BidirectionalCell(
            r.LSTMCell(6, prefix="bl_"), r.GRUCell(6, prefix="br_"), output_prefix="bi_"), True),
        "residual": (lambda: r.ResidualCell(r.GRUCell(5, prefix="res_")), False),
        "zoneout": (lambda: r.ZoneoutCell(r.LSTMCell(6, prefix="z_"), zoneout_outputs=0.3,
                                          zoneout_states=0.2), False),
        "fused_lstm_bi": (lambda: r.FusedRNNCell(6, num_layers=2, mode="lstm",
                                                 bidirectional=True, prefix="fl_",
                                                 get_next_state=True), True),
        "fused_gru": (lambda: r.FusedRNNCell(6, num_layers=2, mode="gru", prefix="fg_",
                                             get_next_state=True), False),
        "fused_rnn_relu": (lambda: r.FusedRNNCell(6, mode="rnn_relu", prefix="fr_"), True),
    }


def _unrolled(pkg, kind, T):
    with pkg.name.NameManager():
        build, merge = _cells(pkg)[kind]
        outputs, states = build().unroll(T, inputs=pkg.sym.Variable("data"),
                                         merge_outputs=merge)
        outs = list(outputs) if isinstance(outputs, (list, tuple)) else [outputs]
        return pkg.sym.Group(outs + list(states))


@pytest.mark.parametrize("kind", sorted(_cells(jmx)))
def test_cell_unroll_against_jax(kind):
    """``cell.unroll`` builds the same arguments and outputs in both
    packages, and the bound graphs agree on the same inputs and weights."""
    T, N, D = 4, 3, 5
    jsym, tsym = _unrolled(jmx, kind, T), _unrolled(tmx, kind, T)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert len(tsym.list_outputs()) == len(jsym.list_outputs())
    arg_shapes, _, _ = jsym.infer_shape(data=(N, T, D))
    rng = np.random.RandomState(7)
    feed = {n: (rng.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(jsym.list_arguments(), arg_shapes)}
    jexe = jsym.simple_bind(grad_req="null", data=(N, T, D))
    jouts = jexe.forward(is_train=False, **{k: jmx.nd.array(v) for k, v in feed.items()})
    texe = tsym.simple_bind(device="cpu", grad_req="null", data=(N, T, D))
    touts = texe.forward(is_train=False, **{k: torch.from_numpy(v) for k, v in feed.items()})
    for t, j in zip(touts, jouts):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["rnn_tanh", "lstm", "gru"])
def test_fused_cell_matches_its_unfuse(mode):
    """The reference's fused-against-unfused check
    (tests/test_rnn_legacy.py test_fused_matches_unfused): FusedRNNCell and
    its ``unfuse()`` stack on ``unpack_weights``' weights agree, and
    ``pack_weights`` gives the vector back."""
    T, B, D, H, L = 3, 2, 5, 4, 2
    fused = tmx.rnn.FusedRNNCell(H, num_layers=L, mode=mode, prefix="f_")
    f_out, _ = fused.unroll(T, inputs=tmx.sym.Variable("data"), merge_outputs=True)
    rng = np.random.RandomState(0)
    params = torch.from_numpy(((rng.rand(trnn.rnn_param_size(mode, D, H, L, False)) - 0.5)
                               * 0.4).astype(np.float32))
    x = torch.from_numpy(rng.randn(B, T, D).astype(np.float32))
    (f_y,) = f_out.simple_bind(device="cpu", grad_req="null", data=(B, T, D)).forward(
        data=x, f_parameters=params)
    unfused = fused.unfuse()
    u_out, _ = unfused.unroll(T, inputs=tmx.sym.Variable("data"), merge_outputs=True)
    args = fused.unpack_weights({"f_parameters": params})
    (u_y,) = u_out.simple_bind(device="cpu", grad_req="null", data=(B, T, D)).forward(
        data=x, **args)
    np.testing.assert_allclose(f_y.numpy(), u_y.numpy(), rtol=RTOL, atol=ATOL)
    packed = fused.pack_weights(args)["f_parameters"]
    np.testing.assert_array_equal(packed.numpy(), params.numpy())


def test_lstm_weights_unpack_pack_and_begin_state():
    """Per-gate weights round-trip; ``begin_state(func=sym.zeros)`` with the
    reference's unknown batch (0) binds; another func with it raises."""
    cell = tmx.rnn.LSTMCell(4, prefix="lstm_")
    rng = np.random.RandomState(0)
    args = {"lstm_i2h_weight": rng.randn(16, 5), "lstm_i2h_bias": rng.randn(16),
            "lstm_h2h_weight": rng.randn(16, 4), "lstm_h2h_bias": rng.randn(16)}
    unpacked = cell.unpack_weights(dict(args))
    assert "lstm_i2h_i_weight" in unpacked and "lstm_h2h_o_bias" in unpacked
    for k, v in cell.pack_weights(unpacked).items():
        np.testing.assert_array_equal(v.numpy(), args[k])
    states = cell.begin_state(func=tmx.sym.zeros)
    out, _ = cell.unroll(2, inputs=tmx.sym.Variable("data"), begin_state=states,
                         merge_outputs=True)
    (y,) = out.simple_bind(device="cpu", grad_req="null", data=(3, 2, 5)).forward(
        data=torch.ones(3, 2, 5))
    assert tuple(y.shape) == (3, 2, 4)
    with pytest.raises(ValueError, match="deferred batch"):
        tmx.rnn.LSTMCell(4, prefix="o_").begin_state(func=tmx.sym.ones)


# -- the iterator, the metric and the optimizer ----------------------------------------

def _sentences(n, seed, vocab=12, lo=2, hi=9):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(1, vocab, size=rng.randint(lo, hi))) for _ in range(n)]


def test_encode_sentences_and_bucket_iter_against_jax():
    """The vocabulary, and every batch of two epochs (bucket key, data,
    labels, shapes) with numpy's and Python's generators seeded alike."""
    words = [["a", "b", "c"], ["b", "d"], ["e", "a", "f", "b"]]
    for kw in (dict(), dict(invalid_label=0, start_label=1)):
        assert tmx.rnn.encode_sentences(words, **kw) == jmx.rnn.encode_sentences(words, **kw)
    sents = _sentences(60, 0, hi=14)
    batches = []
    for pkg in (jmx, tmx):
        np.random.seed(5)
        random.seed(5)
        it = pkg.rnn.BucketSentenceIter(sents, 4, buckets=[4, 8, 12], invalid_label=0)
        got = []
        for _ in range(2):
            for b in it:
                got.append((b.bucket_key, np.asarray(b.data[0].asnumpy() if pkg is jmx
                                                      else b.data[0].numpy()),
                            np.asarray(b.label[0].asnumpy() if pkg is jmx
                                       else b.label[0].numpy()),
                            tuple(b.provide_data[0].shape)))
            it.reset()
        batches.append(got)
    assert len(batches[0]) == len(batches[1]) > 10
    for (jk, jd, jl, js), (tk, td, tl, ts) in zip(*batches):
        assert (jk, js) == (tk, ts)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)


def test_perplexity_against_jax():
    rng = np.random.RandomState(2)
    labels = rng.randint(0, 6, size=(4, 5)).astype(np.float32)
    probs = rng.rand(20, 6).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    for ignore in (None, 0):
        j = jmx.metric.create("perplexity", ignore_label=ignore)
        t = tmx.metric.create("perplexity", ignore_label=ignore)
        for _ in range(2):
            j.update([jmx.nd.array(labels)], [jmx.nd.array(probs)])
            t.update([torch.from_numpy(labels)], [torch.from_numpy(probs)])
        assert t.get()[0] == j.get()[0] == "perplexity"
        np.testing.assert_allclose(t.get()[1], j.get()[1], rtol=1e-6)
        assert t.num_inst == j.num_inst


def test_adam_against_jax():
    """Three updates of two parameters (a weight with weight decay, a bias
    without), with rescaling and clipping; then a row-sparse gradient
    raises."""
    rng = np.random.RandomState(4)
    w0 = {i: rng.randn(3, 4).astype(np.float32) for i in (0, 1)}
    grads = [{i: (rng.randn(3, 4) * 3).astype(np.float32) for i in (0, 1)} for _ in range(3)]
    kw = dict(learning_rate=0.01, wd=0.1, rescale_grad=0.5, clip_gradient=1.0,
              param_idx2name={0: "fc_weight", 1: "fc_bias"})
    jopt, topt = jmx.optimizer.create("adam", **kw), tmx.optimizer.create("adam", **kw)
    jopt.set_wd_mult({})
    topt.set_wd_mult({})
    jup, tup = jmx.optimizer.get_updater(jopt), tmx.optimizer.get_updater(topt)
    jw = {i: jmx.nd.array(w) for i, w in w0.items()}
    tw = {i: torch.from_numpy(w.copy()) for i, w in w0.items()}
    for g in grads:
        for i in (0, 1):
            jup(i, jmx.nd.array(g[i]), jw[i])
            tup(i, torch.from_numpy(g[i]), tw[i])
    for i in (0, 1):
        np.testing.assert_allclose(tw[i].numpy(), jw[i].asnumpy(), rtol=RTOL, atol=ATOL)
    states = tup.get_states()
    again = tmx.optimizer.get_updater(tmx.optimizer.create("adam", **kw))
    again.set_states(states)
    for i in (0, 1):
        for a, b in zip(again._state(i, tw[i]), tup.states[i]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="A14"):
        tup(0, torch.from_numpy(grads[0][0]).to_sparse(), tw[0])


# -- the bucketing language model -------------------------------------------------------

VOCAB, EMBED, HIDDEN, LAYERS, BATCH, BUCKETS = 12, 4, 8, 2, 3, (4, 8)


def _lm_sym_gen(pkg, fused=False):
    if fused:
        stack = pkg.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS, mode="lstm", prefix="lstm_")
    else:
        stack = pkg.rnn.SequentialRNNCell()
        for i in range(LAYERS):
            stack.add(pkg.rnn.LSTMCell(num_hidden=HIDDEN, prefix="lstm_l%d_" % i))
    sym = pkg.sym

    def sym_gen(seq_len):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data=data, input_dim=VOCAB, output_dim=EMBED, name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = sym.Reshape(outputs, shape=(-1, HIDDEN))
        pred = sym.FullyConnected(pred, num_hidden=VOCAB, name="pred")
        label = sym.Reshape(label, shape=(-1,))
        return sym.SoftmaxOutput(pred, label=label, name="softmax"), ("data",), ("softmax_label",)

    return sym_gen


def _lm_batches():
    rng = np.random.RandomState(11)
    out = []
    for key in (8, 4, 8):
        rows = rng.randint(1, VOCAB, size=(BATCH, key)).astype(np.float32)
        out.append((key, rows, np.concatenate([rows[:, 1:], np.zeros((BATCH, 1), np.float32)],
                                              axis=1)))
    return out


def _lm_args(sym):
    rng = np.random.RandomState(3)
    shapes, _, _ = sym.infer_shape(data=(BATCH, 8), softmax_label=(BATCH, 8))
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _fit_steps(pkg, sym_gen, args):
    """Three Adam steps over the alternating batches -> [(probabilities,
    {parameter: values})] after each."""
    kw = dict(context=jmx.cpu()) if pkg is jmx else dict(device="cpu")
    mod = pkg.mod.BucketingModule(sym_gen, default_bucket_key=8, **kw)
    desc = lambda n, s: pkg.io.DataDesc(n, s)  # noqa: E731
    mod.bind([desc("data", (BATCH, 8))], [desc("softmax_label", (BATCH, 8))])
    if pkg is jmx:
        mod.init_params(arg_params={k: jmx.nd.array(v) for k, v in args.items()})
    else:
        sym = sym_gen(8)[0]
        targs, _ = symbol_params_from_jax(sym, args, {}, device="cpu", data=(BATCH, 8),
                                          softmax_label=(BATCH, 8))
        mod.init_params(arg_params=targs)
    mod.init_optimizer(optimizer="adam", optimizer_params={"learning_rate": 0.01, "wd": 1e-5})
    out = []
    for key, data, label in _lm_batches():
        arr = jmx.nd.array if pkg is jmx else torch.from_numpy
        batch = pkg.io.DataBatch([arr(data)], [arr(label)], bucket_key=key,
                                 provide_data=[desc("data", data.shape)],
                                 provide_label=[desc("softmax_label", label.shape)])
        mod.forward_backward(batch)
        mod.update()
        prob = mod.get_outputs()[0]
        arg_params, _ = mod.get_params()
        out.append((prob.asnumpy() if pkg is jmx else prob.numpy(),
                    {k: (v.asnumpy() if pkg is jmx else v.detach().numpy()).copy()
                     for k, v in arg_params.items()}))
    return out


def _jax_lm():
    sym_gen = _lm_sym_gen(jmx)
    args = _lm_args(sym_gen(8)[0])
    return args, _fit_steps(jmx, sym_gen, args)


@pytest.fixture(scope="module")
def jax_lm(tmp_path_factory):
    """The JAX LM's weights and three steps, computed once per test run
    (``xdist_shared``)."""
    return shared(tmp_path_factory, "torch_rnn_jax_lm", _jax_lm)


def test_bucketing_lm_three_adam_steps_against_jax(jax_lm):
    """The example's model at 2 × 8 hidden, embed 4, vocabulary 12, batch 3:
    buckets 8, 4, 8; each step's probabilities and every parameter after
    it; the buckets share one set of parameters."""
    args, ref = jax_lm
    got = _fit_steps(tmx, _lm_sym_gen(tmx), args)
    for step, ((tp, tparams), (jp, jparams)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL, err_msg="step %d" % step)
        assert sorted(tparams) == sorted(jparams)
        for k in jparams:
            np.testing.assert_allclose(tparams[k], jparams[k], rtol=RTOL, atol=ATOL,
                                       err_msg="step %d %s" % (step, k))
    assert not np.allclose(got[-1][1]["pred_weight"], args["pred_weight"])


def test_bucketing_lm_fused_stack_matches_the_cells(jax_lm):
    """The same model over a FusedRNNCell (the RNN op), its packed vector
    made by ``pack_weights`` from the cells' weights, takes the same three
    steps as the JAX cell stack."""
    args, ref = jax_lm
    fused = tmx.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS, mode="lstm", prefix="lstm_")
    fused_args = {k: np.asarray(v) for k, v in fused.pack_weights(
        {k: torch.from_numpy(v) for k, v in args.items()}).items()}
    assert "lstm_parameters" in fused_args and "lstm_l0_i2h_weight" not in fused_args
    got = _fit_steps(tmx, _lm_sym_gen(tmx, fused=True), fused_args)
    for step, ((tp, _), (jp, _)) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(tp, jp, rtol=RTOL, atol=ATOL, err_msg="step %d" % step)


def test_bucketing_module_needs_a_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    with pytest.raises(RuntimeError):
        tmx.mod.BucketingModule(_lm_sym_gen(tmx), default_bucket_key=8).bind(
            [("data", (BATCH, 8))], [("softmax_label", (BATCH, 8))])


def test_lstm_bucketing_example_learns_on_the_cpu(caplog):
    """The port's example for one short epoch (as
    tests/test_examples_rnn_sparse.py runs the JAX one): the Speedometer's
    perplexity falls from the first window to the last."""
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing

    torch.manual_seed(0)
    np.random.seed(0)
    random.seed(0)
    with caplog.at_level(logging.INFO):
        lstm_bucketing.main(["--ctx", "cpu", "--num-epochs", "1", "--num-sentences", "400",
                             "--batch-size", "16", "--num-hidden", "48", "--num-embed", "24",
                             "--disp-batches", "5"])
    import re

    ppl = [float(m) for m in re.findall(r"perplexity=([0-9.]+)", caplog.text)]
    assert len(ppl) >= 3 and ppl[-1] < 0.7 * ppl[0], ppl
