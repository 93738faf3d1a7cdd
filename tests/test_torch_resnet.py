"""BatchNorm batch statistics and the Gluon ResNet train step of the port
(mxnet_tpu_torch) against the JAX package, on the CPU, on the same
numpy-seeded inputs: the BatchNorm op's training branch and its gradients,
the layer's running statistics, the ResNet-50 v1/v2 Gluon names, narrow
V1/V2 forwards, softmax cross-entropy, and three ``make_train_step`` steps
of a narrow V1 net in fp32 and bf16.  JAX weights cross by
``load_jax_params``; bf16 values cross as float32 numpy arrays of
bf16-representable values.

The train-step comparison feeds each port step the JAX state before that
step, so that each step is compared on its own: at lr 0.05 an update is
tens of times a U(−0.07, 0.07) weight, and rounding differences of 1e-6
compound into percents over free-running steps.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.functional import make_train_step as jax_make_train_step
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.ops import nn as jops
from mxnet_tpu_torch.gluon import functional as tfun
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import load_jax_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops import nn as tops

BF = torch.bfloat16
NARROW = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10)
LR, MOMENTUM, STEPS, BATCH = 0.05, 0.9, 3, 4
# the train step at 64x64: stage 4 then normalises 2x2 maps over the
# batch, 16 values a channel (at 32x32 it would normalise 4)
STEP_IMAGE = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf(a):
    """float32 numpy -> the same values rounded to bf16, as float32 numpy."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF).float().numpy()


def _np(a):
    """a torch tensor or JAX array of any float dtype -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _params(jnet):
    return {k[len(jnet.prefix):]: p.data().asnumpy()
            for k, p in jnet.collect_params().items()}


def _bn_inputs(shape, seed):
    """Data with one channel far from its running mean, and γ, β and running
    statistics that are not the identity."""
    rng = np.random.RandomState(seed)
    c = shape[1]
    x = rng.randn(*shape).astype(np.float32) * 2 + 0.5
    x[:, 2] += 12.0  # the shifted form's case: batch mean 6 std from m0
    g = rng.rand(c).astype(np.float32) + 0.5
    b = rng.randn(c).astype(np.float32)
    m = (rng.randn(c) * 0.3).astype(np.float32)
    v = (rng.rand(c) + 0.5).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)
    return x, g, b, m, v, cot, rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 5, 6, 7), (12, 5)], ids=["nchw", "nc"])
def test_batch_norm_training_matches_jax(dtype, shape):
    """Output, batch mean and variance, and the gradients of data, γ and β
    of ``L = Σ out·c + Σ mean·cm + Σ var·cv`` (so that the gradient paths
    through the statistics count too)."""
    x, g, b, m, v, cot, cm, cv = _bn_inputs(shape, 3)
    bf16 = dtype == "bfloat16"
    if bf16:  # the bf16 step's operands: bf16 data, γ, β; fp32 statistics
        x, g, b, cot = map(_bf, (x, g, b, cot))
    jd = jnp.dtype(dtype)
    kw = dict(eps=1e-5, fix_gamma=False, momentum=0.9)

    def jfn(d, gg, bb):
        return jops.batch_norm(d, gg, bb, jnp.asarray(m), jnp.asarray(v),
                               training=True, **kw)

    # op by op, as the port computes: under jit XLA:CPU would keep the bf16
    # products in fp32
    (jout, jmean, jvar), vjp = jax.vjp(
        jfn, jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd), jnp.asarray(b).astype(jd))
    jgrads = vjp((jnp.asarray(cot).astype(jd), jnp.asarray(cm), jnp.asarray(cv)))

    td = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(td).requires_grad_() for a in (x, g, b)]
    out, mean, var = tops.batch_norm(*leaves, torch.from_numpy(m), torch.from_numpy(v),
                                     training=True, output_mean_var=True, **kw)
    assert out.dtype == td and mean.dtype == var.dtype == torch.float32
    loss = ((out.float() * torch.from_numpy(cot)).sum() + (mean * torch.from_numpy(cm)).sum()
            + (var * torch.from_numpy(cv)).sum())
    tgrads = torch.autograd.grad(loss, leaves)
    # the statistics are fp32 means in another order; E[d²] − E[d]² keeps
    # the rounding of E[d²] (~150 for the channel 12 from its running mean)
    red = tuple(i for i in range(len(shape)) if i != 1)
    ex2 = ((x.astype(np.float64) - m.reshape((1, -1) + (1,) * (len(shape) - 2))) ** 2).mean(red)
    np.testing.assert_allclose(_np(mean), _np(jmean), rtol=1e-6, atol=1e-5)
    n = x.size // shape[1]  # terms of each mean: n·ε·E[d²] bounds the order's effect
    np.testing.assert_allclose(_np(var), _np(jvar), rtol=0,
                               atol=n * np.finfo(np.float32).eps * ex2.max())
    if bf16:
        # the same fp32 scale and shift rounded to bf16, then bf16 products:
        # within one bf16 ulp of the output's scale; each gradient sums a
        # direct and a statistics term that the two sides round to bf16 at
        # other places: within 8 bf16 ulps of the largest gradient
        np.testing.assert_allclose(_np(out), _np(jout), rtol=2 ** -8,
                                   atol=2 ** -8 * np.abs(_np(jout)).max())
        rtol = 2 ** -5
    else:
        np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=1e-5)
        rtol = 1e-4
    for name, got, ref in zip(("data", "gamma", "beta"), tgrads, jgrads):
        assert got.dtype == td, name
        ref = _np(ref)
        np.testing.assert_allclose(_np(got), ref, rtol=rtol,
                                   atol=rtol * np.abs(ref).max(), err_msg=name)


def test_batch_norm_inference_branch_unchanged_by_training_flag():
    """``use_global_stats`` wins over ``training``, and the op's default
    (one output, running statistics) is what it was."""
    x, g, b, m, v, *_ = _bn_inputs((3, 5, 4, 4), 4)
    args = [torch.from_numpy(a) for a in (x, g, b, m, v)]
    plain = tops.batch_norm(*args, eps=1e-5, fix_gamma=False)
    glob = tops.batch_norm(*args, eps=1e-5, fix_gamma=False, training=True,
                           use_global_stats=True, output_mean_var=True)
    assert torch.equal(plain, glob[0])
    assert glob[1] is args[3] and glob[2] is args[4]


@pytest.mark.parametrize("scale_center", [True, False], ids=["affine", "no_affine"])
def test_batchnorm_layer_running_stats_match_jax(scale_center):
    """A train-mode forward against the JAX layer under
    ``autograd.record()``: the output, and the running statistics folded
    with momentum 0.9; then eval mode on the new running statistics."""
    x, g, b, m, v, *_ = _bn_inputs((4, 5, 6, 6), 5)
    jbn = jnn.BatchNorm(in_channels=5, scale=scale_center, center=scale_center)
    jbn.initialize()
    for p, val in zip((jbn.gamma, jbn.beta, jbn.running_mean, jbn.running_var), (g, b, m, v)):
        p.set_data(nd.array(val))
    tbn = tnn.BatchNorm(in_channels=5, scale=scale_center, center=scale_center, device="cpu")
    load_jax_params(tbn, _params(jbn))
    assert not tbn.training  # built in eval mode
    assert tbn.gamma.requires_grad == tbn.beta.requires_grad == scale_center
    with autograd.record():
        jout = jbn(nd.array(x)).asnumpy()
    tbn.train()
    tout = tbn(torch.from_numpy(x)).detach().numpy()
    # the variance's summation error (n·ε·E[d²], ~1e-5 of it for the far
    # channel) passes into every normalised output
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-4)
    for name in ("running_mean", "running_var"):
        ref = getattr(jbn, name).data().asnumpy()
        assert not np.allclose(ref, {"running_mean": m, "running_var": v}[name])
        # m·r + (1 − m)·batch: fp32 sums of 144 values in another order
        np.testing.assert_allclose(getattr(tbn, name).numpy(), ref, rtol=1e-6, atol=1e-5,
                                   err_msg=name)
    tbn.eval()
    x2 = x[::-1].copy()
    before = tbn.running_mean.clone()
    # on running statistics that agree within 1e-5 of their size
    np.testing.assert_allclose(tbn(torch.from_numpy(x2)).detach().numpy(),
                               jbn(nd.array(x2)).asnumpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(tbn.running_mean, before)  # eval mode updates nothing


@pytest.fixture(scope="module")
def resnet50_names():
    """{version: {Gluon name: shape}} of the JAX resnet50_v1 / v2, root
    prefix stripped: every parameter's shape as the JAX net's symbolic
    forward infers it at 32x32 (nothing compiles; an eager forward took
    ~12 s of XLA compiles for the same shapes)."""
    out = {}
    for version in (1, 2):
        jnet = jres.get_resnet(version, 50, classes=1000)
        sym = jnet(mx.sym.var("data"))
        arg_shapes, _, aux_shapes = sym.infer_shape(data=(1, 3, 32, 32))
        shapes = dict(zip(sym.list_arguments(), arg_shapes))
        shapes.update(zip(sym.list_auxiliary_states(), aux_shapes))
        out[version] = {k[len(jnet.prefix):]: tuple(shapes[k]) for k in jnet.collect_params()}
    return out


@pytest.mark.parametrize("version", [1, 2])
def test_resnet50_gluon_names_and_shapes_match_jax(resnet50_names, version):
    net = tres.get_resnet(version, 50, classes=1000, device="cpu")
    got = {k: tuple(t.shape) for k, t in net.gluon_named_tensors().items()}
    ref = resnet50_names[version]
    assert set(got) == set(ref), sorted(set(got) ^ set(ref))[:10]
    assert got == ref
    for name in ("stage1_conv2d0_weight", "stage1_batchnorm0_running_var",
                 "dense0_bias", "dense0_weight"):
        assert name in got
    # BottleneckV1 keeps the 1x1 convs' biases, Gluon's default; V2 has none
    assert ("stage1_conv2d0_bias" in got) == (version == 1)
    assert not net.training


def test_resnet_initial_weights_follow_the_jax_defaults():
    gen = torch.Generator().manual_seed(0)
    net = tres.resnet18_v1(classes=10, device="cpu", generator=gen)
    again = tres.resnet18_v1(classes=10, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    named = net.gluon_named_tensors()
    for name, t in named.items():
        t = t.detach()
        assert torch.equal(t, again.gluon_named_tensors()[name]), name
        if name.endswith("weight"):  # Uniform(0.07), the JAX default initializer
            assert 0.06 < float(t.abs().max()) <= 0.07, name
        elif name.endswith(("gamma", "running_var")):
            assert bool((t == 1).all()), name
        else:
            assert bool((t == 0).all()), name
    with pytest.raises(RuntimeError, match="pretrained"):
        tres.resnet18_v1(pretrained=True, device="cpu")
    with pytest.raises(ValueError, match="Invalid number of layers"):
        tres.get_resnet(1, 20, device="cpu")


@pytest.fixture(scope="module")
def narrow():
    """The narrow V1 (BottleneckV1) and V2 (BottleneckV2) nets of both
    sides, from the same weights, with non-trivial running statistics."""
    nets = {}
    rng = np.random.RandomState(7)
    for version, block in ((1, "BottleneckV1"), (2, "BottleneckV2")):
        mx.random.seed(version)
        cls = getattr(jres, "ResNetV%d" % version)
        jnet = cls(getattr(jres, block), **NARROW)
        jnet.initialize()
        # the weights' shapes by symbolic inference: the same values as a
        # first forward draws, without its eager compiles
        jnet.infer_shape(nd.array(np.zeros((1, 3, 32, 32), np.float32)))
        for k, p in jnet.collect_params().items():
            if k.endswith("running_mean"):
                p.set_data(nd.array((rng.randn(*p.shape) * 0.1).astype(np.float32)))
            elif k.endswith("running_var"):
                p.set_data(nd.array((rng.rand(*p.shape) + 0.5).astype(np.float32)))
        params = _params(jnet)
        tnet = getattr(tres, "ResNetV%d" % version)(getattr(tres, block), device="cpu", **NARROW)
        nets[version] = (jnet, load_jax_params(tnet, params), params)
    return nets, rng.randn(BATCH, 3, 32, 32).astype(np.float32)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("version", [1, 2])
def test_narrow_resnet_forward_matches_jax(narrow, version, mode):
    """Eval mode (running statistics) and train mode (batch statistics, the
    JAX net under ``autograd.record()``; each side's running statistics then
    move, and must agree).  Each test starts from the fixture's weights."""
    nets, x = narrow
    jnet, tnet, params = nets[version]
    for k, p in jnet.collect_params().items():
        p.set_data(nd.array(params[k[len(jnet.prefix):]]))
    load_jax_params(tnet, params)
    if mode == "eval":
        ref = jnet(nd.array(x)).asnumpy()
        got = tnet(torch.from_numpy(x)).detach().numpy()
    else:
        with autograd.record():
            ref = jnet(nd.array(x)).asnumpy()
        tnet.train()
        try:
            got = tnet(torch.from_numpy(x)).detach().numpy()
        finally:
            tnet.eval()
        jrun = _params(jnet)
        trun = {k: t.detach().numpy() for k, t in tnet.gluon_named_tensors().items()}
        moved = [k for k in params if k.endswith("running_var")]
        for k in moved:
            assert not np.array_equal(trun[k], params[k]), k
            # fp32 batch statistics of up to 4x16x16 values, in another order
            np.testing.assert_allclose(trun[k], jrun[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert got.shape == (BATCH, NARROW["classes"])
    # fp32 convolutions and reductions summed in another order, through
    # eleven normalised layers
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["sparse", "dense", "weighted"])
def test_softmax_cross_entropy_matches_jax(case):
    rng = np.random.RandomState(11)
    pred = rng.randn(6, 7).astype(np.float32) * 3
    if case == "dense":
        label = rng.rand(6, 7).astype(np.float32)
        label /= label.sum(1, keepdims=True)
        kw = dict(sparse_label=False)
    else:
        # float class indices, as the bench feeds them; one out of range
        label = rng.randint(0, 7, 6).astype(np.float32)
        label[0] = 9.0
        kw = {}
    sw = None
    if case == "weighted":
        kw["weight"] = 0.7
        sw = rng.rand(6, 1).astype(np.float32)
    jl = jloss.SoftmaxCrossEntropyLoss(**kw)
    tl = tloss.SoftmaxCrossEntropyLoss(**kw)
    jargs = [nd.array(pred), nd.array(label)] + ([nd.array(sw)] if sw is not None else [])
    targs = [torch.from_numpy(pred), torch.from_numpy(label)] + (
        [torch.from_numpy(sw)] if sw is not None else [])
    ref = jl(*jargs).asnumpy()
    got = tl(*targs).numpy()
    assert got.shape == ref.shape == (6,)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["fp32", "bf16"])
def steps(request):
    """STEPS steps of the narrow V1 at batch 4 on both sides: the JAX
    ``make_train_step`` under ``jax.jit``, and the port's ``make_train_step``
    started before each step from the JAX state.  -> per step: JAX loss,
    port loss, and both states after the step, as numpy by Gluon name."""
    dtype = request.param
    mx.random.seed(3)
    jnet = jres.ResNetV1(jres.BottleneckV1, **NARROW)
    jnet.initialize()
    rng = np.random.RandomState(3)
    x = _bf(rng.randn(BATCH, 3, STEP_IMAGE, STEP_IMAGE))
    y = rng.randint(0, NARROW["classes"], BATCH).astype(np.float32)
    jnet.infer_shape(nd.array(x))  # the weights, as a first forward draws them
    params = _params(jnet)
    jstep, jstate, (names, li, ai) = jax_make_train_step(
        jnet, jloss.SoftmaxCrossEntropyLoss(), learning_rate=LR, momentum=MOMENTUM,
        compute_dtype=dtype)
    jstep = jax.jit(jstep)
    tnet = load_jax_params(tres.ResNetV1(tres.BottleneckV1, device="cpu", **NARROW), params)
    tstep, tstate, (tnames, tli, tai) = tfun.make_train_step(
        tnet, tloss.SoftmaxCrossEntropyLoss(), learning_rate=LR, momentum=MOMENTUM,
        compute_dtype=dtype)
    names = [n[len(jnet.prefix):] for n in names]
    assert (tnames, tli, tai) == (names, li, ai)
    learn = [names[i] for i in li]
    aux = [names[i] for i in ai]
    out = []
    for s in range(STEPS):
        with torch.no_grad():
            for tpart, jpart in zip(tstate, jstate):
                for t, j in zip(tpart, jpart):
                    t.copy_(torch.from_numpy(np.array(j)))
        before = {n: np.asarray(v) for n, v in zip(learn, jstate[0])}
        jstate, jl = jstep(jstate, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(s))
        tstate, tl = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))

        def as_np(state, side):
            conv = (lambda v: np.asarray(v)) if side == "jax" else (lambda t: t.numpy().copy())
            return ({n: conv(v) for n, v in zip(learn, state[0])},
                    {n: conv(v) for n, v in zip(learn, state[1])},
                    {n: conv(v) for n, v in zip(aux, state[2])})

        out.append(dict(jloss=float(jl), tloss=float(tl), before=before,
                        jax=as_np(jstate, "jax"), port=as_np(tstate, "port"),
                        dtypes={t.dtype for part in tstate for t in part},
                        loss_dtype=tl.dtype))
    return dtype, out, tnet


# weights compared after each step (a pre-BatchNorm conv bias has a zero
# gradient but for rounding, so none is among them)
CHOSEN = ("conv2d0_weight", "stage2_conv2d1_weight", "stage4_batchnorm2_gamma",
          "dense0_weight", "dense0_bias")


@pytest.mark.parametrize("step", range(STEPS))
def test_train_step_loss_matches_jax(steps, step):
    dtype, out, _ = steps
    r = out[step]
    assert r["loss_dtype"] == torch.float32 and np.isfinite(r["tloss"])
    # fp32: a mean of four cross-entropies after eleven normalised layers,
    # summed in another order; bf16: the same, rounded to bf16 at each op
    # on the port and across fused ops under jit (XLA keeps fp32 between)
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=1e-5 if dtype is None else 3e-2)


@pytest.mark.parametrize("step", range(STEPS))
def test_train_step_weights_and_momentum_match_jax(steps, step):
    dtype, out, _ = steps
    r = out[step]
    (jw, jm, _), (tw, tm, _) = r["jax"], r["port"]
    assert r["dtypes"] == {torch.float32}  # fp32 masters, momentum, statistics
    for name in CHOSEN:
        assert not np.array_equal(jw[name], r["before"][name]), name
        scale = np.abs(jm[name]).max()
        if dtype is None:
            # one fp32 backward, summed in another order
            np.testing.assert_allclose(tm[name], jm[name], rtol=1e-3, atol=1e-3 * scale,
                                       err_msg=name)
            np.testing.assert_allclose(tw[name], jw[name], rtol=1e-5,
                                       atol=LR * 1e-3 * scale, err_msg=name)
        elif name.startswith("dense0"):
            # the output layer's gradient is features x error, no BatchNorm
            # behind it: within the bf16 forward's spread
            np.testing.assert_allclose(tm[name], jm[name], rtol=0, atol=0.1 * scale,
                                       err_msg=name)
        else:
            # behind a BatchNorm the bf16 gradient is a difference of nearly
            # equal terms, rounded to bf16 at other places by the two sides
            # (the port op by op, XLA across a fusion): the direction agrees
            a, b = tm[name].ravel(), jm[name].ravel()
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert cos > 0.9, (name, cos)
        # p = p − lr·m from the same p
        np.testing.assert_allclose(tw[name], r["before"][name] - LR * tm[name],
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("step", range(STEPS))
def test_train_step_running_statistics_match_jax(steps, step):
    dtype, out, _ = steps
    r = out[step]
    ja, ta = r["jax"][2], r["port"][2]
    assert set(ja) == set(ta) and any(k.endswith("running_var") for k in ja)
    for name, ref in ja.items():
        if not name.endswith(("running_mean", "running_var")):
            continue
        scale = np.abs(ref).max()
        # fp32 statistics of the same (fp32 or bf16) activations
        tol = 1e-5 if dtype is None else 5e-2
        np.testing.assert_allclose(ta[name], ref, rtol=tol, atol=tol * scale, err_msg=name)


def test_train_step_leaves_the_net_in_eval_mode_with_its_state(steps):
    """The state is the net's own storage; the net's mode is restored."""
    _, out, tnet = steps
    assert not tnet.training
    learn, _, aux = out[-1]["port"]
    named = tnet.gluon_named_tensors()
    assert set(learn) | set(aux) == set(named)
    for name, value in list(learn.items()) + list(aux.items()):
        np.testing.assert_array_equal(named[name].detach().numpy(), value)


def test_make_train_step_without_momentum_and_unported_options():
    net = tres.ResNetV1(tres.BottleneckV1, device="cpu",
                        generator=torch.Generator().manual_seed(1), **NARROW)
    step, (learn, mom, aux), (names, li, ai) = tfun.make_train_step(
        net, tloss.SoftmaxCrossEntropyLoss(), learning_rate=0.1)
    assert mom == [] and names == sorted(names)
    assert all(names[i].endswith(("running_mean", "running_var")) for i in ai)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2))
    y = torch.tensor([1.0, 3.0])
    before = [p.clone() for p in learn]
    stats = [t.clone() for t in aux]
    # the gradient of the same loss at the same point, by plain autograd
    net.train()
    loss = torch.mean(tloss.SoftmaxCrossEntropyLoss()(net(x), y))
    grads = torch.autograd.grad(loss, [p for n, p in sorted(
        net.gluon_named_tensors().items()) if isinstance(p, torch.nn.Parameter)])
    net.eval()
    with torch.no_grad():  # the step starts from the same running statistics
        for t, s in zip(aux, stats):
            t.copy_(s)
    step((learn, mom, aux), x, y)
    for p0, p1, g in zip(before, learn, grads):
        torch.testing.assert_close(p1, p0 - 0.1 * g, rtol=1e-5, atol=1e-6)
    with pytest.raises(NotImplementedError, match="A10"):
        tfun.make_train_step(net, tloss.SoftmaxCrossEntropyLoss(), mesh=object())
    with pytest.raises(NotImplementedError, match="A10"):
        tfun.make_train_step(net, tloss.SoftmaxCrossEntropyLoss(),
                             shard_optimizer_states=True)
    v2 = tres.ResNetV2(tres.BottleneckV2, device="cpu", **NARROW)
    _, _, (names2, li2, ai2) = tfun.make_train_step(v2, tloss.SoftmaxCrossEntropyLoss())
    # V2's first BatchNorm has no scale or shift: its γ and β are auxiliary
    assert {"batchnorm0_gamma", "batchnorm0_beta"} <= {names2[i] for i in ai2}
