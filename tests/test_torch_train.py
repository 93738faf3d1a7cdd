"""The port's Deformable R-FCN train step (mxnet_tpu_torch/train_fused.py)
against the JAX package's (examples/deformable_rfcn/train_fused.py), on the
CPU, at the tiny configuration of that example (units (1,1,1,1), 64×96,
3 classes, scales (1, 2), pre/post NMS 200/32, batch_rois 16, rpn_batch 32,
max_gts 8) and batch 2.

The JAX weights cross by ``load_jax_params``.  The offset and trans convs
get non-zero weights, so that sampling leaves the integer grid, and the
score convs larger ones, so that the RPN scores spread out: the proposal
sort and the target thresholds have no near-tie at this seed, and each side
can run three steps on its own weights.  The step's noise is derived from
the JAX step's key exactly as that step derives it, and handed to the port.
"""
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon.functional import functionalize
from mxnet_tpu.gluon.model_zoo.detection import DeformableRFCN as JaxRFCN
from mxnet_tpu.ops import rcnn_targets as jtargets
from mxnet_tpu.test_utils import load_module_by_path
from mxnet_tpu_torch import train_fused
from mxnet_tpu_torch.gluon.model_zoo import DeformableRFCN, load_jax_params
from mxnet_tpu_torch.ops import rcnn_targets as ttargets
from xdist_shared import shared

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(classes=3, image_shape=(64, 96), units=(1, 1, 1, 1), scales=(1, 2),
           rpn_pre_nms=200, rpn_post_nms=32, batch_rois=16, rpn_batch=32,
           max_gts=8)
B = 2
STEPS = 3
SEED = 0
OUTPUTS = ("rpn_cls", "rpn_bbox", "rpn_label", "rpn_bt", "rpn_bw", "rois",
           "label", "bbox_target", "bbox_weight", "cls_score", "bbox_pred")
# weights compared after the three steps
CHOSEN = ("res5_unit1_deformableconv2d0_offset_weight", "rfcn_trans_weight",
          "rpn_cls_weight", "res4_unit1_conv2d0_weight")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps this file off
    the cores that the suite's parallel workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _run():
    """Both sides built once: the JAX step run STEPS times under jit and the
    port's step STEPS times, each on its own weights, from the same start
    and with the same noise; plus the 11 training outputs of both at the
    start, on the noise of step 0."""
    jtf = load_module_by_path(
        str(ROOT / "examples" / "deformable_rfcn" / "train_fused.py"),
        "_rfcn_train_fused_torch_parity")
    mx.random.seed(SEED)
    jnet = JaxRFCN(**CFG)
    jnet.initialize()
    jnet.init_params()
    rng = np.random.RandomState(SEED)
    scale = {"offset_weight": 0.2, "rfcn_trans_weight": 0.5,
             "rfcn_cls_weight": 4.0, "rfcn_bbox_weight": 4.0,
             "rpn_cls_weight": 4.0}
    for k, p in jnet.collect_params().items():
        for suffix, s in scale.items():
            if k.endswith(suffix):
                p.set_data(nd.array((rng.randn(*p.shape) * s).astype(np.float32)))
    params = {k[len(jnet.prefix):]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    data, info, gt = jtf.synthetic_coco(rng, B, CFG["image_shape"], CFG["classes"],
                                        CFG["max_gts"])
    Hf, Wf = jnet.feat_shape
    a_total = Hf * Wf * jnet.num_anchors
    ncand = CFG["rpn_post_nms"] + CFG["max_gts"]
    key = jax.random.PRNGKey(SEED)
    keys = [jax.random.fold_in(key, s) for s in range(STEPS)]

    def noise(k):  # train_fused.py:133-135
        k1, k2, _ = jax.random.split(k, 3)
        return (np.asarray(jax.random.uniform(k1, (B, a_total, 2), jnp.float32)),
                np.asarray(jax.random.uniform(k2, (B, ncand, 2), jnp.float32)))

    nzs = [noise(k) for k in keys]
    apply, names, vals, aux_names = functionalize(jnet, train=True)
    fwd = jax.jit(lambda v, *a: apply(v, a, key)[0])
    jout = [np.asarray(o) for o in fwd(vals, data, info, gt, *nzs[0])]

    step, state = jtf.make_rfcn_train_step(jnet, B, learning_rate=5e-4,
                                           momentum=0.9)
    jstep = jax.jit(step)
    jparts = []
    for k in keys:
        state, _, parts = jstep(state, jnp.asarray(data), jnp.asarray(info),
                                jnp.asarray(gt), k)
        jparts.append(np.asarray(parts))
    learn = [n[len(jnet.prefix):] for n in names if n not in set(aux_names)]
    jfinal = dict(zip(learn, (np.asarray(v) for v in state[0])))
    jmom = dict(zip(learn, (np.asarray(v) for v in state[1])))

    tnet = load_jax_params(DeformableRFCN(device="cpu", **CFG), params)
    tout = [o.detach().numpy() for o in tnet(
        _t(data), _t(info), _t(gt), _t(nzs[0][0]), _t(nzs[0][1]))]
    tstep = train_fused.make_rfcn_train_step(tnet, B, learning_rate=5e-4,
                                             momentum=0.9)
    tparts = [tstep(_t(data), _t(info), _t(gt), _t(a), _t(b))[1].numpy()
              for a, b in nzs]
    named = tnet.gluon_named_tensors()
    by_param = {id(p): m for p, m in zip(tstep.params, tstep.momentum)}
    tfinal = {n: t.detach().numpy().copy() for n, t in named.items()}
    tmom = {n: by_param.get(id(t)) for n, t in named.items()}
    return dict(params=params, jout=jout, tout=tout, jparts=jparts,
                tparts=tparts, jfinal=jfinal, jmom=jmom, tfinal=tfinal,
                tmom=tmom, aux=[n[len(jnet.prefix):] for n in aux_names])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``_run()``, computed once per test run (``xdist_shared``)."""
    return shared(tmp_path_factory, "torch_train_run", _run)


def _targets_inputs(seed):
    """gt for two images (the second without any box when ``seed`` is odd),
    proposals jittered around the gts so that all three IoU bands occur,
    and the noise."""
    rng = np.random.RandomState(seed)
    G, post, H, W = 8, 32, 64, 96
    gt = np.full((B, G, 5), -1.0, np.float32)
    for b in range(B):
        if b == 1 and seed % 2:
            continue
        for j in range(rng.randint(1, 5)):
            x1, y1 = rng.uniform(0, W - 30), rng.uniform(0, H - 20)
            gt[b, j] = [rng.randint(0, 3), x1, y1, x1 + rng.uniform(10, 30),
                        y1 + rng.uniform(10, 20)]
    src = np.where(gt[..., :1] >= 0, gt, [[[0, 10, 10, 40, 40]]])[..., 1:]
    pick = src[np.arange(B)[:, None], rng.randint(0, 2, (B, post))]
    boxes = pick + rng.normal(0, 6, (B, post, 4))
    rois = np.concatenate([np.repeat(np.arange(B, dtype=np.float32), post)[:, None],
                           boxes.reshape(B * post, 4)], 1).astype(np.float32)
    info = np.array([[H, W, 1.0], [H - 16, W - 32, 1.0]], np.float32)
    nz_rpn = rng.rand(B, 4 * 6 * 6, 2).astype(np.float32)
    nz_prop = rng.rand(B, post + G, 2).astype(np.float32)
    return gt, info, rois, nz_rpn, nz_prop


ANCHOR_KW = dict(feat_height=4, feat_width=6, feature_stride=16, scales=(1, 2),
                 ratios=(0.5, 1, 2), batch_rois=32, fg_fraction=0.5)
PROPOSAL_KW = dict(num_classes=4, class_agnostic=True, batch_images=B, batch_rois=2 * 16,
                   fg_fraction=0.25)


@functools.lru_cache(maxsize=None)
def _jitted_targets():
    """The two JAX target ops jitted once for every seed (the eager ops
    would each compile on first use, and a jit a seed recompiles)."""
    return (jax.jit(functools.partial(jtargets.rpn_anchor_target, **ANCHOR_KW)),
            jax.jit(functools.partial(jtargets.proposal_target, **PROPOSAL_KW)))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_anchor_and_proposal_targets_match(seed):
    gt, info, rois, nz_rpn, nz_prop = _targets_inputs(seed)
    anchor_target, proposal_target = _jitted_targets()
    ref = anchor_target(gt, info, nz_rpn)
    got = ttargets.rpn_anchor_target(*map(_t, (gt, info, nz_rpn)), **ANCHOR_KW)
    ref2 = proposal_target(rois, gt, nz_prop)
    got2 = ttargets.proposal_target(*map(_t, (rois, gt, nz_prop)), **PROPOSAL_KW)
    label, bt, bw = (np.asarray(a) for a in ref)
    assert (label == 1).any() and (label == 0).any() and (label == -1).any()
    # the selection is exact: labels, weights and the sampled rois are equal;
    # the regression targets' log and division may differ by one ulp
    # between XLA and torch
    for g, r, exact in zip(list(got) + list(got2), list(ref) + list(ref2),
                           (True, False, True, True, True, False, True)):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape
        if exact:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def test_training_forward_outputs_match(run):
    """The 11 outputs at the same weights and the same noise."""
    assert len(run["tout"]) == len(run["jout"]) == 11
    for name, got, ref in zip(OUTPUTS, run["tout"], run["jout"]):
        assert got.shape == ref.shape, name
        if name in ("rpn_label", "rpn_bw", "label", "bbox_weight"):
            np.testing.assert_array_equal(got, ref, err_msg=name)
        elif name == "rois":
            # box decode (exp, products) in fp32 in another order
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4, err_msg=name)
        else:
            # fp32 convs and pooled means summed in another order
            np.testing.assert_allclose(got, ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_parts_match(run, step):
    got, ref = run["tparts"][step], run["jparts"][step]
    assert np.isfinite(got).all() and got.shape == (4,)
    # four fp32 means over a few hundred terms, and every gradient of the
    # steps before, summed in another order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", CHOSEN)
def test_weights_and_momentum_match_after_three_steps(run, name):
    p0, ref, got = run["params"][name], run["jfinal"][name], run["tfinal"][name]
    assert not np.array_equal(ref, p0)  # the weight moved
    # p = p0 − lr·Σ m: the update is below the weight's ulp in places
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    # the momentum buffer holds the gradients at their own scale: fp32
    # backward sums in another order, compounded over three steps
    m_ref, m_got = run["jmom"][name], run["tmom"][name].numpy()
    assert np.abs(m_ref).max() > 0
    np.testing.assert_allclose(m_got, m_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(m_ref).max())


def test_fixed_layers_and_batchnorm_statistics_stay(run):
    """conv1 and res2 get no gradient and the BatchNorm running statistics
    are untouched, on both sides; every res3 weight moves."""
    p0, jfinal, tfinal = run["params"], run["jfinal"], run["tfinal"]
    fixed = [n for n in p0 if n.startswith(("conv1_", "res2_"))]
    assert fixed
    for n in fixed:
        if n in jfinal:
            np.testing.assert_array_equal(jfinal[n], p0[n])
        np.testing.assert_array_equal(tfinal[n], p0[n])
    for n in run["aux"]:
        np.testing.assert_array_equal(tfinal[n], p0[n])
    for n in p0:
        if n.startswith("res3_") and n.endswith("_weight"):
            assert not np.array_equal(tfinal[n], p0[n]), n


def test_training_forward_checks_its_inputs():
    net = DeformableRFCN(device="cpu", **CFG)
    data = torch.zeros((B, 3, 64, 96))
    info = torch.tensor([[64.0, 96.0, 1.0]] * B)
    gt = torch.full((B, CFG["max_gts"], 5), -1.0)
    nz_prop = torch.rand(B, CFG["rpn_post_nms"] + CFG["max_gts"], 2)
    with pytest.raises(ValueError, match="nz_rpn"):
        net(data, info, gt, torch.rand(B, 7, 2), nz_prop)
    with pytest.raises(ValueError, match="gt_boxes"):
        net(data, info, gt[:, :3], torch.rand(B, 144, 2), nz_prop)
    step = train_fused.make_rfcn_train_step(net, B)
    with pytest.raises(ValueError, match="batch 2"):
        step(data[:1], info[:1], gt[:1], torch.rand(1, 144, 2), nz_prop[:1])


def test_run_bench_runs_on_the_cpu_when_asked(capsys, monkeypatch):
    img_s, ms, loss = train_fused.run_bench(False, batch=1, iters=1, windows=1,
                                            device="cpu")
    assert img_s > 0 and ms > 0 and np.isfinite(loss)
    assert "on cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_fused.run_bench(False, iters=1, windows=1)


def test_train_step_computes_in_full_fp32():
    """TF32 is off in the backward as in the forward (cuDNN would take it by
    default), and the caller's settings come back after the step."""
    net = DeformableRFCN(device="cpu", **CFG)
    step = train_fused.make_rfcn_train_step(net, 1)
    seen = []
    net.rfcn_cls.weight.register_hook(lambda g: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    rng = np.random.RandomState(1)
    batch = train_fused.synthetic_coco(rng, 1, CFG["image_shape"], CFG["classes"],
                                       CFG["max_gts"])
    noise = [torch.rand(s) for s in train_fused.noise_shapes(net, 1)]
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        step(*map(_t, batch), *noise)
        after = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    assert seen == [(False, False)]
    assert after == (True, True)
