"""The Deformable R-FCN train step with BatchNorm on batch statistics
(``frozen_bn=False``): the port (mxnet_tpu_torch/train_fused.py) against
the JAX step (examples/deformable_rfcn/train_fused.py) on the JAX model
built with ``frozen_bn=False``, on the CPU, at the tiny configuration
(units (1,1,1,1), 64×96, 3 classes) and batch 2, for two steps.

The weights and the batch are those of tests/test_torch_train.py (seed 0,
real offset and trans weights) but for the RPN score conv's (RPN_CLS_SCALE);
at this seed the proposal sort and the targets have no near-tie.  The JAX
weights cross by ``load_jax_params`` and
the step's noise is derived from the JAX step's key as that step derives
it.  Every trunk BatchNorm normalises with the batch's statistics and
folds them into its running ones, those of conv1 and res2 too, whose
gradient ``BlockGrad`` stops.

Each port step starts from the JAX state before that step, so that each
step is compared on its own: free-running, the two sides' 1e-5 differences
in the first update move a sampled roi across a threshold within two
steps.
"""
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
from mxnet_tpu.test_utils import load_module_by_path
from mxnet_tpu_torch import train_fused
from mxnet_tpu_torch.gluon.model_zoo import DeformableRFCN, load_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(classes=3, image_shape=(64, 96), units=(1, 1, 1, 1), scales=(1, 2),
           rpn_pre_nms=200, rpn_post_nms=32, batch_rois=16, rpn_batch=32,
           max_gts=8)
B = 2
STEPS = 2
LR = 5e-4
# the RPN score conv's weights: with batch statistics its input has unit
# variance, and tests/test_torch_train.py's 4.0 would put the two logits
# of an anchor ~1,000 apart, saturate the scores and tie the proposal sort
RPN_CLS_SCALE = 0.1
SEED = 0
# a res2 and a res5 BatchNorm, and the first BatchNorm of conv1
RUNNING = tuple("%s_%s" % (bn, stat) for bn in (
    "batchnorm0", "res2_unit1_batchnorm2", "res5_unit1_batchnorm1")
    for stat in ("running_mean", "running_var"))
CHOSEN = ("res5_unit1_deformableconv2d0_offset_weight", "rfcn_trans_weight",
          "rpn_cls_weight", "res4_unit1_conv2d0_weight",
          "res3_unit1_batchnorm0_gamma")


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


@pytest.fixture(scope="module")
def run():
    """STEPS steps of each side with the same noise: the JAX step under jit,
    and the port's step on the port's model started before each step from
    the JAX state (weights, momentum, running statistics).  Per step: the
    loss parts, the chosen weights before and after and their momentum,
    and the running statistics of RUNNING."""
    jtf = load_module_by_path(
        str(ROOT / "examples" / "deformable_rfcn" / "train_fused.py"),
        "_rfcn_train_fused_torch_bn_parity")
    mx.random.seed(SEED)
    jnet = JaxRFCN(frozen_bn=False, **CFG)
    jnet.initialize()
    jnet.init_params()
    rng = np.random.RandomState(SEED)
    scale = {"offset_weight": 0.2, "rfcn_trans_weight": 0.5,
             "rfcn_cls_weight": 4.0, "rfcn_bbox_weight": 4.0,
             "rpn_cls_weight": RPN_CLS_SCALE}
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
    keys = [jax.random.fold_in(jax.random.PRNGKey(SEED), s) for s in range(STEPS)]

    def noise(k):  # train_fused.py:133-135
        k1, k2, _ = jax.random.split(k, 3)
        return (np.asarray(jax.random.uniform(k1, (B, a_total, 2), jnp.float32)),
                np.asarray(jax.random.uniform(k2, (B, ncand, 2), jnp.float32)))

    _, names, _, aux_names = functionalize(jnet, train=True)
    names = [n[len(jnet.prefix):] for n in names]
    aux = [n[len(jnet.prefix):] for n in aux_names]
    learn = [n for n in names if n not in set(aux)]
    step, state = jtf.make_rfcn_train_step(jnet, B, learning_rate=LR, momentum=0.9)
    jstep = jax.jit(step)

    tnet = load_jax_params(DeformableRFCN(device="cpu", frozen_bn=False, **CFG), params)
    tstep = train_fused.make_rfcn_train_step(tnet, B, learning_rate=LR, momentum=0.9)
    named = tnet.gluon_named_tensors()
    mom_of = {id(p): m for p, m in zip(tstep.params, tstep.momentum)}
    out = []
    for k in keys:
        with torch.no_grad():  # the port starts from the JAX state
            for n, v in zip(learn, state[0]):
                named[n].copy_(_t(v))
            for n, v in zip(learn, state[1]):
                if id(named[n]) in mom_of:
                    mom_of[id(named[n])].copy_(_t(v))
            for n, v in zip(aux, state[2]):
                named[n].copy_(_t(v))
        before = {n: np.asarray(v) for n, v in zip(learn, state[0]) if n in CHOSEN}
        state, _, jparts = jstep(state, jnp.asarray(data), jnp.asarray(info),
                                 jnp.asarray(gt), k)
        a, b = noise(k)
        tparts = tstep(_t(data), _t(info), _t(gt), _t(a), _t(b))[1].numpy()
        jl = dict(zip(learn, state[0]))
        jm = dict(zip(learn, state[1]))
        ja = dict(zip(aux, state[2]))
        out.append(dict(
            jparts=np.asarray(jparts), tparts=tparts, before=before,
            jw={n: np.asarray(jl[n]) for n in CHOSEN},
            tw={n: named[n].detach().numpy().copy() for n in CHOSEN},
            jm={n: np.asarray(jm[n]) for n in CHOSEN},
            tm={n: mom_of[id(named[n])].numpy().copy() for n in CHOSEN},
            jrun={n: np.asarray(ja[n]) for n in RUNNING},
            trun={n: named[n].detach().numpy().copy() for n in RUNNING},
            training=tnet.training))
    fixed = {n: named[n].detach().numpy().copy() for n in learn
             if n.startswith(("conv1_", "batchnorm0_", "conv2d0_", "res2_"))}
    return dict(params=params, steps=out, fixed=fixed)


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_parts_match(run, step):
    r = run["steps"][step]
    got, ref = r["tparts"], r["jparts"]
    assert np.isfinite(got).all() and got.shape == (4,)
    # four fp32 means over a few hundred terms, behind every trunk layer
    # normalised by the statistics of two images, in another order
    np.testing.assert_allclose(got, ref, rtol=5e-5, atol=1e-6)


@pytest.mark.parametrize("step", range(STEPS))
def test_running_statistics_move_and_match(run, step):
    """conv1's and res2's statistics move too: BlockGrad stops their
    gradient, not their update."""
    r = run["steps"][step]
    start = run["params"] if step == 0 else run["steps"][step - 1]["jrun"]
    for name in RUNNING:
        got, ref = r["trun"][name], r["jrun"][name]
        assert not np.array_equal(ref, start[name]), name
        var = r["jrun"][name.replace("_mean", "_var")]
        # m·r + (1 − m)·batch: fp32 batch statistics of the same
        # activations, the mean within 1e-5 of the activations' scale
        atol = 1e-5 * np.sqrt(var.max()) if name.endswith("_mean") else 0
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol, err_msg=name)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("name", CHOSEN)
def test_weights_and_momentum_match(run, step, name):
    r = run["steps"][step]
    assert not np.array_equal(r["jw"][name], r["before"][name])
    m_ref = r["jm"][name]
    # the gradient through batch statistics, summed in another order
    np.testing.assert_allclose(r["tm"][name], m_ref, rtol=1e-3,
                               atol=1e-3 * np.abs(m_ref).max(), err_msg=name)
    # p − lr·m from the same p: the momentum's error times lr
    np.testing.assert_allclose(r["tw"][name], r["jw"][name], rtol=1e-6,
                               atol=LR * 1e-3 * np.abs(m_ref).max(), err_msg=name)


def test_step_trains_in_training_mode_and_restores_eval(run):
    """The step switches the net to training mode only inside the step, and
    its fixed layers (conv1, res2) keep their weights."""
    assert [r["training"] for r in run["steps"]] == [False] * STEPS
    assert run["fixed"]
    for n, v in run["fixed"].items():
        np.testing.assert_array_equal(v, run["params"][n], err_msg=n)
