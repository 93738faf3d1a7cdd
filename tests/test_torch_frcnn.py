"""The port's Faster R-CNN (mxnet_tpu_torch: ``FasterRCNN``, ``roi_pooling``,
class-specific ``proposal_target``, dropout, ``train_frcnn``) against the
JAX package, on the CPU, at the tiny configuration of
examples/rcnn/train_fused.py (``build_net(vgg16=False)``: five 1-conv
stages of widths 8-32, fc 64, 64×96, 3 classes, scales (1, 2), pre/post
NMS 200/32, batch_rois 16, rpn_batch 32, max_gts 8) and batch 2.

The JAX weights cross by ``load_jax_params``; the RPN score conv gets larger
weights, so that the proposal scores spread out (no near-tie in the sort at
this seed).  The step's random inputs are derived from the JAX step's key as
that step derives them: the noise from ``split(key, 3)``'s first two keys,
the dropout masks from ``fold_in(k3, 0)`` (fc6) and ``fold_in(k3, 1)``
(fc7), the keys ``key_provider`` hands the two Dropout ops in the order the
forward reaches them (the training forward's test confirms the order).

Tolerances: selections (labels, weights, sampled rois) exact; fp32 values
rtol 1e-6 for the ops, 1e-4 through the convolutions; loss parts rtol 1e-5
(fp32) and 3e-2 (bf16); bf16 gradients by direction (cosine > 0.9: under
``jax.jit`` XLA:CPU keeps bf16 expressions in fp32 across a fusion, the
port rounds each op).
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
from mxnet_tpu.ops import detection as jdet
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import rcnn_targets as jtargets
from mxnet_tpu.test_utils import load_module_by_path
from mxnet_tpu_torch import train_frcnn
from mxnet_tpu_torch.gluon.model_zoo import FasterRCNN, load_jax_params
from mxnet_tpu_torch.ops import detection as tdet
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import rcnn_targets as ttargets
from xdist_shared import shared

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF = torch.bfloat16
B = 2
STEPS = 3
SEED = 0
LR = 1e-3
CFG = dict(classes=3, image_shape=(64, 96), rpn_pre_nms=200, rpn_post_nms=32,
           **train_frcnn.TINY)
OUTPUTS = ("rpn_cls", "rpn_bbox", "rpn_label", "rpn_bt", "rpn_bw", "rois",
           "label", "bbox_target", "bbox_weight", "cls_score", "bbox_pred")
# weights compared after the steps: the first trained conv, the last, the
# RPN and the three head layers
CHOSEN = ("conv3_conv2d0_weight", "conv5_conv2d0_weight", "rpn_cls_weight",
          "fc6_weight", "fc7_weight", "bbox_pred_weight")


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


def _np(a):
    """a torch tensor or JAX array of any float dtype -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _randoms(key, Hf, Wf, A):
    """The step's random inputs from its key, as the JAX step derives them
    (examples/rcnn/train_fused.py:81-87, Dropout's keys from key_provider)."""
    k1, k2, k3 = jax.random.split(key, 3)
    R, F = B * CFG["batch_rois"], CFG["fc_hidden"]
    return (np.asarray(jax.random.uniform(k1, (B, Hf * Wf * A, 2), jnp.float32)),
            np.asarray(jax.random.uniform(k2, (B, CFG["rpn_post_nms"] + CFG["max_gts"], 2),
                                          jnp.float32)),
            np.asarray(jax.random.bernoulli(jax.random.fold_in(k3, 0), 0.5, (R, F))),
            np.asarray(jax.random.bernoulli(jax.random.fold_in(k3, 1), 0.5, (R, F))))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """``_run()``, computed once per test run (``xdist_shared``)."""
    return shared(tmp_path_factory, "torch_frcnn_run", _run)


def _run():
    """Both sides built once: the JAX serve forward, training forward and
    STEPS fp32 steps and one bf16 step, jitted, and the port's, from the
    same weights and the same random inputs."""
    jtf = load_module_by_path(str(ROOT / "examples" / "rcnn" / "train_fused.py"),
                              "_frcnn_train_fused_torch_parity")
    mx.random.seed(SEED)
    jnet, _, _ = jtf.build_net(False)
    rng = np.random.RandomState(SEED)
    w = jnet.collect_params()[jnet.prefix + "rpn_cls_weight"]
    w.set_data(nd.array((rng.randn(*w.shape) * 0.5).astype(np.float32)))
    params = {k[len(jnet.prefix):]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    data, info, gt = jtf.synthetic_voc(rng, B, CFG["image_shape"], CFG["classes"],
                                       CFG["max_gts"])
    Hf, Wf = jnet.feat_shape
    key = jax.random.PRNGKey(SEED)
    keys = [jax.random.fold_in(key, s) for s in range(STEPS)]
    rnds = [_randoms(k, Hf, Wf, jnet.num_anchors) for k in keys]

    apply, names, vals, aux_names = functionalize(jnet, train=False)
    jserve = [np.asarray(o) for o in jax.jit(lambda v, *a: apply(v, a)[0])(
        vals, data, info)]
    tapply = functionalize(jnet, train=True)[0]
    _, _, k3 = jax.random.split(keys[0], 3)
    jtrain = [np.asarray(o) for o in jax.jit(lambda v, *a: tapply(v, a, k3)[0])(
        vals, data, info, gt, *rnds[0][:2])]

    jstep, state0 = jtf.make_frcnn_train_step(jnet, B, learning_rate=LR, momentum=0.9)
    jstep = jax.jit(jstep)
    state = state0
    jparts = []
    for k in keys:
        state, _, parts = jstep(state, jnp.asarray(data), jnp.asarray(info),
                                jnp.asarray(gt), k)
        jparts.append(np.asarray(parts))
    learn = [n[len(jnet.prefix):] for n in names if n not in set(aux_names)]
    jfinal = dict(zip(learn, (np.asarray(v) for v in state[0])))
    jmom = dict(zip(learn, (np.asarray(v) for v in state[1])))
    jbstep, bstate = jtf.make_frcnn_train_step(jnet, B, learning_rate=LR, momentum=0.9,
                                               compute_dtype="bfloat16")
    bstate, _, bparts = jax.jit(jbstep)(bstate, jnp.asarray(data), jnp.asarray(info),
                                        jnp.asarray(gt), keys[0])
    jbmom = dict(zip(learn, (np.asarray(v) for v in bstate[1])))

    def port_net():
        return load_jax_params(FasterRCNN(device="cpu", **CFG), params)

    tnet = port_net()
    tserve = [o.numpy() for o in tnet(_t(data), _t(info))]
    tnet.train()
    with torch.no_grad():
        ttrain = [o.numpy() for o in tnet(_t(data), _t(info), _t(gt),
                                          *map(_t, rnds[0]))]
    tnet.eval()
    tstep = train_frcnn.make_frcnn_train_step(tnet, B, learning_rate=LR, momentum=0.9)
    tparts = [tstep(_t(data), _t(info), _t(gt), *map(_t, r))[1].numpy() for r in rnds]
    named = tnet.gluon_named_tensors()
    by_param = {id(p): m for p, m in zip(tstep.params, tstep.momentum)}
    tfinal = {n: t.detach().numpy().copy() for n, t in named.items()}
    tmom = {n: by_param[id(t)].numpy() for n, t in named.items()}
    bnet = port_net()
    bstep = train_frcnn.make_frcnn_train_step(bnet, B, learning_rate=LR, momentum=0.9,
                                              compute_dtype="bfloat16")
    tbparts = bstep(_t(data), _t(info), _t(gt), *map(_t, rnds[0]))[1].numpy()
    by_param = {id(p): m for p, m in zip(bstep.params, bstep.momentum)}
    tbmom = {n: by_param[id(t)].numpy() for n, t in bnet.gluon_named_tensors().items()}
    return dict(params=params, names=[n[len(jnet.prefix):] for n in names],
                jserve=jserve, tserve=tserve, jtrain=jtrain, ttrain=ttrain,
                jparts=jparts, tparts=tparts, jfinal=jfinal, jmom=jmom,
                tfinal=tfinal, tmom=tmom, jbparts=np.asarray(bparts),
                tbparts=tbparts, jbmom=jbmom, tbmom=tbmom)


# -- proposal_target -----------------------------------------------------


def _targets_inputs(seed):
    """gt for two images (the second without any box when ``seed`` is odd)
    and proposals jittered around them, so that fg, bg and both classes
    occur, and the noise."""
    rng = np.random.RandomState(seed)
    G, post, H, W = 8, 32, 64, 96
    gt = np.full((B, G, 5), -1.0, np.float32)
    for b in range(B):
        if b == 1 and seed % 2:
            continue
        for j in range(rng.randint(2, 6)):
            x1, y1 = rng.uniform(0, W - 30), rng.uniform(0, H - 20)
            gt[b, j] = [rng.randint(0, 3), x1, y1, x1 + rng.uniform(10, 30),
                        y1 + rng.uniform(10, 20)]
    src = np.where(gt[..., :1] >= 0, gt, [[[0, 10, 10, 40, 40]]])[..., 1:]
    pick = src[np.arange(B)[:, None], rng.randint(0, 3, (B, post))]
    boxes = pick + rng.normal(0, 5, (B, post, 4))
    rois = np.concatenate([np.repeat(np.arange(B, dtype=np.float32), post)[:, None],
                           boxes.reshape(B * post, 4)], 1).astype(np.float32)
    nz_prop = rng.rand(B, post + G, 2).astype(np.float32)
    return rois, gt, nz_prop


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("agnostic", [False, True], ids=["class_specific", "agnostic"])
def test_proposal_target_matches(seed, agnostic):
    rois, gt, nz = _targets_inputs(seed)
    # class-specific with normalised targets: Faster R-CNN's call;
    # class-agnostic without: R-FCN's
    kw = dict(num_classes=4, batch_images=B, batch_rois=2 * 16, fg_fraction=0.25,
              class_agnostic=agnostic,
              box_stds=None if agnostic else (0.1, 0.1, 0.2, 0.2))
    # op by op, not jitted: XLA's fusions move the targets' divisions by
    # ~10 ulps (1.3e-6 relative at this seed), the port rounds as JAX's ops
    ref = jtargets.proposal_target(jnp.asarray(rois), jnp.asarray(gt), jnp.asarray(nz), **kw)
    got = ttargets.proposal_target(*map(_t, (rois, gt, nz)), **kw)
    K = 2 if agnostic else 4
    label, bw = np.asarray(ref[1]), np.asarray(ref[3])
    assert bw.shape == (2 * 16, 4 * K) and (bw > 0).any()
    assert (label == 0).any() and (label > 0).any()
    if not agnostic:
        assert len(set(label[label > 0].tolist())) > 1  # several classes' slots
    # selections exact; the targets' log and division within an ulp
    for g, r, exact in zip(got, ref, (True, True, False, True)):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape
        if exact:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


# -- roi_pooling ------------------------------------------------------------

ROI_MAP = (2, 3, 9, 11)  # B, C, H, W at stride 1/16 below


def _roi_inputs(dtype):
    """Integer-valued data in 0..3 (ties everywhere) and 2·6 grouped rois:
    in the map, partly off it on each side (roi 2's last column of bins
    lies past the map: empty), wholly off it (every bin empty), one row
    tall (every bin repeats the row), and corners at an exact .5 after
    scaling (8, 24, 40, 200 -> 0.5, 1.5, 2.5, 12.5: half to even gives 0,
    2, 2, 12, where floor(x + 0.5) would give 1, 2, 3, 13)."""
    rng = np.random.RandomState(5)
    data = rng.randint(0, 4, ROI_MAP).astype(np.float32)
    boxes = np.array([[8, 24, 40, 120],             # .5 corners
                      [-40, -30, 60, 50],           # off the top left
                      [100, 90, 260, 200],          # off the bottom right
                      [400, 300, 500, 400],         # off the map: all bins empty
                      [16, 16, 150, 17],            # one row tall
                      [0, 0, 175, 143]], np.float32)
    rois = np.concatenate([np.repeat(np.arange(2, dtype=np.float32), 6)[:, None],
                           np.concatenate([boxes, boxes[::-1] + 3])], 1)
    cot = rng.randint(-4, 5, (12, 3, 3, 3)).astype(np.float32) / 4
    if dtype == "bfloat16":
        return data, rois, cot, jnp.bfloat16, BF
    return data, rois, cot, jnp.float32, torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rpi", [6, 0], ids=["grouped", "per_roi"])
@pytest.mark.parametrize("shared", [False, True], ids=["distinct", "shared_windows"])
def test_roi_pooling_forward_and_gradient_match(dtype, rpi, shared):
    """Values exact (a max picks an element); the input gradient splits
    equally among tied maxima at each of the two stages, as jnp.max's.
    ``shared``: each image's rois repeat one box, so that bins of several
    rois share their row windows (the backward sums them per window)."""
    data, rois, cot, jdt, tdt = _roi_inputs(dtype)
    if shared:
        rois = rois.copy()
        rois[1:6, 1:] = rois[0, 1:]
        rois[7:, 1:] = rois[6, 1:]
    kw = dict(pooled_size=(3, 3), spatial_scale=1.0 / 16, rois_per_image=rpi)

    def jfn(d):
        out = jdet.roi_pooling(d, jnp.asarray(rois), **kw)
        return out, jnp.sum(out.astype(jnp.float32) * cot)

    # jitted, as the JAX model runs it: its bin sizes are extent · fp32(1/n)
    jout = _np(jax.jit(lambda d: jfn(d)[0])(jnp.asarray(data, jdt)))
    jgrad = _np(jax.jit(jax.grad(lambda d: jfn(d)[1]))(jnp.asarray(data, jdt)))
    td = _t(data).to(tdt).requires_grad_()
    out = tdet.roi_pooling(td, _t(rois), **kw)
    (out.float() * _t(cot)).sum().backward()
    assert out.dtype == tdt and out.shape == (12, 3, 3, 3)
    np.testing.assert_array_equal(_np(out), jout)
    if not shared:  # empty bins give 0: all of roi 3's, the last column of roi 2's
        assert (jout[3] == 0).all() and (jout[2, :, :, 2] == 0).all() and jout[2].any()
    assert 0 < np.abs(jgrad).max() and np.any(jgrad % 0.25 != 0)  # split ties
    if dtype == "float32":
        np.testing.assert_allclose(_np(td.grad), jgrad, rtol=1e-6, atol=1e-7)
    else:  # bf16 sums of the shares in another order
        np.testing.assert_allclose(_np(td.grad), jgrad, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("height", [255, 256, 300])
def test_roi_pooling_gradient_splits_among_hundreds_of_tied_rows(height):
    """One roi over a (1, 1, H, 1) map of zeros in one bin: every row ties,
    so each gets 1/H of the gradient, as the jitted JAX op gives (a count
    of tied rows held in 8 bits wraps at 256)."""
    data = np.zeros((1, 1, height, 1), np.float32)
    rois = np.array([[0, 0, 0, 0, height - 1]], np.float32)
    kw = dict(pooled_size=(1, 1), spatial_scale=1.0)
    jgrad = np.asarray(jax.jit(jax.grad(lambda d: jnp.sum(
        jdet.roi_pooling(d, jnp.asarray(rois), **kw))))(jnp.asarray(data)))
    td = _t(data).requires_grad_()
    tdet.roi_pooling(td, _t(rois), **kw).sum().backward()
    got = td.grad.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(jgrad, 1.0 / height, rtol=1e-6)
    np.testing.assert_allclose(got, jgrad, rtol=1e-6)


def test_roi_pooling_bin_bounds_round_half_to_even():
    _, rois, _, _, _ = _roi_inputs("float32")
    hs, he, ws, we = tdet._roi_bins(_t(rois[:1]), 1.0 / 16, 3, 3, 9, 11)
    # x: round(0.5) = 0 .. round(2.5) = 2: three columns, one per bin
    assert ws.tolist() == [[0, 1, 2]] and we.tolist() == [[1, 2, 3]]
    # y: round(1.5) = 2 .. round(7.5) = 8: seven rows
    assert hs.tolist() == [[2, 4, 6]] and he.tolist() == [[5, 7, 9]]


def test_roi_pooling_bins_are_the_jitted_ops():
    """Every roi height 1..200 in 7 bins: the bounds that the JAX op gets
    under jax.jit, where XLA multiplies by fp32(1/7) for the division by 7
    (the eager op divides: ceil(7 · (3/7)) = 3, ceil(7 · 3·fp32(1/7)) = 4)."""
    n = 200
    rois = np.zeros((n, 5), np.float32)
    rois[:, 4] = np.arange(n) * 16.0  # y from 0 to round(y2/16) = 0 .. n-1
    hs, he, _, _ = tdet._roi_bins(_t(rois), 1.0 / 16, 7, 7, 10 ** 4, 10 ** 4)

    def bounds(r):
        ye = jnp.round(r[:, 4] / 16.0).astype(jnp.int32)
        bs = jnp.maximum(ye + 1, 1).astype(jnp.float32) / 7
        p = jnp.arange(7, dtype=jnp.float32)
        return (jnp.floor(p[None] * bs[:, None]).astype(jnp.int32),
                jnp.ceil((p[None] + 1) * bs[:, None]).astype(jnp.int32))

    js, je = (np.asarray(a) for a in jax.jit(bounds)(jnp.asarray(rois)))
    np.testing.assert_array_equal(hs.numpy(), js)
    np.testing.assert_array_equal(he.numpy(), je)
    assert (he.numpy() != np.asarray(bounds(jnp.asarray(rois))[1])).any()  # eager differs


# -- dropout ----------------------------------------------------------------


@pytest.mark.parametrize("fold", [0, 1])
def test_dropout_with_the_jax_mask_matches_the_jax_op(fold):
    rng = np.random.RandomState(fold)
    x = rng.randn(32, 64).astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(3), fold)
    ref = jnn.dropout(jnp.asarray(x), p=0.5, training=True, key=key)
    keep = np.asarray(jax.random.bernoulli(key, 0.5, (32, 64)))
    got = tnn.dropout(_t(x), p=0.5, training=True, keep=_t(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tnn.dropout(_t(x), p=0.5).numpy(), x)  # eval
    with pytest.raises(ValueError, match="Generator"):
        tnn.dropout(_t(x), p=0.5, training=True)
    gen = torch.Generator().manual_seed(0)
    drawn = tnn.dropout(_t(x), p=0.5, training=True, generator=gen)
    assert 0.3 < float((drawn == 0).float().mean()) < 0.7


# -- the model --------------------------------------------------------------


def test_every_jax_parameter_name_maps_to_the_port(run):
    port = FasterRCNN(device="cpu", **CFG).gluon_named_tensors()
    assert sorted(port) == sorted(run["names"])
    for n, v in run["params"].items():
        assert tuple(port[n].shape) == v.shape, n


def test_serve_forward_matches(run):
    """rois, cls_prob and bbox_pred of the whole inference forward."""
    rois, prob, bbox = run["tserve"]
    jrois, jprob, jbbox = run["jserve"]
    assert rois.shape == (B * 32, 5) and bbox.shape == (B * 32, 16)
    np.testing.assert_allclose(rois, jrois, rtol=0, atol=1e-4)
    np.testing.assert_allclose(prob, jprob, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bbox, jbbox, rtol=1e-4, atol=1e-5 * np.abs(jbbox).max())


# The bf16 RPN scores tie often (about a third of an image's top 200), so
# the rois of the two sides agree in order only if the port's probabilities
# equal the JAX op's bit for bit: its bf16 softmax takes jax.nn.softmax's
# rounded steps (torch.softmax, rounding once, reordered ties at seeds 1, 3
# and 4 of 0-7).  What differences remain come from the trunk's bf16
# convolutions (at seed 4, 2 of conv5's 1,536 values an ulp apart; the rois
# still within 2e-5 px).
SERVE_BF16_SEEDS = range(8)


@pytest.mark.parametrize("shape, axis", [((2, 2, 54, 6), 1), ((64, 4), -1), ((8, 1000), -1)])
def test_bf16_softmax_equals_the_jax_op_bit_for_bit(shape, axis):
    x = (np.random.RandomState(len(shape)).randn(*shape) * 3).astype(np.float32)
    ref = jax.nn.softmax(jnp.asarray(x, jnp.bfloat16), axis=axis)
    got = tnn.softmax(_t(x).to(BF), axis=axis)
    assert got.dtype == BF
    np.testing.assert_array_equal(_np(got), _np(ref))


@pytest.fixture(scope="module")
def bf16_serve():
    """seed -> (the JAX net's params, its input, im_info, its bf16 serve
    outputs and its two RPN outputs): the tiny net of each seed cast to bf16,
    its serve forward jitted once for all seeds (the parameters are
    arguments, so one trace serves every seed's values)."""
    jtf = load_module_by_path(str(ROOT / "examples" / "rcnn" / "train_fused.py"),
                              "_frcnn_train_fused_torch_bf16_serve")
    info = np.array([[64, 96, 1.0], [48, 80, 1.0]], np.float32)
    jitted = []

    def build(seed):
        mx.random.seed(seed)
        jnet, _, _ = jtf.build_net(False)
        rng = np.random.RandomState(seed)
        w = jnet.collect_params()[jnet.prefix + "rpn_cls_weight"]
        w.set_data(nd.array((rng.randn(*w.shape) * 0.5).astype(np.float32)))
        params = {k[len(jnet.prefix):]: p.data().asnumpy()
                  for k, p in jnet.collect_params().items()}
        x = _t(rng.randn(B, 3, 64, 96).astype(np.float32)).to(BF)
        jnet.cast("bfloat16")
        rpn, proposals = [], jnet._proposals

        def capture(F, rpn_cls, rpn_bbox, im_info):  # the RPN outputs, traced
            rpn[:] = [rpn_cls._data, rpn_bbox._data]
            return proposals(F, rpn_cls, rpn_bbox, im_info)

        jnet._proposals = capture
        apply, _, vals, _ = functionalize(jnet, train=False)
        if not jitted:
            jitted.append(jax.jit(lambda v, *a: (apply(v, a)[0], tuple(rpn))))
        out, rpn_out = jitted[0](vals, jnp.asarray(_np(x), jnp.bfloat16), jnp.asarray(info))
        return params, x, info, out, rpn_out

    return build


@pytest.mark.parametrize("seed", SERVE_BF16_SEEDS)
def test_serve_forward_after_cast_matches_jax(bf16_serve, seed):
    """The tiny net served after ``cast("bfloat16")`` against the JAX net
    cast the same way, jitted (its ROIPooling bins are the jitted op's):
    rois fp32, in the same order within 0.1 px (decoded in fp32 from bf16
    deltas that may differ by an ulp); probabilities and deltas bf16,
    within a few ulps.  The port's proposals from the JAX net's own RPN
    outputs are the JAX rois, so any difference in the rois comes from
    above the proposal op."""
    params, x, info, ref, (jrpn_cls, jrpn_bbox) = bf16_serve(seed)
    tnet = load_jax_params(FasterRCNN(device="cpu", **CFG), params).cast("bfloat16")
    assert all(t.dtype == BF for t in tnet.state_dict().values())
    got = tnet(x, _t(info))
    assert [a.dtype for a in got] == [torch.float32, BF, BF]
    assert [str(r.dtype) for r in ref] == ["float32", "bfloat16", "bfloat16"]
    rois, prob, bbox = (_np(a) for a in got)
    jrois, jprob, jbbox = (_np(r) for r in ref)
    assert rois.shape == (B * 32, 5) and bbox.shape == (B * 32, 16)
    with torch.inference_mode():
        cross = tnet._proposals(_t(_np(jrpn_cls)).to(BF), _t(_np(jrpn_bbox)).to(BF), _t(info))
    np.testing.assert_allclose(_np(cross), jrois, rtol=0, atol=1e-4)
    np.testing.assert_allclose(rois, jrois, rtol=0, atol=0.1)
    np.testing.assert_allclose(prob, jprob, rtol=0, atol=1e-2)
    np.testing.assert_allclose(bbox, jbbox, rtol=0, atol=3e-2 * np.abs(jbbox).max())


def test_training_forward_matches(run):
    """The 11 outputs with the same noise and the dropout masks of the JAX
    key order: cls_score and bbox_pred agree only if fc6's mask is
    ``fold_in(k3, 0)``'s and fc7's ``fold_in(k3, 1)``'s."""
    for name, got, ref in zip(OUTPUTS, run["ttrain"], run["jtrain"]):
        assert got.shape == ref.shape, name
        if name in ("rpn_label", "rpn_bw", "label", "bbox_weight"):
            np.testing.assert_array_equal(got, ref, err_msg=name)
        elif name == "rois":
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=name)
    assert np.any(run["ttrain"][8][:, 8:] > 0)  # a foreground class's slot


@pytest.mark.parametrize("step", range(STEPS))
def test_loss_parts_match(run, step):
    got, ref = run["tparts"][step], run["jparts"][step]
    assert np.isfinite(got).all() and got.shape == (4,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", CHOSEN)
def test_weights_and_momentum_match_after_three_steps(run, name):
    p0, ref, got = run["params"][name], run["jfinal"][name], run["tfinal"][name]
    assert not np.array_equal(ref, p0)  # the weight moved
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    m_ref, m_got = run["jmom"][name], run["tmom"][name]
    assert np.abs(m_ref).max() > 0
    np.testing.assert_allclose(m_got, m_ref, rtol=1e-3, atol=1e-4 * np.abs(m_ref).max())


def test_conv1_and_conv2_stay(run):
    fixed = [n for n in run["params"] if n.startswith(("conv1_", "conv2_"))]
    assert len(fixed) == 4
    for n in fixed:
        np.testing.assert_array_equal(run["jfinal"][n], run["params"][n])
        np.testing.assert_array_equal(run["tfinal"][n], run["params"][n])
        assert not run["tmom"][n].any()


def test_bf16_step_matches(run):
    """One compute_dtype="bfloat16" step: the loss parts at bf16 tolerance,
    each trained layer's gradient (the first momentum) by direction."""
    got, ref = run["tbparts"], run["jbparts"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=3e-2, atol=1e-3)
    for name in CHOSEN:
        a, b = run["tbmom"][name].ravel(), run["jbmom"][name].ravel()
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > 0.9, (name, cos)


def test_train_step_checks_its_inputs():
    net = FasterRCNN(device="cpu", **CFG)
    rng = np.random.RandomState(1)
    batch = [_t(a) for a in train_frcnn.synthetic_coco(rng, B, (64, 96), 3, 8)]
    rnd = train_frcnn.draw_randoms(net, B, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(r.shape) for r in rnd] == [tuple(s) for s in train_frcnn.random_shapes(net, B)]
    net.train()
    with pytest.raises(ValueError, match="keep6"):
        net(*batch, *rnd[:2], rnd[2][:5], rnd[3][:5])
    with pytest.raises(ValueError, match="together"):
        net(*batch, *rnd[:3])
    with pytest.raises(ValueError, match="Generator"):  # dropout draws nothing itself
        net(*batch, *rnd[:2])
    step = train_frcnn.make_frcnn_train_step(net, B)
    with pytest.raises(ValueError, match="batch 2"):
        step(*(t[:1] for t in batch), *rnd)


def test_run_bench_runs_on_the_cpu_when_asked(capsys, monkeypatch):
    img_s, ms, loss = train_frcnn.run_bench(False, batch=1, iters=1, windows=1,
                                            device="cpu")
    assert img_s > 0 and ms > 0 and np.isfinite(loss)
    assert "on cpu" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_frcnn.run_bench(False, iters=1, windows=1)
