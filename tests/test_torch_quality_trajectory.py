"""The per-step losses of the two detection-quality gates' train steps, JAX
package against port, on the same weights and the same batches (the
``slow`` tier: ``-m slow``).

For the SSD300 gate (``examples/quality/eval_ssd_map.py`` against
``mxnet_tpu_torch.quality.eval_ssd_map``: VGG16-reduced SSD300, 3 classes,
batch 4, lr 5e-3 with the gate's warm-up, momentum 0.9) and the Faster
R-CNN VGG16 gate (``eval_frcnn_map.py``: 608×1024, 3 classes, batch 1, lr
2e-3, momentum 0.9), each in fp32 on the CPU: the JAX net is built and
initialised as its gate builds it, its weights cross with
``load_jax_params``, and both steps take the same numpy batches, drawn from
one ``RandomState`` (the gates' host stream, ``synthetic_voc``).  The
Faster R-CNN step's random inputs (the anchor and proposal sampling noise,
the dropout masks) are the JAX step's own draws from its key, handed to
the port's step.  Nothing is drawn from either package's device stream.

Each gate runs ``MXNET_TRAJECTORY_STEPS`` steps (200) or as many as
``MXNET_TRAJECTORY_MINUTES`` (20) allow, and prints which, with every
step's pair of losses.  Tolerance: the first 3 steps within rtol 1e-4 (the
same step from the same weights: fp32 sums in another order); after that
free-running trajectories drift apart as any two fp32 runs do, so each
window of 25 steps must agree in its mean loss within 5%: a port fault
that changes what the step learns moves the means, rounding does not.

``MXNET_TRAJECTORY_WIDTH=tiny`` runs the gates' CPU configurations instead
(the SSD at 128², width 0.125; the tiny Faster R-CNN at 64×96), which a
machine without the memory for the full widths can afford; a number (0.25,
the JAX SSD gate's CPU width) runs SSD300's real geometry (300², 8,732
anchors) at that trunk width, and the tiny Faster R-CNN.
"""
import math
import os
import pathlib
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.test_utils import load_module_by_path
from mxnet_tpu_torch import train_frcnn, train_ssd
from mxnet_tpu_torch.context import full_fp32
from mxnet_tpu_torch.gluon.model_zoo import SSD300, VGGSSD, load_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS = int(os.environ.get("MXNET_TRAJECTORY_STEPS", "200"))
MINUTES = float(os.environ.get("MXNET_TRAJECTORY_MINUTES", "20"))
_WIDTH = os.environ.get("MXNET_TRAJECTORY_WIDTH", "full")
TINY = _WIDTH != "full"
SSD_WIDTH = None if _WIDTH in ("full", "tiny") else float(_WIDTH)
SEED = 0
FIRST, FIRST_RTOL, WINDOW, WINDOW_RTOL = 3, 1e-4, 25, 0.05


def _run(jstep, tstep, batch_of, what):
    """Step both sides on the same batches until STEPS or MINUTES; ->
    (JAX losses, port losses)."""
    jl, tl = [], []
    t0 = time.time()
    for s in range(STEPS):
        if time.time() - t0 > MINUTES * 60:
            break
        batch = batch_of(s)
        jl.append(jstep(s, batch))
        tl.append(tstep(s, batch))
        print("%s step %d  jax %.6f  port %.6f" % (what, s, jl[-1], tl[-1]), flush=True)
    print("%s: %d steps of %d (%s), %.0f s" % (
        what, len(jl), STEPS, "all" if len(jl) == STEPS else "the time limit",
        time.time() - t0), flush=True)
    return np.array(jl), np.array(tl)


def _check(jl, tl, what):
    np.testing.assert_allclose(tl[:FIRST], jl[:FIRST], rtol=FIRST_RTOL, err_msg=what)
    for w in range(0, len(jl) - WINDOW + 1, WINDOW):
        a, b = jl[w:w + WINDOW].mean(), tl[w:w + WINDOW].mean()
        print("%s window %d-%d: jax %.5f port %.5f (%+.2f%%)"
              % (what, w, w + WINDOW - 1, a, b, 100 * (b - a) / a), flush=True)
        assert abs(b - a) <= WINDOW_RTOL * abs(a), (what, w, a, b)


@pytest.mark.slow
def test_ssd300_gate_trajectory():
    jtf = load_module_by_path(str(ROOT / "examples" / "ssd" / "train_fused.py"),
                              name="_ssd_train_fused_trajectory")
    jvgg = load_module_by_path(str(ROOT / "examples" / "ssd" / "vgg_ssd.py"),
                               name="_vgg_ssd_trajectory")
    size, width, cfg = ((300, SSD_WIDTH or 1.0, SSD300) if SSD_WIDTH or not TINY
                        else (128, 0.125, train_ssd.tiny_config()))
    classes, batch, lr, gate_steps = 3, 4, 5e-3, 2000
    mx.random.seed(SEED)
    jnet = jvgg.VGGSSD(classes, jvgg.SSD300 if size == 300 else cfg, width=width)
    jnet.initialize(mx.init.Xavier())
    jnet(mx.nd.zeros((1, 3, size, size)))
    janchors = jnet.make_anchors(size)
    params = {k[len(jnet.prefix):]: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = load_jax_params(VGGSSD(classes, cfg, width=width, device="cpu"), params)
    tanchors = tnet.make_anchors(size)
    np.testing.assert_array_equal(tanchors.numpy(), np.asarray(janchors))
    jstep, jstate = jtf.make_ssd_train_step(jnet, janchors, batch, learning_rate=lr,
                                            momentum=0.9)
    jstep = jax.jit(jstep)
    tstep, tstate = train_ssd.make_ssd_train_step(tnet, tanchors, batch, learning_rate=lr,
                                                  momentum=0.9)
    warmup = gate_steps // 10  # the gate's schedule over its first steps
    key = jax.random.PRNGKey(SEED)
    rng = np.random.RandomState(SEED)
    box = {"j": jstate, "t": tstate}

    def lr_at(s):
        return lr * min(1.0, (s + 1) / warmup)

    def j(s, b):
        box["j"], loss, _ = jstep(box["j"], b[0], b[1], jax.random.fold_in(key, s),
                                  np.float32(lr_at(s)))
        return float(loss)

    def t(s, b):
        box["t"], loss, _ = tstep(box["t"], torch.from_numpy(b[0]), torch.from_numpy(b[1]),
                                  lr=lr_at(s))
        return float(loss)

    jl, tl = _run(j, t, lambda s: train_ssd.synthetic_voc(rng, batch, size, classes),
                  "ssd%d-w%g" % (size, width))
    _check(jl, tl, "ssd")


@pytest.mark.slow
def test_frcnn_vgg16_gate_trajectory():
    jtf = load_module_by_path(str(ROOT / "examples" / "rcnn" / "train_fused.py"),
                              name="_frcnn_train_fused_trajectory")
    classes, lr = 3, 2e-3
    mx.random.seed(SEED)
    jnet, shape, _ = jtf.build_net(not TINY, classes=classes)
    params = {k[len(jnet.prefix):]: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet, _, _ = train_frcnn.build_net(not TINY, classes=classes, device="cpu",
                                       generator=torch.Generator().manual_seed(SEED))
    load_jax_params(tnet, params)
    jstep, jstate = jtf.make_frcnn_train_step(jnet, 1, learning_rate=lr, momentum=0.9)
    jstep = jax.jit(jstep)
    tstep = train_frcnn.make_frcnn_train_step(tnet, 1, learning_rate=lr, momentum=0.9)
    Hf, Wf = jnet.feat_shape
    A, R = jnet.num_anchors, tnet.batch_rois
    key = jax.random.PRNGKey(SEED)
    rng = np.random.RandomState(SEED)
    box = {"j": jstate}

    def randoms(k):
        """The JAX step's draws from its key (examples/rcnn/train_fused.py:
        81-87; the Dropout masks from key_provider's fold-ins of k3)."""
        k1, k2, k3 = jax.random.split(k, 3)
        return [torch.from_numpy(np.asarray(a)) for a in (
            jax.random.uniform(k1, (1, Hf * Wf * A, 2), jnp.float32),
            jax.random.uniform(k2, (1, jnet.rpn_post_nms + jnet.max_gts, 2), jnp.float32),
            jax.random.bernoulli(jax.random.fold_in(k3, 0), 0.5, (R, tnet.fc_hidden)),
            jax.random.bernoulli(jax.random.fold_in(k3, 1), 0.5, (R, tnet.fc_hidden)))]

    def j(s, b):
        box["j"], loss, _ = jstep(box["j"], *b, jax.random.fold_in(key, s), np.float32(lr))
        return float(loss)

    def t(s, b):
        loss, _ = tstep(*map(torch.from_numpy, b), *randoms(jax.random.fold_in(key, s)), lr=lr)
        return float(loss)

    jl, tl = _run(j, t, lambda s: jtf.synthetic_voc(rng, 1, shape, classes, jnet.max_gts),
                  "frcnn-vgg16" if not TINY else "frcnn-tiny")
    _check(jl, tl, "frcnn")


@pytest.mark.slow
def test_frcnn_vgg16_proposals_from_the_jax_rpn_outputs():
    """Where the two Faster R-CNN steps part at full width (ROADMAP C6): after
    one JAX step, the port's training forward on the JAX weights and the
    same batch, noise and masks gives RPN outputs within 2e-5 of the JAX
    forward's, and its proposal and target ops fed the JAX forward's RPN
    outputs sample the JAX forward's rois, labels and targets.  The port's
    own RPN outputs, fp32 roundings away, may swap two proposals whose
    scores tie within them, and the noise that samples the background rois
    is drawn by position: from there the two trajectories differ."""
    from mxnet_tpu.gluon.functional import functionalize

    jtf = load_module_by_path(str(ROOT / "examples" / "rcnn" / "train_fused.py"),
                              name="_frcnn_train_fused_proposals")
    classes, lr = 3, 2e-3
    mx.random.seed(SEED)
    jnet, shape, _ = jtf.build_net(not TINY, classes=classes)
    apply, names, vals, aux_names = functionalize(jnet, train=True)
    jstep, jstate = jtf.make_frcnn_train_step(jnet, 1, learning_rate=lr, momentum=0.9)
    Hf, Wf = jnet.feat_shape
    A = jnet.num_anchors
    key = jax.random.PRNGKey(SEED)
    rng = np.random.RandomState(SEED)
    b0, b1 = (jtf.synthetic_voc(rng, 1, shape, classes, jnet.max_gts) for _ in range(2))
    learn = jax.jit(jstep)(jstate, *b0, jax.random.fold_in(key, 0), np.float32(lr))[0][0]
    learn_idx = [i for i, n in enumerate(names) if n not in set(aux_names)]
    merged = list(vals)
    for i, v in zip(learn_idx, learn):
        merged[i] = v
    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 1), 3)
    nz_rpn = jax.random.uniform(k1, (1, Hf * Wf * A, 2), jnp.float32)
    nz_prop = jax.random.uniform(k2, (1, jnet.rpn_post_nms + jnet.max_gts, 2), jnp.float32)
    jouts = jax.jit(lambda v: apply(v, (b1[0], b1[1], b1[2], nz_rpn, nz_prop), k3)[0])(merged)
    jouts = [np.asarray(getattr(o, "_data", o)) for o in jouts]
    tnet, _, _ = train_frcnn.build_net(not TINY, classes=classes, device="cpu",
                                       generator=torch.Generator().manual_seed(SEED))
    load_jax_params(tnet, {n[len(jnet.prefix):]: np.asarray(v) for n, v in zip(names, merged)})
    R = tnet.batch_rois
    keeps = [jax.random.bernoulli(jax.random.fold_in(k3, i), 0.5, (R, tnet.fc_hidden))
             for i in (0, 1)]
    tin = [torch.from_numpy(np.asarray(a)) for a in (*b1, nz_rpn, nz_prop, *keeps)]
    tnet.train()
    with torch.no_grad(), full_fp32():
        touts = tnet(*tin)
        for i in (0, 1):  # rpn_cls, rpn_bbox
            np.testing.assert_allclose(touts[i].numpy(), jouts[i], rtol=0, atol=2e-5)
        rois = tnet._proposals(*(torch.from_numpy(jouts[i]) for i in (0, 1)), tin[1])
        _, (rois_s, label, bbox_target, bbox_weight) = tnet._targets(
            rois, tin[2], tin[1], tin[3], tin[4])
        own = tnet._proposals(touts[0], touts[1], tin[1])
    apart = np.nonzero(np.abs(own.numpy() - rois.numpy()).max(1) > 1e-2)[0]
    print("RPN outputs apart by %.3e / %.3e; proposals from the port's own RPN outputs: rows "
          "%s of %d differ; sampled rois from them: %d of %d rows differ" % (
              np.abs(touts[0].numpy() - jouts[0]).max(), np.abs(touts[1].numpy() - jouts[1]).max(),
              apart.tolist(), rois.shape[0],
              int((np.abs(touts[5].numpy() - jouts[5]).max(1) > 1e-2).sum()), jouts[5].shape[0]),
          flush=True)
    np.testing.assert_allclose(rois_s.numpy(), jouts[5], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(label.numpy(), jouts[6])
    np.testing.assert_allclose(bbox_target.numpy(), jouts[7], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(bbox_weight.numpy(), jouts[8])


@pytest.mark.slow
def test_frcnn_vgg16_first_update_parts_at_relu_gates(monkeypatch):
    """The first update of the full-width Faster R-CNN step (ROADMAP C6):
    the JAX step's and the port's part by ~1e-3 of the update, because the
    forwards, fp32 roundings apart, gate a few ReLU inputs that lie within
    that rounding of 0 on opposite sides.  With fc6's and fc7's ReLU gates
    taken from the JAX forward, the port's update of fc6, fc7, cls_score
    and bbox_pred equals the JAX step's within 1e-4 of each parameter's
    update, and the trunk's gap is within 3x of what the port's own update
    moves by when noise of 1e-7 of the image's standard deviation is added
    to the image: the step is that sensitive at full width."""
    import mxnet_tpu_torch.ops.nn as tnn
    from mxnet_tpu.gluon.functional import functionalize
    from mxnet_tpu.gluon.model_zoo import detection as jdet

    jtf = load_module_by_path(str(ROOT / "examples" / "rcnn" / "train_fused.py"),
                              name="_frcnn_train_fused_gates")
    classes, lr = 3, 2e-3
    mx.random.seed(SEED)
    jnet, shape, _ = jtf.build_net(not TINY, classes=classes)
    params = {k[len(jnet.prefix):]: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    apply, names, vals, aux_names = functionalize(jnet, train=True)
    learn_names = [n[len(jnet.prefix):] for n in names if n not in set(aux_names)]
    jstep, jstate = jtf.make_frcnn_train_step(jnet, 1, learning_rate=lr, momentum=0.9)
    Hf, Wf = jnet.feat_shape
    key = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    batch = jtf.synthetic_voc(np.random.RandomState(SEED), 1, shape, classes, jnet.max_gts)
    learn = jax.jit(jstep)(jstate, *batch, key, np.float32(lr))[0][0]
    d_jax = {n: np.asarray(a1) - np.asarray(a0) for n, a0, a1 in zip(learn_names, jstate[0], learn)}
    k1, k2, k3 = jax.random.split(key, 3)
    nz_rpn = jax.random.uniform(k1, (1, Hf * Wf * jnet.num_anchors, 2), jnp.float32)
    nz_prop = jax.random.uniform(k2, (1, jnet.rpn_post_nms + jnet.max_gts, 2), jnp.float32)
    stash = []

    def head(self, F, c5, rois, rois_per_image=0):  # jdet.FasterRCNN._head, fc outputs kept
        pooled = F.ROIPooling(c5, rois, pooled_size=(self.pooled, self.pooled),
                              spatial_scale=1.0 / self.stride,
                              rois_per_image=int(rois_per_image))
        a6 = self.fc6(F.Flatten(pooled))
        a7 = self.fc7(self.drop6(a6))
        h = self.drop7(a7)
        stash[:] = [a6, a7]
        return self.cls_score(h), self.bbox_pred(h)

    with monkeypatch.context() as m:
        m.setattr(jdet.FasterRCNN, "_head", head)
        acts = jax.jit(lambda v: (apply(v, (batch[0], batch[1], batch[2], nz_rpn, nz_prop),
                                        k3), [getattr(s, "_data", s) for s in stash])[1])(vals)
    jgates = [torch.from_numpy(np.asarray(a) > 0) for a in acts]
    keeps = [jax.random.bernoulli(jax.random.fold_in(k3, i), 0.5, tuple(jgates[i].shape))
             for i in (0, 1)]
    rand = [torch.from_numpy(np.asarray(a)) for a in (nz_rpn, nz_prop, *keeps)]

    def port_update(noise=0.0, gates=None):
        tnet, _, _ = train_frcnn.build_net(not TINY, classes=classes, device="cpu",
                                           generator=torch.Generator().manual_seed(SEED))
        load_jax_params(tnet, params)
        named = tnet.gluon_named_tensors()
        before = {n: t.detach().clone() for n, t in named.items()}
        flips, plain = [], tnn.activation

        def activation(data, *, act_type):
            if gates is not None and tuple(data.shape) == tuple(gates[0].shape):
                g = gates[len(flips)]
                flips.append(int(((data > 0) != g).sum()))
                return data * g
            return plain(data, act_type=act_type)

        with monkeypatch.context() as m:
            m.setattr(tnn, "activation", activation)
            step = train_frcnn.make_frcnn_train_step(tnet, 1, learning_rate=lr, momentum=0.9)
            data = torch.from_numpy(batch[0])
            data = data + noise * data.std() * torch.randn(
                data.shape, generator=torch.Generator().manual_seed(SEED + 1))
            step(data, *map(torch.from_numpy, batch[1:]), *rand, lr=lr)
        return {n: (named[n].detach() - before[n]).numpy() for n in d_jax}, flips

    def rel(a, b, only=None):
        keys = [n for n in b if only is None or n.startswith(only)]
        return math.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in keys)
                         / sum((b[n] ** 2).sum() for n in keys))

    own, _ = port_update()
    gated, flips = port_update(gates=jgates)
    noised, _ = port_update(noise=1e-7)
    trunk, sensitivity = rel(gated, d_jax, "conv"), rel(noised, own, "conv")
    print("first update against the JAX step: all %.3e, fc6/fc7 %.3e; with the JAX forward's "
          "fc6 / fc7 gates (%s of the port's own differ): fc6/fc7 %.3e, trunk (conv) %.3e; "
          "the port's own update with 1e-7 input noise: trunk %.3e, fc6/fc7 %.3e" % (
              rel(own, d_jax), rel(own, d_jax, ("fc6", "fc7")), flips,
              rel(gated, d_jax, ("fc6", "fc7")), trunk, sensitivity,
              rel(noised, own, ("fc6", "fc7"))), flush=True)
    for n in d_jax:
        if n.startswith(("fc6", "fc7", "cls_score", "bbox_pred")):
            assert rel({n: gated[n]}, {n: d_jax[n]}) <= 1e-4, n
    assert trunk <= 3 * sensitivity, (trunk, sensitivity)
