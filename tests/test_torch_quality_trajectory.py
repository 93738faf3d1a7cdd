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
