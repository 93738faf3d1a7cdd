"""SSD-300 / SSD-512 train and score steps (counterpart of
``examples/ssd/train_fused.py``; reference ``example/ssd/{train.py,
benchmark_score.py}``, BASELINE config 5: VGG16 SSD at 300², 95 FPS at
batch 16 on a TITAN X, ``example/ssd/README.md:44-50``).

- train step: the VGG16-reduced forward, MultiBoxTarget (bipartite match,
  0.5 IoU, 3:1 negative mining), softmax cross-entropy and smooth-L1, each
  over the positive count, and momentum SGD;
- score step: the forward, an fp32 softmax and MultiBoxDetection (decode,
  per-class NMS over every anchor: one ``nms_alive`` launch a batch).

PyTorch runs both eagerly; neither synchronises the host.

    python -m mxnet_tpu_torch.train_ssd --device cpu             # tiny smoke
    python -m mxnet_tpu_torch.train_ssd --size 300 --bench       # on the card
    python -m mxnet_tpu_torch.train_ssd --size 512 --bench
    python -m mxnet_tpu_torch.train_ssd --size 300 --bench --dtype bfloat16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .context import full_fp32, resolve_device
from .gluon.model_zoo.ssd import SSD300, SSD512, VGGSSD
from .ops import detection as ops_det
from .ops import elemwise, nn as ops_nn
from .train_fused import _dtype, paint_rectangles

__all__ = ["synthetic_voc", "synthetic_voc_device", "ssd_losses", "make_ssd_train_step",
           "make_score_step", "run_bench", "tiny_config"]

# the JAX example's CPU smoke: 128², 3 classes, batch 2, lr 5e-3, the first
# four sources of SSD300 and no tail
TINY_SIZE, TINY_CLASSES, TINY_BATCH, TINY_LR = 128, 3, 2, 5e-3


def tiny_config():
    """SSD300 cut to the JAX example's CPU smoke: four sources, no tail."""
    return dict(SSD300, tail=0, sizes=SSD300["sizes"][:4], ratios=SSD300["ratios"][:4])


def synthetic_voc(rng, batch, size, classes, max_gts=8):
    """Bright rectangles on noise (``examples/ssd/train_fused.py
    synthetic_voc``, the same draws from ``rng``, a numpy RandomState):
    -> data (B, 3, size, size) float32, labels (B, max_gts, 5) ``[cls, x1,
    y1, x2, y2]`` in [0, 1] corner format, -1-padded."""
    data = (rng.rand(batch, 3, size, size) * 0.2).astype(np.float32)
    gt = np.full((batch, max_gts, 5), -1.0, np.float32)
    for b in range(batch):
        for j in range(rng.randint(1, 5)):
            cls = rng.randint(0, classes)
            w, h = rng.uniform(0.1, 0.5, 2)
            x1, y1 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            gt[b, j] = [cls, x1, y1, x1 + w, y1 + h]
            px = (np.array([x1, y1, x1 + w, y1 + h]) * size).astype(int)
            data[b, cls % 3, px[1]:px[3], px[0]:px[2]] += 0.8
    return data, gt


def synthetic_voc_device(generator, batch, size, classes, max_gts=8):
    """:func:`synthetic_voc` drawn on the device of ``generator`` (a
    ``torch.Generator``): noise U(0, 0.2), 1 to 4 rectangles of 0.1–0.5 of
    the side each, a class below ``classes``, painted +0.8 onto channel
    ``cls % 3`` with the host generator's integer bounds (``int(v ·
    size)``); gt rows in [0, 1], −1-padded.  The same construction as the
    host generator (not its draws), with no host work and no copy (the JAX
    gate's ``synthetic_voc_device``).  -> (data (B, 3, size, size), gt (B,
    max_gts, 5)), float32."""
    dev = generator.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    data = u(batch, 3, size, size) * 0.2
    n = torch.randint(1, 5, (batch,), generator=generator, device=dev)
    cls = torch.randint(0, classes, (batch, max_gts), generator=generator, device=dev)
    w = u(batch, max_gts) * 0.4 + 0.1
    h = u(batch, max_gts) * 0.4 + 0.1
    x1 = u(batch, max_gts) * (1.0 - w)
    y1 = u(batch, max_gts) * (1.0 - h)
    valid = torch.arange(max_gts, device=dev) < n[:, None]
    gt = torch.where(valid[..., None],
                     torch.stack([cls.to(torch.float32), x1, y1, x1 + w, y1 + h], -1), -1.0)
    paint_rectangles(data, gt, scale=size)
    return data, gt


def ssd_losses(cls_preds, box_preds, anchors, gt):
    """-> (cls_loss, loc_loss): the JAX step's losses on fp32 predictions.
    MultiBoxTarget (3:1 negative mining) on ``cls_preds`` without a
    gradient; softmax cross-entropy over the anchors whose target is not
    ignored, and smooth-L1 (σ 1) of the masked box offsets, each over
    max(positives, 1)."""
    B = cls_preds.shape[0]
    bt, bm, ct = ops_det.multibox_target(anchors, gt, cls_preds.detach().transpose(1, 2),
                                         negative_mining_ratio=3.0)
    valid = (ct >= 0).to(torch.float32)
    logp = ops_nn.log_softmax(cls_preds, axis=-1)
    ce = -torch.gather(logp, 2, torch.clamp(ct, min=0).to(torch.int64)[..., None])[..., 0] * valid
    npos = torch.clamp(bm.reshape(B, -1, 4)[..., 0].sum(), min=1.0)
    cls_loss = ce.sum() / npos
    loc_loss = elemwise.smooth_l1((box_preds - bt) * bm, scalar=1.0).sum() / npos
    return cls_loss, loc_loss


def make_ssd_train_step(net, anchors, batch, learning_rate=1e-3, momentum=0.9,
                        compute_dtype=None):
    """-> ``(step, state)``: one momentum-SGD step of a ``VGGSSD``
    (``examples/ssd/train_fused.py make_ssd_train_step``).

    ``state = (learn, mom)``: the net's parameters (its own storage, in the
    order of the sorted Gluon names) and their momentum buffers, zeros.
    ``step(state, data, gt, lr=learning_rate) -> (state, loss, parts)``
    runs the forward, :func:`ssd_losses` (``parts`` stacks cls_loss and
    loc_loss, ``loss`` is their sum), the backward and ``m = momentum·m +
    g; p = p − lr·m`` in place, in full fp32 (TF32 off).  ``anchors`` (A,
    4) stay fp32.

    ``compute_dtype="bfloat16"``: the fp32 masters are cast to bf16 for each
    step (the gradient flows back through the cast), the images are cast,
    and the predictions are upcast to fp32 before the targets and the
    losses; gradients and momentum are fp32."""
    cdtype = _dtype(compute_dtype)
    named = sorted(net.gluon_named_tensors().items())
    # functional_call takes module attribute paths, not Gluon names
    by_id = {id(t): k for k, t in net.named_parameters()}
    paths = [by_id[id(t)] for _, t in named]
    learn = [t.detach() for _, t in named]
    mom = [torch.zeros_like(v) for v in learn]
    anc = anchors.to(torch.float32)[None]

    def step(state, data, gt, lr=learning_rate):
        learn, mom = state
        if data.shape[0] != batch:
            raise ValueError("this step was made for batch %d, got %d"
                             % (batch, data.shape[0]))
        leaves = [p.detach().requires_grad_() for p in learn]
        with full_fp32():
            cast = [v.to(cdtype) for v in leaves] if cdtype else leaves
            x = data.to(cdtype) if cdtype else data
            cls_preds, box_preds = torch.func.functional_call(net, dict(zip(paths, cast)), (x,))
            parts = torch.stack(ssd_losses(cls_preds.to(torch.float32),
                                           box_preds.to(torch.float32), anc, gt))
            loss = parts[0] + parts[1]
            # a parameter the loss does not reach gets a zero gradient
            grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        with torch.no_grad():
            torch._foreach_mul_(mom, momentum)
            torch._foreach_add_(mom, grads)
            torch._foreach_sub_(learn, torch._foreach_mul(mom, lr))
        return state, loss.detach(), parts.detach()

    return step, (learn, mom)


def make_score_step(net, anchors):
    """-> ``score(x)``: the forward in the net's parameter dtype (cast the
    net, ``net.cast("bfloat16")``, to serve in bf16, as the JAX score's
    ``compute_dtype`` casts its parameters), an fp32 softmax, and
    ``multibox_detection(nms_threshold=0.45, nms_topk=400)`` on the fp32
    anchors (``examples/ssd/train_fused.py make_score_step``, reference
    benchmark_score.py).  -> (B, A, 6) detections, under
    ``torch.inference_mode()``."""
    anc = anchors.to(torch.float32)[None]

    @torch.inference_mode()
    def score(x):
        dtype = next(net.parameters()).dtype
        cls_preds, box_preds = net(x.to(dtype))
        cls_prob = ops_nn.softmax(cls_preds.to(torch.float32), axis=-1)
        return ops_det.multibox_detection(cls_prob.transpose(1, 2),
                                          box_preds.to(torch.float32), anc,
                                          nms_threshold=0.45, nms_topk=400)

    return score


def run_bench(size=300, classes=20, train_batch=8, score_batch=16, iters=10,
              dtype=None, device=None):
    """Timed SSD train and score steps at full width (Xavier weights from
    seed 0): one warm-up call, then 3 windows of ``iters`` calls, the host
    clock around each window ending in a device synchronisation.  ``dtype`` "bfloat16": the train step's
    ``compute_dtype``, and the score step runs after ``cast("bfloat16")``.
    -> {"train": (img/s, ms a step, final loss), "score": (img/s, ms)} of
    the best windows, and prints them with the device's name."""
    dev = resolve_device(device)
    cfg = SSD300 if size == 300 else SSD512
    net = VGGSSD(classes, cfg, device=dev, generator=torch.Generator().manual_seed(0))
    anchors = net.make_anchors(size)
    rng = np.random.RandomState(0)
    print("ssd%d: %d anchors, %d params" % (
        size, anchors.shape[0], sum(p.numel() for p in net.parameters())), flush=True)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def best_window(call):
        call()
        sync()
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = call()
            sync()
            dt = (time.perf_counter() - t0) / iters
            best = dt if best is None else min(best, dt)
        return best, out

    step, state = make_ssd_train_step(net, anchors, train_batch, compute_dtype=dtype)
    data, gt = (torch.from_numpy(a).to(dev) for a in
                synthetic_voc(rng, train_batch, size, classes))
    best, (_, loss, _) = best_window(lambda: step(state, data, gt))
    results = {"train": (train_batch / best, best * 1e3, float(loss))}
    if dtype is not None:
        net.cast(dtype)
    score = make_score_step(net, anchors)
    xs = torch.from_numpy(synthetic_voc(rng, score_batch, size, classes)[0]).to(dev)
    best_s, _ = best_window(lambda: score(xs))
    results["score"] = (score_batch / best_s, best_s * 1e3)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print("ssd%d_bench on %s (%s): train %.1f img/s (%.1f ms/step, batch %d) | "
          "score+nms %.1f img/s (%.1f ms, batch %d)" % (
              size, name, dtype or "float32", results["train"][0], results["train"][1],
              train_batch, results["score"][0], results["score"][1], score_batch),
          flush=True)
    return results


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=300, choices=(300, 512))
    p.add_argument("--classes", type=int, default=20)
    p.add_argument("--train-batch", type=int, default=None,
                   help="default 8 at 300, 4 at 512")
    p.add_argument("--score-batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--bench", action="store_true")
    # the smoke draws a new batch each step, so its loss follows the batch: at
    # the JAX example's default of 8 steps both packages end above their first
    # loss; the repository runs that example with 6
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (default float32; bfloat16: bf16 trunk, "
                   "fp32 masters, anchors and box math)")
    args = p.parse_args()
    dtype = None if args.dtype in (None, "float32") else args.dtype
    if args.bench:
        tb = args.train_batch or (8 if args.size == 300 else 4)
        run_bench(size=args.size, classes=args.classes, train_batch=tb,
                  score_batch=args.score_batch, iters=args.iters, dtype=dtype,
                  device=args.device)
        return
    # the tiny smoke: the real graph at 128², the loss must fall
    dev = resolve_device(args.device)
    rng = np.random.RandomState(0)
    net = VGGSSD(TINY_CLASSES, tiny_config(), device=dev,
                 generator=torch.Generator().manual_seed(0))
    anchors = net.make_anchors(TINY_SIZE)
    step, state = make_ssd_train_step(net, anchors, TINY_BATCH, learning_rate=TINY_LR,
                                      compute_dtype=dtype)
    first = last = None
    for s in range(args.steps):
        data, gt = (torch.from_numpy(a).to(dev) for a in
                    synthetic_voc(rng, TINY_BATCH, TINY_SIZE, TINY_CLASSES))
        state, loss, parts = step(state, data, gt)
        last = float(loss)
        first = last if first is None else first
        print("step %d loss=%.4f (cls %.3f loc %.3f)" % (s, last, *parts.tolist()),
              flush=True)
    if not (np.isfinite(last) and last < first):
        raise SystemExit("the SSD loss did not fall: %.4f -> %.4f" % (first, last))
    print("SSD TRAIN OK", flush=True)


if __name__ == "__main__":
    main()
