"""SSD detection quality: mAP on synthetic VOC data (counterpart of
``examples/quality/eval_ssd_map.py``).

Trains the VGG16-reduced SSD at its real anchor menu (SSD300: 8,732
anchors, SSD512: 24,564) from seeded Xavier weights on a synthetic-VOC
stream drawn on the device (``train_ssd.synthetic_voc_device``): momentum
SGD 0.9, a linear warm-up over the first tenth of the steps, then ×0.1 at
60% and 85% (from-scratch SSD collapses on some seeds without the warm-up).
On the card with ``--full`` the step computes in bf16 (fp32 masters), as the
JAX gate trains on its chip; elsewhere in fp32.  Then the fp32 score step
(softmax, MultiBoxDetection, per-class NMS over every anchor) scores the
held-out host stream (``RandomState(12345)``) with ``VOCMApMetric``.

    python -m mxnet_tpu_torch.quality.eval_ssd_map --full               # SSD300, card
    python -m mxnet_tpu_torch.quality.eval_ssd_map --full --size 512
    python -m mxnet_tpu_torch.quality.eval_ssd_map --device cpu --steps 4 --eval-images 2
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..context import resolve_device
from ..gluon.model_zoo.ssd import SSD300, SSD512, VGGSSD
from ..metric import VOCMApMetric
from ..train_ssd import (make_score_step, make_ssd_train_step, synthetic_voc,
                         synthetic_voc_device, tiny_config)
from .common import EVAL_SEED, finish, learning_rates, report, train_loop

__all__ = ["build", "evaluate", "parse", "run", "main"]

ANCHORS = {300: 8732, 512: 24564}
# without --full: the tiny configuration of the CPU tests (the JAX example's
# CPU smoke, 128², four sources, at width 0.125)
TINY_SIZE, TINY_WIDTH, TINY_ANCHORS = 128, 0.125, 1528


def build(full, size, classes, seed, device):
    """-> (net, image size, anchors): SSD300 / SSD512 at full width, or the
    tiny configuration; Xavier weights drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    if full:
        net = VGGSSD(classes, SSD300 if size == 300 else SSD512, device=device, generator=gen)
        want = ANCHORS[size]
    else:
        size = TINY_SIZE
        net = VGGSSD(classes, tiny_config(), width=TINY_WIDTH, device=device, generator=gen)
        want = TINY_ANCHORS
    anchors = net.make_anchors(size)
    if anchors.shape[0] != want:
        raise SystemExit("the anchor menu drifted from the reference count: %d, not %d"
                         % (anchors.shape[0], want))
    return net, size, anchors


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--full", action="store_true",
                   help="full width at --size (the card); default: the tiny configuration")
    p.add_argument("--size", type=int, default=300, choices=(300, 512))
    p.add_argument("--steps", type=int, default=None, help="default 2000 with --full, else 30")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--eval-images", type=int, default=500)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--map-floor", type=float, default=None,
                   help="exit 1 if the final mAP falls below this")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and the training stream (the held-out "
                   "stream stays fixed)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def evaluate(net, anchors, size, classes, images, device):
    """The fp32 score step over the first ``images`` images of the held-out
    host stream, each image's detections copied to the host for
    ``VOCMApMetric`` at IoU 0.5.  -> mAP."""
    score = make_score_step(net, anchors)
    metric = VOCMApMetric(iou_thresh=0.5)
    rng = np.random.RandomState(EVAL_SEED)
    for _ in range(images):
        data, gt = synthetic_voc(rng, 1, size, classes)
        metric.update(score(torch.from_numpy(data).to(device)).cpu().numpy(), gt[:, :, :5])
    return metric.get()[1]


def run(args):
    """Train, then score; prints the progress, the ``TIMES`` and the
    ``FINAL`` line.  -> {"map", "steps", "train_s", "eval_s"}."""
    dev = resolve_device(args.device)
    steps = args.steps or (2000 if args.full else 30)
    net, size, anchors = build(args.full, args.size, args.classes, args.seed, dev)
    bf16 = args.full and dev.type == "cuda"
    label = "full" if args.full else "tiny"
    print("ssd%d gate (%s): %d anchors, %d steps at batch %d, %s" % (
        size, label, anchors.shape[0], steps, args.batch,
        "bf16 train" if bf16 else "fp32 train"), flush=True)
    step, state = make_ssd_train_step(net, anchors, args.batch, learning_rate=args.lr,
                                      momentum=0.9,
                                      compute_dtype="bfloat16" if bf16 else None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def one_step(s, lr):
        data, gt = synthetic_voc_device(gen, args.batch, size, args.classes)
        return step(state, data, gt, lr)[1]

    train_s = train_loop(steps, learning_rates(steps, args.lr, warmup=True), one_step)
    del step, state
    t0 = time.perf_counter()
    value = evaluate(net, anchors, size, args.classes, args.eval_images, dev)
    eval_s = time.perf_counter() - t0
    report(dev, steps, train_s, eval_s, args.eval_images)
    print("FINAL ssd%d %s synthetic-VOC mAP = %.4f  (steps=%d, classes=%d, eval n=%d, "
          "%d anchors)" % (size, label, value, steps, args.classes, args.eval_images,
                           anchors.shape[0]), flush=True)
    return dict(map=value, steps=steps, train_s=train_s, eval_s=eval_s)


def main(argv=None):
    args = parse(argv)
    return finish(run(args), args.map_floor)


if __name__ == "__main__":
    sys.exit(main())
