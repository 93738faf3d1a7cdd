"""Deformable R-FCN detection quality: mAP on synthetic VOC-format data
(counterpart of ``examples/quality/eval_rfcn_map.py``).

Trains ``train_fused.make_rfcn_train_step`` (in bf16 with fp32 masters on
the card at full width, fp32 elsewhere) from seeded random weights on a
synthetic COCO-style stream drawn on the device
(``train_fused.synthetic_coco_device``), momentum SGD 0.9 with ×0.1 at 60%
and 85% of the steps (``--flat-lr``: none); ``--live-bn`` trains the trunk's
BatchNorms on batch statistics (from-scratch runs: the frozen recipe
assumes pretrained weights).  Then the fp32 inference forward with the
moving statistics scores the held-out host stream (``RandomState(12345)``):
the class-agnostic decode (:func:`decode_detections`) with its per-class
NMS on the device, and ``VOCMApMetric``.

    python -m mxnet_tpu_torch.quality.eval_rfcn_map --resnet101 --steps 3000 --live-bn
    python -m mxnet_tpu_torch.quality.eval_rfcn_map --device cpu --steps 2 --eval-images 2
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..context import resolve_device
from ..train_fused import build_net, make_rfcn_train_step, noise_shapes, synthetic_coco_device
from .common import (evaluate_detector, finish, learning_rates, nms_detections, report,
                     train_loop)

__all__ = ["decode_detections", "evaluate", "parse", "run", "main"]


def decode_detections(rois, cls_prob, bbox_pred, num_classes, im_shape,
                      score_thresh=0.05, nms_thresh=0.3, max_det=100):
    """rois (R, 5) ``[b, x1, y1, x2, y2]``, cls_prob (R, C + 1) and the
    class-agnostic deltas bbox_pred (R, 8), on the device -> numpy (1, K, 6)
    ``[cls, score, x1, y1, x2, y2]`` (the JAX script's
    ``decode_detections``).

    The foreground deltas ``bbox_pred[:, 4:8]`` invert the training targets'
    transform (+1 width convention, no normalisation, no clip before
    ``exp``); boxes clipped to the image.  Every (class, roi) scoring at
    least ``score_thresh`` is a row, class by class in roi order;
    :func:`common.nms_detections` pads or cuts them to 512, runs per-class
    NMS at ``nms_thresh`` and keeps ``max_det``."""
    rois, cls_prob, bbox_pred = (t.float() for t in (rois, cls_prob, bbox_pred))
    R, C = rois.shape[0], num_classes
    boxes = rois[:, 1:5]
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * (w - 1.0)
    cy = boxes[:, 1] + 0.5 * (h - 1.0)
    d = bbox_pred[:, 4:8]
    pcx = d[:, 0] * w + cx
    pcy = d[:, 1] * h + cy
    pw = torch.exp(d[:, 2]) * w
    ph = torch.exp(d[:, 3]) * h
    H, W = im_shape
    box = torch.stack([torch.clamp(pcx - 0.5 * (pw - 1.0), 0, W - 1),
                       torch.clamp(pcy - 0.5 * (ph - 1.0), 0, H - 1),
                       torch.clamp(pcx + 0.5 * (pw - 1.0), 0, W - 1),
                       torch.clamp(pcy + 0.5 * (ph - 1.0), 0, H - 1)], -1)
    score = cls_prob[:, 1:C + 1].transpose(0, 1)  # (C, R)
    cls = torch.arange(C, dtype=torch.float32, device=rois.device)[:, None].expand(C, R)
    rows = torch.cat([cls[..., None], score[..., None], box.expand(C, R, 4)], -1)
    return nms_detections(rows[score >= score_thresh], nms_thresh, max_det)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--resnet101", action="store_true",
                   help="full ResNet-101 at 608x1024 (default: the tiny configuration)")
    p.add_argument("--steps", type=int, default=None,
                   help="default 800 with --resnet101, else 30")
    p.add_argument("--eval-images", type=int, default=500)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--map-floor", type=float, default=None,
                   help="exit 1 if the final mAP falls below this")
    p.add_argument("--live-bn", action="store_true",
                   help="train the BatchNorm statistics (from-scratch runs)")
    p.add_argument("--flat-lr", action="store_true", help="no step decays")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and the training stream (the held-out "
                   "stream stays fixed)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def evaluate(net, images, device):
    """The eval path on ``net`` (a ``DeformableRFCN`` in eval mode: the
    moving statistics): -> (mAP, detections of each held-out image)
    (``common.evaluate_detector``)."""
    return evaluate_detector(
        net, lambda *out: decode_detections(*out, net.classes, net.image_shape),
        images, device)


def run(args):
    """Train, then score the net; prints the progress, the ``TIMES`` and the
    ``FINAL`` line.  -> {"map", "steps", "train_s", "eval_s"}."""
    dev = resolve_device(args.device)
    steps = args.steps or (800 if args.resnet101 else 30)
    net, shape, classes = build_net(args.resnet101, classes=args.classes, device=dev,
                                    generator=torch.Generator().manual_seed(args.seed),
                                    frozen_bn=not args.live_bn)
    bf16 = args.resnet101 and dev.type == "cuda"
    label = "resnet101" if args.resnet101 else "tiny"
    print("rfcn gate (%s): %s, %d classes, %d steps, %s BatchNorm, %s" % (
        label, shape, classes, steps, "live" if args.live_bn else "frozen",
        "bf16 train" if bf16 else "fp32 train"), flush=True)
    step = make_rfcn_train_step(net, 1, learning_rate=args.lr, momentum=0.9,
                                compute_dtype="bfloat16" if bf16 else None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def one_step(s, lr):
        data, im_info, gt = synthetic_coco_device(gen, 1, shape, classes, net.max_gts)
        noise = [torch.rand(t, generator=gen, device=dev) for t in noise_shapes(net, 1)]
        return step(data, im_info, gt, *noise, lr)[0]

    train_s = train_loop(steps, learning_rates(steps, args.lr, flat=args.flat_lr), one_step)

    t0 = time.perf_counter()
    del step
    net.eval()  # the step leaves it so; the moving statistics
    value, _ = evaluate(net, args.eval_images, dev)
    eval_s = time.perf_counter() - t0
    report(dev, steps, train_s, eval_s, args.eval_images)
    print("FINAL rfcn %s synthetic-VOC mAP = %.4f  (steps=%d, classes=%d, eval n=%d)"
          % (label, value, steps, classes, args.eval_images), flush=True)
    return dict(map=value, steps=steps, train_s=train_s, eval_s=eval_s)


def main(argv=None):
    args = parse(argv)
    return finish(run(args), args.map_floor)


if __name__ == "__main__":
    sys.exit(main())
