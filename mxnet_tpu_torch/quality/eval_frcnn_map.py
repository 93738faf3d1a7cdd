"""Faster R-CNN VGG16 detection quality: mAP on synthetic VOC-format data
(counterpart of ``examples/quality/eval_frcnn_map.py``).

Trains ``train_frcnn.make_frcnn_train_step`` (in bf16 with fp32 masters on
the card at full width, fp32 elsewhere) from seeded N(0, 2/fan_in) weights
on a synthetic COCO-style stream drawn on the device
(``train_fused.synthetic_coco_device``), momentum SGD 0.9 with ×0.1 at 60%
and 85% of the steps (``--flat-lr``: none).  Then an inference twin at the
reference's TEST proposal counts (6000/300 at full width) holding the
trained weights scores the held-out host stream (``RandomState(12345)``):
the fp32 forward, the class-specific decode (:func:`decode_detections`) with
its per-class NMS on the device, and ``VOCMApMetric``.

    python -m mxnet_tpu_torch.quality.eval_frcnn_map --vgg16 --steps 3000   # card
    python -m mxnet_tpu_torch.quality.eval_frcnn_map --device cpu --steps 2 --eval-images 2
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..context import resolve_device
from ..train_frcnn import build_net, draw_randoms, make_frcnn_train_step
from ..train_fused import synthetic_coco_device
from .common import (evaluate_detector, finish, learning_rates, nms_detections, report,
                     train_loop)

__all__ = ["decode_detections", "evaluate", "parse", "run", "main"]


def decode_detections(rois, cls_prob, bbox_pred, num_classes, im_shape,
                      box_stds=(0.1, 0.1, 0.2, 0.2), score_thresh=0.05, nms_thresh=0.3,
                      max_det=100):
    """rois (R, 5) ``[b, x1, y1, x2, y2]``, cls_prob (R, C + 1) and the
    class-specific deltas bbox_pred (R, 4·(C + 1)), on the device -> numpy
    (1, K, 6) ``[cls, score, x1, y1, x2, y2]`` (the JAX script's
    ``decode_detections``).

    Class c's deltas ``bbox_pred[:, 4(c + 1):4(c + 2)]`` are multiplied by
    ``box_stds`` and applied to the roi with the +1 width convention, the
    log-sizes clipped to ±10 before ``exp``; boxes clipped to the image.
    Every (class, roi) scoring at least ``score_thresh`` is a row, class by
    class in roi order; :func:`common.nms_detections` pads or cuts them to
    512, runs per-class NMS at ``nms_thresh`` and keeps ``max_det``."""
    rois, cls_prob, bbox_pred = (t.float() for t in (rois, cls_prob, bbox_pred))
    R, C = rois.shape[0], num_classes
    boxes = rois[:, 1:5]
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * (w - 1.0)
    cy = boxes[:, 1] + 0.5 * (h - 1.0)
    stds = torch.tensor(box_stds, dtype=torch.float32, device=rois.device)
    d = (bbox_pred[:, 4:4 * (C + 1)].reshape(R, C, 4) * stds).transpose(0, 1)  # (C, R, 4)
    pcx = d[..., 0] * w + cx
    pcy = d[..., 1] * h + cy
    pw = torch.exp(torch.clamp(d[..., 2], -10, 10)) * w
    ph = torch.exp(torch.clamp(d[..., 3], -10, 10)) * h
    H, W = im_shape
    x1 = torch.clamp(pcx - 0.5 * (pw - 1.0), 0, W - 1)
    y1 = torch.clamp(pcy - 0.5 * (ph - 1.0), 0, H - 1)
    x2 = torch.clamp(pcx + 0.5 * (pw - 1.0), 0, W - 1)
    y2 = torch.clamp(pcy + 0.5 * (ph - 1.0), 0, H - 1)
    score = cls_prob[:, 1:C + 1].transpose(0, 1)
    cls = torch.arange(C, dtype=torch.float32, device=rois.device)[:, None].expand(C, R)
    rows = torch.stack([cls, score, x1, y1, x2, y2], -1)[score >= score_thresh]
    return nms_detections(rows, nms_thresh, max_det)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--vgg16", action="store_true",
                   help="full VGG16 at 608x1024 (default: the tiny configuration)")
    p.add_argument("--steps", type=int, default=None, help="default 800 with --vgg16, else 30")
    p.add_argument("--eval-images", type=int, default=500)
    p.add_argument("--classes", type=int, default=3)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--map-floor", type=float, default=None,
                   help="exit 1 if the final mAP falls below this")
    p.add_argument("--flat-lr", action="store_true", help="no step decays")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the weights and the training stream (the held-out "
                   "stream stays fixed)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def evaluate(net, images, device):
    """The eval path on ``net`` (a ``FasterRCNN``): -> (mAP, detections of
    each held-out image) (``common.evaluate_detector``)."""
    return evaluate_detector(
        net, lambda *out: decode_detections(*out, net.classes, net.image_shape,
                                            box_stds=net.box_stds),
        images, device)


def run(args):
    """Train, then score the inference twin; prints the progress, the
    ``TIMES`` and the ``FINAL`` line.  -> {"map", "steps", "train_s",
    "eval_s"}."""
    dev = resolve_device(args.device)
    steps = args.steps or (800 if args.vgg16 else 30)
    net, shape, classes = build_net(args.vgg16, classes=args.classes, device=dev,
                                    generator=torch.Generator().manual_seed(args.seed))
    bf16 = args.vgg16 and dev.type == "cuda"
    label = "vgg16" if args.vgg16 else "tiny"
    print("frcnn gate (%s): %s, %d classes, %d steps, %s" % (
        label, shape, classes, steps, "bf16 train" if bf16 else "fp32 train"), flush=True)
    step = make_frcnn_train_step(net, 1, learning_rate=args.lr, momentum=0.9,
                                 compute_dtype="bfloat16" if bf16 else None)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def one_step(s, lr):
        data, im_info, gt = synthetic_coco_device(gen, 1, shape, classes, net.max_gts)
        return step(data, im_info, gt, *draw_randoms(net, 1, gen, dev), lr)[0]

    train_s = train_loop(steps, learning_rates(steps, args.lr, flat=args.flat_lr), one_step)

    t0 = time.perf_counter()
    # the inference twin at the TEST proposal counts holds the trained weights
    eval_net, _, _ = build_net(args.vgg16, classes=classes,
                               rpn_pre_nms=6000 if args.vgg16 else None,
                               rpn_post_nms=300 if args.vgg16 else None, device=dev)
    eval_net.load_state_dict(net.state_dict())
    del net, step
    value, _ = evaluate(eval_net, args.eval_images, dev)
    eval_s = time.perf_counter() - t0
    report(dev, steps, train_s, eval_s, args.eval_images)
    print("FINAL frcnn %s synthetic-VOC mAP = %.4f  (steps=%d, classes=%d, eval n=%d)"
          % (label, value, steps, classes, args.eval_images), flush=True)
    return dict(map=value, steps=steps, train_s=train_s, eval_s=eval_s)


def main(argv=None):
    args = parse(argv)
    return finish(run(args), args.map_floor)


if __name__ == "__main__":
    sys.exit(main())
