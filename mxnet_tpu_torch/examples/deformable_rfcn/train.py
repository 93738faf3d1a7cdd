"""Deformable R-FCN end-to-end training on synthetic shapes, through the
imperative frontend: a copy of ``examples/deformable_rfcn/train.py``
written against ``mxnet_tpu_torch`` (``mx.nd``, ``autograd.record``,
``gluon.Trainer``).

    python -m mxnet_tpu_torch.examples.deformable_rfcn.train            # 3 epochs, card
    python -m mxnet_tpu_torch.examples.deformable_rfcn.train --bench \\
        --data-shape 3 512 512                                          # ms a step
    python -m mxnet_tpu_torch.examples.deformable_rfcn.train --ctx cpu  # on the CPU

Training asserts that the last epoch's mean loss is below the first's.
``--bench`` times ``--bench-iters`` steps on one batch after one warm-up
step (its anchors subsampled from a seeded ``RandomState``) and prints
the milliseconds a step and the launches a step of each CUDA kernel of the
path (``dconv_col``, ``dconv_col_bwd``, ``nms_alive``, ``psroi_abuild``,
``psroi_abuild_bwd``; 0 on the CPU, where the plain versions run).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, nd

from .deformable_rfcn import DeformableRFCN, rfcn_losses, rpn_losses

__all__ = ["PATH_KERNELS", "synthetic_batches", "build", "make_train_step",
           "prepare_bench", "bench", "main"]

# the CUDA kernels the step reaches
PATH_KERNELS = ("dconv_col", "dconv_col_bwd", "nms_alive", "psroi_abuild", "psroi_abuild_bwd")


def synthetic_batches(batch_size, data_shape, num_batches, num_classes=2, seed=0, ctx=None):
    """Bright rectangles on dim noise; labels [cls, x1, y1, x2, y2] in
    pixels, up to 2 a picture (-1 rows pad)."""
    rng = np.random.RandomState(seed)
    c, h, w = data_shape
    for _ in range(num_batches):
        data = rng.rand(batch_size, c, h, w).astype(np.float32) * 0.2
        labels = np.full((batch_size, 2, 5), -1.0, dtype=np.float32)
        for b in range(batch_size):
            for j in range(rng.randint(1, 3)):
                cls = rng.randint(0, num_classes)
                bw = rng.uniform(0.3, 0.6) * w
                bh = rng.uniform(0.3, 0.6) * h
                x1 = rng.uniform(0, w - bw)
                y1 = rng.uniform(0, h - bh)
                labels[b, j] = [cls, x1, y1, x1 + bw, y1 + bh]
                data[b, cls % c, int(y1):int(y1 + bh), int(x1):int(x1 + bw)] += 0.8
        im_info = np.tile(np.array([h, w, 1.0], np.float32), (batch_size, 1))
        yield nd.array(data, ctx=ctx), nd.array(im_info, ctx=ctx), nd.array(labels, ctx=ctx)


def build(num_classes=2, lr=0.02, ctx=None):
    """-> (net, trainer): the example's net, initialized on ``ctx`` (its
    deferred shapes complete at the first step), and its SGD trainer."""
    net = DeformableRFCN(num_classes=num_classes)
    net.initialize(ctx=ctx)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": lr, "momentum": 0.9})
    return net, trainer


def make_train_step(net, trainer, batch_size, num_classes, anchor_rng=None):
    """One full detection train step, ``step(data, im_info, labels) ->
    (loss, [cls, bbox, rpn_cls, rpn_bbox])`` as floats (the training and
    ``--bench`` run the same step)."""

    def step(data, im_info, labels):
        with autograd.record():
            rois, cls_score, bbox_pred, rpn_cls, rpn_bbox = net(data, im_info)
            cls_loss, bbox_loss = rfcn_losses(rois, cls_score, bbox_pred, labels, num_classes)
            rpn_cls_loss, rpn_bbox_loss = rpn_losses(net, rpn_cls, rpn_bbox, labels, im_info,
                                                     anchor_rng=anchor_rng)
            loss = cls_loss + bbox_loss + rpn_cls_loss + rpn_bbox_loss
        loss.backward()
        trainer.step(batch_size)
        parts = [float(p.asnumpy()) for p in (cls_loss, bbox_loss, rpn_cls_loss, rpn_bbox_loss)]
        return float(loss.asnumpy()), parts

    return step


def _launches():
    from mxnet_tpu_torch.ops import kernels

    return {n: kernels.KERNELS[n].wrapper.launches for n in PATH_KERNELS}


def prepare_bench(args, ctx):
    """-> (step, batch): the example's net and train step at
    ``--data-shape`` after one warm-up step (deferred shapes, kernel
    builds).  The anchors are subsampled from a seeded ``RandomState``, so
    that two runs time the same steps."""
    net, trainer = build(args.num_classes, args.lr, ctx)
    step = make_train_step(net, trainer, args.batch_size, args.num_classes,
                           anchor_rng=np.random.RandomState(0))
    batch = next(iter(synthetic_batches(
        args.batch_size, tuple(args.data_shape), 1, args.num_classes, ctx=ctx)))
    step(*batch)
    return step, batch


def bench(args, ctx, prepared=None):
    """ms a step and launches a step of each kernel over ``--bench-iters``
    steps on one batch, after ``prepare_bench`` (or the ``(step, batch)``
    it returned)."""
    from mxnet_tpu_torch.ops import kernels

    step, batch = prepared or prepare_bench(args, ctx)
    iters = max(1, args.bench_iters)
    kernels.reset_launches()
    nd.waitall()
    tic = time.perf_counter()
    losses = [step(*batch)[0] for _ in range(iters)]
    nd.waitall()
    ms = (time.perf_counter() - tic) / iters * 1e3
    per_step = {n: c / iters for n, c in _launches().items()}
    print("rfcn_bench: shape=%s batch=%d  %.2f img/s (%.2f ms/step)"
          % (tuple(args.data_shape), args.batch_size, args.batch_size / ms * 1e3, ms))
    print("rfcn_bench_json: " + json.dumps(
        {"shape": list(args.data_shape), "batch": args.batch_size, "iters": iters,
         "ms_per_step": ms, "launches_per_step": per_step, "losses": losses}))
    return ms, per_step, losses


def train(args, ctx):
    """The example's training: epochs of synthetic batches; returns the
    first and last epochs' mean losses."""
    net, trainer = build(args.num_classes, args.lr, ctx)
    step = make_train_step(net, trainer, args.batch_size, args.num_classes)
    first_loss = last_loss = None
    for epoch in range(args.epochs):
        tic = time.time()
        total = 0.0
        n = 0
        for data, im_info, labels in synthetic_batches(
                args.batch_size, tuple(args.data_shape), args.batches_per_epoch,
                args.num_classes, seed=epoch, ctx=ctx):
            total += step(data, im_info, labels)[0]
            n += 1
        avg = total / n
        if first_loss is None:
            first_loss = avg
        last_loss = avg
        print("Epoch[%d] loss=%.4f time=%.1fs" % (epoch, avg, time.time() - tic))
    print("first=%.4f last=%.4f" % (first_loss, last_loss))
    assert last_loss < first_loss, "loss did not decrease"
    print("DEFORMABLE-RFCN TRAIN OK")
    return first_loss, last_loss


def parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--data-shape", type=int, nargs=3, default=[3, 64, 64])
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batches-per-epoch", type=int, default=6)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--bench", action="store_true",
                   help="time the train step at --data-shape")
    p.add_argument("--bench-iters", type=int, default=10)
    p.add_argument("--ctx", choices=("gpu", "cpu"), default="gpu")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    ctx.device  # raises here without a card, unless --ctx cpu
    with ctx, mx.full_fp32() if args.ctx == "gpu" else contextlib.nullcontext():
        return bench(args, ctx) if args.bench else train(args, ctx)


if __name__ == "__main__":
    main()
