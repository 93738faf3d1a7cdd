"""Faster R-CNN VGG16 train step (counterpart of
``examples/rcnn/train_fused.py``, BASELINE config 2).

One step is the training forward of ``FasterRCNN`` (VGG16 trunk, RPN,
MultiProposal, anchor and class-specific proposal targets, 7×7 ROIPooling,
fc6/fc7 with dropout), the four losses in the JAX step's order, the backward
and momentum SGD: the step of ``train_fused.py``, which the R-FCN step
shares.  PyTorch runs it eagerly; the step's random inputs (the targets'
noise and the two dropout keep masks) are arguments, drawn by the caller
(``run_bench`` draws them from a ``torch.Generator`` on the device).

    python -m mxnet_tpu_torch.train_frcnn --device cpu          # tiny config
    python -m mxnet_tpu_torch.train_frcnn --vgg16 --bench       # on the card
    python -m mxnet_tpu_torch.train_frcnn --vgg16 --bench --dtype bfloat16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .context import resolve_device
from .gluon.model_zoo.detection import FasterRCNN, faster_rcnn_vgg16
from .train_fused import detection_train_step, noise_shapes, synthetic_coco

__all__ = ["random_shapes", "draw_randoms", "make_frcnn_train_step", "build_net",
           "run_bench"]

# the tiny CPU configuration of the JAX example's build_net(vgg16=False)
TINY = dict(filters=(8, 16, 32, 32, 32), units=(1, 1, 1, 1, 1), fc_hidden=64,
            scales=(1, 2), ratios=(0.5, 1, 2), batch_rois=16, rpn_batch=32,
            max_gts=8)


def random_shapes(net, batch):
    """Shapes of the step's random inputs: the noise (nz_rpn, nz_prop) and
    the keep masks of fc6's and fc7's dropout."""
    keep = (batch * net.batch_rois, net.fc_hidden)
    return noise_shapes(net, batch) + (keep, keep)


def draw_randoms(net, batch, generator, device):
    """The step's random inputs drawn from ``generator`` (a
    ``torch.Generator`` on ``device``): uniform noise, and keep masks
    ``uniform < 1 − rate`` (the JAX op's ``bernoulli(key, 1 − rate)``)."""
    nz_rpn, nz_prop, keep6, keep7 = random_shapes(net, batch)
    nz = [torch.rand(s, generator=generator, device=device) for s in (nz_rpn, nz_prop)]
    keeps = [torch.rand(s, generator=generator, device=device) < 1.0 - d._rate
             for s, d in ((keep6, net.drop6), (keep7, net.drop7))]
    return nz + keeps


def make_frcnn_train_step(net, batch, learning_rate=1e-3, momentum=0.9,
                          compute_dtype=None):
    """-> ``step(data, im_info, gt, nz_rpn, nz_prop, keep6, keep7,
    lr=learning_rate) -> (loss, parts)``: one momentum-SGD step on a
    ``FasterRCNN``'s parameters, in place.

    The losses are the JAX step's (examples/rcnn/train_fused.py:98-124), in
    its order: RPN softmax cross-entropy over the sampled anchors, RPN
    smooth-L1 (σ 3) over ``rpn_batch · batch``, R-CNN cross-entropy over
    the sampled rois and class-specific smooth-L1 (σ 1) over their count,
    on targets normalised by the model's ``box_stds``.  ``keep6`` and
    ``keep7`` are the dropout keep masks, bool (batch · batch_rois,
    fc_hidden) (:func:`draw_randoms`).  SGD, training mode, full fp32 and
    ``compute_dtype="bfloat16"`` (fp32 masters cast to bf16 for each step,
    fp32 box math, gradients and momentum) as
    ``train_fused.make_rfcn_train_step``.  No gradient reaches conv1 and
    conv2: they stay as they are.
    """
    run = detection_train_step(net, batch, learning_rate, momentum, compute_dtype)

    def step(data, im_info, gt, nz_rpn, nz_prop, keep6, keep7, lr=learning_rate):
        return run(data, im_info, gt, (nz_rpn, nz_prop, keep6, keep7), lr)

    step.params = run.params
    step.momentum = run.momentum
    step.compute_dtype = run.compute_dtype
    return step


def build_net(vgg16, image_shape=None, classes=None, rpn_pre_nms=None,
              rpn_post_nms=None, device=None, generator=None):
    """-> (net, image_shape, classes): the full VGG16 model of the JAX
    example's ``build_net`` (max_gts 16, TRAIN proposal counts 12000/2000),
    or its tiny CPU configuration with the same graph; seeded random weights
    (``FasterRCNN.reset_parameters``).  ``rpn_pre_nms`` / ``rpn_post_nms``
    override the proposal counts: the reference's TEST counts, 6000/300,
    give the serving model."""
    if vgg16:
        shape = tuple(image_shape or (608, 1024))
        classes = classes or 20
        net = faster_rcnn_vgg16(classes=classes, image_shape=shape, max_gts=16,
                                rpn_pre_nms=rpn_pre_nms or 12000,
                                rpn_post_nms=rpn_post_nms or 2000,
                                device=device, generator=generator)
    else:
        shape = tuple(image_shape or (64, 96))
        classes = classes or 3
        net = FasterRCNN(classes=classes, image_shape=shape,
                         rpn_pre_nms=rpn_pre_nms or 200,
                         rpn_post_nms=rpn_post_nms or 32,
                         device=device, generator=generator, **TINY)
    return net, shape, classes


def run_bench(vgg16, batch=1, iters=10, image_shape=None, classes=None,
              dtype=None, lr=1e-3, windows=3, device=None, seed=0, verbose=True):
    """Timed train steps: ``windows`` windows of ``iters`` steps after one
    warm-up step, the host clock around each window ending in a device
    synchronisation.  The step's random inputs come from a
    ``torch.Generator`` on the device; ``dtype`` is the step's
    ``compute_dtype`` (None: fp32).  -> (img_per_sec, ms_per_step,
    final_loss) of the best window; prints them with the device's name and
    the dtype."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    net, shape, classes = build_net(vgg16, image_shape, classes, device=dev,
                                    generator=gen)
    rng = np.random.RandomState(seed)
    data, im_info, gt = (torch.from_numpy(a).to(dev) for a in
                         synthetic_coco(rng, batch, shape, classes, net.max_gts))
    step = make_frcnn_train_step(net, batch, learning_rate=lr, momentum=0.9,
                                 compute_dtype=dtype)
    rnd_gen = torch.Generator(device=dev).manual_seed(seed)

    def one():
        return step(data, im_info, gt, *draw_randoms(net, batch, rnd_gen, dev), lr)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    loss, _ = one()
    sync()
    first_s = time.perf_counter() - t0
    best = None
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            loss, _ = one()
        sync()
        dt = (time.perf_counter() - t0) / iters
        best = dt if best is None else min(best, dt)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if verbose:
        print("frcnn train step on %s: %s, batch %d, first step %.1f s, best "
              "of %d windows %.2f ms/step (%.2f img/s), loss %.4f"
              % (name, step.compute_dtype or torch.float32, batch, first_s,
                 windows, best * 1e3, batch / best, float(loss)), flush=True)
    return batch / best, best * 1e3, float(loss)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--vgg16", action="store_true",
                   help="full VGG16 at 608x1024 (default: the tiny config)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--bench", action="store_true")
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype of the step (default float32; "
                   "bfloat16: bf16 trunk and head, fp32 masters and box math)")
    args = p.parse_args()
    dtype = None if args.dtype in (None, "float32") else args.dtype
    if args.bench:
        run_bench(args.vgg16, batch=args.batch_size, dtype=dtype, lr=args.lr,
                  device=args.device)
        return
    dev = resolve_device(args.device)
    net, shape, classes = build_net(args.vgg16, device=dev,
                                    generator=torch.Generator().manual_seed(0))
    step = make_frcnn_train_step(net, args.batch_size, learning_rate=args.lr,
                                 compute_dtype=dtype)
    rng = np.random.RandomState(0)
    rnd_gen = torch.Generator(device=dev).manual_seed(0)
    for s in range(args.steps):
        data, im_info, gt = (torch.from_numpy(a).to(dev) for a in synthetic_coco(
            rng, args.batch_size, shape, classes, net.max_gts))
        loss, parts = step(data, im_info, gt,
                           *draw_randoms(net, args.batch_size, rnd_gen, dev))
        print("step %2d  loss=%.4f  (rpn_cls %.3f rpn_bbox %.3f rcnn_cls %.3f "
              "rcnn_bbox %.3f)" % (s, float(loss), *parts.tolist()), flush=True)


if __name__ == "__main__":
    main()
