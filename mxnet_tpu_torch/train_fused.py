"""Deformable R-FCN train step (counterpart of
``examples/deformable_rfcn/train_fused.py``).

One step is the training forward of ``DeformableRFCN`` (targets included),
the four losses in the JAX step's order, the backward through the port's
CUDA kernels, and momentum SGD with the JAX step's semantics.  PyTorch runs
it eagerly; the noise that drives the target subsampling is an input of the
step, drawn by the caller (``run_bench`` draws it from a ``torch.Generator``
on the device).

    python -m mxnet_tpu_torch.train_fused --device cpu        # tiny config
    python -m mxnet_tpu_torch.train_fused --resnet101 --bench  # on the card
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .context import full_fp32, resolve_device
from .gluon.model_zoo.detection import DeformableRFCN, rfcn_resnet101
from .ops import elemwise
from .ops import nn as ops_nn

__all__ = ["synthetic_coco", "noise_shapes", "make_rfcn_train_step",
           "build_net", "run_bench"]


def synthetic_coco(rng, batch, image_shape, classes, max_gts):
    """One synthetic COCO-scale batch, bright rectangles on noise, from a
    ``numpy.random.RandomState`` (a copy of the JAX example's generator).

    Returns numpy (data (B, 3, H, W), im_info (B, 3), gt (B, G, 5)), gt
    rows ``[cls, x1, y1, x2, y2]`` padded with −1."""
    h, w = image_shape
    data = (rng.rand(batch, 3, h, w) * 0.2).astype(np.float32)
    gt = np.full((batch, max_gts, 5), -1.0, np.float32)
    for b in range(batch):
        for j in range(rng.randint(1, min(max_gts, 8) + 1)):
            cls = rng.randint(0, classes)
            bw = rng.uniform(0.08, 0.5) * w
            bh = rng.uniform(0.08, 0.5) * h
            x1 = rng.uniform(0, w - bw)
            y1 = rng.uniform(0, h - bh)
            gt[b, j] = [cls, x1, y1, x1 + bw, y1 + bh]
            data[b, cls % 3, int(y1):int(y1 + bh), int(x1):int(x1 + bw)] += 0.8
    im_info = np.tile(np.array([h, w, 1.0], np.float32), (batch, 1))
    return data, im_info, gt


def _smooth_l1(pred, target, weight, sigma):
    return elemwise.smooth_l1((pred - target) * weight, scalar=sigma)


def noise_shapes(net, batch):
    """Shapes of the step's two noise inputs: (nz_rpn, nz_prop)."""
    Hf, Wf = net.feat_shape
    return ((batch, Hf * Wf * net.num_anchors, 2),
            (batch, net.rpn_post_nms + net.max_gts, 2))


def make_rfcn_train_step(net, batch, learning_rate=5e-4, momentum=0.9):
    """-> ``step(data, im_info, gt, nz_rpn, nz_prop, lr=learning_rate) ->
    (loss, parts)``: one momentum-SGD step on ``net``'s parameters, in place.

    The losses are the JAX step's (train_fused.py:142-165), in its order:
    RPN softmax cross-entropy over the sampled anchors, RPN smooth-L1 (σ 3)
    over ``rpn_batch · batch``, R-CNN cross-entropy and class-agnostic
    smooth-L1 (σ 1) over the sampled rois.  ``parts`` stacks the four.
    SGD: ``m = momentum·m + g; p = p − lr·m`` with m starting at 0, as the
    JAX step computes it; ``lr`` is a per-step float.  A parameter that gets
    no gradient (conv1 and res2) counts a zero gradient.  BatchNorm running
    statistics are buffers and stay as they are.  Forward and backward run in
    full fp32 (TF32 off, the caller's setting restored after).  ``step.params`` lists the
    parameters it updates and ``step.momentum`` their momentum buffers, in
    the same order.
    """
    Hf, Wf = net.feat_shape
    A = net.num_anchors
    a_total = Hf * Wf * A
    params = [p for p in net.parameters() if p.requires_grad]
    moms = [torch.zeros_like(p) for p in params]

    def losses(data, im_info, gt, nz_rpn, nz_prop):
        (rpn_cls, rpn_bbox, rpn_label, rpn_bt, rpn_bw, _rois, label,
         bbox_target, bbox_weight, cls_score, bbox_pred) = net(
            data, im_info, gt, nz_rpn, nz_prop)
        # anchor order h·(W·A) + w·A + a, as the targets and MultiProposal
        logits = rpn_cls.reshape(batch, 2, A, Hf, Wf).permute(0, 3, 4, 2, 1)
        logits = logits.reshape(batch, a_total, 2)
        valid = rpn_label >= 0
        lab = torch.clamp(rpn_label, min=0.0).to(torch.int64)
        logp = ops_nn.log_softmax(logits, axis=-1)
        ce = -torch.gather(logp, -1, lab[..., None])[..., 0]
        rpn_cls_loss = (torch.where(valid, ce, 0.0).sum()
                        / torch.clamp(valid.sum(), min=1))
        bp = rpn_bbox.reshape(batch, A, 4, Hf, Wf).permute(0, 3, 4, 1, 2)
        bp = bp.reshape(batch, a_total, 4)
        rpn_bbox_loss = _smooth_l1(bp, rpn_bt, rpn_bw, 3.0).sum() / (
            net.rpn_batch * batch)
        logp2 = ops_nn.log_softmax(cls_score, axis=-1)
        rcnn_cls_loss = -torch.gather(
            logp2, 1, label.to(torch.int64)[:, None]).mean()
        rcnn_bbox_loss = _smooth_l1(bbox_pred, bbox_target, bbox_weight,
                                    1.0).sum() / label.shape[0]
        total = rpn_cls_loss + rpn_bbox_loss + rcnn_cls_loss + rcnn_bbox_loss
        parts = torch.stack([rpn_cls_loss, rpn_bbox_loss, rcnn_cls_loss,
                             rcnn_bbox_loss])
        return total, parts

    @torch.no_grad()
    def sgd(lr):
        # multi-tensor updates: a few launches per step, not a few per tensor;
        # a parameter without a gradient keeps m = 0 and so stays as it is
        torch._foreach_mul_(moms, momentum)
        fed = [i for i, p in enumerate(params) if p.grad is not None]
        torch._foreach_add_([moms[i] for i in fed], [params[i].grad for i in fed])
        torch._foreach_sub_(params, torch._foreach_mul(moms, lr))

    def step(data, im_info, gt, nz_rpn, nz_prop, lr=learning_rate):
        if data.shape[0] != batch:
            raise ValueError("this step was made for batch %d, got %d"
                             % (batch, data.shape[0]))
        for p in params:
            p.grad = None
        # the backward in full fp32 too: cuDNN would take TF32 by default
        with full_fp32():
            loss, parts = losses(data, im_info, gt, nz_rpn, nz_prop)
            loss.backward()
        sgd(lr)
        return loss.detach(), parts.detach()

    step.params = params
    step.momentum = moms
    return step


def build_net(resnet101, image_shape=None, classes=None, device=None,
              generator=None):
    """-> (net, image_shape, classes): the full ResNet-101 model of the JAX
    example's ``build_net`` (max_gts 16), or its tiny CPU configuration with
    the same graph; seeded random weights."""
    if resnet101:
        shape = tuple(image_shape or (608, 1024))
        classes = classes or 80
        net = rfcn_resnet101(classes=classes, image_shape=shape, max_gts=16,
                             device=device, generator=generator)
    else:
        shape = tuple(image_shape or (64, 96))
        classes = classes or 3
        net = DeformableRFCN(
            classes=classes, image_shape=shape, units=(1, 1, 1, 1),
            scales=(1, 2), ratios=(0.5, 1, 2), rpn_pre_nms=200,
            rpn_post_nms=32, batch_rois=16, rpn_batch=32, max_gts=8,
            device=device, generator=generator)
    return net, shape, classes


def run_bench(resnet101, batch=1, iters=10, image_shape=None, classes=None,
              lr=5e-4, windows=3, device=None, seed=0, verbose=True):
    """Timed train steps: ``windows`` windows of ``iters`` steps after one
    warm-up step, the host clock around each window ending in a device
    synchronisation.  The step's noise comes from a ``torch.Generator`` on
    the device.  -> (img_per_sec, ms_per_step, final_loss) of the best
    window; prints them with the device's name."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    net, shape, classes = build_net(resnet101, image_shape, classes, dev, gen)
    rng = np.random.RandomState(seed)
    data, im_info, gt = (torch.from_numpy(a).to(dev) for a in
                         synthetic_coco(rng, batch, shape, classes, net.max_gts))
    step = make_rfcn_train_step(net, batch, learning_rate=lr, momentum=0.9)
    nz_gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = noise_shapes(net, batch)

    def one():
        nz = [torch.rand(s, generator=nz_gen, device=dev) for s in shapes]
        return step(data, im_info, gt, *nz, lr)

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
        print("rfcn train step on %s: batch %d, first step %.1f s, best of "
              "%d windows %.2f ms/step (%.2f img/s), loss %.4f"
              % (name, batch, first_s, windows, best * 1e3, batch / best,
                 float(loss)), flush=True)
    return batch / best, best * 1e3, float(loss)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--resnet101", action="store_true",
                   help="full ResNet-101 at 608x1024 (default: the tiny config)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--bench", action="store_true")
    args = p.parse_args()
    if args.bench:
        run_bench(args.resnet101, batch=args.batch_size, device=args.device)
        return
    dev = resolve_device(args.device)
    net, shape, classes = build_net(args.resnet101, device=dev,
                                    generator=torch.Generator().manual_seed(0))
    step = make_rfcn_train_step(net, args.batch_size)
    rng = np.random.RandomState(0)
    nz_gen = torch.Generator(device=dev).manual_seed(0)
    for s in range(args.steps):
        data, im_info, gt = (torch.from_numpy(a).to(dev) for a in synthetic_coco(
            rng, args.batch_size, shape, classes, net.max_gts))
        nz = [torch.rand(t, generator=nz_gen, device=dev)
              for t in noise_shapes(net, args.batch_size)]
        loss, parts = step(data, im_info, gt, *nz)
        print("step %2d  loss=%.4f  (rpn_cls %.3f rpn_bbox %.3f rcnn_cls %.3f "
              "rcnn_bbox %.3f)" % (s, float(loss), *parts.tolist()), flush=True)


if __name__ == "__main__":
    main()
