#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit, TF32 off for matmuls and cuDNN;
2. build: the CUDA kernels of ``mxnet_tpu_torch/ops/csrc`` with nvcc;
3. serve: Deformable R-FCN ResNet-101 (80 classes, 608x1024, pre/post NMS
   6000/300) with seeded random weights answers four single-image requests
   and one batch of two; every answer is checked (shapes, finite values,
   probabilities, roi corners) and so are the kernels' launch counts;
4. train: the same model (max_gts 16, batch_rois 128, rpn_batch 256, fp32,
   momentum SGD 0.9 at lr 5e-4) takes 2 warm-up steps, 5 timed steps at
   batch 1 and one step at batch 2 on synthetic COCO batches; each step's
   loss parts must be finite and each kernel's launch count per step as
   expected; conv1/res2 must not move, res3+ must, and the offset convs and
   rfcn_trans must get a non-zero gradient; the second warm-up step records
   the backward kernels' inputs;
5. kernels: the inputs each forward kernel got during one inference forward,
   and each backward kernel (and NMS) during that train step, are captured;
   NMS prints its words and survivors per call; each kernel
   is held against its plain PyTorch version on them and timed beside it
   (and beside one library call where there is one; the dconv forward also
   beside the copy that would bring its column to the weight product's
   layout, 0 when it is stored so);
6. int8: int8 post-training quantization of ResNet-50 v2 (3x224x224, 1,000
   classes, seeded He-scaled weights, BN moving mean 0 and variance 1):
   naive calibration over 4 batches of 8, ``quantize_model`` with fc1 left
   in fp32, then the int8 symbol bound and run at batch 1 and 32 beside the
   fp32 symbol; outputs, launches per forward (one ``quantize_int8`` per int8
   quantize node, one ``dequantize_int8`` per dequantize node of int8 input),
   no host synchronisation inside the int8 forward, latencies and the top-1
   agreement with fp32; the calls of one batch-32 forward, and an odd-sized
   tensor with +-0, NaN and a zero range, hold the int8 pair bit for bit
   against the plain versions;
7. resnet: the Gluon ResNet-50 v1 train step of bench.py's second headline
   (``MXNET_BENCH=resnet50``: ``resnet50_v1(classes=1000)``, 224x224,
   ``make_train_step`` with softmax cross-entropy, SGD lr 0.05 momentum
   0.9), seeded U(-0.07, 0.07) weights, N(0, 1) images and float labels
   < 1000 at batch 32: one warm-up and 5 timed steps in fp32 (TF32 off) and
   in bf16 (``compute_dtype="bfloat16"``), each with its step ms, img/s,
   peak memory and one profiled step (kernels, device busy, idle share,
   largest groups); every loss finite, every running statistic moved, the
   bf16 masters fp32, no ported kernel launched; then the first step at
   batch 2 on the card against the CPU from the same weights (loss, two
   weights' updates, a running variance);
8. frcnn: the Faster R-CNN VGG16 path of bench.py's third headline
   (``MXNET_BENCH=frcnn``; the JAX example's ``build_net(vgg16=True)``: 20
   classes, 608x1024, seeded N(0, 2/fan_in) weights): serve with the
   reference's TEST proposal counts 6000/300, four single-image requests
   and one batch of two, each answer checked (shapes (B*300, 5), (B*300,
   21), (B*300, 84), finite values, probabilities, roi corners) and one NMS
   launch a request; then the train step (TRAIN counts 12000/2000,
   batch_rois 128, rpn_batch 256, max_gts 16, momentum SGD 0.9 at lr 1e-3)
   on the serve model's weights: 2 warm-up steps (the second records NMS's
   N = 12,000 call and ROIPooling's inputs), 5 timed steps at batch 1 and
   one at batch 2 in fp32, then 2 warm-up and 3 timed steps in bf16
   (``compute_dtype="bfloat16"``, fp32 masters); every step's loss parts
   finite and one NMS launch a step, conv1/conv2 bit-identical, every other
   tensor moved.  One serve forward and one step of each dtype run under
   ``torch.cuda.set_sync_debug_mode("error")``: no host synchronisation.
   Each path prints its ms, img/s, peak memory, device profile (kernels,
   busy, idle share, groups) and ROIPooling's device ms and peak bytes on
   its own inputs; the kernels phase holds NMS bit for bit against its
   plain version at N = 12,000 and times it.  Then the serve model is cast
   to bf16 (``cast("bfloat16")``) and serves
   three single-image requests and one batch of two, each answer checked
   (rois fp32, cls_prob and bbox_pred bf16) with one NMS launch a request,
   with its ms, device profile and ROIPooling cost;
8b. module: bench.py's ``MXNET_BENCH=module`` (the MLP 128-256-256-10 with
   SoftmaxOutput through ``Module``, batch 64, sgd lr 0.05 momentum 0.9:
   one warm-up and 50 timed ``forward_backward`` + ``update``; samples/s,
   ms a step, one profiled step, the cross-entropy of the warm-up and the
   last step on the fixed batch, which must fall), then train_cifar10.py's
   defaults through ``Module.fit`` (ResNet-110 on 3x28x28, batch 128, sgd
   lr 0.05 momentum 0.9 wd 1e-4, Xavier(gaussian, in, 2), a
   MultiFactorScheduler, "acc" and a Speedometer; seeded N(0, 1) images,
   one epoch of 8 batches, then ``score`` on 2): every loss finite, every
   moving statistic and weight moved, the fix_gamma gamma moved by weight
   decay alone with a zero gradient; ms a step, img/s, peak memory and one
   profiled step.  One step of each path runs under
   ``set_sync_debug_mode("error")``, and neither launches a ported kernel;
8c. ssd: the SSD path of BASELINE config 5 (``examples/ssd/train_fused.py``,
   VGG16-reduced, 20 classes, seeded Xavier weights, synthetic VOC images).
   ``ssd_serve``: the score step (forward, fp32 softmax, MultiBoxDetection
   at NMS 0.45, top 400) of SSD300 (8,732 anchors) in fp32 and, after
   ``cast("bfloat16")``, in bf16, each with three single-image requests and
   three batches of 16, and of SSD512 (24,564 anchors) in fp32 at batch 16;
   every answer checked (shape, finite, valid rows a sorted prefix of at
   most 400, class range, boxes in [0, 1]) with one NMS launch a call and
   no other kernel, the first batch of 16 under
   ``set_sync_debug_mode("error")``; ms, img/s, peak memory, kernels a call,
   busy and idle share.  ``ssd_train``: the train step (MultiBoxTarget with
   3:1 mining, the two losses, momentum SGD 0.9 at lr 1e-3) of SSD300 at
   batch 8 in fp32 and bf16 (``compute_dtype``) and of SSD512 at batch 4 in
   fp32: a warm-up step, one under the sync check and three timed steps,
   finite loss parts, no ported kernel launched, fp32 masters; ms, img/s,
   peak memory, profile.  The kernels phase holds one batch-16 NMS call of
   each score path, and the batch-1 requests' calls, bit for bit against
   the plain version and times it at
   N 8,732 (the staged scan) and N 24,564 (``nms_scan_kernel_global``),
   checking which scan ran;
9. small input: the tiny configuration on the card against the same model on
   the CPU (the plain versions), stage by stage, then one train step on each
   with the same weights and the same noise, with frozen BatchNorm and with
   batch statistics (``frozen_bn=False``); one step of the narrow ResNet V1
   in fp32 and bf16; the R-FCN stages in bf16; the CIFAR ResNet-8 int8
   symbol with the same weights and calibration table on both devices; and
   the tiny Faster R-CNN stage by stage, end to end and over one train step
   with the same weights, noise and dropout masks; one Module step of the
   CIFAR ResNet-8 from the same weights (loss, two weights' updates, a
   moving variance); the tiny SSD (128², 1,528 anchors) stage by stage
   (forward, MultiBoxDetection on the CPU's probabilities), its score step,
   and one train step's loss parts and weights.

Each phase prints its seconds, and the run its total, before the last two
lines.

Between 4 and 5 the bf16 R-FCN path runs at the same full width: serve (the model
with its own seeded weights, ``cast("bfloat16")``, three single-image
requests and one batch of two; rois fp32, cls_prob and bbox_pred bf16) and
train (``compute_dtype="bfloat16"`` on the fp32 model of phase 4: fp32
masters, momentum and BatchNorm statistics; 2 warm-up steps, the second
recording the backward kernels' inputs, and 3 timed steps at batch 1), each
with its launch counts checked per request or step; phase 5 then holds the
four bf16 kernel instances against their plain versions on the bf16 path's
calls, each bf16 output within one bf16 ulp.  Phase 5 runs after phase 8b.

The second-to-last line is the kernels JSON object, the last line
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
import json
import logging
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
SPIN_CYCLES = 40_000_000    # ~20 ms at the H100's ~1.98 GHz: covers the
                            # host's queueing of a timed run of calls
# the JAX example's build_net(resnet101=True); the other training
# arguments keep the model's defaults
FULL = dict(classes=80, image_shape=(608, 1024), max_gts=16)
TINY = dict(classes=3, image_shape=(64, 96), units=(1, 1, 1, 1), scales=(1, 2),
            rpn_pre_nms=200, rpn_post_nms=32, batch_rois=16, rpn_batch=32,
            max_gts=8)
LR = 5e-4
# upstream's imagenet_gen_qsym.py model: get_symbol(num_classes=1000,
# num_layers=50, image_shape="3,224,224"), fc1 excluded from quantization
INT8 = dict(num_classes=1000, num_layers=50, image_shape="3,224,224")
INT8_CALIB = (4, 8)          # batches x images of naive calibration
INT8_BATCHES = (1, 32)
INT8_PAIR = ("quantize_int8", "dequantize_int8")
# bench.py MXNET_BENCH=resnet50: resnet50_v1(classes=1000) at 224x224,
# make_train_step(SoftmaxCrossEntropyLoss(), learning_rate=0.05,
# momentum=0.9), images N(0, 1) and labels < 1000 stored as float; batch 32
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES = 32, 224, 1000
RESNET_LR, RESNET_MOMENTUM = 0.05, 0.9
RESNET_TIMED = 5
# running statistics the small train phases compare (a res2 and a res5
# BatchNorm); the batch-statistics phase's seed and RPN score weights' gain:
# at these its CPU run's 201 best proposal scores of each image lie at least
# 7.4e-5 apart (a gain of 4 saturates scores behind batch statistics)
SMALL_TRAIN_BN_STATS = ("res2_unit1_batchnorm2_running_var",
                        "res5_unit1_batchnorm1_running_var")
SMALL_TRAIN_BN_SEED, SMALL_TRAIN_BN_RPN_GAIN = SEED + 17, 2.0
# the narrow ResNet of tests/test_torch_resnet.py
NARROW = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128], classes=10)
# bench.py MXNET_BENCH=frcnn: the JAX example's build_net(vgg16=True)
# (faster_rcnn_vgg16, 20 VOC classes, 608x1024, max_gts 16, TRAIN proposal
# counts 12000/2000, batch_rois 128, rpn_batch 256), momentum SGD 0.9 at lr
# 1e-3; served with the reference's TEST counts 6000/300 (demo.py:74-75)
FRCNN_SERVE_NMS = (6000, 300)
FRCNN_LR = 1e-3
FRCNN_TIMED, FRCNN_TIMED_BF16 = 5, 3
# the tiny Faster R-CNN's tie-free seed and RPN score weights' gain
SMALL_FRCNN_SEED, SMALL_FRCNN_RPN_GAIN = 42, 2.0
FRCNN_SERVE_BF16_REQUESTS = 3
# bench.py MXNET_BENCH=module (main_module): the MLP fc1 128->256, relu, fc2
# 256->256, relu, fc3 256->10, SoftmaxOutput through Module, batch 64, sgd
# lr 0.05 momentum 0.9 (rescale_grad 1/64 by default), Module's default
# Uniform(0.01) weights, N(0, 1) data and labels < 10 from RandomState(0);
# one warm-up step, then 50 timed forward_backward + update
MODULE_BATCH, MODULE_ITERS = 64, 50
# train_cifar10.py's defaults (common/fit.py): resnet, 110 layers, 3x28x28,
# 10 classes, batch 128, sgd lr 0.05 momentum 0.9 wd 1e-4,
# Xavier(gaussian, in, 2), lr x0.1 at lr_step_epochs 200 and 250 of
# 50,000 / 128 = 390 updates an epoch, eval_metric "acc", a Speedometer.
# The CIFAR-10 .rec files are not in the repository: seeded N(0, 1) images
# and labels < 10, one epoch of 8 batches, then score on 2
CIFAR = dict(num_classes=10, num_layers=110, image_shape="3,28,28")
CIFAR_BATCH, CIFAR_BATCHES, CIFAR_SCORE_BATCHES = 128, 8, 2
CIFAR_SGD = dict(learning_rate=0.05, momentum=0.9, wd=1e-4)
CIFAR_EPOCH_UPDATES, CIFAR_LR_STEP_EPOCHS, CIFAR_LR_FACTOR = 50000 // 128, (200, 250), 0.1
# BASELINE config 5 (examples/ssd/train_fused.py run_bench): the VGG16-reduced
# SSD, 20 VOC classes, seeded Xavier weights; the train step at batch 8
# (SSD300, 8,732 anchors) and 4 (SSD512, 24,564), momentum SGD 0.9 at lr
# 1e-3; the score step (forward, softmax, MultiBoxDetection at NMS 0.45, top
# 400) at batch 16, and SSD300 also at batch 1 (the reference's 95 / 64 FPS
# bars at 300², example/ssd/README.md:44-50)
SSD_CLASSES, SSD_LR = 20, 1e-3
SSD_TRAIN_BATCH = {300: 8, 512: 4}
SSD_SERVE_BATCH, SSD_REQUESTS, SSD_TIMED = 16, 3, 3
SSD_TOPK = 400


def fail(msg):
    print("chip_smoke: FAIL: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail("nvidia-smi: %s" % smi.stderr.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device: %s (torch %s, CUDA %s, %d card(s))" % (
        name, torch.__version__, torch.version.cuda, torch.cuda.device_count()))
    say(smi.stdout.strip().splitlines()[0])
    say("tf32: torch.backends.cuda.matmul.allow_tf32=%s "
        "torch.backends.cudnn.allow_tf32=%s" % (
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32))
    return name


def phase_build():
    from mxnet_tpu_torch.ops import _build

    _build.library()
    info = _build.build_info()
    say("build: %.1f s -> %s" % (info["seconds"], info["path"]))
    for line in info["ptxas"].splitlines():
        if "Compiling entry" in line or "Used" in line:
            say("  " + line.strip())


def randomize_deformable(net, gen):
    """Small non-zero weights for the zero-initialised offset convs and
    rfcn_trans, so that sampling leaves the integer grid."""
    from mxnet_tpu_torch.gluon.model_zoo import DeformableConv2D

    convs = [m.offset for m in net.modules() if isinstance(m, DeformableConv2D)]
    with torch.no_grad():
        for conv, gain in [(c, 0.5) for c in convs] + [(net.rfcn_trans, 1.0)]:
            w = conv.weight
            w.copy_(torch.randn(w.shape, generator=gen) * gain / math.sqrt(w[0].numel()))


def make_request(gen, infos, shape, dev):
    data = torch.randn((len(infos), 3) + shape, generator=gen).to(dev)
    return data, torch.tensor(infos, dtype=torch.float32).to(dev)


def check_answer(net, out, im_info, dtype=torch.float32, box_cols=8):
    """Shapes, dtypes (rois fp32; cls_prob and bbox_pred in the model's
    ``dtype``), finite values, probabilities and roi corners; bbox_pred has
    ``box_cols`` columns (8 for R-FCN's two-class boxes, 4·(classes + 1)
    for Faster R-CNN's).  A bf16 probability row sums to 1 within 2^-7."""
    rois, prob, bbox = out
    B = im_info.shape[0]
    R = B * net.rpn_post_nms
    for t, shape, name, dt in ((rois, (R, 5), "rois", torch.float32),
                               (prob, (R, net.classes + 1), "cls_prob", dtype),
                               (bbox, (R, box_cols), "bbox_pred", dtype)):
        if tuple(t.shape) != shape or t.dtype != dt:
            fail("%s is %s %s, expected %s %s" % (name, t.dtype, tuple(t.shape), dt, shape))
        if not bool(torch.isfinite(t).all()):
            fail("%s has non-finite values" % name)
    # the bf16 softmax rounds as the JAX op does: its fp32 sum rounded to
    # bf16 (at most 2^-8 relative) and each quotient rounded (at most 2^-8
    # of p): the row sums to 1 within 2^-7
    err = float((prob.float().sum(-1) - 1).abs().max())
    if err > (1e-5 if dtype == torch.float32 else 2.0 ** -7):
        fail("cls_prob rows sum to 1 only within %g" % err)
    info = im_info.repeat_interleave(net.rpn_post_nms, 0)
    if not torch.equal(rois[:, 0], torch.arange(B, device=rois.device)
                       .repeat_interleave(net.rpn_post_nms).float()):
        fail("rois' batch column is not batch-major")
    # MultiProposal clips to the image, then widens boxes under the minimum
    # size by half of it on each side (multi_proposal.cc FilterBox)
    slack = net.rpn_min_size * info[:, 2] / 2 + 1e-3
    x1, y1, x2, y2 = rois[:, 1], rois[:, 2], rois[:, 3], rois[:, 4]
    inside = ((x1 >= -slack) & (y1 >= -slack) & (x1 <= x2) & (y1 <= y2)
              & (x2 <= info[:, 1] - 1 + slack) & (y2 <= info[:, 0] - 1 + slack))
    if not bool(inside.all()):
        fail("%d rois have corners outside the image" % int((~inside).sum()))


def per_forward(net, bf16=False):
    """Launches of each kernel in one inference forward: one dconv per
    deformable conv (the three res5 units), one NMS over the batch, one
    A-build per pooling, and no backward kernel; in bf16 the dconv and
    A-build launches are their bf16 instances'."""
    from mxnet_tpu_torch.gluon.model_zoo import DeformableConv2D
    from mxnet_tpu_torch.ops import kernels

    n_dconv = sum(isinstance(m, DeformableConv2D) for m in net.modules())
    tag = "[bf16]" if bf16 else ""
    want = {"nms_alive": 1, "dconv_col" + tag: n_dconv, "psroi_abuild" + tag: 3}
    return {n: want.get(n, 0) for n in kernels.KERNELS}


def per_train_step(net, bf16=False):
    """Launches of each kernel in one train step: the forward's, one dconv
    backward per deformable conv, and one A-build backward for each of the
    two poolings whose offsets carry a gradient (the offset pooling itself
    samples at fixed points: its yv/xv carry none)."""
    tag = "[bf16]" if bf16 else ""
    fwd = per_forward(net, bf16)
    return dict(fwd, **{"dconv_col_bwd" + tag: fwd["dconv_col" + tag],
                        "psroi_abuild_bwd" + tag: 2})


def counts(kernels):
    return {n: k.wrapper.launches for n, k in kernels.KERNELS.items()}


def phase_serve(kernels, dev):
    from mxnet_tpu_torch.gluon.model_zoo import rfcn_resnet101

    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    net = rfcn_resnet101(device="cuda", generator=gen, **FULL)
    randomize_deformable(net, gen)
    torch.cuda.synchronize()
    say("serve: R-101 Deformable R-FCN, %d classes, %s, %.1f M parameters, "
        "built in %.1f s" % (net.classes, net.image_shape,
                             sum(p.numel() for p in net.parameters()) / 1e6,
                             time.perf_counter() - t0))
    expect = per_forward(net)
    H, W = net.image_shape
    requests = [[[H, W, 1.0]]] * 4 + [[[H, W, 1.0], [H - 32, W - 64, 1.0]]]
    for infos in (requests[0], requests[-1]):  # cuDNN and allocator set-up
        net(*make_request(gen, infos, (H, W), dev))
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i, infos in enumerate(requests):
        data, im_info = make_request(gen, infos, (H, W), dev)
        before = counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(data, im_info)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_answer(net, out, im_info)
        for name, k in kernels.KERNELS.items():
            got = k.wrapper.launches - before[name]
            if got != expect[name]:
                fail("%s launched %d times in one forward, expected %d"
                     % (name, got, expect[name]))
        say("request %d: batch %d, %.2f ms, %d rois, mean top score %.4f" % (
            i + 1, len(infos), ms, out[0].shape[0],
            float(out[1][:, 1:].max(1).values.mean())))
    launches = counts(kernels)
    for name, n in launches.items():
        if n == 0 and expect[name]:
            fail("%s was never launched on the serve path" % name)
    say("serve launches: %s" % json.dumps(launches))
    return net, gen, launches


def train_inputs(net, rng, batch, dev):
    from mxnet_tpu_torch import train_fused

    return tuple(torch.from_numpy(a).to(dev) for a in train_fused.synthetic_coco(
        rng, batch, net.image_shape, net.classes, net.max_gts))


def train_noise(net, batch, gen, dev):
    from mxnet_tpu_torch import train_fused

    return [torch.rand(s, generator=gen, device=dev)
            for s in train_fused.noise_shapes(net, batch)]


def checked_step(kernels, step, inputs, noise, expect, what, lr=LR):
    """One train step on ``inputs`` and the noise ``noise()`` draws: its
    host-clock ms (ended by a synchronize), loss and parts; fails unless the
    loss is fp32, the parts finite and the kernels' launches ``expect``."""
    before = counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, parts = step(*inputs, *noise(), lr)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    parts = parts.tolist()
    if loss.dtype != torch.float32 or not all(math.isfinite(v) for v in parts):
        fail("%s: loss %s, parts not finite fp32: %s" % (what, loss.dtype, parts))
    got = {n: c - before[n] for n, c in counts(kernels).items()}
    if got != expect:
        fail("%s: kernel launches %s, expected %s" % (what, got, expect))
    return ms, float(loss), parts


def phase_train(kernels, net, dev, card):
    """The main path's train step at full width: see the module docstring."""
    from mxnet_tpu_torch import train_fused
    from mxnet_tpu_torch.gluon.model_zoo import DeformableConv2D

    rng = np.random.RandomState(SEED)
    nz_gen = torch.Generator(device=dev).manual_seed(SEED)
    named = net.gluon_named_tensors()
    fixed = {n: t.detach().clone() for n, t in named.items()
             if n.startswith(("conv1_", "res2_"))}
    trunk = {n: t.detach().clone() for n, t in named.items()
             if n.startswith(("res3_", "res4_", "res5_")) and "conv2d" in n
             and n.endswith("_weight")}
    probes = [m.offset.weight for m in net.modules() if isinstance(m, DeformableConv2D)]
    probes.append(net.rfcn_trans.weight)
    expect = per_train_step(net)

    def one_step(step, inputs, batch, what):
        return checked_step(kernels, step, inputs,
                            lambda: train_noise(net, batch, nz_gen, dev), expect, what)

    step1 = train_fused.make_rfcn_train_step(net, 1, learning_rate=LR, momentum=0.9)
    inputs1 = train_inputs(net, rng, 1, dev)
    # the second warm-up step also records the backward kernels' inputs,
    # which the kernels phase holds against the plain versions
    bwd_names = [n for n in kernels.KERNELS if n.endswith("_bwd")]
    for i in range(2):  # (and the step's NMS call, compared beside the serve one)
        out = []
        run = lambda: out.append(one_step(step1, inputs1, 1, "warm-up step %d" % (i + 1)))
        if i == 1:
            captured = capture_calls(kernels, bwd_names + ["nms_alive"], run)
            train_nms = captured.pop("nms_alive")
        else:
            run()
        ms, loss, parts = out[0]
        say("train warm-up step %d: %.2f ms, loss %.4f" % (i + 1, ms, loss))
    kernels.reset_launches()
    times = []
    for i in range(5):
        ms, loss, parts = one_step(step1, inputs1, 1, "step %d" % (i + 1))
        times.append(ms)
        say("train step %d: batch 1, %.2f ms, loss %.4f (rpn_cls %.4f rpn_bbox "
            "%.4f rcnn_cls %.4f rcnn_bbox %.4f)" % (i + 1, ms, loss, *parts))
    step2 = train_fused.make_rfcn_train_step(net, 2, learning_rate=LR, momentum=0.9)
    ms2, loss, parts = one_step(step2, train_inputs(net, rng, 2, dev), 2, "batch-2 step")
    say("train step: batch 2 (first at this batch size), %.2f ms, loss %.4f"
        % (ms2, loss))
    launches = counts(kernels)
    for n, t in fixed.items():
        if not torch.equal(named[n], t):
            fail("train: %s moved; conv1/res2 must get no gradient" % n)
    still = [n for n, t in trunk.items() if torch.equal(named[n], t)]
    if still:
        fail("train: %d res3+ conv weights did not move: %s" % (len(still), still[:3]))
    for p in probes:
        if p.grad is None or not float(p.grad.abs().max()) > 0:
            fail("train: an offset conv or rfcn_trans got no gradient")
    say("train: R-101 on %s, batch 1 median %.2f ms/step (%s), batch 2 %.2f ms; "
        "conv1/res2 fixed (%d tensors), %d res3+ conv weights moved, offset-conv "
        "and rfcn_trans gradients non-zero (max |g| %s)" % (
            card, statistics.median(times), ", ".join("%.2f" % t for t in times),
            ms2, len(fixed), len(trunk),
            ", ".join("%.3g" % float(p.grad.abs().max()) for p in probes)))
    say("train launches (6 steps): %s" % json.dumps(launches))
    return launches, captured, train_nms


def time_ms(fn, reps):
    """Device time (ms) of one ``fn()``: CUDA events around ``reps`` calls in
    a row, over ``reps``, after a warm-up.  A spin kernel queued first keeps
    the card busy while the host queues the calls, so that the host's launch
    time, longer than some of these kernels, stays out of the interval."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def layout_copy_ms(col, reps):
    """Device ms of the copy that would turn the (BG, N, C) column ``col``
    into the weight product's layout, (BG, C, N) contiguous: 0 when ``col``
    is stored so (channel-major), since then no copy is made."""
    t = col.transpose(1, 2)
    return 0.0 if t.is_contiguous() else time_ms(t.contiguous, reps)


def bound(byte_count, flops):
    """Least time (ms) for the work: bytes over the memory rate or float32
    operations over the float32 rate, whichever is larger."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(name, args, out):
    """(bytes, float32 operations) of one call, from its inputs and output:
    each input read once, each output written once, at its element size (a
    bf16 instance's bf16 tensors count 2 bytes an element; the fp32 buffer
    that the bf16 dconv backward sums d_ft in is scratch, not counted).  The
    operations are counted at the float32 rate, as the CUDA cores do them;
    the bf16 dconv backward forms d_ft's share (8 of its 31 per row and
    channel) on the tensor cores, so its operations bound is an upper one,
    and its bytes bound the larger at the R-FCN calls."""
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    name = name.split("[")[0]
    if name == "dconv_col":
        y0, ft = args[0], args[7]
        return (nbytes(*args[:8], out),
                y0.numel() * ft.shape[2] * 8)  # 4 products, 3 sums, the live mask
    if name == "dconv_col_bwd":
        y0, ft = args[0], args[7]
        # per (row, channel): d_ly and d_lx 7 each, d_lf 9, the four
        # scattered corner weights 8
        return nbytes(*args[:9], *out), y0.numel() * ft.shape[2] * 31
    if name == "psroi_abuild":
        yv, xv = args[:2]
        N, S, H = yv.shape
        return nbytes(yv, xv, out), 2 * N * S * H * xv.shape[2]
    if name == "psroi_abuild_bwd":
        yv, xv, g = args
        N, S, H = yv.shape
        return nbytes(yv, xv, g, *out), 4 * N * S * H * xv.shape[2]
    if name in INT8_PAIR:
        # 4 bytes of float32 and 1 of int8 per element either way, and the
        # range; quantize |x|, ·s, +0.5 and min per element, dequantize one ·
        n = args[0].numel()
        return 5 * n + 4, (4 if name == "quantize_int8" else 1) * n
    boxes, valid = args[0], args[1]
    ids = args[2] if len(args) > 2 else None
    # IoUs the greedy scan needs on this data: each survivor against every
    # earlier survivor, each suppressed box against at least one; ~12 flops each
    alive = out.to(torch.int64)
    earlier = torch.cumsum(alive, 1) - alive
    pairs = int((earlier * alive).sum()) + int((valid & ~out).sum())
    # the valid and alive masks whole; a box (and a float32 class id) only
    # where valid, since an invalid row can neither suppress nor survive
    row_bytes = 4 * boxes.shape[-1] + (0 if ids is None else 4)
    return int(valid.sum()) * row_bytes + 2 * valid.numel(), 12 * pairs


def capture_calls(kernels, names, run):
    """Run ``run()`` with the wrappers of ``names`` recording their args."""
    captured = {name: [] for name in names}

    def capture(name, fn):
        def wrapper(*args, **kw):
            captured[name].append((args, kw))
            return fn(*args, **kw)
        return wrapper

    def attr(name):  # a bf16 row's wrapper: dconv_col_bf16 for dconv_col[bf16]
        return kernels.KERNELS[name].wrapper.__name__

    for name in names:
        setattr(kernels, attr(name), capture(name, kernels.KERNELS[name].wrapper))
    try:
        run()
    finally:
        for name in names:
            setattr(kernels, attr(name), kernels.KERNELS[name].wrapper)
    torch.cuda.synchronize()
    return captured


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significand bits)."""
    e = torch.frexp(x.float().abs().clamp(min=2.0 ** -126)).exponent
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def compare(name, got, ref):
    """Max |kernel − plain| over the outputs; fail beyond the tolerance."""
    base = name.split("[")[0]
    if name in ("nms_alive",) + INT8_PAIR:
        # bit for bit (NaN cannot come out of either: quantize makes it 0,
        # and the dequantize ranges are finite)
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            fail("%s: %d values differ from the plain version"
                 % (name, int((got != ref).sum())))
        return 0.0
    err = 0.0
    for a, b in zip(*((got, ref) if isinstance(got, tuple) else ((got,), (ref,)))):
        scale = float(b.float().abs().max())
        if a.dtype == torch.bfloat16:
            # within one bf16 ulp: fp32 sums of the same products in another
            # order, rounded once; d_ft's atomics may also cancel, so it
            # keeps the fp32 row's absolute slack
            slack = 1e-5 * scale if base == "dconv_col_bwd" else 0.0
            if a.dtype != b.dtype:
                fail("%s: a %s output against %s" % (name, a.dtype, b.dtype))
            diff = (a.float() - b.float()).abs()
            bad = int((diff > bf16_ulp(b) + slack).sum())
            if bad:
                fail("%s: %d of %d bf16 values more than one ulp from the plain "
                     "version" % (name, bad, a.numel()))
            say("  %s: %d of %d bf16 values not bit-equal to the plain version"
                % (name, int((a != b).sum()), a.numel()))
            err = max(err, float(diff.max()))
            continue
        if base == "dconv_col_bwd":
            # sums over C in another order, and d_ft summed by atomics in an
            # order that changes from run to run
            rtol, atol = 1e-4, 1e-5 * scale
        elif base == "psroi_abuild_bwd":
            # fixed-order fp32 sums over 38 rows and 64 columns (fused
            # multiply-add chains and a shuffle tree) against torch's sums
            rtol, atol = 1e-5, 1e-5 * scale
        else:
            rtol, atol = 1e-5, 1e-5
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m: "%s: %s" % (name, m))
        err = max(err, float((a - b).abs().max()))
    return err


def phase_kernels(kernels, net, launches, bwd_captured, train_nms, dev, bf16=False):
    """Each R-FCN kernel against its plain version on the calls of a real
    run: an inference forward for the forward kernels, and for the backward
    kernels the calls ``phase_train`` recorded in one of its batch-1 steps
    (NMS is compared on that step's call too, and timed on the serve call).
    With ``bf16``, the bf16 instances on the bf16 path's calls (``net`` the
    bf16 serve model, the backward calls from ``phase_train_bf16``; NMS has
    its row already).  (The int8 pair's rows come from ``phase_int8``'s
    calls.)"""
    H, W = net.image_shape
    gen = torch.Generator().manual_seed(SEED + 3)
    data, im_info = make_request(gen, [[H, W, 1.0]], net.image_shape, dev)
    data = data.to(net.rfcn_cls.weight.dtype)
    expect = per_forward(net, bf16)
    fwd_names = [n for n, c in expect.items() if c and not (bf16 and n == "nms_alive")]
    captured = capture_calls(kernels, fwd_names, lambda: net(data, im_info))
    captured.update(bwd_captured)
    expect.update({n: per_train_step(net, bf16)[n] for n in bwd_captured})
    rows = []
    for name in fwd_names + list(bwd_captured):
        main = ("train" if name in bwd_captured else "serve") + ("_bf16" if bf16 else "")
        with torch.no_grad():  # the captured backward inputs carry a graph
            rows.append(kernel_row(name, kernels.KERNELS[name], captured[name],
                                   expect[name], launches, main,
                                   extra_calls=train_nms if name == "nms_alive" else ()))
    return rows


# why a kernel has no one-call PyTorch yardstick
NO_LIBRARY_CALL = {
    "nms_alive": "no single torch call does greedy NMS (torchvision.ops.nms is "
                 "not part of PyTorch, and not installed)",
    "dconv_col": "no single torch call samples a bilinear four-corner gather "
                 "at per-row corners (grid_sample takes another layout and "
                 "clamp rule)",
    "dconv_col_bwd": "no single torch call computes the three masked row sums "
                     "and the four-corner scatter together",
    "quantize_int8": "torch.quantize_per_tensor rounds half to even, with a "
                     "zero point",
    "dconv_col[bf16]": "no single torch call samples a bilinear four-corner gather "
                       "at per-row corners (grid_sample takes another layout and "
                       "clamp rule)",
    "dconv_col_bwd[bf16]": "no single torch call computes the three masked row "
                           "sums and the four-corner scatter together",
    "psroi_abuild[bf16]": "no single torch call: torch.bmm of the fp32 factors "
                          "writes an fp32 A, and rounding it to bf16 is a second "
                          "call (the fp32 row times torch.bmm)",
    "psroi_abuild_bwd[bf16]": "no single torch call: torch.bmm takes no bf16 g "
                              "beside fp32 factors without a cast first (the fp32 "
                              "row times torch.bmm)",
}


def kernel_row(name, k, calls, expected, launches, main, extra_calls=(),
               timed_call=0):
    """Hold one kernel against its plain version on its captured calls (and
    on ``extra_calls``, compared only), time both (and the library call) on
    captured call ``timed_call``, and return its JSON row.  ``launches``
    maps each path to its counts; ``main`` names the kernel's own path."""
    if len(calls) != expected:
        fail("captured %d %s calls, expected %d" % (len(calls), name, expected))
    err = 0.0
    for args, kw in list(calls) + list(extra_calls):
        got = k.wrapper(*args, **kw)
        ref = k.plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, compare(name, got, ref))
        if name == "nms_alive":  # the serial chain's length and its work
            say("  nms call %s: %d words, survivors %s of %s valid" % (
                [tuple(a.shape) for a in args[:2]], -(-args[1].shape[1] // 64),
                got.sum(1).tolist(), args[1].sum(1).tolist()))
    args, kw = calls[timed_call]
    out = k.wrapper(*args, **kw)
    kernel_ms = time_ms(lambda: k.wrapper(*args, **kw), 20)
    plain_ms = time_ms(lambda: k.plain(*args, **kw),
                       3 if name == "nms_alive" else 5)
    library_ms = None
    if name == "psroi_abuild":
        yv, xv = args[:2]  # the out_dtype may follow
        library_ms = time_ms(lambda: torch.bmm(yv.transpose(1, 2), xv), 20)
    elif name == "psroi_abuild_bwd":
        yv, xv, g = args
        library_ms = time_ms(lambda: (torch.bmm(xv, g.transpose(1, 2)),
                                      torch.bmm(yv, g)), 20)
    elif name == "dequantize_int8":
        # one call with type promotion, the same function; quantize has no
        # such call (torch.quantize_per_tensor rounds half to even)
        q, real = args
        scale = real / torch.full_like(real, 127.0)
        library_ms = time_ms(lambda: torch.mul(q, scale), 20)
    bound_ms, bound_by = bound(*work(name, args, out))
    shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
    if library_ms is None:
        say("  %s library_ms: null, %s" % (name, NO_LIBRARY_CALL[name]))
    # "launches" is the count on the kernel's own main path (serve for the
    # forward kernels, train for the backward ones, int8 for the pair);
    # "ms" and "kernel_ms" carry the one kernel time under both names that
    # readers of this line look up
    row = dict(
        name=name, route="cuda", source=k.source, replaces=k.replaces,
        launches=launches[main][name],
        **{"%s_launches" % path: c[name] for path, c in launches.items()},
        max_abs_err=err, ms=kernel_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
        library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    say("kernel %s %s: %.4f ms (plain %.4f ms%s), bound %.4f ms by %s, "
        "max_abs_err %g over %d calls" % (
            name, shapes, kernel_ms, plain_ms,
            "" if library_ms is None else ", library %.4f ms" % library_ms,
            bound_ms, bound_by, err, len(calls) + len(extra_calls)))
    if name == "dconv_col":
        # the copy its caller would make to reach the weight product's layout
        row["layout_copy_ms"] = layout_copy_ms(out, 20)
        ly, lf = args[4], args[6]
        say("  dconv samples: %.3f off the integer grid, %.3f live; column "
            "strides %s, layout copy %.4f ms" % (
                float((ly != 0).float().mean()), float(lf.mean()),
                tuple(out.stride()), row["layout_copy_ms"]))
    return row


def phase_serve_bf16(kernels, dev):
    """The serve path in bf16 at full width: see the module docstring."""
    from mxnet_tpu_torch.gluon.model_zoo import rfcn_resnet101

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 21)
    net = rfcn_resnet101(device="cuda", generator=gen, **FULL)
    randomize_deformable(net, gen)
    net.cast("bfloat16")
    if any(t.dtype != bf for t in net.state_dict().values()):
        fail("serve bf16: cast left a parameter or buffer outside bf16")
    expect = per_forward(net, bf16=True)
    H, W = net.image_shape
    requests = [[[H, W, 1.0]]] * 3 + [[[H, W, 1.0], [H - 32, W - 64, 1.0]]]

    def request(infos):
        data, im_info = make_request(gen, infos, (H, W), dev)
        return data.to(bf), im_info

    for infos in (requests[0], requests[-1]):  # cuDNN and allocator set-up
        net(*request(infos))
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i, infos in enumerate(requests):
        data, im_info = request(infos)
        before = counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(data, im_info)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_answer(net, out, im_info, bf)
        got = {n: c - before[n] for n, c in counts(kernels).items()}
        if got != expect:
            fail("bf16 forward launched %s, expected %s" % (got, expect))
        say("bf16 request %d: batch %d, %.2f ms, %d rois, mean top score %.4f" % (
            i + 1, len(infos), ms, out[0].shape[0],
            float(out[1][:, 1:].float().max(1).values.mean())))
    launches = counts(kernels)
    say("serve bf16 launches: %s" % json.dumps(launches))
    return net, launches


def phase_train_bf16(kernels, net, dev, card):
    """The bf16 train step at full width on the fp32 model: see the module
    docstring.  Returns the path's launch counts and the backward kernels'
    calls of the second warm-up step."""
    from mxnet_tpu_torch import train_fused

    rng = np.random.RandomState(SEED + 22)
    nz_gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    named = net.gluon_named_tensors()
    fixed = {n: t.detach().clone() for n, t in named.items()
             if n.startswith(("conv1_", "res2_"))}
    expect = per_train_step(net, bf16=True)
    step = train_fused.make_rfcn_train_step(net, 1, learning_rate=LR, momentum=0.9,
                                            compute_dtype="bfloat16")
    inputs = train_inputs(net, rng, 1, dev)

    def one_step(what):
        return checked_step(kernels, step, inputs, lambda: train_noise(net, 1, nz_gen, dev),
                            expect, what)

    bwd_names = [n for n in kernels.KERNELS if n.endswith("_bwd[bf16]")]
    for i in range(2):
        out = []
        run = lambda: out.append(one_step("bf16 warm-up step %d" % (i + 1)))
        if i == 1:
            captured = capture_calls(kernels, bwd_names, run)
        else:
            run()
        say("train bf16 warm-up step %d: %.2f ms, loss %.4f" % (i + 1, out[0][0], out[0][1]))
    kernels.reset_launches()
    times = []
    for i in range(3):
        ms, loss, parts = one_step("bf16 step %d" % (i + 1))
        times.append(ms)
        say("train bf16 step %d: batch 1, %.2f ms, loss %.4f (rpn_cls %.4f rpn_bbox "
            "%.4f rcnn_cls %.4f rcnn_bbox %.4f)" % (i + 1, ms, loss, *parts))
    launches = counts(kernels)
    kinds = {(p.dtype, m.dtype) for p, m in zip(step.params, step.momentum)}
    if kinds != {(torch.float32, torch.float32)} or any(
            b.dtype != torch.float32 for b in net.buffers()):
        fail("train bf16: masters, momentum and BN statistics must stay fp32, got %s" % kinds)
    for n, t in fixed.items():
        if not torch.equal(named[n], t):
            fail("train bf16: %s moved; conv1/res2 must get no gradient" % n)
    say("train bf16: R-101 on %s, batch 1 median %.2f ms/step (%s); fp32 masters, "
        "momentum and BN statistics; conv1/res2 fixed" % (
            card, statistics.median(times), ", ".join("%.2f" % t for t in times)))
    say("train bf16 launches (3 steps): %s" % json.dumps(launches))
    return launches, captured


def phase_small_input_bf16(dev):
    """Tiny configuration cast to bf16: the card (kernels) against the CPU
    (plain versions), stage by stage, each stage fed the CPU's own inputs.
    Not end to end: bf16 RPN scores tie, and an ulp between the two devices'
    convolutions can reorder the proposals."""
    from mxnet_tpu_torch.gluon.model_zoo import DeformableRFCN

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED + 23)
    cpu = DeformableRFCN(device="cpu", generator=gen, **TINY)
    randomize_deformable(cpu, gen)
    gpu = DeformableRFCN(device="cuda", **TINY)
    gpu.load_state_dict(cpu.state_dict())
    cpu.cast(bf)
    gpu.cast(bf)
    data = torch.randn((2, 3) + cpu.image_shape, generator=gen).to(bf)
    info = torch.tensor([[64, 96, 1.0], [48, 80, 1.0]])
    g = lambda t: t.to(dev)
    with torch.inference_mode():
        c4, c5 = cpu._features(data)
        g4, g5 = gpu._features(g(data))
        rc, rb = cpu._rpn(c4)
        grc, grb = gpu._rpn(g(c4))
        rois = cpu._proposals(rc, rb, info)
        grois = gpu._proposals(g(rc), g(rb), g(info))
        cs, bp = cpu._head(c5, rois, rois_per_image=cpu.rpn_post_nms)
        gcs, gbp = gpu._head(g(c5), g(rois), rois_per_image=cpu.rpn_post_nms)
    # bf16 maps: cuDNN and the CPU round their fp32 sums to bf16 at other
    # places, a few ulps apart; the rois come from the same bf16 scores
    for name, got, ref in (("c4", g4, c4), ("c5", g5, c5), ("rpn_cls", grc, rc),
                           ("rpn_bbox", grb, rb), ("cls_score", gcs, cs),
                           ("bbox_pred", gbp, bp)):
        if got.dtype != bf:
            fail("small bf16: %s is %s" % (name, got.dtype))
        torch.testing.assert_close(got.float().cpu(), ref.float(), rtol=2e-2,
                                   atol=2e-2 * float(ref.float().abs().max()),
                                   msg=lambda m, n=name: "small bf16 %s: %s" % (n, m))
    torch.testing.assert_close(grois.cpu(), rois, rtol=0, atol=1e-3,
                               msg=lambda m: "small bf16 rois: %s" % m)
    say("small input, bf16: the card agrees with the CPU stage by stage (c4, c5, "
        "rpn_cls, rpn_bbox, rois, cls_score, bbox_pred)")


def phase_small_input(dev):
    """Tiny configuration: the card (kernels) against the CPU (plain)."""
    from mxnet_tpu_torch.gluon.model_zoo import DeformableRFCN

    gen = torch.Generator().manual_seed(SEED + 1)
    cpu = DeformableRFCN(device="cpu", generator=gen, **TINY)
    randomize_deformable(cpu, gen)
    gpu = DeformableRFCN(device="cuda", **TINY)
    gpu.load_state_dict(cpu.state_dict())
    data = torch.randn((2, 3) + cpu.image_shape, generator=gen)
    info = torch.tensor([[64, 96, 1.0], [48, 80, 1.0]])
    g = lambda t: t.to(dev)
    with torch.inference_mode():
        c4, c5 = cpu._features(data)
        g4, g5 = gpu._features(g(data))
        rc, rb = cpu._rpn(c4)
        grc, grb = gpu._rpn(g(c4))
        stages = [("c4", g4, c4, 1e-4 * float(c4.abs().max())),
                  ("c5", g5, c5, 1e-4 * float(c5.abs().max())),
                  ("rpn_cls", grc, rc, 1e-4 * float(rc.abs().max())),
                  ("rpn_bbox", grb, rb, 1e-4 * float(rb.abs().max()))]
        rois = cpu._proposals(rc, rb, info)
        stages.append(("rois", gpu._proposals(g(rc), g(rb), g(info)), rois, 1e-3))
        cs, bp = cpu._head(c5, rois, rois_per_image=cpu.rpn_post_nms)
        gcs, gbp = gpu._head(g(c5), g(rois), rois_per_image=cpu.rpn_post_nms)
        stages += [("cls_prob", torch.softmax(gcs, -1), torch.softmax(cs, -1), 1e-4),
                   ("bbox_pred", gbp, bp, 1e-4)]
    for name, got, ref, atol in stages:
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=atol,
                                   msg=lambda m, n=name: "%s: %s" % (n, m))
    whole = [a.cpu() for a in gpu(g(data), g(info))]
    for got, ref in zip(whole, cpu(data, info)):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-3)
    say("small input: the card agrees with the CPU stage by stage and end to end "
        "(%s)" % ", ".join(n for n, *_ in stages))


def phase_small_train(dev, frozen_bn=True):
    """Tiny configuration, one train step at batch 2 on the card (kernels)
    against the same step on the CPU (plain versions): the same weights, the
    same synthetic batch and the same noise.  The RPN score conv gets larger
    weights, so that the proposal scores spread out and the sort has no
    near-tie that the two devices' rounding could flip at this seed.  With
    ``frozen_bn=False`` every trunk BatchNorm normalises with the batch's
    statistics, and a res2 and a res5 running variance are compared too."""
    from mxnet_tpu_torch import train_fused
    from mxnet_tpu_torch.gluon.model_zoo import DeformableConv2D, DeformableRFCN

    # at these seeds the CPU's sorted proposal scores lie at least 1.6e-5
    # (frozen) and 7.4e-5 (batch statistics) apart, far above the devices'
    # rounding differences
    seed, gain = (SEED + 7, 4.0) if frozen_bn else (SMALL_TRAIN_BN_SEED,
                                                    SMALL_TRAIN_BN_RPN_GAIN)
    gen = torch.Generator().manual_seed(seed)
    cpu = DeformableRFCN(device="cpu", generator=gen, frozen_bn=frozen_bn, **TINY)
    randomize_deformable(cpu, gen)
    with torch.no_grad():
        w = cpu.rpn_cls.weight
        w.copy_(torch.randn(w.shape, generator=gen) * gain / math.sqrt(w[0].numel()))
    gpu = DeformableRFCN(device=dev, frozen_bn=frozen_bn, **TINY)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(seed)
    batch = train_fused.synthetic_coco(rng, 2, cpu.image_shape, cpu.classes,
                                       cpu.max_gts)
    noise = [torch.rand(s, generator=gen) for s in train_fused.noise_shapes(cpu, 2)]
    results = []
    for net, d in ((cpu, torch.device("cpu")), (gpu, dev)):
        step = train_fused.make_rfcn_train_step(net, 2, learning_rate=LR, momentum=0.9)
        args = [torch.from_numpy(a).to(d) for a in batch] + [t.to(d) for t in noise]
        loss, parts = step(*args, LR)
        probes = {"offset": next(m.offset.weight for m in net.modules()
                                 if isinstance(m, DeformableConv2D)),
                  "rfcn_trans": net.rfcn_trans.weight}
        named = net.gluon_named_tensors()
        results.append((parts.cpu(), {k: p.grad.cpu() for k, p in probes.items()},
                        {k: named[k].cpu() for k in SMALL_TRAIN_BN_STATS}))
    (ref_parts, ref_grads, ref_stats), (got_parts, got_grads, got_stats) = results
    what = "train" if frozen_bn else "train, batch statistics"
    # four fp32 means over the same selection, summed in another order
    torch.testing.assert_close(got_parts, ref_parts, rtol=1e-4, atol=1e-5,
                               msg=lambda m: "%s loss parts: %s" % (what, m))
    for k, ref in ref_grads.items():
        if not float(ref.abs().max()) > 0:
            fail("small %s: %s got no gradient on the CPU" % (what, k))
        # cuDNN and CPU fp32 backward sums in another order through every
        # layer, the atomics of d_ft among them
        torch.testing.assert_close(got_grads[k], ref, rtol=1e-3,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m, k=k: "%s gradient: %s" % (k, m))
    for k, ref in ref_stats.items():
        moved = not bool((ref == 1).all())
        if moved == frozen_bn:
            fail("small %s: %s %s" % (what, k, "moved" if moved else "did not move"))
        # fp32 statistics of the same activations, in another order
        torch.testing.assert_close(got_stats[k], ref, rtol=1e-4, atol=1e-6,
                                   msg=lambda m, k=k: "%s %s: %s" % (what, k, m))
    say("small input, %s: one step on the card agrees with the CPU (loss parts %s, "
        "offset-conv and rfcn_trans weight gradients, %s)"
        % (what, ", ".join("%.5f" % v for v in got_parts.tolist()),
           ", ".join(SMALL_TRAIN_BN_STATS)))


def resnet_step(net, compute_dtype=None):
    """``make_train_step`` of ``net`` with the bench's loss and SGD."""
    from mxnet_tpu_torch.gluon.functional import make_train_step
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    return make_train_step(net, SoftmaxCrossEntropyLoss(), learning_rate=RESNET_LR,
                           momentum=RESNET_MOMENTUM, compute_dtype=compute_dtype)


def resnet_batch(batch, image, classes, seed, dev):
    """bench.py's inputs: N(0, 1) images and integer labels stored as float,
    from ``numpy.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 3, image, image).astype(np.float32)
    y = rng.randint(0, classes, (batch,)).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def check_resnet_state(state, names, aux_idx, what):
    """Every tensor of the state fp32 and finite, and every running mean and
    variance moved from its start (0 and 1)."""
    learn, mom, aux = state
    for t in learn + mom + aux:
        if t.dtype != torch.float32 or not bool(torch.isfinite(t).all()):
            fail("%s: a state tensor is %s or not finite" % (what, t.dtype))
    for i, t in zip(aux_idx, aux):
        start = 1.0 if names[i].endswith("running_var") else 0.0
        if names[i].endswith(("running_mean", "running_var")) and bool((t == start).all()):
            fail("%s: %s did not move" % (what, names[i]))


def phase_resnet_train(kernels, dev, card):
    """The Gluon ResNet-50 v1 train step of bench.py's second headline at
    full width (1000 classes, 224x224, batch 32, SGD lr 0.05 momentum 0.9),
    fp32 and bf16: one warm-up step, RESNET_TIMED timed steps (host clock,
    each ended by a synchronize), one profiled step; every loss finite, every
    running statistic moved, masters fp32.  The path reaches no TPU kernel's
    port: every count must stay 0.  Returns the counts."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    x, y = resnet_batch(RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES, SEED, dev)
    results = {}
    kernels.reset_launches()
    for dtype in (None, "bfloat16"):
        label = dtype or "float32"
        net = resnet50_v1(classes=RESNET_CLASSES, device=dev,
                          generator=torch.Generator().manual_seed(SEED))
        step, state, (names, learn_idx, aux_idx) = resnet_step(net, dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        times, losses = [], [float(loss)]
        for _ in range(RESNET_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, x, y)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(math.isfinite(v) for v in losses):
            fail("resnet50 %s: losses %s" % (label, losses))
        check_resnet_state(state, names, aux_idx, "resnet50 " + label)
        prof = device_profile(lambda: step(state, x, y), reps=1, top=6)
        ms = statistics.median(times)
        results[label] = dict(step_ms=ms, img_per_s=RESNET_BATCH / ms * 1e3, steps_ms=times,
                              first_step_s=first_s, losses=losses, peak_gib=peak,
                              profile=prof)
        say("resnet50 train %s on %s: batch %d, first step %.2f s, median %.2f ms/step "
            "(%s), %.1f img/s, peak memory %.2f GiB, losses %s; %s kernels a step, "
            "device busy %s ms, idle share %s" % (
                label, card, RESNET_BATCH, first_s, ms, ", ".join("%.2f" % t for t in times),
                RESNET_BATCH / ms * 1e3, peak, ", ".join("%.4f" % v for v in losses),
                prof.get("kernels_per_call"), prof.get("device_busy_ms"),
                prof.get("idle_share")))
        del net, step, state
        torch.cuda.empty_cache()
    launches = counts(kernels)
    if any(launches.values()):
        fail("the resnet50 train path launched %s" % launches)
    say("resnet50 train: %s" % json.dumps(results))
    say("resnet50 train launches (fp32 and bf16, %d steps each): %s"
        % (RESNET_TIMED + 2, json.dumps(launches)))
    return launches


def resnet_state_of(state, names, learn_idx, aux_idx):
    """{Gluon name: tensor on the CPU} of a train step's learnables and
    auxiliary state."""
    learn, _, aux = state
    # a copy: the step updates the state's tensors in place
    out = {names[i]: t.detach().cpu().clone() for i, t in zip(learn_idx, learn)}
    out.update({names[i]: t.detach().cpu().clone() for i, t in zip(aux_idx, aux)})
    return out


def phase_resnet_card_vs_cpu(dev):
    """The first ResNet-50 v1 step at full width (1000 classes, 224x224) and
    batch 2, fp32, on the card and on the CPU from the same weights and
    inputs: the loss, three weights' updates and a running variance."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    cpu = torch.device("cpu")
    x, y = resnet_batch(2, RESNET_IMAGE, RESNET_CLASSES, SEED + 31, cpu)
    out = []
    for d in (cpu, dev):
        net = resnet50_v1(classes=RESNET_CLASSES, device=d,
                          generator=torch.Generator().manual_seed(SEED + 31))
        step, state, meta = resnet_step(net)
        before = resnet_state_of(state, *meta)
        state, loss = step(state, x.to(d), y.to(d))
        out.append((float(loss), before, resnet_state_of(state, *meta)))
    (ref_loss, ref0, ref1), (got_loss, got0, got1) = out
    # one fp32 forward through 53 BatchNorms at batch 2, sums in another order
    if not math.isclose(got_loss, ref_loss, rel_tol=1e-4):
        fail("resnet50 card vs CPU: loss %.6f against %.6f" % (got_loss, ref_loss))
    for name in ("conv2d0_weight", "stage3_conv2d4_weight", "dense0_weight"):
        if not torch.equal(got0[name], ref0[name]):
            fail("resnet50 card vs CPU: %s starts apart" % name)
        upd, ref_upd = got1[name] - got0[name], ref1[name] - ref0[name]
        scale = float(ref_upd.abs().max())
        if name.startswith("dense0"):
            # the update is lr x the gradient; the output layer's has no
            # BatchNorm behind it: fp32 sums in another order
            torch.testing.assert_close(upd, ref_upd, rtol=1e-3, atol=1e-3 * scale,
                                       msg=lambda m, n=name: "resnet50 %s update: %s" % (n, m))
            continue
        # behind a BatchNorm at batch 2 the gradient is a difference of
        # nearly equal terms, which fp32 rounds at the percent level on any
        # device (the CPU's fp32 against its own fp64 too): the two devices'
        # updates agree in direction and within a tenth of the largest
        cos = float((upd * ref_upd).sum() / (upd.norm() * ref_upd.norm()))
        err = float((upd - ref_upd).abs().max())
        if not (cos > 0.999 and err <= 0.1 * scale):
            fail("resnet50 card vs CPU: %s update cosine %.6f, max error %.3g of %.3g"
                 % (name, cos, err, scale))
    name = "stage2_batchnorm1_running_var"
    torch.testing.assert_close(got1[name], ref1[name], rtol=1e-4, atol=1e-6,
                               msg=lambda m: "resnet50 %s: %s" % (name, m))
    say("resnet50 card vs CPU (batch 2, fp32): loss %.6f / %.6f; dense0's update, the "
        "directions of conv2d0's and stage3_conv2d4's, and %s agree" % (got_loss, ref_loss, name))


def phase_small_resnet(dev):
    """The narrow ResNet V1 of the CPU tests (64x64, batch 4): one step on
    the card against one on the CPU from the same weights, fp32 and bf16."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1

    cpu = torch.device("cpu")
    x, y = resnet_batch(4, 64, NARROW["classes"], SEED + 33, cpu)
    for dtype in (None, "bfloat16"):
        out = []
        for d in (cpu, dev):
            net = ResNetV1(BottleneckV1, device=d,
                           generator=torch.Generator().manual_seed(SEED + 33), **NARROW)
            step, state, meta = resnet_step(net, dtype)
            state, loss = step(state, x.to(d), y.to(d))
            names, learn_idx, _ = meta
            # the first step's momentum is its gradient
            moms = {names[i]: m.cpu().clone() for i, m in zip(learn_idx, state[1])}
            out.append((float(loss), resnet_state_of(state, *meta), moms))
        (ref_loss, ref, ref_m), (got_loss, got, got_m) = out
        bf16 = dtype is not None
        # fp32: sums in another order; bf16: each device rounds its bf16
        # convolutions and products at other places
        if not math.isclose(got_loss, ref_loss, rel_tol=3e-2 if bf16 else 1e-5):
            fail("small resnet %s: loss %.6f against %.6f" % (dtype, got_loss, ref_loss))
        for name, t in ref.items():
            if name.endswith(("running_mean", "running_var")):
                tol = 5e-2 if bf16 else 1e-5
                torch.testing.assert_close(got[name], t, rtol=tol,
                                           atol=tol * float(t.abs().max()),
                                           msg=lambda m, n=name: "small resnet %s: %s" % (n, m))
        for name in ("dense0_weight", "stage2_conv2d1_weight"):
            a, b = got_m[name], ref_m[name]
            if bf16 and not name.startswith("dense0"):
                # behind a BatchNorm a bf16 gradient is a difference of
                # nearly equal terms rounded at other places: its direction
                cos = float((a * b).sum() / (a.norm() * b.norm()))
                if not cos > 0.9:
                    fail("small resnet bf16: %s gradient cosine %.3f" % (name, cos))
                continue
            tol = 0.1 if bf16 else 1e-3
            torch.testing.assert_close(a, b, rtol=tol, atol=tol * float(b.abs().max()),
                                       msg=lambda m, n=name: "small resnet %s: %s" % (n, m))
        say("small input, resnet %s: one step on the card agrees with the CPU (loss %.5f "
            "/ %.5f, running statistics, dense0 and stage2 gradients)"
            % (dtype or "float32", got_loss, ref_loss))


def resnet_params(net, data_shape, gen, dev):
    """He-scaled weights, BN gamma 1 and beta 0, moving mean 0 and variance
    1, fc1's bias 0: the arg and aux dictionaries of ``net`` on the card."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=data_shape)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_weight"):
            v = torch.randn(s, generator=gen) * math.sqrt(2.0 / math.prod(s[1:]))
        else:
            v = torch.ones(s) if n.endswith("_gamma") else torch.zeros(s)
        args[n] = v.to(dev)
    aux = {n: (torch.ones(s) if n.endswith("_var") else torch.zeros(s)).to(dev)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def bind(sym, args, aux, batch, dev, image=(3, 224, 224)):
    exe = sym.simple_bind(device=dev, grad_req="null", data=(batch,) + image)
    for bound, params in ((exe.arg_dict, args), (exe.aux_dict, aux)):
        for k, v in params.items():
            bound[k].copy_(v)
    return exe


def int8_nodes(qsym, data_shape):
    """(int8 quantize nodes, dequantize nodes whose input is int8) of the
    rewritten graph, counted on its shape and dtype inference."""
    from mxnet_tpu_torch.symbol.symbol import _infer_graph, _sym_out_name

    metas = _infer_graph(qsym, {"data": data_shape})
    nodes = [n for n in qsym._walk() if not n.is_var]
    n_q = sum(n.op.name == "_contrib_quantize" and n.attrs.get("out_type") == "int8"
              for n in nodes)
    n_dq = sum(n.op.name == "_contrib_dequantize"
               and metas[_sym_out_name(n.inputs[0])].dtype == torch.int8 for n in nodes)
    return n_q, n_dq


def only(got, **want):
    """``got``'s keys with the counts of ``want`` and 0 elsewhere."""
    return {k: want.get(k, 0) for k in got}


def timed_forward(exe, data, reps=7):
    """Median host-clock ms of ``reps`` forwards, each ended by a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.forward(data=data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


PROFILE_GROUPS = (  # first match wins, on the lower-cased kernel name
    ("nms_alive", ("nms_mask_kernel", "nms_scan_kernel")),
    ("dequantize_int8", ("dequantize_int8_kernel",)),
    ("quantize_int8", ("quantize_int8_kernel",)),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "implicit", "cudnn")),
    ("gemm", ("gemm", "cublas", "cutlass")),
    ("reduce", ("reduce_kernel",)),
    ("multi_tensor", ("multi_tensor_apply",)),
    ("elementwise", ("elementwise_kernel",)),
)


def device_profile(run, reps=3, top=0):
    """Where a forward's or a step's device time goes: device busy ms and
    kernels per ``run()``, by group (the int8 pair, cuDNN convolutions,
    matrix products, reductions, multi-tensor updates, elementwise kernels,
    the rest: copies and others), and with ``top`` the ``top`` kernels by
    device time, from ``torch.profiler``'s CUDA activity over ``reps``
    calls; the idle share is 1 - busy / the traced wall.  "not measured"
    when the profiler records no device time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    groups, launches, kernels = {}, 0, []
    for evt in prof.key_averages():
        us = float(getattr(evt, "self_device_time_total", 0) or 0)
        if us <= 0 or evt.device_type == torch.autograd.DeviceType.CPU:
            continue
        name = evt.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + us / reps / 1e3
        launches += evt.count / reps
        kernels.append((us / reps / 1e3, evt.count / reps, evt.key[:120]))
    busy = sum(groups.values())
    if not busy:
        return {"device_busy_ms": "not measured"}
    out = {"traced_wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
           "kernels_per_call": launches, "device_ms_by_group": groups}
    if top:
        out["top_kernels_ms_count_name"] = sorted(kernels, reverse=True)[:top]
    return out


def phase_int8(kernels, dev, card):
    """int8 post-training quantization of ResNet-50 v2 at full width: see
    the module docstring.  Returns the path's launch counts, the int8
    pair's calls captured in one batch-32 forward, and the latencies."""
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.models import resnet_symbol

    gen = torch.Generator().manual_seed(SEED + 11)
    with sym.NameManager():
        net = resnet_symbol.get_symbol(**INT8)
    image = tuple(int(v) for v in INT8["image_shape"].split(","))
    args, aux = resnet_params(net, (1,) + image, gen, dev)
    n_batches, per_batch = INT8_CALIB
    calib = torch.randn((n_batches * per_batch,) + image, generator=gen).to(dev)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    qsym, qargs, qaux = quantize_model(
        net, args, aux, device=dev, excluded_sym_names=["fc1"], calib_mode="naive",
        calib_data=NDArrayIter(calib, batch_size=per_batch))
    torch.cuda.synchronize()
    qm_s = time.perf_counter() - t0
    weight_launches = counts(kernels)
    n_w = sum(n.endswith("_quantize") for n in qsym.list_arguments())
    if weight_launches != only(weight_launches, quantize_int8=n_w):
        fail("quantize_model launched %s, expected quantize_int8 once per "
             "offline weight (%d) and nothing else" % (weight_launches, n_w))
    calibrated = [n for n in qsym._walk()
                  if not n.is_var and n.op.name == "_contrib_requantize"]
    if not all(n.attrs.get("max_calib_range") is not None for n in calibrated):
        fail("quantize_model left a requantize node uncalibrated")
    n_q, n_dq = int8_nodes(qsym, (1,) + image)
    ops = [n.op.name for n in qsym._walk() if not n.is_var]
    say("int8: ResNet-%d v2 %s, %d classes, %.1f M parameters; quantize_model "
        "(naive, %dx%d images, fc1 excluded) in %.2f s: %d quantized convs, "
        "%d int8 quantize and %d int8-input dequantize nodes, %d weights "
        "quantized offline with %d quantize_int8 launches" % (
            INT8["num_layers"], image, INT8["num_classes"],
            sum(v.numel() for v in args.values()) / 1e6,
            n_batches, per_batch, qm_s, ops.count("_contrib_quantized_conv"),
            n_q, n_dq, n_w, weight_launches["quantize_int8"]))

    latencies = {}
    captured = None
    for batch in INT8_BATCHES:
        fexe = bind(net, args, aux, batch, dev)
        qexe = bind(qsym, qargs, qaux, batch, dev)
        data = torch.randn((batch,) + image, generator=gen).to(dev)
        ref = fexe.forward(data=data)[0]
        qexe.forward(data=data)  # warm-up: cuBLAS and allocator set-up
        torch.cuda.synchronize()
        before = counts(kernels)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = qexe.forward(data=data)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        got = {n: c - before[n] for n, c in counts(kernels).items()}
        if got != only(got, quantize_int8=n_q, dequantize_int8=n_dq):
            fail("int8 forward at batch %d launched %s, expected quantize_int8 "
                 "%d and dequantize_int8 %d" % (batch, got, n_q, n_dq))
        for t, what in ((out, "int8"), (ref, "fp32")):
            if tuple(t.shape) != (batch, INT8["num_classes"]):
                fail("%s output has shape %s" % (what, tuple(t.shape)))
            if not bool(torch.isfinite(t).all()):
                fail("%s output has non-finite values" % what)
            err = float((t.sum(1) - 1).abs().max())
            if err > 1e-5:
                fail("%s output rows sum to 1 only within %g" % (what, err))
        agree = float((out.argmax(1) == ref.argmax(1)).float().mean())
        q_ms, q_all = timed_forward(qexe, data)
        f_ms, f_all = timed_forward(fexe, data)
        latencies[batch] = dict(int8_ms=q_ms, fp32_ms=f_ms, top1_agreement=agree,
                                int8_profile=device_profile(lambda: qexe.forward(data=data)),
                                fp32_profile=device_profile(lambda: fexe.forward(data=data)))
        say("int8 request: batch %d, int8 %.2f ms (%s), fp32 %.2f ms (%s) on %s; "
            "top-1 int8 = fp32 on %.3f of the images; no host sync in the int8 "
            "forward; launches %s" % (
                batch, q_ms, ", ".join("%.2f" % t for t in q_all), f_ms,
                ", ".join("%.2f" % t for t in f_all), card, agree,
                {k: got[k] for k in INT8_PAIR}))
        if batch == max(INT8_BATCHES):
            captured = capture_calls(kernels, list(INT8_PAIR),
                                     lambda: qexe.forward(data=data))
        del fexe, qexe
    launches = counts(kernels)
    forwards = launches["dequantize_int8"] // n_dq
    if forwards < 1 or launches != only(launches, quantize_int8=n_w + forwards * n_q,
                        dequantize_int8=forwards * n_dq):
        fail("int8 path launched %s over quantize_model and %d forwards"
             % (launches, forwards))
    say("int8 launches (quantize_model and %d int8 forwards): %s"
        % (forwards, json.dumps(launches)))
    say("int8 latency: %s" % json.dumps(latencies))
    return launches, captured, {"quantize_int8": n_q, "dequantize_int8": n_dq}


def int8_edge_calls(kernels, dev):
    """An odd-sized tensor with +-0, NaN and infinities, its range, a zero
    range, and all zeros under a zero range: compared only."""
    gen = torch.Generator().manual_seed(SEED + 12)
    x = torch.randn(1_000_003, generator=gen) * 3
    x[:6] = torch.tensor([0.0, -0.0, math.nan, math.inf, -math.inf, 1e-30])
    x = x.to(dev)
    real = x[torch.isfinite(x)].abs().max()
    zero = torch.zeros((), device=dev)
    zeros = torch.zeros(1_000_003, device=dev)
    q = kernels.quantize_int8_plain(x, real)
    return {"quantize_int8": [((x, real), {}), ((x, zero), {}), ((zeros, zero), {})],
            "dequantize_int8": [((q, real), {}), ((q, zero), {})]}


def phase_small_int8(dev):
    """CIFAR ResNet-8 v2: quantize_model with naive calibration on the CPU,
    then the int8 symbol with the same weights and the same calibration
    table on the card and on the CPU.  Every int8 and int32 value of every
    node must be equal; the fc1 logits agree within 1e-6."""
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.models import resnet_symbol

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 13)
    with sym.NameManager():
        net = resnet_symbol.get_symbol(10, 8, "3,32,32")
    image = (3, 32, 32)
    args, aux = resnet_params(net, (1,) + image, gen, cpu)
    qsym, qargs, qaux = quantize_model(
        net, args, aux, device="cpu", excluded_sym_names=["fc1"], calib_mode="naive",
        calib_data=NDArrayIter(torch.randn((8,) + image, generator=gen), batch_size=4))
    internals = qsym.get_internals()
    data = torch.randn((4,) + image, generator=gen)
    outs = []
    for d in (cpu, dev):
        exe = bind(internals, {k: v.to(d) for k, v in qargs.items()},
                   {k: v.to(d) for k, v in qaux.items()}, 4, d, image)
        outs.append([o.cpu() for o in exe.forward(data=data.to(d))])
    n_int = 0
    for name, ref, got in zip(internals.list_outputs(), *outs):
        if ref.dtype in (torch.int8, torch.int32):
            n_int += ref.numel()
            if not torch.equal(got, ref):
                fail("small int8: %s differs between the card and the CPU in %d "
                     "values" % (name, int((got != ref).sum())))
    names = internals.list_outputs()
    ref, got = (o[names.index("fc1_output")] for o in outs)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6,
                               msg=lambda m: "small int8 fc1 logits: %s" % m)
    say("small input, int8: CIFAR ResNet-8 int8 on the card equals the CPU in "
        "all %d int8/int32 values; fc1 logits within %.3g" % (
            n_int, float((got - ref).abs().max())))


def no_host_sync(fn, what):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: any host
    synchronisation inside it fails the run."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        fail("%s synchronised the host: %s" % (what, e))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


def capture_roi_pooling(run):
    """Run ``run()`` with ``ops.detection.roi_pooling`` recording its
    inputs: -> [(data detached, rois, keywords)]."""
    from mxnet_tpu_torch.ops import detection as ops_det

    orig, seen = ops_det.roi_pooling, []

    def spy(data, rois, **kw):
        seen.append((data.detach(), rois, kw))
        return orig(data, rois, **kw)

    ops_det.roi_pooling = spy
    try:
        run()
    finally:
        ops_det.roi_pooling = orig
    torch.cuda.synchronize()
    return seen


def roi_pooling_cost(call, train):
    """Device ms of one ROIPooling call on a path's own inputs (forward, or
    forward and backward with ``train``; CUDA events around 3 calls behind a
    spin kernel) and its peak bytes above what was allocated before it."""
    from mxnet_tpu_torch.ops import detection as ops_det

    data, rois, kw = call
    g = torch.randn((rois.shape[0], data.shape[1]) + (7, 7), device=data.device,
                    generator=torch.Generator(device=data.device).manual_seed(SEED),
                    ).to(data.dtype)

    def run():
        if not train:
            with torch.inference_mode():
                return ops_det.roi_pooling(data, rois, **kw)
        x = data.detach().requires_grad_()
        ops_det.roi_pooling(x, rois, **kw).backward(g)
        return x.grad

    ms = time_ms(run, 3)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return ms, torch.cuda.max_memory_allocated() - base


def frcnn_expect(kernels):
    """Faster R-CNN's launches a forward or step: one NMS over the batch,
    no other ported kernel (ROIPooling and the rest are PyTorch)."""
    return {n: int(n == "nms_alive") for n in kernels.KERNELS}


def report_path(what, card, times, batch, peak, prof, roi):
    """Print a path's step or request ms, img/s, device profile and its
    ROIPooling cost; -> the same as a dict."""
    ms = statistics.median(times)
    out = dict(ms=ms, all_ms=times, img_per_s=batch / ms * 1e3, peak_gib=peak,
               profile=prof, roi_pooling_ms=roi[0], roi_pooling_peak_bytes=roi[1])
    say("%s on %s: batch %d, median %.2f ms (%s), %.2f img/s, peak memory %.2f GiB; "
        "%s kernels a call, device busy %s ms, idle share %s; ROIPooling %.3f ms, "
        "peak %.3f GB above its inputs" % (
            what, card, batch, ms, ", ".join("%.2f" % t for t in times),
            batch / ms * 1e3, peak, prof.get("kernels_per_call"), prof.get("device_busy_ms"),
            prof.get("idle_share"), roi[0], roi[1] / 1e9))
    say("%s device groups: %s" % (what, json.dumps(prof)))
    return out


def phase_frcnn_serve(kernels, dev, card):
    """Faster R-CNN VGG16 serve at full width: see the module docstring."""
    from mxnet_tpu_torch import train_frcnn

    gen = torch.Generator().manual_seed(SEED + 41)
    t0 = time.perf_counter()
    net, shape, classes = train_frcnn.build_net(
        True, rpn_pre_nms=FRCNN_SERVE_NMS[0], rpn_post_nms=FRCNN_SERVE_NMS[1],
        device=dev, generator=gen)
    torch.cuda.synchronize()
    say("frcnn serve: VGG16 Faster R-CNN, %d classes, %s, pre/post NMS %d/%d, %.1f M "
        "parameters, built in %.1f s" % (classes, shape, net.rpn_pre_nms, net.rpn_post_nms,
                                        sum(p.numel() for p in net.parameters()) / 1e6,
                                        time.perf_counter() - t0))
    expect = frcnn_expect(kernels)
    H, W = shape
    requests = [[[H, W, 1.0]]] * 4 + [[[H, W, 1.0], [H - 32, W - 64, 1.0]]]
    for infos in (requests[0], requests[-1]):  # cuDNN and allocator set-up
        net(*make_request(gen, infos, shape, dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for i, infos in enumerate(requests):
        data, im_info = make_request(gen, infos, shape, dev)
        before = counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:  # the first request also shows that the forward never syncs
            out = no_host_sync(lambda: net(data, im_info), "the frcnn serve forward")
        else:
            out = net(data, im_info)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_answer(net, out, im_info, box_cols=4 * (classes + 1))
        got = {n: c - before[n] for n, c in counts(kernels).items()}
        if got != expect:
            fail("frcnn forward launched %s, expected %s" % (got, expect))
        if len(infos) == 1:
            times.append(ms)
        say("frcnn request %d: batch %d, %.2f ms, %d rois, mean top score %.4f" % (
            i + 1, len(infos), ms, out[0].shape[0], float(out[1][:, 1:].max(1).values.mean())))
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    data, im_info = make_request(gen, requests[0], shape, dev)
    prof = device_profile(lambda: net(data, im_info), reps=3, top=8)
    roi = roi_pooling_cost(capture_roi_pooling(lambda: net(data, im_info))[0], train=False)
    res = report_path("frcnn serve (batch 1)", card, times, 1, peak, prof, roi)
    say("frcnn serve launches (%d requests): %s" % (len(requests), json.dumps(launches)))
    return net, launches, res


def frcnn_train_steps(kernels, net, dev, card, dtype, timed, seed):
    """Warm-up, timed and checked train steps of ``net`` at batch 1 (and one
    at batch 2 in fp32): see the module docstring.  -> (launches, the NMS
    calls of the second warm-up step, the path's report)."""
    from mxnet_tpu_torch import train_frcnn

    label = dtype or "float32"
    rng = np.random.RandomState(seed)
    rnd_gen = torch.Generator(device=dev).manual_seed(seed)
    named = net.gluon_named_tensors()
    fixed = {n: t.detach().clone() for n, t in named.items()
             if n.startswith(("conv1_", "conv2_"))}
    moving = {n: t.detach().clone() for n, t in named.items() if n not in fixed}
    expect = frcnn_expect(kernels)

    def inputs(batch):
        return tuple(torch.from_numpy(a).to(dev) for a in train_frcnn.synthetic_coco(
            rng, batch, net.image_shape, net.classes, net.max_gts))

    def one_step(step, x, batch, what):
        return checked_step(kernels, step, x,
                            lambda: train_frcnn.draw_randoms(net, batch, rnd_gen, dev),
                            expect, "frcnn %s %s" % (label, what), lr=FRCNN_LR)

    step1 = train_frcnn.make_frcnn_train_step(net, 1, learning_rate=FRCNN_LR, momentum=0.9,
                                              compute_dtype=dtype)
    x1 = inputs(1)
    for i in range(2):
        out = []
        run = lambda: out.append(one_step(step1, x1, 1, "warm-up step %d" % (i + 1)))
        if i == 1:  # records NMS's call and ROIPooling's inputs
            roi_calls = []
            nms = capture_calls(kernels, ["nms_alive"], lambda: roi_calls.extend(
                capture_roi_pooling(run)))["nms_alive"]
        else:
            run()
        say("frcnn train %s warm-up step %d: %.2f ms, loss %.4f" % (label, i + 1, *out[0][:2]))
    rnd = train_frcnn.draw_randoms(net, 1, rnd_gen, dev)
    no_host_sync(lambda: step1(*x1, *rnd, FRCNN_LR), "the frcnn %s train step" % label)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for i in range(timed):
        ms, loss, parts = one_step(step1, x1, 1, "step %d" % (i + 1))
        times.append(ms)
        say("frcnn train %s step %d: batch 1, %.2f ms, loss %.4f (rpn_cls %.4f rpn_bbox %.4f "
            "rcnn_cls %.4f rcnn_bbox %.4f)" % (label, i + 1, ms, loss, *parts))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if dtype is None:
        step2 = train_frcnn.make_frcnn_train_step(net, 2, learning_rate=FRCNN_LR, momentum=0.9)
        ms2, loss, _ = one_step(step2, inputs(2), 2, "batch-2 step")
        say("frcnn train float32 step: batch 2 (first at this batch size), %.2f ms, loss %.4f"
            % (ms2, loss))
    launches = counts(kernels)
    for n, t in fixed.items():
        if not torch.equal(named[n], t):
            fail("frcnn train %s: %s moved; conv1/conv2 must get no gradient" % (label, n))
    still = [n for n, t in moving.items() if torch.equal(named[n], t)]
    if still:
        fail("frcnn train %s: %d conv3+ and head tensors did not move: %s"
             % (label, len(still), still[:3]))
    kinds = {(p.dtype, m.dtype) for p, m in zip(step1.params, step1.momentum)}
    if kinds != {(torch.float32, torch.float32)}:
        fail("frcnn train %s: masters and momentum must stay fp32, got %s" % (label, kinds))
    prof = device_profile(lambda: step1(*x1, *train_frcnn.draw_randoms(net, 1, rnd_gen, dev),
                                        FRCNN_LR), reps=1, top=8)
    roi = roi_pooling_cost(roi_calls[0], train=True)
    res = report_path("frcnn train %s (batch 1)" % label, card, times, 1, peak, prof, roi)
    say("frcnn train %s: conv1/conv2 fixed (%d tensors), %d conv3+ and head tensors moved, "
        "fp32 masters and momentum; launches (%d steps): %s" % (
            label, len(fixed), len(moving), timed + (dtype is None), json.dumps(launches)))
    return launches, nms, res


def phase_frcnn_train(kernels, serve_net, dev, card):
    """The Faster R-CNN VGG16 train step at full width, fp32 then bf16, on
    the JAX example's build_net(vgg16=True) with the serve model's weights."""
    from mxnet_tpu_torch import train_frcnn

    net, shape, classes = train_frcnn.build_net(True, device=dev)
    net.load_state_dict(serve_net.state_dict())
    say("frcnn train: VGG16 Faster R-CNN, %d classes, %s, pre/post NMS %d/%d, batch_rois "
        "%d, rpn_batch %d, max_gts %d, SGD lr %g momentum 0.9" % (
            classes, shape, net.rpn_pre_nms, net.rpn_post_nms, net.batch_rois,
            net.rpn_batch, net.max_gts, FRCNN_LR))
    launches, nms, fp32 = frcnn_train_steps(kernels, net, dev, card, None, FRCNN_TIMED,
                                            SEED + 42)
    launches_bf16, _, bf16 = frcnn_train_steps(kernels, net, dev, card, "bfloat16",
                                               FRCNN_TIMED_BF16, SEED + 43)
    return launches, launches_bf16, nms, {"float32": fp32, "bfloat16": bf16}


def phase_frcnn_serve_bf16(kernels, net, dev, card):
    """Faster R-CNN VGG16 served after ``cast("bfloat16")`` (the serve
    model's weights, cast in place): FRCNN_SERVE_BF16_REQUESTS single-image
    requests and one batch of two, each answer checked as the fp32 stage's
    (rois fp32; cls_prob and bbox_pred bf16) and one NMS launch a request;
    ms, busy, idle share and kernels."""
    bf = torch.bfloat16
    net.cast("bfloat16")
    if any(t.dtype != bf for t in net.state_dict().values()):
        fail("frcnn serve bf16: cast left a parameter or buffer outside bf16")
    gen = torch.Generator().manual_seed(SEED + 44)
    expect = frcnn_expect(kernels)
    H, W = net.image_shape
    requests = [[[H, W, 1.0]]] * FRCNN_SERVE_BF16_REQUESTS + \
        [[[H, W, 1.0], [H - 32, W - 64, 1.0]]]

    def request(infos):
        data, im_info = make_request(gen, infos, (H, W), dev)
        return data.to(bf), im_info

    for infos in (requests[0], requests[-1]):  # cuDNN and allocator set-up
        net(*request(infos))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for i, infos in enumerate(requests):
        data, im_info = request(infos)
        before = counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = net(data, im_info)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_answer(net, out, im_info, bf, box_cols=4 * (net.classes + 1))
        got = {n: c - before[n] for n, c in counts(kernels).items()}
        if got != expect:
            fail("frcnn bf16 forward launched %s, expected %s" % (got, expect))
        if len(infos) == 1:
            times.append(ms)
        say("frcnn bf16 request %d: batch %d, %.2f ms, %d rois, mean top score %.4f" % (
            i + 1, len(infos), ms, out[0].shape[0],
            float(out[1][:, 1:].float().max(1).values.mean())))
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    data, im_info = request(requests[0])
    prof = device_profile(lambda: net(data, im_info), reps=3, top=8)
    roi = roi_pooling_cost(capture_roi_pooling(lambda: net(data, im_info))[0], train=False)
    res = report_path("frcnn serve bf16 (batch 1)", card, times, 1, peak, prof, roi)
    say("frcnn serve bf16 launches (%d requests): %s" % (len(requests), json.dumps(launches)))
    return launches, res


def device_ops(run, tries=3):
    """The names of the device operations of one ``run()``, from the
    profiler.  A profile that recorded no device operation at all is taken
    again, up to ``tries`` times: the profiler has returned an empty
    profile for a call whose kernels ran."""
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ops = sorted({e.key for e in prof.key_averages()
                      if float(getattr(e, "self_device_time_total", 0) or 0) > 0})
        if ops:
            break
    return ops


def nms_at_train_size(kernels, calls):
    """NMS on the Faster R-CNN train step's own call (N = 12,000, 188
    words): bit for bit against the plain version, the kernel's device time
    and bound, and the device operations of one call (the staged scan, not
    the global one, takes N = 12,000).  -> keys for the NMS row."""
    k = kernels.KERNELS["nms_alive"]
    for args, kw in calls:
        got, ref = k.wrapper(*args, **kw), k.plain(*args, **kw)
        torch.cuda.synchronize()
        compare("nms_alive", got, ref)
    args, kw = calls[0]
    n = args[0].shape[1]
    words = -(-n // 64)
    ms = time_ms(lambda: k.wrapper(*args, **kw), 20)
    plain_ms = time_ms(lambda: k.plain(*args, **kw), 3)
    bound_ms, bound_by = bound(*work("nms_alive", args, k.wrapper(*args, **kw)))
    ops = device_ops(lambda: k.wrapper(*args, **kw))
    if not any("nms_scan_kernel" in o and "global" not in o for o in ops):
        fail("nms at N=%d did not run the staged scan: %s" % (n, ops))
    say("kernel nms_alive at the frcnn train size: N %d, %d words, %.4f ms (plain %.4f ms), "
        "bound %.6f ms by %s, bit-identical over %d calls; device ops %s"
        % (n, words, ms, plain_ms, bound_ms, bound_by, len(calls), ops))
    return dict(frcnn_train_n=n, frcnn_train_words=words, frcnn_train_ms=ms,
                frcnn_train_plain_ms=plain_ms, frcnn_train_bound_ms=bound_ms)


def phase_small_frcnn(dev):
    """The tiny Faster R-CNN on the card against the CPU: stage by stage,
    each stage fed the CPU's inputs, end to end, then one fp32 train step
    with the same weights, noise and dropout masks.  At this seed and RPN
    gain the CPU's 144 foreground scores of each image lie at least 4.6e-5
    apart, far above the devices' rounding differences."""
    from mxnet_tpu_torch import train_frcnn
    from mxnet_tpu_torch.gluon.model_zoo import FasterRCNN

    cfg = dict(classes=3, image_shape=(64, 96), rpn_pre_nms=200, rpn_post_nms=32,
               **train_frcnn.TINY)
    gen = torch.Generator().manual_seed(SMALL_FRCNN_SEED)
    cpu = FasterRCNN(device="cpu", generator=gen, **cfg)
    with torch.no_grad():
        cpu.rpn_cls.weight.mul_(SMALL_FRCNN_RPN_GAIN)
    gpu = FasterRCNN(device=dev, **cfg)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(SMALL_FRCNN_SEED)
    batch = [torch.from_numpy(a) for a in train_frcnn.synthetic_coco(
        rng, 2, cpu.image_shape, cpu.classes, cpu.max_gts)]
    data, info = batch[:2]
    g = lambda t: t.to(dev)
    with torch.inference_mode():
        c5, g5 = cpu._features(data), gpu._features(g(data))
        rc, rb = cpu._rpn(c5)
        grc, grb = gpu._rpn(g(c5))
        stages = [("c5", g5, c5, 1e-4 * float(c5.abs().max())),
                  ("rpn_cls", grc, rc, 1e-4 * float(rc.abs().max())),
                  ("rpn_bbox", grb, rb, 1e-4 * float(rb.abs().max()))]
        rois = cpu._proposals(rc, rb, info)
        stages.append(("rois", gpu._proposals(g(rc), g(rb), g(info)), rois, 1e-3))
        cs, bp = cpu._head(c5, rois, rois_per_image=cpu.rpn_post_nms)
        gcs, gbp = gpu._head(g(c5), g(rois), rois_per_image=cpu.rpn_post_nms)
        stages += [("cls_prob", torch.softmax(gcs, -1), torch.softmax(cs, -1), 1e-5),
                   ("bbox_pred", gbp, bp, 1e-4 * float(bp.abs().max()))]
    for name, got, ref, atol in stages:
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=atol,
                                   msg=lambda m, n=name: "small frcnn %s: %s" % (n, m))
    for got, ref in zip(gpu(g(data), g(info)), cpu(data, info)):
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-3)
    rnd = train_frcnn.draw_randoms(cpu, 2, gen, "cpu")
    res = []
    for net, d in ((cpu, torch.device("cpu")), (gpu, dev)):
        step = train_frcnn.make_frcnn_train_step(net, 2, learning_rate=FRCNN_LR, momentum=0.9)
        _, parts = step(*(t.to(d) for t in batch + rnd))
        named = net.gluon_named_tensors()
        res.append((parts.cpu(), {k: named[k].grad.cpu() for k in
                                  ("conv3_conv2d0_weight", "fc6_weight", "rpn_cls_weight")}))
    (ref_parts, ref_grads), (got_parts, got_grads) = res
    # four fp32 means over the same selection, summed in another order
    torch.testing.assert_close(got_parts, ref_parts, rtol=1e-4, atol=1e-5,
                               msg=lambda m: "small frcnn loss parts: %s" % m)
    for k, ref in ref_grads.items():
        if not float(ref.abs().max()) > 0:
            fail("small frcnn: %s got no gradient on the CPU" % k)
        torch.testing.assert_close(got_grads[k], ref, rtol=1e-3,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m, k=k: "small frcnn %s gradient: %s" % (k, m))
    say("small input, frcnn: the card agrees with the CPU stage by stage (%s), end to end, "
        "and over one train step (loss parts %s; conv3, fc6 and rpn_cls gradients)"
        % (", ".join(n for n, *_ in stages), ", ".join("%.5f" % v for v in got_parts.tolist())))


def ssd_check(out, batch, n_anchors, what):
    """A score step's answer: (B, A, 6) fp32, finite; the valid rows (score
    >= 0) a prefix of at most SSD_TOPK rows sorted by score; a kept row's
    class in [0, SSD_CLASSES) and its box in [0, 1]; the other rows -1.
    -> (valid rows, kept rows) per image."""
    if tuple(out.shape) != (batch, n_anchors, 6) or out.dtype != torch.float32:
        fail("%s: detections are %s %s, expected float32 %s"
             % (what, out.dtype, tuple(out.shape), (batch, n_anchors, 6)))
    if not bool(torch.isfinite(out).all()):
        fail("%s: non-finite detections" % what)
    cid, score = out[..., 0], out[..., 1]
    valid = score >= 0
    n = valid.sum(1)
    if not bool((valid == (torch.arange(n_anchors, device=out.device) < n[:, None])).all()):
        fail("%s: the valid rows are not a prefix" % what)
    if not bool((n <= SSD_TOPK).all()):
        fail("%s: more than %d valid rows" % (what, SSD_TOPK))
    if bool(((score[:, 1:] > score[:, :-1]) & valid[:, 1:]).any()):
        fail("%s: valid rows are not sorted by score" % what)
    kept = cid >= 0
    if bool((kept & ~valid).any()) or bool((cid[kept] >= SSD_CLASSES).any()) \
            or bool((cid[~kept] != -1).any()):
        fail("%s: class ids outside [0, %d) or on invalid rows" % (what, SSD_CLASSES))
    box = out[..., 2:][valid]
    if bool(((box < 0) | (box > 1)).any()):
        fail("%s: a valid box outside [0, 1]" % what)
    if bool((out[~valid] != -1).any()):
        fail("%s: an invalid row is not all -1" % what)
    return n.tolist(), kept.sum(1).tolist()


def ssd_images(size, batch, seed):
    """A seeded synthetic VOC batch on the host: (data, labels)."""
    from mxnet_tpu_torch import train_ssd

    return train_ssd.synthetic_voc(np.random.RandomState(seed), batch, size, SSD_CLASSES)


def ssd_serve_path(kernels, net, anchors, size, label, card, batches, dev, seed, base):
    """One score path: for each batch size, a warm-up call, then timed calls
    (host clock, synchronised), each answer checked and one NMS launch each;
    the first batch-16 call under ``no_host_sync``.  Peak memory is counted
    above ``base``, the bytes allocated before the model was built.  ->
    (launches, the NMS calls of one batch-16 call and of the batch-1
    requests, report)."""
    from mxnet_tpu_torch import train_ssd

    score = train_ssd.make_score_step(net, anchors)
    expect = frcnn_expect(kernels)
    # batch 1: SSD_REQUESTS requests of one image each
    xs = {b: torch.from_numpy(ssd_images(size, SSD_REQUESTS if b == 1 else b, seed + b)[0])
          .to(dev) for b in batches}
    for b in batches:  # cuDNN and allocator set-up
        score(xs[b][:b])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    report = {}
    for b in batches:
        x = xs[b]
        reps = [x[i:i + 1] for i in range(SSD_REQUESTS)] if b == 1 else [x] * SSD_TIMED
        times = []
        for i, xi in enumerate(reps):
            before = counts(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0 and b == SSD_SERVE_BATCH:
                out = no_host_sync(lambda: score(xi), "the %s score step" % label)
            else:
                out = score(xi)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            valid, kept = ssd_check(out, b, anchors.shape[0], label)
            got = {n: c - before[n] for n, c in counts(kernels).items()}
            if got != expect:
                fail("%s score step launched %s, expected %s" % (label, got, expect))
        ms = statistics.median(times)
        report["batch%d" % b] = dict(ms=ms, all_ms=times, img_per_s=b / ms * 1e3)
        say("%s batch %d: %s ms, valid rows %s, kept after NMS %s" % (
            label, b, ", ".join("%.2f" % t for t in times), valid[:4], kept[:4]))
    launches = counts(kernels)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    x = xs[SSD_SERVE_BATCH]
    prof = device_profile(lambda: score(x), reps=3, top=6)
    # the NMS calls that the kernels phase compares: one batch-16 call first,
    # then the batch-1 requests
    requests = [xs[1][i:i + 1] for i in range(SSD_REQUESTS)] if 1 in batches else []
    nms = capture_calls(kernels, ["nms_alive"],
                        lambda: [score(xi) for xi in [x] + requests])["nms_alive"]
    for b in batches:
        r = report["batch%d" % b]
        say("%s on %s: batch %d, median %.2f ms, %.2f img/s" % (label, card, b, r["ms"],
                                                               r["img_per_s"]))
    say("%s on %s: peak memory %.2f GiB; batch %d: %s kernels a call, device busy %s ms, "
        "idle share %s; groups %s" % (
            label, card, peak, SSD_SERVE_BATCH, prof.get("kernels_per_call"),
            prof.get("device_busy_ms"), prof.get("idle_share"), json.dumps(prof)))
    report.update(peak_gib=peak, profile=prof)
    say("%s launches (%d calls): %s" % (label, sum(
        SSD_REQUESTS if b == 1 else SSD_TIMED for b in batches), json.dumps(launches)))
    return launches, nms, report


def phase_ssd_serve(kernels, dev, card):
    """SSD300 served in fp32 and, after ``cast("bfloat16")``, in bf16 (box
    math fp32) at batch 1 and 16; SSD512 in fp32 at batch 16."""
    from mxnet_tpu_torch.gluon.model_zoo import SSD300, SSD512, VGGSSD

    launches, nms, reports = {}, {}, {}
    for size, cfg, seed in ((300, SSD300, SEED + 51), (512, SSD512, SEED + 52)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        net = VGGSSD(SSD_CLASSES, cfg, device=dev,
                     generator=torch.Generator().manual_seed(seed))
        anchors = net.make_anchors(size)
        torch.cuda.synchronize()
        say("ssd%d serve: VGG16-reduced SSD, %d classes, %d anchors, %.1f M parameters, "
            "built in %.1f s" % (size, SSD_CLASSES, anchors.shape[0],
                                 sum(p.numel() for p in net.parameters()) / 1e6,
                                 time.perf_counter() - t0))
        dtypes = ("float32", "bfloat16") if size == 300 else ("float32",)
        for dtype in dtypes:
            label = "ssd%d_serve%s" % (size, "_bf16" if dtype == "bfloat16" else "")
            if dtype == "bfloat16":
                net.cast("bfloat16")
            batches = (1, SSD_SERVE_BATCH) if size == 300 else (SSD_SERVE_BATCH,)
            launches[label], nms[label], reports[label] = ssd_serve_path(
                kernels, net, anchors, size, label, card, batches, dev, seed, base)
        del net
        torch.cuda.empty_cache()
    return launches, nms, reports


def ssd_train_path(kernels, size, dtype, card, dev, seed):
    """One train path at full width: 1 warm-up step, one under
    ``no_host_sync``, SSD_TIMED timed steps on one seeded batch, each with
    finite loss parts and no ported kernel launched; masters and momentum
    fp32; the trunk's first conv and fc7, and at least half the tensors,
    moved.  -> (launches, report)."""
    from mxnet_tpu_torch import train_ssd
    from mxnet_tpu_torch.gluon.model_zoo import SSD300, SSD512, VGGSSD

    label = "ssd%d_train%s" % (size, "_bf16" if dtype else "")
    batch = SSD_TRAIN_BATCH[size]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # peak memory is counted above it
    net = VGGSSD(SSD_CLASSES, SSD300 if size == 300 else SSD512, device=dev,
                 generator=torch.Generator().manual_seed(seed))
    anchors = net.make_anchors(size)
    step, state = train_ssd.make_ssd_train_step(net, anchors, batch, learning_rate=SSD_LR,
                                                compute_dtype=dtype)
    data, gt = (torch.from_numpy(a).to(dev) for a in ssd_images(size, batch, seed))
    named = net.gluon_named_tensors()
    before = {n: t.detach().clone() for n, t in named.items()}
    expect = {n: 0 for n in kernels.KERNELS}

    def one(what):
        pre = counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss, parts = step(state, data, gt)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        parts = parts.tolist()
        if not all(math.isfinite(v) for v in parts) or not parts[0] > 0:
            fail("%s %s: loss parts %s" % (label, what, parts))
        got = {n: c - pre[n] for n, c in counts(kernels).items()}
        if got != expect:
            fail("%s %s launched %s, expected no ported kernel" % (label, what, got))
        return ms, parts

    ms, parts = one("warm-up step")
    say("%s warm-up step: batch %d, %.2f ms, loss parts (cls, loc) %.4f %.4f"
        % (label, batch, ms, *parts))
    no_host_sync(lambda: step(state, data, gt), "the %s step" % label)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for i in range(SSD_TIMED):
        ms, parts = one("step %d" % (i + 1))
        times.append(ms)
        say("%s step %d: batch %d, %.2f ms, loss parts (cls, loc) %.4f %.4f"
            % (label, i + 1, batch, ms, *parts))
    launches = counts(kernels)
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    # a head whose anchors are neither positive nor mined negative in the
    # batch gets no gradient: only the trunk must move
    moved = [n for n, t in named.items() if not torch.equal(t, before[n])]
    need = ["conv2d0_weight", "conv2d14_weight"]
    if any(n not in moved for n in need) or 2 * len(moved) < len(named):
        fail("%s: the first conv, fc7 and half the tensors must move; %d moved, still: %s"
             % (label, len(moved), [n for n in named if n not in moved]))
    kinds = {(p.dtype, m.dtype) for p, m in zip(*state)}
    if kinds != {(torch.float32, torch.float32)}:
        fail("%s: masters and momentum must stay fp32, got %s" % (label, kinds))
    prof = device_profile(lambda: step(state, data, gt), reps=1, top=6)
    med = statistics.median(times)
    say("%s on %s: batch %d, median %.2f ms (%s), %.2f img/s, peak memory %.2f GiB; %s "
        "kernels a step, device busy %s ms, idle share %s; %d of %d tensors moved; groups %s"
        % (label, card, batch, med, ", ".join("%.2f" % t for t in times), batch / med * 1e3,
           peak, prof.get("kernels_per_call"), prof.get("device_busy_ms"),
           prof.get("idle_share"), len(moved), len(named), json.dumps(prof)))
    del net, step, state
    torch.cuda.empty_cache()
    return launches, dict(ms=med, all_ms=times, img_per_s=batch / med * 1e3, peak_gib=peak,
                          profile=prof, loss_parts=parts, moved=len(moved), tensors=len(named))


def phase_ssd_train(kernels, dev, card):
    """The SSD train step at full width: SSD300 in fp32 and bf16
    (``compute_dtype="bfloat16"``, fp32 masters), SSD512 in fp32."""
    launches, reports = {}, {}
    for size, dtype, seed in ((300, None, SEED + 53), (300, "bfloat16", SEED + 54),
                              (512, None, SEED + 55)):
        label = "ssd%d_train%s" % (size, "_bf16" if dtype else "")
        launches[label], reports[label] = ssd_train_path(kernels, size, dtype, card, dev, seed)
    return launches, reports


def nms_at_ssd_sizes(kernels, calls):
    """NMS on the SSD score steps' own calls (per-class ids, ``plus_one``
    0, at most 400 valid rows an image): each captured call (one batch-16
    call of each score path, and SSD300's batch-1 requests) bit for bit
    against the plain version; at SSD300's N = 8,732 (137 words, the staged
    scan) and SSD512's N = 24,564 (384 words, ``nms_scan_kernel_global``)
    at batch 16 the kernel's device time, the plain version's, the bound
    and the device operations of one call.  -> keys for the NMS row."""
    k = kernels.KERNELS["nms_alive"]
    for label, cl in calls.items():
        for args, kw in cl:
            got, ref = k.wrapper(*args, **kw), k.plain(*args, **kw)
            torch.cuda.synchronize()
            compare("nms_alive", got, ref)
    out = {}
    for label, scan in (("ssd300_serve", "staged"), ("ssd512_serve", "global")):
        args, kw = calls[label][0]
        B, n = args[1].shape
        words = -(-n // 64)
        if args[2] is None:
            fail("%s: the NMS call has no class ids" % label)
        ms = time_ms(lambda: k.wrapper(*args, **kw), 20)
        plain_ms = time_ms(lambda: k.plain(*args, **kw), 3)
        alive = k.wrapper(*args, **kw)
        bound_ms, bound_by = bound(*work("nms_alive", args, alive))
        ops = device_ops(lambda: k.wrapper(*args, **kw))
        ran_global = any("nms_scan_kernel_global" in o for o in ops)
        ran_staged = any("nms_scan_kernel" in o and "global" not in o for o in ops)
        if (scan == "global") != ran_global or (scan == "staged") != ran_staged:
            fail("nms at N=%d did not run the %s scan alone: %s" % (n, scan, ops))
        # the device time of each of the two kernels
        split = {"mask": "not measured", "scan": "not measured"}
        prof = device_profile(lambda: k.wrapper(*args, **kw), reps=3, top=4)
        for kms, _, kname in prof.get("top_kernels_ms_count_name", []):
            for part, kernel in (("mask", "nms_mask_kernel"), ("scan", "nms_scan_kernel")):
                if kernel in kname:
                    split[part] = kms
        key = label.split("_")[0]
        say("kernel nms_alive at the %s score size: B %d, N %d, %d words, %d valid and %d "
            "kept, scratch %.1f MB; %.4f ms (plain %.4f ms; nms_mask_kernel %s ms, %s scan "
            "%s ms), bound %.6f ms by %s, bit-identical over %d calls; device ops %s" % (
                key, B, n, words, int(args[1].sum()), int(alive.sum()),
                B * n * words * 8 / 1e6, ms, plain_ms, split["mask"], scan, split["scan"],
                bound_ms, bound_by, sum(len(c) for c in calls.values()), ops))
        out.update({key + "_batch": B, key + "_n": n, key + "_words": words, key + "_ms": ms,
                    key + "_plain_ms": plain_ms, key + "_bound_ms": bound_ms,
                    key + "_scan": scan, key + "_mask_kernel_ms": split["mask"],
                    key + "_scan_kernel_ms": split["scan"]})
    return out


def phase_small_ssd(dev):
    """The tiny SSD (the JAX example's CPU smoke at width 0.125: 128², 3
    classes, 1,528 anchors) on the card against the CPU from the same
    weights, stage by stage as ``phase_small_frcnn``: the forward, then
    MultiBoxDetection fed the CPU's probabilities and offsets (the devices'
    forwards differ in the last bits, enough to reorder near-equal scores),
    the whole score step's answer checked; then one fp32 train step's loss
    parts and updated weights."""
    got, ref = small_ssd_card_and_cpu(dev)
    for k in ("cls_preds", "box_preds"):
        torch.testing.assert_close(got[k], ref[k], rtol=1e-4,
                                   atol=1e-4 * float(ref[k].abs().max()),
                                   msg=lambda m, k=k: "small ssd %s: %s" % (k, m))
    if not torch.equal(got["det"][..., 0], ref["det"][..., 0]):
        fail("small ssd: the card's detections' classes differ from the CPU's in %d rows"
             % int((got["det"][..., 0] != ref["det"][..., 0]).sum()))
    torch.testing.assert_close(got["det"], ref["det"], rtol=1e-6, atol=1e-6,
                               msg=lambda m: "small ssd detections: %s" % m)
    ssd_check(got["score"], 2, 1528, "small ssd score step")
    torch.testing.assert_close(got["parts"], ref["parts"], rtol=1e-4, atol=1e-5,
                               msg=lambda m: "small ssd loss parts: %s" % m)
    for k, r in ref["weights"].items():
        torch.testing.assert_close(got["weights"][k], r, rtol=1e-4, atol=1e-6,
                                   msg=lambda m, k=k: "small ssd %s after a step: %s" % (k, m))
    say("small input, ssd: the card agrees with the CPU on the forward, on every class id of "
        "MultiBoxDetection (%d kept detections), and over one train step (loss parts %s; "
        "three updated weights)" % (int((ref["det"][..., 0] >= 0).sum()),
                                    ", ".join("%.5f" % v for v in got["parts"].tolist())))


def small_ssd_card_and_cpu(dev):
    """The tiny SSD's stages on the card and on the CPU from the same weights
    and batch: -> (card, cpu) dicts of the forward's outputs, the detections
    of the CPU's probabilities and offsets, the whole score step's answer,
    one train step's loss parts and three weights after it (all on the
    CPU)."""
    from mxnet_tpu_torch import train_ssd
    from mxnet_tpu_torch.gluon.model_zoo import VGGSSD
    from mxnet_tpu_torch.ops import detection as ops_det

    cfg = train_ssd.tiny_config()
    cpu = VGGSSD(3, cfg, width=0.125, device="cpu",
                 generator=torch.Generator().manual_seed(SEED))
    gpu = VGGSSD(3, cfg, width=0.125, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    data, gt = (torch.from_numpy(a) for a in train_ssd.synthetic_voc(
        np.random.RandomState(SEED), 2, 128, 3))
    fed = None
    res = []
    for net, d in ((cpu, torch.device("cpu")), (gpu, dev)):
        anchors = net.make_anchors(128)
        with torch.inference_mode():
            cls, box = net(data.to(d))
            if fed is None:
                fed = (torch.softmax(cls, -1).transpose(1, 2).contiguous(), box)
            det = ops_det.multibox_detection(fed[0].to(d), fed[1].to(d), anchors[None],
                                             nms_threshold=0.45, nms_topk=400)
        out = dict(cls_preds=cls.cpu(), box_preds=box.cpu(), det=det.cpu(),
                   score=train_ssd.make_score_step(net, anchors)(data.to(d)))
        step, state = train_ssd.make_ssd_train_step(net, anchors, 2)
        _, _, parts = step(state, data.to(d), gt.to(d))
        named = net.gluon_named_tensors()
        out.update(parts=parts.cpu(), weights={k: named[k].detach().cpu() for k in (
            "conv2d0_weight", "conv2d14_weight", "conv2d19_weight")})
        res.append(out)
    return res[1], res[0]


def module_mlp():
    """bench.py main_module's symbol, on the port's frontend."""
    from mxnet_tpu_torch import symbol as sym

    data = sym.var("data")
    h = sym.Activation(sym.FullyConnected(data, name="fc1", num_hidden=256), name="a1",
                       act_type="relu")
    h = sym.Activation(sym.FullyConnected(h, name="fc2", num_hidden=256), name="a2",
                       act_type="relu")
    return sym.SoftmaxOutput(sym.FullyConnected(h, name="fc3", num_hidden=10),
                             name="softmax")


def cross_entropy(mod, label):
    """The mean cross-entropy of a Module's softmax output against
    ``label`` (read to the host)."""
    p = mod.get_outputs()[0]
    pick = p.gather(1, label.long().reshape(-1, 1)).reshape(-1)
    return float(-torch.log(pick).mean())


def module_step(mod, batch):
    mod.forward_backward(batch)
    mod.update()


def phase_module_mlp(kernels, dev, card):
    """bench.py MXNET_BENCH=module on the card: see MODULE_BATCH.  The
    cross-entropy on the fixed batch must fall from the warm-up step to the
    last; no ported kernel launches; one step makes no host
    synchronisation.  -> (launch counts, report)."""
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.module import Module

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(MODULE_BATCH, 128).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 10, (MODULE_BATCH,)).astype(np.float32)).to(dev)
    batch = DataBatch([x], [y])
    kernels.reset_launches()
    mod = Module(module_mlp(), device=dev)
    mod.bind(data_shapes=[("data", (MODULE_BATCH, 128))],
             label_shapes=[("softmax_label", (MODULE_BATCH,))])
    mod.init_params()
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
    if mod._optimizer.rescale_grad != 1.0 / MODULE_BATCH:
        fail("module mlp: rescale_grad %g" % mod._optimizer.rescale_grad)
    module_step(mod, batch)  # warm-up
    first = cross_entropy(mod, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MODULE_ITERS):
        module_step(mod, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    last = cross_entropy(mod, y)
    if not (math.isfinite(first) and math.isfinite(last) and last < first):
        fail("module mlp: cross-entropy %.5f -> %.5f did not fall" % (first, last))
    no_host_sync(lambda: module_step(mod, batch), "a module mlp forward_backward + update")
    prof = device_profile(lambda: module_step(mod, batch), reps=1, top=6)
    launches = counts(kernels)
    if any(launches.values()):
        fail("the module mlp path launched %s" % launches)
    ms = seconds / MODULE_ITERS * 1e3
    res = dict(step_ms=ms, samples_per_s=MODULE_BATCH / seconds * MODULE_ITERS,
               first_cross_entropy=first, last_cross_entropy=last, profile=prof)
    say("module mlp (bench.py MXNET_BENCH=module) on %s: batch %d, %d timed steps, %.3f ms "
        "a step, %.1f samples/s; cross-entropy %.5f (warm-up step) -> %.5f (step %d); %s "
        "kernels a step, device busy %s ms, idle share %s" % (
            card, MODULE_BATCH, MODULE_ITERS, ms, res["samples_per_s"], first, last,
            MODULE_ITERS + 1, prof.get("kernels_per_call"), prof.get("device_busy_ms"),
            prof.get("idle_share")))
    say("module mlp device groups: %s" % json.dumps(prof))
    return launches, res


def fixed_gamma_trajectory(start, steps, lr, wd, momentum):
    """A fix_gamma BatchNorm's gamma after ``steps`` SGD updates: its
    gradient is 0, so only weight decay moves it, in ``SGD.update_multi``'s
    order of operations."""
    w, mom = start.clone(), torch.zeros_like(start)
    for _ in range(steps):
        g = torch.zeros_like(w) + w * wd
        mom = mom * momentum - g * lr
        w = w + mom
    return w


def phase_module_cifar(kernels, dev, card):
    """train_cifar10.py's defaults through Module.fit on the card: see
    CIFAR.  Every loss finite, every BatchNorm moving statistic and every
    weight moved, the fix_gamma gamma with a zero gradient and moved by
    weight decay alone; score on held-out batches; one step makes no host
    synchronisation; no ported kernel launches.  -> (launch counts,
    report)."""
    from mxnet_tpu_torch.callback import Speedometer
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.lr_scheduler import MultiFactorScheduler
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol
    from mxnet_tpu_torch.module import Module

    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    n = CIFAR_BATCH * (CIFAR_BATCHES + CIFAR_SCORE_BATCHES)
    rng = np.random.RandomState(SEED + 51)
    shape = tuple(int(v) for v in CIFAR["image_shape"].split(","))
    x = torch.from_numpy(rng.randn(n, *shape).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 10, (n,)).astype(np.float32)).to(dev)
    m = CIFAR_BATCH * CIFAR_BATCHES
    train = NDArrayIter(x[:m], y[:m], batch_size=CIFAR_BATCH)
    held_out = NDArrayIter(x[m:], y[m:], batch_size=CIFAR_BATCH)
    kernels.reset_launches()
    t0 = time.perf_counter()
    sym = get_symbol(**CIFAR)
    mod = Module(sym, device=dev)
    mod.bind(data_shapes=train.provide_data, label_shapes=train.provide_label)
    init = Xavier(rnd_type="gaussian", factor_type="in", magnitude=2,
                  generator=torch.Generator().manual_seed(SEED + 52))
    mod.init_params(initializer=init)
    arg0, aux0 = (({k: v.clone() for k, v in d.items()}) for d in mod.get_params())
    say("module cifar: ResNet-%d, %s, %d classes, %.2f M parameters, %d BatchNorms, bound "
        "and initialised in %.1f s" % (
            CIFAR["num_layers"], CIFAR["image_shape"], CIFAR["num_classes"],
            sum(v.numel() for v in arg0.values()) / 1e6, len(aux0) // 2,
            time.perf_counter() - t0))
    steps = [lr * CIFAR_EPOCH_UPDATES for lr in CIFAR_LR_STEP_EPOCHS]
    optimizer_params = dict(CIFAR_SGD, lr_scheduler=MultiFactorScheduler(
        step=steps, factor=CIFAR_LR_FACTOR))
    marks, losses = [], []

    def on_batch(param):  # the metric's read has synchronised the step
        marks.append(time.perf_counter())
        losses.append(cross_entropy(mod, param.locals["data_batch"].label[0]))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod.fit(train, eval_metric="acc", optimizer="sgd", optimizer_params=optimizer_params,
            initializer=init, batch_end_callback=[Speedometer(CIFAR_BATCH, 4), on_batch],
            num_epoch=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    first_s = marks[0] - t0
    times = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    score = dict(mod.score(held_out, "acc"))
    if len(losses) != CIFAR_BATCHES or not all(math.isfinite(v) for v in losses):
        fail("module cifar: losses %s" % losses)
    arg1, aux1 = mod.get_params()
    still = [k for k, v in aux1.items() if torch.equal(v, aux0[k])]
    if still:
        fail("module cifar: %d moving statistics did not move: %s" % (len(still), still[:3]))
    still = [k for k, v in arg1.items() if k.endswith("_weight") and torch.equal(v, arg0[k])]
    if still:
        fail("module cifar: %d weights did not move: %s" % (len(still), still[:3]))
    fixed = [node.name + "_gamma" for node in sym._walk()
             if not node.is_var and node.op.name == "BatchNorm"
             and node.attrs.get("fix_gamma", True)]
    for k in fixed:
        want = fixed_gamma_trajectory(arg0[k], CIFAR_BATCHES, CIFAR_SGD["learning_rate"],
                                      CIFAR_SGD["wd"], CIFAR_SGD["momentum"])
        if mod._exec.grad_dict[k].any():
            fail("module cifar: fix_gamma %s got a gradient" % k)
        torch.testing.assert_close(arg1[k], want, rtol=1e-6, atol=0,
                                   msg=lambda m, k=k: "module cifar %s: %s" % (k, m))
    batch = next(iter(train))
    no_host_sync(lambda: module_step(mod, batch), "a module cifar forward_backward + update")
    prof = device_profile(lambda: module_step(mod, batch), reps=1, top=8)
    launches = counts(kernels)
    if any(launches.values()):
        fail("the module cifar path launched %s" % launches)
    ms = statistics.median(times)
    res = dict(step_ms=ms, steps_ms=times, img_per_s=CIFAR_BATCH / ms * 1e3,
               first_step_s=first_s, losses=losses, score=score, peak_gib=peak, profile=prof)
    say("module cifar (train_cifar10.py defaults, Module.fit) on %s: batch %d, first step "
        "%.2f s, median %.2f ms a step (%s), %.1f img/s, peak memory %.2f GiB, losses %s, "
        "held-out %s; %s kernels a step, device busy %s ms, idle share %s; fix_gamma "
        "gammas %s: zero gradient, weight decay only" % (
            card, CIFAR_BATCH, first_s, ms, ", ".join("%.2f" % t for t in times),
            CIFAR_BATCH / ms * 1e3, peak, ", ".join("%.4f" % v for v in losses), score,
            prof.get("kernels_per_call"), prof.get("device_busy_ms"),
            prof.get("idle_share"), fixed))
    say("module cifar device groups: %s" % json.dumps(prof))
    return launches, res


def phase_small_module(dev):
    """One Module step of the CIFAR ResNet-8 (batch 4, 3x28x28) on the card
    and on the CPU from the same carried-in weights (Xavier from a seeded
    CPU generator) and batch: the loss, two weights' updates and a moving
    variance within 1e-4."""
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.models.resnet_symbol import get_symbol
    from mxnet_tpu_torch.module import Module

    cpu = torch.device("cpu")
    rng = np.random.RandomState(SEED + 53)
    x = torch.from_numpy(rng.randn(4, 3, 28, 28).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (4,)).astype(np.float32))
    out, start = [], None
    names = ("conv0_weight", "stage3_unit1_conv2_weight")
    var = "stage2_unit1_bn1_moving_var"
    for d in (cpu, dev):
        mod = Module(get_symbol(10, 8, "3,28,28"), device=d)
        mod.bind(data_shapes=[("data", (4, 3, 28, 28))], label_shapes=[("softmax_label", (4,))])
        if start is None:
            mod.init_params(Xavier(rnd_type="gaussian", factor_type="in", magnitude=2,
                                   generator=torch.Generator().manual_seed(SEED + 53)))
            start = tuple({k: v.clone() for k, v in p.items()} for p in mod.get_params())
        else:
            mod.init_params(arg_params=start[0], aux_params=start[1])
        mod.init_optimizer(optimizer="sgd", optimizer_params=CIFAR_SGD)
        mod.forward_backward(DataBatch([x.to(d)], [y.to(d)]))
        mod.update()
        arg, aux = mod.get_params()
        out.append((cross_entropy(mod, y.to(d)), {k: arg[k].cpu() - start[0][k] for k in names},
                    aux[var].cpu()))
    (ref_loss, ref_upd, ref_var), (got_loss, got_upd, got_var) = out
    if not math.isclose(got_loss, ref_loss, rel_tol=1e-4):
        fail("small module: loss %.6f against %.6f" % (got_loss, ref_loss))
    for k, r in ref_upd.items():
        torch.testing.assert_close(got_upd[k], r, rtol=1e-4, atol=1e-4 * float(r.abs().max()),
                                   msg=lambda m, k=k: "small module %s update: %s" % (k, m))
    torch.testing.assert_close(got_var, ref_var, rtol=1e-4, atol=1e-6,
                               msg=lambda m: "small module %s: %s" % (var, m))
    say("small input, module: one CIFAR ResNet-8 Module step on the card agrees with the CPU "
        "(loss %.6f / %.6f; %s updates; %s)" % (got_loss, ref_loss, ", ".join(names), var))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        from mxnet_tpu_torch.ops import kernels
    except ImportError as e:
        fail("the port (mxnet_tpu_torch) is not importable next to this "
             "script: %s" % e)
    t_start = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        say("phase %s: %.1f s" % (name, seconds[name]))
        return out

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = phase("device", phase_device)
    phase("build", phase_build)
    net, gen, serve_launches = phase("serve", phase_serve, kernels, dev)
    train_launches, bwd_captured, train_nms = phase("train", phase_train, kernels, net,
                                                    dev, name)
    net_bf16, serve_bf16_launches = phase("serve_bf16", phase_serve_bf16, kernels, dev)
    train_bf16_launches, bwd_captured_bf16 = phase("train_bf16", phase_train_bf16,
                                                   kernels, net, dev, name)
    int8_launches, int8_captured, int8_expect = phase("int8", phase_int8, kernels, dev, name)
    resnet_launches = phase("resnet", phase_resnet_train, kernels, dev, name)
    phase("resnet_card_vs_cpu", phase_resnet_card_vs_cpu, dev)
    frcnn_net, frcnn_serve_launches, frcnn_serve = phase(
        "frcnn_serve", phase_frcnn_serve, kernels, dev, name)
    frcnn_train_launches, frcnn_bf16_launches, frcnn_nms, frcnn_train = phase(
        "frcnn_train", phase_frcnn_train, kernels, frcnn_net, dev, name)
    frcnn_serve_bf16_launches, frcnn_serve_bf16 = phase(
        "frcnn_serve_bf16", phase_frcnn_serve_bf16, kernels, frcnn_net, dev, name)
    del frcnn_net
    torch.cuda.empty_cache()
    say("frcnn: %s" % json.dumps({"serve": frcnn_serve, "train": frcnn_train,
                                  "serve_bf16": frcnn_serve_bf16}))
    module_mlp_launches, module_mlp_res = phase("module_mlp", phase_module_mlp, kernels, dev,
                                                name)
    module_cifar_launches, module_cifar_res = phase("module_cifar", phase_module_cifar,
                                                    kernels, dev, name)
    say("module: %s" % json.dumps({"mlp": module_mlp_res, "cifar": module_cifar_res}))
    ssd_serve_launches, ssd_nms, ssd_serve = phase("ssd_serve", phase_ssd_serve, kernels, dev,
                                                   name)
    ssd_train_launches, ssd_train = phase("ssd_train", phase_ssd_train, kernels, dev, name)
    say("ssd: %s" % json.dumps({"serve": ssd_serve, "train": ssd_train}))
    launches = {"serve": serve_launches, "train": train_launches,
                "serve_bf16": serve_bf16_launches, "train_bf16": train_bf16_launches,
                "int8": int8_launches, "resnet_train": resnet_launches,
                "frcnn_serve": frcnn_serve_launches, "frcnn_train": frcnn_train_launches,
                "frcnn_train_bf16": frcnn_bf16_launches,
                "frcnn_serve_bf16": frcnn_serve_bf16_launches,
                "module_mlp": module_mlp_launches, "module_cifar": module_cifar_launches,
                **ssd_serve_launches, **ssd_train_launches}

    def kernel_rows():
        rows = phase_kernels(kernels, net, launches, bwd_captured, train_nms, dev)
        nms_row = next(r for r in rows if r["name"] == "nms_alive")
        nms_row.update(nms_at_train_size(kernels, frcnn_nms))
        nms_row.update(nms_at_ssd_sizes(kernels, ssd_nms))
        rows += phase_kernels(kernels, net_bf16, launches, bwd_captured_bf16, (), dev,
                              bf16=True)
        edge = int8_edge_calls(kernels, dev)
        for pair_name in INT8_PAIR:
            # timed on the call with the most elements: its 100 MB of float32
            # exceed the 50 MB L2, which the 20 calls in a row would otherwise
            # serve from
            calls = int8_captured[pair_name]
            largest = max(range(len(calls)), key=lambda i: calls[i][0][0].numel())
            rows.append(kernel_row(pair_name, kernels.KERNELS[pair_name], calls,
                                   int8_expect[pair_name], launches, "int8",
                                   extra_calls=edge[pair_name], timed_call=largest))
        return rows

    rows = phase("kernels", kernel_rows)
    del net, net_bf16, int8_captured, bwd_captured, bwd_captured_bf16, train_nms, frcnn_nms
    del ssd_nms
    torch.cuda.empty_cache()
    phase("small_input", phase_small_input, dev)
    phase("small_train", phase_small_train, dev)
    phase("small_train_bn", phase_small_train, dev, frozen_bn=False)
    phase("small_resnet", phase_small_resnet, dev)
    phase("small_input_bf16", phase_small_input_bf16, dev)
    phase("small_int8", phase_small_int8, dev)
    phase("small_frcnn", phase_small_frcnn, dev)
    phase("small_module", phase_small_module, dev)
    phase("small_ssd", phase_small_ssd, dev)
    say("phases (s): %s" % json.dumps(seconds))
    say("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
