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
7b. imperative: the imperative frontend (``mx.nd``, ``autograd``,
   ``gluon.Trainer``).  ``imperative_rfcn``: the port's copy of
   ``examples/deformable_rfcn/train.py`` as the example runs (3 epochs x 6
   batches, 3x64x64, batch 2, its loss falling), with every path kernel
   (``dconv_col``, ``dconv_col_bwd``, ``nms_alive``, ``psroi_abuild``,
   ``psroi_abuild_bwd``) launched; its ``--bench`` at 3x64x64 and
   3x512x512, 10 steps each (ms and launches a step), the five kernels'
   calls of one more step at each shape held against their plain versions
   in the kernel rows; at each shape its first steps (2 at 64x64, 3 at
   512x512) against the CPU's from the same weights, batch and anchor
   sampling (the first step's losses within rtol ``IMPERATIVE_RFCN_RTOL``,
   its update of the parameters and the later losses within
   ``IMPERATIVE_RFCN_UPDATE_RTOL``).  ``imperative_resnet``: ResNet-50 v1
   at 224², batch 32, 3 steps of ``autograd.record`` -> softmax
   cross-entropy -> ``backward`` -> ``Trainer("sgd", lr 0.1, momentum 0.9,
   wd 1e-4)`` against ``make_train_step`` with the same SGD (its weight
   decay the gradient of (wd/2)·Σ‖p‖² added to the loss) from the same
   weights on the same batches, under deterministic cuDNN, in fp32 timed in
   turns (a second ``make_train_step`` run must repeat the first's bits)
   and in float64 (beside a ``make_train_step`` run started one ulp up,
   which shows how far the trajectory carries a rounding): losses and the
   weights after every step within ``IMPERATIVE_RESNET_RTOL``, no ported
   kernel launched;
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
8g. lstm_bucketing: the LSTM bucketing language model
   (``mxnet_tpu_torch/examples/rnn/lstm_bucketing.py``) at the PTB width of
   the reference's example (2 LSTM layers x 200, embed 200, batch 32,
   buckets 10-60, vocabulary 10,000, Adam lr 0.01 wd 1e-5) on the example's
   synthetic corpus cut into 5-60 token sentences: each bucket's first
   batch on the card against the CPU from the same weights (loss and the
   whole update within rtol 1e-5), then one epoch of
   ``BucketingModule.fit`` (Perplexity, Speedometer) with each stack: the
   perplexity falls, median ms a batch of each bucket, kernels a batch and
   peak memory; no ported kernel launched; last, the FusedRNNCell stack
   (the ``RNN`` op) against its ``unfuse()`` on the card (1e-5), on the
   cell stack's weights after its epoch;
8h. image classification, after lstm_bucketing.  ``imagenet_alexnet``:
   ``train_imagenet.py --network alexnet --benchmark 1`` through the port's
   ``fit.fit`` (the script's defaults: batch 128, 3x224x224, 1,000 classes,
   sgd lr 0.1 momentum 0.9 wd 1e-4, Xavier(gaussian, in, 2), the ``device``
   kvstore, ``--top-k 5``; one tower, 50.8 M parameters, two LRNs a
   forward), first its first two batches on the card against the CPU from
   the same weights and keep masks through Module and the kvstore as
   fit.fit runs them (TF32 off; in float32 the first loss within 1e-5, the
   second within 1e-3 and the card's first update no further from the
   float64 update than twice the CPU's; bound in float64 both losses and
   the first update within 1e-10; each card run then goes on alone for 6
   steps, printing the divergence of the recipe at lr 0.1), then one epoch
   of SyntheticDataIter's 50 batches at the defaults and one at lr 0.01,
   whose weights stay finite: ms a batch and img/s over the last 40, peak
   memory, one profiled step.  ``mnist_lenet_stn``: LeNet with its
   spatial transformer (``lenet.get_symbol(add_stn=True)``) through
   ``fit.fit`` on ``train_mnist.py``'s stand-in data, 40 batches of 64 at lr
   0.01 (see LENET_ARGS): the first batch against the CPU within 1e-5;
   three card epochs and one CPU epoch from one seed, each one's held-out
   accuracy up by 0.4, and one card epoch at the script's lr 0.05
   printed; ``stn_loc`` moved.  ``python_loss``: the
   port's ``examples/module/python_loss.py`` (SequentialModule of an MLP
   Module and a PythonLossModule hinge): 8 epochs above accuracy 0.9, the
   first epoch's scores against the CPU within 1e-5.  ``optimizers``: one
   gradient on AlexNet's parameters under each new optimizer (and
   multi_precision on bf16 weights for SGD, NAG and Adam), the card within
   1e-6 of the CPU, ms a step.  ``registry_ops``: the 55 operators of the
   slice at the CPU tests' cases (``test_utils.registry_cases``), CTC at
   (200, 16, 29) and Deconvolution at an FCN-32s head, forward and
   gradients against the CPU port (gelqf / syevd up to each row's sign).
   None of these paths launches a ported kernel;
8c. ssd: the SSD path of BASELINE config 5 (``examples/ssd/train_fused.py``,
   VGG16-reduced, 20 classes, seeded Xavier weights, synthetic VOC images).
   ``ssd_serve``: the score step (forward, fp32 softmax, MultiBoxDetection
   at NMS 0.45, top 400) of SSD300 (8,732 anchors) in fp32 and, after
   ``cast("bfloat16")``, in bf16, each with three single-image requests and
   three batches of 16, and of SSD512 (24,564 anchors) in fp32 and bf16 at
   batch 16;
   every answer checked (shape, finite, valid rows a sorted prefix of at
   most 400, class range, boxes in [0, 1]) with one NMS launch a call and
   no other kernel, the first batch of 16 under
   ``set_sync_debug_mode("error")``; ms, img/s, peak memory, kernels a call,
   busy and idle share.  ``ssd_train``: the train step (MultiBoxTarget with
   3:1 mining, the two losses, momentum SGD 0.9 at lr 1e-3) of SSD300 at
   batch 8 and of SSD512 at batch 4, each in fp32 and bf16
   (``compute_dtype``): a warm-up step, one under the sync check and three
   timed steps,
   finite loss parts, no ported kernel launched, fp32 masters; ms, img/s,
   peak memory, profile.  The kernels phase holds one batch-16 NMS call of
   each score path, and the batch-1 requests' calls, bit for bit against
   the plain version and times it at
   N 8,732 (the staged scan) and N 24,564 (``nms_scan_kernel_global``, the
   fp32 and the bf16 score path), checking which scan ran: the C entry's
   launch rule names it, and the profiler's device operations, where they
   name a scan, must name that one.
   ``map_ssd300``: the SSD300 detection-quality gate at its full recipe
   (``quality.eval_ssd_map``: 3 classes, 2,000 bf16 steps at batch 4 on the
   device data stream with warm-up and step decays, the fp32 score step over
   500 held-out images, ``VOCMApMetric``) at seed 0: one NMS launch an eval
   image and no other kernel, the mAP at or above the port's single-run
   floor (``quality.gate_map.SINGLE_RUN_FLOORS``), steps/s and seconds;
8f. map_rfcn_eval (after train_bf16) and map_frcnn_eval (after frcnn_train):
   the gates' eval path at full width (``quality.eval_*_map.evaluate``:
   fp32 forward, the decode, its per-class ``box_nms`` on the card at B 1,
   N 512, ``VOCMApMetric``) over 20 held-out images, on the gates' 3-class
   eval nets (R-FCN with live BatchNorm, Faster R-CNN at TEST counts
   6000/300) holding the serve / frcnn phases' trunk and RPN weights: each
   image launches a serve forward's kernels plus one NMS, every decode's
   detections well formed (at most 100 rows, classes, falling scores >=
   0.05, boxes inside the image), mAP finite in [0, 1] (a random head: not
   a quality figure); the kernels phase holds each decode call bit for bit
   against the plain version and times one (staged scan);
8d. predictor: bench.py's ``MXNET_BENCH=predictor`` (the deploy twin of
   ``test_utils.deploy_twin_checkpoint``, batch 16, 32x32) as an fp32
   ``Predictor`` and its ``with_precision("bf16")`` and calibrated
   ``with_precision("int8", calibrate(...))`` twins: each tier's first
   forward (the plan's build) timed apart, then 3 windows of 200 forwards
   (ms a forward, samples/s) under ``set_sync_debug_mode("error")``, one
   profile (kernels a forward, busy, idle share), the pass rows, ``check()``
   (warnings at most), and each twin within its tier's tolerance of the
   fp32 outputs; no ported kernel.  ``predictor_resnet``: ResNet-50 v2
   (INT8's symbol) written to files and served through ``Predictor`` at
   batch 1 and 32, fp32, bf16 tier and int8 tier (calibrated on 4 batches
   of 8), the same numbers plus peak memory, the bf16 tier's folded
   BatchNorms and cast nodes, the int8 tier's sites, and fc1's logits of
   each twin against fp32's on 32 images: relative L2 errors, plain and
   centred on the batch mean, gated at ``LOGIT_LIMITS``, which must reject
   two broken controls (top-1 agreement reported, not gated); then
   ``quantize_model``'s int8 symbol (naive, fc1 excluded) written to files
   and served through ``Predictor``: one ``quantize_int8`` per int8
   quantize node and one ``dequantize_int8`` per dequantize node of int8
   input a forward, no host sync, outputs equal bit for bit to a bare
   ``Executor`` of the same symbol with the graph passes off (its launches
   are not the path's and are taken out of the phase's count, which must
   equal launches a forward times the Predictors' forwards), and the pass
   rows;
8e. serve_engine: ``predictor_resnet``'s files served through the serving
   layer.  (a) an fp32 ``serving.Engine`` on ``pow2_ladder(32)``, warmed up
   (six fresh buckets, each one's compile seconds printed) before 8
   closed-loop clients send 240 requests of 1-8 N(0, 1) images and 2 of 40
   (direct dispatch): compiles after warmup only the direct signature's,
   every reply (n, 1000), finite, rows summing to 1 within 1e-5, and equal
   bit for bit to a Predictor of its bucket on the same rows at the same
   offsets; requests/s, samples/s, p50 / p99, batches, fill, padding waste,
   peak memory and one profiled batch of 32; (b) the ``quantize_model``
   deploy through an Engine on (1, 8, 32), 40 of (a)'s requests from 4
   clients: ``quantize_int8`` / ``dequantize_int8`` launched 49 / 53 times
   (the Predictor's count a forward) per Engine forward (warmup's plus its
   batches), replies equal to the bucket's Predictor, top-1 agreement with
   (a); (c) a ``Router`` over ``ModelRegistry.register(..., tiers=("fp32",
   "bf16", "int8"), calibration=<predictor_resnet's table>)``: paid traffic
   alone all on fp32 with no downgrade, a best_effort flood that must
   degrade best_effort to bf16 within 30 s while paid stays on fp32, the
   route back to fp32 within hold_s + 5 s after the flood, 8 requests
   through the int8 pool, every pool's replies equal to its twin's bucket
   Predictor; no ported kernel launched in (a) or (c);
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
   and one train step's loss parts and weights; the tiny deploy twin and
   a CIFAR ResNet-8 v2 as Predictors in the three tiers (fp32 within rtol
   1e-4, the twins within their tier's tolerance).

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
calls, each bf16 output within one bf16 ulp.  Phase 5 runs after phase 8e.

The second-to-last line is the kernels JSON object, the last line
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
import json
import logging
import math
import statistics
import subprocess
import sys
import tempfile
import threading
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
# the port's copy of examples/deformable_rfcn/train.py: the example's own
# run at its defaults (3 epochs x 6 batches, 3x64x64, batch 2), then
# --bench at these shapes (the five kernels' calls of one bench step at each
# held against their plain versions in the kernel rows); then at each shape
# the first steps on the card against the CPU (the plain versions) from the
# same weights, batch and anchor sampling: the first step's losses within
# IMPERATIVE_RFCN_RTOL, its update of the parameters within "update" of the
# CPU's over all of them and "update_param" of each parameter's own (fp32
# sums in other orders, dconv_col_bwd's by atomics: ~1e-6 expected), and
# the later steps' losses within "later" (their weights already one fp32
# rounding apart).  A parameter whose update is under "floor" of the whole
# (pstrans' bias: 3e-5 of it) is measured against that floor; the conv
# biases before BatchNorm, whose gradient is zero but for rounding (at most
# 4e-8 of the whole, and the card's rounding is not the CPU's), count only
# in the whole.
IMPERATIVE_RFCN_SHAPES = ((3, 64, 64), (3, 512, 512))
IMPERATIVE_RFCN_ITERS = 10
IMPERATIVE_RFCN_CPU_STEPS = {(3, 64, 64): 2, (3, 512, 512): 3}
IMPERATIVE_RFCN_RTOL = 2e-4
IMPERATIVE_RFCN_UPDATE_RTOL = {"update": 1e-4, "update_param": 1e-3, "floor": 1e-4,
                               "later": 1e-2}
IMPERATIVE_RFCN_ROUNDING_ONLY = ("backbone_down0_bias", "backbone_down1_bias",
                                 "backbone_down2_bias")
# ResNet-50 v1 through autograd.record / Trainer against make_train_step:
# batch RESNET_BATCH at 224x224, these SGD settings, 3 steps from the same
# weights on the same batches, under deterministic cuDNN, in fp32 (the gate
# at the issue's settings) and in float64.  make_train_step takes Trainer's
# weight decay as the gradient of (wd/2)·Σ‖p‖² added to its loss.  Per
# dtype and step i: the losses within "loss"[i], and the weights within
# "weights"[i] of make_train_step's update since the start.  Step 1 shows
# the two update rules alone.  After it, at lr 0.1 and a rising loss, the
# trajectory amplifies any difference: a float64 make_train_step started
# one ulp up, run beside, is 9.1e-8, 2.6e-3 and 6.2e-2 of the update away
# after steps 1-3, and in float64 the imperative loop must stay closer than
# it at every step.  The later limits are 2.5x the readings of the first
# runs (H100, 700 W; bit for bit the same in each run): fp32 losses 0, 3.95e-6,
# 2.35e-3 apart and weights 8.9e-9, 4.06e-2, 7.91e-2; float64 losses 0,
# 0, 2.44e-7 and weights 1.09e-17, 1.33e-8, 6.25e-4.
IMPERATIVE_RESNET_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
IMPERATIVE_RESNET_STEPS = 3
IMPERATIVE_RESNET_RTOL = {
    "float32": {"loss": (1e-6, 1e-5, 6e-3), "weights": (1e-6, 0.1, 0.2)},
    "float64": {"loss": (1e-12, 1e-10, 6e-7), "weights": (1e-14, 3.3e-8, 1.6e-3)},
}
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
# the LSTM bucketing LM (mxnet_tpu_torch/examples/rnn/lstm_bucketing.py) at the
# PTB width of the reference's example/rnn/bucketing: 2 LSTM layers x 200
# hidden, embed 200, batch 32, buckets 10..60, a vocabulary of 10,000, Adam
# at lr 0.01 and wd 1e-5, Xavier(in, 2.34) weights.  The example's
# synthetic Zipf / bigram corpus (synthetic_corpus(n, vocab_size=10000))
# gives sentences of 4-23 tokens; its token stream is cut into sentences of
# 5-60 tokens (uniform lengths) so that every bucket fills: one epoch of
# ~60 batches, each bucket at least 6
LM = dict(layers=2, hidden=200, embed=200, vocab=10000, batch=32,
          buckets=(10, 20, 30, 40, 50, 60), lr=0.01, wd=1e-5, corpus=4700)
LM_RTOL = 1e-5          # card against CPU: loss and update; fused against unfused
LM_MIN_TIMED = 5        # batches timed in each bucket, its first (the bind) apart
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
# the detection-quality gates (mxnet_tpu_torch/quality): map_ssd300 runs the
# SSD300 gate's full recipe (gate_map.RECIPES["ssd300"]: full width, 3
# classes, 2,000 bf16 steps at batch 4, the fp32 score step over 500
# held-out images) at seed SEED and holds its mAP to the single-run floor
# (gate_map.SINGLE_RUN_FLOORS); map_frcnn_eval and map_rfcn_eval run the
# gates' eval path (forward, decode, the decode's box_nms on the card, the
# metric) over the first MAP_EVAL_IMAGES held-out images, on the gates' eval
# nets (3 classes; Faster R-CNN at TEST counts 6000/300, R-FCN with live
# BatchNorm) holding the frcnn / serve phases' trunk and RPN weights
MAP_EVAL_IMAGES = 20
MAP_CLASSES = 3
# bench.py MXNET_BENCH=predictor (main_predictor): the deploy twin of
# test_utils.deploy_twin_checkpoint at batch 16, 32x32, inputs U(0, 1) from
# RandomState(0), 200 forwards after the first; the int8 twin calibrated on
# 4 batches; each tier timed over 3 windows of 200 forwards
PREDICTOR_BATCH, PREDICTOR_IMAGE, PREDICTOR_ITERS, PREDICTOR_WINDOWS = 16, 32, 200, 3
PREDICTOR_CALIB = 4
TIERS = ("fp32", "bf16", "int8")
# ResNet-50 v2 (INT8's symbol) served through Predictor from files at
# INT8_BATCHES, each tier over 3 windows of 50 forwards; the int8 tier and
# quantize_model calibrated as INT8_CALIB
PREDICTOR_RESNET_ITERS = 50
# fc1's logits of each ResNet-50 tier against fp32's: limits on the relative
# L2 error and on that of the logits centred on their batch mean (the part
# that depends on the image; with these random weights it is ~4% of the
# logits' norm).  On an H100 the readings were bf16 (0.0056, 0.109) and
# int8 (0.024, 0.446); the broken controls of resnet_tier_logits read
# (0.042, 1.44) for another image's logits and (0.279, 0.839) for the int8
# twin of a table with halved ranges, and the gate rejects both.
LOGIT_LIMITS = {"bf16": (0.02, 0.3), "int8": (0.08, 0.65)}
# serve_engine, on predictor_resnet's files: (a) the fp32 Engine on
# pow2_ladder(32), 8 closed-loop clients, 240 requests of 1-8 N(0, 1) images
# and 2 of 40 (direct dispatch); (b) the quantize_model deploy's Engine on
# (1, 8, 32), 40 of (a)'s requests from 4 clients; (c) a Router over the
# fp32 / bf16 / int8 twins on (1, 4, 16), queues of 16: paid alone (30
# requests of 1-4 images, 2 clients), then 8 clients' 4-image best_effort
# flood beside 2 paid clients until the queue pressure (degrade at 0.25,
# calm below 0.125 for 2 s) degrades best_effort, at most 30 s.  Every path
# serves fc1's logits beside the probabilities (SERVE_OUTPUTS), and replies
# must equal their bucket's Predictor bit for bit (an H100 showed them so).
SERVE_OUTPUTS = ("fc1", "softmax")
SERVE_LADDER_TOP, SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_N = 32, 8, 240, 8
SERVE_DIRECT = (2, 40)
SERVE_DEPLOY_LADDER, SERVE_DEPLOY_REQUESTS, SERVE_DEPLOY_CLIENTS = (1, 8, 32), 40, 4
ROUTER_LADDER, ROUTER_MAX_QUEUE, ROUTER_FLOOD_CLIENTS = (1, 4, 16), 16, 8
ROUTER_POLICY = dict(pressure=0.25, hold_s=2.0, interval_s=0.05)
ROUTER_DEGRADE_WAIT_S = 30

# slice 19.  imagenet_alexnet: train_imagenet.py's recipe (its defaults:
# batch 128, 3x224x224, 1,000 classes, sgd lr 0.1 momentum 0.9 wd 1e-4, the
# default Xavier(gaussian, in, 2), kvstore device) with --network alexnet
# --benchmark 1 (SyntheticDataIter's 50 batches), one epoch, --top-k 5; the
# card against the CPU on the first two batches (losses, and the first
# update as a whole), through Module and the device KVStore as fit.fit
# runs them; the ms a batch over the last ALEXNET_TIMED batches.
# In float32 the first update cannot be held to the CPU's within 1e-4: the
# CPU's own float32 update is 1.79e-4 from its float64 one (conv1's weight
# gradient sums 373,248 terms an entry, conv1 2.0e-3 apart), and the card's
# 2.54e-4 (NVIDIA H100 80GB HBM3, 700 W); in float64 the two devices agree to
# 2.3e-15.  So the float32 run holds the first batch's loss within
# ALEXNET_LOSS_RTOL, the second batch's (computed after that update, its
# rounding carried: 4.5e-5 apart on that card) within ALEXNET_LOSS2_RTOL,
# and the card's update no further than ALEXNET_FP32_ERROR_RATIO times the
# CPU's from the float64 update; the float64 run (the same Module and
# KVStore path bound in float64, the same weights, batches and masks) holds
# both losses and the first update within ALEXNET_FLOAT64_RTOL.
# The recipe at these defaults diverges on SyntheticDataIter's one repeated
# batch (the loss inf from the fifth batch on the card): each card run goes
# on alone for ALEXNET_FURTHER steps and prints its losses, in float32 and
# in float64 alike.  The epoch at the defaults is timed on those non-finite
# weights; the same epoch at ALEXNET_FINITE_LR keeps them finite (its loss
# must fall), and is timed and profiled too
ALEXNET_ARGS = ["--network", "alexnet", "--benchmark", "1", "--num-epochs", "1",
                "--top-k", "5", "--disp-batches", "10"]
ALEXNET_LOSS_RTOL, ALEXNET_LOSS2_RTOL, ALEXNET_FLOAT64_RTOL = 1e-5, 1e-3, 1e-10
ALEXNET_FP32_ERROR_RATIO = 2.0
ALEXNET_TIMED, ALEXNET_FURTHER, ALEXNET_FINITE_LR = 40, 6, 0.01
# mnist_lenet_stn: train_mnist.py (batch 64, sgd momentum 0.9 wd 1e-4, its
# synthetic stand-in data) with lenet.get_symbol(add_stn=True), one epoch of
# 2,560 examples (40 batches), at --lr 0.01: at the script's 0.05 LeNet does
# not learn the stand-in in 40 batches, in the JAX package's script and in
# the port's alike (plain LeNet, CPU runs; ROADMAP.md section C), and the
# card's LeNet-STN epoch at 0.05 is printed beside the others.  The first
# batch card against CPU within LENET_RTOL; LENET_CARD_RUNS card epochs and
# one CPU epoch, each from mx.random seeded with LENET_SEED, each one's
# held-out accuracy must rise by LENET_MIN_GAIN over its initial weights'
# (chance is 0.1; sound epochs on an H100 rose by 0.486 to 0.900 over six
# readings, on the CPU by 0.695 and 0.902, and the card's epoch at lr 0.05
# by -0.021: PERF.md section 5)
LENET_ARGS = ["--network", "lenet", "--num-epochs", "1", "--num-examples", "2560",
              "--lr", "0.01", "--disp-batches", "10"]
LENET_RTOL, LENET_MIN_GAIN = 1e-5, 0.4
LENET_CARD_RUNS, LENET_SEED = 3, 19
# python_loss: the port's examples/module/python_loss.py; 8 epochs must pass
# the JAX test's accuracy bar, and the first epoch's scores card vs CPU
PYTHON_LOSS_MIN_ACC, PYTHON_LOSS_RTOL = 0.9, 1e-5
# optimizers: the 13 of the slice, RMSProp centred, and multi_precision on
# bf16 weights for SGD, NAG and Adam, each one step on AlexNet's parameters
OPTIMIZER_RUNS = {
    "nag": dict(momentum=0.9), "signum": dict(momentum=0.9), "sgld": {},
    "dcasgd": dict(momentum=0.9), "adagrad": {}, "adadelta": {}, "adamax": {}, "nadam": {},
    "rmsprop": {}, "rmsprop-centered": dict(centered=True), "ftrl": {}, "ftml": {},
    "lbsgd": dict(momentum=0.9), "test": {},
    "sgd-mp": dict(momentum=0.9, multi_precision=True),
    "nag-mp": dict(momentum=0.9, multi_precision=True), "adam-mp": dict(multi_precision=True)}
OPTIMIZER_RTOL = 1e-6
# registry_ops: the CPU tests' cases, CTC at a DeepSpeech-like size (T, N,
# C) and Deconvolution at an FCN-32s head (B, classes, H, W, kernel, stride)
REGISTRY_CTC = (200, 16, 29)
REGISTRY_DECONV = (1, 21, 16, 16, 64, 32)
# the two large cases accumulate float32 rounding past the small cases'
# tolerances: the FCN-32s deconvolution sums up to 86,016 terms an entry
# (its data gradient: 21 channels x 64 x 64; on an H100 1.2e-4 apart
# against a limit of 1.3e-5 on gradients up to 12.9, the CPU's own
# float32 result 1.0e-4 from float64), CTC's gradient runs through 200
# steps of log-space sums (the card 8.3e-6 apart against 1.5e-6).  Each is
# held to a float64 run on the CPU, the card no further from it than
# REGISTRY_LARGE_RATIO times the CPU's float32 run
REGISTRY_LARGE = ("_contrib_CTCLoss#deepspeech", "Deconvolution#fcn32s")
REGISTRY_LARGE_RATIO = 2.0


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


def phase_kernels(kernels, net, launches, bwd_captured, train_nms, dev, bf16=False,
                  extra=None):
    """Each R-FCN kernel against its plain version on the calls of a real
    run: an inference forward for the forward kernels, and for the backward
    kernels the calls ``phase_train`` recorded in one of its batch-1 steps
    (NMS is compared on that step's call too, and timed on the serve call).
    With ``bf16``, the bf16 instances on the bf16 path's calls (``net`` the
    bf16 serve model, the backward calls from ``phase_train_bf16``; NMS has
    its row already).  ``extra`` maps a kernel to more calls it is held
    against (the imperative R-FCN's bench steps), compared only.  (The int8
    pair's rows come from ``phase_int8``'s calls.)"""
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
                                   extra_calls=list(train_nms if name == "nms_alive" else ())
                                   + list((extra or {}).get(name, ()))))
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


def device_ops(run, tries=5, want=None):
    """The names of the device operations of one ``run()``, from the
    profiler.  A profile that recorded no device operation at all, or none
    whose name holds ``want``, is taken again, up to ``tries`` times: the
    profiler has returned an empty profile for a call whose kernels ran
    (three in a row once, right after a profile that held them), and one
    that held the call's PyTorch kernels but not the two NMS kernels
    launched after them."""
    for _ in range(tries):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        ops = sorted({e.key for e in prof.key_averages()
                      if float(getattr(e, "self_device_time_total", 0) or 0) > 0})
        if ops and (want is None or any(want in o for o in ops)):
            break
    return ops


def nms_scan_taken(kernels, run, n, expect):
    """The survivor scan one NMS ``run()`` over ``n`` boxes took, which must
    be ``expect``: the C entry's launch rule (``kernels.nms_scan``) names
    it, and the profiler's device operations, where they name an NMS scan,
    must name that one alone.  -> (scan, device ops or the reason there are
    none)."""
    scan = kernels.nms_scan(n)
    ops = device_ops(run, want="nms_scan_kernel")
    seen = {("global" if "global" in o else "staged") for o in ops if "nms_scan_kernel" in o}
    if scan != expect or seen and seen != {scan}:
        fail("nms at N=%d did not run the %s scan alone: the launch rule took %s, the "
             "device ran %s" % (n, expect, scan, ops))
    return scan, ops if seen else "none recorded (the profiler returned %s)" % (ops,)


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
    _, ops = nms_scan_taken(kernels, lambda: k.wrapper(*args, **kw), n, "staged")
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
    math fp32) at batch 1 and 16; SSD512 in fp32 and bf16 at batch 16."""
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
        for dtype in ("float32", "bfloat16"):
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
    """The SSD train step at full width, SSD300 and SSD512, each in fp32 and
    in bf16 (``compute_dtype="bfloat16"``, fp32 masters)."""
    launches, reports = {}, {}
    for size, dtype, seed in ((300, None, SEED + 53), (300, "bfloat16", SEED + 54),
                              (512, None, SEED + 55), (512, "bfloat16", SEED + 56)):
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
    for label, scan in (("ssd300_serve", "staged"), ("ssd512_serve", "global"),
                        ("ssd512_serve_bf16", "global")):
        args, kw = calls[label][0]
        B, n = args[1].shape
        words = -(-n // 64)
        if args[2] is None:
            fail("%s: the NMS call has no class ids" % label)
        ms = time_ms(lambda: k.wrapper(*args, **kw), 20)
        plain_ms = time_ms(lambda: k.plain(*args, **kw), 3)
        alive = k.wrapper(*args, **kw)
        bound_ms, bound_by = bound(*work("nms_alive", args, alive))
        _, ops = nms_scan_taken(kernels, lambda: k.wrapper(*args, **kw), n, scan)
        # the device time of each of the two kernels
        split = {"mask": "not measured", "scan": "not measured"}
        prof = device_profile(lambda: k.wrapper(*args, **kw), reps=3, top=4)
        for kms, _, kname in prof.get("top_kernels_ms_count_name", []):
            for part, kernel in (("mask", "nms_mask_kernel"), ("scan", "nms_scan_kernel")):
                if kernel in kname:
                    split[part] = kms
        key = label.replace("_serve", "")
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


def phase_map_ssd300(kernels, card):
    """The SSD300 quality gate's full recipe at seed SEED through its entry
    point (``quality.eval_ssd_map.run``): one NMS launch per eval image and
    no other kernel, an mAP at or above the single-run floor.  -> (launches,
    report)."""
    from mxnet_tpu_torch.quality import eval_ssd_map, gate_map

    floor = gate_map.SINGLE_RUN_FLOORS["ssd300"]
    if floor is None:
        fail("map_ssd300: gate_map.SINGLE_RUN_FLOORS has no SSD300 floor")
    args = eval_ssd_map.parse(gate_map.RECIPES["ssd300"][1] + ["--seed", str(SEED)])
    kernels.reset_launches()
    res = eval_ssd_map.run(args)
    launches = counts(kernels)
    expect = {n: args.eval_images * (n == "nms_alive") for n in kernels.KERNELS}
    if launches != expect:
        fail("map_ssd300 launched %s, expected %s" % (launches, expect))
    if not (math.isfinite(res["map"]) and 0.0 <= res["map"] <= 1.0):
        fail("map_ssd300: mAP %r" % res["map"])
    res.update(floor=floor, steps_per_s=res["steps"] / res["train_s"])
    say("map_ssd300 on %s: mAP %.4f (single-run floor %.4f) after %d bf16 steps at batch %d "
        "(%.1f s, %.2f steps/s), eval of %d images %.1f s; launches %s" % (
            card, res["map"], floor, res["steps"], args.batch, res["train_s"],
            res["steps_per_s"], args.eval_images, res["eval_s"], json.dumps(launches)))
    if res["map"] < floor:
        fail("map_ssd300: mAP %.4f below the single-run floor %.4f" % (res["map"], floor))
    return launches, res


def map_eval_net(model, src, dev):
    """The gate's eval net of ``model`` ("frcnn": the TEST-count twin,
    "rfcn": live BatchNorm), MAP_CLASSES classes, holding ``src``'s tensors
    wherever name and shape agree (trunk, RPN).  -> (net, tensors taken,
    tensors)."""
    from mxnet_tpu_torch import train_frcnn, train_fused

    gen = torch.Generator().manual_seed(SEED + 61)
    if model == "frcnn":
        net, _, _ = train_frcnn.build_net(True, classes=MAP_CLASSES,
                                          rpn_pre_nms=FRCNN_SERVE_NMS[0],
                                          rpn_post_nms=FRCNN_SERVE_NMS[1], device=dev,
                                          generator=gen)
    else:
        net, _, _ = train_fused.build_net(True, classes=MAP_CLASSES, device=dev,
                                          generator=gen, frozen_bn=False)
    own = net.state_dict()
    shared = {k: v for k, v in src.state_dict().items()
              if k in own and own[k].shape == v.shape}
    net.load_state_dict(shared, strict=False)
    return net, len(shared), len(own)


def check_detections(dets, net, what):
    """A decode's answer: numpy (1, K, 6), K <= 100; one all −1 row, or
    rows of class ids in [0, classes), scores in [0.05, 1] falling, finite
    boxes inside the image with x1 <= x2 and y1 <= y2.  -> K."""
    H, W = net.image_shape
    if dets.ndim != 3 or dets.shape[0] != 1 or dets.shape[2] != 6 or dets.dtype != np.float32:
        fail("%s: detections %s %s" % (what, dets.dtype, dets.shape))
    d = dets[0]
    if d.shape[0] == 1 and (d == -1).all():
        return 0
    cid, score, box = d[:, 0], d[:, 1], d[:, 2:]
    if not (d.shape[0] <= 100 and np.isfinite(d).all()
            and ((cid >= 0) & (cid < net.classes) & (cid == np.round(cid))).all()
            and ((score >= 0.05) & (score <= 1)).all() and (np.diff(score) <= 0).all()
            and (box >= 0).all() and (box[:, [0, 2]] <= W - 1).all()
            and (box[:, [1, 3]] <= H - 1).all()
            and (box[:, 0] <= box[:, 2]).all() and (box[:, 1] <= box[:, 3]).all()):
        fail("%s: malformed detections %s" % (what, d[:4].tolist()))
    return d.shape[0]


def phase_map_eval(kernels, model, src, dev, card):
    """The gate's eval path of ``model`` at full width over the first
    MAP_EVAL_IMAGES held-out images (``quality.eval_*_map.evaluate``): each
    image's forward launches as a serve forward, plus one NMS for the
    decode's ``box_nms`` (B 1, N 512, per-class ids), which is recorded for
    the kernels phase; the detections well formed, the mAP finite in [0, 1].
    -> (launches, the decode's NMS calls, report)."""
    from mxnet_tpu_torch.quality import common, eval_frcnn_map, eval_rfcn_map

    mod = eval_frcnn_map if model == "frcnn" else eval_rfcn_map
    net, taken, total = map_eval_net(model, src, dev)
    mod.evaluate(net, 1, dev)  # cuDNN and allocator set-up
    torch.cuda.synchronize()
    per_image = dict(frcnn_expect(kernels) if model == "frcnn" else per_forward(net))
    per_image["nms_alive"] += 1
    kernels.reset_launches()
    out = []
    t0 = time.perf_counter()
    calls = capture_calls(kernels, ["nms_alive"],
                          lambda: out.append(mod.evaluate(net, MAP_EVAL_IMAGES, dev)))["nms_alive"]
    seconds = time.perf_counter() - t0
    launches = counts(kernels)
    value, dets = out[0]
    decode = [c for c in calls if len(c[0]) > 2 and c[0][2] is not None]
    if len(decode) != MAP_EVAL_IMAGES or any(
            tuple(a[1].shape) != (1, common.NMS_CAP) for a, _ in decode):
        fail("map_%s_eval: %d decode NMS calls of shapes %s, expected %d of (1, %d)" % (
            model, len(decode), sorted({tuple(a[1].shape) for a, _ in decode}),
            MAP_EVAL_IMAGES, common.NMS_CAP))
    expect = {n: c * MAP_EVAL_IMAGES for n, c in per_image.items()}
    if launches != expect:
        fail("map_%s_eval launched %s, expected %s" % (model, launches, expect))
    kept = [check_detections(d, net, "map_%s_eval" % model) for d in dets]
    if not (math.isfinite(value) and 0.0 <= value <= 1.0):
        fail("map_%s_eval: mAP %r" % (model, value))
    valid = [int(a[1].sum()) for a, _ in decode]
    res = dict(map=value, images=MAP_EVAL_IMAGES, seconds=seconds,
               ms_per_image=seconds / MAP_EVAL_IMAGES * 1e3, kept=kept, nms_valid_rows=valid,
               tensors_taken=taken, tensors=total)
    say("map_%s_eval on %s: %d held-out images in %.2f s (%.1f ms an image), detections "
        "kept %s, decode NMS valid rows %s, mAP %.4f (random head: not a quality figure); "
        "%d of %d tensors from the smoke's net; launches %s" % (
            model, card, MAP_EVAL_IMAGES, seconds, res["ms_per_image"], kept, valid, value,
            taken, total, json.dumps(launches)))
    del net
    torch.cuda.empty_cache()
    return launches, decode, res


def nms_at_decode(kernels, calls):
    """NMS on the quality gates' decode calls (``box_nms`` over the padded
    or cut rows of one image: B 1, N 512, per-class ids, ``plus_one`` 0):
    each call bit for bit against the plain version; on the first, the
    kernel's device time, the plain version's, the bound and the device
    operations of one call (the staged scan).  -> keys for the NMS row."""
    k = kernels.KERNELS["nms_alive"]
    for args, kw in calls:
        got, ref = k.wrapper(*args, **kw), k.plain(*args, **kw)
        torch.cuda.synchronize()
        compare("nms_alive", got, ref)
    args, kw = calls[0]
    B, n = args[1].shape
    ms = time_ms(lambda: k.wrapper(*args, **kw), 20)
    plain_ms = time_ms(lambda: k.plain(*args, **kw), 3)
    alive = k.wrapper(*args, **kw)
    bound_ms, bound_by = bound(*work("nms_alive", args, alive))
    _, ops = nms_scan_taken(kernels, lambda: k.wrapper(*args, **kw), n, "staged")
    say("kernel nms_alive at the decode size: B %d, N %d, %d valid and %d kept, %.4f ms "
        "(plain %.4f ms), bound %.6f ms by %s, bit-identical over %d calls; device ops %s" % (
            B, n, int(args[1].sum()), int(alive.sum()), ms, plain_ms, bound_ms, bound_by,
            len(calls), ops))
    return dict(decode_batch=B, decode_n=n, decode_calls=len(calls), decode_ms=ms,
                decode_plain_ms=plain_ms, decode_bound_ms=bound_ms, decode_bound_by=bound_by)


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


def lm_sentences():
    """The example's synthetic corpus cut into sentences of 5-60 tokens: see
    LM."""
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing as ex

    sents, _ = ex.synthetic_corpus(LM["corpus"], vocab_size=LM["vocab"], seed=SEED)
    stream = [w for sent in sents for w in sent]
    rng = np.random.RandomState(SEED + 61)
    out, i = [], 0
    while i < len(stream):
        n = rng.randint(5, 61)
        out.append(stream[i:i + n])
        i += n
    return out


def lm_iter(sents):
    """``BucketSentenceIter`` over ``sents``, its shuffles seeded."""
    import random

    from mxnet_tpu_torch import rnn

    np.random.seed(SEED + 62)
    random.seed(SEED + 62)
    return rnn.BucketSentenceIter(sents, LM["batch"], buckets=list(LM["buckets"]),
                                  invalid_label=0)


def lm_init():
    from mxnet_tpu_torch.initializer import Xavier

    return Xavier(factor_type="in", magnitude=2.34,
                  generator=torch.Generator().manual_seed(SEED + 63))


def lm_module(dev, fused=False, arg_params=None, ready=True):
    """The example's BucketingModule on ``dev`` -> (module, its cell stack);
    with ``ready`` bound to the largest bucket, its weights
    ``Xavier(in, 2.34)`` from a seeded generator (or ``arg_params``) and
    Adam's optimizer initialised, as ``fit`` makes them."""
    from mxnet_tpu_torch.examples.rnn import lstm_bucketing as ex
    from mxnet_tpu_torch.module import BucketingModule

    stack = ex.lstm_stack(LM["layers"], LM["hidden"], fused=fused)
    mod = BucketingModule(ex.make_sym_gen(stack, LM["vocab"], LM["embed"], LM["hidden"]),
                          default_bucket_key=max(LM["buckets"]), device=dev)
    if ready:
        shape = (LM["batch"], max(LM["buckets"]))
        mod.bind([("data", shape)], [("softmax_label", shape)])
        mod.init_params(initializer=lm_init(), arg_params=arg_params,
                        allow_missing=arg_params is None)
        mod.init_optimizer(optimizer="adam",
                           optimizer_params={"learning_rate": LM["lr"], "wd": LM["wd"]})
    return mod, stack


def lm_batch(it, key, dev=None):
    """The first batch of bucket ``key`` in ``it``'s (shuffled) rows, its
    labels the next tokens."""
    from mxnet_tpu_torch.io import DataBatch, DataDesc

    rows = it.data[it.buckets.index(key)][:LM["batch"]]
    labels = np.concatenate([rows[:, 1:], np.zeros((rows.shape[0], 1), rows.dtype)], axis=1)
    data, label = (torch.from_numpy(np.ascontiguousarray(a)).to(dev or "cpu")
                   for a in (rows, labels))
    return DataBatch([data], [label], bucket_key=key,
                     provide_data=[DataDesc("data", rows.shape)],
                     provide_label=[DataDesc("softmax_label", labels.shape)])


def lm_loss(mod, batch):
    """The mean cross-entropy of the softmax over every position (padding
    included, as the loss's gradient), in float64 on the host."""
    p = mod.get_outputs()[0].double().cpu()
    label = batch.label[0].reshape(-1).long().cpu()
    return float(-torch.log(p[torch.arange(label.numel()), label]).mean())


def lm_params(mod):
    return {k: v.detach().double().cpu() for k, v in mod.get_params()[0].items()}


def lm_card_vs_cpu(it, dev):
    """Each bucket's first batch, in turn, through the card's and the CPU's
    cell stack from the same weights: the losses within ``LM_RTOL`` and
    the update of all parameters as one vector within ``LM_RTOL`` relative
    (per bucket).  -> [(bucket, loss rel. error, update rel. error)]."""
    card, _ = lm_module(dev)
    cpu, _ = lm_module("cpu", arg_params={k: v.cpu() for k, v in card.get_params()[0].items()})
    out = []
    for key in LM["buckets"]:
        before = lm_params(cpu)
        mods = []
        for mod, d in ((card, dev), (cpu, None)):
            batch = lm_batch(it, key, d)
            mod.forward_backward(batch)
            mod.update()
            mods.append((lm_loss(mod, batch), lm_params(mod)))
        (l_card, p_card), (l_cpu, p_cpu) = mods
        d_card = torch.cat([(p_card[k] - before[k]).flatten() for k in sorted(before)])
        d_cpu = torch.cat([(p_cpu[k] - before[k]).flatten() for k in sorted(before)])
        loss_err = abs(l_card - l_cpu) / abs(l_cpu)
        upd_err = float((d_card - d_cpu).norm() / d_cpu.norm())
        if not (loss_err <= LM_RTOL and upd_err <= LM_RTOL):
            fail("lstm bucketing, bucket %d: card against CPU: loss %.8f vs %.8f (rel %.2e), "
                 "update rel %.2e (limit %g)" % (key, l_card, l_cpu, loss_err, upd_err, LM_RTOL))
        out.append((key, loss_err, upd_err))
        # the next bucket starts from the CPU's weights on both devices
        with torch.no_grad():
            for k, v in card.get_params()[0].items():
                v.copy_(p_cpu[k].float().to(dev))
    return out


def lm_packed(mod, dev):
    """``mod``'s (a cell stack's module) weights with the cells' packed by
    the FusedRNNCell's ``pack_weights`` into its ``parameters`` vector."""
    fused_cell = lm_module(dev, fused=True, ready=False)[1]
    return fused_cell.pack_weights({k: v.cpu() for k, v in mod.get_params()[0].items()})


def lm_fused_vs_cells(it, dev, cells):
    """The FusedRNNCell stack (the ``RNN`` op) on the weights of ``cells``,
    the cell stack's module after its ``fit`` epoch (so that every bias
    differs by layer and gate), packed by ``pack_weights``: the same
    probabilities on each bucket's first batch within ``LM_RTOL`` (relative
    L2).  -> [(bucket, error)]."""
    fused, _ = lm_module(dev, fused=True, arg_params=lm_packed(cells, dev))
    out = []
    for key in LM["buckets"]:
        probs = []
        for mod in (cells, fused):
            mod.forward(lm_batch(it, key, dev), is_train=False)
            probs.append(mod.get_outputs()[0].double())
        err = float((probs[1] - probs[0]).norm() / probs[0].norm())
        if not err <= LM_RTOL:
            fail("lstm bucketing, bucket %d: FusedRNNCell against its unfuse(): rel %.2e"
                 % (key, err))
        out.append((key, err))
    return out


def lm_fit(it, dev, fused, arg_params=None):
    """One epoch of ``BucketingModule.fit`` (Perplexity ignoring the padding,
    a Speedometer) from ``lm_init``'s weights or ``arg_params`` (the fused
    stack's packed vector has no initializer of its own, as in the JAX
    package) -> (each batch's (bucket, ms, perplexity), peak GiB, seconds,
    the module)."""
    from mxnet_tpu_torch.callback import Speedometer
    from mxnet_tpu_torch.metric import Perplexity

    mod, _ = lm_module(dev, fused=fused, ready=False)
    metric = Perplexity(0)
    rows, state = [], {"mark": None, "sum": 0.0, "n": 0}

    def on_batch(param):  # the metric's read has synchronised the batch
        now = time.perf_counter()
        nll = (metric.sum_metric - state["sum"]) / (metric.num_inst - state["n"])
        state.update(sum=metric.sum_metric, n=metric.num_inst)
        rows.append((param.locals["data_batch"].bucket_key, (now - state["mark"]) * 1e3,
                     math.exp(nll)))
        state["mark"] = now

    it.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = state["mark"] = time.perf_counter()
    mod.fit(it, eval_metric=metric, optimizer="adam",
            optimizer_params={"learning_rate": LM["lr"], "wd": LM["wd"]},
            initializer=lm_init(), arg_params=arg_params,
            batch_end_callback=[on_batch, Speedometer(LM["batch"], 20, auto_reset=False)],
            num_epoch=1)
    return rows, torch.cuda.max_memory_allocated() / 2 ** 30, time.perf_counter() - t0, mod


def lm_report(rows):
    """-> {bucket: median ms of its batches after its first} and the
    perplexity's first and last 10 batches' means; fails unless every
    bucket has ``LM_MIN_TIMED`` such batches and the perplexity fell."""
    seen, per = set(), {}
    for key, ms, _ in rows:
        if key in seen:
            per.setdefault(key, []).append(ms)
        seen.add(key)
    short = {k: len(per.get(k, [])) for k in LM["buckets"] if len(per.get(k, [])) < LM_MIN_TIMED}
    if short:
        fail("lstm bucketing: too few timed batches in buckets %s" % short)
    ppl = [p for _, _, p in rows]
    first, last = statistics.mean(ppl[:10]), statistics.mean(ppl[-10:])
    if not (all(math.isfinite(p) for p in ppl) and first > last):
        fail("lstm bucketing: perplexity did not fall: first 10 %.2f, last 10 %.2f"
             % (first, last))
    return {k: statistics.median(per[k]) for k in LM["buckets"]}, first, last


def phase_lstm_bucketing(kernels, dev, card):
    """The LSTM bucketing language model on the card: see LM.  Each bucket's
    first batch on the card against the CPU (loss and update, ``LM_RTOL``);
    one epoch of ``BucketingModule.fit`` with each stack (the example's
    unrolled LSTMCell stack and a FusedRNNCell over the ``RNN`` op, both
    from the same initial weights): the perplexity must fall (the mean of
    the first 10 batches above that of the last 10); median ms a batch of
    each bucket, device kernels a batch at the largest bucket, peak memory;
    no ported kernel launched; then the FusedRNNCell stack against its
    ``unfuse()`` on the card, on the cell stack's trained weights.  ->
    (launch counts, report)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    say("lstm bucketing card: %s" % smi.stdout.strip().splitlines()[0])
    logging.basicConfig(level=logging.INFO, format="%(message)s", stream=sys.stdout)
    it = lm_iter(lm_sentences())
    sizes = {k: len(m) // LM["batch"] for k, m in zip(it.buckets, it.data)}
    say("lstm bucketing: %d layers x %d hidden, embed %d, vocabulary %d, batch %d, batches "
        "an epoch by bucket %s" % (LM["layers"], LM["hidden"], LM["embed"], LM["vocab"],
                                    LM["batch"], sizes))
    t0 = time.perf_counter()
    card_cpu = lm_card_vs_cpu(it, dev)
    say("lstm bucketing card vs CPU (bucket, loss rel, update rel) in %.1f s: %s" % (
        time.perf_counter() - t0, card_cpu))
    packed = lm_packed(lm_module(dev)[0], dev)
    res = {"card_vs_cpu": card_cpu}
    trained = None
    kernels.reset_launches()
    for name, fused in (("cells", False), ("fused", True)):
        rows, peak, seconds, mod = lm_fit(it, dev, fused, packed if fused else None)
        medians, first, last = lm_report(rows)
        big = lm_batch(it, max(LM["buckets"]), dev)

        def step(mod=mod, big=big):
            mod.forward_backward(big)
            mod.update()

        prof = device_profile(step, reps=1, top=6)
        res[name] = dict(batches=len(rows), epoch_s=seconds, median_ms=medians,
                         perplexity_first10=first, perplexity_last10=last, peak_gib=peak,
                         profile=prof)
        say("lstm bucketing (%s stack, BucketingModule.fit) on %s: %d batches in %.1f s, "
            "median ms a batch by bucket %s, perplexity %.1f (first 10) -> %.1f (last 10), "
            "peak memory %.2f GiB; at bucket %d: %s kernels a batch, device busy %s ms, "
            "idle share %s" % (
                name, card, len(rows), seconds,
                json.dumps({k: round(v, 2) for k, v in medians.items()}), first, last, peak,
                max(LM["buckets"]), prof.get("kernels_per_call"), prof.get("device_busy_ms"),
                prof.get("idle_share")))
        say("lstm bucketing %s device groups: %s" % (name, json.dumps(prof)))
        if not fused:
            trained = mod
        del mod
    launches = counts(kernels)
    if any(launches.values()):
        fail("the lstm bucketing path launched %s" % launches)
    say("lstm bucketing: ported kernel launches %s" % launches)
    res["fused_vs_unfused"] = lm_fused_vs_cells(it, dev, trained)
    say("lstm bucketing FusedRNNCell vs its unfuse() on the card, on the cell stack's "
        "weights after its epoch (bucket, rel): %s" % res["fused_vs_unfused"])
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


def predictor_windows(pred, x, iters, windows):
    """ms a forward over ``windows`` windows of ``iters`` forwards each (host
    clock, each window ended by a synchronize, as bench.py counts them);
    every forward runs under ``set_sync_debug_mode("error")``."""
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            for _ in range(iters):
                pred.forward(data=x)
        except RuntimeError as e:
            fail("a Predictor forward synchronised the host: %s" % e)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def pass_rows(pred):
    """(pass, nodes in, nodes out) of a predictor's inference plan."""
    return [(r["pass"], r["nodes_in"], r["nodes_out"])
            for r in pred.pass_stats()["eval"]["passes"]]


def check_clean(pred, what):
    """``pred.check()`` must hold warnings at most -> its codes, counted."""
    from mxnet_tpu_torch.analysis import worst_severity

    diags = pred.check()
    if worst_severity(diags) not in (None, "warning"):
        fail("%s: check() found %s" % (what, [str(d) for d in diags if d.severity != "warning"]))
    codes = {}
    for d in diags:
        codes[d.code] = codes.get(d.code, 0) + 1
    return codes


def serve_tier(kernels, pred, x, what, iters, windows, base=None):
    """Serve one predictor: its first forward (the plan's build) timed apart,
    outputs finite, and within the tier's tolerance of ``base`` (the fp32
    outputs) where given; then ``windows`` windows of ``iters`` forwards
    (no host sync), one profile, and no ported kernel launched.
    -> (report, outputs)."""
    from mxnet_tpu_torch.graph_passes import precision

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = pred.forward(data=x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    outs = [o.clone() for o in outs]
    for i, o in enumerate(outs):
        if not bool(torch.isfinite(o).all()):
            fail("%s: output %d has non-finite values" % (what, i))
    err = None
    if base is not None:
        tol = precision.tier_tolerance(pred.precision_tier)
        err = max(float((a.float() - b).abs().max()) for a, b in zip(outs, base))
        for a, b in zip(outs, base):
            torch.testing.assert_close(a.float(), b, **tol,
                                       msg=lambda m: "%s against fp32: %s" % (what, m))
    ms = predictor_windows(pred, x, iters, windows)
    prof = device_profile(lambda: pred.forward(data=x))
    launched = counts(kernels)
    if any(launched.values()):
        fail("%s launched %s" % (what, launched))
    med = statistics.median(ms)
    rep = dict(first_forward_s=first_s, ms=med, ms_windows=ms,
               samples_per_s=x.shape[0] * 1e3 / med, max_abs_err_vs_fp32=err,
               kernels_per_forward=prof.get("kernels_per_call"),
               device_busy_ms=prof.get("device_busy_ms"), idle_share=prof.get("idle_share"),
               device_ms_by_group=prof.get("device_ms_by_group"), passes=pass_rows(pred),
               check=check_clean(pred, what))
    say("%s: first forward %.3f s; %.4f ms a forward (windows %s), %.1f samples/s; "
        "%s kernels a forward, busy %s ms, idle share %s; max |x - fp32| %s; passes %s; "
        "check %s" % (what, first_s, med, ", ".join("%.4f" % t for t in ms),
                      rep["samples_per_s"], rep["kernels_per_forward"], rep["device_busy_ms"],
                      rep["idle_share"], err, rep["passes"], rep["check"]))
    return rep, outs


def phase_predictor(kernels, dev, card):
    """bench.py MXNET_BENCH=predictor on the card: the deploy twin as an fp32
    Predictor and its bf16 and calibrated int8 twins (PREDICTOR_BATCH)."""
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.graph_passes import precision
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.test_utils import deploy_twin_checkpoint

    b, im = PREDICTOR_BATCH, PREDICTOR_IMAGE
    with sym.NameManager():
        net, params, shapes = deploy_twin_checkpoint(batch=b, image=im)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(b, 3, im, im).astype(np.float32)).to(dev)
    pred = Predictor(net, params, shapes)
    res = {}
    res["fp32"], base = serve_tier(kernels, pred, x, "predictor fp32", PREDICTOR_ITERS,
                                   PREDICTOR_WINDOWS)
    t0 = time.perf_counter()
    table = precision.calibrate(pred, ({"data": rng.rand(b, 3, im, im).astype(np.float32)}
                                       for _ in range(PREDICTOR_CALIB)))
    calib_s = time.perf_counter() - t0
    for tier in TIERS[1:]:
        twin = pred.with_precision(tier, table if tier == "int8" else None)
        res[tier], _ = serve_tier(kernels, twin, x, "predictor %s" % tier, PREDICTOR_ITERS,
                                  PREDICTOR_WINDOWS, base)
        if tier == "int8":
            res[tier]["int8_sites"] = len(twin.int8_sites)
            res[tier]["calibrate_s"] = calib_s
    say("predictor (bench.py MXNET_BENCH=predictor, batch %d, %dx%d) on %s: %s" % (
        b, im, im, card, json.dumps({t: {k: res[t][k] for k in ("ms", "samples_per_s",
                                                                 "kernels_per_forward",
                                                                 "idle_share")}
                                     for t in TIERS})))
    return res


def plan_int8_nodes(exe):
    """(int8 quantize nodes, dequantize nodes of int8 input) of the plan an
    executor runs for inference, from its walk on meta tensors."""
    from mxnet_tpu_torch.analysis import executor_context
    from mxnet_tpu_torch.analysis.graph_analyzers import _abstract_walk

    ctx = executor_context(exe)
    dts = {n: v.dtype for n, v in ctx.arg_avals.items()}
    _abstract_walk(ctx.graph, ctx,
                   record=lambda node, nm, shape, dtype, vals, ins: dts.__setitem__(nm, dtype))
    plan = ctx.graph.entries
    return (sum(n.op.name == "_contrib_quantize" and n.attrs.get("out_type") == "int8"
                for n, _ in plan),
            sum(n.op.name == "_contrib_dequantize" and dts[ins[0]] == torch.int8
                for n, ins in plan))


def save_checkpoint(directory, prefix, net, args, aux):
    """``prefix-symbol.json`` and ``prefix.params`` (``arg:`` / ``aux:``
    keys) under ``directory`` -> their paths."""
    from mxnet_tpu_torch import ndarray

    sfile, pfile = "%s/%s-symbol.json" % (directory, prefix), "%s/%s.params" % (directory, prefix)
    net.save(sfile)
    ndarray.save(pfile, {**{"arg:" + k: v for k, v in args.items()},
                         **{"aux:" + k: v for k, v in aux.items()}})
    return sfile, pfile


def resnet_tier_logits(sfile, pfile, data, table, image):
    """fc1's logits of each twin against fp32's on ``data`` (a partial-output
    Predictor of the same files; the softmax of random weights saturates):
    the relative L2 error and that of the logits centred on their batch
    mean, gated at LOGIT_LIMITS, and two broken controls that each tier's
    gate must reject: fp32's logits of another image (the batch rolled by
    one) and the int8 twin of a table whose ranges are halved (every
    activation scale half the calibrated one).  Top-1 agreement is
    reported, not gated: with these weights the images may all share one
    top class."""
    from mxnet_tpu_torch.graph_passes import precision
    from mxnet_tpu_torch.predictor import Predictor

    fp32 = Predictor(sfile, pfile, {"data": tuple(data.shape)}, output_names=["fc1"])
    ref = fp32.forward(data=data)[0].float().clone()

    def centred(t):
        return t - t.mean(0, keepdim=True)

    def err(got):
        return dict(rel_l2_err=float((got - ref).norm() / ref.norm()),
                    centred_rel_l2_err=float((centred(got) - centred(ref)).norm()
                                             / centred(ref).norm()),
                    top1_agreement=float((got.argmax(1) == ref.argmax(1)).float().mean()))

    def within(e, limits):
        return e["rel_l2_err"] <= limits[0] and e["centred_rel_l2_err"] <= limits[1]

    out = {"fp32_logit_absmax": float(ref.abs().max()),
           "fp32_top1_classes": len(set(ref.argmax(1).tolist()))}
    for tier in TIERS[1:]:
        out[tier] = err(fp32.with_precision(tier, table if tier == "int8" else None)
                        .forward(data=data)[0].float())
    halved = precision.CalibrationTable(
        {k: (lo / 2, hi / 2) for k, (lo, hi) in table.ranges.items()}, table.batches)
    out["controls"] = {"another image": err(ref.roll(1, 0)),
                       "int8 twin, ranges halved": err(
                           fp32.with_precision("int8", halved).forward(data=data)[0].float())}
    say("predictor_resnet fc1 logits against fp32 on %d images: %s" % (
        data.shape[0], json.dumps(out)))
    for tier, limits in LOGIT_LIMITS.items():
        if not within(out[tier], limits):
            fail("predictor_resnet %s: fc1 logits' errors %s beyond the limits %s"
                 % (tier, out[tier], limits))
        for name, e in out["controls"].items():
            if within(e, limits):
                fail("predictor_resnet %s: the control (%s) errs by %s, within the limits %s: "
                     "the gate cannot tell a broken twin" % (tier, name, e, limits))
    return out


def phase_predictor_resnet(kernels, dev, card, tmp):
    """ResNet-50 v2 (INT8's symbol) served through Predictor from files at
    INT8_BATCHES: fp32, the bf16 tier and the int8 tier, then
    ``quantize_model``'s int8 symbol served the same way and held bit for bit
    against a bare Executor with the graph passes off.  The files are
    written under ``tmp``.  -> (launch counts over the phase, report, the
    files, the calibration table and the image shape for serve_engine)."""
    import os

    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.contrib.quantization import quantize_model
    from mxnet_tpu_torch.graph_passes import precision
    from mxnet_tpu_torch.io import NDArrayIter
    from mxnet_tpu_torch.models import resnet_symbol
    from mxnet_tpu_torch.predictor import Predictor

    gen = torch.Generator().manual_seed(SEED + 14)
    with sym.NameManager():
        net = resnet_symbol.get_symbol(**INT8)
    image = tuple(int(v) for v in INT8["image_shape"].split(","))
    args, aux = resnet_params(net, (1,) + image, gen, dev)
    n_batches, per_batch = INT8_CALIB
    calib = torch.randn((n_batches * per_batch,) + image, generator=gen).to(dev)
    data = torch.randn((max(INT8_BATCHES),) + image, generator=gen).to(dev)
    res = {}
    sfile, pfile = save_checkpoint(tmp, "resnet50_v2", net, args, aux)
    base = Predictor(sfile, pfile, {"data": (per_batch,) + image})
    t0 = time.perf_counter()
    table = precision.calibrate(base, ({"data": calib[i * per_batch:(i + 1) * per_batch]}
                                       for i in range(n_batches)))
    calib_s = time.perf_counter() - t0
    struct = [getattr(n.op, "name", "") for n, _ in base._exec._structural_plan(False)[0]]
    for batch in INT8_BATCHES:
        x = data[:batch]
        fp32 = base.with_shapes({"data": (batch,) + image})
        outs = {}
        for tier in TIERS:
            pred = fp32 if tier == "fp32" else fp32.with_precision(
                tier, table if tier == "int8" else None)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rep, out = serve_tier(kernels, pred, x, "predictor_resnet %s batch %d" % (
                tier, batch), PREDICTOR_RESNET_ITERS, PREDICTOR_WINDOWS)
            rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            rep["resident_before_gib"] = before / 2**30
            outs[tier] = out[0]
            if tier != "fp32":
                rep["max_abs_err_vs_fp32"] = float((out[0].float() - outs["fp32"]).abs().max())
                rep["top1_agreement"] = float(
                    (out[0].argmax(1) == outs["fp32"].argmax(1)).float().mean())
            plan = [getattr(n.op, "name", "") for n, _ in pred._exec._opt_plan(False)[0]]
            if tier == "bf16":
                rep["folded_batchnorms"] = struct.count("_bn_affine") - plan.count("_bn_affine")
                rep["cast_nodes"] = plan.count("_precision_cast")
            if tier == "int8":
                rep["int8_sites"] = len(pred.int8_sites)
                rep["calibrate_s"] = calib_s
            res["%s_batch%d" % (tier, batch)] = rep
            say("predictor_resnet %s batch %d: peak %.3f GiB (%.3f resident before)%s" % (
                tier, batch, rep["peak_gib"], rep["resident_before_gib"],
                "".join("; %s %s" % (k, rep[k]) for k in (
                    "top1_agreement", "max_abs_err_vs_fp32", "folded_batchnorms",
                    "cast_nodes", "int8_sites") if k in rep)))
            del pred
        del fp32, outs
    del base
    res["logits_vs_fp32"] = resnet_tier_logits(sfile, pfile, data, table, image)
    torch.cuda.empty_cache()

    # quantize_model's int8 symbol, deployed
    qsym, qargs, qaux = quantize_model(
        net, args, aux, device=dev, excluded_sym_names=["fc1"], calib_mode="naive",
        calib_data=NDArrayIter(calib, batch_size=per_batch))
    qfile, qpfile = save_checkpoint(tmp, "resnet50_v2_int8", qsym, qargs, qaux)
    kernels.reset_launches()
    bare_launched = dict.fromkeys(counts(kernels), 0)  # the references', taken out
    expect = dict.fromkeys(counts(kernels), 0)         # launches a forward x forwards
    for batch in INT8_BATCHES:
        x = data[:batch]
        pred = Predictor(qfile, qpfile, {"data": (batch,) + image})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.forward(data=x)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        n_q, n_dq = plan_int8_nodes(pred._exec)
        if (n_q, n_dq) != int8_nodes(qsym, (batch,) + image):
            fail("the passes changed the int8 quantize / dequantize nodes: %s -> %s"
                 % (int8_nodes(qsym, (batch,) + image), (n_q, n_dq)))
        before = counts(kernels)
        out = no_host_sync(lambda: pred.forward(data=x)[0].clone(),
                           "the quantize_model deploy's forward")
        got = {n: c - before[n] for n, c in counts(kernels).items()}
        if got != only(got, quantize_int8=n_q, dequantize_int8=n_dq):
            fail("the quantize_model deploy at batch %d launched %s, expected "
                 "quantize_int8 %d and dequantize_int8 %d" % (batch, got, n_q, n_dq))
        before = counts(kernels)
        os.environ["MXNET_GRAPH_PASSES"] = "0"
        try:
            bare = bind(qsym, qargs, qaux, batch, dev, image)
        finally:
            del os.environ["MXNET_GRAPH_PASSES"]
        ref = bare.forward(data=x)[0]
        if bare.pass_stats() or not torch.equal(out, ref):
            fail("the quantize_model deploy at batch %d differs from the bare executor "
                 "in %d values" % (batch, int((out != ref).sum())))
        for n, c in counts(kernels).items():
            bare_launched[n] += c - before[n]
        ms = predictor_windows(pred, x, PREDICTOR_RESNET_ITERS, PREDICTOR_WINDOWS)
        reps = 3
        prof = device_profile(lambda: pred.forward(data=x), reps=reps)
        # the first forward, the one under no_host_sync, the windows, the profile
        forwards = 2 + PREDICTOR_RESNET_ITERS * PREDICTOR_WINDOWS + reps
        for n in expect:
            expect[n] += got[n] * forwards
        rep = dict(first_forward_s=first_s, ms=statistics.median(ms), ms_windows=ms,
                   samples_per_s=batch * 1e3 / statistics.median(ms),
                   launches_per_forward={k: got[k] for k in INT8_PAIR},
                   kernels_per_forward=prof.get("kernels_per_call"),
                   device_busy_ms=prof.get("device_busy_ms"),
                   idle_share=prof.get("idle_share"), passes=pass_rows(pred),
                   check=check_clean(pred, "the quantize_model deploy"))
        res["quantize_model_batch%d" % batch] = rep
        say("predictor_resnet quantize_model deploy batch %d: equal bit for bit to the "
            "bare executor (passes off); launches a forward %s; first forward %.3f s; "
            "%.3f ms a forward (windows %s); %s kernels, busy %s ms, idle share %s; "
            "passes %s" % (batch, rep["launches_per_forward"], first_s, rep["ms"],
                           ", ".join("%.3f" % t for t in ms), rep["kernels_per_forward"],
                           rep["device_busy_ms"], rep["idle_share"], rep["passes"]))
        del pred, bare
    # the Predictor's own launches: the bare executors' reference forwards
    # are not the path's
    launches = {n: c - bare_launched[n] for n, c in counts(kernels).items()}
    if launches != expect:
        fail("the quantize_model deploy's Predictors launched %s over the phase, expected "
             "%s (launches a forward x forwards)" % (launches, expect))
    res["quantize_model_launches"] = launches
    say("predictor_resnet on %s: %s" % (card, json.dumps(res)))
    return launches, res, dict(sfile=sfile, pfile=pfile, qfile=qfile, qpfile=qpfile,
                               table=table, image=image,
                               launches_per_forward=(got["quantize_int8"], got["dequantize_int8"]))


def record_batches(eng):
    """Have ``eng`` log every batch its device loop dispatches, as (requests,
    bucket) in dispatch order -> the log (a list that grows)."""
    log = []
    dispatch = eng._dispatch

    def recorded(reqs, bucket):
        log.append((list(reqs), bucket))
        return dispatch(reqs, bucket)

    eng._dispatch = recorded
    return log


def check_replies(log, base, what):
    """Every reply of the logged batches (SERVE_OUTPUTS: fc1's logits and
    the probabilities) held against a Predictor of its bucket
    (``base.with_shapes``) forwarded on a batch that holds the same rows at
    the same offsets, zeros elsewhere: equal bit for bit (eval rows do not
    mix), else the phase fails with the largest difference.  The logits are
    compared because the softmax of these random weights saturates to one
    hot rows that a TF32-rounded forward leaves unchanged.  Each reply must
    also be finite, (n, 1000), with rows of probabilities summing to 1
    within 1e-5.  -> summary."""
    refs, unequal, max_abs = {}, 0, 0.0
    for reqs, bucket in log:
        ref = refs.get(bucket.key)
        if ref is None:
            ref = refs[bucket.key] = base.with_shapes(bucket.input_shapes())
        x = np.zeros((bucket.batch,) + bucket.sample_shape("data"), np.float32)
        off = 0
        for req in reqs:
            x[off:off + req.n] = req.inputs["data"]
            off += req.n
        want = [o.float().cpu().numpy() for o in ref.forward(data=x)]
        off = 0
        for req in reqs:
            got = req.result(0)
            if [g.shape for g in got] != [(req.n, 1000)] * 2 or \
                    not all(np.isfinite(g).all() for g in got):
                fail("%s: a reply of shapes %s, finite %s" % (
                    what, [g.shape for g in got], [np.isfinite(g).all() for g in got]))
            if np.abs(got[1].sum(1) - 1).max() > 1e-5:
                fail("%s: a reply's rows sum to %s" % (what, got[1].sum(1)))
            for g, w in zip(got, want):
                w = w[off:off + req.n]
                if not np.array_equal(g, w):
                    unequal += 1
                    max_abs = max(max_abs, float(np.abs(g - w).max()))
            off += req.n
    if unequal:
        fail("%s: %d replies differ from their bucket's Predictor, largest |diff| %g"
             % (what, unequal, max_abs))
    return dict(batches_checked=len(log), replies_checked=sum(len(r) for r, _ in log))


def drive_clients(submit, jobs, timeout=120.0):
    """Closed-loop clients, one thread per list of ``jobs``: each submits its
    inputs one by one and waits for each reply.  -> (the requests in order,
    wall seconds from the first submit to the last reply)."""
    done = [[] for _ in jobs]
    errors = []

    def client(i):
        try:
            for x in jobs[i]:
                req = submit(x)
                req.result(timeout)
                done[i].append(req)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(jobs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout * 4)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail("serving clients failed: %r" % (errors[:3],))
    return [r for reqs in done for r in reqs], wall


def latency_ms(reqs):
    lat = sorted(r.latency_s * 1e3 for r in reqs)
    return dict(p50_ms=lat[len(lat) // 2], p99_ms=lat[min(len(lat) - 1, int(len(lat) * 0.99))])


def batch_fill(log):
    """Mean fill and mean padding waste of the logged ladder batches."""
    ladder = [(sum(r.n for r in reqs), b.batch) for reqs, b in log if not b.direct]
    fills = [n / b for n, b in ladder]
    return dict(batches=len(log), ladder_batches=len(ladder),
                mean_fill=statistics.mean(fills) if fills else None,
                mean_padding_waste=1 - statistics.mean(fills) if fills else None)


def serve_jobs(rng, clients, requests, max_n, image, pool=None):
    """Per-client lists of request inputs: sizes 1..max_n from ``rng``, N(0, 1)
    images (drawn from ``pool``, a list of ready arrays, where given)."""
    jobs = [[] for _ in range(clients)]
    for i in range(requests):
        n = int(rng.randint(1, max_n + 1))
        x = (pool[int(rng.randint(len(pool)))][:n] if pool is not None
             else rng.standard_normal((n,) + image).astype(np.float32))
        jobs[i % clients].append({"data": x})
    return jobs


def serve_engine_fp32(kernels, deploy, card):
    """(a): ResNet-50 v2 fp32 through an Engine on pow2_ladder(32)."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.predictor import Predictor

    image = deploy["image"]
    rng = np.random.RandomState(SEED + 16)
    jobs = serve_jobs(rng, SERVE_CLIENTS, SERVE_REQUESTS, SERVE_MAX_N, image)
    for i in range(SERVE_DIRECT[0]):  # the direct requests, mid-stream
        jobs[i].insert(len(jobs[i]) // 2, {"data": rng.standard_normal(
            (SERVE_DIRECT[1],) + image).astype(np.float32)})
    kernels.reset_launches()
    eng = serving.Engine(deploy["sfile"], deploy["pfile"], {"data": image},
                         output_names=SERVE_OUTPUTS,
                         ladder=serving.BucketLadder(serving.pow2_ladder(SERVE_LADDER_TOP)),
                         max_direct_batch=128, name="resnet50-fp32",
                         start=False)
    try:
        report = eng.warmup()
        if [r["fresh"] for r in report] != [True] * 6:
            fail("serve_engine fp32: warmup rows %s, expected six fresh" % report)
        say("serve_engine fp32 warmup: %s" % ", ".join(
            "%s %.3f s" % (r["bucket"], r["compile_s"]) for r in report))
        compiles = eng.stats()["compiles"]
        log = record_batches(eng)
        eng.start()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reqs, wall = drive_clients(eng.submit, jobs)
        peak = torch.cuda.max_memory_allocated() / 2**30
        stats = eng.stats()
        if stats["compiles"] != compiles + 1:
            fail("serve_engine fp32: %d compiles after warmup's %d; expected one more, the "
                 "direct signature" % (stats["compiles"], compiles))
        # one profiled window: 4 requests of 8 samples at once
        window = [{"data": jobs[0][k]["data"][:1].repeat(8, 0)} for k in range(4)]
        n_traffic = len(log)
        prof = device_profile(lambda: [r.result(60) for r in [eng.submit(x) for x in window]],
                              reps=1)
        log_window = log[n_traffic:]
    finally:
        eng.close()
    if any(counts(kernels).values()):
        fail("serve_engine fp32 launched %s" % counts(kernels))
    base = Predictor(deploy["sfile"], deploy["pfile"], {"data": (1,) + image},
                     output_names=SERVE_OUTPUTS)
    checked = check_replies(log, base, "serve_engine fp32")
    if checked["batches_checked"] < 16:
        fail("serve_engine fp32: %d batches checked, fewer than 16" % checked["batches_checked"])
    samples = sum(r.n for r in reqs)
    kpc = prof.get("kernels_per_call")
    res = dict(requests=len(reqs), samples=samples, wall_s=wall, requests_per_s=len(reqs) / wall,
               samples_per_s=samples / wall, **latency_ms(reqs), **batch_fill(log[:n_traffic]),
               compiles=stats["compiles"], warmup_compile_s=[r["compile_s"] for r in report],
               peak_gib=peak, direct=stats["direct"],
               window=dict(batches=len(log_window), buckets=[repr(b) for _, b in log_window],
                           kernels_per_batch=kpc / len(log_window) if kpc else None,
                           device_busy_ms=prof.get("device_busy_ms"),
                           idle_share=prof.get("idle_share"),
                           traced_wall_ms=prof.get("traced_wall_ms")),
               **checked)
    say("serve_engine fp32 (ResNet-50 v2, 224², ladder %s, %d clients) on %s: %.1f requests/s, "
        "%.1f samples/s, p50 %.2f ms, p99 %.2f ms, %d batches, mean fill %.3f, padding waste "
        "%.3f, peak %.3f GiB; window %s; %d replies in %d batches equal to their bucket's "
        "Predictor"
        % (serving.pow2_ladder(SERVE_LADDER_TOP), SERVE_CLIENTS, card, res["requests_per_s"],
           res["samples_per_s"], res["p50_ms"], res["p99_ms"], res["batches"], res["mean_fill"],
           res["mean_padding_waste"], peak, json.dumps(res["window"]),
           res["replies_checked"], res["batches_checked"]))
    return res, jobs, reqs


def serve_engine_deploy(kernels, deploy, card, fp32_jobs, fp32_reqs):
    """(b): the quantize_model deploy through an Engine: the int8 pair's
    launches = launches a forward x the Engine's forwards."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.predictor import Predictor

    image = deploy["image"]
    flat = [x for job in fp32_jobs for x in job if x["data"].shape[0] <= SERVE_MAX_N]
    inputs = flat[:SERVE_DEPLOY_REQUESTS]
    jobs = [inputs[i::SERVE_DEPLOY_CLIENTS] for i in range(SERVE_DEPLOY_CLIENTS)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    eng = serving.Engine(deploy["qfile"], deploy["qpfile"], {"data": image},
                         output_names=SERVE_OUTPUTS,
                         ladder=serving.BucketLadder(SERVE_DEPLOY_LADDER), name="resnet50-int8",
                         start=False)
    try:
        report = eng.warmup()
        log = record_batches(eng)
        eng.start()
        reqs, wall = drive_clients(eng.submit, jobs)
    finally:
        eng.close()
    torch.cuda.synchronize()
    launches = counts(kernels)
    stats = eng.stats()
    forwards = len(report) + stats["batches"]
    # launches a forward: the int8 nodes of the bucket plans, as
    # predictor_resnet measured them a forward of its Predictors
    n_q, n_dq = deploy["launches_per_forward"]
    for bucket in eng.ladder.signatures(eng.sample_shapes):
        if plan_int8_nodes(eng._cache[bucket.key]._exec) != (n_q, n_dq):
            fail("serve_engine deploy: bucket %s's plan has int8 nodes %s, the Predictor's %s"
                 % (bucket, plan_int8_nodes(eng._cache[bucket.key]._exec), (n_q, n_dq)))
    expect = only(launches, quantize_int8=n_q * forwards, dequantize_int8=n_dq * forwards)
    if launches != expect:
        fail("serve_engine deploy: launched %s over %d forwards (%d warmup + %d batches), "
             "expected %d / %d a forward" % (launches, forwards, len(report), stats["batches"],
                                            n_q, n_dq))
    checked = check_replies(log, Predictor(deploy["qfile"], deploy["qpfile"],
                                           {"data": (1,) + image}, output_names=SERVE_OUTPUTS),
                            "serve_engine deploy")
    # top-1 against (a)'s fp32 replies to the same samples
    fp32_reply = {id(r.inputs["data"]): r.result(0)[0] for r in fp32_reqs}
    agree = [float((r.result(0)[0].argmax(1) == fp32_reply[id(r.inputs["data"])].argmax(1)).mean())
             for r in reqs if id(r.inputs["data"]) in fp32_reply]
    samples = sum(r.n for r in reqs)
    res = dict(requests=len(reqs), samples=samples, wall_s=wall, samples_per_s=samples / wall,
               **latency_ms(reqs), **batch_fill(log), warmup_compile_s=[r["compile_s"] for r in report],
               forwards=forwards, launches_per_forward={"quantize_int8": n_q, "dequantize_int8": n_dq},
               launches=launches, top1_agreement_vs_fp32=statistics.mean(agree) if agree else None,
               **checked)
    say("serve_engine quantize_model deploy (ladder %s, %d clients) on %s: %s"
        % (SERVE_DEPLOY_LADDER, SERVE_DEPLOY_CLIENTS, card, json.dumps(res)))
    return launches, res


def serve_engine_router(kernels, deploy, card):
    """(c): a Router over the registered fp32 / bf16 / int8 twins: paid
    alone, a best_effort flood until the policy degrades, the restore,
    and the int8 pool."""
    from mxnet_tpu_torch import serving

    image = deploy["image"]
    rng = np.random.RandomState(SEED + 17)
    paid_pool = [rng.standard_normal((4,) + image).astype(np.float32) for _ in range(16)]
    flood_pool = [rng.standard_normal((4,) + image).astype(np.float32) for _ in range(16)]
    kernels.reset_launches()
    t0 = time.perf_counter()
    model = serving.ModelRegistry().register(
        "resnet50", deploy["sfile"], deploy["pfile"], {"data": image}, tiers=TIERS,
        calibration=deploy["table"], output_names=SERVE_OUTPUTS,
        ladder=serving.BucketLadder(ROUTER_LADDER),
        max_queue=ROUTER_MAX_QUEUE)
    register_s = time.perf_counter() - t0
    cfg = serving.PolicyConfig(mode="degrade", **ROUTER_POLICY)
    r = serving.Router(model, replicas=1, policy=cfg, name="resnet50", start=False)
    logs = {}
    try:
        warm = r.warmup()
        logs = {t: record_batches(r.engines(t)[0]) for t in TIERS}
        r.start()
        # step 1: paid traffic alone
        paid1, _ = drive_clients(lambda x: r.submit(x, priority="paid"), serve_jobs(
            rng, 2, 30, 4, image, paid_pool))
        st = r.stats()
        if {q.tier for q in paid1} != {"fp32"} or {q.routed_tier for q in paid1} != {"fp32"} \
                or st["downgrades"]:
            fail("serve_engine router: paid alone went to %s, downgrades %d"
                 % ({q.tier for q in paid1}, st["downgrades"]))
        # step 2: a best_effort flood beside paid traffic, until degrade
        stop = threading.Event()
        done = {"paid": [], "best_effort": []}
        sheds, errors = [0], []

        def client(prio, pool, seed):
            crng = np.random.RandomState(seed)
            try:
                while not stop.is_set():
                    x = {"data": pool[int(crng.randint(len(pool)))]}
                    try:
                        q = r.submit(x, priority=prio)
                    except serving.ServerBusy:
                        sheds[0] += 1
                        time.sleep(0.001)
                        continue
                    q.result(60)
                    done[prio].append(q)
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=client, args=("best_effort", flood_pool, 100 + i))
                   for i in range(ROUTER_FLOOD_CLIENTS)]
        threads += [threading.Thread(target=client, args=("paid", paid_pool, 200 + i))
                    for i in range(2)]
        t_flood = time.perf_counter()
        for t in threads:
            t.start()
        t_degrade = None
        while time.perf_counter() - t_flood < ROUTER_DEGRADE_WAIT_S:
            if r.stats()["router"]["route"]["best_effort"] != "fp32":
                t_degrade = time.perf_counter() - t_flood
                break
            time.sleep(0.01)
        if t_degrade is not None:  # flood on until bf16 has served some
            while time.perf_counter() - t_flood < t_degrade + ROUTER_DEGRADE_WAIT_S and \
                    sum(q.tier == "bf16" for q in list(done["best_effort"])) < 8:
                time.sleep(0.01)
        stop.set()
        for t in threads:
            t.join(120)
        t_stop = time.perf_counter()
        if errors or any(t.is_alive() for t in threads):
            fail("serve_engine router flood: %r" % (errors[:3],))
        if t_degrade is None:
            fail("serve_engine router: no degrade within %d s of the flood (signals %s)"
                 % (ROUTER_DEGRADE_WAIT_S, r.stats()["router"]["signals"]))
        paid_tiers = {q.tier for q in done["paid"]}
        be_tiers = [q.tier for q in done["best_effort"]]
        if paid_tiers - {"fp32"} or "bf16" not in be_tiers:
            fail("serve_engine router flood: paid replies on %s, best_effort on %s"
                 % (paid_tiers, set(be_tiers)))
        # step 3: the route returns to native after the flood
        t_restore = None
        while time.perf_counter() - t_stop < ROUTER_POLICY["hold_s"] + 5:
            if r.stats()["router"]["route"]["best_effort"] == "fp32":
                t_restore = time.perf_counter() - t_stop
                break
            time.sleep(0.01)
        if t_restore is None:
            fail("serve_engine router: still degraded %.1f s after the flood"
                 % (ROUTER_POLICY["hold_s"] + 5))
        # step 4: the int8 pool
        int8_reqs, _ = drive_clients(r.engines("int8")[0].submit,
                                     serve_jobs(rng, 1, 8, 8, image, paid_pool + flood_pool))
        if {q.tier for q in int8_reqs} != {"int8"}:
            fail("serve_engine router int8 pool: tiers %s" % {q.tier for q in int8_reqs})
        stats = r.stats()
    finally:
        r.close()
    if any(counts(kernels).values()):
        fail("serve_engine router launched %s" % counts(kernels))
    res = dict(register_s=register_s, warmup_compile_s={
        k: [row["compile_s"] for row in v] for k, v in warm.items()},
        paid_alone=dict(requests=len(paid1), **latency_ms(paid1)),
        flood=dict(seconds=t_stop - t_flood, degrade_after_s=t_degrade, restore_after_s=t_restore,
                   paid=dict(requests=len(done["paid"]), tiers=sorted(paid_tiers),
                             **latency_ms(done["paid"])),
                   best_effort=dict(requests=len(be_tiers), on_bf16=be_tiers.count("bf16"),
                                    **latency_ms(done["best_effort"])),
                   client_retries_on_shed=sheds[0]),
        transitions=stats["router"]["transitions"], priorities=stats["router"]["priorities"],
        pools={})
    for tier in TIERS:
        pool = dict(**batch_fill(logs[tier]), **check_replies(
            logs[tier], model.twin(tier), "serve_engine router %s pool" % tier))
        served = [q for reqs, _ in logs[tier] for q in reqs]
        if served:
            pool.update(latency_ms(served))
        res["pools"][tier] = pool
    say("serve_engine router (ResNet-50 v2 fp32 / bf16 / int8 twins, ladder %s, policy %s) on "
        "%s: %s" % (ROUTER_LADDER, ROUTER_POLICY, card, json.dumps(res)))
    return res


def phase_serve_engine(kernels, card, deploy):
    """The serving Engine and Router on predictor_resnet's files: (a) fp32
    through an Engine, (b) the quantize_model deploy through an Engine, the
    int8 pair counted, (c) a Router over the three tiers.  They serve with
    TF32 and the reduced-precision reductions allowed outside the forwards,
    as a user may have them: each forward's ``full_fp32`` must hold them
    off although the Router's three device loops enter and leave it at
    once (the reference Predictors run on this thread).  -> (launch counts
    of (b), report)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else card
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    mm.allow_bf16_reduced_precision_reduction = True
    res = {}
    try:
        res["fp32"], jobs, reqs = serve_engine_fp32(kernels, deploy, card)
        launches, res["deploy"] = serve_engine_deploy(kernels, deploy, card, jobs, reqs)
        del jobs, reqs
        res["router"] = serve_engine_router(kernels, deploy, card)
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = saved
    torch.cuda.empty_cache()
    return launches, res


def phase_small_predictor(dev):
    """The tiny deploy twin and a CIFAR ResNet-8 v2 as Predictors on the card
    against the CPU from the same weights, each tier's int8 twin from one
    table calibrated on the CPU: fp32 within rtol 1e-4, the twins within
    their tier's tolerance."""
    from mxnet_tpu_torch import symbol as sym
    from mxnet_tpu_torch.graph_passes import precision
    from mxnet_tpu_torch.models import resnet_symbol
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.test_utils import deploy_twin_checkpoint

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 15)
    with sym.NameManager():
        twin, twin_params, twin_shapes = deploy_twin_checkpoint(batch=2, image=16, seed=SEED + 15)
    with sym.NameManager():
        res8 = resnet_symbol.get_symbol(10, 8, "3,32,32")
    args, aux = resnet_params(res8, (1, 3, 32, 32), gen, cpu)
    res8_params = {**{"arg:" + k: v for k, v in args.items()},
                   **{"aux:" + k: v for k, v in aux.items()}}
    worst = {}
    for name, net, params, shapes in (("deploy twin", twin, twin_params, twin_shapes),
                                      ("CIFAR ResNet-8", res8, res8_params,
                                       {"data": (4, 3, 32, 32)})):
        shape = shapes["data"]
        x = torch.rand(shape, generator=gen)
        preds = {d: Predictor(net, params, shapes, device=d) for d in (cpu, dev)}
        table = precision.calibrate(preds[cpu], [{"data": torch.rand(shape, generator=gen)}
                                                 for _ in range(2)])
        for tier in TIERS:
            outs = [[o.float().cpu() for o in preds[d].with_precision(
                tier, table if tier == "int8" else None).forward(data=x.to(d))]
                for d in (cpu, dev)]
            tol = dict(rtol=1e-4, atol=1e-6) if tier == "fp32" else \
                precision.tier_tolerance(tier)
            for ref, got in zip(*outs):
                torch.testing.assert_close(got, ref, **tol, msg=lambda m: "small predictor "
                                           "%s %s: %s" % (name, tier, m))
            worst["%s %s" % (name, tier)] = max(float((g - r).abs().max())
                                                for r, g in zip(*outs))
    say("small input, predictor: the deploy twin and CIFAR ResNet-8 v2, fp32 / bf16 / int8 "
        "tiers, card against CPU, max |card - CPU| %s" % json.dumps(worst))


def imperative_rfcn_args(*argv):
    from mxnet_tpu_torch.examples.deformable_rfcn import train as example

    return example.parser().parse_args(list(argv))


def imperative_rfcn_card_vs_cpu(dev, shape, steps):
    """The example's first ``steps`` steps at ``shape`` on the CPU (the plain
    versions) and on the card, in full fp32, from the same weights, batch and
    anchor sampling -> [(CPU losses, CPU update), (card losses, card update)]:
    each step's (loss, parts), and each parameter's change over the first
    step (numpy)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.examples.deformable_rfcn import train as example

    args = imperative_rfcn_args()
    out, start = [], None
    for ctx in (mx.cpu(), mx.gpu(dev.index)):
        with ctx, mx.full_fp32():
            mx.random.seed(SEED)
            net, trainer = example.build(args.num_classes, args.lr, ctx)
            batch = next(iter(example.synthetic_batches(
                args.batch_size, shape, 1, args.num_classes, seed=SEED + 41, ctx=ctx)))
            with autograd.pause():
                net(*batch[:2])  # predict mode: completes the deferred shapes
            params = net.collect_params()
            if start is None:
                start = {k: p.data().asnumpy() for k, p in params.items()}
            else:
                for k, p in params.items():
                    p.set_data(torch.from_numpy(start[k]))
            step = example.make_train_step(net, trainer, args.batch_size, args.num_classes,
                                           anchor_rng=np.random.RandomState(SEED + 41))
            losses = [step(*batch)]
            update = {k: p.data().asnumpy() - start[k] for k, p in params.items()}
            losses += [step(*batch) for _ in range(steps - 1)]
            out.append((losses, update))
        del net, trainer, step, batch, params
    return out


def check_imperative_rfcn_card_vs_cpu(dev, shape, steps):
    """Hold the card's first steps at ``shape`` against the CPU's
    (``IMPERATIVE_RFCN_RTOL``, ``IMPERATIVE_RFCN_UPDATE_RTOL``) -> the
    readings."""
    (ref_losses, ref_upd), (got_losses, got_upd) = imperative_rfcn_card_vs_cpu(dev, shape, steps)
    tag = "imperative_rfcn %dx%d card vs CPU" % shape[1:]
    (ref_loss, ref_parts), (got_loss, got_parts) = ref_losses[0], got_losses[0]
    for what, a, b in [("loss", got_loss, ref_loss)] + [
            ("part %d" % i, x, y) for i, (x, y) in enumerate(zip(got_parts, ref_parts))]:
        if not math.isclose(a, b, rel_tol=IMPERATIVE_RFCN_RTOL, abs_tol=1e-6):
            fail("%s: step 1 %s %.7f against %.7f" % (tag, what, a, b))
    norm = lambda v: math.sqrt(float((v.astype(np.float64) ** 2).sum()))  # noqa: E731
    whole = math.sqrt(sum(norm(r) ** 2 for r in ref_upd.values()))
    floor = IMPERATIVE_RFCN_UPDATE_RTOL["floor"] * whole
    per_param = {k: norm(got_upd[k] - r) / max(norm(r), floor) for k, r in ref_upd.items()
                 if k not in IMPERATIVE_RFCN_ROUNDING_ONLY}
    moved = sum(1 for k in per_param if norm(ref_upd[k]) >= floor)
    total = math.sqrt(sum(norm(got_upd[k] - r) ** 2 for k, r in ref_upd.items())) / whole
    worst = max(per_param, key=per_param.get)
    if not (moved > 10 and total <= IMPERATIVE_RFCN_UPDATE_RTOL["update"]
            and per_param[worst] <= IMPERATIVE_RFCN_UPDATE_RTOL["update_param"]):
        fail("%s: the first step's update apart by %.3g of the CPU's over all %d "
             "parameters (%d above the floor), %.3g at %s" % (
                 tag, total, len(ref_upd), moved, per_param[worst], worst))
    later = [(g[0], r[0]) for g, r in zip(got_losses[1:], ref_losses[1:])]
    if not all(math.isclose(g, r, rel_tol=IMPERATIVE_RFCN_UPDATE_RTOL["later"])
               for g, r in later):
        fail("%s: later steps' losses %s (card, CPU)" % (tag, later))
    say("%s: step 1 loss %.7f / %.7f, its update %.3g of the CPU's apart over %d "
        "parameters (%d above the floor; worst %.3g at %s); losses of steps 1-%d card %s / CPU %s"
        % (tag, got_loss, ref_loss, total, len(ref_upd), moved, per_param[worst], worst,
           steps, ["%.6f" % g[0] for g in got_losses], ["%.6f" % r[0] for r in ref_losses]))
    return dict(losses=[g[0] for g in got_losses], cpu_losses=[r[0] for r in ref_losses],
                parts=got_parts, cpu_parts=ref_parts, update_rel_error=total,
                worst_param=worst, worst_param_rel_error=per_param[worst])


def detached(calls):
    """Captured calls without their autograd graphs."""
    d = lambda a: a.detach() if isinstance(a, torch.Tensor) else a  # noqa: E731
    return [(tuple(d(a) for a in args), {k: d(v) for k, v in kw.items()})
            for args, kw in calls]


def phase_imperative_rfcn(kernels, dev, card):
    """The port's copy of examples/deformable_rfcn/train.py on the card,
    through ``mx.nd``, ``autograd.record`` and ``gluon.Trainer``: the
    example's own run (3 epochs x 6 batches, 3x64x64, batch 2; its loss must
    fall), then ``--bench`` at 3x64x64 and 3x512x512, batch 2, 10 steps
    each (ms a step, launches a step of each path kernel, every one > 0;
    the five kernels' calls of one more step captured for the kernel rows),
    then the first steps at each shape against the CPU.  Returns the counts
    of the example's run, the results and the captured calls."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.deformable_rfcn import train as example

    gpu = mx.gpu(dev.index)
    res, captured = {}, {n: [] for n in example.PATH_KERNELS}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with gpu:
        first, last = example.train(imperative_rfcn_args(), gpu)
    res["train"] = dict(first_epoch_loss=first, last_epoch_loss=last,
                        seconds=time.perf_counter() - t0)
    launches = counts(kernels)
    idle = [n for n in example.PATH_KERNELS if not launches[n]]
    if idle:
        fail("imperative_rfcn: the example's run launched no %s (%s)" % (idle, launches))
    for shape in IMPERATIVE_RFCN_SHAPES:
        args = imperative_rfcn_args("--bench", "--bench-iters", str(IMPERATIVE_RFCN_ITERS),
                                    "--data-shape", *map(str, shape))
        with gpu:
            step, batch = prepared = example.prepare_bench(args, gpu)
            calls = capture_calls(kernels, example.PATH_KERNELS, lambda: step(*batch))
            ms, per_step, losses = example.bench(args, gpu, prepared)
        del prepared, step, batch
        if not all(math.isfinite(v) for v in losses):
            fail("imperative_rfcn bench %s: losses %s" % (shape, losses))
        idle = [n for n in example.PATH_KERNELS if not per_step[n] > 0]
        if idle:
            fail("imperative_rfcn bench %s: no launch of %s a step" % (shape, idle))
        for n, c in calls.items():
            if len(c) != per_step[n]:
                fail("imperative_rfcn bench %s: captured %d %s calls in a step, %s a step "
                     "launched" % (shape, len(c), n, per_step[n]))
            captured[n] += detached(c)
        res["bench_%dx%d" % shape[1:]] = dict(ms_per_step=ms, launches_per_step=per_step,
                                              losses=losses)
        say("imperative_rfcn bench on %s: 3x%dx%d batch 2, %.2f ms a step, launches a "
            "step %s; losses %s; captured calls %s" % (
                card, shape[1], shape[2], ms, json.dumps(per_step),
                ", ".join("%.4f" % v for v in losses),
                {n: [[tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
                     for args, _ in c] for n, c in calls.items()}))
    for shape in IMPERATIVE_RFCN_SHAPES:
        res["card_vs_cpu_%dx%d" % shape[1:]] = check_imperative_rfcn_card_vs_cpu(
            dev, shape, IMPERATIVE_RFCN_CPU_STEPS[shape])
    say("imperative_rfcn on %s: the example's loss %.4f -> %.4f over 3 epochs; launches %s"
        % (card, first, last, json.dumps({n: launches[n] for n in example.PATH_KERNELS})))
    return launches, res, captured


def imperative_resnet_loop(net, trainer, loss_fn):
    import mxnet_tpu_torch as mx

    def step(x, y):
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        return loss
    return step


class WeightDecayed(torch.nn.Module):
    """``net`` whose forward also returns (wd/2)·Σ‖p‖² over its learnables:
    ``make_train_step`` over it, with a loss that adds the term, takes the
    wd·p gradient that the SGD optimizer's weight decay adds."""

    def __init__(self, net, wd):
        super().__init__()
        self.net, self.wd = net, wd

    def gluon_named_tensors(self):
        return self.net.gluon_named_tensors()

    def forward(self, x):
        learn = [p for p in self.net.parameters() if p.requires_grad]
        return self.net(x), 0.5 * self.wd * sum((p * p).sum() for p in learn)


def imperative_resnet_run(dev, dtype, timed):
    """ResNet-50 v1 3 steps through ``autograd.record`` and ``Trainer`` and
    3 steps of ``make_train_step`` from the same weights on the same batches,
    in ``dtype`` under deterministic cuDNN; beside them in fp32 a second
    ``make_train_step`` run (which must repeat the first's bits) and the two
    loops timed in turns, in float64 a ``make_train_step`` run started one
    ulp up.  -> (losses, ms, the distance after each step of each other
    run's weights from make_train_step's, over make_train_step's update
    since the start)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.functional import make_train_step
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    sgd = IMPERATIVE_RESNET_SGD
    twin = "make_train_step_twin" if timed else "make_train_step_one_ulp_up"
    labels = ["imperative", "make_train_step", twin]
    nets = [resnet50_v1(classes=RESNET_CLASSES, device=dev,
                        generator=torch.Generator().manual_seed(SEED + 51)).to(dtype)
            for _ in labels]
    imp, ref = nets[:2]
    if not timed:
        with torch.no_grad():
            for p in nets[2].parameters():
                if p.requires_grad:
                    p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
    start = {k: t.detach().clone() for k, t in ref.gluon_named_tensors().items()}
    trainer = mx.gluon.Trainer(imp.collect_params(), "sgd", dict(sgd))
    steps = {"imperative": imperative_resnet_loop(imp, trainer, SoftmaxCrossEntropyLoss())}
    states, ce = {}, {}
    loss_block = SoftmaxCrossEntropyLoss()

    def decayed_loss(out, y):
        logits, decay = out
        ce["loss"] = loss_block(logits, y)
        return ce["loss"] + decay

    for label, net in zip(labels[1:], nets[1:]):
        steps[label], states[label], _ = make_train_step(
            WeightDecayed(net, sgd["wd"]), decayed_loss, learning_rate=sgd["learning_rate"],
            momentum=sgd["momentum"])
    want = ref.gluon_named_tensors()

    @torch.no_grad()
    def apart(net):
        got = net.gluon_named_tensors()
        sq = lambda d: sum(float(v.double().pow(2).sum()) for v in d)  # noqa: E731
        return math.sqrt(sq(got[k] - want[k] for k in want)
                         / sq(want[k] - start[k] for k in want))

    losses, times = {k: [] for k in steps}, {k: [] for k in steps}
    distance = {labels[0]: [], labels[2]: []}
    with mx.full_fp32(), torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                                    deterministic=True):
        for i in range(IMPERATIVE_RESNET_STEPS):
            x, y = resnet_batch(RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES, SEED + 51 + i, dev)
            x, y = x.to(dtype), y.to(dtype)
            for label, step in steps.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if label == "imperative":
                    loss = step(mx.nd.NDArray(x), mx.nd.NDArray(y)).mean().asscalar()
                else:
                    states[label], _ = step(states[label], x, y)
                    loss = ce["loss"].detach().mean()
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t0) * 1e3)
                losses[label].append(float(loss))
            for label, net in ((labels[0], imp), (labels[2], nets[2])):
                distance[label].append(apart(net))
    del nets, imp, ref, states, steps, trainer
    torch.cuda.empty_cache()
    return losses, times, distance


def phase_imperative_resnet(kernels, dev, card):
    """ResNet-50 v1 (1000 classes, 224x224, batch 32) trained 3 steps
    through ``autograd.record`` -> ``SoftmaxCrossEntropyLoss`` ->
    ``backward`` -> ``Trainer("sgd", IMPERATIVE_RESNET_SGD).step(32)``
    against 3 steps of ``make_train_step`` with the same SGD, in fp32 (timed
    in turns) and in float64: the losses and the weights after every step
    must agree (``IMPERATIVE_RESNET_RTOL``), and in float64 the weights
    must stay closer to make_train_step's than those of make_train_step
    started one ulp up.  The path reaches no ported kernel.  Returns the
    counts and the results."""
    kernels.reset_launches()
    runs = {"float32": imperative_resnet_run(dev, torch.float32, timed=True),
            "float64": imperative_resnet_run(dev, torch.float64, timed=False)}
    launches = counts(kernels)
    if any(launches.values()):
        fail("the imperative resnet path launched %s" % launches)
    res = {}
    for dtype, (losses, times, distance) in runs.items():
        tol = IMPERATIVE_RESNET_RTOL[dtype]
        imp_l, ref_l = losses["imperative"], losses["make_train_step"]
        loss_err = [abs(a - b) / abs(b) for a, b in zip(imp_l, ref_l)]
        errors = distance["imperative"]
        (other, other_d), = ((k, v) for k, v in distance.items() if k != "imperative")
        if not all(math.isfinite(v) for v in imp_l) or any(
                e > t for e, t in zip(loss_err, tol["loss"])):
            fail("imperative resnet %s: losses %s against make_train_step's %s, limits %s"
                 % (dtype, imp_l, ref_l, tol["loss"]))
        if any(e > t for e, t in zip(errors, tol["weights"])) or (
                other == "make_train_step_twin" and any(other_d)) or (
                other == "make_train_step_one_ulp_up" and any(
                    e >= d for e, d in zip(errors, other_d))):
            fail("imperative resnet %s: the weights differ from make_train_step's by %s "
                 "of the update after each step, limits %s (%s: %s)"
                 % (dtype, errors, tol["weights"], other, other_d))
        res[dtype] = dict(losses=losses, weights_rel_error_of_update=errors,
                          loss_rel_error=loss_err, **{other + "_rel_error_of_update": other_d})
        say("imperative resnet50 on %s (batch %d, %s): losses %s / make_train_step %s "
            "(apart %s); weights apart by %s of the update after each step (%s: %s)"
            % (card, RESNET_BATCH, dtype, ", ".join("%.9f" % v for v in imp_l),
               ", ".join("%.9f" % v for v in ref_l), ", ".join("%.3g" % v for v in loss_err),
               ", ".join("%.3g" % v for v in errors), other,
               ", ".join("%.3g" % v for v in other_d)))
        if dtype == "float32":
            res[dtype].update(step_ms=times,
                              median_ms={k: statistics.median(v) for k, v in times.items()})
            say("imperative resnet50 %s ms a step %s / make_train_step %s" % (
                dtype, ", ".join("%.2f" % v for v in times["imperative"]),
                ", ".join("%.2f" % v for v in times["make_train_step"])))
    return launches, res


# -- slice 19: the image-classification recipes, the python loss, the
# optimizers and the rest of the operator registry -----------------------------

def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


class TimedIter:
    """A data iterator that notes the time (after a device synchronisation)
    each time a batch is asked for: the gaps are the batches' times."""

    def __init__(self, it, marks, dev=None):
        self.it, self.marks = it, marks
        self.sync = dev is None or dev.type == "cuda"
        self.batch_size = it.batch_size
        self.provide_data, self.provide_label = it.provide_data, it.provide_label

    def __iter__(self):
        return self

    def __next__(self):
        if self.sync:
            torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        return next(self.it)

    def reset(self):
        self.it.reset()


class SameKeepMasks:
    """Every Dropout call of the port's registry takes ``masks[k % len(masks)]``
    at its k-th call on a device (counted per device type): a card run and a
    CPU run of the same steps drop the same units.  Dropout stays on."""

    def __init__(self, masks):
        from mxnet_tpu_torch.ops import registry

        self.masks, self.calls = masks, {}
        self.opdef = registry.get("Dropout")
        self.fn = self.opdef.fn

    def __enter__(self):
        fn, masks, calls = self.fn, self.masks, self.calls

        def dropout(data, *, p=0.5, axes=(), training=False, keep=None, generator=None):
            if not training:
                return data
            k = calls.get(data.device.type, 0)
            calls[data.device.type] = k + 1
            return fn(data, p=p, axes=axes, training=True,
                      keep=masks[k % len(masks)].to(data.device))

        self.opdef.fn = dropout
        return self

    def __exit__(self, *exc):
        self.opdef.fn = self.fn


def flat_params(mod):
    """A Module's parameters as one float64 CPU vector, in name order."""
    arg = mod.get_params()[0]
    return torch.cat([arg[k].detach().double().cpu().reshape(-1) for k in sorted(arg)])


def rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))


def first_steps_card_vs_cpu(sym, shape, batches, sgd, init, dev, masks=None, start=None,
                            dtype=torch.float32, card_only=0):
    """``len(batches)`` Module steps (training forward, backward, the fit
    harness's SGD through a ``device`` KVStore, as fit.fit runs them) on the
    card and on the CPU, both Modules bound in ``dtype``, from the same
    initial weights (``start``, else the card's draw of ``init``) on the same
    batches (with the same keep masks); then ``card_only`` more steps of the
    last batch on the card alone: -> ([(card loss, CPU loss)], (card's,
    CPU's first update as float64 CPU vectors), the initial weights by
    name, [the card's further losses])."""
    from mxnet_tpu_torch import kvstore
    from mxnet_tpu_torch.io import DataBatch
    from mxnet_tpu_torch.module import Module

    cpu = torch.device("cpu")
    mods = []
    old_dtype = torch.get_default_dtype()
    torch.set_default_dtype(dtype)  # Module.bind makes its tensors in the default dtype
    try:
        for d in (dev, cpu):
            mod = Module(sym, device=d)
            mod.bind(data_shapes=[("data", shape)],
                     label_shapes=[("softmax_label", (shape[0],))])
            if start is None:
                mod.init_params(init)
                start = {k: v.detach().cpu().clone() for k, v in mod.get_params()[0].items()}
            else:
                mod.init_params(arg_params=start)
            mod.init_optimizer(kvstore=kvstore.create("device"), optimizer="sgd",
                               optimizer_params=dict(sgd))
            mods.append(mod)
        w0 = torch.cat([start[k].double().reshape(-1) for k in sorted(start)])
        losses, upd, further = [], None, []
        with SameKeepMasks(masks or []):
            for i, (x, y) in enumerate(batches):
                pair = []
                for d, mod in zip((dev, cpu), mods):
                    mod.forward(DataBatch([x.to(d)], [y.to(d)]), is_train=True)
                    mod.backward()
                    pair.append(cross_entropy(mod, y.to(d)))
                    mod.update()
                losses.append(tuple(pair))
                if i == 0:
                    upd = (flat_params(mods[0]) - w0, flat_params(mods[1]) - w0)
            x, y = batches[-1]
            for _ in range(card_only):
                module_step(mods[0], DataBatch([x.to(dev)], [y.to(dev)]))
                further.append(cross_entropy(mods[0], y.to(dev)))
    finally:
        torch.set_default_dtype(old_dtype)
    if not all(math.isfinite(a) and math.isfinite(b) for a, b in losses):
        fail("card vs CPU: a loss is not finite: %s" % losses)
    return losses, upd, start, further


def batch_times(marks, last=None):
    """(median ms of the last ``last`` batches, all but the first without
    it; the number of batches) from TimedIter's marks (one a batch, and one
    more at the end)."""
    gaps = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return statistics.median(gaps[-last:] if last else gaps[1:]), len(gaps)


def alexnet_epoch(kernels, args, sym, shape):
    """One fit.run epoch of train_imagenet.py's recipe (``args``) on the
    card, timed batch by batch -> (ms a batch over the last ALEXNET_TIMED,
    seconds, peak GiB, ported-kernel launch counts, the Module, whether its
    weights are finite)."""
    from mxnet_tpu_torch.examples.image_classification.common import data, fit

    marks = []

    def loader(a, kv):
        train, val = data.get_rec_iter(a, kv)
        return TimedIter(train, marks), val

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = fit.run(args, sym, loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms, n_batches = batch_times(marks, ALEXNET_TIMED)
    if n_batches != 50:
        fail("imagenet alexnet: %d batches in the epoch, not 50" % n_batches)
    finite = all(bool(torch.isfinite(v).all()) for v in model.get_params()[0].values())
    return ms, seconds, peak, launches, model, finite


def phase_imagenet_alexnet(kernels, dev, card):
    """train_imagenet.py --network alexnet --benchmark 1 through the port's
    fit.fit: see ALEXNET_ARGS.  First the card against the CPU on the first
    two batches from the same Xavier weights and keep masks, through
    ``Module`` and the ``device`` KVStore as fit.fit runs them, in float32
    and in float64 (see ALEXNET_LOSS_RTOL), each card run then going on
    alone for ALEXNET_FURTHER steps (the losses of the divergence); then the
    recipe's epoch of 50 synthetic batches on the card, and the same epoch
    at ALEXNET_FINITE_LR, whose weights stay finite (ms a batch and img/s
    over the last 40, peak memory; one profiled step of the finite run), no
    ported kernel launched.  -> (launch counts, report)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.image_classification import train_imagenet
    from mxnet_tpu_torch.examples.image_classification.common import data, fit
    from mxnet_tpu_torch.examples.image_classification.symbols import alexnet

    say("imagenet alexnet card: %s" % card_line())
    args = train_imagenet.make_parser().parse_args(ALEXNET_ARGS)
    sym = alexnet.get_symbol(**vars(args))
    shape = (args.batch_size,) + tuple(int(v) for v in args.image_shape.split(","))
    arg_shapes = sym.infer_shape(data=shape)[0]
    n_params = sum(math.prod(s) for n, s in zip(sym.list_arguments(), arg_shapes)
                   if n not in ("data", "softmax_label"))
    with mx.cpu():
        it = data.SyntheticDataIter(args.num_classes, shape, 2)
    batches = [(b.data[0], b.label[0]) for b in it]
    gen = torch.Generator().manual_seed(SEED + 190)
    masks = [torch.rand((args.batch_size, 4096), generator=gen) < 0.5 for _ in range(4)]
    sgd = dict(learning_rate=args.lr, momentum=args.mom, wd=args.wd)
    t0 = time.perf_counter()
    losses, (u_card, u_cpu), start, further = first_steps_card_vs_cpu(
        sym, shape, batches, sgd, fit.make_initializer(args.initializer), dev, masks,
        card_only=ALEXNET_FURTHER)
    losses64, (u64_card, u64_cpu), _, further64 = first_steps_card_vs_cpu(
        sym, shape, batches, sgd, None, dev, masks, start=start, dtype=torch.float64,
        card_only=ALEXNET_FURTHER)
    loss_rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in losses]
    loss64_rel = [abs(a - b) / max(abs(b), 1e-30) for a, b in losses64]
    upd_rel, upd64_rel = rel(u_card, u_cpu), rel(u64_card, u64_cpu)
    err_card, err_cpu = rel(u_card, u64_cpu), rel(u_cpu, u64_cpu)
    card_vs_cpu = dict(losses=losses, loss_rel=loss_rel, update_rel=upd_rel,
                       losses_float64=losses64, loss_rel_float64=loss64_rel,
                       update_rel_float64=upd64_rel, fp32_update_error_card=err_card,
                       fp32_update_error_cpu=err_cpu,
                       card_further_losses=further, card_further_losses_float64=further64)
    say("imagenet alexnet card vs CPU (%.1f s): %s" % (time.perf_counter() - t0,
                                                         json.dumps(card_vs_cpu)))
    if loss_rel[0] > ALEXNET_LOSS_RTOL or loss_rel[1] > ALEXNET_LOSS2_RTOL \
            or max(loss64_rel) > ALEXNET_FLOAT64_RTOL or upd64_rel > ALEXNET_FLOAT64_RTOL \
            or err_card > ALEXNET_FP32_ERROR_RATIO * err_cpu:
        fail("imagenet alexnet card vs CPU: %s" % json.dumps(card_vs_cpu))
    ms, seconds, peak, launches, model, finite = alexnet_epoch(kernels, args, sym, shape)
    if any(launches.values()):
        fail("the imagenet alexnet path launched %s" % launches)
    finite_args = train_imagenet.make_parser().parse_args(
        ALEXNET_ARGS + ["--lr", str(ALEXNET_FINITE_LR)])
    ms_f, seconds_f, peak_f, launches_f, model_f, finite_f = alexnet_epoch(
        kernels, finite_args, sym, shape)
    with mx.gpu(0), mx.full_fp32():
        it = data.SyntheticDataIter(args.num_classes, shape, 1)
        batch = next(it)
        prof = device_profile(lambda: module_step(model_f, batch), reps=1, top=6)
        loss_f = cross_entropy(model_f, batch.label[0])
    if any(launches_f.values()) or not finite_f or not loss_f < losses[0][0]:
        fail("imagenet alexnet at lr %g: launches %s, weights finite %s, loss %.4f -> %.4f"
             % (ALEXNET_FINITE_LR, launches_f, finite_f, losses[0][0], loss_f))
    res = dict(params=n_params, epoch_s=seconds, batch_ms=ms,
               img_per_s=args.batch_size / ms * 1e3, peak_gib=peak,
               weights_finite_after=finite,
               finite_lr=dict(lr=ALEXNET_FINITE_LR, epoch_s=seconds_f, batch_ms=ms_f,
                              img_per_s=args.batch_size / ms_f * 1e3, peak_gib=peak_f,
                              loss_first=losses[0][0], loss_after=loss_f),
               card_vs_cpu=card_vs_cpu, profile=prof)
    say("imagenet alexnet (train_imagenet.py --network alexnet --benchmark 1, fit.fit) on %s: "
        "%d parameters, batch %d at %s; at the defaults (lr %g) 50 batches in %.1f s, median "
        "%.2f ms a batch over the last %d, %.1f img/s, peak memory %.2f GiB, weights finite "
        "after: %s (the card's losses on the repeated batch: %s); at lr %g 50 batches in "
        "%.1f s, median %.2f ms a batch, %.1f img/s, peak memory %.2f GiB, loss %.4f -> %.4f; "
        "ported kernel launches a batch 0; %s device kernels a batch, device busy %s ms, idle "
        "share %s" % (card, n_params, args.batch_size, shape[1:], args.lr, seconds, ms,
                      ALEXNET_TIMED, res["img_per_s"], peak, finite,
                      [losses[0][0], losses[1][0]] + further, ALEXNET_FINITE_LR, seconds_f,
                      ms_f, res["finite_lr"]["img_per_s"], peak_f, losses[0][0], loss_f,
                      prof.get("kernels_per_call"), prof.get("device_busy_ms"),
                      prof.get("idle_share")))
    say("imagenet alexnet device groups (lr %g): %s" % (ALEXNET_FINITE_LR, json.dumps(prof)))
    return launches, res


def accuracy_of(mod, it):
    return dict(mod.score(it, "acc"))["accuracy"]


def lenet_epoch(kernels, args, sym, dev):
    """One fit.run epoch of train_mnist.py's recipe (``args``) from
    mx.random seeded with LENET_SEED (the initial weights) and fresh
    iterators (the shuffle's own generator) -> (held-out accuracy of the
    initial weights, after the epoch; ms a batch; batches; seconds; the
    epoch's ported-kernel launch counts; the Module; the initial stn_loc
    weights)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.image_classification import train_mnist
    from mxnet_tpu_torch.examples.image_classification.common import fit
    from mxnet_tpu_torch.module import Module

    ctx = mx.gpu(0) if dev.type == "cuda" else mx.cpu()
    with mx.cpu():
        train, val = train_mnist.get_mnist_iter(args, None)
    with ctx, mx.full_fp32():
        mx.random.seed(LENET_SEED)
        start = Module(sym, device=dev)
        start.bind(data_shapes=train.provide_data, label_shapes=train.provide_label)
        start.init_params(fit.make_initializer(args.initializer))
        before = accuracy_of(start, val)
        loc0 = {k: v.clone() for k, v in start.get_params()[0].items() if k.startswith("stn_")}
        mx.random.seed(LENET_SEED)
    marks = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    model = fit.run(args, sym, lambda a, kv: (TimedIter(train, marks, dev), val))
    seconds = time.perf_counter() - t0
    launches = counts(kernels)
    with ctx, mx.full_fp32():
        after = accuracy_of(model, val)
    ms, n_batches = batch_times(marks)
    return (before, after), ms, n_batches, seconds, launches, model, loc0


def phase_mnist_lenet_stn(kernels, dev, card):
    """lenet.get_symbol(add_stn=True) through fit.fit with train_mnist.py's
    synthetic stand-in: see LENET_ARGS.  The first batch on the card against
    the CPU (loss and update within LENET_RTOL); LENET_CARD_RUNS epochs on the
    card and one on the CPU from the same seed, each one's held-out accuracy
    above its initial weights' by LENET_MIN_GAIN; the transformer's stn_loc
    weight and bias moved; one card epoch at the script's lr (0.05) reported;
    no ported kernel launched.  -> (launch counts of the first card epoch,
    report)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.image_classification import train_mnist
    from mxnet_tpu_torch.examples.image_classification.common import fit
    from mxnet_tpu_torch.examples.image_classification.symbols import lenet

    say("mnist lenet-stn card: %s" % card_line())
    args = train_mnist.make_parser().parse_args(LENET_ARGS)
    sym = lenet.get_symbol(num_classes=args.num_classes, add_stn=True)
    shape = (args.batch_size, 1, 28, 28)
    with mx.cpu():
        train, _ = train_mnist.get_mnist_iter(args, None)
    first = next(iter(train))
    sgd = dict(learning_rate=args.lr, momentum=args.mom, wd=args.wd)
    losses, (u_card, u_cpu), _, _ = first_steps_card_vs_cpu(
        sym, shape, [(first.data[0], first.label[0])], sgd,
        fit.make_initializer(args.initializer), dev)
    loss_rel = abs(losses[0][0] - losses[0][1]) / abs(losses[0][1])
    upd = rel(u_card, u_cpu)
    say("mnist lenet-stn card vs CPU, first batch: loss %s (relative %.3g), update relative "
        "%.3g" % (losses[0], loss_rel, upd))
    if loss_rel > LENET_RTOL or upd > LENET_RTOL:
        fail("mnist lenet-stn card vs CPU: loss %.3g, update %.3g" % (loss_rel, upd))
    runs = []
    for i in range(LENET_CARD_RUNS):
        acc, ms, n_batches, seconds, run_launches, model, loc0 = lenet_epoch(
            kernels, args, sym, dev)
        if i == 0:
            launches, ms0, n0, seconds0 = run_launches, ms, n_batches, seconds
            loc = model.get_params()[0]
            moved = {k: float((loc[k] - v).abs().max()) for k, v in loc0.items()}
        if any(run_launches.values()):
            fail("the mnist lenet-stn path launched %s" % run_launches)
        runs.append(acc)
    cpu_args = train_mnist.make_parser().parse_args(LENET_ARGS + ["--ctx", "cpu"])
    cpu_acc = lenet_epoch(kernels, cpu_args, sym, torch.device("cpu"))[0]
    default_args = train_mnist.make_parser().parse_args(
        [v for v in LENET_ARGS if v not in ("--lr", str(args.lr))])
    default_acc = lenet_epoch(kernels, default_args, sym, dev)[0]
    readings = dict(card=runs, cpu=cpu_acc, card_at_default_lr=default_acc)
    say("mnist lenet-stn held-out accuracy (initial, after one epoch) from mx.random seed %d: "
        "%s" % (LENET_SEED, json.dumps(readings)))
    if not all(b >= a + LENET_MIN_GAIN for a, b in runs + [cpu_acc]):
        fail("mnist lenet-stn: a held-out accuracy rose less than %.2f: %s"
             % (LENET_MIN_GAIN, json.dumps(readings)))
    if not all(m > 0 for m in moved.values()):
        fail("mnist lenet-stn: the transformer did not move: %s" % moved)
    res = dict(batches=n0, epoch_s=seconds0, batch_ms=ms0, accuracy=runs[0],
               accuracy_readings=readings, stn_moved=moved,
               card_vs_cpu=dict(loss=losses[0], loss_rel=loss_rel, update_rel=upd))
    say("mnist lenet-stn (train_mnist.py's stand-in data, lenet add_stn, fit.fit) on %s: "
        "card vs CPU loss %s (relative %.3g), update relative %.3g; %d batches of %d in "
        "%.1f s, median %.2f ms a batch; held-out accuracy %.3f -> %.3f; stn_loc moved by "
        "%s; ported kernel launches 0" % (card, losses[0], loss_rel, upd, n0,
                                          args.batch_size, seconds0, ms0, runs[0][0],
                                          runs[0][1], moved))
    return launches, res


def phase_python_loss(kernels, dev, card):
    """The port's examples/module/python_loss.py on the card: main(epochs=8)
    reaches accuracy > PYTHON_LOSS_MIN_ACC (the JAX test's bar); one epoch on
    the card and one on the CPU give the same scores on every sample within
    PYTHON_LOSS_RTOL; no ported kernel launched.  -> (launch counts,
    report)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.examples.module import python_loss

    say("python loss card: %s" % card_line())
    scores = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx, mx.full_fp32():
            mod, it = python_loss.train(epochs=1)
            it.reset()
            outs = []
            for b in it:
                mod.forward(b, is_train=False)
                outs.append(mod.get_outputs()[0].detach().cpu())
            scores[ctx.device_type] = torch.cat(outs)
    diff = rel(scores["gpu"], scores["cpu"])
    if diff > PYTHON_LOSS_RTOL:
        fail("python loss: the first epoch's scores on the card are %.3g from the CPU's" % diff)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with mx.gpu(0), mx.full_fp32():
        acc = python_loss.main(epochs=8)
    seconds = time.perf_counter() - t0
    launches = counts(kernels)
    if any(launches.values()):
        fail("the python loss path launched %s" % launches)
    if not acc > PYTHON_LOSS_MIN_ACC:
        fail("python loss: accuracy %.3f after 8 epochs" % acc)
    say("python loss (SequentialModule: MLP Module + PythonLossModule hinge) on %s: first "
        "epoch's scores card vs CPU %.3g relative; 8 epochs in %.1f s, accuracy %.3f; "
        "ported kernel launches 0" % (card, diff, seconds, acc))
    return launches, dict(card_vs_cpu=diff, epochs8_s=seconds, accuracy=acc)


def phase_optimizers(kernels, dev, card):
    """One gradient (drawn once) applied to AlexNet's parameter set under each
    optimizer of OPTIMIZER_RUNS on the card and on the CPU: the weights
    within OPTIMIZER_RTOL of the CPU's as a whole, the update's own distance
    reported (LBSGD's layer-wise rate moves a weight by ~1e-5 of itself, so
    the last-bit rounding of the new weights, after norms summed in another
    order, is a large share of that update); SGLD's noise drawn once on the
    host and given to both; then ms a step on the card (median of 3 more
    steps).  -> report."""
    from mxnet_tpu_torch import optimizer
    from mxnet_tpu_torch.examples.image_classification.symbols import alexnet

    say("optimizers card: %s" % card_line())
    sym = alexnet.get_symbol(num_classes=1000)
    shapes = [(n, s) for n, s in zip(sym.list_arguments(),
                                     sym.infer_shape(data=(128, 3, 224, 224))[0])
              if n not in ("data", "softmax_label")]
    gen = torch.Generator().manual_seed(SEED + 191)
    w0 = [torch.randn(s, generator=gen) * 0.05 for _, s in shapes]
    g0 = [torch.randn(s, generator=gen) for _, s in shapes]
    z0 = [torch.randn(s, generator=gen) for _, s in shapes]
    names = dict(enumerate(n for n, _ in shapes))
    rows = {}
    for key, kw in OPTIMIZER_RUNS.items():
        name = key.split("-")[0]
        mp = kw.get("multi_precision", False)
        dtype = torch.bfloat16 if mp else torch.float32
        after, ms = {}, None
        for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
            opt = optimizer.create(name, learning_rate=0.01, wd=1e-4, rescale_grad=1 / 128,
                                   param_idx2name=names, **kw)
            opt.set_wd_mult({})
            if name == "sgld":
                z = [t.to(d, dtype) for t in z0]
                opt.noise_source = lambda i, w, z=z: z[i]
            upd = optimizer.get_updater(opt)
            w = [t.to(d, dtype, copy=True) for t in w0]
            g = [t.to(d, dtype) for t in g0]
            for i in range(len(w)):
                upd(i, g[i], w[i])
            after[where] = torch.cat([t.double().cpu().reshape(-1) for t in w])
            if where == "card":
                times = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for i in range(len(w)):
                        upd(i, g[i], w[i])
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                ms = statistics.median(times)
        start = torch.cat([t.to(dtype).double().reshape(-1) for t in w0])
        w_rel = rel(after["card"], after["cpu"])
        u_rel = rel(after["card"] - start, after["cpu"] - start)
        rows[key] = dict(weights_rel=w_rel, update_rel=u_rel, step_ms=ms)
        if w_rel > OPTIMIZER_RTOL:
            fail("optimizer %s: the card's weights are %.3g from the CPU's" % (key, w_rel))
    say("optimizers on %s, AlexNet's %d tensors (%d values), one gradient: card vs CPU "
        "(weights rel, update rel) and ms a step: %s" % (
            card, len(shapes), sum(t.numel() for t in w0), json.dumps(rows)))
    return rows


def sign_free(case, outs):
    """The factor outputs of ``gelqf`` / ``syevd`` with each row of Q or U
    (and the matching column of L) turned to a positive first nonzero
    entry: a solver may choose either sign."""
    if case.op == "_linalg_gelqf":
        l, q = outs
        s = torch.sign(q[..., :1])
        return [l * s.transpose(-1, -2), q * s]
    if case.op == "_linalg_syevd":
        u, lam = outs
        return [u * torch.sign(u[..., :1]), lam]
    return outs


def sign_free_cotangents(case, outs, cts):
    """Cotangents whose gradient a row's sign does not change: for the
    factors, the gradient of Σ c·x² over the factor outputs."""
    if case.op in ("_linalg_gelqf", "_linalg_syevd"):
        return [2 * c * o.detach() for c, o in zip(cts, outs)]
    return cts


def run_case(case, fn, dev, dtype=None):
    """A registry case on ``dev`` (its inputs in ``dtype`` where given) ->
    (outputs, gradients of Σ outputs · cotangents with respect to its
    differentiable inputs), on the CPU."""
    import mxnet_tpu_torch as mx

    ins = [torch.from_numpy(a.copy()).to(dev, dtype) for a in case.inputs]
    for i in case.grad:
        ins[i].requires_grad_()
    ctx = mx.cpu() if dev.type == "cpu" else mx.gpu(0)
    with ctx, mx.full_fp32():
        res = fn(*ins, **case.attrs)
        outs = list(res) if isinstance(res, (tuple, list)) else [res]
        grads = []
        if case.grad:
            rng = np.random.RandomState(len(case.inputs) + sum(map(ord, case.op)))
            cts = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(np.float32))
                   .to(dev, o.dtype) for o in outs]
            cts = sign_free_cotangents(case, outs, cts)
            grads = torch.autograd.grad(outs, [ins[i] for i in case.grad], cts,
                                        allow_unused=True)
            grads = [torch.zeros(case.inputs[i].shape) if gr is None else gr.detach().cpu()
                     for i, gr in zip(case.grad, grads)]
    return [o.detach().cpu() for o in sign_free(case, outs)], grads


def phase_registry_ops(kernels, dev, card):
    """Each case of ``test_utils.registry_cases`` (the 55 operators this slice
    ports, at the CPU tests' shapes), then CTC at REGISTRY_CTC and
    Deconvolution at REGISTRY_DECONV: forward and gradients on the card
    against the CPU port, within the CPU tests' tolerances (the gradients at
    atol times their largest magnitude; the large CTC and deconvolution
    against float64, REGISTRY_LARGE); gelqf and syevd up to each row's sign.  Every miss is
    listed before the phase fails.  -> report."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    from mxnet_tpu_torch.test_utils import OpCase, register_numpy_softmax, registry_cases

    say("registry ops card: %s" % card_line())
    register_numpy_softmax(mx)
    cases = registry_cases()
    rng = np.random.RandomState(SEED + 192)
    t, n, c = REGISTRY_CTC
    lengths = rng.randint(t // 2, t + 1, n).astype(np.float32)
    labels = rng.randint(1, c, (n, 40)).astype(np.float32)
    label_len = rng.randint(10, 41, n).astype(np.float32)
    cases["_contrib_CTCLoss#deepspeech"] = OpCase(
        "_contrib_CTCLoss", [rng.standard_normal((t, n, c)).astype(np.float32), labels,
                             lengths, label_len],
        dict(use_data_lengths=True, use_label_lengths=True), grad=(0,), rtol=1e-4)
    b, ch, h, w, k, s = REGISTRY_DECONV
    cases["Deconvolution#fcn32s"] = OpCase(
        "Deconvolution", [rng.standard_normal((b, ch, h, w)).astype(np.float32),
                          (rng.standard_normal((ch, ch, k, k)) * 0.01).astype(np.float32)],
        dict(kernel=(k, k), stride=(s, s), num_filter=ch), grad=(0, 1))
    kernels.reset_launches()
    cpu = torch.device("cpu")
    worst, ms, misses = {}, {}, []
    for key in sorted(cases):
        case = cases[key]
        fn = registry.get(case.op).fn
        ref, ref_g = run_case(case, fn, cpu)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, got_g = run_case(case, fn, dev)
        ms[key] = (time.perf_counter() - t0) * 1e3
        pairs = [("output %d" % i, g, r) for i, (g, r) in enumerate(zip(got, ref))]
        pairs += [("d/d input %d" % i, g, r) for i, (g, r) in zip(case.grad, zip(got_g, ref_g))]
        if key in REGISTRY_LARGE:
            truth, truth_g = run_case(case, fn, cpu, torch.float64)
            for (what, g, r), t in zip(pairs, truth + list(truth_g)):
                e_card = float((g.double() - t).abs().max())
                e_cpu = float((r.double() - t).abs().max())
                worst["%s %s (card, CPU) from float64" % (key, what)] = (e_card, e_cpu)
                if e_card > REGISTRY_LARGE_RATIO * e_cpu + 1e-30:
                    misses.append("%s %s: %.3g from float64 against the CPU's %.3g"
                                  % (key, what, e_card, e_cpu))
            continue
        for what, g, r in pairs:
            if tuple(g.shape) != tuple(r.shape):
                misses.append("%s %s: shape %s against %s" % (key, what, tuple(g.shape),
                                                            tuple(r.shape)))
            elif case.exact:
                if not torch.equal(g.to(r.dtype), r):
                    misses.append("%s %s: not equal to the CPU's" % (key, what))
            else:
                atol = case.atol * (max(1.0, float(r.abs().max())) if what[0] == "d" else 1.0)
                err = float((g.float() - r.float()).abs().max())
                worst["%s %s" % (key, what)] = err
                if not torch.allclose(g.float(), r.float(), rtol=case.rtol, atol=atol):
                    misses.append("%s %s: largest difference %.3g (rtol %g, atol %.3g)"
                                  % (key, what, err, case.rtol, atol))
    if misses:
        fail("registry ops on the card against the CPU: %d misses: %s"
             % (len(misses), "; ".join(misses)))
    launches = counts(kernels)
    if any(launches.values()):
        fail("the registry ops launched %s" % launches)
    say("registry ops on %s: %d cases of %d operators, forward and gradients card vs CPU "
        "within the CPU tests' tolerances (the large CTC and deconvolution against float64); "
        "largest "
        "differences %s; ms a case (forward and backward, first call) %s" % (
            card, len(cases), len({c.op for c in cases.values()}),
            json.dumps({k: v for k, v in worst.items() if v}),
            json.dumps({k: round(v, 2) for k, v in ms.items()})))
    return dict(cases=len(cases), ops=len({c.op for c in cases.values()}))


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
    map_rfcn_launches, rfcn_decode_nms, map_rfcn = phase(
        "map_rfcn_eval", phase_map_eval, kernels, "rfcn", net, dev, name)
    int8_launches, int8_captured, int8_expect = phase("int8", phase_int8, kernels, dev, name)
    resnet_launches = phase("resnet", phase_resnet_train, kernels, dev, name)
    phase("resnet_card_vs_cpu", phase_resnet_card_vs_cpu, dev)
    imperative_rfcn_launches, imperative_rfcn, imperative_rfcn_calls = phase(
        "imperative_rfcn", phase_imperative_rfcn, kernels, dev, name)
    imperative_resnet_launches, imperative_resnet = phase(
        "imperative_resnet", phase_imperative_resnet, kernels, dev, name)
    say("imperative: %s" % json.dumps({"rfcn": imperative_rfcn, "resnet": imperative_resnet}))
    frcnn_net, frcnn_serve_launches, frcnn_serve = phase(
        "frcnn_serve", phase_frcnn_serve, kernels, dev, name)
    frcnn_train_launches, frcnn_bf16_launches, frcnn_nms, frcnn_train = phase(
        "frcnn_train", phase_frcnn_train, kernels, frcnn_net, dev, name)
    map_frcnn_launches, frcnn_decode_nms, map_frcnn = phase(
        "map_frcnn_eval", phase_map_eval, kernels, "frcnn", frcnn_net, dev, name)
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
    lstm_launches, lstm_res = phase("lstm_bucketing", phase_lstm_bucketing, kernels, dev, name)
    say("lstm_bucketing: %s" % json.dumps(lstm_res))
    alexnet_launches, alexnet_res = phase("imagenet_alexnet", phase_imagenet_alexnet, kernels,
                                          dev, name)
    lenet_launches, lenet_res = phase("mnist_lenet_stn", phase_mnist_lenet_stn, kernels, dev,
                                      name)
    python_loss_launches, python_loss_res = phase("python_loss", phase_python_loss, kernels,
                                                  dev, name)
    optimizer_res = phase("optimizers", phase_optimizers, kernels, dev, name)
    registry_res = phase("registry_ops", phase_registry_ops, kernels, dev, name)
    say("image classification: %s" % json.dumps({
        "alexnet": alexnet_res, "lenet_stn": lenet_res, "python_loss": python_loss_res,
        "optimizers": optimizer_res, "registry_ops": registry_res}))
    torch.cuda.empty_cache()
    ssd_serve_launches, ssd_nms, ssd_serve = phase("ssd_serve", phase_ssd_serve, kernels, dev,
                                                   name)
    ssd_train_launches, ssd_train = phase("ssd_train", phase_ssd_train, kernels, dev, name)
    say("ssd: %s" % json.dumps({"serve": ssd_serve, "train": ssd_train}))
    map_ssd300_launches, map_ssd300 = phase("map_ssd300", phase_map_ssd300, kernels, name)
    say("map: %s" % json.dumps({"ssd300": map_ssd300, "frcnn_eval": map_frcnn,
                                "rfcn_eval": map_rfcn}))
    predictor_res = phase("predictor", phase_predictor, kernels, dev, name)
    with tempfile.TemporaryDirectory() as workdir:
        predictor_resnet_launches, predictor_resnet_res, deploy = phase(
            "predictor_resnet", phase_predictor_resnet, kernels, dev, name, workdir)
        say("predictor: %s" % json.dumps({"twin": predictor_res,
                                          "resnet": predictor_resnet_res}))
        serve_engine_launches, serve_engine_res = phase(
            "serve_engine", phase_serve_engine, kernels, name, deploy)
        del deploy
    say("serve_engine: %s" % json.dumps(serve_engine_res))
    launches = {"serve": serve_launches, "train": train_launches,
                "serve_bf16": serve_bf16_launches, "train_bf16": train_bf16_launches,
                "int8": int8_launches, "resnet_train": resnet_launches,
                "imperative_rfcn": imperative_rfcn_launches,
                "imperative_resnet": imperative_resnet_launches,
                "frcnn_serve": frcnn_serve_launches, "frcnn_train": frcnn_train_launches,
                "frcnn_train_bf16": frcnn_bf16_launches,
                "frcnn_serve_bf16": frcnn_serve_bf16_launches,
                "module_mlp": module_mlp_launches, "module_cifar": module_cifar_launches,
                "lstm_bucketing": lstm_launches, "imagenet_alexnet": alexnet_launches,
                "mnist_lenet_stn": lenet_launches, "python_loss": python_loss_launches,
                **ssd_serve_launches, **ssd_train_launches,
                "predictor_resnet": predictor_resnet_launches,
                "serve_engine": serve_engine_launches,
                "map_ssd300": map_ssd300_launches, "map_frcnn_eval": map_frcnn_launches,
                "map_rfcn_eval": map_rfcn_launches}

    def kernel_rows():
        rows = phase_kernels(kernels, net, launches, bwd_captured, train_nms, dev,
                             extra=imperative_rfcn_calls)
        nms_row = next(r for r in rows if r["name"] == "nms_alive")
        nms_row.update(nms_at_train_size(kernels, frcnn_nms))
        nms_row.update(nms_at_ssd_sizes(kernels, ssd_nms))
        nms_row.update(nms_at_decode(kernels, rfcn_decode_nms + frcnn_decode_nms))
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
    del imperative_rfcn_calls
    del ssd_nms, rfcn_decode_nms, frcnn_decode_nms
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
    phase("small_predictor", phase_small_predictor, dev)
    say("phases (s): %s" % json.dumps(seconds))
    say("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
