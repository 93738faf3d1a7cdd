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
   (and beside one library call where there is one);
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
7. small input: the tiny configuration on the card against the same model on
   the CPU (the plain versions), stage by stage, then one train step on each
   with the same weights and the same noise; and the CIFAR ResNet-8 int8
   symbol with the same weights and calibration table on both devices.

The second-to-last line is the kernels JSON object, the last line
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""
import json
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


def check_answer(net, out, im_info):
    rois, prob, bbox = out
    B = im_info.shape[0]
    R = B * net.rpn_post_nms
    for t, shape, name in ((rois, (R, 5), "rois"), (prob, (R, net.classes + 1), "cls_prob"),
                           (bbox, (R, 8), "bbox_pred")):
        if tuple(t.shape) != shape:
            fail("%s has shape %s, expected %s" % (name, tuple(t.shape), shape))
        if not bool(torch.isfinite(t).all()):
            fail("%s has non-finite values" % name)
    err = float((prob.sum(-1) - 1).abs().max())
    if err > 1e-5:
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


def per_forward(net):
    """Launches of each kernel in one inference forward: one dconv per
    deformable conv (the three res5 units), one NMS over the batch, one
    A-build per pooling, and no backward kernel."""
    from mxnet_tpu_torch.gluon.model_zoo import DeformableConv2D

    n_dconv = sum(isinstance(m, DeformableConv2D) for m in net.modules())
    return {"nms_alive": 1, "dconv_col": n_dconv, "psroi_abuild": 3,
            "dconv_col_bwd": 0, "psroi_abuild_bwd": 0, "quantize_int8": 0,
            "dequantize_int8": 0}


def per_train_step(net):
    """Launches of each kernel in one train step: the forward's, one dconv
    backward per deformable conv, and one A-build backward for each of the
    two poolings whose offsets carry a gradient (the offset pooling itself
    samples at fixed points: its yv/xv carry none)."""
    fwd = per_forward(net)
    return dict(fwd, dconv_col_bwd=fwd["dconv_col"], psroi_abuild_bwd=2)


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

    def checked_step(step, inputs, batch, what):
        before = counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, parts = step(*inputs, *train_noise(net, batch, nz_gen, dev), LR)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        parts = parts.tolist()
        if not all(math.isfinite(v) for v in parts):
            fail("%s: loss parts not finite: %s" % (what, parts))
        got = {n: c - before[n] for n, c in counts(kernels).items()}
        if got != expect:
            fail("%s: kernel launches %s, expected %s" % (what, got, expect))
        return ms, float(loss), parts

    step1 = train_fused.make_rfcn_train_step(net, 1, learning_rate=LR, momentum=0.9)
    inputs1 = train_inputs(net, rng, 1, dev)
    # the second warm-up step also records the backward kernels' inputs,
    # which the kernels phase holds against the plain versions
    bwd_names = [n for n in kernels.KERNELS if n.endswith("_bwd")]
    for i in range(2):  # (and the step's NMS call, compared beside the serve one)
        out = []
        run = lambda: out.append(checked_step(step1, inputs1, 1,
                                              "warm-up step %d" % (i + 1)))
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
        ms, loss, parts = checked_step(step1, inputs1, 1, "step %d" % (i + 1))
        times.append(ms)
        say("train step %d: batch 1, %.2f ms, loss %.4f (rpn_cls %.4f rpn_bbox "
            "%.4f rcnn_cls %.4f rcnn_bbox %.4f)" % (i + 1, ms, loss, *parts))
    step2 = train_fused.make_rfcn_train_step(net, 2, learning_rate=LR, momentum=0.9)
    ms2, loss, parts = checked_step(step2, train_inputs(net, rng, 2, dev), 2,
                                    "batch-2 step")
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


def bound(byte_count, flops):
    """Least time (ms) for the work: bytes over the memory rate or float32
    operations over the float32 rate, whichever is larger."""
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(name, args, out):
    """(bytes, float32 operations) of one call, from its inputs and output:
    each input read once, each output written once."""
    nbytes = lambda *ts: 4 * sum(t.numel() for t in ts)
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
        yv, xv = args
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
    # IoUs the greedy scan needs on this data: each survivor against every
    # earlier survivor, each suppressed box against at least one; ~12 flops each
    alive = out.to(torch.int64)
    earlier = torch.cumsum(alive, 1) - alive
    pairs = int((earlier * alive).sum()) + int((valid & ~out).sum())
    return boxes.numel() * 4 + 2 * valid.numel(), 12 * pairs


def capture_calls(kernels, names, run):
    """Run ``run()`` with the wrappers of ``names`` recording their args."""
    captured = {name: [] for name in names}

    def capture(name, fn):
        def wrapper(*args, **kw):
            captured[name].append((args, kw))
            return fn(*args, **kw)
        return wrapper

    for name in names:
        setattr(kernels, name, capture(name, kernels.KERNELS[name].wrapper))
    try:
        run()
    finally:
        for name in names:
            setattr(kernels, name, kernels.KERNELS[name].wrapper)
    torch.cuda.synchronize()
    return captured


def compare(name, got, ref):
    """Max |kernel − plain| over the outputs; fail beyond the tolerance."""
    if name in ("nms_alive",) + INT8_PAIR:
        # bit for bit (NaN cannot come out of either: quantize makes it 0,
        # and the dequantize ranges are finite)
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            fail("%s: %d values differ from the plain version"
                 % (name, int((got != ref).sum())))
        return 0.0
    err = 0.0
    for a, b in zip(*((got, ref) if isinstance(got, tuple) else ((got,), (ref,)))):
        scale = float(b.abs().max())
        if name == "dconv_col_bwd":
            # sums over C in another order, and d_ft summed by atomics in an
            # order that changes from run to run
            rtol, atol = 1e-4, 1e-5 * scale
        elif name == "psroi_abuild_bwd":
            # fixed-order fp32 sums over 38 rows and 64 columns (fused
            # multiply-add chains and a shuffle tree) against torch's sums
            rtol, atol = 1e-5, 1e-5 * scale
        else:
            rtol, atol = 1e-5, 1e-5
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m: "%s: %s" % (name, m))
        err = max(err, float((a - b).abs().max()))
    return err


def phase_kernels(kernels, net, launches, bwd_captured, train_nms, dev):
    """Each R-FCN kernel against its plain version on the calls of a real
    run: an inference forward for the forward kernels, and for the backward
    kernels the calls ``phase_train`` recorded in one of its batch-1 steps
    (NMS is compared on that step's call too, and timed on the serve call).
    (The int8 pair's rows come from ``phase_int8``'s calls.)"""
    H, W = net.image_shape
    gen = torch.Generator().manual_seed(SEED + 3)
    data, im_info = make_request(gen, [[H, W, 1.0]], net.image_shape, dev)
    expect = per_forward(net)
    fwd_names = [n for n, c in expect.items() if c]
    captured = capture_calls(kernels, fwd_names, lambda: net(data, im_info))
    captured.update(bwd_captured)
    expect.update({n: per_train_step(net)[n] for n in bwd_captured})
    rows = []
    for name in fwd_names + list(bwd_captured):
        main = "train" if name in bwd_captured else "serve"
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
        yv, xv = args
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
        ly, lf = args[4], args[6]
        say("  dconv samples: %.3f off the integer grid, %.3f live" % (
            float((ly != 0).float().mean()), float(lf.mean())))
    return row


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


def phase_small_train(dev):
    """Tiny configuration, one train step at batch 2 on the card (kernels)
    against the same step on the CPU (plain versions): the same weights, the
    same synthetic batch and the same noise.  The RPN score conv gets larger
    weights, so that the proposal scores spread out and the sort has no
    near-tie that the two devices' rounding could flip at this seed."""
    from mxnet_tpu_torch import train_fused
    from mxnet_tpu_torch.gluon.model_zoo import DeformableConv2D, DeformableRFCN

    # at this seed the CPU's sorted proposal scores lie at least 1.6e-5
    # apart, far above the devices' rounding differences
    gen = torch.Generator().manual_seed(SEED + 7)
    cpu = DeformableRFCN(device="cpu", generator=gen, **TINY)
    randomize_deformable(cpu, gen)
    with torch.no_grad():
        w = cpu.rpn_cls.weight
        w.copy_(torch.randn(w.shape, generator=gen) * 4.0 / math.sqrt(w[0].numel()))
    gpu = DeformableRFCN(device="cuda", **TINY)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(SEED + 7)
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
        results.append((parts.cpu(), {k: p.grad.cpu() for k, p in probes.items()}))
    (ref_parts, ref_grads), (got_parts, got_grads) = results
    # four fp32 means over the same selection, summed in another order
    torch.testing.assert_close(got_parts, ref_parts, rtol=1e-4, atol=1e-5,
                               msg=lambda m: "train loss parts: %s" % m)
    for k, ref in ref_grads.items():
        if not float(ref.abs().max()) > 0:
            fail("small train: %s got no gradient on the CPU" % k)
        # cuDNN and CPU fp32 backward sums in another order through every
        # layer, the atomics of d_ft among them
        torch.testing.assert_close(got_grads[k], ref, rtol=1e-3,
                                   atol=1e-4 * float(ref.abs().max()),
                                   msg=lambda m, k=k: "%s gradient: %s" % (k, m))
    say("small input, train: one step on the card agrees with the CPU (loss "
        "parts %s, offset-conv and rfcn_trans weight gradients)"
        % ", ".join("%.5f" % v for v in got_parts.tolist()))


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
    ("dequantize_int8", ("dequantize_int8_kernel",)),
    ("quantize_int8", ("quantize_int8_kernel",)),
    ("conv", ("fprop", "conv", "implicit")),
    ("gemm", ("gemm", "cublas", "cutlass")),
)


def device_profile(exe, data, reps=3):
    """Where a forward's device time goes: device busy ms and kernels per
    forward, by group (the int8 pair, cuDNN convolutions, matrix products,
    the rest: elementwise work, copies, reductions), from
    ``torch.profiler``'s CUDA activity over ``reps`` forwards; the idle
    share is 1 - busy / the traced wall.  "not measured" when the profiler
    records no device time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            exe.forward(data=data)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    groups, launches = {}, 0
    for evt in prof.key_averages():
        us = float(getattr(evt, "self_device_time_total", 0) or 0)
        if us <= 0 or evt.device_type == torch.autograd.DeviceType.CPU:
            continue
        name = evt.key.lower()
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + us / reps / 1e3
        launches += evt.count / reps
    busy = sum(groups.values())
    if not busy:
        return {"device_busy_ms": "not measured"}
    return {"traced_wall_ms": wall, "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "kernels_per_forward": launches, "device_ms_by_group": groups}


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
                                int8_profile=device_profile(qexe, data),
                                fp32_profile=device_profile(fexe, data))
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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    try:
        from mxnet_tpu_torch.ops import kernels
    except ImportError as e:
        fail("the port (mxnet_tpu_torch) is not importable next to this "
             "script: %s" % e)
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = phase_device()
    phase_build()
    net, gen, serve_launches = phase_serve(kernels, dev)
    train_launches, bwd_captured, train_nms = phase_train(kernels, net, dev, name)
    int8_launches, int8_captured, int8_expect = phase_int8(kernels, dev, name)
    launches = {"serve": serve_launches, "train": train_launches,
                "int8": int8_launches}
    rows = phase_kernels(kernels, net, launches, bwd_captured, train_nms, dev)
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
    del net, int8_captured, bwd_captured, train_nms
    torch.cuda.empty_cache()
    phase_small_input(dev)
    phase_small_train(dev)
    phase_small_int8(dev)
    say("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
