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
   and each backward kernel during that train step, are captured; each kernel
   is held against its plain PyTorch version on them and timed beside it
   (and beside one library call where there is one);
6. small input: the tiny configuration on the card against the same model on
   the CPU (the plain versions), stage by stage, then one train step on each
   with the same weights and the same noise.

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
            "dconv_col_bwd": 0, "psroi_abuild_bwd": 0}


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
    for i in range(2):
        out = []
        run = lambda: out.append(checked_step(step1, inputs1, 1,
                                              "warm-up step %d" % (i + 1)))
        if i == 1:
            captured = capture_calls(kernels, bwd_names, run)
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
    return launches, captured


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
    if name == "nms_alive":
        if not torch.equal(got, ref):
            fail("nms_alive: %d mask entries differ from the plain version"
                 % int((got != ref).sum()))
        return 0.0
    err = 0.0
    for a, b in zip(*((got, ref) if isinstance(got, tuple) else ((got,), (ref,)))):
        scale = float(b.abs().max())
        if name == "dconv_col_bwd":
            # sums over C in another order, and d_ft summed by atomics in an
            # order that changes from run to run
            rtol, atol = 1e-4, 1e-5 * scale
        elif name == "psroi_abuild_bwd":
            # 38- and 64-term fused multiply-add chains against torch's sums
            rtol, atol = 1e-5, 1e-5 * scale
        else:
            rtol, atol = 1e-5, 1e-5
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m: "%s: %s" % (name, m))
        err = max(err, float((a - b).abs().max()))
    return err


def phase_kernels(kernels, net, launches, train_launches, bwd_captured, dev):
    """Each kernel against its plain version on the calls of a real run: an
    inference forward for the forward kernels, and for the backward kernels
    the calls ``phase_train`` recorded in one of its batch-1 steps."""
    H, W = net.image_shape
    gen = torch.Generator().manual_seed(SEED + 3)
    data, im_info = make_request(gen, [[H, W, 1.0]], net.image_shape, dev)
    fwd_names = [n for n in kernels.KERNELS if not n.endswith("_bwd")]
    bwd_names = list(bwd_captured)
    captured = capture_calls(kernels, fwd_names, lambda: net(data, im_info))
    captured.update(bwd_captured)
    expect = dict(per_forward(net))
    expect.update({n: per_train_step(net)[n] for n in bwd_names})

    rows = []
    for name, k in kernels.KERNELS.items():
        with torch.no_grad():  # the captured backward inputs carry a graph
            rows.append(kernel_row(name, k, captured[name], expect[name],
                                   launches, train_launches, bwd_names))
    return rows


def kernel_row(name, k, calls, expected, launches, train_launches, bwd_names):
    """Hold one kernel against its plain version on its captured calls,
    time both (and the library call), and return its JSON row."""
    if len(calls) != expected:
        fail("captured %d %s calls, expected %d" % (len(calls), name, expected))
    err = 0.0
    for args, kw in calls:
        got = k.wrapper(*args, **kw)
        ref = k.plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, compare(name, got, ref))
    args, kw = calls[0]
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
    bound_ms, bound_by = bound(*work(name, args, out))
    shapes = [tuple(a.shape) for a in args if hasattr(a, "shape")]
    # "launches" is the count on the kernel's own main path: the serve
    # run for the forward kernels, the train run for the backward ones;
    # "ms" and "kernel_ms" carry the one kernel time under both names
    # that readers of this line look up
    row = dict(
        name=name, route="cuda", source=k.source, replaces=k.replaces,
        launches=(train_launches if name in bwd_names else launches)[name],
        train_launches=train_launches[name], max_abs_err=err, ms=kernel_ms,
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by=bound_by)
    say("kernel %s %s: %.4f ms (plain %.4f ms%s), bound %.4f ms by %s, "
        "max_abs_err %g over %d calls" % (
            name, shapes, kernel_ms, plain_ms,
            "" if library_ms is None else ", library %.4f ms" % library_ms,
            bound_ms, bound_by, err, len(calls)))
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
    net, gen, launches = phase_serve(kernels, dev)
    train_launches, bwd_captured = phase_train(kernels, net, dev, name)
    rows = phase_kernels(kernels, net, launches, train_launches, bwd_captured, dev)
    del net
    torch.cuda.empty_cache()
    phase_small_input(dev)
    phase_small_train(dev)
    say("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
