#!/usr/bin/env python3
"""Where the time of one Deformable R-FCN inference forward, or one train
step, goes on the GPU.

    python3 tools/profile_torch_rfcn.py            # inference forwards
    python3 tools/profile_torch_rfcn.py --train    # train steps
    python3 tools/profile_torch_rfcn.py --dtype bfloat16 [--train]

With ``--dtype bfloat16`` the forwards run on the model after
``cast("bfloat16")`` with bf16 images, and the train steps take
``compute_dtype="bfloat16"`` (fp32 masters, bf16 trunk, fp32 box math).

With ``--train`` the same model takes momentum-SGD train steps
(``mxnet_tpu_torch/train_fused.py``) on one synthetic COCO batch with fresh
noise from a device generator each step, in place of forwards; everything
below holds for a step as for a forward.

Builds the port's full-width model as ``chip_smoke.py`` does (R-101, 80
classes, 608x1024, seeded random weights, non-zero offset weights, TF32
off), warms it up, then at batch 1 and 2 times five forwards with the host
clock around ``torch.cuda.synchronize()`` and traces five more under
``torch.profiler`` (device activity only).  Device kernel time is
summed by kernel and grouped (convolutions, matrix products, the port's
three CUDA kernels, the rest); the device idle share is 1 − busy / wall,
both per forward and both taken over the five traced forwards.
One more forward runs under ``torch.cuda.set_sync_debug_mode("warn")`` to
count the host synchronisations it makes.  Prints one JSON line per batch
size, with the card's name and power limit.  Needs a CUDA device; imports no JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCHES = (1, 2)
ITERS = 5

GROUPS = (  # first match wins, on the lower-cased kernel name
    ("nms_alive", ("nms_mask_kernel", "nms_scan_kernel")),
    ("dconv_col_bwd", ("dconv_col_bwd_",)),
    ("dconv_col", ("dconv_col_tiled_", "dconv_col_kernel")),
    ("psroi_abuild_bwd", ("psroi_abuild_bwd_",)),
    ("psroi_abuild", ("psroi_abuild_kernel",)),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "winograd", "implicit")),
    ("gemm", ("gemm", "cublas", "cutlass", "matmul", "bmm")),
    ("sort", ("sort", "radix", "scan")),
    ("elementwise", ("elementwise", "reduce", "index", "cat", "copy", "memcpy",
                     "memset", "fill", "gather", "scatter")),
)


def group_of(name):
    n = name.lower()
    for group, keys in GROUPS:
        if any(k in n for k in keys):
            return group
    return "other"


def device_time_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


def forward_runner(net, B, gen):
    H, W = net.image_shape
    dev = net.device
    data = torch.randn((B, 3, H, W), generator=gen).to(dev, net.rfcn_cls.weight.dtype)
    info = torch.tensor([[H, W, 1.0]] * B).to(dev)
    return lambda: net(data, info)


def step_runner(net, B, seed, dtype=None):
    import numpy as np

    from mxnet_tpu_torch import train_fused

    dev = net.device
    batch = train_fused.synthetic_coco(np.random.RandomState(seed), B,
                                       net.image_shape, net.classes, net.max_gts)
    inputs = [torch.from_numpy(a).to(dev) for a in batch]
    step = train_fused.make_rfcn_train_step(net, B, learning_rate=5e-4, momentum=0.9,
                                            compute_dtype=dtype)
    nz_gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = train_fused.noise_shapes(net, B)
    return lambda: step(*inputs, *(torch.rand(s, generator=nz_gen, device=dev)
                                   for s in shapes))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", action="store_true",
                   help="profile train steps instead of inference forwards")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="bfloat16: the model cast to bf16 (forwards) or the bf16 "
                   "train step")
    args = p.parse_args()
    bf16 = args.dtype == "bfloat16"
    if not torch.cuda.is_available():
        sys.exit("profile_torch_rfcn: needs a CUDA device")
    from chip_smoke import FULL, SEED, randomize_deformable
    from mxnet_tpu_torch.gluon.model_zoo import rfcn_resnet101

    gen = torch.Generator().manual_seed(SEED)
    net = rfcn_resnet101(device="cuda", generator=gen, **FULL)
    randomize_deformable(net, gen)
    if bf16 and not args.train:
        net.cast("bfloat16")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    what = "train_step" if args.train else "forward"
    for B in BATCHES:
        run = (step_runner(net, B, SEED, "bfloat16" if bf16 else None) if args.train
               else forward_runner(net, B, gen))
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        # device kernels only (no host-op tracing, which would slow the host);
        # the idle share's busy time and wall both come from this window
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                run()
            torch.cuda.synchronize()
            traced_wall = (time.perf_counter() - t0) * 1e3 / ITERS
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        groups, kernels = {}, []
        for evt in prof.key_averages():
            us = device_time_us(evt)
            if us <= 0 or getattr(evt, "device_type", None) == torch.autograd.DeviceType.CPU:
                continue
            g = group_of(evt.key)
            groups[g] = groups.get(g, 0.0) + us / ITERS / 1e3
            kernels.append((us / ITERS / 1e3, evt.count // ITERS, evt.key[:80]))
        busy = sum(groups.values())
        wall = sorted(walls)[len(walls) // 2]
        kernels.sort(reverse=True)
        print(json.dumps({
            "what": what, "dtype": args.dtype, "batch": B, "card": card,
            "host_syncs_per_%s" % what: syncs,
            "wall_ms_median": wall, "wall_ms": walls,
            "traced_wall_ms": traced_wall,
            "device_busy_ms": busy if busy else "not measured",
            "idle_share": (1 - busy / traced_wall) if busy else "not measured",
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"ms": ms, "launches": n, "name": k} for ms, n, k in kernels[:20]],
        }), flush=True)


if __name__ == "__main__":
    main()
