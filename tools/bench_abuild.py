#!/usr/bin/env python3
"""Time the PS-ROI A-build kernels at the R-FCN path's shapes.

    python3 tools/bench_abuild.py [--against DIR]

Forward on the serve call (N = 14,700, S = 16, 38 x 64), backward on the
train call (N = 6,272), each beside its bytes bound and its ``torch.bmm``
yardstick, with ``chip_smoke.py``'s timer.  With ``--against DIR``, the C
entries ``mx_psroi_abuild`` and ``mx_psroi_abuild_bwd`` are also built from
``DIR/psroi_abuild.cu`` and ``DIR/psroi_abuild_bwd.cu`` (another revision's
``mxnet_tpu_torch/ops/csrc``): the two builds' outputs are compared bit for
bit on the same inputs, at the path's shapes and at every shape of the card
tests, and timed in turns (other, this, this, other) in this one process.
Prints one JSON object per line.  Needs one NVIDIA GPU.
"""
import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (timer, bound, work)
from mxnet_tpu_torch.ops import _build, kernels  # noqa: E402

PATH_CALLS = (("psroi_abuild", (14700, 16, 38, 64)),
              ("psroi_abuild_bwd", (6272, 16, 38, 64)))
REPS = 50  # timed calls in a row, after chip_smoke.time_ms's warm-up
TEST_SHAPES = ((300, 16, 38, 64), (7, 3, 5, 200), (20, 16, 800, 64),
               (33, 16, 38, 61), (20, 1, 38, 64), (20, 16, 1, 64),
               (1, 16, 38, 64), (300, 16, 76, 64), (6271, 16, 38, 64),
               (20, 16, 300, 64))


def build_against(src_dir):
    """The two C entries built from ``src_dir``, loaded with ctypes."""
    srcs = [Path(src_dir, f) for f in ("psroi_abuild.cu", "psroi_abuild_bwd.cu")]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in srcs)).hexdigest()[:16]
    out = _build.BUILD_ROOT / ("against-" + digest)
    lib = out / "libabuild.so"
    if not lib.is_file():
        out.mkdir(parents=True, exist_ok=True)
        objs = [str(out / (p.stem + ".o")) for p in srcs]
        for p, o in zip(srcs, objs):
            subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src_dir),
                            "-c", str(p), "-o", o], check=True)
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", str(lib), *objs], check=True)
    dll = ctypes.CDLL(str(lib))
    for name in ("mx_psroi_abuild", "mx_psroi_abuild_bwd"):
        getattr(dll, name).argtypes = _build._SIGNATURES[name]
        getattr(dll, name).restype = ctypes.c_int
    return dll


def inputs(name, shape, seed):
    n, s, h, w = shape
    rng = np.random.RandomState(seed)
    t = [rng.rand(n, s, h), rng.rand(n, s, w)]
    if name == "psroi_abuild_bwd":
        t.append(rng.randn(n, h, w))
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in t]


def run_lib(dll, name, args):
    """One call of ``name`` through the other build, outputs allocated here."""
    stream = torch.cuda.current_stream().cuda_stream
    n, s, h = args[0].shape
    w = args[1].shape[2]
    if name == "psroi_abuild":
        a = torch.empty((n, h, w), device="cuda")
        rc = dll.mx_psroi_abuild(args[0].data_ptr(), args[1].data_ptr(),
                                 a.data_ptr(), n, s, h, w, stream)
        outs = (a,)
    else:
        dyv, dxv = torch.empty_like(args[0]), torch.empty_like(args[1])
        rc = dll.mx_psroi_abuild_bwd(*(t.data_ptr() for t in args), dyv.data_ptr(),
                                     dxv.data_ptr(), n, s, h, w, stream)
        outs = (dyv, dxv)
    if rc != 0:
        raise RuntimeError("%s (other build): CUDA error %d" % (name, rc))
    return outs


def library_call(name, args):
    if name == "psroi_abuild":
        yv, xv = args
        return lambda: torch.bmm(yv.transpose(1, 2), xv)
    yv, xv, g = args
    return lambda: (torch.bmm(xv, g.transpose(1, 2)), torch.bmm(yv, g))


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="directory holding the other revision's "
                    "psroi_abuild.cu and psroi_abuild_bwd.cu")
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_abuild: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    _build.library()
    print(json.dumps({"ptxas": [l for l in _build.build_info()["ptxas"].splitlines()
                                if "abuild" in l or "Used" in l]}), flush=True)
    dll = build_against(opt.against) if opt.against else None
    if dll is not None:
        for name in ("psroi_abuild", "psroi_abuild_bwd"):
            for i, shape in enumerate(TEST_SHAPES + tuple(s for _, s in PATH_CALLS)):
                if name == "psroi_abuild_bwd" and shape[2] == 800:
                    continue  # beyond the backward's one-block generic path
                args = inputs(name, shape, i)
                got = as_tuple(kernels.KERNELS[name].wrapper(*args))
                other = run_lib(dll, name, args)
                torch.cuda.synchronize()
                print(json.dumps({
                    "name": name, "shape": shape,
                    "bitwise_equal": all(torch.equal(a, b) for a, b in zip(got, other)),
                    "max_abs_diff": max(float((a - b).abs().max()) for a, b in zip(got, other)),
                    "rerun_equal": all(torch.equal(a, b) for a, b in zip(
                        got, as_tuple(kernels.KERNELS[name].wrapper(*args))))}), flush=True)
    for name, shape in PATH_CALLS:
        args = inputs(name, shape, 0)
        k = kernels.KERNELS[name]
        out = k.wrapper(*args)
        bound_ms, by = chip_smoke.bound(*chip_smoke.work(name, args, out))
        row = dict(name=name, shape=shape, bound_ms=bound_ms, bound_by=by)
        this = lambda: k.wrapper(*args)
        if dll is None:
            row["ms"] = chip_smoke.time_ms(this, REPS)
        else:
            that = lambda: run_lib(dll, name, args)
            t = [chip_smoke.time_ms(f, REPS) for f in (that, this, this, that)]
            row.update(ms=(t[1] + t[2]) / 2, ms_turns=t[1:3],
                       against_ms=(t[0] + t[3]) / 2, against_turns=[t[0], t[3]])
        row["library_ms"] = chip_smoke.time_ms(library_call(name, args), REPS)
        # a device copy that reads half and writes half of the call's bytes:
        # what the memory system gives a plain stream at this size
        nbytes = chip_smoke.work(name, args, out)[0]
        src = torch.empty(int(nbytes) // 8, device="cuda")
        dst = torch.empty_like(src)
        row["copy_ms"] = chip_smoke.time_ms(lambda: dst.copy_(src), REPS)
        row["share_of_bound"] = bound_ms / row["ms"]
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
