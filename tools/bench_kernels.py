#!/usr/bin/env python3
"""Time the port's CUDA kernels at the R-FCN path's calls, and compare builds.

    python3 tools/bench_kernels.py [--kernels a,b,...] [--against DIR ...]

Kernels (``--kernels``, default all four):

* ``psroi_abuild`` on the serve call (N = 14,700, S = 16, 38 x 64) and
  ``psroi_abuild_bwd`` on the train call (N = 6,272), on seeded inputs of the
  path's shapes, each beside two ``torch.bmm`` yardsticks;
* ``nms_alive`` and ``dconv_col_bwd`` on the path's own calls: the tool
  builds ``chip_smoke.py``'s full-width R-101 model (seeded weights), runs
  one inference forward and one batch-1 train step and records the calls
  (NMS on the serve and on the train call, the first of the three dconv
  backward calls).  NMS prints its words and survivors per call; the dconv
  backward is timed on ``g`` and the rows' layout as the autograd hands
  them, beside the copy that would make that ``g`` contiguous, and prints
  its tiles' windows (the tiled design's share of tiles whose window fits
  in shared memory, and window quantiles in pixels).

Each row gives the kernel's device time (``chip_smoke.time_ms``), its bound,
and a device copy of the same byte count.  With ``--against DIR`` (another
revision's ``mxnet_tpu_torch/ops/csrc``, or a copy with one change, for a
timing split; repeatable), every ``.cu`` file of ``DIR`` is built into a
library of its own, and for each such build: the outputs of both builds are
compared on the same inputs (bit for bit, and within the smoke's
tolerances; NMS must be equal; a timing copy that computes something else
shows up as unequal and is only reported), and
the two are timed in turns (other, this, this, other) in this one process.
The C entries' signatures are those of ``DIR/../_build.py`` where that
file exists (another revision's ``ops`` package), else this revision's.
An older ``mx_dconv_col_bwd`` takes a prefix of this revision's integer
arguments (BG, N, H, W, C; then g's row and channel strides; then the rows'
layout K2, Ho, Wo); one without g's strides gets a contiguous copy of g,
made once and not timed.  Prints one JSON object per line.  Needs one
NVIDIA GPU; imports no JAX.
"""
import argparse
import ctypes
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (timer, bound, work, the model's settings)
from mxnet_tpu_torch.ops import _build, kernels  # noqa: E402

ALL = ("psroi_abuild", "psroi_abuild_bwd", "nms_alive", "dconv_col_bwd")
ABUILD_CALLS = {"psroi_abuild": (14700, 16, 38, 64),
                "psroi_abuild_bwd": (6272, 16, 38, 64)}
REPS = 50  # timed calls in a row, after chip_smoke.time_ms's warm-up
# the card tests' A-build shapes, compared across builds
ABUILD_TEST_SHAPES = ((300, 16, 38, 64), (7, 3, 5, 200), (20, 16, 800, 64),
                      (33, 16, 38, 61), (20, 1, 38, 64), (20, 16, 1, 64),
                      (1, 16, 38, 64), (300, 16, 76, 64), (6271, 16, 38, 64),
                      (20, 16, 300, 64))


def say(obj):
    print(json.dumps(obj), flush=True)


def signatures(build_py):
    """The C entries' argtypes declared by ``build_py`` (another revision's
    ``ops/_build.py``, loaded on its own: it imports only the standard
    library), or this revision's where that file does not exist."""
    if not build_py.is_file():
        return dict(_build._SIGNATURES)
    name = "other_build_" + hashlib.sha256(str(build_py).encode()).hexdigest()[:8]
    spec = importlib.util.spec_from_file_location(name, build_py)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(mod._SIGNATURES)


class Other:
    """Another build of the C entries, from every ``.cu`` file of ``src``."""

    def __init__(self, src):
        srcs = sorted(Path(src).glob("*.cu"))
        if not srcs:
            sys.exit("bench_kernels: no .cu files under %s" % src)
        blob = b"".join(p.name.encode() + p.read_bytes()
                        for p in srcs + sorted(Path(src).glob("*.cuh")))
        out = _build.BUILD_ROOT / ("against-" + hashlib.sha256(blob).hexdigest()[:16])
        lib = out / "libother.so"
        if not lib.is_file():
            out.mkdir(parents=True, exist_ok=True)
            objs = [out / (p.stem + ".o") for p in srcs]
            procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src),
                                       "-c", str(p), "-o", str(o)],
                                      stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
                     for p, o in zip(srcs, objs)]
            for p in procs:
                if p.wait() != 0:
                    sys.exit("bench_kernels: build of %s failed:\n%s"
                             % (src, p.stderr.read().decode()))
            subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                            "-shared", "-o", str(lib), *map(str, objs)], check=True)
        self.label = Path(src).name
        self.dll = ctypes.CDLL(str(lib))
        sigs = signatures(Path(src).parent / "_build.py")
        # the integer arguments this build's mx_dconv_col_bwd takes (13
        # pointers before them, the stream after)
        self.dconv_ints = len(sigs["mx_dconv_col_bwd"]) - 14
        for name, argtypes in sigs.items():
            fn = getattr(self.dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.masks = {}  # NMS mask scratch, one per shape, kept across calls
        self.contiguous = {}

    def call(self, name, args, kw):
        stream = torch.cuda.current_stream().cuda_stream
        d = self.dll
        if name == "psroi_abuild":
            yv, xv = args
            n, s, h = yv.shape
            a = torch.empty((n, h, xv.shape[2]), device="cuda")
            rc, outs = d.mx_psroi_abuild(yv.data_ptr(), xv.data_ptr(), a.data_ptr(),
                                         n, s, h, xv.shape[2], stream), a
        elif name == "psroi_abuild_bwd":
            yv, xv, g = args
            n, s, h = yv.shape
            dyv, dxv = torch.empty_like(yv), torch.empty_like(xv)
            rc = d.mx_psroi_abuild_bwd(yv.data_ptr(), xv.data_ptr(), g.data_ptr(),
                                       dyv.data_ptr(), dxv.data_ptr(), n, s, h,
                                       xv.shape[2], stream)
            outs = (dyv, dxv)
        elif name == "nms_alive":
            boxes, valid = args[:2]
            ids = args[2] if len(args) > 2 else kw.get("ids")
            B, N = valid.shape
            key = (B, N)
            if key not in self.masks:
                self.masks[key] = torch.empty((B, N, -(-N // 64)), dtype=torch.int64,
                                              device="cuda")
            area = kernels.box_area(boxes, kw.get("plus_one", 1.0)).contiguous()
            idf = None if ids is None else ids.to(torch.float32).contiguous()
            outs = torch.empty((B, N), dtype=torch.bool, device="cuda")
            rc = d.mx_nms_alive(boxes.data_ptr(), area.data_ptr(), valid.data_ptr(),
                                None if idf is None else idf.data_ptr(),
                                self.masks[key].data_ptr(), outs.data_ptr(), B, N,
                                float(kw["thresh"]), float(kw.get("plus_one", 1.0)), stream)
        else:  # dconv_col_bwd
            y0, y1, x0, x1, ly, lx, lf, ft, g, hw = args[:10]
            layout = args[10] if len(args) > 10 else kw.get("layout")
            BG, N = y0.shape
            C = ft.shape[2]
            rows = [torch.empty((BG, N), device="cuda") for _ in range(3)]
            dft = torch.empty_like(ft)
            ptrs = [t.data_ptr() for t in (y0, y1, x0, x1, ly, lx, lf, ft)]
            outp = [t.data_ptr() for t in rows + [dft]]
            if self.dconv_ints < 7 and not g.is_contiguous():
                # what the first signature's caller did, once per g (not timed)
                if g.data_ptr() not in self.contiguous:
                    self.contiguous[g.data_ptr()] = g.contiguous()
                g = self.contiguous[g.data_ptr()]
            ints = [BG, N, hw[0], hw[1], C, int(g.stride(1)), int(g.stride(2)),
                    *(layout or (0, 0, 0))]
            rc = d.mx_dconv_col_bwd(*ptrs, g.data_ptr(), *outp, *ints[:self.dconv_ints],
                                    stream)
            outs = (*rows, dft)
        if rc != 0:
            raise RuntimeError("%s (build %s): CUDA error %d" % (name, self.label, rc))
        return outs


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def agree(name, got, ref):
    """(equal bit for bit, max |difference|, within the smoke's tolerance)."""
    got, ref = as_tuple(got), as_tuple(ref)
    equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    diff = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in zip(got, ref))
    if name == "nms_alive":
        return equal, diff, equal
    close = True
    for a, b in zip(got, ref):
        scale = float(b.abs().max()) if b.numel() else 0.0
        rtol = 1e-4 if name == "dconv_col_bwd" else 1e-5
        atol = 1e-5 if name == "psroi_abuild" else 1e-5 * scale
        close &= scale == scale and bool(torch.allclose(a, b, rtol=rtol, atol=atol))
    return equal, diff, close


def abuild_inputs(name, shape, seed):
    n, s, h, w = shape
    rng = np.random.RandomState(seed)
    t = [rng.rand(n, s, h), rng.rand(n, s, w)]
    if name == "psroi_abuild_bwd":
        t.append(rng.randn(n, h, w))
    return [torch.from_numpy(a.astype(np.float32)).cuda() for a in t]


def path_calls(names, dev, config):
    """The calls of ``names`` (nms_alive, dconv_col_bwd) on the R-FCN path of
    ``config`` (``chip_smoke.FULL``: the full-width R-101):
    {name: [(label, args, kw), ...]}."""
    from mxnet_tpu_torch import train_fused
    from mxnet_tpu_torch.gluon.model_zoo import DeformableRFCN

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    net = DeformableRFCN(device=dev, generator=gen, **config)
    chip_smoke.randomize_deformable(net, gen)
    H, W = net.image_shape
    data, info = chip_smoke.make_request(gen, [[H, W, 1.0]], (H, W), dev)
    calls = {n: [] for n in names}
    if "nms_alive" in names:
        got = chip_smoke.capture_calls(kernels, ["nms_alive"], lambda: net(data, info))
        calls["nms_alive"] += [("serve", a, k) for a, k in got["nms_alive"]]
    step = train_fused.make_rfcn_train_step(net, 1, learning_rate=chip_smoke.LR,
                                            momentum=0.9)
    inputs = chip_smoke.train_inputs(net, np.random.RandomState(chip_smoke.SEED), 1, dev)
    nz = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    got = chip_smoke.capture_calls(
        kernels, [n for n in names if n in ("nms_alive", "dconv_col_bwd")],
        lambda: step(*inputs, *chip_smoke.train_noise(net, 1, nz, dev), chip_smoke.LR))
    for n, lst in got.items():
        calls[n] += [("train", tuple(a.detach() if torch.is_tensor(a) else a for a in args),
                      kw) for args, kw in lst[:1]]
    del net
    torch.cuda.empty_cache()
    return calls


def describe(name, args, kw, out):
    """What a call is: shapes, and for NMS its words and survivors."""
    d = {"shapes": [list(a.shape) for a in args if torch.is_tensor(a)]}
    if name == "nms_alive":
        N = args[1].shape[1]
        d.update(words=-(-N // 64), survivors=[int(v) for v in out.sum(1)],
                 valid=[int(v) for v in args[1].sum(1)], thresh=kw.get("thresh"))
    if name == "dconv_col_bwd":
        d["g_strides"] = list(args[8].stride())
        layout = args[10] if len(args) > 10 else kw.get("layout")
        if layout is not None:
            d.update(layout=list(layout), **tile_windows(*args[:4], layout))
    return d


# the tiled dconv backward's tile and window limit (ops/csrc/dconv_col_bwd.cu
# kTileH, kTileW, kMaxWindow)
TILE_H, TILE_W, MAX_WINDOW = 4, 8, 224


def tile_windows(y0, y1, x0, x1, layout):
    """The tiled dconv backward's windows at a call: the share of tiles whose
    window fits in shared memory, and the median window in pixels."""
    K2, Ho, Wo = layout
    pad = (0, -Wo % TILE_W, 0, -Ho % TILE_H)  # edge copies: min and max unchanged

    def tiles(t, reduce):
        t = torch.nn.functional.pad(t.reshape(-1, K2, Ho, Wo).float(), pad, mode="replicate")
        t = t.reshape(t.shape[0], K2, t.shape[2] // TILE_H, TILE_H, t.shape[3] // TILE_W,
                      TILE_W)
        return reduce(reduce(reduce(t, 5), 3), 1)

    amin = lambda t, dim: t.amin(dim)
    amax = lambda t, dim: t.amax(dim)
    wh = tiles(y1, amax) - tiles(y0, amin) + 1
    ww = tiles(x1, amax) - tiles(x0, amin) + 1
    px = (wh * ww).flatten().float()
    return {"tiles": int(wh.numel()),
            "tiles_in_shared_window": float((px <= MAX_WINDOW).float().mean()),
            "window_px_quantiles": [float(v) for v in
                                    px.quantile(torch.tensor([0.1, 0.5, 0.9, 1.0], device=px.device))]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=",".join(ALL),
                    help="comma-separated, from %s" % ", ".join(ALL))
    ap.add_argument("--against", action="append", default=[],
                    help="a directory of .cu sources to build and compare with "
                    "(repeatable)")
    opt = ap.parse_args()
    names = [n for n in opt.kernels.split(",") if n]
    bad = [n for n in names if n not in ALL]
    if bad:
        sys.exit("bench_kernels: unknown kernels %s" % bad)
    if not torch.cuda.is_available():
        sys.exit("bench_kernels: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    say({"card": card, "torch": torch.__version__})
    _build.library()
    say({"ptxas": [l.strip() for l in _build.build_info()["ptxas"].splitlines()
                   if "Compiling entry" in l or "Used" in l]})
    others = [Other(d) for d in opt.against]

    calls = {}  # name -> [(label, args, kw)]
    for n in names:
        if n in ABUILD_CALLS:
            calls[n] = [("path", tuple(abuild_inputs(n, ABUILD_CALLS[n], 0)), {})]
    want = [n for n in names if n in ("nms_alive", "dconv_col_bwd")]
    if want:
        calls.update(path_calls(want, torch.device("cuda"),
                                dict(chip_smoke.FULL, units=(3, 4, 23, 3))))

    for n in names:  # the builds against each other, on every call compared
        k = kernels.KERNELS[n]
        extra = []
        if n in ABUILD_CALLS:
            extra = [("test", tuple(abuild_inputs(n, s, i)), {})
                     for i, s in enumerate(ABUILD_TEST_SHAPES)
                     if not (n == "psroi_abuild_bwd" and s[2] == 800)]
        for label, args, kw in calls[n] + extra:
            got = k.wrapper(*args, **kw)
            row = {"name": n, "call": label, **describe(n, args, kw, got)}
            if label != "test":
                ref = k.plain(*args, **kw)
                row["vs_plain"] = dict(zip(("bitwise_equal", "max_abs_diff", "within_tol"),
                                           agree(n, got, ref)))
            row["rerun_equal"] = agree(n, got, k.wrapper(*args, **kw))[0]
            for o in others:
                row["vs_" + o.label] = dict(zip(("bitwise_equal", "max_abs_diff",
                                                  "within_tol"),
                                                 agree(n, got, o.call(n, args, kw))))
            torch.cuda.synchronize()
            say(row)

    for n in names:  # times, on the path's calls
        k = kernels.KERNELS[n]
        for label, args, kw in calls[n]:
            out = k.wrapper(*args, **kw)
            bound_ms, by = chip_smoke.bound(*chip_smoke.work(n, args, out))
            row = {"name": n, "call": label, "bound_ms": bound_ms, "bound_by": by}
            this = lambda: k.wrapper(*args, **kw)
            row["ms"] = chip_smoke.time_ms(this, REPS)
            for o in others:
                that = lambda: o.call(n, args, kw)
                t = [chip_smoke.time_ms(f, REPS) for f in (that, this, this, that)]
                row[o.label] = {"ms": (t[0] + t[3]) / 2, "turns": [t[0], t[3]],
                                "this_turns": [t[1], t[2]]}
            if n == "psroi_abuild":
                yv, xv = args
                row["library_ms"] = chip_smoke.time_ms(
                    lambda: torch.bmm(yv.transpose(1, 2), xv), REPS)
            elif n == "psroi_abuild_bwd":
                yv, xv, g = args
                row["library_ms"] = chip_smoke.time_ms(
                    lambda: (torch.bmm(xv, g.transpose(1, 2)), torch.bmm(yv, g)), REPS)
            elif n == "dconv_col_bwd":
                g = args[8]
                cm = g if not g.is_contiguous() else g.transpose(1, 2).contiguous().transpose(1, 2)
                row["g_contiguous_copy_ms"] = chip_smoke.time_ms(cm.contiguous, REPS)
            # a device copy that reads half and writes half of the call's bytes:
            # what the memory system gives a plain stream at this size
            nbytes = chip_smoke.work(n, args, out)[0]
            src = torch.empty(max(int(nbytes) // 8, 1), device="cuda")
            dst = torch.empty_like(src)
            row["copy_ms"] = chip_smoke.time_ms(lambda: dst.copy_(src), REPS)
            row["share_of_bound"] = bound_ms / row["ms"]
            say(row)


if __name__ == "__main__":
    main()
