#!/usr/bin/env python3
"""Time the port's CUDA kernels at the R-FCN path's calls, and compare builds.

    python3 tools/bench_kernels.py [--kernels a,b,...] [--against DIR ...]
    python3 tools/bench_kernels.py --dtype bfloat16 [--kernels a,b,...]
    python3 tools/bench_kernels.py --batch 2 ...   # the path's calls at batch 2

With ``--dtype bfloat16`` the rows are the bf16 instances of the dconv and
A-build kernels (``dconv_col[bf16]`` and so on; NMS stays fp32) on the bf16
path's calls: the forward calls of the model after ``cast("bfloat16")``,
the backward calls of a ``compute_dtype="bfloat16"`` train step, and the
A-build pair's seeded calls with A (and g) in bf16; bf16 outputs are
compared within one bf16 ulp (d_ft plus 1e-5 of its largest value).

Kernels (``--kernels``, default all five):

* ``psroi_abuild`` on the serve call (N = 14,700, S = 16, 38 x 64) and
  ``psroi_abuild_bwd`` on the train call (N = 6,272), on seeded inputs of the
  path's shapes, each beside two ``torch.bmm`` yardsticks;
* ``nms_alive``, ``dconv_col`` and ``dconv_col_bwd`` on the path's own
  calls: the tool builds ``chip_smoke.py``'s full-width R-101 model (seeded
  weights), runs one inference forward and, for NMS and the dconv backward,
  one batch-1 train step, and records the calls (NMS on the serve and on the
  train call, the first of the three dconv forward calls of the serve
  forward and of the three backward calls of the step).  NMS prints its
  words and survivors per call; the dconv forward is timed beside
  ``layout_copy_ms``, the copy that would turn its column into the weight
  product's layout (0 when it is stored that way, channel-major), and is
  also compared on a few edge shapes; the dconv backward is timed on ``g``
  and the rows' layout as the autograd hands them, beside the copy that
  would make that ``g`` contiguous, and prints its tiles' windows (the
  tiled design's share of tiles whose window fits in shared memory, and
  window quantiles in pixels).

Each row gives the kernel's device time (``chip_smoke.time_ms``), its bound,
a device copy of the same byte count, and the device operations (kernels,
memsets) of one call, from the profiler, by name (``device_ops``; each
``--against`` build's too).  With ``--against DIR`` (another
revision's ``mxnet_tpu_torch/ops/csrc``, or a copy with one change, for a
timing split; repeatable), every ``.cu`` file of ``DIR`` is built into a
library of its own, and for each such build: the outputs of both builds are
compared on the same inputs (bit for bit, and within the smoke's
tolerances; NMS must be equal; a timing copy that computes something else
shows up as unequal and is only reported), and
the two are timed in turns (other, this, this, other) in this one process.
The C entries' signatures are those of ``DIR/../_build.py`` where that
file exists (another revision's ``ops`` package), else this revision's; a
bf16 dconv backward entry with one pointer more than the fp32 one gets an
fp32 buffer for its d_ft sums.
An older ``mx_dconv_col_bwd`` takes a prefix of this revision's integer
arguments (BG, N, H, W, C; then g's row and channel strides; then the rows'
layout K2, Ho, Wo); one without g's strides gets a contiguous copy of g,
made once and not timed.  An ``mx_dconv_col`` without this revision's last
integer argument (``vec``) writes its column row-major: its row also gives
``layout_copy_ms``, the caller's transposing copy of that column alone, and
``with_layout_copy_ms``, the kernel and that copy together, both in turns.
Prints one JSON object per line.  Needs one NVIDIA GPU; imports no JAX.
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

ALL = ("psroi_abuild", "psroi_abuild_bwd", "nms_alive", "dconv_col", "dconv_col_bwd")
ABUILD_CALLS = {"psroi_abuild": (14700, 16, 38, 64),
                "psroi_abuild_bwd": (6272, 16, 38, 64)}
REPS = 50  # timed calls in a row, after chip_smoke.time_ms's warm-up
# the card tests' A-build shapes, compared across builds
ABUILD_TEST_SHAPES = ((300, 16, 38, 64), (7, 3, 5, 200), (20, 16, 800, 64),
                      (33, 16, 38, 61), (20, 1, 38, 64), (20, 16, 1, 64),
                      (1, 16, 38, 64), (300, 16, 76, 64), (6271, 16, 38, 64),
                      (20, 16, 300, 64))
# (BG, N, H, W, C) of the card tests' dconv forward shapes that take the
# other kernel or part of a pass (C 72, 130, 132; N 501), compared across builds
DCONV_TEST_SHAPES = ((4, 500, 19, 23, 72), (4, 501, 19, 23, 128),
                     (4, 500, 19, 23, 130), (3, 500, 19, 23, 132))
# and the bf16 forward's: its 16-byte design with C 8 and 136 (a second pass
# in part), then N 500 (the 8-byte design) and 501 (one thread an output)
DCONV_BF16_TEST_SHAPES = ((2, 504, 19, 23, 8), (3, 1000, 19, 23, 136),
                          (2, 500, 19, 23, 128), (4, 501, 19, 23, 128))


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
        self.sigs = sigs
        # the integer arguments this build's mx_dconv_col_bwd takes (13
        # pointers before them, the stream after)
        self.dconv_ints = len(sigs["mx_dconv_col_bwd"]) - 14
        # an mx_dconv_col with five integer arguments (9 pointers before
        # them) writes col row-major; one with six takes ``vec`` last
        self.col_row_major = len(sigs["mx_dconv_col"]) - 10 == 5
        for name, argtypes in sigs.items():
            fn = getattr(self.dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        self.masks = {}  # NMS mask scratch, one per shape, kept across calls
        self.contiguous = {}

    def pointers(self, entry):
        """The leading pointer arguments of C entry ``entry``."""
        sig = self.sigs[entry]
        return next((i for i, t in enumerate(sig) if t is not ctypes.c_void_p), len(sig))

    def call(self, name, args, kw):
        """``name``'s kernel (a bf16 row, ``dconv_col[bf16]``, its bf16
        entry) of this build on ``args``, its outputs allocated here."""
        stream = torch.cuda.current_stream().cuda_stream
        d = self.dll
        bf16 = name.endswith("[bf16]")
        entry = lambda base: getattr(d, "mx_" + base + ("_bf16" if bf16 else ""))
        name = name.split("[")[0]
        if name == "psroi_abuild":
            yv, xv = args
            n, s, h = yv.shape
            a = torch.empty((n, h, xv.shape[2]), device="cuda",
                            dtype=torch.bfloat16 if bf16 else torch.float32)
            rc, outs = entry(name)(yv.data_ptr(), xv.data_ptr(), a.data_ptr(),
                                   n, s, h, xv.shape[2], stream), a
        elif name == "psroi_abuild_bwd":
            yv, xv, g = args
            n, s, h = yv.shape
            dyv, dxv = torch.empty_like(yv), torch.empty_like(xv)
            rc = entry(name)(yv.data_ptr(), xv.data_ptr(), g.data_ptr(),
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
        elif name == "dconv_col":
            y0, ft, hw = args[0], args[7], args[8]
            BG, N = y0.shape
            C = ft.shape[2]
            if self.col_row_major:
                outs, extra = torch.empty((BG, N, C), device="cuda", dtype=ft.dtype), []
            else:
                outs = kernels._col_empty(BG, N, C, y0.device, ft.dtype)
                extra = [kernels._dconv_col_vec((*args[:8], outs), N, C)]
            rc = entry(name)(*(t.data_ptr() for t in args[:8]), outs.data_ptr(),
                             BG, N, hw[0], hw[1], C, *extra, stream)
        else:  # dconv_col_bwd
            y0, y1, x0, x1, ly, lx, lf, ft, g, hw = args[:10]
            layout = args[10] if len(args) > 10 else kw.get("layout")
            BG, N = y0.shape
            C = ft.shape[2]
            rows = [torch.empty((BG, N), device="cuda") for _ in range(3)]
            dft = torch.empty_like(ft)
            ptrs = [t.data_ptr() for t in (y0, y1, x0, x1, ly, lx, lf, ft)]
            outp = [t.data_ptr() for t in rows + [dft]]
            if bf16 and self.pointers("mx_dconv_col_bwd_bf16") == 14:
                # that build sums d_ft in an fp32 buffer its caller allocates
                outp.append(torch.empty(ft.shape, device="cuda").data_ptr())
            if self.dconv_ints < 7 and not g.is_contiguous():
                # what the first signature's caller did, once per g (not timed)
                if g.data_ptr() not in self.contiguous:
                    self.contiguous[g.data_ptr()] = g.contiguous()
                g = self.contiguous[g.data_ptr()]
            ints = [BG, N, hw[0], hw[1], C, int(g.stride(1)), int(g.stride(2)),
                    *(layout or (0, 0, 0))]
            rc = entry(name)(*ptrs, g.data_ptr(), *outp, *ints[:self.dconv_ints], stream)
            outs = (*rows, dft)
        if rc != 0:
            raise RuntimeError("%s (build %s): CUDA error %d" % (name, self.label, rc))
        return outs


def device_ops(fn):
    """The device operations (kernels, memsets, copies) of one ``fn()``, from
    the profiler: {name: count}."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            ops[evt.key[:60]] = ops.get(evt.key[:60], 0) + evt.count
    return ops


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def agree(name, got, ref):
    """(equal bit for bit, max |difference|, within the smoke's tolerance:
    one bf16 ulp for a bf16 output)."""
    got, ref = as_tuple(got), as_tuple(ref)
    equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    diff = max(float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
               for a, b in zip(got, ref))
    if name == "nms_alive":
        return equal, diff, equal
    close = True
    for a, b in zip(got, ref):
        scale = float(b.float().abs().max()) if b.numel() else 0.0
        if a.dtype == torch.bfloat16:
            slack = 1e-5 * scale if name == "dconv_col_bwd" else 0.0
            close &= bool(((a.float() - b.float()).abs()
                           <= chip_smoke.bf16_ulp(b) + slack).all())
            continue
        rtol = 1e-4 if name == "dconv_col_bwd" else 1e-5
        atol = 1e-5 if name in ("psroi_abuild", "dconv_col") else 1e-5 * scale
        close &= scale == scale and bool(torch.allclose(a, b, rtol=rtol, atol=atol))
    return equal, diff, close


def abuild_inputs(name, shape, seed, bf16=False):
    n, s, h, w = shape
    rng = np.random.RandomState(seed)
    t = [rng.rand(n, s, h), rng.rand(n, s, w)]
    if name == "psroi_abuild_bwd":
        t.append(rng.randn(n, h, w))
    t = [torch.from_numpy(a.astype(np.float32)).cuda() for a in t]
    if bf16 and name == "psroi_abuild_bwd":
        t[2] = t[2].to(torch.bfloat16)  # the cotangent of a bf16 A
    return t


def dconv_inputs(shape, seed, bf16=False):
    """Seeded dconv forward inputs with clamped corners and dead rows, as
    the card tests make them (ft in bf16 with ``bf16``)."""
    BG, N, H, W, C = shape
    rng = np.random.RandomState(seed)
    y0, x0 = rng.randint(0, H, (BG, N)), rng.randint(0, W, (BG, N))
    y0[:, :20], x0[:, 10:30] = H - 1, W - 1
    ints = [y0, np.minimum(y0 + 1, H - 1), x0, np.minimum(x0 + 1, W - 1)]
    flts = [rng.rand(BG, N), rng.rand(BG, N), rng.rand(BG, N) > 0.2,
            rng.randn(BG, H * W, C)]
    t = ([torch.from_numpy(a.astype(np.int32)).cuda() for a in ints]
         + [torch.from_numpy(a.astype(np.float32)).cuda() for a in flts])
    if bf16:
        t[7] = t[7].to(torch.bfloat16)
    return tuple(t + [(H, W)])


def path_calls(names, dev, config, bf16=False, batch=1):
    """The calls of ``names`` (nms_alive, dconv_col, dconv_col_bwd, or their
    bf16 rows) on the R-FCN path of ``config`` (``chip_smoke.FULL``: the
    full-width R-101) at ``batch`` images, in bf16 the model cast to bf16
    for the forward and the bf16 train step for the backward:
    {name: [(label, args, kw), ...]}."""
    import copy

    from mxnet_tpu_torch import train_fused
    from mxnet_tpu_torch.gluon.model_zoo import DeformableRFCN

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    net = DeformableRFCN(device=dev, generator=gen, **config)
    chip_smoke.randomize_deformable(net, gen)
    H, W = net.image_shape
    data, info = chip_smoke.make_request(gen, [[H, W, 1.0]] * batch, (H, W), dev)
    snet = copy.deepcopy(net).cast("bfloat16") if bf16 else net
    data = data.to(snet.rfcn_cls.weight.dtype)
    calls = {n: [] for n in names}
    serve = [n for n in names if n.split("[")[0] in ("nms_alive", "dconv_col")]
    got = chip_smoke.capture_calls(kernels, serve, lambda: snet(data, info))
    for n, lst in got.items():
        calls[n] += [("serve", a, k) for a, k in lst[:1]]
    train = [n for n in names if n.split("[")[0] in ("nms_alive", "dconv_col_bwd")]
    if train:
        step = train_fused.make_rfcn_train_step(net, batch, learning_rate=chip_smoke.LR,
                                                momentum=0.9,
                                                compute_dtype="bfloat16" if bf16 else None)
        inputs = chip_smoke.train_inputs(net, np.random.RandomState(chip_smoke.SEED), batch,
                                         dev)
        nz = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
        got = chip_smoke.capture_calls(
            kernels, train,
            lambda: step(*inputs, *chip_smoke.train_noise(net, batch, nz, dev),
                         chip_smoke.LR))
        for n, lst in got.items():
            calls[n] += [("train", tuple(a.detach() if torch.is_tensor(a) else a
                                         for a in args), kw) for args, kw in lst[:1]]
    del net, snet
    torch.cuda.empty_cache()
    return calls


def describe(name, args, kw, out):
    """What a call is: shapes, and for NMS its words and survivors."""
    d = {"shapes": [list(a.shape) for a in args if torch.is_tensor(a)]}
    if name == "nms_alive":
        N = args[1].shape[1]
        d.update(words=-(-N // 64), survivors=[int(v) for v in out.sum(1)],
                 valid=[int(v) for v in args[1].sum(1)], thresh=kw.get("thresh"))
    if name == "dconv_col":
        d["col_strides"] = list(out.stride())
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
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                    help="bfloat16: the bf16 instances on the bf16 path's calls")
    ap.add_argument("--batch", type=int, default=1,
                    help="images of the serve request and the train step whose "
                    "calls are timed (the A-build pair's seeded calls stay)")
    opt = ap.parse_args()
    bf16 = opt.dtype == "bfloat16"
    names = [n for n in opt.kernels.split(",") if n]
    bad = [n for n in names if n not in ALL]
    if bad:
        sys.exit("bench_kernels: unknown kernels %s" % bad)
    if bf16:  # the bf16 rows; NMS has none
        names = [n + "[bf16]" for n in names if n != "nms_alive"]
    if not torch.cuda.is_available():
        sys.exit("bench_kernels: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    say({"card": card, "torch": torch.__version__, "batch": opt.batch})
    _build.library()
    say({"ptxas": [l.strip() for l in _build.build_info()["ptxas"].splitlines()
                   if "Compiling entry" in l or "Used" in l]})
    others = [Other(d) for d in opt.against]

    calls = {}  # name -> [(label, args, kw)]
    for n in names:
        b = n.split("[")[0]
        if b in ABUILD_CALLS:
            calls[n] = [("path", tuple(abuild_inputs(b, ABUILD_CALLS[b], 0, bf16)), {})]
    want = [n for n in names if n.split("[")[0] in ("nms_alive", "dconv_col", "dconv_col_bwd")]
    if want:
        calls.update(path_calls(want, torch.device("cuda"),
                                dict(chip_smoke.FULL, units=(3, 4, 23, 3)), bf16,
                                opt.batch))

    for n in names:  # the builds against each other, on every call compared
        k = kernels.KERNELS[n]
        b = n.split("[")[0]
        extra = []
        if b in ABUILD_CALLS:
            extra = [("test", tuple(abuild_inputs(b, s, i, bf16)), {})
                     for i, s in enumerate(ABUILD_TEST_SHAPES)
                     if not (b == "psroi_abuild_bwd" and s[2] == 800)]
        elif n == "dconv_col":
            extra = [("test", dconv_inputs(s, i), {}) for i, s in enumerate(DCONV_TEST_SHAPES)]
        elif n == "dconv_col[bf16]":
            extra = [("test", dconv_inputs(s, i, bf16), {})
                     for i, s in enumerate(DCONV_BF16_TEST_SHAPES)]
        for label, args, kw in calls[n] + extra:
            got = k.wrapper(*args, **kw)
            row = {"name": n, "call": label, **describe(b, args, kw, got)}
            if label != "test":
                ref = k.plain(*args, **kw)
                row["vs_plain"] = dict(zip(("bitwise_equal", "max_abs_diff", "within_tol"),
                                           agree(b, got, ref)))
            row["rerun_equal"] = agree(b, got, k.wrapper(*args, **kw))[0]
            for o in others:
                row["vs_" + o.label] = dict(zip(("bitwise_equal", "max_abs_diff",
                                                  "within_tol"),
                                                 agree(b, got, o.call(n, args, kw))))
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
            row["device_ops"] = device_ops(this)
            for o in others:
                timed = {"ms": lambda: o.call(n, args, kw)}
                if n == "dconv_col" and o.col_row_major:
                    old = o.call(n, args, kw)
                    timed["layout_copy_ms"] = lambda: old.transpose(1, 2).contiguous()
                    timed["with_layout_copy_ms"] = (
                        lambda: o.call(n, args, kw).transpose(1, 2).contiguous())
                row[o.label] = {"device_ops": device_ops(timed["ms"])}
                for key, that in timed.items():
                    t = [chip_smoke.time_ms(f, REPS) for f in (that, this, this, that)]
                    pre = "" if key == "ms" else key + "_"
                    row[o.label].update({key: (t[0] + t[3]) / 2, pre + "turns": [t[0], t[3]],
                                         pre + "this_turns": [t[1], t[2]]})
            if n == "psroi_abuild":
                yv, xv = args
                row["library_ms"] = chip_smoke.time_ms(
                    lambda: torch.bmm(yv.transpose(1, 2), xv), REPS)
            elif n == "psroi_abuild_bwd":
                yv, xv, g = args
                row["library_ms"] = chip_smoke.time_ms(
                    lambda: (torch.bmm(xv, g.transpose(1, 2)), torch.bmm(yv, g)), REPS)
            elif n == "dconv_col":
                row["layout_copy_ms"] = chip_smoke.layout_copy_ms(out, REPS)
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
