"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one process per source, all started together, and the objects are linked
into one shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``mxnet_tpu_torch/_build/<hash>/``, keyed by a hash of
the sources and the flags, so it is built at first use and rebuilt when a
source changes.  A failed build raises with the compiler's output.

Nothing here runs at import: :func:`library` builds on its first call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["build_info", "check", "library", "source_hash"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "libmxnet_tpu_torch_kernels.so"
# no --use_fast_math: the NMS IoU and the int8 quantize must round exactly as
# the plain versions, and the dconv and A-build kernels compute in full fp32
# as the TPU's did
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry -> argtypes; every entry returns cudaGetLastError() as an int
_SIGNATURES = {
    "mx_nms_alive": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    "mx_dconv_col": [_P] * 9 + [_I] * 6 + [_P],
    "mx_dconv_col_bf16": [_P] * 9 + [_I] * 6 + [_P],
    "mx_dconv_col_bwd": [_P] * 13 + [_I] * 10 + [_P],
    "mx_dconv_col_bwd_bf16": [_P] * 14 + [_I] * 10 + [_P],
    "mx_psroi_abuild": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mx_psroi_abuild_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "mx_psroi_abuild_bwd": [_P] * 5 + [_I] * 4 + [_P],
    "mx_psroi_abuild_bwd_bf16": [_P] * 5 + [_I] * 4 + [_P],
    "mx_quantize_int8": [_P, _P, _P, _L, _I, _P],
    "mx_dequantize_int8": [_P, _P, _P, _L, _I, _P],
}

_lock = threading.Lock()
_lib = None
_info = {"seconds": None, "path": None, "ptxas": ""}


def _nvcc():
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():  # the toolkit's default prefix
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "mxnet_tpu_torch need the CUDA toolkit to build")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError("no CUDA sources under %s" % CSRC)
    return srcs


def source_hash():
    """Hash of the kernel sources, headers and compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once; raise with its output if any fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append("%s\n%s" % (" ".join(cmd), out))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return outs


def _build(dest):
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        objs = [tmp / (src.stem + ".o") for src in _sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                         for src, obj in zip(_sources(), objs)])
        lib = tmp / LIB_NAME
        _run_all([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                   "-o", str(lib), *map(str, objs)]])
        dest.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib, dest)  # atomic: a concurrent build sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return "".join(logs)


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        dest = BUILD_ROOT / source_hash() / LIB_NAME
        t0 = time.perf_counter()
        if not dest.is_file():
            _info["ptxas"] = _build(dest)
        _info["seconds"] = time.perf_counter() - t0
        _info["path"] = str(dest)
        lib = ctypes.CDLL(str(dest))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mx_nms_scan_global.argtypes = [ctypes.c_int]
        lib.mx_nms_scan_global.restype = ctypes.c_int
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def build_info():
    """Seconds the first :func:`library` call took (build or load), the
    library's path, and ptxas' register / shared-memory report of the build
    (empty when the library was already built)."""
    return dict(_info)


def check(lib, rc, what):
    """Raise when a C entry reported a CUDA error."""
    if rc != 0:
        msg = lib.mx_cuda_error_string(rc).decode()
        raise RuntimeError("%s: CUDA error %d (%s)" % (what, rc, msg))
