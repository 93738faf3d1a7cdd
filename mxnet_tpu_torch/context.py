"""Device selection for the port (counterpart of ``mxnet_tpu/context.py``).

The rule: every entry point takes ``device=``.  When it is not given the
device is ``"cuda"``; if CUDA is missing the entry point raises unless the
caller asked for ``"cpu"``.  There is no silent CPU path.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["full_fp32", "resolve_device"]


@contextlib.contextmanager
def full_fp32():
    """Full fp32 arithmetic and accumulation inside the block, the caller's
    settings restored after it: TF32 off for cuDNN convolutions and float32
    matmuls, and cuBLAS's reduced-precision (bf16) reductions off for
    bfloat16 matmuls.  PyTorch allows all three by default; the JAX
    reference computes fp32 in full fp32 and accumulates bf16 products in
    fp32."""
    mm = torch.backends.cuda.matmul
    old = (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
           mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
         mm.allow_bf16_reduced_precision_reduction) = old


def resolve_device(device=None):
    """``device`` (None, a string or a ``torch.device``) -> ``torch.device``.

    None means CUDA.  Raises RuntimeError when CUDA is asked for (or
    defaulted to) and is not available, and ValueError for a device type
    the port does not run on.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mxnet_tpu_torch runs on CUDA by default and no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError("mxnet_tpu_torch runs on 'cuda' or 'cpu', got %r"
                         % (device,))
    return dev
