"""Device selection for the port (counterpart of ``mxnet_tpu/context.py``).

The rule: every entry point takes ``device=``.  When it is not given the
device is ``"cuda"``; if CUDA is missing the entry point raises unless the
caller asked for ``"cpu"``.  There is no silent CPU path.

``Context`` (``cpu()``, ``gpu(i)``, ``with ctx:``) is the imperative
frontend's form of the same rule: its default is ``gpu(0)``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["Context", "as_device", "cpu", "current_context", "full_fp32", "gpu",
           "num_gpus", "resolve_device"]


# full_fp32's holders across threads: the first to enter saves the flags
# and sets them off, the last to leave restores them
_FP32_LOCK = threading.Lock()
_fp32_holders = 0
_fp32_saved = None


def _fp32_flags():
    mm = torch.backends.cuda.matmul
    return (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)


def _set_fp32_flags(flags):
    mm = torch.backends.cuda.matmul
    (mm.allow_tf32, torch.backends.cudnn.allow_tf32,
     mm.allow_bf16_reduced_precision_reduction) = flags


@contextlib.contextmanager
def full_fp32():
    """Full fp32 arithmetic and accumulation inside the block, the caller's
    settings restored after it: TF32 off for cuDNN convolutions and float32
    matmuls, and cuBLAS's reduced-precision (bf16) reductions off for
    bfloat16 matmuls.  PyTorch allows cuDNN's TF32 and the reduced-precision
    reductions by default; the JAX reference computes fp32 in full fp32 and
    accumulates bf16 products in fp32.

    The three flags are process-global, and serving runs forwards from
    several threads at once: the first holder (of any thread) saves the
    flags and sets them off, the last to leave restores them, so no block
    sees them back on while another thread's is still running."""
    global _fp32_holders, _fp32_saved
    with _FP32_LOCK:
        if _fp32_holders == 0:
            _fp32_saved = _fp32_flags()
            _set_fp32_flags((False, False, False))
        _fp32_holders += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_holders -= 1
            if _fp32_holders == 0:
                _set_fp32_flags(_fp32_saved)
                _fp32_saved = None


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


class Context:
    """A device context (counterpart of ``mxnet_tpu/context.py`` Context;
    reference python/mxnet/context.py:23): ``Context("gpu", i)`` is
    ``torch.device("cuda", i)``, ``Context("cpu")`` the CPU.  ``with ctx:``
    makes it the default context of the thread for the imperative frontend
    (``nd.array``, ``Block.initialize``, the random samplers).

    ``Context()`` and the default context are ``gpu(0)``: its ``device``
    resolves through ``resolve_device`` and raises without a card, unless
    the caller has entered ``cpu()``.  The JAX package's ``tpu()`` has no
    counterpart."""

    _default_ctx = threading.local()

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {v: k for k, v in devtype2str.items()}

    def __init__(self, device_type="gpu", device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        elif isinstance(device_type, torch.device):
            device_type, device_id = (
                ("gpu", device_type.index or 0) if device_type.type == "cuda"
                else ("cpu", 0))
        if device_type not in Context.devstr2type:
            raise ValueError("Context: device type must be one of %s, got %r (the "
                             "JAX package's 'tpu' is not ported)"
                             % (sorted(Context.devstr2type), device_type))
        self.device_typeid = Context.devstr2type[device_type]
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def device(self):
        """The ``torch.device``; a gpu context raises without CUDA."""
        if self.device_type == "gpu":
            return resolve_device(torch.device("cuda", self.device_id))
        return torch.device("cpu")

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context) and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id=0):
    """The CPU context."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """The context of CUDA device ``device_id``."""
    return Context("gpu", device_id)


def num_gpus():
    """Number of visible CUDA devices."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The thread's default context: the innermost ``with ctx:``, else
    ``gpu(0)``."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", 0)


def as_device(ctx=None):
    """A Context, a ``torch.device``, a device string or None (the current
    context) -> ``torch.device``; CUDA raises without a card."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return ctx.device
    return resolve_device(ctx)
