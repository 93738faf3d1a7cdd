"""Creation operators (counterpart of ``mxnet_tpu/ops/init_ops.py``;
reference src/operator/tensor/init_op.cc): ``_zeros``, ``_ones``,
``_full``, ``_arange``, ``_eye``, ``_linspace`` and ``_zeros_rows``.  They
take no tensor input: ``device`` says where the result lives (the nd
frontend passes its context's device; None means CUDA, and raises
without it)."""
from __future__ import annotations

import torch

from ..context import resolve_device
from .elemwise import to_dtype
from .registry import register

__all__ = ["zeros", "ones", "full", "arange"]


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _kw(dtype, device):
    return dict(dtype=to_dtype(dtype or "float32"), device=resolve_device(device))


@register("_zeros", alias=("zeros",))
def zeros(*, shape, dtype="float32", device=None):
    return torch.zeros(_shape(shape), **_kw(dtype, device))


@register("_zeros_rows")
def zeros_rows(data, *, tail, dtype="float32"):
    """Zeros of shape ``(data.shape[0],) + tail`` on ``data``'s device."""
    return torch.zeros((data.shape[0],) + _shape(tail), dtype=to_dtype(dtype or "float32"),
                       device=data.device)


@register("_ones", alias=("ones",))
def ones(*, shape, dtype="float32", device=None):
    return torch.ones(_shape(shape), **_kw(dtype, device))


@register("_full", alias=("full",))
def full(*, shape, value, dtype="float32", device=None):
    return torch.full(_shape(shape), value, **_kw(dtype, device))


@register("_arange", alias=("arange",))
def arange(*, start=0, stop=None, step=1.0, repeat=1, dtype="float32", device=None):
    """``[start, stop)`` by ``step`` (no ``stop``: ``[0, start)``), each
    value ``repeat`` times."""
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, **_kw(dtype, device))
    return torch.repeat_interleave(out, repeat) if repeat != 1 else out


@register("_eye", alias=("eye",))
def eye(*, N, M=0, k=0, dtype="float32", device=None):
    """Ones on the ``k``-th diagonal of an N×M (M 0: N×N) matrix."""
    M = M or N
    rows = torch.arange(N, device=resolve_device(device))[:, None]
    cols = torch.arange(M, device=rows.device)[None, :]
    return (cols - rows == k).to(to_dtype(dtype or "float32"))


@register("_linspace", alias=("linspace",))
def linspace(*, start, stop, num, endpoint=True, dtype="float32", device=None):
    kw = _kw(dtype, device)
    if endpoint:
        return torch.linspace(start, stop, num, **kw)
    step = (stop - start) / num
    return torch.linspace(start, stop - step, num, **kw)
