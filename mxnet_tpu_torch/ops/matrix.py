"""Shape operators (counterpart of ``mxnet_tpu/ops/matrix.py``)."""
from __future__ import annotations

import math

from .registry import register

__all__ = ["infer_reshape", "reshape", "flatten"]


def infer_reshape(src_shape, target):
    """MXNet Reshape target -> concrete shape (reference matrix_op-inl.h
    ReshapeParam; ``mxnet_tpu/ops/matrix.py infer_reshape``).

    Codes: 0 copies the input dim at the same position, -1 is inferred from
    the rest, a positive value is taken as it is.  The other codes (-2, -3,
    -4, ``reverse``) are not ported.
    """
    out = []
    for i, code in enumerate(target):
        if code == 0:
            out.append(src_shape[i])
        elif code == -1 or code > 0:
            out.append(int(code))
        else:
            raise NotImplementedError("Reshape: code %d is not ported" % code)
    if -1 in out:
        known = math.prod(d for d in out if d != -1)
        out[out.index(-1)] = math.prod(src_shape) // max(known, 1)
    return tuple(out)


def reshape(data, shape):
    """Reshape with the MXNet special codes (reference matrix_op.cc Reshape)."""
    return data.reshape(infer_reshape(data.shape, shape))


@register("Flatten")
def flatten(data):
    """Collapse all axes but the first (reference matrix_op.cc Flatten)."""
    return data.reshape((data.shape[0], -1) if data.dim() > 1 else (data.shape[0],))
