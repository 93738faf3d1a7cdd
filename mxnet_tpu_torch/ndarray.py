"""Saving and loading tensors in the JAX package's file layout (counterpart
of ``mxnet_tpu/ndarray/__init__.py`` ``save`` / ``load``; reference
MXNDArraySave / MXNDArrayLoad): a numpy ``.npz`` whose ``__mx_format__`` is
"single" (key ``a0``), "list" (``a0``, ``a1``, ...) or "dict" (``k_<name>``).
A file written by either package loads in the other; this is how
checkpoints carry weights between them."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["save", "load"]


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save(fname, data):
    """Save a tensor, a list of them or a {name: tensor} dict to ``fname``
    (tensors on any device, or arrays)."""
    # an open handle, so that numpy does not append ".npz" to the name
    with open(fname, "wb") as f:
        if isinstance(data, dict):
            np.savez(f, __mx_format__="dict", **{"k_" + k: _np(v) for k, v in data.items()})
        elif isinstance(data, (list, tuple)):
            np.savez(f, __mx_format__="list", **{"a%d" % i: _np(a) for i, a in enumerate(data)})
        else:
            np.savez(f, __mx_format__="single", a0=_np(data))


def load(fname):
    """-> a list of CPU tensors ("single", "list") or a {name: tensor} dict."""
    with np.load(fname, allow_pickle=False) as z:
        fmt = str(z["__mx_format__"])
        if fmt == "dict":
            return {k[2:]: torch.from_numpy(z[k]) for k in z.files if k.startswith("k_")}
        n = len([k for k in z.files if k.startswith("a")])
        return [torch.from_numpy(z["a%d" % i]) for i in range(n)]
