"""Data iterators (counterpart of ``mxnet_tpu/io.py``): ``DataBatch`` and an
in-order ``NDArrayIter`` over tensors, which is what the calibration of
:func:`mxnet_tpu_torch.contrib.quantization.quantize_model` reads."""
from __future__ import annotations

import torch

__all__ = ["DataBatch", "NDArrayIter"]


class DataBatch:
    """One batch: a list of data tensors, a list of label tensors and the
    number of padding samples at its end (reference io.py DataBatch)."""

    def __init__(self, data, label=None, pad=0):
        self.data = data
        self.label = label
        self.pad = pad


class NDArrayIter:
    """One pass over in-memory tensors (or arrays) in batches, in order
    (reference io.py:546, without shuffling).  A last partial batch is padded
    by wrapping around to the start, as ``last_batch_handle="pad"`` does."""

    def __init__(self, data, label=None, batch_size=1):
        self.data = [torch.as_tensor(d) for d in _as_list(data)]
        self.label = [torch.as_tensor(v) for v in _as_list(label)]
        self.batch_size = batch_size
        self.num_data = self.data[0].shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size")
        self.cursor = -batch_size

    def __iter__(self):
        return self

    def __next__(self):
        self.cursor += self.batch_size
        if self.cursor >= self.num_data:
            raise StopIteration
        pad = max(self.cursor + self.batch_size - self.num_data, 0)
        return DataBatch([self._take(v, pad) for v in self.data],
                         [self._take(v, pad) for v in self.label], pad=pad)

    def _take(self, v, pad):
        part = v[self.cursor: self.cursor + self.batch_size]
        return torch.cat([part, v[:pad]]) if pad else part


def _as_list(v):
    if v is None:
        return []
    return list(v) if isinstance(v, (list, tuple)) else [v]
