"""Data iterators (counterpart of ``mxnet_tpu/io.py``; reference
python/mxnet/io.py): ``DataDesc``, ``DataBatch``, the ``DataIter`` base and
``NDArrayIter`` over in-memory tensors or arrays, what ``Module.fit`` and
the calibration of :func:`mxnet_tpu_torch.contrib.quantization.
quantize_model` read.  Batches are slices of the given tensors, on their
device; ``shuffle`` draws the order from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import collections

import torch

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    """A named input shape, with its dtype (reference io.py DataDesc)."""

    def __new__(cls, name, shape, dtype=torch.float32):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        return ret


class DataBatch:
    """One batch: a list of data tensors, a list of label tensors and the
    number of padding samples at its end (reference io.py DataBatch)."""

    def __init__(self, data, label=None, pad=0, provide_data=None, provide_label=None):
        self.data = data if isinstance(data, (list, tuple)) else [data]
        self.label = label if label is None or isinstance(label, (list, tuple)) else [label]
        self.pad = pad
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Iterator base (reference io.py:182): ``iter_next`` advances,
    ``getdata`` / ``getlabel`` / ``getpad`` read the current batch."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def __next__(self):
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(), pad=self.getpad())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getpad(self):
        raise NotImplementedError


def _init_data(data, default_name):
    """A tensor, an array, a list of them or a dict -> [(name, tensor)]
    (reference io.py _init_data): one unnamed input is ``default_name``,
    several ``_<i>_<default_name>``."""
    if data is None:
        return []
    if isinstance(data, dict):
        items = list(data.items())
    else:
        data = list(data) if isinstance(data, (list, tuple)) else [data]
        if len(data) == 1:
            items = [(default_name, data[0])]
        else:
            items = [("_%d_%s" % (i, default_name), d) for i, d in enumerate(data)]
    return [(k, torch.as_tensor(v)) for k, v in items]


class NDArrayIter(DataIter):
    """Batches over in-memory tensors (reference io.py:546).

    ``last_batch_handle``: "pad" fills the last batch from the start of the
    data and reports the count as ``pad``; "discard" drops the incomplete
    batch; "roll_over" fills it the same way without reporting a pad, and
    the next epoch starts where the filling ended.  ``shuffle`` reorders
    the samples at each ``reset`` (construction included) with
    ``generator``, a ``torch.Generator`` on the CPU (one seeded with 0 when
    None); the global random state is never used."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False, last_batch_handle="pad",
                 data_name="data", label_name="softmax_label", generator=None):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("last_batch_handle must be pad, discard or roll_over, got %r"
                             % last_batch_handle)
        self.data = _init_data(data, data_name)
        self.label = _init_data(label, label_name)
        self.num_source = self.data[0][1].shape[0]
        self.idx = torch.arange(self.num_source)
        self.shuffle = shuffle
        self.generator = generator
        if shuffle and generator is None:
            self.generator = torch.Generator().manual_seed(0)
        self.last_batch_handle = last_batch_handle
        self.num_data = self.num_source
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size")
        self.cursor = -batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            self.idx = torch.randperm(self.num_source, generator=self.generator)
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _batch(self, source):
        start, end = self.cursor, self.cursor + self.batch_size
        if not self.shuffle and end <= self.num_data:
            return [v[start:end] for _, v in source]
        sel = self.idx[start:min(end, self.num_data)]
        if end > self.num_data:  # wrap around to the start
            sel = torch.cat([sel, self.idx[:end - self.num_data]])
        return [v.index_select(0, sel.to(v.device)) for _, v in source]

    def getdata(self):
        return self._batch(self.data)

    def getlabel(self):
        return self._batch(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
