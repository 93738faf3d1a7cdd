"""KVStore — the one-process parameter store (counterpart of
``mxnet_tpu/kvstore.py``; reference include/mxnet/kvstore.h:47,
python/mxnet/kvstore.py, src/kvstore/kvstore.cc:40-72).

``local`` and ``device`` keep a key -> tensor store in this process:
``push`` sums the values given for a key (one per device replica) and, with
an updater (``set_optimizer`` / ``set_updater``), applies it to the stored
value (the updater's index is the key as a string, as in the JAX store),
else stores the sum; ``pull`` copies the stored value into each
output.  ``rank`` is 0 and ``num_workers`` 1.  The distributed stores
(``dist_*``, the reference's parameter servers) and the gradient
compression they use are ROADMAP A10, and ``row_sparse_pull`` waits for
the sparse arrays (ROADMAP A14).
"""
from __future__ import annotations

import pickle

import torch

__all__ = ["KVStore", "create"]


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _tensor(v):
    """An NDArray's tensor, a tensor itself, or an array as a CPU tensor."""
    if hasattr(v, "_data"):
        return v._data
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def _write(dst, value):
    """Copy ``value`` into ``dst`` (a tensor or an NDArray)."""
    if hasattr(dst, "_set_data"):
        dst._set_data(value.to(dst._data.device))
    else:
        with torch.no_grad():
            dst.copy_(value)


class KVStore:
    """A key -> tensor store in one process (``local`` or ``device``)."""

    def __init__(self, type_str="local"):
        if type_str not in ("local", "device"):
            raise NotImplementedError("kvstore %r is not ported: one process takes 'local' "
                                      "or 'device' (ROADMAP A10)" % (type_str,))
        self._type = type_str
        self._store = {}
        self._updater = None
        self._optimizer = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Store a copy of each key's initial value."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                raise ValueError("key %s already initialized" % k)
            self._store[k] = _tensor(v).detach().clone()

    def push(self, key, value, priority=0):
        """Sum the values of each key (a list of them: one per replica), and
        apply the updater to the stored value, or store the sum.
        ``priority`` is taken for the reference's signature."""
        keys, values = self._normalize_push(key, value)
        for k, vlist in zip(keys, values):
            self._check_init(k)
            merged = self._merge(vlist, self._store[k].device)
            if self._updater is not None:
                self._updater(k, merged, self._store[k])
            else:
                self._store[k] = merged

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into every array of ``out``."""
        if out is None:
            raise ValueError("pull requires out=")
        keys, outs = self._normalize_push(key, out)
        for k, olist in zip(keys, outs):
            self._check_init(k)
            for o in olist:
                _write(o, self._store[k])
        return out

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        self.pull(key, out if out is not None else value, priority)

    def broadcast(self, key, value, out=None, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise NotImplementedError("row_sparse_pull waits for the sparse arrays (ROADMAP A14)")

    def set_updater(self, updater):
        """Install ``updater(key, pushed, stored)``, applied at each push."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` in the store, on a pickled copy (the reference
        pickles it to its servers)."""
        from . import optimizer as opt_mod

        self._optimizer = pickle.loads(pickle.dumps(optimizer))
        self._updater = opt_mod.get_updater(self._optimizer)

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError("gradient compression belongs to the distributed stores "
                                  "(ROADMAP A10)")

    def barrier(self):
        """Nothing to wait for in one process."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise RuntimeError("no updater or optimizer attached")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise RuntimeError("no updater or optimizer attached")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    # -- internals ---------------------------------------------------------------
    def _check_init(self, k):
        if k not in self._store:
            raise KeyError("key %s has not been initialized" % k)

    @staticmethod
    def _normalize(key, value):
        keys = _as_list(key)
        values = _as_list(value) if isinstance(key, (list, tuple)) else [value]
        if len(keys) != len(values):
            raise ValueError("%d keys for %d values" % (len(keys), len(values)))
        return [str(k) for k in keys], values

    @staticmethod
    def _normalize_push(key, value):
        """(keys, a list of values for each key): a flat list of values for
        one key are its replicas."""
        if isinstance(key, (list, tuple)):
            keys = [str(k) for k in key]
            vals = list(value)
            if len(vals) != len(keys):
                if len(vals) % len(keys):
                    raise ValueError("%d values for %d keys" % (len(vals), len(keys)))
                per = len(vals) // len(keys)
                return keys, [vals[i * per:(i + 1) * per] for i in range(len(keys))]
            return keys, [_as_list(v) for v in vals]
        return [str(key)], [_as_list(value)]

    @staticmethod
    def _merge(vlist, device):
        merged = _tensor(vlist[0]).to(device)
        for v in vlist[1:]:
            merged = merged + _tensor(v).to(device)
        return merged.clone() if len(vlist) == 1 else merged


def create(name="local"):
    """A store by type: ``local`` and ``device`` (one process); the
    distributed types raise (ROADMAP A10)."""
    if name in ("local", "device", "nccl", "dist_sync", "dist_device_sync", "dist_async"):
        return KVStore(name)
    raise ValueError("unknown KVStore type %r; expected one of ('local', 'device', 'nccl', "
                     "'dist_sync', 'dist_device_sync', 'dist_async')" % (name,))
