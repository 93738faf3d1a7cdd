"""Shape-bucket ladder — the pure shape math under the micro-batcher
(counterpart of ``mxnet_tpu/serving/bucketing.py``).

Every distinct input shape is a new bind and plan build of the Predictor,
so an online engine that forwarded raw request shapes would rebuild per
traffic pattern.  A finite **bucket ladder** fixes that: each request is
padded UP to the nearest configured bucket on the batch dim (and
optionally on per-sample dims), so the whole traffic mix resolves to
``len(ladder)`` signatures, all built at startup (``serving.warmup``).

This module is policy-free shape arithmetic: no threads, no torch, no env
vars — the Engine owns those.
"""
from __future__ import annotations

import itertools

__all__ = ["Bucket", "BucketLadder", "pow2_ladder"]


def pow2_ladder(max_value, start=1):
    """Powers of two from ``start`` up to and including ``max_value``
    (``max_value`` itself is appended when it is not a power of two):
    ``pow2_ladder(12) -> (1, 2, 4, 8, 12)``."""
    if max_value < 1:
        raise ValueError("max_value must be >= 1, got %r" % (max_value,))
    out = []
    v = max(1, int(start))
    while v < max_value:
        out.append(v)
        v *= 2
    out.append(int(max_value))
    return tuple(out)


class Bucket:
    """One served signature: a batch capacity + per-input padded sample
    shapes (sample shape = the request array shape WITHOUT the leading
    sample-count dim).  Hashable — the signature-cache key."""

    __slots__ = ("batch", "shapes", "direct")

    def __init__(self, batch, shapes, direct=False):
        self.batch = int(batch)
        # canonical order so dict-ordering differences can't split the cache
        self.shapes = tuple(sorted(
            (str(n), tuple(int(d) for d in s)) for n, s in dict(shapes).items()))
        self.direct = bool(direct)

    @property
    def key(self):
        return (self.batch, self.shapes)

    def input_shapes(self):
        """name -> full input shape (batch dim included) for Predictor."""
        return {n: (self.batch,) + s for n, s in self.shapes}

    def sample_shape(self, name):
        return dict(self.shapes)[name]

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, Bucket) and self.key == other.key

    def __repr__(self):
        dims = ",".join("%s=%s" % (n, "x".join(map(str, s)) or "scalar")
                        for n, s in self.shapes)
        return "b%d[%s]%s" % (self.batch, dims,
                              ":direct" if self.direct else "")


class BucketLadder:
    """The configured bucket set.

    Parameters
    ----------
    batch_sizes : sequence of int
        Allowed batch capacities, e.g. ``(1, 2, 4, 8)``.  A formed batch of
        n samples is zero-padded up to the smallest capacity >= n.
    shape_buckets : dict, optional
        ``input name -> sequence of candidate per-sample shapes``.  A request
        sample shape is padded (zeros, trailing) up to the smallest candidate
        that dominates it in every dim.  Inputs without an entry admit only
        their exact base sample shape — one spatial class, zero padding.
    """

    def __init__(self, batch_sizes=(1, 2, 4, 8), shape_buckets=None):
        sizes = sorted({int(b) for b in batch_sizes})
        if not sizes or sizes[0] < 1:
            raise ValueError("batch_sizes must be positive ints, got %r"
                             % (batch_sizes,))
        self.batch_sizes = tuple(sizes)
        self.shape_buckets = {}
        for name, cands in (shape_buckets or {}).items():
            cands = [tuple(int(d) for d in s) for s in cands]
            if not cands:
                raise ValueError("empty shape bucket list for %r" % name)
            ndims = {len(s) for s in cands}
            if len(ndims) != 1:
                raise ValueError(
                    "shape buckets for %r mix ranks: %s" % (name, cands))
            # sorted by volume so "smallest dominating" is a forward scan
            self.shape_buckets[name] = tuple(sorted(
                set(cands), key=lambda s: (_volume(s), s)))

    @property
    def max_batch(self):
        return self.batch_sizes[-1]

    def pad_batch(self, n):
        """Smallest configured capacity >= n; None when n exceeds the top
        bucket (the caller direct-dispatches)."""
        for b in self.batch_sizes:
            if b >= n:
                return b
        return None

    def pad_shape(self, name, shape, base_shape):
        """Padded per-sample shape for one input; None = no bucket fits
        (direct dispatch).  ``base_shape`` is the engine's declared sample
        shape, the only admissible class for un-bucketed inputs."""
        shape = tuple(int(d) for d in shape)
        cands = self.shape_buckets.get(name)
        if cands is None:
            return shape if shape == tuple(base_shape) else None
        for cand in cands:
            if len(cand) == len(shape) and all(
                    c >= d for c, d in zip(cand, shape)):
                return cand
        return None

    def bucket_for(self, sample_shapes, n):
        """The ladder bucket holding ``n`` samples of the given (already
        padded) per-sample shapes; None when n exceeds the top batch."""
        b = self.pad_batch(n)
        if b is None:
            return None
        return Bucket(b, sample_shapes)

    def signatures(self, base_sample_shapes):
        """Every signature this ladder can produce — the warmup set, and
        the exact per-stream compile count of an Engine.  Cartesian product of batch sizes x per-input shape
        candidates (un-bucketed inputs contribute their single base shape)."""
        names = sorted(base_sample_shapes)
        per_input = []
        for n in names:
            cands = self.shape_buckets.get(n)
            per_input.append(cands if cands is not None
                             else (tuple(base_sample_shapes[n]),))
        out = []
        for b in self.batch_sizes:
            for combo in itertools.product(*per_input):
                out.append(Bucket(b, dict(zip(names, combo))))
        return out


def _volume(shape):
    v = 1
    for d in shape:
        v *= int(d)
    return v
