"""Bucketed sequence input (counterpart of ``mxnet_tpu/rnn/io.py``;
reference python/mxnet/rnn/io.py): ``encode_sentences`` and
``BucketSentenceIter``.

The iterator keeps one padded matrix per bucket and emits fixed-shape
batches tagged with their bucket length, each of which the bucketing module
binds once.  It shuffles with numpy's and Python's global generators, as
the JAX package's iterator does: seeded alike, the two give the same
batches.
"""
from __future__ import annotations

import logging
import random as pyrandom

import numpy as np

import torch

from ..io import DataBatch, DataDesc, DataIter

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1, invalid_key="\n",
                     start_label=0):
    """Map token sequences to integer-id sequences.

    With ``vocab=None`` a fresh vocabulary is grown on the fly: ids are
    handed out in first-seen order starting at ``start_label``, and the id
    reserved for padding (``invalid_label``, bound to ``invalid_key``) is
    never assigned to a real token.  With an explicit ``vocab`` the mapping
    is closed: unseen tokens are an error.

    Returns ``(encoded, vocab)``.
    """
    if vocab is not None:
        # Closed vocabulary: pure lookup, loud failure on novel tokens.
        def lookup(tok):
            assert tok in vocab, "Unknown token %s" % tok
            return vocab[tok]
    else:
        vocab = {invalid_key: invalid_label}
        counter = [start_label]

        def lookup(tok):
            known = vocab.get(tok)
            if known is not None and (known != invalid_label or tok == invalid_key):
                return known
            nxt = counter[0]
            if nxt == invalid_label:   # padding id stays reserved
                nxt += 1
            counter[0] = nxt + 1
            vocab[tok] = nxt
            return nxt

    encoded = [[lookup(tok) for tok in sent] for sent in sentences]
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Fixed-shape batches over variable-length sequences via bucketing.

    Each bucket length gets one executor downstream (the reference's
    per-bucket executor), so the iterator groups sentences by the smallest
    bucket that fits, pads each group into one dense ``(n_sent,
    bucket_len)`` matrix, and emits ``batch_size``-row slices tagged with
    ``bucket_key``.  Labels are the next-token shift of the data, made at
    fetch time.  The batches are CPU tensors.
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            buckets = self._auto_buckets(sentences, batch_size)
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.layout = layout
        self.major_axis = layout.find("N")
        self.default_bucket_key = max(self.buckets)

        self.data = self._pack(sentences)
        self._schedule = []          # [(bucket_idx, start_row)] for one epoch
        self._cursor = 0

        full_shape = (batch_size, self.default_bucket_key)
        if self.major_axis != 0:
            full_shape = full_shape[::-1]
        self.provide_data = [DataDesc(data_name, full_shape, getattr(torch, dtype),
                                      layout=layout)]
        self.provide_label = [DataDesc(label_name, full_shape, getattr(torch, dtype),
                                       layout=layout)]
        self.reset()

    @staticmethod
    def _auto_buckets(sentences, batch_size):
        """One bucket per sentence length that occurs >= batch_size times."""
        freq = {}
        for sent in sentences:
            freq[len(sent)] = freq.get(len(sent), 0) + 1
        chosen = [n for n, c in sorted(freq.items()) if c >= batch_size]
        assert chosen, "no bucket holds >= batch_size sentences; pass buckets="
        return chosen

    def _pack(self, sentences):
        """Group sentences into dense padded matrices, one per bucket."""
        groups = [[] for _ in self.buckets]
        dropped = 0
        for sent in sentences:
            dest = None
            for k, blen in enumerate(self.buckets):
                if len(sent) <= blen:
                    dest = k
                    break
            if dest is None:
                dropped += 1
                continue
            groups[dest].append(sent)
        if dropped:
            logging.getLogger(__name__).warning(
                "BucketSentenceIter: dropped %d sentences longer than the "
                "largest bucket (%d)", dropped, self.buckets[-1])
        packed = []
        for blen, group in zip(self.buckets, groups):
            mat = np.full((len(group), blen), self.invalid_label, dtype=self.dtype)
            for row, sent in enumerate(group):
                mat[row, : len(sent)] = sent
            packed.append(mat)
        return packed

    def reset(self):
        """Reshuffle rows within buckets and the batch visitation order."""
        self._cursor = 0
        for k, mat in enumerate(self.data):
            self.data[k] = mat[np.random.permutation(len(mat))]
        self._schedule = [
            (k, start)
            for k, mat in enumerate(self.data)
            for start in range(0, len(mat) - self.batch_size + 1, self.batch_size)
        ]
        pyrandom.shuffle(self._schedule)

    def __next__(self):
        return self.next()

    def next(self):
        if self._cursor >= len(self._schedule):
            raise StopIteration
        k, start = self._schedule[self._cursor]
        self._cursor += 1
        rows = self.data[k][start : start + self.batch_size]
        # next-token target: shift left, pad the final step
        tail = np.full((rows.shape[0], 1), self.invalid_label, dtype=rows.dtype)
        labels = np.concatenate([rows[:, 1:], tail], axis=1)
        if self.major_axis != 0:   # time-major layout
            rows, labels = rows.T, labels.T
        return DataBatch(
            [torch.from_numpy(np.ascontiguousarray(rows))],
            [torch.from_numpy(np.ascontiguousarray(labels))],
            pad=0,
            bucket_key=self.buckets[k],
            provide_data=[DataDesc(self.data_name, rows.shape, getattr(torch, self.dtype),
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, labels.shape, getattr(torch, self.dtype),
                                    layout=self.layout)],
        )
