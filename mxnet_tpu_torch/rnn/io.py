"""Bucketing data iterator for sequences — the port of
``mxnet_tpu/rnn/io.py``'s ``BucketSentenceIter``.

All lengths are bucketed in one ``np.searchsorted`` and each bucket's
padded token matrix is built with one boolean-mask assignment; the epoch
order comes from a ``numpy.random.RandomState(seed)``, so the same
sentences and seed give the JAX package's batches exactly.  Batches are
host NDArrays; each bucket key selects its own unrolled graph in
``BucketingModule``.
"""
from __future__ import annotations

import logging

import numpy as np

from ..io import DataIter, DataBatch, DataDesc
from .. import ndarray as nd
from ..context import cpu

__all__ = ["BucketSentenceIter"]


def _auto_buckets(lengths, batch_size):
    """Pick bucket lengths: every distinct sentence length that occurs often
    enough to fill at least one batch becomes a bucket."""
    uniq, counts = np.unique(lengths, return_counts=True)
    chosen = uniq[counts >= batch_size].tolist()
    if not chosen:
        chosen = [int(uniq.max())]
    return chosen


def _pad_matrix(sentences, lengths, width, fill, dtype):
    """All sentences as one (n, width) matrix, tail-padded with ``fill``."""
    out = np.full((len(sentences), width), fill, dtype=dtype)
    mask = np.arange(width)[None, :] < lengths[:, None]
    out[mask] = np.concatenate([np.asarray(s, dtype=dtype)
                                for s in sentences]) if sentences else []
    return out


class BucketSentenceIter(DataIter):
    """Language-model iterator over variable-length token-id sequences.

    Sequences are assigned to the smallest bucket that fits (longer ones are
    dropped with a warning), padded with ``invalid_label``, and served as
    full batches whose ``bucket_key`` selects the matching unrolled graph.
    Labels are the inputs shifted one step left (next-token prediction).

    ``layout``: "NT" serves (batch, time); "TN" serves (time, batch).
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT", seed=None):
        super().__init__(batch_size)
        lengths = np.array([len(s) for s in sentences], dtype=np.int64)
        buckets = sorted(buckets) if buckets else _auto_buckets(lengths,
                                                                batch_size)

        # vectorized binning: smallest bucket >= length, out-of-range -> drop
        which = np.searchsorted(buckets, lengths, side="left")
        keep = which < len(buckets)
        if not keep.all():
            logging.warning(
                "BucketSentenceIter: dropping %d sequence(s) longer than the "
                "largest bucket (%d)", int((~keep).sum()), buckets[-1])

        self.buckets = list(buckets)
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.default_bucket_key = max(buckets)

        if layout == "NT":
            self._batch_major = True
        elif layout == "TN":
            self._batch_major = False
        else:
            raise ValueError("layout must be 'NT' (batch major) or 'TN' "
                             "(time major), got %r" % layout)

        # one padded matrix per bucket, built in bulk
        self._tokens = []
        for b, width in enumerate(buckets):
            rows = np.nonzero(keep & (which == b))[0]
            group = [sentences[i] for i in rows]
            self._tokens.append(
                _pad_matrix(group, lengths[rows], width, invalid_label,
                            dtype))

        self._order = None      # per-bucket row permutations
        self._schedule = None   # shuffled (bucket, row-window) pairs
        self._cursor = 0
        self._rng = np.random.RandomState(seed)  # seed pins epoch order
        self.reset()

        shape = ((batch_size, self.default_bucket_key) if self._batch_major
                 else (self.default_bucket_key, batch_size))
        self.provide_data = [DataDesc(data_name, shape)]
        self.provide_label = [DataDesc(label_name, shape)]

    # -- epoch machinery -----------------------------------------------------
    def reset(self):
        self._cursor = 0
        self._order = [self._rng.permutation(len(t)) for t in self._tokens]
        schedule = [(b, start)
                    for b, tokens in enumerate(self._tokens)
                    for start in range(0,
                                       len(tokens) - self.batch_size + 1,
                                       self.batch_size)]
        self._rng.shuffle(schedule)
        self._schedule = schedule

    def next(self):
        if self._cursor >= len(self._schedule):
            raise StopIteration
        b, start = self._schedule[self._cursor]
        self._cursor += 1

        rows = self._order[b][start:start + self.batch_size]
        tokens = self._tokens[b][rows]
        # next-token labels: shift left, pad the final step
        labels = np.concatenate(
            [tokens[:, 1:],
             np.full((len(tokens), 1), self.invalid_label,
                     dtype=tokens.dtype)], axis=1)
        if not self._batch_major:
            tokens = tokens.T
            labels = labels.T
        data = nd.array(tokens, ctx=cpu(), dtype=self.dtype)
        label = nd.array(labels, ctx=cpu(), dtype=self.dtype)
        return DataBatch([data], [label], pad=0,
                         bucket_key=self.buckets[b],
                         provide_data=[DataDesc(self.data_name, data.shape)],
                         provide_label=[DataDesc(self.label_name,
                                                 label.shape)])
