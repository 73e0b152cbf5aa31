"""Bucketed text IO (parity: mxnet_tpu/rnn/io.py; the reference's
python/mxnet/rnn/io.py — encode_sentences:30, BucketSentenceIter:84).
Batches lie on the current context, as ``io.NDArrayIter``'s do."""
from __future__ import annotations

import numpy as np

from ..io.io import DataIter, DataBatch
from ..ndarray.ndarray import array

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0):
    """Token lists -> id lists, growing `vocab` as new tokens appear."""
    if vocab is None:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    taken = set(vocab.values())
    encoded = []
    for sent in sentences:
        row = []
        for tok in sent:
            if tok not in vocab:
                while next_id in taken:
                    next_id += 1
                vocab[tok] = next_id
                taken.add(next_id)
            row.append(vocab[tok])
        encoded.append(row)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """Pad each sentence up to the smallest bucket that fits it; batches
    are drawn per bucket (reference BucketSentenceIter semantics, with
    label = input shifted by one)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", layout="NT", seed=0):
        super().__init__(batch_size)
        if buckets is None:
            lengths = sorted({len(s) for s in sentences})
            buckets = [l for l in lengths if l > 1]
        if not buckets:
            raise ValueError(
                "BucketSentenceIter: no usable buckets (every sentence "
                "is shorter than 2 tokens, or an empty bucket list was "
                "given)")
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.default_bucket_key = max(self.buckets)

        per_bucket = {b: [] for b in self.buckets}
        skipped = 0
        for s in sentences:
            fit = [b for b in self.buckets if b >= len(s)]
            if not fit:
                skipped += 1
                continue
            b = fit[0]
            row = np.full(b, invalid_label, np.float32)
            row[:len(s)] = s
            per_bucket[b].append(row)
        if skipped:
            import warnings

            warnings.warn("BucketSentenceIter: %d sentences longer than "
                          "the largest bucket were discarded" % skipped)
        self._data = {b: np.asarray(rows) for b, rows in
                      per_bucket.items() if rows}
        self._rng = np.random.RandomState(seed)
        self.reset()

    @property
    def provide_data(self):
        return [(self.data_name,
                 (self.batch_size, self.default_bucket_key))]

    @property
    def provide_label(self):
        return [(self.label_name,
                 (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self._plan = []
        for b, rows in self._data.items():
            idx = self._rng.permutation(len(rows))
            for i in range(0, len(rows) - self.batch_size + 1,
                           self.batch_size):
                self._plan.append((b, idx[i:i + self.batch_size]))
        self._rng.shuffle(self._plan)
        self._pos = 0

    def next(self):
        if self._pos >= len(self._plan):
            raise StopIteration
        b, idx = self._plan[self._pos]
        self._pos += 1
        rows = self._data[b][idx]
        label = np.full_like(rows, self.invalid_label)
        label[:, :-1] = rows[:, 1:]
        batch = DataBatch(data=[array(rows)], label=[array(label)])
        batch.bucket_key = b
        batch.provide_data = [(self.data_name, (self.batch_size, b))]
        batch.provide_label = [(self.label_name, (self.batch_size, b))]
        return batch
