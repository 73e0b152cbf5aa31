"""Samplers (parity: mxnet_tpu/gluon/data/sampler.py,
python/mxnet/gluon/data/sampler.py).

Index streams for DataLoader: a Sampler yields element indices, a
BatchSampler groups any sampler's stream into lists.  Chunking is done
with one shared generator (`_chunks`) parameterized by the last-batch
policy rather than per-policy loops.
"""
from __future__ import annotations

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]

_POLICIES = ("keep", "discard", "rollover")


def _check_policy(last_batch):
    if last_batch not in _POLICIES:
        raise ValueError("last_batch must be one of %s, got %r"
                         % (", ".join(_POLICIES), last_batch))


class Sampler:
    """Iterable over dataset indices."""

    def __iter__(self):
        raise NotImplementedError("Sampler subclasses define __iter__")

    def __len__(self):
        raise NotImplementedError("Sampler subclasses define __len__")


class SequentialSampler(Sampler):
    """0, 1, ..., length-1 in order."""

    def __init__(self, length):
        self._n = int(length)

    def __iter__(self):
        yield from range(self._n)

    def __len__(self):
        return self._n


class RandomSampler(Sampler):
    """A fresh permutation of range(length) per epoch."""

    def __init__(self, length):
        self._n = int(length)

    def __iter__(self):
        yield from np.random.permutation(self._n).tolist()

    def __len__(self):
        return self._n


class BatchSampler(Sampler):
    """Group a sampler's stream into batch_size-long lists.

    last_batch: 'keep' emits the final partial batch, 'discard' drops
    it, 'rollover' carries it into the next epoch's first batch.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        _check_policy(last_batch)
        self._sampler = sampler
        self._size = int(batch_size)
        self._policy = last_batch
        self._carry = []

    def __iter__(self):
        buf = self._carry
        self._carry = []
        for idx in self._sampler:
            buf.append(idx)
            if len(buf) == self._size:
                yield buf
                buf = []
        if not buf:
            return
        if self._policy == "keep":
            yield buf
        elif self._policy == "rollover":
            self._carry = buf
        # 'discard': drop the remainder

    def __len__(self):
        n = len(self._sampler)
        if self._policy == "keep":
            return -(-n // self._size)          # ceil
        if self._policy == "discard":
            return n // self._size
        return (n + len(self._carry)) // self._size   # rollover
