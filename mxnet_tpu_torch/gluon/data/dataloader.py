"""DataLoader (parity: mxnet_tpu/gluon/data/dataloader.py,
python/mxnet/gluon/data/dataloader.py:464).

Batches are host arrays, as upstream's default batchify gives:
``default_batchify_fn`` stacks NDArray samples with ``torch.stack`` on
their own device (a dataset's images are host arrays) and makes numpy or
number samples into host arrays.  ``pin_memory=True`` pins each batch's
host tensors (upstream's ``cpu_pinned``) when a card is present, so that
its copy to the card can be asynchronous; ``device_prefetch=`` bridges
to ``io.DevicePrefetcher``, which stages the next batch onto the card
while the current step runs (``True`` or a depth: onto the current
context, ``gpu(0)``; a ``ShardedTrainer``: through its ``shard_batch``;
a callable: ``put(batch)``).

``num_workers > 0`` is a thread pool with ``prefetch`` batches in flight,
as in the JAX package: PIL's codec, numpy and torch release the GIL, so
decoding and augmentation scale with the workers; transforms in pure
Python serialize (upstream's worker processes would not).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...context import cpu
from ...ndarray.ndarray import NDArray, array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d._data for d in data]))
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    return array(np.asarray(data), ctx=cpu())


default_mp_batchify_fn = default_batchify_fn


def _pin(batch):
    """``batch`` with each host tensor in pinned memory."""
    if isinstance(batch, NDArray):
        t = batch._data
        return NDArray(t.pin_memory()) if t.device.type == "cpu" else batch
    if isinstance(batch, (list, tuple)):
        return type(batch)(_pin(b) for b in batch)
    return batch


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, pin_device_id=0,
                 prefetch=None, thread_pool=False, timeout=120,
                 device_prefetch=None):
        self._dataset = dataset
        # pinning needs a card's driver; without one there is nothing to
        # copy asynchronously to
        self._pin_memory = bool(pin_memory) and torch.cuda.is_available()
        self._timeout = timeout
        self._device_prefetch = device_prefetch

        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                if shuffle:
                    sampler = RandomSampler(len(dataset))
                else:
                    sampler = SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif (batch_size is not None or shuffle or sampler is not None or
              last_batch is not None):
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch or 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _batch(self, indices):
        batch = self._batchify_fn([self._dataset[i] for i in indices])
        return _pin(batch) if self._pin_memory else batch

    def __iter__(self):
        if self._num_workers == 0:
            it = (self._batch(batch) for batch in self._batch_sampler)
        else:
            it = _MultiWorkerIter(self)
        dp = self._device_prefetch
        if dp is None or dp is False or dp == 0:
            return it
        from ...io.prefetch import DevicePrefetcher

        if dp is True:
            kw = {}
        elif isinstance(dp, int):  # a depth (MXNET_DEVICE_PREFETCH's unit)
            kw = {"depth": dp}
        elif hasattr(dp, "shard_batch"):
            kw = {"trainer": dp}
        elif callable(dp):
            kw = {"put": dp}
        else:
            raise ValueError(
                "device_prefetch= accepts True, a depth int, a "
                "ShardedTrainer, or a put(batch) callable; got %r"
                % (dp,))

        def staged():
            # the prefetcher starts at the first next(), so an iterator
            # never advanced starts no thread; the finally stops it on
            # break, exception or collection
            pf = DevicePrefetcher(it, **kw)
            try:
                yield from pf
            finally:
                pf.close()

        return staged()

    def __len__(self):
        return len(self._batch_sampler)


class _MultiWorkerIter:
    """Thread-pool iterator with ``prefetch`` batches in flight."""

    def __init__(self, loader):
        self._loader = loader
        self._pool = ThreadPoolExecutor(max_workers=loader._num_workers)
        self._batches = iter(loader._batch_sampler)
        self._pending = []
        self._exhausted = False
        for _ in range(max(loader._prefetch, 1)):
            self._push_next()

    def _push_next(self):
        if self._exhausted:
            return
        try:
            indices = next(self._batches)
        except StopIteration:
            self._exhausted = True
            return
        self._pending.append(self._pool.submit(self._loader._batch, indices))

    def __iter__(self):
        return self

    def __next__(self):
        if not self._pending:
            self._pool.shutdown(wait=False)
            raise StopIteration
        fut = self._pending.pop(0)
        self._push_next()
        return fut.result(timeout=self._loader._timeout)

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
