"""Overlapped device prefetch: stage the next batch's host-to-card copy
while the current step computes (parity: mxnet_tpu/io/prefetch.py; the
reference's engine overlap plus ``io.PrefetchingIter``).

    loader = gluon.data.DataLoader(ds, batch_size=64, num_workers=2,
                                   pin_memory=True)
    with DevicePrefetcher(loader, trainer=trainer) as batches:
        for x, y in batches:
            trainer.step([x], y)

A background thread pulls from ``source`` and stages each batch
``depth`` batches ahead of the consumer.  On a card it pins each host
tensor that is not pinned yet and copies it with ``non_blocking=True``
on a side CUDA stream, then records an event; the consumer's stream
waits on that event before the batch is handed over (and each staged
tensor is marked as used on the consumer's stream, so the allocator
keeps it until the consumer is done).  That is what ``jax.device_put``
is, asynchronously.

``trainer=`` stages through ``ShardedTrainer.shard_batch`` (the
trainer's device), ``put=`` takes any callable, and the default copies
each element to ``ctx`` (default: the current context, ``gpu(0)``),
yielding the device tensors as the JAX package yields device arrays.
Depth comes from ``MXNET_DEVICE_PREFETCH``; 0 makes the wrapper a
passthrough that stages inline.  Batches flow through unchanged in
order and count: only their placement moves earlier.

A handoff that finds nothing staged is a stall: ``PREFETCH_STALLS``, a
``prefetch:stall`` trace instant, and the blocked wall time into
``PREFETCH_WAIT_SECONDS`` (the step breakdown's data_wait bucket) and
the goodput ledger's ``data_wait`` segment.
"""
from __future__ import annotations

import queue as _queue
import sys as _sys
import threading as _threading
import time as _time

import torch

from .. import telemetry as _telemetry
from .. import tracing as _tracing
from ..context import current_context
from ..ndarray.ndarray import NDArray

__all__ = ["DevicePrefetcher"]

_END = object()


def _tensors(obj):
    """The torch tensors inside a batch (nested lists and tuples)."""
    if isinstance(obj, NDArray):
        return [obj._data]
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []


def to_device(x, device):
    """``x`` (NDArray, tensor or numpy) as a tensor on ``device``: a host
    tensor bound for a card is pinned first, so that the
    ``non_blocking=True`` copy is asynchronous."""
    t = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
    if device.type == "cuda" and t.device.type == "cpu" \
            and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _copy_to(device):
    """put(batch): each element's tensor on ``device``."""
    def put(batch):
        if isinstance(batch, (tuple, list)):
            return type(batch)(to_device(x, device) for x in batch)
        return to_device(batch, device)

    return put


class DevicePrefetcher:
    """Iterate ``source``, staging each batch onto the device ``depth``
    batches ahead of the consumer on a background thread.  Exceptions of
    ``source`` or of the staging callable surface at the consumer's
    ``next()``, after every batch staged before them."""

    def __init__(self, source, put=None, trainer=None, depth=None, ctx=None):
        from .. import config as _config

        if depth is None:
            depth = _config.get("MXNET_DEVICE_PREFETCH")
        self._depth = max(0, int(depth))
        self._device = None
        if put is not None:
            self._put = put
            if ctx is not None:
                self._device = ctx.torch_device
        elif trainer is not None:
            # non-tuple batches are treated as a single array
            def put_via_trainer(batch):
                if isinstance(batch, (tuple, list)):
                    return type(batch)(trainer.shard_batch(*batch))
                return trainer.shard_batch(batch)[0]

            self._put = put_via_trainer
            self._device = trainer._device
        else:
            self._device = (ctx or current_context()).torch_device
            self._put = _copy_to(self._device)
        self._cuda = self._device is not None and self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) \
            if self._cuda and self._depth > 0 else None
        self._source = iter(source)
        self._q = None
        self._thread = None
        self._closed = False
        self._done = False
        if self._depth > 0:
            self._q = _queue.Queue(maxsize=self._depth)
            self._thread = _threading.Thread(
                target=self._run, name="mxnet_tpu_torch-device-prefetch",
                daemon=True)
            self._thread.start()

    # -- producer ---------------------------------------------------------
    def _stage(self, batch):
        """(staged batch, event the consumer's stream waits on or None)."""
        if self._stream is None:
            return self._put(batch), None
        with torch.cuda.stream(self._stream):
            staged = self._put(batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _run(self):
        try:
            for batch in self._source:
                self._q.put(("ok", self._stage(batch)))
                if self._closed:
                    return
        except BaseException as e:  # noqa: BLE001 - raised at next()
            self._q.put(("err", e))
        else:
            self._q.put((None, _END))

    # -- consumer ---------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._q is None:  # depth 0: passthrough, stage inline
            return self._put(next(self._source))
        if self._done:
            # the producer has ended (its end or error was delivered)
            raise StopIteration
        try:
            kind, item = self._q.get_nowait()
        except _queue.Empty:
            # the train loop beat the pipeline to the handoff: the input
            # path, not the card, bounds this step.  The blocked wall
            # time is the data_wait attribution bucket.
            tel = _telemetry.enabled()
            if tel:
                _telemetry.PREFETCH_STALLS.inc()
            _tracing.instant("prefetch:stall")
            gp = _sys.modules.get("mxnet_tpu_torch.goodput")
            gp_on = gp is not None and gp.active()
            t0 = _time.perf_counter() if (tel or gp_on) else None
            kind, item = self._q.get()
            if tel or gp_on:
                wait_s = _time.perf_counter() - t0
                if tel:
                    _telemetry.PREFETCH_WAIT_SECONDS.observe(wait_s)
                if gp_on:
                    gp.record_segment("data_wait", wait_s)
        if kind == "err":
            self._done = True
            raise item
        if item is _END:
            self._done = True
            raise StopIteration
        staged, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _tensors(staged):
                if t.is_cuda:
                    t.record_stream(stream)
        return staged

    def close(self):
        """Stop the producer and drop the staged batches.  The producer
        checks ``_closed`` after each handoff, so draining the queue
        frees it at most one batch later."""
        self._closed = True
        self._done = True
        if self._q is not None:
            for _ in range(self._depth + 2):
                try:
                    while True:
                        self._q.get_nowait()
                except _queue.Empty:
                    pass
                if self._thread is None or not self._thread.is_alive():
                    break
                self._thread.join(timeout=0.05)
        self._source = iter(())

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
