"""Dependency-engine facade over CUDA streams (parity: mxnet_tpu/engine.py,
include/mxnet/engine.h Engine::WaitForVar/WaitForAll, src/engine/).

torch orders a device's work on its CUDA stream, as the reference's
engine ordered it by its variables' queues, and returns to the host
before the work is done.  What remains is the control surface:

- ``wait_for_var(tensor)`` synchronizes the tensor's CUDA stream (a host
  tensor is ready already);
- ``wait_for_all()`` synchronizes every visible card;
- ``MXNET_ENGINE_TYPE=NaiveEngine`` (or ``set_engine_type``) makes
  ``ndarray._invoke_nd`` synchronize after every op, the race-free
  oracle of the reference;
- an exception recorded by ``record_exception`` re-raises at the next
  wait, as the reference's deferred exceptions do;
- ``set_bulk_size`` and ``bulk`` are accepted and change nothing.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Engine", "get", "set_bulk_size", "bulk"]


class Engine:
    """The process's engine facade (``Engine.get()``)."""

    _inst = None
    _lock = threading.Lock()

    def __init__(self):
        from . import config as _config

        self._engine_type = _config.get("MXNET_ENGINE_TYPE")
        self.is_naive = self._engine_type == "NaiveEngine"
        self._bulk_size = 0
        self._deferred_exc = []
        self._exc_lock = threading.Lock()

    @staticmethod
    def get():
        inst = Engine._inst
        if inst is None:  # the lock only until the first call has made it
            with Engine._lock:
                if Engine._inst is None:
                    Engine._inst = Engine()
                inst = Engine._inst
        return inst

    @property
    def engine_type(self):
        return self._engine_type

    def set_engine_type(self, name):
        self._engine_type = name
        self.is_naive = name == "NaiveEngine"

    # -- sync points ----------------------------------------------------------
    @staticmethod
    def sync(device):
        """Wait for the work queued on ``device``'s current stream."""
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()

    def wait_for_var(self, data):
        """Wait until ``data`` (a tensor) is computed, re-raising a
        deferred exception (parity: Engine::WaitForVar)."""
        self._rethrow()
        self.sync(data.device)
        self._rethrow()
        return data

    def wait_for_all(self):
        """Synchronize every visible card (parity: Engine::WaitForAll)."""
        self._rethrow()
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        self._rethrow()

    # -- deferred exceptions --------------------------------------------------
    def record_exception(self, exc):
        with self._exc_lock:
            self._deferred_exc.append(exc)

    def _rethrow(self):
        with self._exc_lock:
            if self._deferred_exc:
                raise self._deferred_exc.pop(0)

    # -- bulking (accepted; torch issues each op as it comes) -----------------
    def set_bulk_size(self, size):
        prev, self._bulk_size = self._bulk_size, size
        return prev

    @property
    def bulk_size(self):
        return self._bulk_size


def get():
    return Engine.get()


def set_bulk_size(size):
    """Parity: mx.engine.set_bulk_size."""
    return Engine.get().set_bulk_size(size)


class bulk:
    """``with mx.engine.bulk(size):``, a scope that changes nothing."""

    def __init__(self, size):
        self._size = size
        self._old = 0

    def __enter__(self):
        self._old = Engine.get().set_bulk_size(self._size)

    def __exit__(self, *args):
        Engine.get().set_bulk_size(self._old)
