"""Typed serving errors and the request future (parity:
mxnet_tpu/serving_async.py:107-229).

The decode tier (``generate.TokenServer``) degrades through these: a
client tells a full queue (:class:`Overloaded`, HTTP 429) from an
expired deadline (:class:`DeadlineExceeded`, 504) without parsing
messages.  ``AsyncPredictor`` and ``BurnRateShedder`` are not ported
yet.
"""
from __future__ import annotations

import threading
import time

__all__ = ["ServingFuture", "ServingError", "Overloaded",
           "DeadlineExceeded", "Cancelled", "ReplicaFailed"]


class ServingError(RuntimeError):
    """Base of every typed serving failure."""


class Overloaded(ServingError):
    """Request rejected at admission.  ``reason`` is one of ``queue``
    (queue full), ``inflight`` (in-flight cap), ``wait`` (estimated wait
    exceeds the SLO/deadline budget), ``slo`` (burn-rate shedding),
    ``unhealthy`` (no healthy replica), ``shutdown`` (closed), or — from
    the decode tier — ``slots`` (every KV-cache lane busy).  Retryable by
    the client after backoff (HTTP mapping: 429)."""

    def __init__(self, reason, detail=""):
        super().__init__("overloaded (%s)%s"
                         % (reason, ": " + detail if detail else ""))
        self.reason = reason


class DeadlineExceeded(ServingError):
    """Request failed by its deadline.  ``stage`` says where: the decode
    tier tags ``prefill`` (expired waiting for, or during, prompt
    prefill) and ``decode`` (expired mid-generation; the slot is
    evicted); the predict tier's ``queue``, ``pickup``, ``dispatch`` and
    ``completion`` arrive with ``AsyncPredictor``."""

    def __init__(self, stage, detail=""):
        super().__init__("deadline exceeded (%s)%s"
                         % (stage, ": " + detail if detail else ""))
        self.stage = stage


class Cancelled(ServingError):
    """Request retracted — by :meth:`ServingFuture.cancel` or by a
    non-drained shutdown."""


class ReplicaFailed(ServingError):
    """The serving replica failed the request (a dispatch raised)."""

    def __init__(self, msg, cause=None):
        super().__init__(msg)
        self.cause = cause


class ServingFuture:
    """Resolution handle for one submitted request.

    Thread-safe, first-writer-wins: the worker, a deadline and
    :meth:`cancel` may race to resolve it; exactly one outcome sticks.
    """

    __slots__ = ("_ev", "_lock", "_result", "_exc", "_owner", "_req",
                 "resolved_at")

    def __init__(self, owner=None, req=None):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._exc = None
        self._owner = owner
        self._req = req
        self.resolved_at = None     # monotonic resolution time

    def _resolve(self, result=None, exc=None):
        """First writer wins; returns whether this call resolved it."""
        with self._lock:
            if self._ev.is_set():
                return False
            self._result = result
            self._exc = exc
            self.resolved_at = time.monotonic()
            self._ev.set()
            # a caller holding futures must not keep every request
            # payload alive after resolution
            self._owner = None
            self._req = None
            return True

    def done(self):
        return self._ev.is_set()

    def cancelled(self):
        return self._ev.is_set() and isinstance(self._exc, Cancelled)

    def cancel(self):
        """Retract the request: dequeued if still waiting, evicted at the
        next tick if running.  Returns False when it already resolved."""
        owner, req = self._owner, self._req
        if owner is None or req is None:
            return self._resolve(exc=Cancelled("request cancelled"))
        return owner._cancel(req)

    def result(self, timeout=None):
        """Block for the outcome; raises the typed serving error on
        failure, ``TimeoutError`` if ``timeout`` elapses first."""
        if not self._ev.wait(timeout):
            raise TimeoutError("request not resolved within %r s"
                               % (timeout,))
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request not resolved within %r s"
                               % (timeout,))
        return self._exc
