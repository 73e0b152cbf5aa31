"""Wide-event request observability: one structured record per unit of
work (counterpart of mxnet_tpu/events.py).

The telemetry registry answers "what is the aggregate" and the
perf ledger "where did the step's milliseconds go" — but a tail
observation in a histogram is anonymous: nobody can answer "why was
*this* request slow".  This module is the per-request evidence layer:
every unit of work — serving request, TokenServer generation, train-step
window, checkpoint save/load, AOT compile/load — emits ONE wide event, a
single JSONL record carrying

* the root ``tracing.TRACE_ID`` plus the request's span id (so the
  event joins the span tree and the ``/metrics`` exemplars),
* a **typed outcome** — ``ok`` / ``shed`` (+``reason``) / ``deadline``
  (+``stage``) / ``evicted`` (+``reason``) / ``error`` (+``error_kind``)
  — mirroring the serving_async error taxonomy,
* the per-stage latency split (``stages_s``: queue / prefill / decode /
  dispatch ...) and kind-specific payload fields (rows, tokens, step),
* the ``perf_ledger`` provenance fields (git sha, backend,
  device kind/count, mesh, dtype policy ...), resolved once per process,
* the rank provenance (``proc_id``/``n_procs`` from the
  ``MXNET_DIST_PROC_ID``/``MXNET_DIST_NUM_PROCS`` identity, ``0/1``
  single-process) so merged
  per-rank streams slice by rank (``events_query.py --by rank``).

**Sampling** is head+tail: non-``ok`` outcomes (sheds, deadline
exceeded, evictions, errors) are ALWAYS kept — degradation evidence
must never be sampled away — and so is any event slower than the
current per-kind tail threshold (the slowest ``TAIL_FRACTION`` of the
recent window); ``ok`` traffic below the tail is kept with probability
``MXNET_EVENTS_SAMPLE``.

**Writing** is a bounded background writer: kept events append to an
in-memory ring (``recent()`` — the ``/requestz`` endpoint and the
flight-recorder bundle read it) and, when ``MXNET_EVENTS_PATH`` names a
file, enqueue onto a bounded queue drained by a daemon thread with one
``O_APPEND`` write per batch.  A full queue drops the event and counts
the drop (``stats()`` + ``mxnet_tpu_events_dropped_total``) — the event
layer may lose evidence under pressure, it may never block serving.

Everything is OFF by default (``MXNET_EVENTS=1`` /
:func:`enable`); a disabled process pays one flag check per call site.
Query the stream with ``tools/events_query.py`` (p50/p99/p999 by
outcome/stage/kind, top-K slowest with trace ids, ``--join`` against a
chrome trace).  See docs/observability.md "Wide events & introspection".

Import-light by design (stdlib + ``config`` + ``telemetry``):
``tracing`` and ``perf_ledger`` are imported lazily inside functions.
"""
from __future__ import annotations

import collections
import json
import os
import random
import threading
import time

from . import config as _config
from . import telemetry as _telemetry

__all__ = ["enabled", "enable", "disable", "emit", "recent", "stats",
           "flush", "reset", "read_events", "writer_path",
           "RING_SIZE", "QUEUE_MAX", "TAIL_FRACTION", "OUTCOMES",
           "KINDS"]

_enabled = False
_sample = 1.0
_path = None

# the typed outcome vocabulary (mirrors the serving_async taxonomy);
# emit() rejects anything else so the stream stays queryable
OUTCOMES = ("ok", "shed", "deadline", "evicted", "error")

# known unit-of-work kinds (documentation + events_query default order;
# emit() accepts others so downstream layers can add units of work)
KINDS = ("gateway_request", "serving_request", "token_request",
         "train_step", "checkpoint_save", "checkpoint_load", "aot_load",
         "aot_compile")

RING_SIZE = 512          # /requestz + flight-recorder window
QUEUE_MAX = 4096         # bounded writer queue (past it: drop + count)
TAIL_FRACTION = 0.01     # always keep the slowest 1% per kind
_TAIL_WINDOW = 512       # recent durations per kind the threshold is
_TAIL_MIN = 64           # .. computed over (no tail-keep before this)

_lock = threading.Lock()
_write_lock = threading.Lock()   # serializes pop+write batches
_ring = collections.deque(maxlen=RING_SIZE)
_queue = collections.deque()
_writer = None
_writer_wake = threading.Event()
_stats = {"emitted": 0, "sampled_out": 0, "dropped": 0, "written": 0}
_tails = {}              # kind -> _Tail
_prov_cache = None
_proc_cache = None


def enabled():
    """Whether wide-event emission is on (one branch per call site)."""
    return _enabled


def enable(path=None, sample=None):
    """Turn emission on.  ``path`` overrides ``MXNET_EVENTS_PATH``
    ('' = ring only, nothing persists); ``sample`` overrides
    ``MXNET_EVENTS_SAMPLE`` (the keep probability for ok-outcome
    traffic below the tail threshold)."""
    global _enabled, _sample, _path
    if path is not None:
        _path = os.fspath(path) or None
    elif _path is None:
        _path = _config.get("MXNET_EVENTS_PATH") or None
    if sample is not None:
        _sample = min(1.0, max(0.0, float(sample)))
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def writer_path():
    """The JSONL path events are written to, or None (ring only)."""
    return _path


def reset():
    """Clear the ring, queue, tail state, and counters — test hook.
    The configured path/sample and the writer thread survive."""
    global _proc_cache
    with _lock:
        _ring.clear()
        _queue.clear()
        _tails.clear()
        for k in _stats:
            _stats[k] = 0
        _proc_cache = None


class _Tail:
    """Per-kind tail-latency keeper: tracks the recent duration window
    and keeps anything at or above the ``1 - TAIL_FRACTION`` quantile.
    The threshold is recomputed every 32 observations (a sort of 512
    floats), so the hot path is an append + one compare."""

    __slots__ = ("window", "threshold", "_since")

    def __init__(self):
        self.window = collections.deque(maxlen=_TAIL_WINDOW)
        self.threshold = None
        self._since = 0

    def keep(self, dur):
        self.window.append(dur)
        self._since += 1
        if self.threshold is None or self._since >= 32:
            self._since = 0
            if len(self.window) >= _TAIL_MIN:
                srt = sorted(self.window)
                idx = int(len(srt) * (1.0 - TAIL_FRACTION))
                self.threshold = srt[min(idx, len(srt) - 1)]
        # strictly greater: under a uniform latency distribution the
        # p99 equals the common value and >= would tail-keep everything
        return self.threshold is not None and dur > self.threshold


def _provenance():
    """The perf_ledger provenance dict, resolved once per process
    (environment identity does not change mid-run)."""
    global _prov_cache
    if _prov_cache is None:
        try:
            from . import perf_ledger as _pl

            _prov_cache = _pl.provenance()
        except Exception:
            _prov_cache = {"error": "provenance unavailable"}
    return _prov_cache


def _proc_identity():
    """(proc_id, n_procs) from the distributed env, resolved once per
    process (``0/1`` single-process) — the rank provenance every wide
    event carries so ``events_query.py --by rank`` can split a pod's
    merged JSONL streams.  ``reset()`` clears the cache (test hook)."""
    global _proc_cache
    if _proc_cache is None:
        try:
            pid = int(os.environ.get("MXNET_DIST_PROC_ID", "-1"))
        except ValueError:
            pid = -1
        try:
            n = int(os.environ.get("MXNET_DIST_NUM_PROCS", "0"))
        except ValueError:
            n = 0
        _proc_cache = ((pid if pid >= 0 else 0), (n if n > 1 else 1))
    return _proc_cache


def emit(kind, outcome="ok", dur_s=None, stages_s=None, trace_id=None,
         span_id=None, **fields):
    """Record one wide event (the sampling decision happens here).

    Returns the event dict when it was kept, None when emission is off
    or the event was sampled out.  ``span_id`` defaults to the current
    open span (or a fresh request id when tracing is off);
    ``trace_id`` to the process ``tracing.TRACE_ID``.  Extra ``fields``
    land at the top level (``reason`` / ``stage`` / ``error_kind`` are
    the outcome qualifiers by convention).
    """
    if not _enabled:
        return None
    if outcome not in OUTCOMES:
        raise ValueError("outcome %r not in %r" % (outcome, OUTCOMES))
    dur = float(dur_s) if dur_s is not None else None
    keep = outcome != "ok"
    if not keep and dur is not None:
        with _lock:
            tail = _tails.get(kind)
            if tail is None:
                tail = _tails[kind] = _Tail()
            keep = tail.keep(dur)
    if not keep:
        keep = _sample >= 1.0 or random.random() < _sample
    if not keep:
        with _lock:
            _stats["sampled_out"] += 1
        _telemetry.EVENTS_SAMPLED_OUT.inc()
        return None

    from . import tracing as _tracing

    if trace_id is None:
        trace_id = _tracing.TRACE_ID
    if span_id is None:
        sp = _tracing.current_span()
        span_id = sp.span_id if sp is not None \
            else _tracing.new_request_id()
    proc_id, n_procs = _proc_identity()
    ev = {"kind": str(kind), "time": round(time.time(), 6),
          "trace_id": trace_id, "span_id": span_id, "outcome": outcome,
          "proc_id": proc_id, "n_procs": n_procs}
    if dur is not None:
        ev["dur_s"] = round(dur, 6)
    if stages_s:
        ev["stages_s"] = {str(k): round(float(v), 6)
                          for k, v in stages_s.items() if v is not None}
    for k, v in fields.items():
        if v is not None:
            ev[k] = v
    ev["provenance"] = _provenance()
    _telemetry.EVENTS_EMITTED.inc(kind=str(kind))
    with _lock:
        _stats["emitted"] += 1
        _ring.append(ev)
        if _path is not None:
            if len(_queue) >= QUEUE_MAX:
                _stats["dropped"] += 1
                _telemetry.EVENTS_DROPPED.inc()
            else:
                _queue.append(ev)
                _ensure_writer_locked()
    _writer_wake.set()
    return ev


def recent(n=None):
    """The last ``n`` kept events (newest last; default: the whole
    ring) — the ``/requestz`` payload and the flight-recorder window."""
    with _lock:
        out = list(_ring)
    return out if n is None else out[-int(n):]


def stats():
    """Writer/drop accounting: emitted, sampled_out, dropped, written,
    queue depth, ring size, enabled/path."""
    with _lock:
        out = dict(_stats)
        out["queue"] = len(_queue)
        out["ring"] = len(_ring)
    out["enabled"] = _enabled
    out["path"] = _path
    out["sample"] = _sample
    return out


# ---------------------------------------------------------------------------
# the bounded background writer
# ---------------------------------------------------------------------------

_atexit_registered = False


def _ensure_writer_locked():
    global _writer, _atexit_registered
    if _writer is None or not _writer.is_alive():
        _writer = threading.Thread(target=_writer_loop,
                                   name="events-writer", daemon=True)
        _writer.start()
    if not _atexit_registered:
        # flush-on-exit: the writer is a daemon thread, so a
        # short-lived CLI run (bench tools, prewarm) can exit with a
        # tail batch still queued — drain it synchronously at
        # interpreter shutdown.  What a FULL queue already dropped
        # stays dropped (and counted): atexit recovers the tail, not
        # the backpressure losses.
        import atexit

        atexit.register(_drain_once, True)
        _atexit_registered = True


def _writer_loop():
    while True:
        _writer_wake.wait(0.25)
        _writer_wake.clear()
        _drain_once()


def _drain_once(fsync=False):
    """Pop everything queued and append it with ONE O_APPEND write
    (concurrent emitters from other processes interleave at line
    granularity).  The pop and the write happen under one batch lock,
    so a :func:`flush` that acquires it afterwards knows every prior
    batch is on disk.  A failed write re-counts the batch as dropped —
    the writer must never raise into or block the request path."""
    with _write_lock:
        with _lock:
            batch = list(_queue)
            _queue.clear()
            path = _path
        if not batch or path is None:
            if fsync and path is not None and os.path.exists(path):
                try:
                    fd = os.open(path, os.O_WRONLY)
                    try:
                        os.fsync(fd)
                    finally:
                        os.close(fd)
                except OSError:
                    pass
            return 0
        try:
            lines = "".join(
                json.dumps(ev, sort_keys=True, default=str) + "\n"
                for ev in batch)
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                         0o644)
            try:
                os.write(fd, lines.encode("utf-8"))
                if fsync:
                    os.fsync(fd)
            finally:
                os.close(fd)
        except Exception:
            with _lock:
                _stats["dropped"] += len(batch)
            _telemetry.EVENTS_DROPPED.inc(len(batch))
            return 0
    with _lock:
        _stats["written"] += len(batch)
    _telemetry.EVENTS_WRITTEN.inc(len(batch))
    return len(batch)


def flush():
    """Block until everything queued so far is on disk (fsync'd) —
    an in-flight writer batch completes first (the batch lock), then
    the remainder drains synchronously.  Returns the total written
    count over the process lifetime (``stats()['written']``)."""
    _drain_once(fsync=True)
    with _lock:
        return _stats["written"]


def read_events(path):
    """Parse an events JSONL file -> (events, problems).  Unparsable
    lines become ``(lineno, message)`` problems, never exceptions — a
    torn tail line must not hide the run."""
    events, problems = [], []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError as e:
                problems.append((i, "unparsable JSON (%s)" % e))
                continue
            if not isinstance(ev, dict) or "kind" not in ev:
                problems.append((i, "not an event object"))
                continue
            events.append(ev)
    return events, problems


# ---------------------------------------------------------------------------
# /statusz subsystem view
# ---------------------------------------------------------------------------

def _statusz():
    return stats()


_telemetry.register_status_provider("events", _statusz)


try:
    _sample = min(1.0, max(0.0, _config.get("MXNET_EVENTS_SAMPLE")))
except Exception:
    _sample = 1.0
if _config.get("MXNET_EVENTS"):
    enable()
