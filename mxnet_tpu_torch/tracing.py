"""Hierarchical span tracing + black-box flight recorder (counterpart of
mxnet_tpu/tracing.py).

The telemetry registry answers "how fast, how often"; this module
answers "what exactly was happening, in what order, with how much device
memory in use" — the structured timeline that incident triage needs:

* **Spans** — :func:`begin`/:meth:`Span.end` (or the :class:`span`
  context manager, which `telemetry.span` now wraps) record hierarchical
  timed scopes with a process-wide ``TRACE_ID``, unique span IDs, and
  parent propagation via :mod:`contextvars` (each thread roots its own
  tree).  Finished spans land in a bounded, lock-protected ring buffer —
  the newest ``MXNET_TRACE_BUFFER`` spans survive, oldest are evicted
  and counted — so a crash always has the recent past on hand.
* **Chrome-trace export** — :func:`chrome_trace_payload` merges spans
  (completed + still-open), per-device memory counter samples
  (``torch.cuda`` allocator statistics), and the
  profiler's op timeline into one valid Chrome ``trace.json``
  (Perfetto-loadable); :func:`export_trace` writes it atomically via
  ``checkpoint.atomic_write``.  ``profiler.dump()`` uses the same
  payload, so the two subsystems emit a single unified timeline.
* **Flight recorder** — :func:`record_crash` dumps a postmortem bundle
  (trace.json, telemetry.json, stacks.txt, info.json) into
  ``MXNET_FLIGHT_RECORDER_DIR`` when ``MXNET_FLIGHT_RECORDER=1``.
  Trigger points live in the runtime layers: the non-finite step guard
  (``checkpoint.check_finite``), checkpoint digest failures, the
  SIGTERM/SIGINT preemption flush, and unhandled exceptions in
  ``ShardedTrainer.step`` / ``Module.fit`` / ``serving.Predictor``.
  Bundles are written to a temp dir and committed with one ``rename``
  (a crash mid-dump never leaves a half bundle), and rate-limited per
  reason (:data:`FLIGHT_MIN_INTERVAL`) so a NaN storm produces one
  bundle, not thousands.

Both features are OFF by default and cost one branch per instrumented
call site when off (``MXNET_TRACE=1`` / ``MXNET_FLIGHT_RECORDER=1`` at
import, or :func:`enable` / :func:`enable_flight_recorder` at runtime).

Import-light by design (stdlib + ``config`` + ``telemetry``):
``profiler`` and ``checkpoint`` are imported lazily inside functions so
every runtime layer can import this module without cycles.
"""
from __future__ import annotations

import collections
import contextvars
import itertools
import json
import logging
import os
import shutil
import sys
import tempfile
import threading
import time
import traceback
import uuid

from . import config as _config
from . import telemetry as _telemetry

__all__ = ["TRACE_ID", "Span", "span", "begin", "current_span",
           "enabled", "enable", "disable", "reset", "new_request_id",
           "unwind_to",
           "sample_device_memory", "chrome_trace_payload", "export_trace",
           "flight_recorder_enabled", "enable_flight_recorder",
           "disable_flight_recorder", "rearm_flight_recorder",
           "record_crash", "bundles", "FLIGHT_MIN_INTERVAL"]

logger = logging.getLogger("mxnet_tpu_torch.tracing")

_enabled = False
_flight_enabled = False
_flight_dir = None

# one trace per process: every span carries it so bundles from a fleet
# can be correlated back to the run that produced them
TRACE_ID = uuid.uuid4().hex
_PID = os.getpid()

_ids = itertools.count(1)          # span-id source (count.__next__ is atomic)
# REENTRANT: record_crash runs inside signal handlers, which interrupt
# the main thread between arbitrary bytecodes — possibly inside one of
# this module's own locked regions.  A plain Lock would self-deadlock
# there; with an RLock the handler proceeds (a crash dump reading a
# half-updated ring buffer is fine, a hung preemption flush is not).
_lock = threading.RLock()
_buffer = collections.deque(
    maxlen=max(16, _config.get("MXNET_TRACE_BUFFER")))
_active = {}                       # span_id -> open Span (insertion order)
_mem_samples = collections.deque(maxlen=4096)  # (t, device, in_use, peak)
_thread_names = {}                 # tid -> thread name (export metadata)
_dropped = 0

# flight-recorder rate limit: at most one bundle per reason per window,
# so a NaN at every step files one report, not one per step
FLIGHT_MIN_INTERVAL = 60.0
_last_bundle = {}                  # reason -> time.monotonic() of last dump
_bundle_seq = itertools.count(1)


def enabled():
    """Whether span collection is on (one branch on the hot path)."""
    return _enabled


def enable(buffer_size=None):
    """Turn span collection on; ``buffer_size`` resizes the ring buffer
    (existing spans are kept, newest-first, up to the new cap)."""
    global _enabled, _buffer
    if buffer_size is not None:
        with _lock:
            _buffer = collections.deque(_buffer,
                                        maxlen=max(16, int(buffer_size)))
    _enabled = True


def disable():
    """Turn span collection off (buffered spans are kept for export)."""
    global _enabled
    _enabled = False


def reset():
    """Clear buffered/open spans, memory samples, and drop counts — test
    hook and per-run reset (TRACE_ID and registrations survive)."""
    global _dropped
    with _lock:
        _buffer.clear()
        _active.clear()
        _mem_samples.clear()
        _thread_names.clear()
        _dropped = 0
        _last_bundle.clear()


_current = contextvars.ContextVar("mxnet_tpu_span", default=None)


def current_span():
    """The innermost open :class:`Span` in this context, or None."""
    return _current.get()


def _exemplar_labels():
    """Active {trace_id, span_id} for Histogram exemplars, or None
    when tracing is off — installed into telemetry below so a tail
    histogram observation links back to its trace (and through the
    span id, to its wide event)."""
    if not _enabled:
        return None
    out = {"trace_id": TRACE_ID}
    sp = _current.get()
    if sp is not None:
        out["span_id"] = sp.span_id
    return out


_telemetry.set_exemplar_source(_exemplar_labels)


def new_request_id():
    """A fresh ID from the span-ID space (used for request correlation
    on error paths when tracing is off and no root span exists)."""
    return "%016x" % next(_ids)


class Span:
    """One open traced scope.  Create via :func:`begin`; finish with
    :meth:`end`.  ``activate=False`` spans do not become the contextvar
    parent (used for overlapping serving requests)."""

    __slots__ = ("name", "span_id", "parent_id", "tid", "t0", "dur",
                 "args", "status", "_token")

    def __init__(self, name, args=None, activate=True):
        parent = _current.get()
        self.name = name
        self.span_id = "%016x" % next(_ids)
        self.parent_id = parent.span_id if parent is not None else None
        self.tid = threading.get_ident()
        self.args = dict(args) if args else None
        self.status = "open"
        self.dur = None
        self._token = _current.set(self) if activate else None
        # t0 before registration: a concurrent exporter snapshotting
        # _active must never see a span without a timestamp
        self.t0 = time.perf_counter()
        with _lock:
            if self.tid not in _thread_names:
                _thread_names[self.tid] = threading.current_thread().name
            _active[self.span_id] = self
            # leaked spans (exception paths that never end()) must not
            # grow the open-table unboundedly over a process lifetime
            while len(_active) > 2 * (_buffer.maxlen or 1):
                _active.pop(next(iter(_active)))

    @property
    def id_str(self):
        return self.span_id

    def set(self, **args):
        """Attach/overwrite span args after creation."""
        if self.args is None:
            self.args = {}
        self.args.update(args)
        return self

    def _record(self, now=None):
        dur = self.dur
        if dur is None:
            dur = max(0.0, (now or time.perf_counter()) - self.t0)
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id, "tid": self.tid,
                "t0": self.t0, "dur": dur, "status": self.status,
                "args": self.args}

    def end(self, error=False):
        """Close the span and commit it to the ring buffer.  Unlike
        telemetry latency series (success-only), failed spans ARE
        recorded — a postmortem wants exactly those."""
        global _dropped
        if self.status != "open":
            return self
        self.dur = time.perf_counter() - self.t0
        self.status = "error" if error else "ok"
        if self._token is not None:
            try:
                _current.reset(self._token)
            except ValueError:
                pass  # ended from a different context: leave it be
            self._token = None
        with _lock:
            _active.pop(self.span_id, None)
            if _buffer.maxlen is not None and \
                    len(_buffer) == _buffer.maxlen:
                _dropped += 1
                _telemetry.TRACE_SPANS_DROPPED.inc()
            _buffer.append(self._record())
        return self


def begin(name, args=None, activate=True):
    """Open a :class:`Span` (caller must :meth:`Span.end` it).  Prefer
    the :class:`span` context manager unless the scope crosses loop
    iterations (e.g. one serving request across upload -> drain)."""
    return Span(name, args=args, activate=activate)


def instant(name, args=None):
    """Record a zero-duration marker into the trace ring buffer
    (chrome-trace ``ph:"i"``): completion ticks and stall markers from
    background threads (the async metric fetcher, the device
    prefetcher) that have no natural begin/end scope.  No-op when
    tracing is off."""
    global _dropped
    if not _enabled:
        return
    tid = threading.get_ident()
    rec = {"name": name, "span_id": "%016x" % next(_ids),
           "parent_id": None, "tid": tid, "t0": time.perf_counter(),
           "dur": 0.0, "status": "instant",
           "args": dict(args) if args else None}
    with _lock:
        if tid not in _thread_names:
            _thread_names[tid] = threading.current_thread().name
        if _buffer.maxlen is not None and len(_buffer) == _buffer.maxlen:
            _dropped += 1
            _telemetry.TRACE_SPANS_DROPPED.inc()
        _buffer.append(rec)


def unwind_to(outer, error=True):
    """End every context-chain span opened below ``outer`` (innermost
    first) and restore ``outer`` as the current span — exception-path
    cleanup for instrumented loops whose normal close sites were
    skipped by the unwind.  Without it a dead span would stay the
    contextvar parent and corrupt the parentage of everything recorded
    later in the thread."""
    sp = _current.get()
    while sp is not None and sp is not outer:
        sp.end(error=error)
        nxt = _current.get()
        if nxt is sp:
            break  # token could not reset (foreign context): stop
        sp = nxt


class span:
    """Timed scope feeding up to three subsystems from one context
    manager: the trace ring buffer (tracing on), ``hist`` in the
    telemetry registry (telemetry on; completed scopes only — failures
    get their own counters), and the profiler aggregate/timeline table
    (``profiler.set_config(aggregate_stats=True)``).  All off: no
    timestamp is even taken.  ``telemetry.span`` is an alias of this.
    """

    __slots__ = ("name", "hist", "labels", "_t0", "_span")

    def __init__(self, name, hist=None, **labels):
        self.name = name
        self.hist = hist
        self.labels = labels
        self._t0 = None
        self._span = None

    def __enter__(self):
        from . import profiler as _profiler

        if _enabled:
            self._span = begin(self.name, args=self.labels or None)
            self._t0 = self._span.t0
        elif _telemetry.enabled() or _profiler.aggregate_enabled():
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._span is not None:
            sp, self._span = self._span, None
            sp.end(error=exc_type is not None)
            dur = sp.dur
        elif self._t0 is not None:
            dur = time.perf_counter() - self._t0
        else:
            return
        if exc_type is not None:
            return
        if self.hist is not None and _telemetry.enabled():
            self.hist.observe(dur, **self.labels)
        from . import profiler as _profiler

        if _profiler.aggregate_enabled():
            _profiler.record_op_time(self.name, dur, self._t0)


# ---------------------------------------------------------------------------
# device-memory watermarks
# ---------------------------------------------------------------------------

def sample_device_memory():
    """Sample ``profiler.device_memory_stats()`` once: per-device HBM
    live/peak bytes into the telemetry gauges and (tracing on) into the
    chrome-trace counter track.  Called per train step by the
    instrumented loops; cheap enough for that cadence (one allocator
    query per local device)."""
    from . import profiler as _profiler

    stats = _profiler.device_memory_stats()
    now = time.perf_counter()
    for dev, st in stats.items():
        in_use = int(st.get("bytes_in_use", 0))
        peak = int(st.get("peak_bytes_in_use", 0))
        _telemetry.DEVICE_MEMORY_BYTES_IN_USE.set(in_use, device=dev)
        _telemetry.DEVICE_MEMORY_PEAK_BYTES.set(peak, device=dev)
        if _enabled:
            with _lock:
                _mem_samples.append((now, dev, in_use, peak))
    return stats


# ---------------------------------------------------------------------------
# chrome-trace export
# ---------------------------------------------------------------------------

def chrome_trace_payload(include_profiler=True):
    """One valid Chrome/Perfetto trace dict: span ``"X"`` events (with
    trace/span/parent IDs and user args), still-open spans (flagged
    ``incomplete`` so a postmortem's parents always resolve), per-device
    HBM ``"C"`` counter events, thread-name metadata, and — when
    ``include_profiler`` — the profiler's op timeline.  Events are
    sorted by ``ts`` (one shared ``perf_counter`` timebase)."""
    now = time.perf_counter()
    with _lock:
        completed = list(_buffer)
        open_recs = [s._record(now) for s in _active.values()]
        mem = list(_mem_samples)
        tnames = dict(_thread_names)
        dropped = _dropped
    events = []
    for rec in completed:
        events.append(_span_event(rec))
    for rec in open_recs:
        ev = _span_event(rec)
        ev["args"]["incomplete"] = True
        events.append(ev)
    for t, dev, in_use, peak in mem:
        events.append({"name": "HBM %s" % dev, "ph": "C", "cat": "memory",
                       "ts": t * 1e6, "pid": _PID, "tid": 0,
                       "args": {"bytes_in_use": in_use,
                                "peak_bytes_in_use": peak}})
    other = {"trace_id": TRACE_ID, "pid": _PID,
             "dropped_spans": dropped,
             "open_spans": len(open_recs)}
    if include_profiler:
        from . import profiler as _profiler

        for name, t0, dur in list(_profiler._events):
            events.append({"name": name, "ph": "X", "cat": "op",
                           "ts": t0 * 1e6, "dur": dur * 1e6,
                           "pid": _PID, "tid": 0})
        other["dropped_events"] = _profiler._dropped_events
        try:
            other["device_memory"] = _profiler.device_memory_stats()
        except Exception:
            pass  # an allocator query failed: spans still export
    events.sort(key=lambda e: e["ts"])
    meta = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
             "args": {"name": "mxnet_tpu_torch pid %d" % _PID}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": _PID, "tid": tid,
              "args": {"name": nm}} for tid, nm in sorted(tnames.items())]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms",
            "otherData": other}


def _span_event(rec):
    args = {"trace_id": TRACE_ID, "span_id": rec["span_id"],
            "parent_id": rec["parent_id"], "status": rec["status"]}
    if rec["args"]:
        for k, v in rec["args"].items():
            args.setdefault(str(k), _jsonable(v))
    if rec["status"] == "instant":
        return {"name": rec["name"], "ph": "i", "s": "t", "cat": "span",
                "ts": rec["t0"] * 1e6, "pid": _PID, "tid": rec["tid"],
                "args": args}
    return {"name": rec["name"], "ph": "X", "cat": "span",
            "ts": rec["t0"] * 1e6, "dur": max(0.0, rec["dur"]) * 1e6,
            "pid": _PID, "tid": rec["tid"], "args": args}


def _jsonable(v):
    if isinstance(v, (str, int, bool)) or v is None:
        return v
    if isinstance(v, float):
        return v if v == v and abs(v) != float("inf") else repr(v)
    return str(v)


def export_trace(path, include_profiler=True):
    """Write :func:`chrome_trace_payload` to ``path`` atomically (crash
    mid-export leaves the old file or none, never a torn one)."""
    from .checkpoint import atomic_write

    atomic_write(os.fspath(path),
                 json.dumps(chrome_trace_payload(include_profiler)))
    return path


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def flight_recorder_enabled():
    return _flight_enabled


def enable_flight_recorder(directory=None):
    """Arm the flight recorder (and clear the per-reason rate limiter).
    ``directory`` overrides ``MXNET_FLIGHT_RECORDER_DIR``."""
    global _flight_enabled, _flight_dir
    if directory is not None:
        _flight_dir = os.fspath(directory)
    _flight_enabled = True
    rearm_flight_recorder()


def disable_flight_recorder():
    global _flight_enabled
    _flight_enabled = False


def rearm_flight_recorder():
    """Forget per-reason rate-limit state so the next trigger of any
    reason dumps immediately (tests; operator 'dump again now')."""
    with _lock:
        _last_bundle.clear()


def _bundle_base():
    d = _flight_dir or _config.get("MXNET_FLIGHT_RECORDER_DIR") or \
        os.path.join(os.getcwd(), "flight_recorder")
    return os.fspath(d)


def bundles(directory=None):
    """Committed bundle directories under ``directory`` (default: the
    configured flight-recorder dir), oldest first."""
    base = os.fspath(directory) if directory is not None else _bundle_base()
    try:
        names = os.listdir(base)
    except OSError:
        return []
    return [os.path.join(base, n) for n in sorted(names)
            if n.startswith("flight-")]


def _mark_recorded(exc):
    """Tag an exception as already captured so the same error unwinding
    through several instrumented layers (check_finite -> step -> fit)
    files ONE bundle, not one per layer."""
    if exc is not None:
        try:
            exc._mxnet_flight_recorded = True
        except Exception:
            pass  # exceptions with __slots__: layers may double-record


def record_crash(reason, exc=None, extra=None):
    """Dump one postmortem bundle for ``reason`` and return its path.

    No-op (returns None) when the recorder is off, when ``exc`` was
    already captured by an inner layer, or when ``reason`` already
    dumped within :data:`FLIGHT_MIN_INTERVAL` (a failed write un-stamps
    the window so the next trigger retries).  NEVER raises: the
    recorder runs inside signal handlers and exception paths, where a
    secondary failure would mask the primary one.
    """
    if not _flight_enabled:
        return None
    if exc is not None and getattr(exc, "_mxnet_flight_recorded", False):
        return None
    now = time.monotonic()
    with _lock:
        last = _last_bundle.get(reason)
        if last is not None and now - last < FLIGHT_MIN_INTERVAL:
            _mark_recorded(exc)
            return None
        _last_bundle[reason] = now
    try:
        path = _write_bundle(reason, exc, extra)
    except Exception:
        # un-stamp so the NEXT trigger retries — a transient disk error
        # on the first bundle must not silence the whole incident window
        with _lock:
            if _last_bundle.get(reason) == now:
                del _last_bundle[reason]
        logger.exception("flight-recorder dump for %r failed", reason)
        return None
    _mark_recorded(exc)
    return path


def _write_bundle(reason, exc, extra):
    from .checkpoint import atomic_write

    base = _bundle_base()
    os.makedirs(base, exist_ok=True)
    # temp dir + rename = the bundle's commit mark: a bundle directory
    # that exists is complete (readers skip ".tmp-" dirs)
    tmp = tempfile.mkdtemp(dir=base, prefix=".tmp-flight-")
    try:
        export_trace(os.path.join(tmp, "trace.json"))
        _telemetry.REGISTRY.dump(os.path.join(tmp, "telemetry.json"))
        try:
            # the recent-events ring: per-request evidence for the
            # window leading into the crash (best effort — a broken
            # events layer must not cost the bundle)
            from . import events as _events

            atomic_write(os.path.join(tmp, "events.json"),
                         json.dumps({"stats": _events.stats(),
                                     "events": _events.recent()},
                                    default=str))
        except Exception:
            logger.exception("flight-recorder events.json failed")
        atomic_write(os.path.join(tmp, "stacks.txt"), _format_stacks())
        atomic_write(os.path.join(tmp, "info.json"),
                     json.dumps(_bundle_info(reason, exc, extra), indent=1,
                                sort_keys=True, default=str))
    except BaseException:
        # a half-written bundle must not pile up as junk under the
        # bundle root on every retry
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    final = os.path.join(base, "flight-%s-%s-p%d-%d" % (
        time.strftime("%Y%m%d-%H%M%S"), reason, _PID, next(_bundle_seq)))
    os.rename(tmp, final)
    _telemetry.FLIGHT_BUNDLES.inc(reason=reason)
    logger.error("flight recorder: %s -> %s", reason, final)
    return final


def _format_stacks():
    """Python stacks of every live thread (sys._current_frames), thread
    names resolved — the 'what was everyone doing' page of the bundle."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for tid, frame in sorted(sys._current_frames().items()):
        out.append("Thread %s (tid %d)%s:" % (
            names.get(tid, "<unknown>"), tid,
            " <- current" if tid == threading.get_ident() else ""))
        out.extend(l.rstrip("\n") for l in traceback.format_stack(frame))
        out.append("")
    return "\n".join(out) + "\n"


def _bundle_info(reason, exc, extra):
    with _lock:
        n_spans, n_open, dropped = len(_buffer), len(_active), _dropped
    info = {
        "format_version": 1,
        "reason": reason,
        "time": time.time(),
        "pid": _PID,
        "argv": list(sys.argv),
        "python": sys.version,
        "trace_id": TRACE_ID,
        "spans": {"buffered": n_spans, "open": n_open,
                  "dropped": dropped},
        "config": {name: str(_config.get(name))
                   for name in sorted(_config.FLAGS)},
    }
    if extra:
        info["extra"] = dict(extra)
    if exc is not None:
        info["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(
                type(exc), exc, exc.__traceback__),
        }
    try:
        import torch

        cuda = torch.cuda.is_available()
        n = torch.cuda.device_count() if cuda else 0
        info["torch"] = {"version": torch.__version__,
                         "cuda": torch.version.cuda,
                         "backend": "cuda" if cuda else "cpu",
                         "device_count": n,
                         "devices": [torch.cuda.get_device_name(i)
                                     for i in range(n)]}
    except Exception as e:
        info["torch"] = {"unavailable": str(e)}
    try:
        from . import profiler as _profiler

        info["device_memory"] = _profiler.device_memory_stats()
    except Exception:
        pass
    return info


if _config.get("MXNET_TRACE"):
    enable()
if _config.get("MXNET_FLIGHT_RECORDER"):
    enable_flight_recorder()
