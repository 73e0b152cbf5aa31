"""Profiler facade over ``torch.profiler`` (counterpart of
mxnet_tpu/profiler.py).

Reference parity: src/profiler/ (chrome://tracing JSON dump, aggregate
stats) + python/mxnet/profiler.py:33,122,287 (set_config/start/stop/dumps)
+ scope classes (ProfileTask/Event/Frame/Domain).

Two files come out of a ``start()`` ... ``stop()`` ... ``dump()`` window:

* ``start``/``stop`` run a ``torch.profiler.profile`` with CPU activity
  and, when CUDA is available, CUDA activity (the card's kernels); at
  ``stop`` its Chrome trace is written to ``<filename>_trace/`` (where
  the JAX package writes its XPlane trace), one
  ``trace-<pid>-<n>.json`` a window (:func:`device_trace_path`);
* ``dump`` writes ``filename`` itself: the unified host timeline of this
  facade's op events, the hierarchical spans and the per-device memory
  samples (``tracing.chrome_trace_payload``).

Scope classes annotate the device trace through
``torch.profiler.record_function``; ``device_memory_stats`` reads the
``torch.cuda`` caching allocator.  Aggregate python-side op stats are
kept by this facade for `dumps()` parity.
"""
from __future__ import annotations

import collections
import os
import time

from . import telemetry as _telemetry

__all__ = ["set_config", "profiler_set_config", "start", "stop", "pause",
           "resume", "dump", "dumps", "set_state", "profiler_set_state",
           "Domain", "Task", "Frame", "Event", "Counter", "Marker",
           "device_trace_path", "last_error", "device_memory_stats"]

_config = {"profile_all": False, "filename": "profile.json",
           "aggregate_stats": False}
_state = {"running": False, "dir": None, "prof": None, "trace_path": None,
          "error": None, "n": 0}
_records = []
_op_stats = {}  # name -> [total_s, count, min_s, max_s]
# bounded timeline log feeding the chrome-trace dump(); entries are
# (name, start_s, dur_s) in perf_counter time.  At the cap the OLDEST
# event is evicted (the tail of a long run is what a post-mortem wants)
# and the drop is counted — silently freezing the timeline, as the old
# newest-dropped behavior did, made a saturated trace look complete.
_EVENT_CAP = 65536
_events = collections.deque(maxlen=_EVENT_CAP)
_dropped_events = 0
# per-program cost analysis (flops / bytes accessed), attributed once
# per program by the trainer's torch.utils.flop_counter count (the JAX
# package's name for the table is kept: XLA cost analysis fills it there)
_xla_costs = {}


def set_config(**kwargs):
    """Parity: mx.profiler.set_config (profile_symbolic/profile_imperative/
    profile_memory/profile_api/aggregate_stats/filename)."""
    _config.update(kwargs)


def profiler_set_config(mode="symbolic", filename="profile.json"):
    _config["filename"] = filename


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        start()
    else:
        stop()


profiler_set_state = set_state


def start(profile_process="worker"):
    """Start a ``torch.profiler.profile`` (CPU, plus CUDA when
    available).  A profiler that fails to start leaves ``running``
    False and its error in :func:`last_error`, as the JAX facade
    swallows a failed ``start_trace``."""
    import torch

    if _state["running"]:
        return
    logdir = os.path.splitext(_config.get("filename", "profile.json"))[0] + "_trace"
    _state["dir"] = logdir
    _state["error"] = None
    try:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        _state["prof"] = prof
        _state["running"] = True
    except Exception as e:
        _state["prof"] = None
        _state["running"] = False
        _state["error"] = e


def stop(profile_process="worker"):
    """Stop the running profile and write its Chrome trace into
    ``<filename>_trace/`` (:func:`device_trace_path` names the file)."""
    if _state["running"]:
        prof = _state["prof"]
        try:
            prof.stop()
            os.makedirs(_state["dir"], exist_ok=True)
            _state["n"] += 1
            path = os.path.join(_state["dir"], "trace-%d-%d.json"
                                % (os.getpid(), _state["n"]))
            prof.export_chrome_trace(path)
            _state["trace_path"] = path
        finally:
            _state["running"] = False
            _state["prof"] = None


def device_trace_path():
    """The Chrome trace the last :func:`stop` wrote (host and, on the
    card, CUDA kernel events), or None."""
    return _state["trace_path"]


def last_error():
    """The exception of the last :func:`start` that failed, or None."""
    return _state["error"]


def pause(profile_process="worker"):
    stop(profile_process)


def resume(profile_process="worker"):
    start(profile_process)


def dump(finished=True, profile_process="worker"):
    """Write the chrome://tracing JSON to the configured ``filename``
    (reference Profiler::DumpProfile, src/profiler/profiler.h:256) and
    stop any running torch profile (its device trace goes to
    ``<filename>_trace/``).

    The payload is the UNIFIED timeline (tracing.chrome_trace_payload):
    this facade's op events plus any hierarchical spans and per-device
    memory counter samples from ``tracing`` — one valid chrome/Perfetto
    file however the data was collected."""
    import json

    if _state["running"] and finished:
        stop()
    path = _config.get("filename", "profile.json")
    from . import tracing as _tracing

    payload = _tracing.chrome_trace_payload(include_profiler=True)
    payload["otherData"]["xla_costs"] = _xla_costs
    from .checkpoint import atomic_write

    atomic_write(path, json.dumps(payload))
    return path


def aggregate_enabled():
    """True when per-op aggregate stats collection is on."""
    return bool(_config.get("aggregate_stats"))


def sync_enabled():
    """True when dispatch hooks should synchronize the card so timings
    cover device execution instead of async dispatch
    (set_config(profile_sync=True))."""
    return bool(_config.get("profile_sync"))


def record_op_time(name, dur_s, start_s=None):
    """Called by the dispatch layers per op/program when aggregation is
    enabled.  O(#op-names) running counters, like the reference's
    aggregate_stats.cc, plus a bounded timeline log for dump()."""
    st = _op_stats.get(name)
    if st is None:
        _op_stats[name] = [dur_s, 1, dur_s, dur_s]
    else:
        st[0] += dur_s
        st[1] += 1
        if dur_s < st[2]:
            st[2] = dur_s
        if dur_s > st[3]:
            st[3] = dur_s
    if start_s is None:
        start_s = time.perf_counter() - dur_s
    if _events.maxlen is not None and len(_events) == _events.maxlen:
        global _dropped_events

        _dropped_events += 1
        _telemetry.PROFILER_EVENTS_DROPPED.inc()
    _events.append((name, start_s, dur_s))


def timed_call(name, fn, args):
    """Run ``fn(*args)`` and, when aggregation is on, record its wall
    time under ``name`` — blocking on the result first when
    profile_sync is set so the timing covers device execution rather
    than async dispatch.  The single helper keeps every dispatch hook
    (CachedOp, ShardedTrainer, Executor) behaviorally identical."""
    if not aggregate_enabled():
        return fn(*args)
    t0 = time.perf_counter()
    out = fn(*args)
    if sync_enabled():
        import torch

        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    record_op_time(name, time.perf_counter() - t0, t0)
    return out


def record_xla_cost(name, analysis):
    """Attribute a program's cost analysis (flops, bytes accessed; the
    trainer's ``torch.utils.flop_counter`` count gives flops) — the
    analogue of the reference's per-op FLOP counters."""
    if not isinstance(analysis, dict):
        return
    _xla_costs[name] = {
        "flops": float(analysis.get("flops", 0.0)),
        "bytes_accessed": float(analysis.get("bytes accessed",
                                             analysis.get("bytes_accessed",
                                                          0.0)))}


def device_memory_stats():
    """Per-device memory counters from the ``torch.cuda`` caching
    allocator (reference storage_profiler.h GpuDeviceStorageProfiler
    role).

    The schema is STABLE across backends: every device gets an entry
    with at least ``bytes_in_use`` and ``peak_bytes_in_use``, plus an
    ``"unavailable"`` reason string where the allocator reports nothing
    (the CPU: one ``"cpu"`` entry of zeros) — dashboards and the flight
    recorder never have to special-case an empty dict.  Devices are
    those CUDA has initialised; no query synchronizes the card."""
    try:
        import torch
    except Exception:
        return {}
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {"cpu": {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                        "unavailable": "no CUDA device in use: the CPU "
                        "allocator keeps no statistics"}}
    out = {}
    for i in range(torch.cuda.device_count()):
        try:
            ms = torch.cuda.memory_stats(i)
            entry = {"bytes_in_use": int(ms.get(
                         "allocated_bytes.all.current", 0)),
                     "peak_bytes_in_use": int(ms.get(
                         "allocated_bytes.all.peak", 0)),
                     "bytes_reserved": int(ms.get(
                         "reserved_bytes.all.current", 0)),
                     "num_allocs": int(ms.get("allocation.all.allocated",
                                              0))}
        except Exception as e:
            entry = {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                     "unavailable": "torch.cuda.memory_stats(%d): %s"
                     % (i, e)}
        out["cuda:%d" % i] = entry
    return out


def dumps(reset=False):
    """Aggregate per-op statistics (reference aggregate_stats.cc table:
    name, count, total/min/max/avg ms), the cost table of the counted
    programs, and device-memory counters."""
    agg = dict(_op_stats)
    for name, dur in _records:   # scope timers (Task/Event/Frame)
        tot, cnt, mn, mx = agg.get(name, (0.0, 0, float("inf"), 0.0))
        agg[name] = [tot + dur, cnt + 1, min(mn, dur), max(mx, dur)]
    out = ["Profile Statistics:",
           "%-32s %10s %12s %12s %12s %12s" % (
               "Name", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
               "Avg(ms)")]
    for name, (tot, cnt, mn, mx) in sorted(agg.items()):
        # count=0 placeholder rows (a registered name that never fired)
        # must render as zeros, not divide by zero
        avg = tot / cnt * 1e3 if cnt else 0.0
        mn = 0.0 if mn == float("inf") else mn
        out.append("%-32s %10d %12.4f %12.4f %12.4f %12.4f" % (
            name, cnt, tot * 1e3, mn * 1e3, mx * 1e3, avg))
    if _xla_costs:
        out.append("")
        out.append("Cost analysis (per program):")
        out.append("%-40s %14s %16s" % ("Program", "GFLOPs", "MB accessed"))
        for name, c in sorted(_xla_costs.items()):
            out.append("%-40s %14.3f %16.3f" % (
                name, c["flops"] / 1e9, c["bytes_accessed"] / 1e6))
    mem = device_memory_stats()
    if mem:
        out.append("")
        out.append("Device memory:")
        for dev, st in mem.items():
            used = st.get("bytes_in_use", 0)
            peak = st.get("peak_bytes_in_use", 0)
            out.append("%-32s in_use %12d  peak %12d" % (dev, used, peak))
    if reset:
        global _dropped_events

        _records.clear()
        _op_stats.clear()
        _events.clear()
        _xla_costs.clear()
        # the drop count describes the cleared timeline; a fresh window
        # must not inherit it (the cumulative telemetry counter is the
        # process-lifetime view)
        _dropped_events = 0
    return "\n".join(out)


class Domain:
    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_event(self, name):
        return Event(name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_marker(self, name):
        return Marker(self, name)


class _Scope:
    def __init__(self, name):
        self.name = name
        self._t0 = None
        self._ann = None

    def start(self):
        import torch

        self._t0 = time.perf_counter()
        try:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        except Exception:
            self._ann = None

    def stop(self):
        if self._t0 is not None:
            _records.append((self.name, time.perf_counter() - self._t0))
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class Task(_Scope):
    def __init__(self, domain, name):
        super().__init__(name)
        self.domain = domain


class Frame(_Scope):
    def __init__(self, domain, name):
        super().__init__(name)
        self.domain = domain


class Event(_Scope):
    pass


class Counter:
    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self.value = value or 0

    def set_value(self, value):
        self.value = value

    def increment(self, delta=1):
        self.value += delta

    def decrement(self, delta=1):
        self.value -= delta

    def __iadd__(self, v):
        self.value += v
        return self

    def __isub__(self, v):
        self.value -= v
        return self


class Marker:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        _records.append((self.name, 0.0))
