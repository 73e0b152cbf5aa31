"""Unified runtime telemetry: process-wide metrics registry + exporters
(counterpart of mxnet_tpu/telemetry.py).

A single process-wide registry of Counter / Gauge / Histogram series
that every layer (ShardedTrainer, Module.fit, the decode engines and
TokenServer, the profiler, the compile path of ``jit.Compiled``)
reports into, exported as

* :func:`scrape` — Prometheus text exposition (``/metrics`` body),
* :func:`dump` — atomic JSON snapshot (via ``checkpoint.atomic_write``),
* :class:`TelemetryReporter` — opt-in background thread that snapshots
  at a fixed interval and drives ``monitor.start_heartbeat``.

Collection is OFF by default: every mutator starts with one module-flag
check (``if not _enabled: return``), so an un-enabled process pays a
single attribute load + branch per call site.  Turn it on with
``MXNET_TELEMETRY=1`` (read at import) or :func:`enable`.

The metric catalog — names (``mxnet_tpu_`` prefix kept, so one
dashboard and the same readers serve both packages), kinds, label
names, buckets and help texts — is the JAX package's, verbatim: the two
packages' ``scrape()`` of the same series are byte-equal.  Help texts
that speak of XLA describe the JAX package's producer of the series;
here the compile series are fed by ``jit.Compiled`` (:func:`note_compile`)
and the step FLOPs by ``torch.utils.flop_counter``.

Import-light by design (stdlib + ``config`` only): ``checkpoint`` and
``profiler`` import this module at top level, so it must never import
them back except lazily inside functions.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

from . import config as _config

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "enabled", "enable", "disable", "counter", "gauge", "histogram",
           "span", "scrape", "dump", "collect", "reset",
           "TelemetryReporter", "set_peak_flops", "peak_flops",
           "serve_scrape", "stop_scrape", "scrape_server",
           "set_exemplar_source", "note_compile", "register_status_provider",
           "unregister_status_provider", "statusz", "varz",
           "register_readiness", "unregister_readiness", "readiness",
           "merge_collected",
           "DEFAULT_TIME_BUCKETS", "BATCH_SIZE_BUCKETS"]

_enabled = False

# latency buckets (seconds): 0.5 ms .. 2 min, roughly 2-2.5x apart —
# covers serving dispatch (~ms) through cold XLA compiles (~100 s)
DEFAULT_TIME_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                        0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                        120.0)
# power-of-two batch sizes, the only ones the serving path compiles for
BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                      512.0, 1024.0)

_INF = float("inf")


def enabled():
    """Whether metric collection is on (one branch on the hot path)."""
    return _enabled


def enable():
    """Turn collection on."""
    global _enabled
    _enabled = True


def disable():
    """Turn collection off (registered series keep their values)."""
    global _enabled
    _enabled = False


def _fmt(v):
    """Prometheus sample-value / bucket-bound formatting."""
    if v != v:
        return "NaN"
    if v == _INF:
        return "+Inf"
    if v == -_INF:
        return "-Inf"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return "%d" % int(f)
    return repr(f)


def _escape_label(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _escape_help(v):
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _json_num(v):
    """JSON-portable number: RFC 8259 has no Infinity/NaN tokens, so
    non-finite values ship as strings (``float()`` round-trips them)."""
    if v != v:
        return "NaN"
    if v == _INF:
        return "Infinity"
    if v == -_INF:
        return "-Infinity"
    return v


class _Metric:
    """Shared label plumbing for the three metric kinds.

    A metric owns a dict of *series* keyed by the tuple of label values
    (in declared ``label_names`` order).  An unlabeled metric has
    exactly one series, created eagerly so it is always exported (a
    counter that has never fired still scrapes as ``0`` — absence and
    zero are different signals).
    """

    kind = None

    def __init__(self, name, help, label_names=()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        # RLock: the flight recorder snapshots the registry from signal
        # handlers, which can interrupt the owning thread inside one of
        # these locked regions — a plain Lock would self-deadlock there
        self._lock = threading.RLock()
        self._series = {}
        if not self.label_names:
            self._series[()] = self._new_series()

    def _new_series(self):
        raise NotImplementedError

    def _key(self, labels):
        if set(labels) != set(self.label_names):
            raise ValueError(
                "metric %s takes labels %r, got %r"
                % (self.name, self.label_names, tuple(sorted(labels))))
        return tuple(str(labels[k]) for k in self.label_names)

    def _get_series(self, labels):
        key = self._key(labels)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, self._new_series())
        return s

    def series_labels(self):
        """Label dicts of every live series (scrape order)."""
        with self._lock:
            keys = sorted(self._series)
        return [dict(zip(self.label_names, k)) for k in keys]

    def clear(self):
        with self._lock:
            self._series.clear()
            if not self.label_names:
                self._series[()] = self._new_series()


class Counter(_Metric):
    """Monotonically increasing count (name should end ``_total``)."""

    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, amount=1, **labels):
        if not _enabled:
            return
        if amount < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        s = self._get_series(labels)
        with self._lock:
            s[0] += amount

    def value(self, **labels):
        s = self._series.get(self._key(labels))
        return s[0] if s is not None else 0.0


class Gauge(_Metric):
    """Point-in-time value (may go up and down)."""

    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def set(self, value, **labels):
        if not _enabled:
            return
        s = self._get_series(labels)
        with self._lock:
            s[0] = float(value)

    def inc(self, amount=1, **labels):
        if not _enabled:
            return
        s = self._get_series(labels)
        with self._lock:
            s[0] += amount

    def dec(self, amount=1, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        s = self._series.get(self._key(labels))
        return s[0] if s is not None else 0.0


# tracing installs a callable here (set_exemplar_source) returning the
# active {trace_id, span_id} labels, or None when tracing is off — the
# lazy hook keeps telemetry import-light (tracing imports telemetry,
# never the reverse)
_exemplar_source = None


def set_exemplar_source(fn):
    """Install the callable ``Histogram.observe`` consults for the
    active trace/span exemplar labels (``tracing`` does this at
    import; pass None to uninstall)."""
    global _exemplar_source
    _exemplar_source = fn


class Histogram(_Metric):
    """Fixed-boundary histogram with Prometheus bucket semantics.

    Per-series state is ``[per-bucket counts..., +Inf count, sum]``;
    exposition emits *cumulative* ``_bucket{le=...}`` counts plus
    ``_sum``/``_count`` like prometheus-client.

    **Exemplars** (trace<->metric correlation): when tracing is on (or
    the caller passes ``exemplar=``), each observation also records
    ``(value, {trace_id, span_id}, time)`` against the bucket it landed
    in — last-writer-wins per bucket, so the rare tail buckets keep
    their spike's trace id while the busy low buckets just churn.
    ``scrape()`` emits them in OpenMetrics exemplar syntax
    (``... # {trace_id="..."} value ts``) so a p999 outlier in a
    dashboard links straight to its trace span and wide event.
    """

    kind = "histogram"

    def __init__(self, name, help, label_names=(),
                 buckets=DEFAULT_TIME_BUCKETS):
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("histogram %s needs strictly increasing "
                             "buckets, got %r" % (name, buckets))
        if b[-1] == _INF:
            b = b[:-1]
        self.buckets = b
        self._exemplars = {}   # series key -> {bucket_i: (v, labels, t)}
        super().__init__(name, help, label_names)

    def _new_series(self):
        return [0] * (len(self.buckets) + 1) + [0.0]

    def observe(self, value, exemplar=None, **labels):
        if not _enabled:
            return
        value = float(value)
        s = self._get_series(labels)
        i = 0
        n = len(self.buckets)
        while i < n and value > self.buckets[i]:
            i += 1
        if exemplar is None and _exemplar_source is not None:
            exemplar = _exemplar_source()
        with self._lock:
            s[i] += 1
            s[-1] += value
            if exemplar:
                self._exemplars.setdefault(self._key(labels), {})[i] = (
                    value, dict(exemplar), time.time())

    def exemplars(self, **labels):
        """{bucket_upper_bound: (value, labels, time)} for the series
        (None entries absent) — the recorded trace exemplars."""
        with self._lock:
            # copy under the lock: observe() inserts concurrently, and
            # iterating the live dict from the scrape thread would
            # raise mid-/metrics on the first new-bucket exemplar
            ex = dict(self._exemplars.get(self._key(labels)) or {})
        if not ex:
            return {}
        bounds = self.buckets + (_INF,)
        return {bounds[i]: v for i, v in ex.items()}

    def clear(self):
        with self._lock:
            self._exemplars.clear()
        super().clear()

    def count(self, **labels):
        s = self._series.get(self._key(labels))
        return sum(s[:-1]) if s is not None else 0

    def sum(self, **labels):
        s = self._series.get(self._key(labels))
        return s[-1] if s is not None else 0.0

    def cumulative(self, **labels):
        """[(upper_bound, cumulative_count)] including (+Inf, total)."""
        s = self._series.get(self._key(labels))
        if s is None:
            s = self._new_series()
        out, running = [], 0
        for i, ub in enumerate(self.buckets + (_INF,)):
            running += s[i]
            out.append((ub, running))
        return out

    def quantile(self, q, **labels):
        """Bucket-interpolated quantile estimate (like Prometheus'
        ``histogram_quantile``); None when the series is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1], got %r" % (q,))
        cum = self.cumulative(**labels)
        total = cum[-1][1]
        if total == 0:
            return None
        rank = q * total
        prev_ub, prev_c = 0.0, 0
        for ub, c in cum:
            if c >= rank:
                if ub == _INF:
                    # open-ended top bucket: best estimate is its lower
                    # edge (Prometheus returns the same)
                    return prev_ub if self.buckets else 0.0
                if c == prev_c:
                    return ub
                return prev_ub + (ub - prev_ub) * (rank - prev_c) \
                    / (c - prev_c)
            prev_ub, prev_c = ub, c
        return cum[-1][0]


class Registry:
    """Named-metric store; ``REGISTRY`` below is the process-wide one."""

    def __init__(self):
        self._lock = threading.RLock()  # signal-handler safe (see _Metric)
        self._metrics = {}

    def _register(self, cls, name, help, label_names, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or \
                        m.label_names != tuple(label_names):
                    raise ValueError(
                        "metric %r already registered as %s%r"
                        % (name, m.kind, m.label_names))
                return m
            m = cls(name, help, label_names, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help, label_names=()):
        return self._register(Counter, name, help, label_names)

    def gauge(self, name, help, label_names=()):
        return self._register(Gauge, name, help, label_names)

    def histogram(self, name, help, label_names=(),
                  buckets=DEFAULT_TIME_BUCKETS):
        return self._register(Histogram, name, help, label_names,
                              buckets=buckets)

    def metrics(self):
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def get(self, name):
        return self._metrics.get(name)

    def reset(self):
        """Zero every series (registrations survive) — test hook."""
        for m in self.metrics():
            m.clear()

    # -- exporters -------------------------------------------------------
    def collect(self):
        """JSON-able snapshot: name -> {type, help, series: [...]}."""
        out = {}
        for m in self.metrics():
            series = []
            for labels in m.series_labels():
                if m.kind == "histogram":
                    row = {
                        "labels": labels,
                        "buckets": [[_json_num(ub), c]
                                    for ub, c in m.cumulative(**labels)],
                        "sum": m.sum(**labels),
                        "count": m.count(**labels)}
                    ex = m.exemplars(**labels)
                    if ex:
                        row["exemplars"] = {
                            str(_json_num(ub)): {
                                "value": v, "labels": el,
                                "time": round(t, 3)}
                            for ub, (v, el, t) in ex.items()}
                    series.append(row)
                else:
                    series.append({"labels": labels,
                                   "value": _json_num(m.value(**labels))})
            out[m.name] = {"type": m.kind, "help": m.help,
                           "label_names": list(m.label_names),
                           "series": series}
        return out

    def scrape(self, openmetrics=False):
        """Prometheus text exposition.

        Default (``openmetrics=False``): classic format 0.0.4 —
        exemplars are NOT emitted, because the classic text parser
        rejects the ``# {...}`` suffix as a malformed sample.  With
        ``openmetrics=True`` (the HTTP endpoint selects it when the
        client's Accept header negotiates
        ``application/openmetrics-text``): bucket lines carry the
        recorded trace exemplars in OpenMetrics exemplar syntax and
        the exposition ends with the ``# EOF`` terminator."""
        lines = []
        for m in self.metrics():
            # OpenMetrics names the counter *family* without the
            # _total suffix (samples keep it); the classic 0.0.4
            # format declares the suffixed name.  Strict OM parsers
            # reject the 0.0.4 spelling.
            fam = m.name[:-len("_total")] \
                if openmetrics and m.kind == "counter" \
                and m.name.endswith("_total") else m.name
            lines.append("# HELP %s %s" % (fam, _escape_help(m.help)))
            lines.append("# TYPE %s %s" % (fam, m.kind))
            for labels in m.series_labels():
                if m.kind == "histogram":
                    exs = m.exemplars(**labels) if openmetrics else {}
                    for ub, c in m.cumulative(**labels):
                        line = "%s_bucket%s %s" % (
                            m.name,
                            _label_str(labels, extra=[("le", _fmt(ub))]),
                            _fmt(c))
                        ex = exs.get(ub)
                        if ex is not None:
                            # OpenMetrics exemplar syntax: the tail
                            # bucket's last observation links to its
                            # trace span (and through it, the wide
                            # event) — see docs/observability.md
                            v, el, t = ex
                            line += " # %s %s %.3f" % (
                                _label_str(el) or "{}", _fmt(v), t)
                        lines.append(line)
                    lines.append("%s_sum%s %s" % (
                        m.name, _label_str(labels), _fmt(m.sum(**labels))))
                    lines.append("%s_count%s %s" % (
                        m.name, _label_str(labels),
                        _fmt(m.count(**labels))))
                else:
                    lines.append("%s%s %s" % (
                        m.name, _label_str(labels),
                        _fmt(m.value(**labels))))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def dump(self, path):
        """Atomic JSON snapshot at ``path`` (crash-safe: old or new file,
        never a torn one)."""
        from .checkpoint import atomic_write

        payload = {"format_version": 1, "time": time.time(),
                   "metrics": self.collect()}
        # allow_nan=False: a non-finite value leaking past _json_num
        # must fail here, not emit a bare Infinity/NaN token only
        # Python's lenient parser would accept
        atomic_write(os.fspath(path),
                     json.dumps(payload, indent=1, sort_keys=True,
                                allow_nan=False))
        return path


def _label_str(labels, extra=()):
    pairs = [(k, _escape_label(v)) for k, v in labels.items()]
    pairs += list(extra)
    if not pairs:
        return ""
    return "{%s}" % ",".join('%s="%s"' % kv for kv in pairs)


def _json_body(payload):
    """UTF-8 JSON bytes for the introspection endpoints (default=str:
    a snapshot must render, never 500 on an odd value)."""
    return json.dumps(payload, sort_keys=True,
                      default=str).encode("utf-8")


REGISTRY = Registry()


def counter(name, help, label_names=()):
    """Get-or-register a :class:`Counter` on the default registry."""
    return REGISTRY.counter(name, help, label_names)


def gauge(name, help, label_names=()):
    return REGISTRY.gauge(name, help, label_names)


def histogram(name, help, label_names=(), buckets=DEFAULT_TIME_BUCKETS):
    return REGISTRY.histogram(name, help, label_names, buckets=buckets)


def collect():
    return REGISTRY.collect()


def scrape(openmetrics=False):
    return REGISTRY.scrape(openmetrics=openmetrics)


def dump(path):
    return REGISTRY.dump(path)


def reset():
    REGISTRY.reset()


def merge_collected(snapshots):
    """Merge N :func:`collect`-shaped snapshots into one: counters sum
    exactly, histograms add bucket-additively (``sum``/``count``
    included), gauges take the max.  The implementation lives in
    :mod:`.fleet` because the fleet collector must stay
    stdlib-only at import — this is the package-facing alias the
    in-process callers use."""
    from . import fleet as _fleet

    return _fleet.merge_metrics(snapshots)


# ---------------------------------------------------------------------------
# span events
# ---------------------------------------------------------------------------

def span(name, hist=None, **labels):
    """Timed scope: observes its duration into ``hist`` (when telemetry
    is on), into the hierarchical trace ring buffer (``MXNET_TRACE=1``;
    the labels double as span args), and into the profiler
    timeline/aggregate-stats table (``aggregate_stats=True``) — one
    context manager feeds all three so dashboards, traces, and
    chrome-dumps agree.  Thin wrapper over :class:`tracing.span`, where
    the semantics are documented (a scope that exits via an exception
    observes nothing into ``hist``; the trace span IS recorded, with
    ``status="error"``)."""
    from . import tracing as _tracing

    return _tracing.span(name, hist=hist, **labels)


# ---------------------------------------------------------------------------
# metric catalog (import-time: the name-lint guard test walks REGISTRY)
# ---------------------------------------------------------------------------

# training (label loop: "sharded" = ShardedTrainer, "module" = Module.fit)
TRAIN_STEP_SECONDS = histogram(
    "mxnet_tpu_train_step_seconds",
    "Train-step wall time (dispatch+commit; includes device execution "
    "whenever the non-finite guard syncs on the loss).", ("loop",))
TRAIN_STEPS = counter(
    "mxnet_tpu_train_steps_total", "Train steps completed.", ("loop",))
TRAIN_SKIPPED_STEPS = counter(
    "mxnet_tpu_train_skipped_steps_total",
    "Updates discarded by the non-finite step guard.", ("loop",))
TRAIN_RESUMES = counter(
    "mxnet_tpu_train_resumes_total",
    "Auto-resumes from a checkpoint at training start.")
TRAIN_EPOCHS = counter(
    "mxnet_tpu_train_epochs_total", "Epochs completed by Module.fit.")
TRAIN_SAMPLES_PER_SEC = gauge(
    "mxnet_tpu_train_samples_per_second",
    "Throughput of the most recent train step.")
TRAIN_LOSS = gauge(
    "mxnet_tpu_train_loss",
    "Most recent train-step loss (under MXNET_ASYNC_METRICS this is "
    "the last COMPLETED background fetch, typically a few steps behind "
    "the dispatch frontier — never a forced device sync).")
HOST_GAP_SECONDS = histogram(
    "mxnet_tpu_host_gap_seconds",
    "Dispatch-to-dispatch host idle: wall time between one train "
    "step's dispatch returning and the next step's dispatch starting "
    "(data wait + host-side metric/bookkeeping cost).  The chip is "
    "only guaranteed busy across the gap when dispatch runs ahead "
    "(async metrics / fused K-step loop); large values bound the "
    "utilization lost to the host.", ("loop",))
ASYNC_FETCH_INFLIGHT = gauge(
    "mxnet_tpu_async_fetch_inflight",
    "Device->host metric fetches currently in flight (bounded queue "
    "depth of the background metric fetcher; submits past the bound "
    "backpressure the dispatch loop).")
ASYNC_METRIC_FETCHES = counter(
    "mxnet_tpu_async_metric_fetches_total",
    "Completed background metric fetches (each transfers one "
    "device-resident accumulator covering metrics_every steps).")
PREFETCH_STALLS = counter(
    "mxnet_tpu_device_prefetch_stalls_total",
    "Times the training loop reached io.DevicePrefetcher before a "
    "staged batch was ready (the input pipeline, not the chip, was "
    "the bottleneck for that step).")
PREFETCH_WAIT_SECONDS = histogram(
    "mxnet_tpu_device_prefetch_wait_seconds",
    "Wall time the training loop spent blocked at the "
    "io.DevicePrefetcher handoff waiting for the input pipeline "
    "(observed only on stalls; the data_wait bucket of "
    "perf_ledger.StepBreakdown and the heartbeat line).")
TRAIN_STEP_FLOPS = gauge(
    "mxnet_tpu_train_step_flops",
    "XLA cost-analysis FLOPs of the compiled train step.")
TRAIN_MFU = gauge(
    "mxnet_tpu_train_mfu_ratio",
    "Model FLOPs utilization: step_flops / step_seconds / peak_flops "
    "(peak from set_peak_flops, MXNET_PEAK_TFLOPS, or docs/"
    "mfu_probe.json).")
# mesh / sharding (parallel.mesh + parallel.train; see docs/sharding.md)
MESH_DEVICES = gauge(
    "mxnet_tpu_mesh_devices",
    "Devices per named axis of the most recently constructed mesh "
    "(parallel.mesh.make_mesh).", ("axis",))
COLLECTIVE_BYTES = counter(
    "mxnet_tpu_collective_bytes_total",
    "Estimated payload bytes moved by mesh collectives, by axis and op "
    "(psum = per-step gradient reduction over the data axes, "
    "all_gather = fsdp parameter regathers, ppermute = ring-attention "
    "K/V hops, all_to_all = MoE dispatch / Ulysses re-shard).  "
    "Host-side accounting from array sizes at dispatch, not NIC "
    "counters — exact for payload attribution, not wire overhead.",
    ("axis", "op"))
TRAIN_STATE_BYTES = gauge(
    "mxnet_tpu_train_state_bytes",
    "Per-device parameter + optimizer-state bytes actually resident "
    "after ShardedTrainer placement (addressable-shard accounting): "
    "the fsdp-vs-replicated memory win, readable on backends whose "
    "allocator reports no HBM stats.", ("device",))
CHECKPOINT_RESHARDS = counter(
    "mxnet_tpu_checkpoint_reshards_total",
    "Checkpoint restores whose saved mesh topology/layout differed "
    "from the restoring trainer's (arrays were resplit onto the new "
    "topology on load — elastic resume).")
# mixed precision (dtype_policy.py; see docs/mixed_precision.md)
DTYPE_POLICY_INFO = gauge(
    "mxnet_tpu_dtype_policy_info",
    "Constant-1 info gauge for the dtype policy active at each build "
    "site (trainer/executor/cachedop/predictor): the label carries the "
    "policy tag, so a scrape shows which precision recipe every "
    "compiled program was built under.", ("policy", "where"))
LOSS_SCALE = gauge(
    "mxnet_tpu_loss_scale",
    "Current dynamic loss scale of the training run (device-resident; "
    "under MXNET_ASYNC_METRICS the value is from the last completed "
    "background fetch).")
LOSS_SCALE_BACKOFFS = counter(
    "mxnet_tpu_loss_scale_backoffs_total",
    "Scaled-overflow steps: the update was discarded in-graph (the "
    "non-finite select), the loss scale multiplied by "
    "MXNET_LOSS_SCALE_BACKOFF, and the finite-step streak reset.")
DTYPE_CAST_BYTES = counter(
    "mxnet_tpu_dtype_cast_bytes_total",
    "Parameter bytes cast to the policy compute dtype per train step "
    "(host-side accounting from array sizes: the per-step cast traffic "
    "a dtype policy adds, fused by XLA into the first consumer).",
    ("policy",))
FUSION_REWRITES = counter(
    "mxnet_tpu_fusion_rewrites_total",
    "Graph-fusion rewrites fired at bind/hybridize/trace time, by "
    "pattern (symbol/fusion.py registry; gated by the shape-keyed "
    "cost table).", ("pattern",))

# compile path (fed by jit.Compiled through note_compile)
COMPILE_SECONDS = histogram(
    "mxnet_tpu_compile_seconds", "Backend (XLA) compile wall time.")
COMPILES = counter(
    "mxnet_tpu_compiles_total", "Backend (XLA) compilations.")
COMPILE_CACHE_HITS = counter(
    "mxnet_tpu_compile_cache_hits_total",
    "Persistent compilation-cache hits.")
COMPILE_CACHE_MISSES = counter(
    "mxnet_tpu_compile_cache_misses_total",
    "Persistent compilation-cache misses.")

# AOT executable store (aot.py) — together with the persistent-cache
# counters above this is the whole compile-cache picture: the XLA cache
# skips the backend compile, the AOT store skips trace+compile and
# survives as a deployable artifact.
AOT_CACHE_HITS = counter(
    "mxnet_tpu_aot_cache_hits_total",
    "AOT executable-store hits (serialized executable deserialized; "
    "no XLA compile).")
AOT_CACHE_MISSES = counter(
    "mxnet_tpu_aot_cache_misses_total",
    "AOT executable-store misses (compiled once, then persisted).")
AOT_SAVES = counter(
    "mxnet_tpu_aot_saves_total",
    "Executables serialized into the AOT store.")
AOT_FALLBACKS = counter(
    "mxnet_tpu_aot_fallbacks_total",
    "AOT paths degraded to plain jit, by reason (acquire/deserialize/"
    "persist/dispatch) — fallbacks cost a compile, never numerics.",
    ("reason",))
AOT_LOAD_SECONDS = histogram(
    "mxnet_tpu_aot_load_seconds",
    "Wall time to lower + load a stored executable on an AOT hit "
    "(the warm-start cost the cold compile is replaced by).")
AOT_COMPILE_SECONDS = histogram(
    "mxnet_tpu_aot_compile_seconds",
    "Wall time of AOT-path XLA compiles (misses).")

# checkpointing
CHECKPOINT_SAVE_SECONDS = histogram(
    "mxnet_tpu_checkpoint_save_seconds",
    "Checkpoint serialize+fsync+rename time.", ("mode",))
CHECKPOINT_LOAD_SECONDS = histogram(
    "mxnet_tpu_checkpoint_load_seconds",
    "Checkpoint read+digest-verify time.")
CHECKPOINT_QUEUE_DEPTH = gauge(
    "mxnet_tpu_checkpoint_async_queue_depth",
    "In-flight async checkpoint saves (0 or 1: overlapping saves "
    "serialize).")
CHECKPOINT_DIGEST_FAILURES = counter(
    "mxnet_tpu_checkpoint_digest_failures_total",
    "Checkpoints rejected by digest/structure verification.")
CHECKPOINT_SHARD_DIGEST_FAILURES = counter(
    "mxnet_tpu_checkpoint_shard_digest_failures_total",
    "Sharded-checkpoint chunks rejected by per-chunk SHA-256 "
    "verification (a torn or tampered shard-<host>.npz; the load falls "
    "back to the newest intact step).")
ELASTIC_RESUMES = counter(
    "mxnet_tpu_elastic_resumes_total",
    "Resumes from a SHARDED checkpoint whose saving topology (mesh "
    "axes/layout/host count) differed from the restoring trainer's — "
    "the save-on-N / resume-on-M path.")
CHECKPOINT_LAST_STEP = gauge(
    "mxnet_tpu_checkpoint_last_step",
    "Step of the most recently COMMITTED checkpoint (manifest "
    "written); 0 until the first commit in this process.")
CHECKPOINT_LAST_UNIXTIME = gauge(
    "mxnet_tpu_checkpoint_last_unixtime",
    "Unix time of the most recent checkpoint commit (manifest age = "
    "now - this; 0 until the first commit in this process).")
CHECKPOINT_SHARDS = gauge(
    "mxnet_tpu_checkpoint_shards",
    "Shard files in the most recently committed checkpoint (1 for a "
    "dense save, n_processes for a sharded one).")

# serving
SERVING_REQUESTS = counter(
    "mxnet_tpu_serving_requests_total",
    "Batches submitted to Predictor.predict.")
SERVING_REQUEST_SECONDS = histogram(
    "mxnet_tpu_serving_request_seconds",
    "Per-batch latency: upload submission to output yield.")
SERVING_BATCH_SIZE = histogram(
    "mxnet_tpu_serving_batch_size",
    "Valid rows per submitted batch.", buckets=BATCH_SIZE_BUCKETS)
SERVING_IN_FLIGHT = gauge(
    "mxnet_tpu_serving_in_flight",
    "Batches uploaded but not yet yielded.")
SERVING_ERRORS = counter(
    "mxnet_tpu_serving_errors_total",
    "Predictor failures by kind (contract = shape/dtype violation, "
    "transfer = host->device upload).", ("kind",))

SERVING_REQUEST_ERRORS = counter(
    "mxnet_tpu_serving_request_errors_total",
    "Predictor failures by kind AND request id (the greppable "
    "per-request view; errors only, and past 128 distinct ids new "
    "failures land in request_id=\"overflow\" so sustained failure "
    "cannot grow the registry without bound).", ("kind", "request_id"))

# async serving tier (serving_async.AsyncPredictor)
SERVING_ASYNC_REQUESTS = counter(
    "mxnet_tpu_serving_async_requests_total",
    "Requests admitted past AsyncPredictor admission control.")
SERVING_SHED = counter(
    "mxnet_tpu_serving_shed_total",
    "Requests rejected at admission by reason (queue = queue full, "
    "inflight = in-flight cap, wait = estimated wait over SLO, "
    "slo = burn-rate shedding, unhealthy = no healthy replica, "
    "shutdown = predictor closed).", ("reason",))
SERVING_DEADLINE_EXCEEDED = counter(
    "mxnet_tpu_serving_deadline_exceeded_total",
    "Requests failed by their deadline, by stage (queue = expired "
    "waiting via the sweep, pickup = expired at batch-former pickup, "
    "dispatch = expired while a replica was computing, completion = "
    "result arrived too late).", ("stage",))
SERVING_QUEUE_DEPTH = gauge(
    "mxnet_tpu_serving_queue_depth",
    "AsyncPredictor requests waiting in the bounded queue.")
SERVING_QUEUE_WAIT_SECONDS = histogram(
    "mxnet_tpu_serving_queue_wait_seconds",
    "Admission to batch-former pickup wait per request.")
SERVING_DISPATCH_ROWS = histogram(
    "mxnet_tpu_serving_dispatch_rows",
    "Valid rows packed into one replica dispatch by the batch former "
    "(capacity = chain x batch rows).", buckets=BATCH_SIZE_BUCKETS)
SERVING_REPLICA_EJECTIONS = counter(
    "mxnet_tpu_serving_replica_ejections_total",
    "Replicas ejected from AsyncPredictor rotation, by reason "
    "(error = dispatch raised, stall = watchdog timeout).", ("reason",))
SERVING_REPLICAS_HEALTHY = gauge(
    "mxnet_tpu_serving_replicas_healthy",
    "AsyncPredictor replicas currently accepting dispatches.")
SERVING_REQUEST_RETRIES = counter(
    "mxnet_tpu_serving_request_retries_total",
    "Requests requeued onto a healthy replica after an ejection.")
SERVING_AUTOHEALS = counter(
    "mxnet_tpu_serving_autoheals_total",
    "Ejected replicas re-admitted automatically after a successful "
    "canary dispatch (mode: warm_pool = pre-built spare installed, "
    "probe = the ejected replica itself recovered).", ("mode",))
SERVING_WARM_POOL_SPARES = gauge(
    "mxnet_tpu_serving_warm_pool_spares",
    "Pre-built spare replicas available to heal the next ejection.")

# LM generation / decode tier (generate.GenerationEngine + TokenServer;
# see docs/lm_serving.md) — scraped through the /metrics endpoint
# so the serving dashboards see the decode tier next to predict
DECODE_ACTIVE_SLOTS = gauge(
    "mxnet_tpu_decode_active_slots",
    "Decode slots (KV-cache lanes) currently generating a sequence.")
DECODE_CACHE_TOKENS = gauge(
    "mxnet_tpu_decode_cache_tokens",
    "Tokens resident across all active KV-cache lanes (occupancy = "
    "this over slots x cache_len; GenerationEngine.occupancy()).")
DECODE_EVICTIONS = counter(
    "mxnet_tpu_decode_evictions_total",
    "Sequences evicted from their decode slot, by reason (eos = "
    "sampled the EOS token, deadline = per-request deadline hit "
    "mid-generation, length = max_new_tokens/position cap, cancelled "
    "= future cancelled, drain = server shutdown).", ("reason",))
DECODE_QUEUE_DEPTH = gauge(
    "mxnet_tpu_decode_queue_depth",
    "TokenServer prompts waiting in the bounded admission queue.")
DECODE_QUEUE_WAIT_SECONDS = histogram(
    "mxnet_tpu_decode_queue_wait_seconds",
    "Submit to prefill-pickup wait per generation request.")
DECODE_TTFT_SECONDS = histogram(
    "mxnet_tpu_decode_ttft_seconds",
    "Time-to-first-token: submit to the prefill-sampled first token "
    "(the latency a decode client feels first; feeds the TokenServer "
    "TTFT burn-rate shedder).")
DECODE_TOKENS = counter(
    "mxnet_tpu_decode_tokens_total",
    "Tokens generated across all decode slots.")
DECODE_STEP_SECONDS = histogram(
    "mxnet_tpu_decode_step_seconds",
    "Wall time of one fixed-shape decode dispatch (all slots advance "
    "one token).")
DECODE_BATCH_TOKENS = histogram(
    "mxnet_tpu_decode_batch_tokens",
    "Active slots per decode step (the continuous-batching batch-size "
    "histogram: how full the fixed-shape step runs).",
    buckets=BATCH_SIZE_BUCKETS)
DECODE_REQUESTS_FINISHED = counter(
    "mxnet_tpu_decode_requests_finished_total",
    "Generation requests resolved successfully, by finish reason "
    "(eos / length).", ("reason",))
DECODE_PAGES_IN_USE = gauge(
    "mxnet_tpu_decode_pages_in_use",
    "Distinct KV page-pool pages referenced by live decode slots "
    "(PagedGenerationEngine; trash page and retained-but-idle prefix "
    "pages excluded).")
DECODE_PREFIX_LOOKUP_TOKENS = counter(
    "mxnet_tpu_decode_prefix_lookup_tokens_total",
    "Prompt tokens eligible for prefix-cache attachment at admission "
    "(full-page-aligned prefix positions; the prefix hit rate's "
    "denominator).")
DECODE_PREFIX_HIT_TOKENS = counter(
    "mxnet_tpu_decode_prefix_hit_tokens_total",
    "Prompt tokens served by attaching shared prefix pages instead of "
    "re-prefilling (the prefix hit rate's numerator).")
DECODE_PREFILL_CHUNKS = counter(
    "mxnet_tpu_decode_prefill_chunks_total",
    "Fixed-size prefill chunk dispatches (chunked prefill interleaves "
    "these with decode steps so long admissions never stall active "
    "lanes).")
DECODE_SPEC_DRAFTED = counter(
    "mxnet_tpu_decode_spec_drafted_total",
    "Tokens drafted by the n-gram speculator and carried into verify "
    "steps.")
DECODE_SPEC_ACCEPTED = counter(
    "mxnet_tpu_decode_spec_accepted_total",
    "Drafted tokens accepted by exact-match verification (acceptance "
    "rate = this over drafted; each accepted token is one decode "
    "dispatch saved).")

# device memory (sampled per train step by tracing.sample_device_memory)
DEVICE_MEMORY_BYTES_IN_USE = gauge(
    "mxnet_tpu_device_memory_bytes_in_use",
    "Live HBM bytes per device at the last sample "
    "(profiler.device_memory_stats; 0 when the backend reports none).",
    ("device",))
DEVICE_MEMORY_PEAK_BYTES = gauge(
    "mxnet_tpu_device_memory_peak_bytes",
    "Peak HBM bytes per device since process start at the last sample.",
    ("device",))

# profiler / tracing facade
PROFILER_EVENTS_DROPPED = counter(
    "mxnet_tpu_profiler_events_dropped_total",
    "Timeline events evicted oldest-first at the profiler event cap.")
TRACE_SPANS_DROPPED = counter(
    "mxnet_tpu_trace_spans_dropped_total",
    "Spans evicted oldest-first at the trace ring-buffer cap "
    "(MXNET_TRACE_BUFFER).")
FLIGHT_BUNDLES = counter(
    "mxnet_tpu_flight_recorder_bundles_total",
    "Flight-recorder postmortem bundles written, by trigger reason.",
    ("reason",))

# wide-event layer (events.py; see docs/observability.md)
EVENTS_EMITTED = counter(
    "mxnet_tpu_events_emitted_total",
    "Wide events kept (post-sampling) by unit-of-work kind.", ("kind",))
EVENTS_SAMPLED_OUT = counter(
    "mxnet_tpu_events_sampled_out_total",
    "OK-outcome wide events discarded by head sampling "
    "(MXNET_EVENTS_SAMPLE; errors/sheds/deadline/tail are never "
    "sampled out).")
EVENTS_DROPPED = counter(
    "mxnet_tpu_events_dropped_total",
    "Wide events lost at the bounded writer queue (or to a failed "
    "write): the event layer sheds evidence under pressure, it never "
    "blocks the request path.")
EVENTS_WRITTEN = counter(
    "mxnet_tpu_events_written_total",
    "Wide events committed to the MXNET_EVENTS_PATH JSONL stream.")

# HTTP serving gateway (gateway.py; see docs/serving_gateway.md)
GATEWAY_REQUESTS = counter(
    "mxnet_tpu_gateway_requests_total",
    "HTTP inference requests received by the gateway, per tenant "
    "(counted at arrival, before any admission decision).", ("tenant",))
GATEWAY_RESPONSES = counter(
    "mxnet_tpu_gateway_responses_total",
    "Gateway responses by final wire status code (the lm_serving.md "
    "contract: 429 shed, 503 shutdown, 504 deadline, 499 client "
    "disconnect).", ("code",))
GATEWAY_REQUEST_SECONDS = histogram(
    "mxnet_tpu_gateway_request_seconds",
    "Wall seconds per gateway request, arrival to final byte (or "
    "error), whatever the outcome.")
GATEWAY_OPEN_STREAMS = gauge(
    "mxnet_tpu_gateway_open_streams",
    "Requests currently dispatched to a backend (SSE streams plus "
    "in-flight predicts); drain waits on this reaching zero.")
GATEWAY_QUEUE_WAIT_SECONDS = histogram(
    "mxnet_tpu_gateway_queue_wait_seconds",
    "Seconds a request waited in the weighted-fair queue for a "
    "dispatch permit (admitted requests only).")
GATEWAY_QUOTA_SHED = counter(
    "mxnet_tpu_gateway_quota_shed_total",
    "Requests 429d by the per-tenant token-bucket quota "
    "(MXNET_GATEWAY_QUOTA_QPS), per tenant.", ("tenant",))
GATEWAY_CLIENT_DISCONNECTS = counter(
    "mxnet_tpu_gateway_client_disconnects_total",
    "Clients that vanished mid-response; each one cancels its backend "
    "request (decode-slot eviction, never a leaked lane).")
GATEWAY_BAD_REQUESTS = counter(
    "mxnet_tpu_gateway_bad_requests_total",
    "Requests refused at the wire before reaching admission, by kind "
    "(malformed, oversized, truncated, slow_body, bad_deadline).",
    ("kind",))
GATEWAY_ROUTE_FLIPS = counter(
    "mxnet_tpu_gateway_route_flips_total",
    "Routing-table changes by operation (deploy, rollback, canary).",
    ("op",))
GATEWAY_STREAM_TOKENS = counter(
    "mxnet_tpu_gateway_stream_tokens_total",
    "Tokens written to clients as SSE frames across all streams.")

# Fleet observatory (fleet.py; see docs/observability.md)
FLEET_SNAPSHOTS = counter(
    "mxnet_tpu_fleet_snapshots_total",
    "Fleet snapshots this rank committed to the spool dir (payload "
    "plus digest sidecar, the durability mark).")
FLEET_PUBLISH_SECONDS = histogram(
    "mxnet_tpu_fleet_publish_seconds",
    "Wall seconds per fleet snapshot publish (collect + breakdown + "
    "atomic write + sidecar); the observatory's own overhead.")
FLEET_PUBLISH_ERRORS = counter(
    "mxnet_tpu_fleet_publish_errors_total",
    "Fleet snapshot publishes that failed (spool unwritable, "
    "serialization error); counted and logged, never raised into the "
    "step loop.")
FLEET_TORN_SNAPSHOTS = counter(
    "mxnet_tpu_fleet_torn_snapshots_total",
    "Torn or partial spool snapshots the collector skipped (missing "
    "sidecar, digest mismatch, unparsable payload) — the read_ledger "
    "torn-line discipline applied to the fleet spool.")

# Goodput ledger (goodput.py; see docs/observability.md)
GOODPUT_SEGMENTS = counter(
    "mxnet_tpu_goodput_segments_total",
    "Typed wall-clock segments this incarnation appended to its "
    "goodput ledger, by kind (productive_step, compile, ckpt_save, "
    "ckpt_restore, data_wait, startup, drain).",
    ("kind",))
GOODPUT_WRITE_ERRORS = counter(
    "mxnet_tpu_goodput_write_errors_total",
    "Goodput ledger appends or sidecar flushes that failed (job dir "
    "unwritable); counted and logged once, never raised into the "
    "step loop.")
GOODPUT_TORN_LINES = counter(
    "mxnet_tpu_goodput_torn_lines_total",
    "Torn or unparsable goodput ledger lines (and prefix-digest "
    "mismatches) the reader skipped with a counted problem — the "
    "read_ledger torn-line discipline applied to the goodput job dir.")


# ---------------------------------------------------------------------------
# compile feed (the JAX package's jax.monitoring bridge)
# ---------------------------------------------------------------------------

def note_compile(duration_secs):
    """One backend compile of ``duration_secs``: ``jit.Compiled`` calls
    this on the first call of each key (trace, compile and one run).
    Observes :data:`COMPILES` / :data:`COMPILE_SECONDS` and feeds the
    goodput ledger's compile bucket (a no-op unless a recorder is live;
    silent while ``goodput.compile_guard()`` is held, whose holder owns
    the compile segment)."""
    if not _enabled:
        return
    COMPILES.inc()
    COMPILE_SECONDS.observe(duration_secs)
    gp = sys.modules.get("mxnet_tpu_torch.goodput")
    if gp is not None:
        try:
            gp.record_compile(duration_secs)
        except Exception:
            pass


def note_compile_cache(hits, misses):
    """The persistent compile cache's hits and misses of one compile
    (``jit.Compiled``, from dynamo's inductor and AOTAutograd counters):
    :data:`COMPILE_CACHE_HITS` / :data:`COMPILE_CACHE_MISSES`."""
    if not _enabled:
        return
    if hits:
        COMPILE_CACHE_HITS.inc(hits)
    if misses:
        COMPILE_CACHE_MISSES.inc(misses)


# ---------------------------------------------------------------------------
# MFU peak-FLOPs resolution
# ---------------------------------------------------------------------------

_peak_flops = None       # explicit set_peak_flops value
_peak_resolved = None    # cached (found, value) from env


def set_peak_flops(flops_per_sec):
    """Pin the accelerator peak FLOP/s used by the MFU gauge (overrides
    MXNET_PEAK_TFLOPS).  Pass None to unpin."""
    global _peak_flops, _peak_resolved
    _peak_flops = None if flops_per_sec is None else float(flops_per_sec)
    _peak_resolved = None


def peak_flops():
    """Best-known accelerator peak FLOP/s, or None.

    Resolution order: :func:`set_peak_flops` > ``MXNET_PEAK_TFLOPS`` env
    flag.  With neither, None: the MFU gauge stays unset (the port reads
    no measured-ceiling artifact; ``docs/mfu_probe.json`` is a TPU's).
    """
    global _peak_resolved
    if _peak_flops is not None:
        return _peak_flops
    if _peak_resolved is not None:
        return _peak_resolved[1]
    val = None
    raw = _config.get("MXNET_PEAK_TFLOPS")
    if raw:
        try:
            val = float(raw) * 1e12
        except ValueError:
            pass
    _peak_resolved = (val is not None, val)
    return val


# ---------------------------------------------------------------------------
# live introspection: /statusz subsystems, /varz, readiness
# ---------------------------------------------------------------------------

_status_providers = {}     # name -> callable() -> dict (merged in)
_readiness_checks = {}     # name -> callable() -> bool


def register_status_provider(name, fn):
    """Register a subsystem snapshot callable for :func:`statusz`.
    The dict it returns is merged over the built-in view of the same
    subsystem name; a raising provider is reported, never fatal."""
    _status_providers[str(name)] = fn


def unregister_status_provider(name):
    _status_providers.pop(str(name), None)


def register_readiness(name, fn):
    """Register a readiness check for ``/healthz``: a callable
    returning truthy when the subsystem can take traffic.  With any
    registered check failing, /healthz answers 503 — the signal a
    fleet scheduler drains on (serving tiers register themselves, so
    readiness flips during drained shutdown).  No checks registered =
    process-up = ready (the historical behavior)."""
    _readiness_checks[str(name)] = fn


def unregister_readiness(name):
    _readiness_checks.pop(str(name), None)


def readiness():
    """(ready, {check_name: bool}) over every registered check — a
    raising check counts as not ready (fail closed: a broken serving
    tier must not keep taking traffic)."""
    checks = {}
    for name, fn in sorted(_readiness_checks.items()):
        try:
            checks[name] = bool(fn())
        except Exception:
            checks[name] = False
    return all(checks.values()), checks


def _label_values(metric, label):
    """{label_value: series value} over a one-label counter/gauge."""
    out = {}
    for labels in metric.series_labels():
        if labels:
            out[labels[label]] = metric.value(**labels)
    return out


def iso_age_seconds(stamp):
    """Age in seconds of an ISO-8601 timestamp (naive stamps read as
    UTC), or None when unparseable — the shared staleness arithmetic
    of the /statusz providers (AOT manifest age, fusion-table age)."""
    if not stamp:
        return None
    import datetime

    try:
        created = datetime.datetime.fromisoformat(str(stamp))
    except ValueError:
        return None
    if created.tzinfo is None:
        created = created.replace(tzinfo=datetime.timezone.utc)
    now = datetime.datetime.now(datetime.timezone.utc)
    return round((now - created).total_seconds(), 1)


def statusz():
    """One JSON-able snapshot of every runtime subsystem — the
    ``/statusz`` payload.

    Schema-stable: the core subsystem keys (``aot``, ``fusion``,
    ``serving``, ``decode``, ``gateway``, ``checkpoint``, ``events``,
    ``process``)
    are always present, built from the always-registered metric
    catalog; live objects (AOT store, fusion table, AsyncPredictors,
    TokenServers, event writer) enrich their subsystem through
    :func:`register_status_provider`.
    """
    t = time.time()
    subs = {
        "process": {"pid": os.getpid(), "time": round(t, 3),
                    "telemetry_enabled": _enabled},
        "aot": {
            "hits": AOT_CACHE_HITS.value(),
            "misses": AOT_CACHE_MISSES.value(),
            "saves": AOT_SAVES.value(),
            "fallbacks": _label_values(AOT_FALLBACKS, "reason"),
        },
        "fusion": {
            "rewrites": _label_values(FUSION_REWRITES, "pattern"),
        },
        "serving": {
            "replicas_healthy": SERVING_REPLICAS_HEALTHY.value(),
            "warm_pool_spares": SERVING_WARM_POOL_SPARES.value(),
            "queue_depth": SERVING_QUEUE_DEPTH.value(),
            "in_flight": SERVING_IN_FLIGHT.value(),
            "shed": _label_values(SERVING_SHED, "reason"),
            "deadline_exceeded": _label_values(
                SERVING_DEADLINE_EXCEEDED, "stage"),
            "autoheals": _label_values(SERVING_AUTOHEALS, "mode"),
        },
        "decode": {
            "active_slots": DECODE_ACTIVE_SLOTS.value(),
            "cache_tokens": DECODE_CACHE_TOKENS.value(),
            "queue_depth": DECODE_QUEUE_DEPTH.value(),
            "tokens_total": DECODE_TOKENS.value(),
            "ttft_p99_ms": (lambda q: round(q * 1e3, 3)
                            if q is not None else None)(
                DECODE_TTFT_SECONDS.quantile(0.99)),
            "evictions": _label_values(DECODE_EVICTIONS, "reason"),
            # paged-engine view (zeros until a PagedGenerationEngine
            # runs): page-pool fill, prefix-cache effectiveness, and
            # the speculative-decoding win per verify dispatch
            "pages_in_use": DECODE_PAGES_IN_USE.value(),
            "prefill_chunks": DECODE_PREFILL_CHUNKS.value(),
            "prefix_hit_rate": (lambda hit, seen: round(hit / seen, 4)
                                if seen else None)(
                DECODE_PREFIX_HIT_TOKENS.value(),
                DECODE_PREFIX_LOOKUP_TOKENS.value()),
            "spec_accept_rate": (lambda acc, drafted:
                                 round(acc / drafted, 4)
                                 if drafted else None)(
                DECODE_SPEC_ACCEPTED.value(),
                DECODE_SPEC_DRAFTED.value()),
        },
        "checkpoint": {
            "async_queue_depth": CHECKPOINT_QUEUE_DEPTH.value(),
            "digest_failures": CHECKPOINT_DIGEST_FAILURES.value(),
            "shard_digest_failures":
                CHECKPOINT_SHARD_DIGEST_FAILURES.value(),
            "saves": (CHECKPOINT_SAVE_SECONDS.count(mode="sync")
                      + CHECKPOINT_SAVE_SECONDS.count(mode="async")),
            "loads": CHECKPOINT_LOAD_SECONDS.count(),
            "reshards": CHECKPOINT_RESHARDS.value(),
            "elastic_resumes": ELASTIC_RESUMES.value(),
            "last_committed_step": int(CHECKPOINT_LAST_STEP.value()),
            "manifest_age_s": (
                round(time.time() - CHECKPOINT_LAST_UNIXTIME.value(), 3)
                if CHECKPOINT_LAST_UNIXTIME.value() else None),
            "shard_count": int(CHECKPOINT_SHARDS.value()),
        },
        "gateway": {
            "requests": _label_values(GATEWAY_REQUESTS, "tenant"),
            "responses": _label_values(GATEWAY_RESPONSES, "code"),
            "open_streams": GATEWAY_OPEN_STREAMS.value(),
            "quota_shed": _label_values(GATEWAY_QUOTA_SHED, "tenant"),
            "client_disconnects": GATEWAY_CLIENT_DISCONNECTS.value(),
            "bad_requests": _label_values(GATEWAY_BAD_REQUESTS, "kind"),
            "route_flips": _label_values(GATEWAY_ROUTE_FLIPS, "op"),
            "stream_tokens": GATEWAY_STREAM_TOKENS.value(),
        },
        "events": {"enabled": False},
        "fleet": {"active": False},
        "goodput": {"active": False},
    }
    try:
        # events, fleet and goodput register their providers on
        # import; importing here makes the subsystems live even when
        # nothing else pulled them in
        from . import events as _events  # noqa: F401
        from . import fleet as _fleet  # noqa: F401
        from . import goodput as _goodput  # noqa: F401
    except Exception:
        pass
    for name, fn in sorted(_status_providers.items()):
        try:
            view = fn()
        except Exception as e:
            view = {"provider_error": "%s: %s" % (type(e).__name__, e)}
        if isinstance(view, dict):
            subs.setdefault(name, {}).update(view)
        else:
            subs[name] = view
    ready, checks = readiness()
    out = {"format_version": 1, "time": round(t, 3),
           "pid": os.getpid(), "ready": ready, "readiness": checks,
           "subsystems": subs}
    try:
        from . import tracing as _tracing

        out["trace_id"] = _tracing.TRACE_ID
    except Exception:
        pass
    return out


def varz():
    """Resolved configuration knobs (the ``/varz`` payload): every
    registered ``MXNET_*``/``DMLC_*`` flag with its *parsed, effective*
    value — what the process is actually running with, env overrides
    applied."""
    return {name: _config.get(name) for name in sorted(_config.FLAGS)}


# ---------------------------------------------------------------------------
# Prometheus HTTP scrape endpoint
# ---------------------------------------------------------------------------

_scrape_server = None
_scrape_lock = threading.Lock()


class _ScrapeServer:
    """Background HTTP server exposing the registry + introspection.

    Routes:

    * ``/metrics`` — Prometheus text exposition (the :func:`scrape`
      body, exemplar-bearing when tracing is on);
    * ``/healthz`` — readiness probe: 200 "ok" while every registered
      :func:`register_readiness` check passes (none registered =
      process-up = ready), **503** with a JSON body naming the failing
      checks otherwise — flips during drained serving shutdown and
      before the first replica is ready, the contract fleet schedulers
      gate rollout on;
    * ``/statusz`` — one JSON snapshot of every runtime subsystem
      (:func:`statusz`);
    * ``/requestz`` — the last-N sampled wide events
      (``?n=`` caps the window; ``events.recent``);
    * ``/varz`` — resolved config knobs (:func:`varz`).

    Everything else is 404.  Daemon threads; :meth:`stop` is
    synchronous.
    """

    def __init__(self, port, host="0.0.0.0"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                path, _, query = self.path.partition("?")
                status = 200
                if path == "/metrics":
                    # content negotiation: exemplars are OpenMetrics
                    # syntax, which the classic 0.0.4 text parser
                    # rejects — only clients that ask for OpenMetrics
                    # (modern Prometheus does) get them
                    accept = self.headers.get("Accept", "")
                    om = "application/openmetrics-text" in accept
                    body = scrape(openmetrics=om).encode("utf-8")
                    ctype = ("application/openmetrics-text; "
                             "version=1.0.0; charset=utf-8") if om \
                        else "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/healthz":
                    ready, checks = readiness()
                    if ready:
                        body = b"ok\n"
                        ctype = "text/plain; charset=utf-8"
                    else:
                        status = 503
                        body = _json_body({
                            "ready": False,
                            "failing": sorted(k for k, v in checks.items()
                                              if not v),
                            "checks": checks})
                        ctype = "application/json; charset=utf-8"
                elif path == "/statusz":
                    body = _json_body(statusz())
                    ctype = "application/json; charset=utf-8"
                elif path == "/requestz":
                    n = 64
                    for part in query.split("&"):
                        if part.startswith("n="):
                            try:
                                n = max(1, int(part[2:]))
                            except ValueError:
                                pass
                    from . import events as _events

                    body = _json_body({
                        "stats": _events.stats(),
                        "events": _events.recent(n)})
                    ctype = "application/json; charset=utf-8"
                elif path == "/varz":
                    body = _json_body(varz())
                    ctype = "application/json; charset=utf-8"
                elif path == "/fleetz":
                    from urllib.parse import parse_qs

                    from . import fleet as _fleet

                    q = parse_qs(query)
                    spool = (q.get("spool") or [None])[0]
                    stale = None
                    try:
                        stale = float(q["stale_after"][0])
                    except (KeyError, IndexError, ValueError):
                        pass
                    merge = (q.get("merge") or ["1"])[0] not in ("0",
                                                                 "false")
                    body = _json_body(_fleet.fleetz(
                        spool=spool, stale_after=stale, merge=merge))
                    ctype = "application/json; charset=utf-8"
                elif path == "/goodputz":
                    from urllib.parse import parse_qs

                    from . import goodput as _goodput

                    q = parse_qs(query)
                    gdir = (q.get("dir") or [None])[0]
                    body = _json_body(_goodput.goodputz(dir=gdir))
                    ctype = "application/json; charset=utf-8"
                else:
                    self.send_error(404, "unknown path %r" % path)
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass  # scrapes are periodic; stay out of training logs

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry-scrape",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._thread.join()
        self._httpd.server_close()


def serve_scrape(port=None, host="0.0.0.0"):
    """Start (or return the already-running) scrape endpoint.

    ``port`` defaults to ``MXNET_TELEMETRY_PORT`` (0 = pick an
    ephemeral port — tests; the chosen port is on the returned
    server's ``.port``).  One server per process: a second call
    returns the live one.  Serving does not by itself enable
    collection — pair with ``MXNET_TELEMETRY=1`` / :func:`enable` for
    non-zero numbers (the exposition itself is always valid)."""
    global _scrape_server
    with _scrape_lock:
        if _scrape_server is not None:
            return _scrape_server
        if port is None:
            port = _config.get("MXNET_TELEMETRY_PORT")
        _scrape_server = _ScrapeServer(port, host=host)
        return _scrape_server


def stop_scrape():
    """Stop the scrape endpoint (no-op when none is running)."""
    global _scrape_server
    with _scrape_lock:
        srv, _scrape_server = _scrape_server, None
    if srv is not None:
        srv.stop()


def scrape_server():
    """The live :class:`_ScrapeServer`, or None."""
    return _scrape_server


# ---------------------------------------------------------------------------
# background reporter
# ---------------------------------------------------------------------------

class TelemetryReporter:
    """Opt-in background snapshot thread.

    Every ``interval`` seconds (default ``MXNET_TELEMETRY_INTERVAL``):
    writes :func:`dump` to ``path`` (when given) and calls
    ``callback(snapshot)`` with the :func:`collect` dict (when given) —
    the hook ``monitor.start_heartbeat`` uses for its one-line log.
    Daemon thread; ``stop()`` is synchronous and flushes a final
    snapshot.  Also usable as a context manager.
    """

    def __init__(self, interval=None, path=None, callback=None,
                 logger=None):
        if interval is None:
            interval = _config.get("MXNET_TELEMETRY_INTERVAL")
        self.interval = float(interval)
        if self.interval <= 0:
            raise ValueError("reporter interval must be > 0, got %r"
                             % (interval,))
        self.path = os.fspath(path) if path is not None else None
        self.callback = callback
        import logging

        self.logger = logger or logging.getLogger("mxnet_tpu_torch.telemetry")
        self._stop = threading.Event()
        self._thread = None

    def _tick(self):
        try:
            snap = None
            if self.path is not None:
                dump(self.path)
            if self.callback is not None:
                snap = collect()
                self.callback(snap)
        except Exception:
            # a broken disk or callback must never kill the reporter —
            # observability failing loudly inside the train loop would
            # be worse than the condition it reports
            self.logger.exception("telemetry snapshot failed")

    def _run(self):
        while not self._stop.wait(self.interval):
            self._tick()

    def start(self):
        if self._thread is not None:
            raise RuntimeError("reporter already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="telemetry-reporter",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Signal the thread, join it, and write one final snapshot."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join()
        self._thread = None
        self._tick()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


if _config.get("MXNET_TELEMETRY"):
    enable()

if _config.get("MXNET_TELEMETRY_PORT") > 0:
    # env-configured scrape endpoint: up for the process lifetime (the
    # /healthz probe must outlive any one trainer/predictor object);
    # a port conflict warns instead of killing the training process
    try:
        serve_scrape()
    except OSError as e:
        import warnings

        warnings.warn("MXNET_TELEMETRY_PORT=%s: scrape endpoint not "
                      "started (%s)"
                      % (_config.get("MXNET_TELEMETRY_PORT"), e))
