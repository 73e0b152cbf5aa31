"""Monitoring: per-layer stat hooks + the telemetry training heartbeat
(parity: mxnet_tpu/monitor.py).

* :class:`Monitor` — the reference-parity per-layer stat hook
  (python/mxnet/monitor.py:33 and the executor monitor callback of
  src/executor/graph_executor.cc:105): a predicate (name filter), a
  collector (the callback executors call with each output) and a drain
  (``toc``) that renders the stats; the weights are sampled again at
  every drain.
* :class:`TelemetryHeartbeat` / :func:`start_heartbeat` — one log line
  per interval summarizing the telemetry registry (step, loss, step-ms
  p50/p99, samples/s, MFU, skipped steps), driven by
  :class:`~mxnet_tpu_torch.telemetry.TelemetryReporter`.  Needs
  ``MXNET_TELEMETRY=1`` (or ``telemetry.enable()``) to have data.
"""
from __future__ import annotations

import logging
import re
import time

from . import telemetry as _telemetry
from .ndarray.ndarray import NDArray

__all__ = ["Monitor", "TelemetryHeartbeat", "start_heartbeat"]


class TelemetryHeartbeat:
    """Render one training-heartbeat line from the telemetry registry.

    Usable directly (``hb()``), or as the ``callback`` of a
    :class:`~mxnet_tpu_torch.telemetry.TelemetryReporter` (which is what
    :func:`start_heartbeat` wires up).  ``loop`` picks the step series:
    ``"sharded"`` (ShardedTrainer) or ``"module"`` (Module.fit).
    """

    def __init__(self, logger=None, loop="sharded"):
        self.logger = logger or logging.getLogger("mxnet_tpu_torch.heartbeat")
        self.loop = loop

    def line(self):
        t = _telemetry
        steps = int(t.TRAIN_STEPS.value(loop=self.loop))
        p50 = t.TRAIN_STEP_SECONDS.quantile(0.5, loop=self.loop)
        p99 = t.TRAIN_STEP_SECONDS.quantile(0.99, loop=self.loop)
        skipped = int(t.TRAIN_SKIPPED_STEPS.value(loop=self.loop))
        parts = [
            "step %d" % steps,
            "loss %.4f" % t.TRAIN_LOSS.value(),
            "step_ms p50 %.1f p99 %.1f" % (
                (p50 or 0.0) * 1e3, (p99 or 0.0) * 1e3),
            "samples/s %.1f" % t.TRAIN_SAMPLES_PER_SEC.value(),
        ]
        # live attribution split (perf_ledger.StepBreakdown buckets):
        # dispatch-to-dispatch host idle and the slice of it spent
        # blocked on the input pipeline — readable without exporting a
        # trace.  data_wait is amortized per step (it only accrues on
        # stalls, so a p50 of the stall histogram would overstate it).
        gap = t.HOST_GAP_SECONDS.quantile(0.5, loop=self.loop)
        parts.append("host_gap_ms p50 %.1f" % ((gap or 0.0) * 1e3))
        wait_ms = (t.PREFETCH_WAIT_SECONDS.sum() / steps * 1e3) \
            if steps else 0.0
        parts.append("data_wait_ms %.1f" % wait_ms)
        mfu = t.TRAIN_MFU.value()
        if mfu:
            parts.append("mfu %.1f%%" % (mfu * 100.0))
        # worst-device memory watermark (sampled per step by
        # tracing.sample_device_memory; omitted on the CPU, whose
        # allocator reports none)
        in_use = peak = 0.0
        for labels in t.DEVICE_MEMORY_BYTES_IN_USE.series_labels():
            if labels:
                in_use = max(in_use,
                             t.DEVICE_MEMORY_BYTES_IN_USE.value(**labels))
                peak = max(peak, t.DEVICE_MEMORY_PEAK_BYTES.value(**labels))
        if peak > 0:
            parts.append("hbm %.2f/%.2fGB" % (in_use / 2**30,
                                              peak / 2**30))
        # decode tier (omitted until a TokenServer has served a first
        # token): the TTFT tail the burn-rate shedder acts on, plus the
        # continuous-batching fill
        if t.DECODE_TTFT_SECONDS.count() > 0:
            ttft99 = t.DECODE_TTFT_SECONDS.quantile(0.99)
            parts.append("ttft_p99_ms %.1f" % ((ttft99 or 0.0) * 1e3))
            parts.append("slots %d" % int(t.DECODE_ACTIVE_SLOTS.value()))
            # paged-engine levers (omitted while the ring engine runs):
            # page-pool fill, prefix-cache hit rate, and the share of
            # drafted tokens the verify step accepted
            pages = int(t.DECODE_PAGES_IN_USE.value())
            if pages > 0:
                parts.append("pages %d" % pages)
            lookups = t.DECODE_PREFIX_LOOKUP_TOKENS.value()
            if lookups > 0:
                parts.append("prefix_hit %.0f%%" % (
                    100.0 * t.DECODE_PREFIX_HIT_TOKENS.value() / lookups))
            drafted = t.DECODE_SPEC_DRAFTED.value()
            if drafted > 0:
                parts.append("spec_accept %.0f%%" % (
                    100.0 * t.DECODE_SPEC_ACCEPTED.value() / drafted))
        # gateway tier (omitted until the HTTP front end has served):
        # live streams plus the shed rate — the two numbers that say
        # whether the wire is healthy or dumping load
        gw_total = sum(t.GATEWAY_RESPONSES.value(**labels)
                       for labels in
                       t.GATEWAY_RESPONSES.series_labels() if labels)
        if gw_total > 0:
            shed = sum(t.GATEWAY_RESPONSES.value(code=c)
                       for c in ("429", "503"))
            parts.append("gw_streams %d" % int(
                t.GATEWAY_OPEN_STREAMS.value()))
            parts.append("gw_shed %.0f%%" % (100.0 * shed / gw_total))
        # checkpoint lineage (omitted until a first commit): the last
        # committed step, its shard fan-out, and how stale it is — the
        # number an operator checks when deciding whether a preemption
        # is cheap (fresh manifest) or expensive (old one)
        last_ckpt = t.CHECKPOINT_LAST_UNIXTIME.value()
        if last_ckpt > 0:
            parts.append("ckpt step %d shards %d age %.0fs" % (
                int(t.CHECKPOINT_LAST_STEP.value()),
                int(t.CHECKPOINT_SHARDS.value()),
                max(0.0, time.time() - last_ckpt)))
        # fleet tier (omitted until a spool is active with >= 2 fresh
        # ranks): the pod's step-time skew and the straggler it points
        # at, so one rank's heartbeat names the slow rank pod-wide
        try:
            from . import fleet as _fleet

            hb = _fleet.heartbeat_fields()
        except Exception:
            hb = None
        if hb:
            parts.append("skew %.2fx" % hb["skew"])
            parts.append("straggler r%d:%s" % (hb["rank"],
                                               hb["bucket"] or "?"))
        # goodput tier (omitted until a job dir is active with wall
        # accrued): the job-lifetime fraction of wall-clock that became
        # training progress, across restarts — the same number
        # /goodputz and perf_report --goodput render
        try:
            from . import goodput as _goodput

            gb = _goodput.heartbeat_fields()
        except Exception:
            gb = None
        if gb:
            parts.append("goodput %.2f%%" % gb["goodput_pct"])
        parts.append("skipped %d" % skipped)
        return " ".join(parts)

    def __call__(self, snapshot=None):
        self.logger.info("heartbeat %s", self.line())


def start_heartbeat(interval=None, logger=None, path=None, loop="sharded"):
    """Start (and return) a background reporter logging one heartbeat
    line per ``interval`` seconds (default ``MXNET_TELEMETRY_INTERVAL``);
    ``path`` additionally dumps the full JSON snapshot each tick.  Call
    ``.stop()`` on the returned reporter to end it."""
    return _telemetry.TelemetryReporter(
        interval=interval, path=path,
        callback=TelemetryHeartbeat(logger=logger, loop=loop),
        logger=logger).start()



def _default_stat(x):
    """|x|₂ / sqrt(n) — the reference's asum-style magnitude stat."""
    return x.norm() / (x.size ** 0.5)


def _render(value):
    """Stat value(s) -> tab-joined display string."""
    values = value if isinstance(value, list) else [value]
    parts = []
    for v in values:
        if not isinstance(v, NDArray):
            raise TypeError("stat_func must return NDArray(s), got %r"
                            % type(v))
        scalarish = v.shape in ((), (1,))
        parts.append(str(v.asscalar() if scalarish else v.asnumpy()))
    return "\t".join(parts) + "\t"


class Monitor:
    """Samples a statistic of matching tensors every `interval` steps.

    Usage parity with the reference: ``install`` on executors (Module
    does this via ``install_monitor``), call ``tic()`` before each
    forward and ``toc_print()`` after.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.sort = sort
        self.monitor_all = monitor_all
        self._match = re.compile(pattern).match
        self._collecting = False
        self._records = []          # (step, name, stat)
        self._step = 0
        self._executors = []

    # executors call this with every intermediate (name, array)
    def stat_helper(self, name, value):
        if self._collecting and self._match(str(name)):
            self._records.append((self._step, str(name),
                                  self.stat_func(value)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper, self.monitor_all)
        self._executors.append(exe)

    @property
    def activated(self):
        return self._collecting

    def _sync_params(self):
        for exe in self._executors:
            for arr in exe.arg_arrays:
                arr.wait_to_read()

    def tic(self):
        """Arm collection if this step is on the interval."""
        if self._step % self.interval == 0:
            self._sync_params()
            self._records = []
            self._collecting = True
        self._step += 1

    def toc(self):
        """Disarm and return [(step, name, rendered stat)] collected
        since tic, plus a fresh stat of every matching parameter."""
        if not self._collecting:
            return []
        self._sync_params()
        for exe in self._executors:
            for name, arr in zip(exe._arg_names, exe.arg_arrays):
                if self._match(name):
                    self._records.append((self._step, name,
                                          self.stat_func(arr)))
        self._collecting = False
        if self.sort:
            self._records.sort(key=lambda r: r[1])
        out = [(step, name, _render(stat))
               for step, name, stat in self._records]
        self._records = []
        return out

    def toc_print(self):
        for step, name, rendered in self.toc():
            logging.info("Batch: %7d %-30s %s", step, name, rendered)
