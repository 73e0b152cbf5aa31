"""Perf observatory: versioned BENCH records, the append-only run
ledger, and step-time attribution (counterpart of mxnet_tpu/perf_ledger.py).

* **Records** — :func:`make_record` builds one versioned BENCH row
  (``schema_version``, ``metric``/``value``/``unit``, plus provenance:
  git sha, backend + device kind/count, mesh/layout, dtype policy,
  fusion-table hash, AOT warm/cold state, steps-per-call) and
  :func:`check_record` rejects malformed ones loudly.  Emitters write
  through :func:`emit`, which prints the row with the unambiguous
  ``BENCH `` line prefix and appends it to the run ledger.
* **Ledger** — an append-only JSONL file (``MXNET_PERF_LEDGER`` or an
  explicit path): one validated record per line, written with a single
  ``O_APPEND`` write + fsync so concurrent emitters can never tear a
  row.  :func:`read_ledger` returns (records, problems) — malformed
  lines are collected, not silently dropped.
* **StepBreakdown** — "where did the milliseconds go" for the train
  loop, assembled from signals the runtime already collects (step-span
  histogram, ``mxnet_tpu_host_gap_seconds``, device-prefetch wait,
  compile + AOT-load histograms, the per-axis collective bytes):
  wall time per step decomposes into device_compute / compile /
  aot_load / data_wait / host_other buckets that sum to the measured
  wall by construction.  ``ShardedTrainer.step_breakdown()`` returns
  one.

The record schema is the JAX package's, so records of both packages
pass the same :func:`validate_record` and sit in one ledger.
:data:`PROVENANCE_KEYS` is unchanged: the port fills ``backend``
(``"cuda"``/``"cpu"``), ``device_kind`` (``torch.cuda.get_device_name``)
and ``device_count`` from torch, and the two jax-version keys hold the
schema's legal ``"unknown"``.  The port has no AOT executable store yet,
so ``aot`` is ``"off"``.

Module-level imports are stdlib-only; torch, telemetry and fusion_cost
are imported lazily inside the functions that need them.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import uuid

__all__ = ["SCHEMA_VERSION", "BENCH_MARKER", "current_run_id",
           "provenance", "make_record", "validate_record", "check_record",
           "emit", "append", "read_ledger", "ledger_path",
           "parse_bench_lines", "StepBreakdown"]

SCHEMA_VERSION = 1

# the one line prefix every emitter marks its JSON record with: grep
# '^BENCH ' and json-parse the rest — warmup logs, progress lines and
# stray braces can never be mistaken for a measurement again
BENCH_MARKER = "BENCH "

# provenance keys every record carries ("unknown" is a legal value —
# the --backfill path ingests pre-schema run files)
PROVENANCE_KEYS = ("git_sha", "jax_version", "jaxlib_version", "backend",
                   "device_kind", "device_count", "mesh_shape", "layout",
                   "dtype_policy", "fusion_table_sha", "aot",
                   "steps_per_call")

_UNKNOWN = "unknown"

# one run id per process: every record emitted by one bench process
# groups under it (perf_report's per-run table, perf_gate's candidate)
_RUN_ID = None


def current_run_id():
    """The process-wide run id (minted lazily, stable afterwards)."""
    global _RUN_ID
    if _RUN_ID is None:
        _RUN_ID = uuid.uuid4().hex[:12]
    return _RUN_ID


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_git_sha_cache = None


def _git_sha():
    """HEAD sha of the repo checkout (cached; "unknown" outside git)."""
    global _git_sha_cache
    if _git_sha_cache is None:
        try:
            out = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=_repo_root(),
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True, timeout=5)
            sha = out.stdout.strip()
            _git_sha_cache = sha if out.returncode == 0 and sha else _UNKNOWN
        except Exception:
            _git_sha_cache = _UNKNOWN
    return _git_sha_cache


def _fusion_table_sha():
    """Content hash of the active fusion cost table (None = no table):
    two runs with different measured tables are not comparable rows."""
    try:
        from mxnet_tpu_torch import fusion_cost

        table = fusion_cost.current_table()
        if table is None:
            return None
        import hashlib

        blob = json.dumps(table.to_dict(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]
    except Exception:
        return _UNKNOWN


def _aot_state():
    """"off" | "cold" | "warm" in the schema: whether an AOT executable
    store served this run.  The port has none yet: always "off"."""
    return "off"


def provenance(**overrides):
    """The full provenance dict for a record emitted by THIS process:
    environment identity (git/backend/devices) resolved here, run
    configuration (mesh_shape, layout, dtype_policy, steps_per_call)
    from ``overrides`` — emitters pass what they measured under.  The
    jax-version keys are "unknown": the port runs no jax."""
    prov = {k: None for k in PROVENANCE_KEYS}
    prov["git_sha"] = _git_sha()
    prov["jax_version"] = _UNKNOWN
    prov["jaxlib_version"] = _UNKNOWN
    try:
        import torch

        if torch.cuda.is_available():
            prov["backend"] = "cuda"
            prov["device_kind"] = torch.cuda.get_device_name(0)
            prov["device_count"] = torch.cuda.device_count()
        else:
            prov["backend"] = "cpu"
            prov["device_kind"] = "cpu"
            prov["device_count"] = 1
    except Exception:
        prov["backend"] = prov["device_kind"] = _UNKNOWN
        prov["device_count"] = 0
    prov["fusion_table_sha"] = _fusion_table_sha()
    prov["aot"] = _aot_state()
    prov["steps_per_call"] = 1
    for k, v in overrides.items():
        if k not in prov:
            raise ValueError("unknown provenance field %r (known: %s)"
                             % (k, ", ".join(PROVENANCE_KEYS)))
        prov[k] = v
    return prov


def make_record(metric, value, unit, run_id=None, prov=None,
                attribution=None, **fields):
    """One schema-valid BENCH record.  ``prov`` is a full provenance
    dict (default: :func:`provenance` resolved now) or a dict of
    provenance overrides; extra ``fields`` land at the top level next
    to the classic bench fields (warmup_seconds, async_speedup, ...)."""
    if prov is None:
        prov = provenance()
    elif not (set(PROVENANCE_KEYS) <= set(prov)):
        prov = provenance(**prov)
    rec = {
        "schema_version": SCHEMA_VERSION,
        "run_id": run_id or current_run_id(),
        "time": round(time.time(), 3),
        "metric": str(metric),
        "value": value,
        "unit": str(unit),
        "provenance": prov,
    }
    if attribution is not None:
        rec["attribution"] = attribution.as_dict() \
            if isinstance(attribution, StepBreakdown) else dict(attribution)
    for k, v in fields.items():
        if k in rec:
            raise ValueError("field %r collides with a schema field" % k)
        rec[k] = v
    check_record(rec)
    return rec


def validate_record(rec):
    """Problem list for one record ([] = schema-valid).  Validation is
    structural, not semantic: provenance fields may be "unknown"
    (backfilled history) but must be present."""
    problems = []
    if not isinstance(rec, dict):
        return ["record is %s, not an object" % type(rec).__name__]
    if rec.get("schema_version") != SCHEMA_VERSION:
        problems.append("schema_version %r != %d"
                        % (rec.get("schema_version"), SCHEMA_VERSION))
    for key, types in (("run_id", str), ("metric", str), ("unit", str)):
        v = rec.get(key)
        if not isinstance(v, types) or not v:
            problems.append("%s missing or not a non-empty string (%r)"
                            % (key, v))
    v = rec.get("value")
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        problems.append("value missing or not a number (%r)" % (v,))
    elif not math.isfinite(v):
        problems.append("value is non-finite (%r)" % (v,))
    t = rec.get("time")
    if not isinstance(t, (int, float)) or isinstance(t, bool) or t < 0:
        problems.append("time missing or not a unix timestamp (%r)" % (t,))
    prov = rec.get("provenance")
    if not isinstance(prov, dict):
        problems.append("provenance missing or not an object (%r)"
                        % (prov,))
    else:
        for k in PROVENANCE_KEYS:
            if k not in prov:
                problems.append("provenance.%s missing" % k)
    attr = rec.get("attribution")
    if attr is not None:
        if not isinstance(attr, dict) or \
                not isinstance(attr.get("buckets_ms_per_step"), dict):
            problems.append("attribution present but malformed "
                            "(needs buckets_ms_per_step object)")
    return problems


def check_record(rec):
    """Raise ValueError on a schema-invalid record (emit/append guard)."""
    problems = validate_record(rec)
    if problems:
        raise ValueError("invalid BENCH record: %s"
                         % "; ".join(problems[:5]))
    return rec


def ledger_path():
    """The run-ledger path from MXNET_PERF_LEDGER ('' / unset = no
    ledger — records still print, nothing persists)."""
    return os.environ.get("MXNET_PERF_LEDGER", "") or None


def append(records, path=None):
    """Append validated record(s) to the JSONL ledger at ``path``
    (default :func:`ledger_path`; no-op when neither is set).

    The whole batch is serialized first and written with ONE
    ``O_APPEND`` write + fsync: concurrent emitters interleave at row
    granularity, and a crash mid-append can tear at most the final
    unflushed line — which :func:`read_ledger` reports instead of
    propagating.  Returns the path written, or None."""
    path = path or ledger_path()
    if path is None:
        return None
    if isinstance(records, dict):
        records = [records]
    lines = []
    for rec in records:
        check_record(rec)
        lines.append(json.dumps(rec, sort_keys=True,
                                allow_nan=False) + "\n")
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, "".join(lines).encode("utf-8"))
        os.fsync(fd)
    finally:
        os.close(fd)
    return path


def emit(rec, stream=None, path=None):
    """The one write path every bench emitter uses: validate ``rec``,
    print it as a ``BENCH {json}`` marker line on ``stream`` (default
    stdout; None-able for tests), and append it to the run ledger when
    one is configured.  Returns the record."""
    check_record(rec)
    line = BENCH_MARKER + json.dumps(rec, allow_nan=False)
    if stream is None:
        stream = sys.stdout
    print(line, file=stream, flush=True)
    append(rec, path=path)
    return rec


def read_ledger(path):
    """Parse a JSONL ledger -> (records, problems).  Schema-invalid or
    unparsable lines become ``(lineno, message)`` problems; valid rows
    always come back, so one bad line cannot hide a whole run."""
    records, problems = [], []
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError as e:
                problems.append((i, "unparsable JSON (%s)" % e))
                continue
            bad = validate_record(rec)
            if bad:
                problems.append((i, "; ".join(bad[:3])))
                continue
            records.append(rec)
    return records, problems


def parse_bench_lines(text, legacy=True):
    """Extract bench JSON objects from captured output.

    The modern contract is the ``BENCH `` marker; with ``legacy=True``
    (the --backfill path) lines that ARE a bare JSON object carrying a
    ``metric`` key are also accepted — exactly the brace-matching
    heuristic the marker retires, kept only for ingesting pre-schema
    run-file tails."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        payload = None
        if line.startswith(BENCH_MARKER):
            payload = line[len(BENCH_MARKER):]
        elif legacy and line.startswith("{") and line.endswith("}"):
            payload = line
        if payload is None:
            continue
        try:
            obj = json.loads(payload)
        except ValueError:
            continue
        if isinstance(obj, dict) and obj.get("metric"):
            out.append(obj)
    return out


# ---------------------------------------------------------------------------
# step-time attribution
# ---------------------------------------------------------------------------

# bucket order is the report order: the residual (device compute)
# leads, host components follow largest-lever-first
BREAKDOWN_BUCKETS = ("device_compute", "compile", "aot_load",
                     "data_wait", "host_other")


class StepBreakdown:
    """Where one train step's milliseconds went, on average.

    Assembled from telemetry series the runtime already collects — no
    new per-step cost.  Accounting (all per-step means over the
    measured window):

    * ``span`` — the dispatch+commit window
      (``mxnet_tpu_train_step_seconds``); under the sync metric path it
      covers device execution (the loss read blocks), under async
      dispatch steady state converges to true step time via
      backpressure.
    * ``gap`` — dispatch-to-dispatch host idle
      (``mxnet_tpu_host_gap_seconds``), amortized per step.
    * ``compile`` / ``aot_load`` — backend-compile and AOT-deserialize
      seconds amortized over the window's steps (zero in steady state;
      dominant when the window includes a cold start).
    * ``data_wait`` — blocking waits at ``io.DevicePrefetcher``
      handoff (``mxnet_tpu_device_prefetch_wait_seconds``), clamped to
      the gap it is part of.
    * ``device_compute`` — the residual: ``span - compile - aot_load``
      (clamped at 0); ``host_other`` is ``gap - data_wait``.

    By construction the five buckets sum to ``span + gap`` (modulo the
    two clamps) — the acceptance bound the tier-1 smoke asserts.
    """

    def __init__(self, steps, span_s, gap_s, data_wait_s=0.0,
                 compile_s=0.0, aot_load_s=0.0, collective_bytes=None,
                 loop="sharded"):
        self.steps = int(steps)
        self.loop = loop
        self.span_s = float(span_s)
        self.gap_s = float(gap_s)
        self.data_wait_s = min(float(data_wait_s), float(gap_s))
        self.compile_s = min(float(compile_s), float(span_s))
        self.aot_load_s = min(float(aot_load_s),
                              float(span_s) - self.compile_s)
        self.collective_bytes = dict(collective_bytes or {})

    @classmethod
    def from_telemetry(cls, loop="sharded", registry=None):
        """Assemble from the live registry (or a compatible one).
        Returns None when the window recorded no steps."""
        from mxnet_tpu_torch import telemetry as tel

        r = registry or tel
        steps = r.TRAIN_STEPS.value(loop=loop)
        calls = r.TRAIN_STEP_SECONDS.count(loop=loop)
        if not steps or not calls:
            return None
        span = r.TRAIN_STEP_SECONDS.sum(loop=loop) / calls
        gap_calls = r.HOST_GAP_SECONDS.count(loop=loop)
        gap = (r.HOST_GAP_SECONDS.sum(loop=loop) / steps) \
            if gap_calls else 0.0
        coll = {}
        for labels in r.COLLECTIVE_BYTES.series_labels():
            if not labels:
                continue
            b = r.COLLECTIVE_BYTES.value(**labels)
            if b:
                coll["%(axis)s/%(op)s" % labels] = b / steps
        return cls(
            steps, span, gap,
            data_wait_s=r.PREFETCH_WAIT_SECONDS.sum() / steps,
            compile_s=r.COMPILE_SECONDS.sum() / steps,
            aot_load_s=r.AOT_LOAD_SECONDS.sum() / steps,
            collective_bytes=coll, loop=loop)

    @property
    def device_compute_s(self):
        return max(0.0, self.span_s - self.compile_s - self.aot_load_s)

    @property
    def host_other_s(self):
        return max(0.0, self.gap_s - self.data_wait_s)

    @property
    def wall_s(self):
        """Measured wall per step: dispatch span + between-dispatch
        gap — what the five buckets decompose."""
        return self.span_s + self.gap_s

    def buckets(self):
        """Ordered {bucket: seconds per step} (sums to :attr:`wall_s`)."""
        return {
            "device_compute": self.device_compute_s,
            "compile": self.compile_s,
            "aot_load": self.aot_load_s,
            "data_wait": self.data_wait_s,
            "host_other": self.host_other_s,
        }

    def as_dict(self):
        """The JSON shape BENCH records embed as ``attribution``."""
        return {
            "loop": self.loop,
            "steps": self.steps,
            "wall_ms_per_step": round(self.wall_s * 1e3, 4),
            "span_ms_per_step": round(self.span_s * 1e3, 4),
            "gap_ms_per_step": round(self.gap_s * 1e3, 4),
            "buckets_ms_per_step": {
                k: round(v * 1e3, 4) for k, v in self.buckets().items()},
            "collective_bytes_per_step": {
                k: round(v, 1) for k, v in self.collective_bytes.items()},
        }

    def describe(self):
        """Human table: bucket, ms/step, share of wall."""
        wall = self.wall_s or 1e-12
        lines = ["step breakdown (%s loop, %d steps, %.3f ms wall/step):"
                 % (self.loop, self.steps, self.wall_s * 1e3)]
        for name, v in self.buckets().items():
            lines.append("  %-15s %10.3f ms  %5.1f%%"
                         % (name, v * 1e3, 100.0 * v / wall))
        for k, b in sorted(self.collective_bytes.items()):
            lines.append("  collective %-12s %12.0f B/step" % (k, b))
        return "\n".join(lines)

    def __repr__(self):
        return "StepBreakdown(%s)" % ", ".join(
            "%s=%.4g" % (k, v * 1e3) for k, v in self.buckets().items())
