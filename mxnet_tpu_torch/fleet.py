"""Fleet observatory: cross-rank metric aggregation + straggler
attribution over a shared spool directory (counterpart of
mxnet_tpu/fleet.py).

The other observability layers — the telemetry registry, span
tracing, wide events, ``/statusz``, the perf ledger — are
process-local, but training is multi-process (the parameter-server
workers of ``tools.launch``).  This module is the cross-process evidence layer: when a pod is
slow it names *which rank* and *which attribution bucket*.

Two halves share one file-channel:

* **Publisher** — :class:`FleetPublisher`: each rank periodically
  writes an atomic snapshot (full ``telemetry.collect()`` with
  bucket-level histograms, the ``/statusz`` subsystem summary, the
  ``perf_ledger.StepBreakdown`` attribution, and a clock sample) into
  a shared spool dir.  Writes reuse the checkpoint sidecar-barrier
  pattern: the payload lands first (atomic tmp+rename), then a digest
  sidecar (``rank-NNNNN.ok``) — sidecar-present == payload durable, and
  a digest mismatch means a torn write the collector skips with a
  counted warning, never a crash (the ``read_ledger`` torn-line
  discipline applied to files).  :meth:`FleetPublisher.attach` runs a
  file-based rendezvous in the spool (every rank says hello, rank 0
  writes the mark, everyone records the wall time it first *saw* the
  mark) — those shared barrier timestamps are what the collector turns
  into per-rank clock-offset estimates.
* **Collector** — :func:`read_spool` / :func:`fleetz`: merges counters
  by sum and histograms bucket-additively (:func:`merge_metrics`, also
  exposed as ``telemetry.merge_collected`` and reused by
  ``tools/telemetry_dump.py --merge``), computes per-rank step-time
  skew into a straggler score naming the lagging rank AND its
  largest-moving attribution bucket, estimates clock offsets from the
  barrier timestamps, and marks dead ranks stale instead of blocking
  the merge.  :func:`stitch_traces` rebases each rank's chrome trace
  from its private ``perf_counter`` timebase onto offset-corrected pod
  wall time so ``tools/trace_view.py --fleet`` renders one pod-level
  timeline.

Serving surfaces: ``tools/fleetz.py`` (CLI) and the ``/fleetz`` route
on the telemetry scrape server render :func:`fleetz`; the heartbeat
line gains ``skew``/``straggler`` fields and ``/statusz`` a ``fleet``
subsystem while a spool is active.

STDLIB-ONLY AT IMPORT by contract (like ``perf_ledger``): every
package reference is a lazy absolute import and the
telemetry-counter hooks fire only when the package is already loaded.
See docs/observability.md "Fleet observatory".
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import sys
import tempfile
import threading
import time

__all__ = ["FleetPublisher", "active_spool", "set_spool", "read_spool",
           "merge_metrics", "hist_quantile", "straggler_report",
           "clock_offsets", "fleetz", "status_summary",
           "heartbeat_fields", "stitch_traces",
           "SNAPSHOT_NAME", "SIDECAR_NAME", "TRACE_NAME"]

logger = logging.getLogger("mxnet_tpu_torch.fleet")

SNAPSHOT_NAME = "rank-%05d.json"
SIDECAR_NAME = "rank-%05d.ok"
TRACE_NAME = "trace-rank-%05d.json"
_SNAP_RE = re.compile(r"^rank-(\d{5})\.json$")
_ATTACH_DIR = "attach"
_ATTACH_MARK = "mark.json"

_INF = float("inf")

_active_spool = None     # set by FleetPublisher / set_spool()


# ---------------------------------------------------------------------------
# lazy package hooks (the stdlib-only-at-import contract)
# ---------------------------------------------------------------------------

def _flag(name, default):
    """Config knob via the package's config when it is loaded, raw env
    otherwise."""
    cfg = sys.modules.get("mxnet_tpu_torch.config")
    if cfg is not None:
        try:
            return cfg.get(name)
        except Exception:
            pass
    raw = os.environ.get(name, default)
    if isinstance(default, (int, float)) and not isinstance(default, bool):
        try:
            return type(default)(float(raw))
        except (TypeError, ValueError):
            return default
    return raw


def _tel():
    """The live telemetry module when the package already imported it,
    else None (a standalone collector has no registry to count into)."""
    return sys.modules.get("mxnet_tpu_torch.telemetry")


def _numf(v):
    """float() tolerant of the dump encoding's non-finite strings
    ("Infinity"/"-Infinity"/"NaN") and the exposition's "+Inf"."""
    if isinstance(v, str):
        if v == "+Inf":
            return _INF
        if v == "-Inf":
            return -_INF
        return float(v)
    return float(v)


def _json_num(v):
    """RFC-8259-safe number (mirrors telemetry._json_num): non-finite
    values ship as strings so merged dumps stay strict-parser valid."""
    v = float(v)
    if v != v:
        return "NaN"
    if v == _INF:
        return "Infinity"
    if v == -_INF:
        return "-Infinity"
    return int(v) if v == int(v) and abs(v) < 2**53 else v


def _atomic_write(path, data):
    """Atomic tmp+fsync+rename in the target dir — the same commit
    discipline as ``checkpoint.atomic_write`` (used directly when the
    package is loaded; the local fallback keeps standalone collectors
    dependency-free)."""
    ck = sys.modules.get("mxnet_tpu_torch.checkpoint")
    if ck is not None:
        ck.atomic_write(path, data)
        return
    if isinstance(data, str):
        data = data.encode("utf-8")
    dirname = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=dirname,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# spool activation
# ---------------------------------------------------------------------------

def set_spool(path):
    """Pin the process-wide active spool dir (None = back to the
    ``MXNET_FLEET_SPOOL`` knob) — what the heartbeat and the
    ``/statusz``/``/fleetz`` defaults read."""
    global _active_spool
    _active_spool = os.fspath(path) if path is not None else None


def active_spool():
    """The active spool dir, or None: an explicit :func:`set_spool` /
    live publisher wins, else a non-empty ``MXNET_FLEET_SPOOL``."""
    if _active_spool:
        return _active_spool
    spool = _flag("MXNET_FLEET_SPOOL", "")
    return str(spool) if spool else None


# ---------------------------------------------------------------------------
# publisher
# ---------------------------------------------------------------------------

def _proc_identity():
    """(rank, n_procs) from the distributed env (0/1 single-process)."""
    try:
        rank = int(_flag("MXNET_DIST_PROC_ID", -1))
    except (TypeError, ValueError):
        rank = -1
    try:
        n = int(_flag("MXNET_DIST_NUM_PROCS", 0))
    except (TypeError, ValueError):
        n = 0
    return (rank if rank >= 0 else 0), (n if n > 1 else 1)


class FleetPublisher:
    """One rank's snapshot publisher into a shared spool dir.

    ``rank``/``n_procs`` default to the ``MXNET_DIST_PROC_ID`` /
    ``MXNET_DIST_NUM_PROCS`` identity,
    ``interval`` to ``MXNET_FLEET_INTERVAL``; ``clock_offset`` (default
    ``MXNET_FLEET_CLOCK_OFFSET``) is added to every wall-clock sample
    this publisher takes — the deterministic skew injection the tier-1
    drill uses, zero in production.  Publishing never raises into the
    caller: a failed write is counted
    (``mxnet_tpu_fleet_publish_errors_total``) and logged.
    """

    def __init__(self, spool=None, rank=None, n_procs=None, interval=None,
                 loop="sharded", clock_offset=None, publish_trace=True):
        spool = spool or active_spool()
        if not spool:
            raise ValueError("no spool dir: pass spool= or set "
                             "MXNET_FLEET_SPOOL")
        self.spool = os.fspath(spool)
        env_rank, env_n = _proc_identity()
        self.rank = int(rank) if rank is not None else env_rank
        self.n_procs = int(n_procs) if n_procs is not None else env_n
        self.loop = loop
        self.interval = float(interval) if interval is not None \
            else float(_flag("MXNET_FLEET_INTERVAL", 5.0))
        self.clock_offset = float(clock_offset) if clock_offset is not None \
            else float(_flag("MXNET_FLEET_CLOCK_OFFSET", 0.0))
        self.publish_trace = bool(publish_trace)
        self.barrier_wall = None
        self.seq = 0
        self._stop = threading.Event()
        self._thread = None
        os.makedirs(self.spool, exist_ok=True)
        set_spool(self.spool)

    def _wall(self):
        return time.time() + self.clock_offset

    # -- attach barrier --------------------------------------------------
    def attach(self, timeout=None, poll=0.005):
        """File rendezvous in the spool: every rank writes a hello,
        rank 0 writes the mark once all ``n_procs`` hellos are present,
        and every rank records the wall time it first OBSERVED the
        mark.  All ranks see the mark appear at (nearly) the same real
        instant — bounded by ``poll`` — so differences between their
        recorded wall clocks estimate per-rank clock offsets.  Returns
        the recorded ``barrier_wall``; raises TimeoutError past
        ``timeout`` (default ``MXNET_DIST_BARRIER_TIMEOUT``)."""
        if timeout is None:
            timeout = float(_flag("MXNET_DIST_BARRIER_TIMEOUT", 120.0))
        adir = os.path.join(self.spool, _ATTACH_DIR)
        os.makedirs(adir, exist_ok=True)
        _atomic_write(os.path.join(adir, "hello-%05d" % self.rank),
                      json.dumps({"rank": self.rank, "pid": os.getpid()}))
        deadline = time.monotonic() + max(0.1, float(timeout))
        mark = os.path.join(adir, _ATTACH_MARK)
        if self.rank == 0:
            want = {"hello-%05d" % r for r in range(self.n_procs)}
            while not want.issubset(set(os.listdir(adir))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        "fleet attach: rank 0 timed out waiting for %s"
                        % sorted(want - set(os.listdir(adir))))
                time.sleep(poll)
            _atomic_write(mark, json.dumps(
                {"n_procs": self.n_procs, "time": self._wall()}))
        while True:
            try:
                with open(mark, encoding="utf-8") as f:
                    json.load(f)
                break
            except (OSError, ValueError):
                if time.monotonic() >= deadline:
                    raise TimeoutError("fleet attach: rank %d timed out "
                                       "waiting for the barrier mark"
                                       % self.rank)
                time.sleep(poll)
        self.barrier_wall = self._wall()
        return self.barrier_wall

    # -- snapshots -------------------------------------------------------
    def _payload(self):
        from mxnet_tpu_torch import telemetry as tel

        self.seq += 1
        payload = {
            "format_version": 1,
            "rank": self.rank,
            "n_procs": self.n_procs,
            "pid": os.getpid(),
            "seq": self.seq,
            "loop": self.loop,
            "time_wall": self._wall(),
            "time_perf": time.perf_counter(),
            "barrier_wall": self.barrier_wall,
            "metrics": tel.collect(),
        }
        try:
            payload["statusz"] = tel.statusz()
        except Exception:
            payload["statusz"] = None
        try:
            from mxnet_tpu_torch import perf_ledger as _pl

            bd = _pl.StepBreakdown.from_telemetry(loop=self.loop)
            payload["breakdown"] = bd.as_dict() if bd is not None else None
        except Exception:
            payload["breakdown"] = None
        return payload

    def publish_once(self):
        """Write one snapshot (payload, then digest sidecar — the
        sidecar is the durability mark) plus, when tracing is on, this
        rank's chrome trace.  Returns the payload dict, or None on a
        counted failure."""
        t0 = time.perf_counter()
        try:
            payload = self._payload()
            data = json.dumps(payload, sort_keys=True, default=str)
            ppath = os.path.join(self.spool, SNAPSHOT_NAME % self.rank)
            _atomic_write(ppath, data)
            sidecar = {
                "format_version": 1,
                "rank": self.rank,
                "seq": payload["seq"],
                "sha256": hashlib.sha256(data.encode("utf-8")).hexdigest(),
                "time": payload["time_wall"],
            }
            _atomic_write(os.path.join(self.spool,
                                       SIDECAR_NAME % self.rank),
                          json.dumps(sidecar, sort_keys=True))
            if self.publish_trace:
                self._publish_trace()
        except Exception:
            logger.exception("fleet publish failed (rank %d)", self.rank)
            tel = _tel()
            if tel is not None:
                tel.FLEET_PUBLISH_ERRORS.inc()
            return None
        tel = _tel()
        if tel is not None:
            tel.FLEET_SNAPSHOTS.inc()
            tel.FLEET_PUBLISH_SECONDS.observe(time.perf_counter() - t0)
        return payload

    def _publish_trace(self):
        from mxnet_tpu_torch import tracing as _tracing

        if not _tracing.enabled():
            return
        payload = _tracing.chrome_trace_payload(include_profiler=False)
        _atomic_write(os.path.join(self.spool, TRACE_NAME % self.rank),
                      json.dumps(payload, default=str))

    # -- background loop -------------------------------------------------
    def start(self):
        """Publish every ``interval`` seconds from a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("publisher already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="fleet-publisher",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self.publish_once()

    def stop(self):
        """Stop the thread and write one final snapshot."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join()
        self._thread = None
        self.publish_once()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# collector: spool reading
# ---------------------------------------------------------------------------

def read_spool(spool, stale_after=None, now=None):
    """Read every durable rank snapshot under ``spool``.

    Returns ``{"ranks": {rank: row}, "clock_offsets": {rank: s},
    "problems": [(name, message)], "torn": n, "stale_after": s}``.
    A row is ``{"snapshot", "sidecar", "age_s", "stale"}``.  Torn or
    partial snapshots (missing sidecar, digest mismatch, unparsable
    payload) are skipped with a counted problem — the same discipline
    as ``read_ledger``'s torn lines; the collector NEVER raises on
    spool content.  Ages are clock-offset corrected where a barrier
    estimate exists; a rank older than ``stale_after``
    (``MXNET_FLEET_STALE``) is marked stale."""
    if stale_after is None:
        stale_after = float(_flag("MXNET_FLEET_STALE", 30.0))
    stale_after = float(stale_after)
    now = time.time() if now is None else float(now)
    ranks, problems, torn = {}, [], 0
    try:
        names = sorted(os.listdir(spool))
    except OSError as e:
        return {"ranks": {}, "clock_offsets": {}, "torn": 0,
                "problems": [(str(spool), "cannot list spool (%s)" % e)],
                "stale_after": stale_after}
    for name in names:
        m = _SNAP_RE.match(name)
        if not m:
            continue
        rank = int(m.group(1))
        sc_name = SIDECAR_NAME % rank
        try:
            with open(os.path.join(spool, sc_name),
                      encoding="utf-8") as f:
                sidecar = json.load(f)
        except (OSError, ValueError) as e:
            torn += 1
            problems.append((name, "snapshot not durable: sidecar %s "
                                   "unreadable (%s)" % (sc_name, e)))
            continue
        try:
            with open(os.path.join(spool, name), "rb") as f:
                raw = f.read()
        except OSError as e:
            torn += 1
            problems.append((name, "payload unreadable (%s)" % e))
            continue
        digest = hashlib.sha256(raw).hexdigest()
        if digest != sidecar.get("sha256"):
            torn += 1
            problems.append((name, "torn snapshot: payload sha256 %s != "
                                   "sidecar %s" % (digest[:12],
                                                   str(sidecar.get(
                                                       "sha256"))[:12])))
            continue
        try:
            snapshot = json.loads(raw.decode("utf-8"))
        except ValueError as e:
            torn += 1
            problems.append((name, "unparsable payload (%s)" % e))
            continue
        ranks[rank] = {"snapshot": snapshot, "sidecar": sidecar}
    offsets = clock_offsets(ranks)
    for rank, row in ranks.items():
        stamp = row["sidecar"].get("time")
        off = offsets.get(rank, 0.0)
        try:
            age = max(0.0, now - (float(stamp) - off))
        except (TypeError, ValueError):
            age = None
        row["age_s"] = round(age, 3) if age is not None else None
        row["stale"] = age is None or age > stale_after
    tel = _tel()
    if tel is not None and torn:
        tel.FLEET_TORN_SNAPSHOTS.inc(torn)
    return {"ranks": ranks, "clock_offsets": offsets, "torn": torn,
            "problems": problems, "stale_after": stale_after}


def clock_offsets(ranks):
    """{rank: estimated clock offset vs the base rank, seconds} from
    the shared attach-barrier timestamps.  All ranks observed the same
    mark file appear at (nearly) the same real instant, so
    ``barrier_wall[r] - barrier_wall[base]`` is rank r's wall-clock
    skew (base = lowest rank with a barrier sample, normally 0).
    Ranks without a barrier sample are omitted."""
    walls = {}
    for rank, row in ranks.items():
        snap = row.get("snapshot") if isinstance(row, dict) else None
        bw = (snap or {}).get("barrier_wall")
        if isinstance(bw, (int, float)):
            walls[rank] = float(bw)
    if not walls:
        return {}
    base = walls[min(walls)]
    return {rank: round(w - base, 6) for rank, w in walls.items()}


# ---------------------------------------------------------------------------
# collector: merge semantics
# ---------------------------------------------------------------------------

def merge_metrics(snapshots):
    """Merge N ``telemetry.collect()``-shaped dicts into one.

    Semantics (docs/observability.md "Fleet observatory"): counters
    sum exactly; histograms add bucket-additively — each series'
    cumulative buckets are decomposed into per-bucket counts,
    accumulated on the union of bucket bounds, and re-cumulated, so
    the merged histogram is exactly the histogram of the pooled
    observations at bucket resolution (``sum``/``count`` add too);
    gauges take the max (a fleet-level watermark — a per-rank view
    should read the per-rank snapshots).  Exemplars are dropped: they
    reference per-process trace ids.  This is the single merge
    implementation behind ``telemetry.merge_collected``, the
    ``/fleetz`` endpoint, and ``telemetry_dump.py --merge``."""
    merged = {}
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        for name, fam in snap.items():
            if not isinstance(fam, dict):
                continue
            kind = fam.get("type", "gauge")
            out = merged.setdefault(name, {
                "type": kind, "help": fam.get("help", ""),
                "label_names": list(fam.get("label_names", [])),
                "_series": {}})
            for s in fam.get("series", []):
                labels = dict(s.get("labels") or {})
                key = tuple(sorted(labels.items()))
                if kind == "histogram":
                    row = out["_series"].setdefault(
                        key, {"labels": labels, "_buckets": {},
                              "sum": 0.0, "count": 0})
                    row["sum"] += _numf(s.get("sum", 0.0))
                    row["count"] += int(s.get("count", 0))
                    prev = 0.0
                    for ub, cum in sorted(
                            ((_numf(b[0]), _numf(b[1]))
                             for b in s.get("buckets", [])),
                            key=lambda bc: bc[0]):
                        row["_buckets"][ub] = \
                            row["_buckets"].get(ub, 0.0) + (cum - prev)
                        prev = cum
                else:
                    row = out["_series"].setdefault(
                        key, {"labels": labels, "_value": 0.0})
                    v = _numf(s.get("value", 0.0))
                    if kind == "gauge":
                        row["_value"] = max(row["_value"], v)
                    else:
                        row["_value"] += v
    return _finalize_merge(merged)


def _finalize_merge(merged):
    out = {}
    for name, fam in merged.items():
        series = []
        for key in sorted(fam["_series"]):
            row = fam["_series"][key]
            if "_buckets" in row:
                cum, cumlist = 0.0, []
                for ub in sorted(row["_buckets"]):
                    cum += row["_buckets"][ub]
                    cumlist.append([_json_num(ub), int(round(cum))])
                series.append({"labels": row["labels"],
                               "buckets": cumlist,
                               "sum": _json_num(row["sum"]),
                               "count": int(row["count"])})
            else:
                series.append({"labels": row["labels"],
                               "value": _json_num(row["_value"])})
        out[name] = {"type": fam["type"], "help": fam["help"],
                     "label_names": fam["label_names"], "series": series}
    return out


def hist_quantile(buckets, q):
    """Bucket-interpolated quantile over cumulative ``[[ub, count]]``
    rows (the merged-dump shape); None when empty."""
    if not buckets:
        return None
    rows = [(_numf(b[0]), _numf(b[1])) for b in buckets]
    total = rows[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_ub, prev_c = 0.0, 0.0
    for ub, c in rows:
        if c >= rank:
            if ub == _INF:
                return prev_ub
            if c == prev_c:
                return ub
            return prev_ub + (ub - prev_ub) * (rank - prev_c) / (c - prev_c)
        prev_ub, prev_c = ub, c
    return prev_ub


# ---------------------------------------------------------------------------
# collector: straggler attribution
# ---------------------------------------------------------------------------

def _median(vals):
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def straggler_report(view):
    """Straggler score over the FRESH ranks of a :func:`read_spool`
    view.  Per rank: ``score = wall_ms_per_step / median(wall)``; the
    straggler is the max-score rank and ``skew`` its score (1.0 = a
    perfectly even pod).  Attribution: the straggler's
    largest-moving ``StepBreakdown`` bucket — largest positive delta
    vs the per-bucket fleet median — names WHAT grew on the lagging
    rank.  Stale ranks are excluded from scoring (they are still
    merged and listed); fewer than 2 scoreable ranks yields
    ``straggler: None`` with a reason."""
    rows = {}
    for rank, row in view["ranks"].items():
        if row.get("stale"):
            continue
        bd = (row.get("snapshot") or {}).get("breakdown")
        if isinstance(bd, dict) and \
                isinstance(bd.get("wall_ms_per_step"), (int, float)):
            rows[rank] = bd
    if len(rows) < 2:
        return {"straggler": None, "skew": None, "bucket": None,
                "reason": "need >= 2 fresh ranks with a step breakdown "
                          "(have %d)" % len(rows),
                "wall_ms_per_step": {
                    str(r): bd["wall_ms_per_step"]
                    for r, bd in rows.items()}}
    wall = {r: float(bd["wall_ms_per_step"]) for r, bd in rows.items()}
    med = _median(wall.values())
    if med <= 0:
        med = max(wall.values()) or 1.0
    scores = {r: w / med for r, w in wall.items()}
    straggler = max(scores, key=lambda r: (scores[r], r))
    bucket_meds = {}
    names = set()
    for bd in rows.values():
        names.update((bd.get("buckets_ms_per_step") or {}))
    for b in names:
        bucket_meds[b] = _median([
            float((bd.get("buckets_ms_per_step") or {}).get(b, 0.0))
            for bd in rows.values()])
    deltas = {
        b: float((rows[straggler].get("buckets_ms_per_step") or {})
                 .get(b, 0.0)) - m
        for b, m in bucket_meds.items()}
    bucket = max(deltas, key=lambda b: (deltas[b], b)) if deltas else None
    return {
        "straggler": straggler,
        "skew": round(scores[straggler], 4),
        "scores": {str(r): round(s, 4) for r, s in sorted(scores.items())},
        "wall_ms_per_step": {str(r): round(w, 4)
                             for r, w in sorted(wall.items())},
        "median_wall_ms_per_step": round(med, 4),
        "bucket": bucket,
        "bucket_delta_ms_per_step": round(deltas[bucket], 4)
        if bucket is not None else None,
        "reason": None,
    }


# ---------------------------------------------------------------------------
# collector: the /fleetz payload
# ---------------------------------------------------------------------------

def fleetz(spool=None, stale_after=None, merge=True):
    """The full fleet view (the ``/fleetz`` endpoint body and the
    ``tools/fleetz.py`` payload): per-rank rows (seq, pid, age, stale
    mark, steps, wall/bucket attribution, clock offset), the straggler
    report, clock offsets, the torn-snapshot count, and — with
    ``merge`` — the merged metric registry (counters summed exactly,
    histograms bucket-additive).  Never raises on spool content;
    returns ``{"active": False, ...}`` when no spool is configured."""
    spool = spool or active_spool()
    if not spool:
        return {"active": False,
                "error": "no fleet spool configured "
                         "(MXNET_FLEET_SPOOL or FleetPublisher)"}
    if not os.path.isdir(spool):
        return {"active": False, "spool": str(spool),
                "error": "spool dir does not exist"}
    view = read_spool(spool, stale_after=stale_after)
    out = {
        "active": True,
        "format_version": 1,
        "time": round(time.time(), 3),
        "spool": str(spool),
        "stale_after_s": view["stale_after"],
        "torn_snapshots": view["torn"],
        "problems": ["%s: %s" % p for p in view["problems"]],
        "clock_offsets_s": {str(r): o
                            for r, o in sorted(
                                view["clock_offsets"].items())},
        "straggler": straggler_report(view),
        "ranks": {},
    }
    for rank, row in sorted(view["ranks"].items()):
        snap = row["snapshot"]
        bd = snap.get("breakdown") or {}
        # the rank's goodput summary rides its statusz snapshot (the
        # goodput /statusz subsystem), so a straggler's job-lifetime
        # badput is visible in the merged pod view
        gp = ((snap.get("statusz") or {}).get("goodput") or {})
        out["ranks"][str(rank)] = {
            "seq": snap.get("seq"),
            "pid": snap.get("pid"),
            "n_procs": snap.get("n_procs"),
            "age_s": row["age_s"],
            "stale": row["stale"],
            "steps": bd.get("steps"),
            "wall_ms_per_step": bd.get("wall_ms_per_step"),
            "buckets_ms_per_step": bd.get("buckets_ms_per_step"),
            "clock_offset_s": view["clock_offsets"].get(rank),
            "goodput_pct": gp.get("goodput_pct")
            if gp.get("active") else None,
            "trace": os.path.exists(
                os.path.join(spool, TRACE_NAME % rank)),
        }
    if merge:
        out["merged_metrics"] = merge_metrics(
            [row["snapshot"].get("metrics") or {}
             for _, row in sorted(view["ranks"].items())])
    return out


def status_summary():
    """The ``fleet`` subsystem of ``/statusz``: active flag, ranks
    seen, per-rank snapshot age + stale mark, current straggler score
    (no merged registry — that is the ``/fleetz`` payload)."""
    spool = active_spool()
    if not spool or not os.path.isdir(spool):
        return {"active": False}
    view = read_spool(spool)
    rep = straggler_report(view)
    return {
        "active": True,
        "spool": str(spool),
        "ranks_seen": len(view["ranks"]),
        "torn_snapshots": view["torn"],
        "snapshot_age_s": {str(r): row["age_s"]
                           for r, row in sorted(view["ranks"].items())},
        "stale": sorted(str(r) for r, row in view["ranks"].items()
                        if row["stale"]),
        "straggler": rep["straggler"],
        "straggler_skew": rep["skew"],
        "straggler_bucket": rep["bucket"],
    }


def heartbeat_fields():
    """{"skew", "rank", "bucket"} for the heartbeat line, or None
    while no spool is active / fewer than 2 fresh ranks reported."""
    spool = active_spool()
    if not spool or not os.path.isdir(spool):
        return None
    rep = straggler_report(read_spool(spool))
    if rep["straggler"] is None:
        return None
    return {"skew": rep["skew"], "rank": rep["straggler"],
            "bucket": rep["bucket"]}


# ---------------------------------------------------------------------------
# stitched pod traces
# ---------------------------------------------------------------------------

def stitch_traces(spool, stale_after=None):
    """Merge per-rank chrome traces into one pod-level timeline.

    Each rank's trace carries ``perf_counter``-µs timestamps — a
    private timebase.  Its snapshot's paired clock sample
    (``time_wall``, ``time_perf``) anchors that timebase to the rank's
    wall clock, and the barrier-estimated clock offset corrects the
    wall clock onto rank 0's: ``pod_us = (ts_us - perf_us) +
    (wall - offset) * 1e6``, re-zeroed on the earliest event.  pid
    becomes the RANK (with a ``process_name`` metadata row naming the
    original pid) and span/parent ids get an ``rN:`` prefix so ids
    stay unique pod-wide.  Returns ``(payload, problems)``; ranks with
    torn snapshots or unreadable traces are skipped with a problem,
    never an exception."""
    view = read_spool(spool, stale_after=stale_after)
    offsets = view["clock_offsets"]
    problems = ["%s: %s" % p for p in view["problems"]]
    events, meta, stitched_ranks = [], [], []
    for rank, row in sorted(view["ranks"].items()):
        tpath = os.path.join(spool, TRACE_NAME % rank)
        try:
            with open(tpath, encoding="utf-8") as f:
                trace = json.load(f)
        except OSError:
            problems.append("%s: no trace published" % (TRACE_NAME % rank))
            continue
        except ValueError as e:
            problems.append("%s: unparsable trace (%s) — skipped"
                            % (TRACE_NAME % rank, e))
            continue
        snap = row["snapshot"]
        wall, perf = snap.get("time_wall"), snap.get("time_perf")
        if not isinstance(wall, (int, float)) or \
                not isinstance(perf, (int, float)):
            problems.append("rank %d: snapshot has no clock sample — "
                            "trace skipped" % rank)
            continue
        shift_us = (wall - offsets.get(rank, 0.0) - perf) * 1e6
        pid = (trace.get("otherData") or {}).get("pid", snap.get("pid"))
        meta.append({"name": "process_name", "ph": "M", "pid": rank,
                     "tid": 0,
                     "args": {"name": "rank %d (pid %s)" % (rank, pid)}})
        for ev in trace.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            if ev.get("ph") == "M":
                if ev.get("name") == "thread_name":
                    ev = dict(ev)
                    ev["pid"] = rank
                    meta.append(ev)
                continue
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            ev = dict(ev)
            ev["ts"] = ts + shift_us
            ev["pid"] = rank
            args = ev.get("args")
            if isinstance(args, dict) and (
                    "span_id" in args or "parent_id" in args):
                args = dict(args)
                if args.get("span_id") is not None:
                    args["span_id"] = "r%d:%s" % (rank, args["span_id"])
                if args.get("parent_id") is not None:
                    args["parent_id"] = "r%d:%s" % (rank,
                                                    args["parent_id"])
                ev["args"] = args
            events.append(ev)
        stitched_ranks.append(rank)
    if events:
        epoch = min(ev["ts"] for ev in events)
        for ev in events:
            ev["ts"] -= epoch
    events.sort(key=lambda e: e["ts"])
    payload = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "fleet": {
                "spool": str(spool),
                "ranks": stitched_ranks,
                "clock_offsets_s": {str(r): o for r, o in
                                    sorted(offsets.items())},
                "skipped": len(view["ranks"]) - len(stitched_ranks),
                "stale": sorted(r for r, row in view["ranks"].items()
                                if row.get("stale")),
                "torn_snapshots": view["torn"],
            }
        },
    }
    return payload, problems


# ---------------------------------------------------------------------------
# /statusz registration (package-context only)
# ---------------------------------------------------------------------------

def _maybe_register_statusz():
    """Register the ``fleet`` /statusz subsystem when this module runs
    inside the package (a standalone tool load has no registry — and
    must not pay for one)."""
    tel = _tel()
    if tel is not None:
        try:
            tel.register_status_provider("fleet", status_summary)
        except Exception:
            pass


_maybe_register_statusz()
