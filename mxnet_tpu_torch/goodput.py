"""Job-lifetime goodput ledger: cross-restart badput attribution and
preemption lost-work accounting (counterpart of mxnet_tpu/goodput.py).

The other observability layers — step-time attribution
(``perf_ledger.StepBreakdown``), wide events, the fleet observatory —
measures *within one process incarnation*.  The question an operator
of a pod-scale, preemption-surviving job actually asks spans restarts:
"what fraction of wall-clock became training progress, and where did
the rest go?"  This module answers it with a typed wall-clock ledger:

* **Recorder** — :class:`GoodputRecorder`: each process incarnation
  appends typed segments to its own JSONL file in a shared job dir
  (``MXNET_GOODPUT_DIR``).  Segment kinds: ``productive_step``,
  ``compile`` (fed by ``jit.Compiled``'s compile feed),
  ``ckpt_save`` / ``ckpt_restore``, ``data_wait``, ``startup``,
  ``drain``.  Boundary records bracket the incarnation: an
  ``incarnation_start`` (start reason, resumed-from step) and — on a
  *clean or preempted* exit only — an ``incarnation_end``.  A SIGKILL
  leaves no end record: that absence IS the kill signal the reader
  prices.  Durability follows the fleet-spool sidecar discipline bent
  to an append-only file: records land with single ``O_APPEND``
  writes, and a ``<ledger>.ok`` sidecar carries ``{bytes, sha256}`` of
  the flushed *prefix* — sidecar-verified prefix == durable, while the
  unflushed tail is still parsed best-effort under the ``read_ledger``
  torn-line discipline (counted problem per bad line, never a crash),
  so a killed incarnation's last seconds still count.
* **Reader** — :func:`read_job` / :func:`goodputz`: merges every
  incarnation of every rank in the job dir into one report.  The
  lost-work rule: in a killed incarnation, steps completed after the
  last *committed* checkpoint (``ckpt_save`` with ``committed``, else
  the resumed-from step) are badput — priced at that incarnation's own
  measured seconds-per-step and moved from ``goodput`` into
  ``lost_work``.  ``other`` absorbs wall time no segment claimed, so
  the buckets sum to wall-clock by construction (the tier-1
  invariant).  MTTR pairs each kill with the first productive step of
  the same rank's successor incarnation.

Serving surfaces: ``tools/goodputz.py`` (CLI), the ``/goodputz``
scrape route, a ``goodput`` /statusz subsystem, a heartbeat
``goodput`` field, ``perf_report --goodput``, and a per-rank
``goodput_pct`` column in the merged ``/fleetz`` pod view (the
snapshot's statusz carries this module's summary).

STDLIB-ONLY AT IMPORT by contract (like ``fleet``/``perf_ledger``):
every package reference is a lazy lookup and the telemetry counters
fire only when the package is already loaded.  See docs/observability.md "Goodput ledger".
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

__all__ = ["GoodputRecorder", "SEGMENT_KINDS", "BUCKETS",
           "set_dir", "active_dir", "active", "record_segment",
           "record_compile", "compile_guard", "note_exit",
           "read_job", "goodputz", "render_report", "ledger_records",
           "status_summary", "heartbeat_fields",
           "LEDGER_NAME", "SIDECAR_SUFFIX"]

logger = logging.getLogger("mxnet_tpu_torch.goodput")

FORMAT_VERSION = 1

LEDGER_NAME = "goodput-r%05d-%s.jsonl"
SIDECAR_SUFFIX = ".ok"
_LEDGER_RE = re.compile(r"^goodput-r(\d{5})-([0-9a-f]+)\.jsonl$")

#: the typed segment taxonomy (docs/observability.md "Goodput ledger")
SEGMENT_KINDS = ("productive_step", "compile", "ckpt_save",
                 "ckpt_restore", "data_wait", "startup", "drain")

#: report buckets: goodput + the badput decomposition.  ``lost_work``
#: is carved out of ``productive_step`` by the pricing rule; ``other``
#: is wall time no segment claimed (sum-to-wall by construction).
BUCKETS = ("goodput", "lost_work", "compile", "ckpt_save",
           "ckpt_restore", "data_wait", "startup", "drain", "other")

_PROCESS_START = time.time()   # default epoch for the startup segment
_LAST_END = None               # when a prior recorder in THIS process
# ended: the successor's default startup epoch, so back-to-back
# incarnations tile the process wall instead of overlapping it
_compile_total = 0.0           # see compile_seconds_total()


# ---------------------------------------------------------------------------
# lazy package hooks (the stdlib-only-at-import contract, as fleet.py)
# ---------------------------------------------------------------------------

def _flag(name, default):
    """Config knob via the package's config when it is loaded,
    raw env otherwise (tools load this file standalone)."""
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
    else None (a standalone reader has no registry to count into)."""
    return sys.modules.get("mxnet_tpu_torch.telemetry")


def _atomic_write(path, data):
    """Atomic tmp+fsync+rename (checkpoint.atomic_write when the
    package is loaded; local fallback keeps standalone readers free)."""
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


# ---------------------------------------------------------------------------
# job-dir activation
# ---------------------------------------------------------------------------

_active_dir = None       # set by GoodputRecorder.begin / set_dir()


def set_dir(path):
    """Pin the process-wide job dir (None = back to the
    ``MXNET_GOODPUT_DIR`` knob) — what the heartbeat and the
    ``/statusz``/``/goodputz`` defaults read."""
    global _active_dir
    _active_dir = os.fspath(path) if path is not None else None


def active_dir():
    """The active job dir, or None: an explicit :func:`set_dir` /
    live recorder wins, else a non-empty ``MXNET_GOODPUT_DIR``."""
    if _active_dir:
        return _active_dir
    d = _flag("MXNET_GOODPUT_DIR", "")
    return str(d) if d else None


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------

class GoodputRecorder:
    """One incarnation's segment recorder (append-only JSONL).

    ``rank``/``n_procs`` default to the ``MXNET_DIST_PROC_ID`` /
    ``MXNET_DIST_NUM_PROCS`` identity; ``flush_every`` (default
    ``MXNET_GOODPUT_FLUSH_EVERY``) is how many records may land
    between prefix-digest sidecar updates.  Recording never raises
    into the step loop: a failed write is counted
    (``mxnet_tpu_goodput_write_errors_total``) and logged once.
    """

    def __init__(self, dir=None, rank=None, n_procs=None,
                 flush_every=None):
        d = dir or active_dir()
        if not d:
            raise ValueError("no goodput dir: pass dir= or set "
                             "MXNET_GOODPUT_DIR")
        self.dir = os.fspath(d)
        env_rank, env_n = _proc_identity()
        self.rank = int(rank) if rank is not None else env_rank
        self.n_procs = int(n_procs) if n_procs is not None else env_n
        self.incarnation = os.urandom(6).hex()
        self.path = os.path.join(self.dir,
                                 LEDGER_NAME % (self.rank,
                                                self.incarnation))
        self.flush_every = int(flush_every) if flush_every is not None \
            else int(_flag("MXNET_GOODPUT_FLUSH_EVERY", 16))
        self._fd = None
        self._lock = threading.Lock()
        self._hash = hashlib.sha256()
        self._bytes = 0
        self._since_flush = 0
        self._warned = False
        self._ended = False

    # -- lifecycle -------------------------------------------------------
    def begin(self, start_reason="fresh", resumed_from_step=None,
              started_at=None):
        """Open the ledger, write the ``incarnation_start`` boundary
        plus the ``startup`` segment (wall since ``started_at``,
        default process start), and install this recorder as the
        process-wide producer target.  Never raises: an unwritable job
        dir leaves the recorder inactive with a counted error."""
        now = time.time()
        if started_at is not None:
            t0 = float(started_at)
        elif _LAST_END is not None:
            t0 = _LAST_END
        else:
            t0 = _PROCESS_START
        t0 = min(t0, now)
        try:
            os.makedirs(self.dir, exist_ok=True)
            self._fd = os.open(self.path,
                               os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                               0o644)
        except OSError:
            self._count_error("goodput ledger unwritable: %s" % self.path)
            return self
        self._write({
            "type": "incarnation_start",
            "format_version": FORMAT_VERSION,
            "incarnation": self.incarnation,
            "rank": self.rank,
            "n_procs": self.n_procs,
            "pid": os.getpid(),
            # stamped at the STARTUP EPOCH (process start / started_at),
            # not at begin(): the startup segment must fall inside the
            # incarnation's wall window or the buckets cannot sum to it
            "time": t0,
            "start_reason": str(start_reason),
            "resumed_from_step": (int(resumed_from_step)
                                  if resumed_from_step is not None
                                  else None),
        })
        self.segment("startup", max(0.0, now - t0))
        self.flush()
        set_dir(self.dir)
        global _recorder
        _recorder = self
        # a clean interpreter exit closes the incarnation; a SIGKILL
        # skips atexit — the missing end record IS the kill evidence,
        # and a preemption handler's earlier end() makes this a no-op
        import atexit

        atexit.register(self.end, "clean")
        return self

    def end(self, exit_reason="clean", step=None):
        """Write the ``incarnation_end`` boundary, flush the sidecar,
        close the ledger, and detach the process-wide producer target.
        A killed incarnation never gets here — the missing end record
        is what the reader prices as lost work."""
        global _recorder, _LAST_END
        if self._ended:
            return
        self._ended = True
        _LAST_END = time.time()
        self._write({
            "type": "incarnation_end",
            "time": _LAST_END,
            "exit_reason": str(exit_reason),
            "step": int(step) if step is not None else None,
        })
        self.flush()
        with self._lock:
            if self._fd is not None:
                try:
                    os.close(self._fd)
                except OSError:
                    pass
                self._fd = None
        if _recorder is self:
            _recorder = None

    # -- segments --------------------------------------------------------
    def segment(self, kind, dur_s, step=None, steps=None, **fields):
        """Append one typed wall-clock segment (best-effort)."""
        rec = {"type": "segment", "kind": str(kind),
               "dur_s": float(dur_s), "time": time.time()}
        if step is not None:
            rec["step"] = int(step)
        if steps is not None:
            rec["steps"] = int(steps)
        rec.update(fields)
        if self._write(rec):
            if kind == "compile":
                global _compile_total
                _compile_total += float(dur_s)
            tel = _tel()
            if tel is not None:
                tel.GOODPUT_SEGMENTS.inc(kind=str(kind))

    def flush(self):
        """Commit the prefix-digest sidecar: everything written so far
        is durable-marked ``{bytes, sha256}`` (atomic write)."""
        with self._lock:
            if self._fd is None:
                return
            try:
                os.fsync(self._fd)
            except OSError:
                pass
            sidecar = {"format_version": FORMAT_VERSION,
                       "bytes": self._bytes,
                       "sha256": self._hash.hexdigest(),
                       "time": time.time()}
            self._since_flush = 0
        try:
            _atomic_write(self.path + SIDECAR_SUFFIX,
                          json.dumps(sidecar, sort_keys=True))
        except Exception:
            self._count_error("goodput sidecar write failed")

    # -- internals -------------------------------------------------------
    def _write(self, rec):
        line = (json.dumps(rec, sort_keys=True, default=str) + "\n") \
            .encode("utf-8")
        need_flush = False
        with self._lock:
            if self._fd is None or (self._ended
                                    and rec.get("type") != "incarnation_end"):
                return False
            try:
                os.write(self._fd, line)
            except OSError:
                self._count_error("goodput ledger append failed")
                return False
            self._hash.update(line)
            self._bytes += len(line)
            self._since_flush += 1
            if self.flush_every > 0 and \
                    self._since_flush >= self.flush_every:
                need_flush = True
        if need_flush:
            self.flush()
        return True

    def _count_error(self, msg):
        if not self._warned:
            self._warned = True
            logger.warning("%s (counted, further errors silent)", msg)
        tel = _tel()
        if tel is not None:
            try:
                tel.GOODPUT_WRITE_ERRORS.inc()
            except Exception:
                pass


# ---------------------------------------------------------------------------
# module-level producer API (cheap no-ops while no recorder is live)
# ---------------------------------------------------------------------------

_recorder = None         # the live incarnation recorder, if any
_tls = threading.local()


def active():
    """True while a live recorder is attached (producers' cheap gate)."""
    return _recorder is not None


def record_segment(kind, dur_s, step=None, steps=None, **fields):
    """Producer hook: append a segment to the live recorder (no-op
    when none is attached; never raises)."""
    rec = _recorder
    if rec is not None:
        rec.segment(kind, dur_s, step=step, steps=steps, **fields)


class _CompileGuard:
    """While held, the compile feed's durations are NOT recorded — the
    holder owns the compile segment, so the compiles it triggers
    internally don't double-count."""

    def __enter__(self):
        _tls.in_compile = getattr(_tls, "in_compile", 0) + 1
        return self

    def __exit__(self, *exc):
        _tls.in_compile = getattr(_tls, "in_compile", 1) - 1
        return False


def compile_guard():
    return _CompileGuard()


def compile_seconds_total():
    """Monotonic process-wide compile seconds recorded to the ledger.
    Trainers snapshot this around a step window and carve the delta
    out of that step's ``productive_step`` segment — a jit compile
    that fires inside a step is compile badput, not goodput, and must
    not be claimed twice."""
    return _compile_total


def record_compile(dur_s):
    """The compile feed (``telemetry.note_compile``): records a
    ``compile`` segment unless a compile scope already owns it."""
    if getattr(_tls, "in_compile", 0):
        return
    record_segment("compile", dur_s)


def note_exit(exit_reason, step=None):
    """Producer hook: write the incarnation_end boundary (preemption
    handlers, trainer close).  No-op when no recorder is live."""
    rec = _recorder
    if rec is not None:
        rec.end(exit_reason, step=step)


# ---------------------------------------------------------------------------
# reader: ledger parsing (torn-line discipline)
# ---------------------------------------------------------------------------

def _parse_ledger(path, name):
    """(records, problems, torn) for one incarnation file.  The
    sidecar-verified prefix is the durable part; a digest mismatch is
    a counted torn problem, and the file is STILL parsed best-effort
    line-by-line (a killed incarnation's unflushed tail counts too).
    Unparsable lines are skipped with a counted problem, never a
    crash."""
    problems, torn = [], 0
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError as e:
        return [], ["%s: unreadable (%s)" % (name, e)], 1
    try:
        with open(path + SIDECAR_SUFFIX, encoding="utf-8") as f:
            sidecar = json.load(f)
    except (OSError, ValueError):
        sidecar = None   # died before the first flush — tail-only file
    if isinstance(sidecar, dict):
        try:
            n = int(sidecar.get("bytes", 0))
        except (TypeError, ValueError):
            n = 0
        if n > len(raw):
            torn += 1
            problems.append("%s: sidecar claims %d bytes, file has %d "
                            "(truncated ledger)" % (name, n, len(raw)))
        elif n > 0 and hashlib.sha256(raw[:n]).hexdigest() != \
                sidecar.get("sha256"):
            torn += 1
            problems.append("%s: durable prefix digest mismatch "
                            "(torn ledger)" % name)
    records = []
    for lineno, line in enumerate(raw.split(b"\n"), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line.decode("utf-8"))
            if not isinstance(rec, dict):
                raise ValueError("not an object")
        except (ValueError, UnicodeDecodeError) as e:
            torn += 1
            problems.append("%s:%d: unparsable ledger line (%s) — skipped"
                            % (name, lineno, e))
            continue
        records.append(rec)
    return records, problems, torn


def _num(v, default=None):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return default
    return float(v)


def _assemble(records, name, rank_hint):
    """Fold one file's records into an incarnation dict."""
    inc = {
        "file": name,
        "incarnation": None,
        "rank": rank_hint,
        "n_procs": 1,
        "pid": None,
        "start_time": None,
        "start_reason": "unknown",
        "resumed_from_step": None,
        "end": None,              # {"time", "exit_reason", "step"} | None
        "last_time": None,
        "segments": {},           # kind -> {"seconds", "count"}
        "steps": 0,
        "last_step": None,
        "first_step_time": None,
        "last_ckpt_step": None,
    }
    for rec in records:
        t = _num(rec.get("time"))
        if t is not None:
            if inc["last_time"] is None or t > inc["last_time"]:
                inc["last_time"] = t
            if inc["start_time"] is None or t < inc["start_time"]:
                inc["start_time"] = t
        rtype = rec.get("type")
        if rtype == "incarnation_start":
            inc["incarnation"] = rec.get("incarnation") or inc["incarnation"]
            if isinstance(rec.get("rank"), int):
                inc["rank"] = rec["rank"]
            if isinstance(rec.get("n_procs"), int):
                inc["n_procs"] = rec["n_procs"]
            inc["pid"] = rec.get("pid", inc["pid"])
            inc["start_reason"] = str(rec.get("start_reason", "unknown"))
            rf = rec.get("resumed_from_step")
            if isinstance(rf, int):
                inc["resumed_from_step"] = rf
            if t is not None:
                inc["start_time"] = min(inc["start_time"], t)
        elif rtype == "incarnation_end":
            inc["end"] = {"time": t,
                          "exit_reason": str(rec.get("exit_reason",
                                                     "unknown")),
                          "step": rec.get("step")}
        elif rtype == "segment":
            kind = str(rec.get("kind", "other"))
            dur = _num(rec.get("dur_s"))
            if dur is None or dur < 0:
                continue
            row = inc["segments"].setdefault(kind,
                                             {"seconds": 0.0, "count": 0})
            row["seconds"] += dur
            row["count"] += 1
            if kind == "productive_step":
                inc["steps"] += int(rec.get("steps", 1) or 1)
                step = rec.get("step")
                if isinstance(step, int):
                    if inc["last_step"] is None or step > inc["last_step"]:
                        inc["last_step"] = step
                if t is not None and (inc["first_step_time"] is None
                                      or t < inc["first_step_time"]):
                    inc["first_step_time"] = t
            elif kind == "ckpt_save" and rec.get("committed"):
                step = rec.get("step")
                if isinstance(step, int) and \
                        (inc["last_ckpt_step"] is None
                         or step > inc["last_ckpt_step"]):
                    inc["last_ckpt_step"] = step
    return inc


def read_job(job_dir):
    """Parse every incarnation ledger under ``job_dir``.

    Returns ``{"incarnations": [inc], "problems": [str],
    "torn_lines": n}`` — incarnations sorted by (rank, start time).
    Never raises on ledger content; torn lines/files are counted
    (``mxnet_tpu_goodput_torn_lines_total``) and listed."""
    incs, problems, torn = [], [], 0
    try:
        names = sorted(os.listdir(job_dir))
    except OSError as e:
        return {"incarnations": [],
                "problems": ["%s: cannot list job dir (%s)"
                             % (job_dir, e)],
                "torn_lines": 0}
    for name in names:
        m = _LEDGER_RE.match(name)
        if not m:
            continue
        records, probs, t = _parse_ledger(os.path.join(job_dir, name),
                                          name)
        problems.extend(probs)
        torn += t
        if not records:
            continue
        inc = _assemble(records, name, int(m.group(1)))
        if inc["incarnation"] is None:
            inc["incarnation"] = m.group(2)
        incs.append(inc)
    incs.sort(key=lambda i: (i["rank"], i["start_time"] or 0.0,
                             i["file"]))
    tel = _tel()
    if tel is not None and torn:
        try:
            tel.GOODPUT_TORN_LINES.inc(torn)
        except Exception:
            pass
    return {"incarnations": incs, "problems": problems,
            "torn_lines": torn}


# ---------------------------------------------------------------------------
# reader: pricing + the /goodputz payload
# ---------------------------------------------------------------------------

def _price(inc):
    """One incarnation's bucket decomposition (the lost-work rule).

    killed  = no incarnation_end record.
    baseline = last committed ckpt_save step in this incarnation,
               else the resumed-from step, else 0 (a fresh start).
    lost_steps = steps completed past the baseline; priced at THIS
    incarnation's measured seconds-per-step and moved from goodput to
    lost_work.  ``other`` = wall the segments didn't claim, so the
    buckets sum to wall by construction."""
    seg_s = {k: v["seconds"] for k, v in inc["segments"].items()}
    productive_s = seg_s.get("productive_step", 0.0)
    steps = inc["steps"]
    killed = inc["end"] is None
    baseline = 0
    if inc["resumed_from_step"] is not None:
        baseline = inc["resumed_from_step"]
    if inc["last_ckpt_step"] is not None:
        baseline = max(baseline, inc["last_ckpt_step"])
    lost_steps = 0
    if killed and inc["last_step"] is not None:
        lost_steps = max(0, inc["last_step"] - baseline)
    per_step = (productive_s / steps) if steps > 0 else 0.0
    lost_work_s = min(productive_s, lost_steps * per_step)
    wall = 0.0
    if inc["start_time"] is not None and inc["last_time"] is not None:
        wall = max(0.0, inc["last_time"] - inc["start_time"])
    buckets = {b: 0.0 for b in BUCKETS}
    buckets["goodput"] = productive_s - lost_work_s
    buckets["lost_work"] = lost_work_s
    claimed = productive_s
    for kind in SEGMENT_KINDS:
        if kind == "productive_step":
            continue
        s = seg_s.get(kind, 0.0)
        buckets[kind] = s
        claimed += s
    buckets["other"] = max(0.0, wall - claimed)
    exit_reason = "killed" if killed else inc["end"]["exit_reason"]
    return {
        "incarnation": inc["incarnation"],
        "rank": inc["rank"],
        "pid": inc["pid"],
        "start_time": inc["start_time"],
        "start_reason": inc["start_reason"],
        "resumed_from_step": inc["resumed_from_step"],
        "exit_reason": exit_reason,
        "wall_s": round(wall, 6),
        "steps": steps,
        "step_time_s": round(per_step, 6),
        "last_step": inc["last_step"],
        "last_ckpt_step": inc["last_ckpt_step"],
        "lost_steps": lost_steps,
        "lost_work_s": round(lost_work_s, 6),
        "goodput_s": round(buckets["goodput"], 6),
        "buckets_s": {b: round(v, 6) for b, v in buckets.items()},
        "first_step_time": inc["first_step_time"],
        "last_time": inc["last_time"],
    }


def _mttr(rows):
    """Kill→recovery pairs: for each killed incarnation, the wall
    between its last ledger record and the first productive step of
    the same rank's next incarnation."""
    events = []
    by_rank = {}
    for r in rows:
        by_rank.setdefault(r["rank"], []).append(r)
    for rank, rs in sorted(by_rank.items()):
        rs.sort(key=lambda r: r["start_time"] or 0.0)
        for i, r in enumerate(rs):
            if r["exit_reason"] != "killed" or i + 1 >= len(rs):
                continue
            nxt = rs[i + 1]
            t0, t1 = r["last_time"], nxt["first_step_time"]
            if t0 is None or t1 is None:
                continue
            events.append({"rank": rank,
                           "killed": r["incarnation"],
                           "resumed": nxt["incarnation"],
                           "mttr_s": round(max(0.0, t1 - t0), 6)})
    mean = round(sum(e["mttr_s"] for e in events) / len(events), 6) \
        if events else None
    return {"events": events, "mean_s": mean}


def goodputz(dir=None):
    """The full job-lifetime goodput report (the ``/goodputz``
    endpoint body and the ``tools/goodputz.py`` payload): job totals,
    the bucket decomposition, the per-incarnation table, MTTR, and
    the torn-line count.  Never raises on ledger content; returns
    ``{"active": False, ...}`` when no job dir is configured."""
    d = dir or active_dir()
    if not d:
        return {"active": False,
                "error": "no goodput dir configured "
                         "(MXNET_GOODPUT_DIR or GoodputRecorder)"}
    if not os.path.isdir(d):
        return {"active": False, "dir": str(d),
                "error": "goodput dir does not exist"}
    job = read_job(d)
    rows = [_price(inc) for inc in job["incarnations"]]
    totals = {b: 0.0 for b in BUCKETS}
    wall = 0.0
    steps = lost_steps = 0
    kills = 0
    for r in rows:
        wall += r["wall_s"]
        steps += r["steps"]
        lost_steps += r["lost_steps"]
        if r["exit_reason"] == "killed":
            kills += 1
        for b in BUCKETS:
            totals[b] += r["buckets_s"].get(b, 0.0)
    goodput_s = totals["goodput"]
    pct = round(100.0 * goodput_s / wall, 2) if wall > 0 else None
    for r in rows:
        r["goodput_pct"] = round(100.0 * r["goodput_s"] / r["wall_s"], 2) \
            if r["wall_s"] > 0 else None
    return {
        "active": True,
        "format_version": FORMAT_VERSION,
        "time": round(time.time(), 3),
        "dir": str(d),
        "wall_s": round(wall, 6),
        "goodput_s": round(goodput_s, 6),
        "goodput_pct": pct,
        "badput_s": round(max(0.0, wall - goodput_s), 6),
        "buckets_s": {b: round(v, 6) for b, v in totals.items()},
        "steps": steps,
        "lost_steps": lost_steps,
        "kills": kills,
        "n_ranks": len({r["rank"] for r in rows}),
        "n_incarnations": len(rows),
        "mttr": _mttr(rows),
        "torn_lines": job["torn_lines"],
        "problems": job["problems"],
        "incarnations": rows,
    }


def render_report(payload):
    """Human rendering of a :func:`goodputz` payload (one string)."""
    if not payload.get("active"):
        return "goodput: inactive (%s)" % payload.get("error", "?")
    lines = []
    pct = payload.get("goodput_pct")
    lines.append("goodput report: dir=%s" % payload["dir"])
    lines.append("  wall %.3fs  goodput %.3fs (%s)  steps %d  "
                 "lost_steps %d  kills %d  incarnations %d/%d rank(s)"
                 % (payload["wall_s"], payload["goodput_s"],
                    ("%.2f%%" % pct) if pct is not None else "n/a",
                    payload["steps"], payload["lost_steps"],
                    payload["kills"], payload["n_incarnations"],
                    payload["n_ranks"]))
    if payload["torn_lines"]:
        lines.append("  torn_lines %d (see problems)"
                     % payload["torn_lines"])
    wall = payload["wall_s"] or 0.0
    lines.append("  %-14s %10s %8s" % ("bucket", "seconds", "% wall"))
    for b in BUCKETS:
        v = payload["buckets_s"].get(b, 0.0)
        share = (100.0 * v / wall) if wall > 0 else 0.0
        lines.append("  %-14s %10.3f %7.2f%%" % (b, v, share))
    lines.append("  incarnations:")
    lines.append("    %-5s %-12s %-7s %-8s %6s %8s %-8s %s"
                 % ("rank", "incarnation", "start", "resume@", "steps",
                    "step_s", "exit", "lost"))
    for r in payload["incarnations"]:
        resume = str(r["resumed_from_step"]) \
            if r["resumed_from_step"] is not None else "-"
        lost = "%d (%.3fs)" % (r["lost_steps"], r["lost_work_s"]) \
            if r["lost_steps"] else "-"
        lines.append("    %-5d %-12s %-7s %-8s %6d %8.4f %-8s %s"
                     % (r["rank"], str(r["incarnation"])[:12],
                        r["start_reason"], resume, r["steps"],
                        r["step_time_s"], r["exit_reason"], lost))
    m = payload["mttr"]
    if m["events"]:
        lines.append("  mttr: mean %.3fs over %d restart(s)"
                     % (m["mean_s"], len(m["events"])))
    for p in payload["problems"]:
        lines.append("  problem: %s" % p)
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# perf-ledger bridge (perf_report --goodput; bench runs)
# ---------------------------------------------------------------------------

def _perf_ledger():
    """perf_ledger.py: the package's module, or loaded by file path when
    this module was (the goodputz and perf_report CLIs load it without
    the package)."""
    pl = sys.modules.get("mxnet_tpu_torch.perf_ledger")
    if pl is not None:
        return pl
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "perf_ledger.py")
    spec = importlib.util.spec_from_file_location(
        "mxnet_tpu_torch.perf_ledger", path)
    pl = importlib.util.module_from_spec(spec)
    sys.modules["mxnet_tpu_torch.perf_ledger"] = pl
    spec.loader.exec_module(pl)
    return pl


def ledger_records(payload, run_id=None):
    """Schema-valid perf-ledger records from a :func:`goodputz`
    payload: ``goodput_pct`` (up-good — perf_gate knows), plus the
    lost-work and MTTR scalars, each carrying the bucket decomposition
    as extra fields.  Empty when the payload is inactive or has no
    wall-clock yet."""
    if not payload.get("active") or not payload.get("wall_s"):
        return []
    pl = _perf_ledger()
    extra = {
        "goodput_dir": payload.get("dir"),
        "goodput_buckets_s": payload.get("buckets_s"),
        "n_incarnations": payload.get("n_incarnations"),
        "kills": payload.get("kills"),
    }
    recs = []
    if payload.get("goodput_pct") is not None:
        recs.append(pl.make_record("goodput_pct",
                                   payload["goodput_pct"], "pct",
                                   run_id=run_id, **extra))
    recs.append(pl.make_record("goodput_lost_work_s",
                               payload["buckets_s"].get("lost_work", 0.0),
                               "s", run_id=run_id,
                               lost_steps=payload.get("lost_steps")))
    mean = (payload.get("mttr") or {}).get("mean_s")
    if mean is not None:
        recs.append(pl.make_record("goodput_mttr_s", mean, "s",
                                   run_id=run_id,
                                   restarts=len(payload["mttr"]["events"])))
    return recs


# ---------------------------------------------------------------------------
# serving surfaces: /statusz subsystem + heartbeat field
# ---------------------------------------------------------------------------

def status_summary():
    """The ``goodput`` subsystem of ``/statusz``: job totals only (the
    per-incarnation table is the ``/goodputz`` payload).  Reads every
    ledger in the job dir — cheap at job scale, not per-step."""
    d = active_dir()
    if not d or not os.path.isdir(d):
        return {"active": False}
    p = goodputz(d)
    if not p.get("active"):
        return {"active": False}
    return {
        "active": True,
        "dir": p["dir"],
        "goodput_pct": p["goodput_pct"],
        "wall_s": p["wall_s"],
        "lost_work_s": p["buckets_s"]["lost_work"],
        "lost_steps": p["lost_steps"],
        "kills": p["kills"],
        "n_incarnations": p["n_incarnations"],
        "torn_lines": p["torn_lines"],
    }


def heartbeat_fields():
    """{"goodput_pct"} for the heartbeat line, or None while no job
    dir is active / no wall-clock has accrued yet."""
    d = active_dir()
    if not d or not os.path.isdir(d):
        return None
    p = goodputz(d)
    if not p.get("active") or p.get("goodput_pct") is None:
        return None
    return {"goodput_pct": p["goodput_pct"]}


def _maybe_register_statusz():
    """Register the ``goodput`` /statusz subsystem when this module
    runs inside the package (a standalone tool load has no registry)."""
    tel = _tel()
    if tel is not None:
        try:
            tel.register_status_provider("goodput", status_summary)
        except Exception:
            pass


_maybe_register_statusz()
