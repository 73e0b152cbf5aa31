"""The fusion plan and its shape-keyed cost table (parity:
mxnet_tpu/fusion_cost.py).

* ``resolve_fusion`` turns a ``fusion=`` argument (or the
  ``MXNET_FUSION`` default) into a :class:`FusionPlan`; ``apply_fusion``
  (``symbol/fusion.py``) asks the plan, site by site, whether a pattern's
  rewrite fires.
* A cost table holds a measured fused and unfused time per site, keyed
  ``pattern|dtype|shape`` (:func:`shape_key`); it comes from
  ``MXNET_FUSION_TUNE`` (a JSON path) or :func:`set_cost_table`
  (``config.fusion_cost_table``).  Its JSON schema is the JAX package's,
  so a table either package writes loads in the other.  The port ships
  no table: without one, the patterns whose math is the unfused graph's
  (``default_on``) fire and the others do not.
* :meth:`FusionPlan.decide`: a measured speedup of at least
  ``SPEEDUP_FIRE`` fires a pattern that is off by default, one below
  ``SPEEDUP_KEEP`` suppresses one that is on; otherwise, or with no
  entry, ``default_on`` decides.  Named patterns (``fusion="norm_act"``)
  always fire.
* A block's compiled forward (``hybridize``, ``ShardedTrainer``) has no
  Symbol graph to rewrite: it installs the plan with :func:`scope` for
  the trace, and an op's shape-specialized fast path (LayerNorm's) asks
  :func:`runtime_decision` with the traced shape.  The scope is a
  thread-local that exists from each thread's start, as a compiled graph
  guards on what it reads.

``note_fired`` counts a fired rewrite in telemetry (``FUSION_REWRITES``)
and marks it with a ``fusion:<pattern>`` span, as the JAX package's does
at trace time.  Inside a ``torch.compile`` trace it records nothing: a
lock or a clock read there would break the graph (``fullgraph=True``).
"""
from __future__ import annotations

import contextlib
import datetime
import json
import os
import re
import threading
import warnings

from .base import MXNetError
from . import config as _config

__all__ = ["shape_key", "CostTable", "validate_table", "load_table",
           "save_table", "set_cost_table", "current_table",
           "FusionPlan", "resolve_fusion", "scope", "current_plan",
           "runtime_decision", "note_fired", "migrate_legacy_table",
           "clear_cost_table", "SPEEDUP_FIRE", "SPEEDUP_KEEP",
           "TABLE_VERSION"]

# a default-OFF pattern fires when measured at least this much faster;
# a default-ON pattern is suppressed when measured slower than parity.
# The asymmetric band keeps noise (~±3% on the CPU harness) from
# flapping decisions run-to-run.
SPEEDUP_FIRE = 1.05
SPEEDUP_KEEP = 1.0
TABLE_VERSION = 1

# ordered: "bfloat16" MUST precede "float16" — the tag match is a
# substring scan and "float16" is a substring of "bfloat16"
_DTYPE_TAGS = {"bfloat16": "bf16", "float32": "f32", "float64": "f64",
               "float16": "f16", "int32": "i32", "int64": "i64"}

# pattern|dtype|DxDx...[|ax<k>]
_KEY_RE = re.compile(
    r"^[A-Za-z0-9_]+\|[a-z0-9]+\|\d+(x\d+)*(\|ax-?\d+)?(\|[a-z0-9.]+)?$")
# the pre-dtype key form (pattern|DxD...): recognized only to emit a
# targeted migration message and to drive migrate_legacy_table — a
# bf16 site must never silently reuse an f32 measurement, so these
# keys are invalid until migrated
_LEGACY_KEY_RE = re.compile(
    r"^[A-Za-z0-9_]+\|\d+(x\d+)*(\|ax-?\d+)?(\|[a-z0-9.]+)?$")

_ENTRY_REQUIRED = ("pattern", "fused_ms", "unfused_ms", "speedup")


def _dtype_tag(dtype):
    s = str(dtype)
    # torch and numpy dtypes stringify with the canonical name in them
    for name, tag in _DTYPE_TAGS.items():
        if name in s:
            return tag
    return re.sub(r"[^a-z0-9]", "", s.lower()) or "f32"


def shape_key(pattern, shape, dtype="float32", axis=None, extra=None):
    """Canonical cost-table key for one rewrite site.

    The same function keys measurements (``microbench``) and bind-time
    lookups, so a table measured on one device drops into another's
    config (the device rides in the table meta, the key stays
    device-neutral).  ``axis`` is canonicalized to its negative form so
    semantically identical spellings (axis=2 vs axis=-1 on 3-D data) hit
    the same entry; ``extra`` is a pattern-supplied
    discriminator tag (e.g. conv geometry) appended verbatim."""
    key = "%s|%s|%s" % (pattern, _dtype_tag(dtype),
                        "x".join(str(int(d)) for d in shape))
    if axis is not None:
        ax = int(axis)
        if ax >= 0:
            ax -= len(shape)
        key += "|ax%d" % ax
    if extra:
        key += "|%s" % extra
    return key


def validate_table(data, max_age_days=None, now=None):
    """Schema/shape-key/staleness check for a cost-table dict.

    Returns ``(problems, stale)``: ``problems`` are malformed-input
    errors; ``stale`` are entries older than ``max_age_days`` (reported,
    not fatal — an old measurement is still a measurement)."""
    problems, stale = [], []
    if not isinstance(data, dict):
        return ["table is not a JSON object"], stale
    if data.get("version") != TABLE_VERSION:
        problems.append("version %r != supported %d"
                        % (data.get("version"), TABLE_VERSION))
    entries = data.get("entries")
    if not isinstance(entries, dict):
        return problems + ["'entries' missing or not an object"], stale
    now = now if now is not None else datetime.datetime.now(
        datetime.timezone.utc)
    for key, e in entries.items():
        if not _KEY_RE.match(key):
            if _LEGACY_KEY_RE.match(key):
                problems.append(
                    "legacy shape key %r is missing its dtype "
                    "component — a bf16 site would reuse this f32 "
                    "measurement; migrate with "
                    "fusion_cost.migrate_legacy_table" % key)
            else:
                problems.append("bad shape key %r (want pattern|dtype|"
                                "DxD[|axK])" % key)
            continue
        if not isinstance(e, dict):
            problems.append("entry %r is not an object" % key)
            continue
        for f in _ENTRY_REQUIRED:
            if f not in e:
                problems.append("entry %r missing field %r" % (key, f))
            elif f != "pattern" and not isinstance(e[f], (int, float)):
                problems.append("entry %r field %r is not numeric"
                                % (key, f))
        if e.get("pattern") and key.split("|", 1)[0] != e["pattern"]:
            problems.append("entry %r pattern field %r does not match "
                            "its key" % (key, e["pattern"]))
        if isinstance(e.get("speedup"), (int, float)) and \
                e["speedup"] <= 0:
            problems.append("entry %r speedup %r is not positive"
                            % (key, e["speedup"]))
        if max_age_days is not None and e.get("measured_at"):
            try:
                ts = datetime.datetime.fromisoformat(
                    str(e["measured_at"]))
                if ts.tzinfo is None:
                    ts = ts.replace(tzinfo=datetime.timezone.utc)
                age = (now - ts).total_seconds() / 86400.0
                if age > max_age_days:
                    stale.append("%s (measured %.0f days ago)"
                                 % (key, age))
            except ValueError:
                problems.append("entry %r measured_at %r is not ISO-8601"
                                % (key, e["measured_at"]))
    return problems, stale


def migrate_legacy_table(data):
    """Rewrite pre-dtype keys (``pattern|DxD...``) to the current form
    by inserting the ``f32`` tag those measurements were taken under.

    Returns ``(migrated_data, n_migrated)``; the input is not mutated.
    Collisions (a legacy key whose migrated form already exists) keep
    the EXPLICIT entry — a measured-with-dtype entry always outranks an
    assumed-f32 legacy one."""
    if not isinstance(data, dict) or not isinstance(data.get("entries"),
                                                    dict):
        return data, 0
    out = {k: v for k, v in data.items() if k != "entries"}
    entries = {}
    n = 0
    for key, e in data["entries"].items():
        if not _KEY_RE.match(key) and _LEGACY_KEY_RE.match(key):
            pattern, rest = key.split("|", 1)
            new_key = "%s|f32|%s" % (pattern, rest)
            if new_key not in data["entries"]:
                entries[new_key] = e
                n += 1
            continue
        entries[key] = e
    out["entries"] = entries
    return out, n


class CostTable:
    """In-memory view of a measured cost table (see module doc)."""

    __slots__ = ("entries", "meta", "_sha_cache")

    def __init__(self, entries=None, meta=None):
        self.entries = dict(entries or {})
        self.meta = dict(meta or {})
        self._sha_cache = None

    @classmethod
    def from_dict(cls, data, source="<dict>"):
        problems, _stale = validate_table(data)
        if problems:
            raise MXNetError("invalid fusion cost table %s: %s"
                             % (source, "; ".join(problems[:5])))
        meta = {k: v for k, v in data.items() if k != "entries"}
        return cls(data["entries"], meta)

    def to_dict(self):
        d = dict(self.meta)
        d.setdefault("version", TABLE_VERSION)
        d["entries"] = self.entries
        return d

    def speedup(self, key):
        e = self.entries.get(key)
        return e.get("speedup") if isinstance(e, dict) else None

    def add(self, key, fused_ms, unfused_ms, **extra):
        e = {"pattern": key.split("|", 1)[0],
             "fused_ms": round(float(fused_ms), 6),
             "unfused_ms": round(float(unfused_ms), 6),
             "speedup": round(float(unfused_ms) / max(float(fused_ms),
                                                      1e-12), 4),
             "measured_at": datetime.datetime.now(
                 datetime.timezone.utc).isoformat(timespec="seconds")}
        e.update(extra)
        self.entries[key] = e
        self._sha_cache = None   # content changed, even on overwrite
        return e

    def content_sha(self):
        """16-hex content hash of the table (cached until the next
        :meth:`add`) — the /statusz and provenance identity: two runs
        fusing from different measurements are not comparable."""
        if self._sha_cache is None:
            import hashlib

            blob = json.dumps(self.to_dict(), sort_keys=True).encode()
            self._sha_cache = hashlib.sha256(blob).hexdigest()[:16]
        return self._sha_cache


def load_table(path):
    """Load + validate a cost table; raises MXNetError on malformed
    input."""
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError as e:
        raise MXNetError("fusion cost table %s: cannot read (%s)"
                         % (path, e))
    except ValueError as e:
        raise MXNetError("fusion cost table %s: malformed JSON (%s)"
                         % (path, e))
    return CostTable.from_dict(data, source=path)


def save_table(path, table):
    """Atomically persist ``table`` (CostTable or dict) as JSON."""
    from .checkpoint import atomic_write

    data = table.to_dict() if isinstance(table, CostTable) else table
    atomic_write(os.fspath(path),
                 json.dumps(data, indent=2, sort_keys=True).encode())
    return path


# ---------------------------------------------------------------------------
# active table: config override > MXNET_FUSION_TUNE env path
# ---------------------------------------------------------------------------

_UNSET = object()
_override = _UNSET       # None = explicitly no table; CostTable; path str
_path_cache = {}         # path -> (mtime, CostTable | None)
_warned_paths = set()


def set_cost_table(table):
    """Install the process-wide cost table (``config.fusion_cost_table``
    calls this): a path, a CostTable/dict, or None to force no table.
    Pass ``_UNSET``-clearing is done via :func:`clear_cost_table`."""
    global _override
    if isinstance(table, dict):
        table = CostTable.from_dict(table)
    _override = table


def clear_cost_table():
    """Back to the env default (``MXNET_FUSION_TUNE``)."""
    global _override
    _override = _UNSET
    _path_cache.clear()
    _warned_paths.clear()


def _load_cached(path):
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = None
    hit = _path_cache.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    table = None
    try:
        table = load_table(path)
    except MXNetError as e:
        # a broken table must not break every bind: warn once, fuse on
        # defaults (the conservative direction)
        if path not in _warned_paths:
            _warned_paths.add(path)
            warnings.warn(str(e))
    _path_cache[path] = (mtime, table)
    return table


def current_table():
    """The active cost table, or None."""
    if _override is not _UNSET:
        if isinstance(_override, (str, os.PathLike)):
            return _load_cached(os.fspath(_override))
        return _override
    path = _config.get("MXNET_FUSION_TUNE")
    if not path:
        return None
    return _load_cached(path)


# ---------------------------------------------------------------------------
# fusion plan
# ---------------------------------------------------------------------------


class FusionPlan:
    """Resolved fusion policy: which patterns may fire, forced or
    table/default gated."""

    __slots__ = ("patterns", "force", "table")

    def __init__(self, patterns=None, force=False, table=None):
        self.patterns = patterns  # None = every registered pattern
        self.force = force
        self.table = table

    def wants(self, pattern):
        return self.patterns is None or pattern in self.patterns

    def decide(self, pattern, default_on, key=None):
        """Should the ``pattern`` rewrite fire at the site ``key``?"""
        if not self.wants(pattern):
            return False
        if self.force:
            return True
        if self.table is not None and key is not None:
            sp = self.table.speedup(key)
            if sp is not None:
                if sp >= SPEEDUP_FIRE:
                    return True
                if sp < SPEEDUP_KEEP:
                    return False
        return bool(default_on)

    def needs_shapes(self):
        """Bind-time sites only need shape inference when a table could
        flip a decision."""
        return self.table is not None and not self.force

    def __repr__(self):
        return "FusionPlan(patterns=%r, force=%r, table=%s)" % (
            self.patterns, self.force,
            "yes" if self.table is not None else "no")


def resolve_fusion(spec):
    """``fusion=`` argument -> FusionPlan or None (fusion off).

    Accepted: None (defer to ``MXNET_FUSION``), bool, ``"off"``/
    ``"none"``/``"0"``, ``""``/``"default"``/``"on"``/``"1"`` (default
    patterns + cost table), ``"all"`` (force every pattern), or a
    comma/plus-separated pattern-name list (forced).  Unknown names
    raise ValueError at bind — same fail-fast contract as
    ``remat_policy``."""
    if spec is None:
        spec = _config.get("MXNET_FUSION")
    if isinstance(spec, FusionPlan):
        return spec
    if spec is False:
        return None
    if spec is True:
        spec = "default"
    s = str(spec).strip()
    low = s.lower()
    if low in ("off", "none", "0", "false"):
        return None
    if low in ("", "default", "on", "1", "true"):
        return FusionPlan(patterns=None, force=False,
                          table=current_table())
    if low == "all":
        return FusionPlan(patterns=None, force=True, table=None)
    names = [t for t in re.split(r"[,+\s]+", s) if t]
    from .symbol import fusion as _fusion

    known = set(_fusion.list_patterns())
    unknown = [n for n in names if n not in known]
    if unknown:
        raise ValueError(
            "unknown fusion pattern(s) %s; registered: %s (or use "
            "'default'/'all'/'off')" % (unknown, sorted(known)))
    return FusionPlan(patterns=names, force=True, table=None)


# ---------------------------------------------------------------------------
# runtime (trace-time) plan context for the block paths
# ---------------------------------------------------------------------------

class _PlanState(threading.local):
    def __init__(self):
        self.plan = None


_plan_state = _PlanState()


@contextlib.contextmanager
def scope(plan):
    """Install ``plan`` for the duration of a block's trace (CachedOp,
    ShardedTrainer); shape-specialized op fast paths consult it through
    :func:`runtime_decision`."""
    prev = _plan_state.plan
    _plan_state.plan = plan
    try:
        yield plan
    finally:
        _plan_state.plan = prev


def current_plan():
    return _plan_state.plan


def note_fired(pattern, site, key=None):
    """Telemetry counter + trace annotation for one fired rewrite of
    ``pattern`` at ``site`` (cost-table ``key``), so wins are
    attributable in the exports.  Silent while dynamo traces."""
    import torch

    if torch.compiler.is_compiling():
        return
    from . import telemetry as _telemetry

    if _telemetry.enabled():
        _telemetry.FUSION_REWRITES.inc(pattern=pattern)
    from . import tracing as _tracing

    if _tracing.enabled():
        sp = _tracing.begin("fusion:%s" % pattern,
                            args={"site": site, "key": key})
        sp.end()


def runtime_decision(pattern, shape, dtype, default_on=False, axis=None,
                     site="<trace>"):
    """Per-shape decision inside a traced op fast path.  Shapes are
    concrete during the trace, so the lookup uses the same keys the
    measurements were taken under.  Returns False when no plan is
    installed (eager calls keep the stock op)."""
    plan = _plan_state.plan
    if plan is None:
        return False
    key = shape_key(pattern, shape, dtype, axis=axis)
    ok = plan.decide(pattern, default_on, key)
    if ok:
        note_fired(pattern, site, key)
    return ok
