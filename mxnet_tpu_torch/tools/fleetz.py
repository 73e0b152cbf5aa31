#!/usr/bin/env python3
"""Fleet observatory CLI: merge a spool dir's per-rank snapshots and
name the straggler.

Usage:
    python mxnet_tpu_torch/tools/fleetz.py SPOOL                 # human-readable table
    python mxnet_tpu_torch/tools/fleetz.py SPOOL --json          # the /fleetz payload
    python mxnet_tpu_torch/tools/fleetz.py SPOOL --stale-after 5 # custom staleness cut
    python mxnet_tpu_torch/tools/fleetz.py SPOOL --top 3         # top-N merged counters

Parity: tools/fleetz.py.  Stdlib-only: ``mxnet_tpu_torch/fleet.py`` is loaded
by file path without importing the ``mxnet_tpu_torch`` package (whose
``__init__`` pulls torch) — the same trick ``perf_report.py`` uses for
the perf ledger.  Other tools (``trace_view.py --fleet``,
``telemetry_dump.py --merge``) import :func:`load_fleet` from here so
there is exactly one loader.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_FLEET_PY = os.path.join(_HERE, os.pardir, "fleet.py")


def load_fleet():
    """The fleet module, without importing the mxnet_tpu_torch package: the
    already-imported module when running inside the package (so state
    like the active spool is shared), else a bare file-path load."""
    mod = sys.modules.get("mxnet_tpu_torch.fleet")
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        "mxnet_tpu_torch.fleet", os.path.abspath(_FLEET_PY))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["mxnet_tpu_torch.fleet"] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop("mxnet_tpu_torch.fleet", None)
        raise
    return mod


def _fmt(v, fmt="%.2f"):
    return fmt % v if isinstance(v, (int, float)) else "-"


def render(view, top=0):
    """Human-readable fleetz report."""
    lines = []
    if not view.get("active"):
        lines.append("fleet: inactive (%s)" % view.get("error", "?"))
        return "\n".join(lines)
    lines.append("fleet spool: %s" % view["spool"])
    header = "%-5s %-8s %-6s %-8s %-7s %-14s %-10s %s" % (
        "rank", "pid", "seq", "age_s", "stale", "wall_ms/step",
        "offset_s", "buckets_ms/step")
    lines.append(header)
    for rank, row in sorted(view["ranks"].items(), key=lambda kv: int(kv[0])):
        buckets = row.get("buckets_ms_per_step") or {}
        btxt = " ".join("%s=%.2f" % (k, v) for k, v in sorted(
            buckets.items()) if isinstance(v, (int, float)))
        lines.append("%-5s %-8s %-6s %-8s %-7s %-14s %-10s %s" % (
            rank, row.get("pid", "-"), row.get("seq", "-"),
            _fmt(row.get("age_s")), "STALE" if row.get("stale") else "ok",
            _fmt(row.get("wall_ms_per_step")),
            _fmt(row.get("clock_offset_s"), "%+.3f"), btxt))
    rep = view.get("straggler") or {}
    if rep.get("straggler") is not None:
        lines.append("straggler: rank %s (skew %.2fx, bucket %s %+.2f "
                     "ms/step vs fleet median)" % (
                         rep["straggler"], rep["skew"], rep["bucket"],
                         rep.get("bucket_delta_ms_per_step") or 0.0))
    else:
        lines.append("straggler: none (%s)" % rep.get("reason", "?"))
    if view.get("torn_snapshots"):
        lines.append("warning: %d torn snapshot(s) skipped"
                     % view["torn_snapshots"])
    for prob in view.get("problems", []):
        lines.append("warning: %s" % prob)
    if top:
        merged = view.get("merged_metrics") or {}
        counters = []
        for name, fam in merged.items():
            if fam.get("type") != "counter":
                continue
            for s in fam.get("series", []):
                v = s.get("value", 0)
                if isinstance(v, (int, float)) and v:
                    counters.append((v, name, s.get("labels") or {}))
        counters.sort(key=lambda t: (-t[0], t[1]))
        if counters:
            lines.append("top merged counters:")
            for v, name, labels in counters[:top]:
                ltxt = ",".join("%s=%s" % kv for kv in sorted(
                    labels.items()))
                lines.append("  %-52s %s" % (
                    name + ("{%s}" % ltxt if ltxt else ""), v))
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="merge a fleet spool and "
                                            "report the straggler")
    p.add_argument("spool", help="fleet spool directory")
    p.add_argument("--stale-after", type=float, default=None,
                   help="staleness cut in seconds (MXNET_FLEET_STALE)")
    p.add_argument("--json", action="store_true",
                   help="emit the raw /fleetz payload")
    p.add_argument("--top", type=int, default=5,
                   help="show the top-N merged counters (0 = none)")
    args = p.parse_args(argv)
    fleet = load_fleet()
    view = fleet.fleetz(spool=args.spool, stale_after=args.stale_after)
    if args.json:
        json.dump(view, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print(render(view, top=args.top))
    if not view.get("active"):
        return 1
    # an empty merge is a diagnosis, not a report: a spool with no
    # durable snapshots (wrong dir? publishers never attached?) or one
    # where every rank went stale (job dead? staleness cut too tight?)
    # must say so and fail, never exit 0 with an empty table
    ranks = view.get("ranks") or {}
    if not ranks:
        print("fleetz: no durable rank snapshots in %s — is this the "
              "right spool dir, and did any FleetPublisher attach? "
              "(%d torn snapshot(s))"
              % (view["spool"], view.get("torn_snapshots", 0)),
              file=sys.stderr)
        return 1
    if all(row.get("stale") for row in ranks.values()):
        print("fleetz: all %d rank snapshot(s) in %s are stale "
              "(older than %.1fs) — the job is dead or the "
              "--stale-after cut is too tight"
              % (len(ranks), view["spool"],
                 view.get("stale_after_s", 0.0)),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
