"""Where did the milliseconds go: the perf-ledger reporter (parity:
tools/perf_report.py).

Reads the append-only JSONL run ledger every bench emitter writes
through ``mxnet_tpu_torch/perf_ledger.py`` and renders

* **one run** — every metric row plus the step-time attribution table
  (device_compute / compile / aot_load / data_wait / host_other,
  ms/step and share of wall), optionally merged with a unified chrome
  trace (``--trace``: top span aggregates) and a telemetry JSON dump
  (``--telemetry``: the step/gap/compile families);
* **a delta between two runs** (``--diff A B``) — per-metric change
  with its noise-free attribution story ("device_compute -4.1%,
  host_other +9.3%"), the decision view the on-chip payoff sweep
  flips defaults from;
* **--backfill** — ingests the pre-schema run files (BENCH_r0*.json
  bench captures, MULTICHIP/MULTIHOST dryrun artifacts) into the
  ledger with provenance marked ``unknown``, so the r02-r05 flat-line
  is queryable history instead of dead files.

Stdlib-only on purpose (perf_ledger is loaded standalone, no torch
import): reporting the history must stay a sub-second operation.

    python mxnet_tpu_torch/tools/perf_report.py --ledger perf_ledger.jsonl
    python mxnet_tpu_torch/tools/perf_report.py --ledger perf_ledger.jsonl --run a1b2c3
    python mxnet_tpu_torch/tools/perf_report.py --ledger perf_ledger.jsonl --diff A B
    python mxnet_tpu_torch/tools/perf_report.py --ledger perf_ledger.jsonl \
        --backfill BENCH_r0*.json MULTICHIP_r0*.json MULTIHOST_r0*.json
"""
import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)


def load_perf_ledger():
    """Load mxnet_tpu_torch/perf_ledger.py WITHOUT importing the package
    (no torch): the module is stdlib-only at import time by contract."""
    path = os.path.join(PKG, "perf_ledger.py")
    spec = importlib.util.spec_from_file_location("_perf_ledger", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pl = load_perf_ledger()


# ---------------------------------------------------------------------------
# backfill: pre-schema run files -> ledger rows
# ---------------------------------------------------------------------------

def backfill_file(path):
    """Records for one legacy run artifact.  Recognized shapes:

    * bench captures (``BENCH_r0*.json``): ``parsed`` when the
      bench's JSON line was extracted, else the stdout ``tail`` is
      scanned with the legacy brace heuristic;
    * multichip dryruns (``n_devices``/``ok``): a 0/1 pass metric;
    * multihost dryruns (``n_procs``/``ok``): same;
    * anything already carrying ``metric``/``value``: passed through.

    Provenance is all ``unknown`` (that is the point of the schema
    field: absence of provenance is now explicit, not implied)."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    run_id = os.path.splitext(os.path.basename(path))[0]
    prov = {k: pl._UNKNOWN for k in pl.PROVENANCE_KEYS}
    mtime = round(os.path.getmtime(path), 3)

    def rec(metric, value, unit, **fields):
        r = {"schema_version": pl.SCHEMA_VERSION, "run_id": run_id,
             "time": mtime, "metric": str(metric), "value": value,
             "unit": str(unit), "provenance": dict(prov),
             "source": os.path.basename(path), "backfill": True}
        r.update(fields)
        return r

    out = []
    if not isinstance(data, dict):
        return out
    if "tail" in data and ("parsed" in data or "cmd" in data):
        rows = []
        if isinstance(data.get("parsed"), dict) and \
                data["parsed"].get("metric"):
            rows = [data["parsed"]]
        else:
            rows = pl.parse_bench_lines(data.get("tail") or "")
        for row in rows:
            fields = {k: v for k, v in row.items()
                      if k not in ("metric", "value", "unit")}
            out.append(rec(row["metric"], row.get("value"),
                           row.get("unit", pl._UNKNOWN),
                           rc=data.get("rc"), **fields))
        if not rows:
            # a timed-out/failed round is itself history worth keeping
            out.append(rec("bench_run_ok",
                           1.0 if data.get("rc") == 0 else 0.0, "bool",
                           rc=data.get("rc")))
    elif "n_devices" in data:
        out.append(rec("multichip_dryrun_ok",
                       1.0 if data.get("ok") else 0.0, "bool",
                       n_devices=data.get("n_devices"),
                       rc=data.get("rc"),
                       skipped=data.get("skipped")))
    elif "n_procs" in data:
        out.append(rec("multihost_dryrun_ok",
                       1.0 if data.get("ok") else 0.0, "bool",
                       n_procs=data.get("n_procs"),
                       dev_per_proc=data.get("dev_per_proc"),
                       topology=data.get("topology")))
    elif data.get("metric") is not None:
        fields = {k: v for k, v in data.items()
                  if k not in ("metric", "value", "unit")}
        out.append(rec(data["metric"], data.get("value"),
                       data.get("unit", pl._UNKNOWN), **fields))
    return [r for r in out if not pl.validate_record(r)]


def backfill(paths, ledger):
    total = 0
    for path in paths:
        try:
            recs = backfill_file(path)
        except (OSError, ValueError) as e:
            print("backfill: %s: unreadable (%s)" % (path, e),
                  file=sys.stderr)
            continue
        if not recs:
            print("backfill: %s: no ingestible records" % path,
                  file=sys.stderr)
            continue
        pl.append(recs, path=ledger)
        total += len(recs)
        print("backfill: %s -> %d record(s)" % (path, len(recs)))
    print("backfill: %d record(s) appended to %s" % (total, ledger))
    return 0 if total else 2


# ---------------------------------------------------------------------------
# report rendering
# ---------------------------------------------------------------------------

def group_runs(records):
    """run_id -> [records], ordered by each run's first timestamp."""
    runs = {}
    for r in records:
        runs.setdefault(r["run_id"], []).append(r)
    return dict(sorted(runs.items(),
                       key=lambda kv: min(r["time"] for r in kv[1])))


def _fmt_val(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        return "%.4g" % v
    return str(v)


def _attribution_of(recs):
    """The run's attribution dict (first record that carries one)."""
    for r in recs:
        if isinstance(r.get("attribution"), dict):
            return r["attribution"]
    return None


def render_run(run_id, recs, trace=None, telemetry=None):
    lines = ["run %s (%d record(s))" % (run_id, len(recs))]
    prov = recs[0].get("provenance", {})
    lines.append("  provenance: git=%s jax=%s backend=%s x%s "
                 "dtype=%s aot=%s"
                 % (str(prov.get("git_sha"))[:12], prov.get("jax_version"),
                    prov.get("backend"), prov.get("device_count"),
                    prov.get("dtype_policy"), prov.get("aot")))
    lines.append("  %-48s %14s  %s" % ("metric", "value", "unit"))
    for r in sorted(recs, key=lambda r: r["metric"]):
        lines.append("  %-48s %14s  %s"
                     % (r["metric"][:48], _fmt_val(r["value"]), r["unit"]))
    attr = _attribution_of(recs)
    if attr:
        wall = attr.get("wall_ms_per_step") or 0.0
        lines.append("  where did the milliseconds go "
                     "(%s steps, %.3f ms wall/step):"
                     % (attr.get("steps", "?"), wall))
        buckets = _buckets_of(attr)
        order = [b for b in pl.BREAKDOWN_BUCKETS if b in buckets] + \
            sorted(set(buckets) - set(pl.BREAKDOWN_BUCKETS))
        for name in order:
            ms = buckets[name]
            share = 100.0 * ms / wall if wall else 0.0
            lines.append("    %-15s %10.3f ms  %5.1f%%"
                         % (name, ms, share))
    if trace:
        lines.extend(render_trace(trace))
    if telemetry:
        lines.extend(render_telemetry(telemetry))
    return lines


def render_trace(path, top=10):
    """Top span aggregates of a unified chrome trace (tracing.py
    export or a flight-recorder bundle's trace.json)."""
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    events = payload.get("traceEvents", payload)
    agg = {}
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        name = ev.get("name", "?")
        tot, n = agg.get(name, (0.0, 0))
        agg[name] = (tot + float(ev.get("dur", 0.0)), n + 1)
    lines = ["  trace spans (%s; top %d by total time):"
             % (os.path.basename(path), top)]
    for name, (tot, n) in sorted(agg.items(), key=lambda kv: -kv[1][0])[
            :top]:
        lines.append("    %-32s %10.3f ms total  x%d  (%.3f ms avg)"
                     % (name[:32], tot / 1e3, n, tot / 1e3 / max(n, 1)))
    return lines


_TELEMETRY_FAMILIES = ("mxnet_tpu_train_step_seconds",
                       "mxnet_tpu_host_gap_seconds",
                       "mxnet_tpu_device_prefetch_wait_seconds",
                       "mxnet_tpu_compile_seconds",
                       "mxnet_tpu_aot_load_seconds",
                       "mxnet_tpu_train_steps_total",
                       "mxnet_tpu_train_mfu_ratio")


def render_telemetry(path):
    """The attribution-relevant families of a telemetry.dump() JSON."""
    with open(path, encoding="utf-8") as f:
        snap = json.load(f)
    metrics = snap.get("metrics", {})
    lines = ["  telemetry (%s):" % os.path.basename(path)]
    for name in _TELEMETRY_FAMILIES:
        fam = metrics.get(name)
        if not fam:
            continue
        for s in fam.get("series", []):
            label = ",".join("%s=%s" % kv
                             for kv in (s.get("labels") or {}).items())
            if fam["type"] == "histogram":
                cnt = s.get("count", 0)
                mean = (s.get("sum", 0.0) / cnt) if cnt else 0.0
                lines.append("    %-44s count=%-6d mean=%.6fs"
                             % ("%s{%s}" % (name, label), cnt, mean))
            else:
                lines.append("    %-44s %s"
                             % ("%s{%s}" % (name, label),
                                _fmt_val(s.get("value"))))
    return lines


def render_diff(run_a, recs_a, run_b, recs_b):
    """Per-metric delta + the attributed milliseconds story."""
    lines = ["delta %s -> %s" % (run_a, run_b)]
    by_a = {r["metric"]: r for r in recs_a}
    by_b = {r["metric"]: r for r in recs_b}
    lines.append("  %-48s %12s %12s %9s" % ("metric", run_a[:12],
                                            run_b[:12], "delta"))
    for m in sorted(set(by_a) & set(by_b)):
        va, vb = by_a[m]["value"], by_b[m]["value"]
        delta = "-"
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)) \
                and va:
            delta = "%+.1f%%" % (100.0 * (vb - va) / abs(va))
        lines.append("  %-48s %12s %12s %9s"
                     % (m[:48], _fmt_val(va), _fmt_val(vb), delta))
    only_a = sorted(set(by_a) - set(by_b))
    only_b = sorted(set(by_b) - set(by_a))
    if only_a:
        lines.append("  only in %s: %s" % (run_a, ", ".join(only_a)))
    if only_b:
        lines.append("  only in %s: %s" % (run_b, ", ".join(only_b)))
    attr_a, attr_b = _attribution_of(recs_a), _attribution_of(recs_b)
    if attr_a or attr_b:
        # one-sided attribution is the NORMAL case against backfilled
        # pre-schema history (provenance=unknown rows carry none):
        # missing buckets read as zero so the story still renders,
        # instead of raising / silently dropping the whole section
        ba = _buckets_of(attr_a)
        bb = _buckets_of(attr_b)
        lines.append("  attribution (ms/step%s):"
                     % ("; %s has none, read as zero"
                        % (run_a if not ba else run_b)
                        if not (ba and bb) else ""))
        parts = []
        names = [n for n in pl.BREAKDOWN_BUCKETS
                 if n in ba or n in bb] or list(pl.BREAKDOWN_BUCKETS)
        names += sorted((set(ba) | set(bb)) - set(names))
        for name in names:
            a, b = ba.get(name, 0.0), bb.get(name, 0.0)
            pct = (100.0 * (b - a) / a) if a else (100.0 if b else 0.0)
            lines.append("    %-15s %10.3f -> %10.3f  (%+.1f%%)"
                         % (name, a, b, pct))
            if abs(b - a) > 1e-9:
                parts.append("%s %+.1f%%" % (name, pct))
        if parts:
            lines.append("  story: " + ", ".join(parts))
    return lines


def _buckets_of(attr):
    """The buckets_ms_per_step dict of one side's attribution, {} when
    the side has no attribution or a malformed one (backfilled rows)."""
    if not isinstance(attr, dict):
        return {}
    buckets = attr.get("buckets_ms_per_step")
    if not isinstance(buckets, dict):
        return {}
    return {k: v for k, v in buckets.items()
            if isinstance(v, (int, float))}


def goodput_report(job_dir, ledger=None):
    """--goodput: render the job-lifetime goodput/badput report (the
    same numbers /goodputz and the goodput statusz subsystem serve)
    and, with --ledger, append the schema-valid goodput records."""
    sys.path.insert(0, HERE)
    from goodputz import load_goodput

    gp = load_goodput()
    payload = gp.goodputz(dir=job_dir)
    print(gp.render_report(payload))
    if not payload.get("active"):
        print("perf_report: goodput: %s"
              % payload.get("error", "inactive"), file=sys.stderr)
        return 2
    if not payload.get("n_incarnations"):
        print("perf_report: goodput: no incarnation ledgers in %s"
              % job_dir, file=sys.stderr)
        return 2
    if ledger:
        recs = gp.ledger_records(payload)
        pl.append(recs, path=ledger)
        print("appended %d goodput record(s) to %s"
              % (len(recs), ledger))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ledger",
                   help="JSONL run ledger (perf_ledger.emit appends; "
                        "MXNET_PERF_LEDGER names it for bench runs); "
                        "required except with --goodput")
    p.add_argument("--run", help="report only this run id "
                                 "(default: every run, newest last)")
    p.add_argument("--diff", nargs=2, metavar=("RUN_A", "RUN_B"),
                   help="attributed delta between two run ids "
                        "('latest'/'prev' resolve positionally)")
    p.add_argument("--backfill", nargs="+", metavar="FILE",
                   help="ingest legacy run files (BENCH_r0*.json / "
                        "MULTICHIP / MULTIHOST) into the ledger")
    p.add_argument("--trace", help="unified chrome trace to merge into "
                                   "the single-run view")
    p.add_argument("--telemetry", help="telemetry.dump() JSON to merge "
                                       "into the single-run view")
    p.add_argument("--goodput", metavar="JOB_DIR",
                   help="render the job-lifetime goodput report for "
                        "this goodput dir (goodput.py ledgers); with "
                        "--ledger, also appends the schema-valid "
                        "goodput_pct/lost-work records so the bench "
                        "history carries the job-level view")
    args = p.parse_args(argv)

    if args.goodput:
        return goodput_report(args.goodput, args.ledger)

    if args.ledger is None:
        p.error("--ledger is required (except with --goodput)")

    if args.backfill:
        return backfill(args.backfill, args.ledger)

    if not os.path.exists(args.ledger):
        print("perf_report: ledger %s does not exist" % args.ledger,
              file=sys.stderr)
        return 2
    records, problems = pl.read_ledger(args.ledger)
    for lineno, msg in problems:
        print("perf_report: %s:%d: %s" % (args.ledger, lineno, msg),
              file=sys.stderr)
    if not records:
        print("perf_report: no valid records in %s" % args.ledger,
              file=sys.stderr)
        return 2
    runs = group_runs(records)
    ids = list(runs)

    def resolve(token):
        if token == "latest":
            return ids[-1]
        if token == "prev":
            if len(ids) < 2:
                # a one-run ledger has no previous run; silently
                # diffing the run against itself would read as "no
                # change" where no comparison exists
                print("perf_report: 'prev' needs at least two runs in "
                      "the ledger (have %d)" % len(ids),
                      file=sys.stderr)
                return None
            return ids[-2]
        if token in runs:
            return token
        print("perf_report: unknown run id %r (have: %s)"
              % (token, ", ".join(ids)), file=sys.stderr)
        return None

    out = []
    if args.diff:
        a, b = resolve(args.diff[0]), resolve(args.diff[1])
        if a is None or b is None:
            return 2
        out = render_diff(a, runs[a], b, runs[b])
    elif args.run:
        rid = resolve(args.run)
        if rid is None:
            return 2
        out = render_run(rid, runs[rid], trace=args.trace,
                         telemetry=args.telemetry)
    else:
        for rid in ids:
            out.extend(render_run(rid, runs[rid]))
            out.append("")
        # a merged trace/telemetry view only makes sense for one run
        if args.trace:
            out.extend(render_trace(args.trace))
        if args.telemetry:
            out.extend(render_telemetry(args.telemetry))
    print("\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
