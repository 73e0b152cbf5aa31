"""Summarize (and sanity-check) mxnet_tpu_torch Chrome-trace exports
(parity: tools/trace_view.py; the trace layout is shared).

Reads the artifact written by ``mxnet_tpu_torch.tracing.export_trace(path)``,
``mx.profiler.dump()``, or a flight-recorder bundle directory (the
bundle's ``trace.json`` is used), validates the Chrome-trace invariants
the tier-1 guard enforces (valid JSON, unique span IDs, resolvable
parents, ts-sorted events), and prints:

* per-span-name aggregates (count, total/mean/max ms, errors),
* per-device HBM watermarks from the counter track,
* with ``--tree``, the span hierarchy of the slowest roots,
* with ``--top-ops N``, the N most expensive op-timeline entries with
  total time and estimated HBM bytes (XLA cost analysis x call count) —
  the human-readable face of the ranking tools/autotune.py feeds on.

    python mxnet_tpu_torch/tools/trace_view.py trace.json [--top 20] [--tree]
    python mxnet_tpu_torch/tools/trace_view.py trace.json --top-ops 15
    python mxnet_tpu_torch/tools/trace_view.py flight_recorder/flight-...-nonfinite-p1-1
    python mxnet_tpu_torch/tools/trace_view.py part1.json part2.json   # split export
    python mxnet_tpu_torch/tools/trace_view.py --fleet SPOOL [--out pod.json]

Multiple paths validate TOGETHER: span parents resolve against the
union of span ids across all given files, so a parent exported into a
different file of the same capture (flight-recorder bundles split by
priority; fleet spools split by rank) is a resolvable reference, not a
silently-dropped "parent not in trace" violation — a parent id that
appears in NO given file still fails.

``--fleet`` treats the path as a fleet spool dir
(``mxnet_tpu_torch/fleet.py``): per-rank chrome traces are stitched onto one
clock-offset-corrected pod timeline (pid = rank, span ids prefixed
``rN:``), torn snapshots are skipped with a counted warning, and the
stitched payload is validated and summarized like any trace
(``--out`` writes it for chrome://tracing / Perfetto).

Exit status is nonzero on malformed input or violated invariants, so CI
can gate on it.
"""
import argparse
import json
import os
import sys


def load_trace(path):
    """Trace payload from a file or a flight-recorder bundle dir."""
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError as e:
        raise SystemExit("%s: cannot read (%s)" % (path, e))
    except ValueError as e:
        raise SystemExit("%s: malformed JSON (%s)" % (path, e))
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise SystemExit("%s: not a chrome trace (no 'traceEvents')"
                         % path)
    return data


def span_ids(data):
    """All span ids declared in a trace payload (for cross-file parent
    resolution when one capture was exported as several files)."""
    ids = set()
    for ev in data["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "span":
            sid = ev.get("args", {}).get("span_id")
            if sid is not None:
                ids.add(sid)
    return ids


def validate(data, known_span_ids=None):
    """Chrome-trace invariant check; returns a list of violations.

    ``known_span_ids`` extends parent resolution beyond this file: a
    parent living in a sibling file of the same capture resolves
    instead of being reported missing (the multi-file bundle case).
    Duplicate/ts/pid checks stay per-file."""
    problems = []
    seen_ids = set()
    last_ts = None
    for ev in data["traceEvents"]:
        ph = ev.get("ph")
        if ph == "M":
            continue  # metadata events carry no timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append("event %r has no numeric ts" % (ev.get("name"),))
            continue
        if last_ts is not None and ts < last_ts:
            problems.append("ts not monotonic at %r (%s < %s)"
                            % (ev.get("name"), ts, last_ts))
        last_ts = ts
        if "pid" not in ev or "tid" not in ev:
            problems.append("event %r missing pid/tid" % (ev.get("name"),))
        if ph == "X" and ev.get("cat") == "span":
            sid = ev.get("args", {}).get("span_id")
            if sid is None:
                problems.append("span %r has no span_id" % (ev.get("name"),))
            elif sid in seen_ids:
                problems.append("duplicate span_id %s" % sid)
            else:
                seen_ids.add(sid)
    resolvable = seen_ids if known_span_ids is None \
        else (seen_ids | set(known_span_ids))
    for ev in data["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("cat") == "span":
            parent = ev.get("args", {}).get("parent_id")
            if parent is not None and parent not in resolvable:
                problems.append("span %r parent %s not in trace"
                                % (ev.get("name"), parent))
    return problems


def _spans(data):
    return [ev for ev in data["traceEvents"]
            if ev.get("ph") == "X" and ev.get("cat") == "span"]


def summarize(data, top):
    spans = _spans(data)
    agg = {}  # name -> [count, total_us, max_us, errors]
    for ev in spans:
        st = agg.setdefault(ev["name"], [0, 0.0, 0.0, 0])
        st[0] += 1
        st[1] += ev.get("dur", 0.0)
        st[2] = max(st[2], ev.get("dur", 0.0))
        if ev.get("args", {}).get("status") == "error":
            st[3] += 1
    other = data.get("otherData", {})
    print("trace_id %s  pid %s  events %d  spans %d (open %s, dropped %s)"
          % (other.get("trace_id", "?"), other.get("pid", "?"),
             len(data["traceEvents"]), len(spans),
             other.get("open_spans", "?"), other.get("dropped_spans", "?")))
    if agg:
        print()
        print("%-36s %7s %11s %11s %11s %6s" % (
            "span", "count", "total(ms)", "mean(ms)", "max(ms)", "err"))
        for name, (n, tot, mx, err) in sorted(
                agg.items(), key=lambda kv: -kv[1][1])[:top]:
            print("%-36s %7d %11.3f %11.3f %11.3f %6d" % (
                name, n, tot / 1e3, tot / n / 1e3, mx / 1e3, err))
    mem = {}  # device -> (max in_use, max peak)
    for ev in data["traceEvents"]:
        if ev.get("ph") == "C":
            args = ev.get("args", {})
            dev = ev.get("name", "?")
            prev = mem.get(dev, (0, 0))
            mem[dev] = (max(prev[0], args.get("bytes_in_use", 0)),
                        max(prev[1], args.get("peak_bytes_in_use", 0)))
    if mem:
        print()
        print("%-44s %14s %14s" % ("memory counter", "max in_use",
                                   "max peak"))
        for dev, (in_use, peak) in sorted(mem.items()):
            print("%-44s %14d %14d" % (dev, in_use, peak))


def aggregate_op_costs(data):
    """``(name, total_ms, calls, est_hbm_bytes|None)`` rows over the op
    timeline, most expensive first.  est = per-program XLA 'bytes
    accessed' x call count; None when the program has no cost-analysis
    entry.  Profiler timeline ops only: span events cover their
    children and would double-count (and dominate) the ranking.  The
    single source of the ranking tools/autotune.py replays."""
    agg = {}  # name -> [total_us, count]
    for ev in data["traceEvents"]:
        if ev.get("ph") != "X" or ev.get("cat") != "op":
            continue
        st = agg.setdefault(ev.get("name", "?"), [0.0, 0])
        st[0] += ev.get("dur", 0.0)
        st[1] += 1
    costs = data.get("otherData", {}).get("xla_costs", {})
    rows = []
    for name, (tot_us, n) in agg.items():
        ba = costs.get(name, {}).get("bytes_accessed")
        est = ba * n if isinstance(ba, (int, float)) else None
        rows.append((name, tot_us / 1e3, n, est))
    rows.sort(key=lambda r: -r[1])
    return rows


def print_top_ops(data, n):
    """The N most expensive timeline ops: total/mean ms and estimated
    HBM bytes ('-' when the program has no cost-analysis entry)."""
    print()
    print("%-40s %7s %11s %11s %14s" % (
        "op/program", "calls", "total(ms)", "mean(ms)", "est HBM bytes"))
    for name, tot_ms, cnt, est in aggregate_op_costs(data)[:n]:
        est_s = "%14.0f" % est if est is not None else "%14s" % "-"
        print("%-40s %7d %11.3f %11.3f %s" % (
            name, cnt, tot_ms, tot_ms / cnt, est_s))


def print_tree(data, top):
    spans = _spans(data)
    by_id = {ev["args"]["span_id"]: ev for ev in spans
             if ev.get("args", {}).get("span_id")}
    children = {}
    roots = []
    for ev in spans:
        parent = ev.get("args", {}).get("parent_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(ev)
        else:
            roots.append(ev)
    roots.sort(key=lambda e: -e.get("dur", 0.0))

    def walk(ev, depth):
        flags = "".join(
            [" !err" if ev["args"].get("status") == "error" else "",
             " (open)" if ev["args"].get("incomplete") else ""])
        print("%s%-*s %9.3f ms%s" % ("  " * depth, 40 - 2 * depth,
                                     ev["name"],
                                     ev.get("dur", 0.0) / 1e3, flags))
        for c in sorted(children.get(ev["args"].get("span_id"), []),
                        key=lambda e: e["ts"]):
            walk(c, depth + 1)

    print()
    for ev in roots[:top]:
        walk(ev, 0)


def print_bundle_events(path):
    """Wide-event window of a flight-recorder bundle (events.json,
    present since the events layer landed): outcome counts per kind +
    the writer's drop accounting — the per-request face of the crash.
    Silent when the bundle predates the events layer."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return
    evs = payload.get("events") or []
    stats = payload.get("stats") or {}
    print()
    print("wide events in bundle: %d (emitted %s, dropped %s)"
          % (len(evs), stats.get("emitted", "?"),
             stats.get("dropped", "?")))
    counts = {}
    for ev in evs:
        key = (str(ev.get("kind")), str(ev.get("outcome")))
        counts[key] = counts.get(key, 0) + 1
    for (kind, outcome), n in sorted(counts.items()):
        print("  %-20s %-10s %d" % (kind, outcome, n))
    bad = [e for e in evs if e.get("outcome") != "ok"]
    for ev in bad[-5:]:
        print("  last %s: span %s %s" % (
            ev.get("outcome"), ev.get("span_id"),
            " ".join("%s=%s" % (k, ev[k])
                     for k in ("stage", "reason", "error_kind")
                     if ev.get(k) is not None)))


def _stitch_fleet(spool, out):
    """--fleet: stitch a spool dir's per-rank traces into one pod
    timeline via the fleet collector (stdlib-only load through
    fleetz.load_fleet); returns (payload, spool problems)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fleetz import load_fleet

    payload, problems = load_fleet().stitch_traces(spool)
    if out:
        with open(out, "w") as f:
            json.dump(payload, f)
        fl = payload.get("otherData", {}).get("fleet", {})
        print("wrote %s (%d rank(s) stitched, %s skipped)"
              % (out, len(fl.get("ranks", [])), fl.get("skipped", 0)))
    return payload, problems


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Summarize/validate mxnet_tpu_torch chrome-trace exports")
    p.add_argument("paths", nargs="+", metavar="path",
                   help="trace JSON file(s) or flight-recorder bundle "
                        "directory; with --fleet, one spool dir")
    p.add_argument("--top", type=int, default=20,
                   help="rows per section (default 20)")
    p.add_argument("--tree", action="store_true",
                   help="print the span hierarchy of the slowest roots")
    p.add_argument("--top-ops", type=int, default=0, metavar="N",
                   help="print the N most expensive timeline ops with "
                        "total time and est. HBM bytes")
    p.add_argument("--fleet", action="store_true",
                   help="treat the path as a fleet spool dir and stitch "
                        "the per-rank traces into one pod timeline")
    p.add_argument("--out", help="write the loaded (or stitched) trace "
                                 "payload to this JSON file")
    args = p.parse_args(argv)

    if args.fleet:
        if len(args.paths) != 1:
            p.error("--fleet takes exactly one spool dir")
        payload, spool_problems = _stitch_fleet(args.paths[0], args.out)
        for msg in spool_problems:
            print("trace_view: fleet: %s" % msg, file=sys.stderr)
        fl = (payload.get("otherData") or {}).get("fleet") or {}
        stitched = fl.get("ranks") or []
        stale = fl.get("stale") or []
        if not stitched:
            # nothing merged: diagnose instead of validating an empty
            # timeline as a success
            print("trace_view: fleet: no rank traces stitched from %s "
                  "— no durable snapshots (wrong spool dir, or no "
                  "publisher attached)?  %d torn snapshot(s)"
                  % (args.paths[0], fl.get("torn_snapshots", 0)),
                  file=sys.stderr)
            return 1
        if stale and len(stale) >= len(stitched) and \
                all(r in stale for r in stitched):
            print("trace_view: fleet: every stitched rank (%s) is "
                  "STALE — the job is dead or the staleness cut is "
                  "too tight; the timeline below is historical"
                  % ",".join(str(r) for r in stale), file=sys.stderr)
            summarize(payload, args.top)
            return 1
        problems = validate(payload)
        summarize(payload, args.top)
        if args.tree:
            print_tree(payload, args.top)
        if problems:
            print()
            for msg in problems:
                print("INVARIANT VIOLATION: %s" % msg, file=sys.stderr)
            return 1
        return 0

    datas = [load_trace(path) for path in args.paths]
    # cross-file parent resolution: one capture exported as several
    # files (bundle split, per-rank spool) must validate as a whole
    all_ids = set()
    for data in datas:
        all_ids |= span_ids(data)
    exit_code = 0
    for path, data in zip(args.paths, datas):
        if len(datas) > 1:
            print("== %s ==" % path)
        problems = validate(data, known_span_ids=all_ids)
        summarize(data, args.top)
        if os.path.isdir(path):
            print_bundle_events(os.path.join(path, "events.json"))
        if args.top_ops:
            print_top_ops(data, args.top_ops)
        if args.tree:
            print_tree(data, args.top)
        if problems:
            print()
            for msg in problems:
                print("INVARIANT VIOLATION: %s" % msg, file=sys.stderr)
            exit_code = 1
        if len(datas) > 1:
            print()
    if args.out and datas:
        with open(args.out, "w") as f:
            json.dump(datas[0] if len(datas) == 1 else
                      {"traceEvents": [ev for d in datas
                                       for ev in d["traceEvents"]],
                       "otherData": {"merged_from": list(args.paths)}},
                      f)
    return exit_code


if __name__ == "__main__":
    sys.exit(main())
