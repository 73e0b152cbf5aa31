"""Query the wide-event stream: latency slices, top-K slowest, trace join.
(parity: tools/events_query.py; the event layout is shared.)

Reads the JSONL stream written by ``mxnet_tpu_torch/events.py``
(``MXNET_EVENTS_PATH``, or a flight-recorder bundle's ``events.json``)
and answers the questions aggregate histograms cannot:

* **slices** — p50/p99/p999 (+count, mean) of ``dur_s`` grouped by any
  event fields (``--by kind,outcome`` default; ``stage``/``reason``/
  ``error_kind``/``label``/``tenant`` work the same way);
* **top-K slowest** — the actual requests behind the tail, each with
  its ``trace_id``/``span_id`` so the row links to the span tree and
  the ``/metrics`` exemplars;
* **--join trace.json** — resolve the top-K span ids against a chrome
  trace (``tracing.export_trace`` / a flight-recorder ``trace.json``):
  prints the matched span's name, duration and child count, so "this
  request was slow" joins to "and here is what it was doing".

Multiple inputs merge into one time-ordered stream — point it at every
rank's JSONL and slice ``--by rank`` (the ``proc_id``/``n_procs``
provenance each event carries) to see which rank's latency moved:

    python mxnet_tpu_torch/tools/events_query.py events.jsonl
    python mxnet_tpu_torch/tools/events_query.py events.jsonl --kind token_request \
        --by outcome,stage --top 5
    python mxnet_tpu_torch/tools/events_query.py events.jsonl --join trace.json
    python mxnet_tpu_torch/tools/events_query.py rank*/events.jsonl --by rank,outcome

Stdlib-only on purpose (no torch import): querying evidence must stay a
sub-second operation.  Exit 0 on success, 2 on unusable input.
"""
import argparse
import json
import os
import sys


def read_events(paths):
    """Events + (path, lineno, message) problems across the inputs.
    Accepts raw JSONL streams and flight-recorder ``events.json``
    bundles ({"events": [...]}); torn lines are reported, not fatal."""
    events, problems = [], []
    for path in paths:
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except OSError as e:
            problems.append((path, 0, "cannot read (%s)" % e))
            continue
        stripped = text.lstrip()
        if stripped.startswith("{") and '"events"' in stripped[:200]:
            # a flight-recorder bundle's events.json
            try:
                payload = json.loads(text)
                events.extend(e for e in payload.get("events", [])
                              if isinstance(e, dict))
                continue
            except ValueError:
                pass  # fall through to line-wise parsing
        for i, line in enumerate(text.splitlines(), 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError as e:
                problems.append((path, i, "unparsable JSON (%s)" % e))
                continue
            if not isinstance(ev, dict) or "kind" not in ev:
                problems.append((path, i, "not an event object"))
                continue
            events.append(ev)
    # merge reader: with one JSONL per rank, interleave on the wall
    # clock so "what happened around t" reads pod-wide (stable sort —
    # same-timestamp events keep file order)
    events.sort(key=lambda e: e.get("time")
                if isinstance(e.get("time"), (int, float)) else 0.0)
    return events, problems


def _quantile(sorted_vals, q):
    if not sorted_vals:
        return None
    idx = int(q * len(sorted_vals))
    return sorted_vals[min(idx, len(sorted_vals) - 1)]


def _key_of(ev, fields):
    # "rank" reads the proc_id/n_procs provenance events.py records
    # (0/1 single-process), rendered r<id>/<n> so slices stay legible
    def val(f):
        if f == "rank":
            return "r%s/%s" % (ev.get("proc_id", 0), ev.get("n_procs", 1))
        return str(ev.get(f, "-"))

    return tuple(val(f) for f in fields)


def render_slices(events, fields):
    groups = {}
    for ev in events:
        groups.setdefault(_key_of(ev, fields), []).append(ev)
    header = "%-44s %7s %9s %9s %9s %9s" % (
        ",".join(fields), "count", "p50_ms", "p99_ms", "p999_ms",
        "mean_ms")
    lines = [header]
    for key in sorted(groups):
        evs = groups[key]
        durs = sorted(e["dur_s"] for e in evs
                      if isinstance(e.get("dur_s"), (int, float)))

        def ms(q):
            v = _quantile(durs, q)
            return "%.3f" % (v * 1e3) if v is not None else "-"

        mean = "%.3f" % (sum(durs) / len(durs) * 1e3) if durs else "-"
        lines.append("%-44s %7d %9s %9s %9s %9s" % (
            "/".join(key)[:44], len(evs), ms(0.5), ms(0.99), ms(0.999),
            mean))
    return lines


def render_top(events, top, span_index=None):
    timed = [e for e in events
             if isinstance(e.get("dur_s"), (int, float))]
    timed.sort(key=lambda e: -e["dur_s"])
    lines = ["top %d slowest:" % top,
             "%9s %-16s %-10s %-34s %s" % (
                 "dur_ms", "kind", "outcome", "span_id (trace_id)",
                 "detail")]
    for ev in timed[:top]:
        detail = []
        for f in ("stage", "reason", "error_kind", "label", "tokens",
                  "rows", "step"):
            if ev.get(f) is not None:
                detail.append("%s=%s" % (f, ev[f]))
        for st, v in sorted((ev.get("stages_s") or {}).items()):
            detail.append("%s=%.1fms" % (st, v * 1e3))
        lines.append("%9.3f %-16s %-10s %-34s %s" % (
            ev["dur_s"] * 1e3, ev.get("kind", "-")[:16],
            ev.get("outcome", "-")[:10],
            "%s (%s)" % (ev.get("span_id"), str(ev.get("trace_id"))[:8]),
            " ".join(detail)))
        if span_index is not None:
            sp = span_index.get(str(ev.get("span_id")))
            if sp is None:
                lines.append("%9s trace: span not found (evicted from "
                             "the ring buffer, or tracing was off)" % "")
            else:
                lines.append(
                    "%9s trace: span %r %.3f ms, %d child span(s)"
                    % ("", sp["name"], sp["dur_ms"], sp["children"]))
    return lines


def build_span_index(trace_path):
    """span_id -> {name, dur_ms, children} from a chrome trace
    (tracing.export_trace payload or a bundle's trace.json)."""
    with open(trace_path, encoding="utf-8") as f:
        payload = json.load(f)
    events = payload.get("traceEvents", payload)
    index, children = {}, {}
    for ev in events:
        if not isinstance(ev, dict):
            continue
        args = ev.get("args") or {}
        sid = args.get("span_id")
        if sid is None:
            continue
        index[str(sid)] = {"name": ev.get("name", "?"),
                           "dur_ms": float(ev.get("dur", 0.0)) / 1e3,
                           "children": 0}
        pid = args.get("parent_id")
        if pid is not None:
            children[str(pid)] = children.get(str(pid), 0) + 1
    for sid, n in children.items():
        if sid in index:
            index[sid]["children"] = n
    return index


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("paths", nargs="+",
                   help="wide-event JSONL file(s) (MXNET_EVENTS_PATH "
                        "stream or a flight-recorder events.json)")
    p.add_argument("--kind", help="only this unit-of-work kind")
    p.add_argument("--outcome", help="only this outcome "
                                     "(ok/shed/deadline/evicted/error)")
    p.add_argument("--by", default="kind,outcome",
                   help="comma list of fields to slice the latency "
                        "table by (default kind,outcome; stage/reason/"
                        "error_kind/label/model/tenant work too — "
                        "tenant slices gateway_request events per "
                        "caller, rank slices by the proc_id/n_procs "
                        "provenance across merged per-rank files)")
    p.add_argument("--top", type=int, default=10,
                   help="slowest events to list with trace ids")
    p.add_argument("--join", metavar="TRACE_JSON",
                   help="chrome trace to resolve the top-K span ids "
                        "against")
    args = p.parse_args(argv)

    events, problems = read_events(args.paths)
    for path, lineno, msg in problems:
        print("events_query: %s:%d: %s" % (path, lineno, msg),
              file=sys.stderr)
    if args.kind:
        events = [e for e in events if e.get("kind") == args.kind]
    if args.outcome:
        events = [e for e in events if e.get("outcome") == args.outcome]
    if not events:
        print("events_query: no matching events", file=sys.stderr)
        return 2
    span_index = None
    if args.join:
        if not os.path.exists(args.join):
            print("events_query: --join %s does not exist" % args.join,
                  file=sys.stderr)
            return 2
        span_index = build_span_index(args.join)
    fields = [f.strip() for f in args.by.split(",") if f.strip()]
    out = ["%d event(s)" % len(events), ""]
    if "rank" in fields:
        # event files written before rank provenance existed carry no
        # proc_id — they slice as rank 0, and we SAY so instead of
        # silently folding old data into r0
        legacy = sum(1 for e in events if "proc_id" not in e)
        if legacy:
            out.append("note: %d event(s) predate rank provenance "
                       "(no proc_id field) — defaulted to rank 0"
                       % legacy)
            out.append("")
    out.extend(render_slices(events, fields))
    out.append("")
    out.extend(render_top(events, args.top, span_index))
    print("\n".join(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
