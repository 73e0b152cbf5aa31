"""Pretty-print (and diff) mxnet_tpu_torch telemetry snapshots (parity:
tools/telemetry_dump.py; the snapshot layout is shared, so it reads
either package's).

Reads the JSON artifact written by ``mxnet_tpu_torch.telemetry.dump(path)``
(or a ``TelemetryReporter``'s ``path=``) **or** a saved Prometheus/
OpenMetrics text exposition (``curl :9100/metrics > snap.txt``) — the
exposition parser understands the exemplar suffix the tracing-enabled
scrape emits (``... # {trace_id="..."} value ts``) instead of crashing
on it.  Renders the top-N series as a table: counters/gauges by value,
histograms as count/sum/mean/p50/p99.

    python mxnet_tpu_torch/tools/telemetry_dump.py snap.json [--top 20]
    python mxnet_tpu_torch/tools/telemetry_dump.py --diff before.json after.json
    python mxnet_tpu_torch/tools/telemetry_dump.py --diff before.txt after.txt  # scrapes
    python mxnet_tpu_torch/tools/telemetry_dump.py --merge r0.json r1.json [--out pod.json]

``--diff`` aligns series by (metric, labels) and prints deltas —
the before/after view for bench runs (counter/histogram deltas are the
work done between the snapshots; gauges show old -> new).

``--merge`` folds N per-rank dumps into one pod-level view with the
fleet collector's semantics (``fleet.merge_metrics``: counters sum
exactly, histograms add bucket-additively, gauges take the max), so a
merged histogram's percentiles are the pooled fleet percentiles at
bucket resolution.  ``--out`` writes the merged dump as JSON (itself
loadable by this tool and ``--diff``-able).
"""
import argparse
import json
import os
import re
import sys

_INF = float("inf")

_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) (\w+)$")
_HELP_RE = re.compile(r"^# HELP ([a-zA-Z_:][a-zA-Z0-9_:]*) (.*)$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)"
    r"(?:\s+-?[0-9.eE+]+)?"   # optional 0.0.4 sample timestamp
    r"(?:\s+#\s+\{.*)?$")     # trailing "# {...} v ts" = exemplar
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse_value(tok):
    if tok == "+Inf":
        return _INF
    if tok == "-Inf":
        return -_INF
    if tok == "NaN":
        return float("nan")
    return float(tok)


def _parse_exposition(text):
    """Prometheus/OpenMetrics text -> the telemetry.dump() JSON shape.

    Exemplar suffixes (`` # {trace_id="..."} value ts``) are stripped:
    they annotate a bucket observation, they are not part of the
    sample value this tool aggregates."""
    types, helps = {}, {}
    hist_series = {}   # (family, labels_key) -> row dict
    scalar_series = {}  # name -> [(labels, value)]
    order = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        m = _TYPE_RE.match(line)
        if m:
            types[m.group(1)] = m.group(2)
            order.append(m.group(1))
            continue
        m = _HELP_RE.match(line)
        if m:
            helps[m.group(1)] = m.group(2)
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError("unparsable exposition line: %r" % line)
        name, labelstr, valtok = m.group(1), m.group(2) or "", m.group(3)
        labels = dict(_LABEL_RE.findall(labelstr))
        value = _parse_value(valtok)
        family = re.sub(r"_(bucket|sum|count)$", "", name)
        if types.get(family) == "histogram" and name != family:
            le = labels.pop("le", None)
            key = (family, tuple(sorted(labels.items())))
            row = hist_series.setdefault(
                key, {"labels": labels, "buckets": [], "sum": 0.0,
                      "count": 0})
            if name.endswith("_bucket") and le is not None:
                row["buckets"].append([_parse_value(le), value])
            elif name.endswith("_sum"):
                row["sum"] = value
            elif name.endswith("_count"):
                row["count"] = value
        else:
            scalar_series.setdefault(name, []).append((labels, value))
    metrics = {}
    for name in order:
        kind = types[name]
        series = []
        out_name = name
        if kind == "histogram":
            for (fam, _lk), row in sorted(hist_series.items()):
                if fam == name:
                    row["buckets"].sort(key=lambda b: b[0])
                    series.append(row)
        else:
            rows = scalar_series.get(name)
            if rows is None and kind == "counter":
                # OpenMetrics counter family: TYPE names the family
                # without _total, samples carry it — normalize back
                # to the suffixed (registry) name
                rows = scalar_series.get(name + "_total")
                if rows is not None:
                    out_name = name + "_total"
            for labels, value in rows or []:
                series.append({"labels": labels, "value": value})
        metrics[out_name] = {"type": kind, "help": helps.get(name, ""),
                             "series": series}
    if not metrics:
        raise ValueError("no # TYPE lines — not an exposition")
    return {"format_version": "exposition", "time": None,
            "metrics": metrics}


def _load(path):
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise SystemExit("%s: cannot read (%s)" % (path, e))
    try:
        data = json.loads(text)
    except ValueError as json_err:
        # not JSON: a saved /metrics scrape parses too (exemplar
        # suffixes included); anything else is a clear message +
        # nonzero exit, not a traceback
        if "# TYPE" in text:
            try:
                return _parse_exposition(text)
            except ValueError as e:
                raise SystemExit("%s: malformed exposition (%s)"
                                 % (path, e))
        raise SystemExit("%s: malformed JSON (%s)" % (path, json_err))
    if not isinstance(data, dict) or "metrics" not in data:
        raise SystemExit("%s: not a telemetry dump (no 'metrics' key)"
                         % path)
    return data


def _series_key(name, labels):
    return name + "".join(
        "{%s=%s}" % kv for kv in sorted(labels.items()))


def _num(v):
    """Undo the dump's RFC-8259-safe encoding: non-finite values ship
    as strings ("NaN"/"Infinity"/"-Infinity"), which float() parses."""
    return float(v) if isinstance(v, str) else v


def _quantile(buckets, q):
    """Bucket-interpolated quantile from cumulative [(le, count)]."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total == 0:
        return None
    rank = q * total
    prev_ub, prev_c = 0.0, 0
    for ub, c in buckets:
        ub = float(_num(ub))
        if c >= rank:
            if ub == _INF:
                return prev_ub
            if c == prev_c:
                return ub
            return prev_ub + (ub - prev_ub) * (rank - prev_c) / (c - prev_c)
        prev_ub, prev_c = ub, c
    return prev_ub


def _flatten(data):
    """dump payload -> {series_key: ("scalar", value) | ("hist", s)}."""
    out = {}
    for name, m in sorted(data["metrics"].items()):
        for s in m["series"]:
            key = _series_key(name, s.get("labels", {}))
            if m["type"] == "histogram":
                out[key] = ("hist", s)
            else:
                out[key] = ("scalar", _num(s.get("value", 0.0)))
    return out


def _fmt_num(v):
    if v is None:
        return "-"
    if isinstance(v, float) and (v != v or v in (_INF, -_INF)):
        return str(v)
    if isinstance(v, float) and v != int(v):
        return "%.6g" % v
    return "%d" % int(v)


def _hist_cells(s):
    n = s.get("count", 0)
    tot = s.get("sum", 0.0)
    mean = tot / n if n else None
    return (n, tot, mean, _quantile(s.get("buckets", []), 0.5),
            _quantile(s.get("buckets", []), 0.99))


def cmd_show(paths, top):
    for path in paths:
        data = _load(path)
        print("== %s (t=%s) ==" % (path, data.get("time")))
        flat = _flatten(data)
        scalars = [(k, v) for k, (kind, v) in flat.items()
                   if kind == "scalar"]
        hists = [(k, s) for k, (kind, s) in flat.items() if kind == "hist"]
        scalars.sort(key=lambda kv: -abs(kv[1]))
        print("%-64s %14s" % ("series", "value"))
        for k, v in scalars[:top]:
            print("%-64s %14s" % (k, _fmt_num(v)))
        if hists:
            print()
            print("%-52s %8s %10s %10s %10s %10s" % (
                "histogram", "count", "sum", "mean", "p50", "p99"))
            hists.sort(key=lambda kv: -kv[1].get("count", 0))
            for k, s in hists[:top]:
                n, tot, mean, p50, p99 = _hist_cells(s)
                print("%-52s %8d %10s %10s %10s %10s" % (
                    k, n, "%.4g" % tot, _fmt_num(mean), _fmt_num(p50),
                    _fmt_num(p99)))
        print()


def cmd_merge(paths, top, out=None):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fleetz import load_fleet

    fleet = load_fleet()
    dumps = [_load(p) for p in paths]
    merged = {
        "format_version": 1,
        "time": max((d.get("time") or 0) for d in dumps) or None,
        "merged_from": list(paths),
        "metrics": fleet.merge_metrics([d["metrics"] for d in dumps]),
    }
    if out:
        with open(out, "w") as f:
            json.dump(merged, f, indent=2, sort_keys=True)
        print("wrote %s (%d inputs, %d metric families)"
              % (out, len(paths), len(merged["metrics"])))
    print("== merged %d dump(s) ==" % len(paths))
    flat = _flatten(merged)
    scalars = [(k, v) for k, (kind, v) in flat.items() if kind == "scalar"]
    hists = [(k, s) for k, (kind, s) in flat.items() if kind == "hist"]
    scalars.sort(key=lambda kv: -abs(kv[1]))
    print("%-64s %14s" % ("series", "value"))
    for k, v in scalars[:top]:
        print("%-64s %14s" % (k, _fmt_num(v)))
    if hists:
        print()
        print("%-52s %8s %10s %10s %10s %10s" % (
            "histogram", "count", "sum", "mean", "p50", "p99"))
        hists.sort(key=lambda kv: -kv[1].get("count", 0))
        for k, s in hists[:top]:
            n, tot, mean, p50, p99 = _hist_cells(s)
            print("%-52s %8d %10s %10s %10s %10s" % (
                k, n, "%.4g" % _num(tot), _fmt_num(mean), _fmt_num(p50),
                _fmt_num(p99)))


def cmd_diff(path_a, path_b, top):
    data_a, data_b = _load(path_a), _load(path_b)
    a, b = _flatten(data_a), _flatten(data_b)
    fams_a, fams_b = set(data_a["metrics"]), set(data_b["metrics"])
    rows = []
    for key in sorted(set(a) | set(b)):
        kind_a, va = a.get(key, (None, None))
        kind_b, vb = b.get(key, (None, None))
        kind = kind_b or kind_a
        # a metric family present in only one snapshot (registered by a
        # different code version, or renamed between runs): flag it as
        # new/gone instead of diffing against a silent zero.  A label
        # SERIES missing on one side within a shared family still diffs
        # from zero (a counter's first increment is real work done).
        family = key.split("{", 1)[0]
        if family not in fams_a or family not in fams_b:
            tag = "new" if family not in fams_a else "gone"
            s = vb if va is None else va
            val = "count %d sum %.4g" % (s.get("count", 0),
                                         s.get("sum", 0.0)) \
                if kind == "hist" else _fmt_num(s)
            rows.append((_INF, "%-56s %s (%s)" % (key, tag, val)))
            continue
        if kind == "hist":
            na = va.get("count", 0) if va else 0
            nb = vb.get("count", 0) if vb else 0
            sa = va.get("sum", 0.0) if va else 0.0
            sb = vb.get("sum", 0.0) if vb else 0.0
            dn, ds = nb - na, sb - sa
            if dn or ds:
                rows.append((abs(dn), "%-56s count %+d  sum %+.4g  "
                             "mean/new %s" % (key, dn, ds,
                                              _fmt_num(ds / dn)
                                              if dn else "-")))
        else:
            va = va or 0.0
            vb = vb or 0.0
            if va != vb:
                rows.append((abs(vb - va), "%-56s %s -> %s (%+.6g)"
                             % (key, _fmt_num(va), _fmt_num(vb), vb - va)))
    rows.sort(key=lambda r: -r[0])
    print("diff %s -> %s (%d changed series)" % (path_a, path_b, len(rows)))
    for _, line in rows[:top]:
        print(line)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Pretty-print/diff mxnet_tpu_torch telemetry dumps")
    p.add_argument("paths", nargs="*", help="telemetry dump JSON file(s)")
    p.add_argument("--top", type=int, default=20,
                   help="series per section (default 20)")
    p.add_argument("--diff", nargs=2, metavar=("A", "B"),
                   help="diff two dumps instead of printing them")
    p.add_argument("--merge", nargs="+", metavar="DUMP",
                   help="merge N per-rank dumps (fleet semantics: "
                        "counters sum, histograms add bucket-additively)")
    p.add_argument("--out", help="with --merge: write the merged dump "
                                 "here as JSON")
    args = p.parse_args(argv)
    if args.diff and args.merge:
        p.error("--diff and --merge are mutually exclusive")
    if args.diff:
        if args.paths:
            p.error("--diff takes exactly two files and no positionals")
        cmd_diff(args.diff[0], args.diff[1], args.top)
    elif args.merge:
        if args.paths:
            p.error("--merge takes its files after the flag, "
                    "no positionals")
        cmd_merge(args.merge, args.top, out=args.out)
    elif args.paths:
        cmd_show(args.paths, args.top)
    else:
        p.error("give dump file(s), --diff A B, or --merge A B ...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
