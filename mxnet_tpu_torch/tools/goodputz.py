#!/usr/bin/env python3
"""Goodput ledger CLI: merge a job dir's incarnation ledgers into one
job-lifetime goodput/badput report.

Usage:
    python mxnet_tpu_torch/tools/goodputz.py JOB_DIR           # human-readable report
    python mxnet_tpu_torch/tools/goodputz.py JOB_DIR --json    # the /goodputz payload

The report decomposes job wall-clock into goodput (productive steps
minus preemption lost work) and the badput buckets — lost_work,
compile, ckpt_save, ckpt_restore, data_wait, startup, drain, other —
with a per-incarnation table and MTTR between each kill and the first
productive step of the successor incarnation.  Torn or partial ledger
lines are skipped with a counted warning, never a crash.

Parity: tools/goodputz.py.  Stdlib-only: ``mxnet_tpu_torch/goodput.py`` is loaded
by file path without importing the ``mxnet_tpu_torch`` package (whose
``__init__`` pulls torch) — the same trick ``fleetz.py`` uses for the
fleet collector.  ``perf_report.py --goodput`` imports
:func:`load_goodput` from here so there is exactly one loader.

Exit 0 on a rendered report, 1 when the job dir is missing/empty.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_GOODPUT_PY = os.path.join(_HERE, os.pardir, "goodput.py")


def load_goodput():
    """The goodput module, without importing the mxnet_tpu_torch package:
    the already-imported module when running inside the package (so
    the active job dir is shared), else a bare file-path load."""
    mod = sys.modules.get("mxnet_tpu_torch.goodput")
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        "mxnet_tpu_torch.goodput", os.path.abspath(_GOODPUT_PY))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["mxnet_tpu_torch.goodput"] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop("mxnet_tpu_torch.goodput", None)
        raise
    return mod


def main(argv=None):
    p = argparse.ArgumentParser(description="merge a goodput job dir "
                                            "and report goodput/badput")
    p.add_argument("dir", help="goodput job directory "
                               "(MXNET_GOODPUT_DIR)")
    p.add_argument("--json", action="store_true",
                   help="emit the raw /goodputz payload")
    args = p.parse_args(argv)
    goodput = load_goodput()
    payload = goodput.goodputz(dir=args.dir)
    if args.json:
        json.dump(payload, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    else:
        print(goodput.render_report(payload))
    if not payload.get("active"):
        print("goodputz: %s" % payload.get("error", "inactive"),
              file=sys.stderr)
        return 1
    if not payload.get("n_incarnations"):
        print("goodputz: no incarnation ledgers in %s — is this the "
              "right job dir, and did any GoodputRecorder begin?"
              % args.dir, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
