"""The port's observability CLIs (mxnet_tpu_torch/tools/) against the JAX
package's (tools/), on the same artifacts.

The artifacts are the port's own: a telemetry dump before and after two
ShardedTrainer steps with a CheckpointManager attached, the Chrome trace
and the events JSONL of those steps, a fleet spool that two
``testing.fleet_worker`` ranks publish (rank 1 a straggler), a goodput
job directory that two ``testing.goodput_worker`` ranks write over a
kill (rank 0 SIGKILLs itself after its last committed checkpoint) and a
resume, and a perf ledger of ``perf_ledger.make_record`` records.  Each
pair of commands gives the same exit code and the same standard output,
allowing only for the package name in the text, and for the fields a
reader stamps with its own clock (fleetz's ``age_s`` column, the
payloads' ``time``); a rank's staleness also follows the reader's
clock, so both read with one cut (``MXNET_FLEET_STALE``), and once with
``--stale-after 0``, where every rank is stale.  ``fleetz``, ``goodputz`` and ``perf_report`` load
the port's ``fleet.py``, ``goodput.py`` and ``perf_ledger.py`` by file
path: running them imports no torch.
"""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from mxnet_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOLS = os.path.join(REPO, "tools")
PORT_TOOLS = os.path.join(REPO, "mxnet_tpu_torch", "tools")

_MAKE = r"""
import json, os, sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import events, parallel, perf_ledger, telemetry, tracing
from mxnet_tpu_torch.gluon import nn
root = sys.argv[1]
telemetry.enable(); tracing.enable()
events.enable(path=os.path.join(root, "events.jsonl"), sample=1.0)
telemetry.dump(os.path.join(root, "t0.json"))
with mx.name.NameManager():
    net = nn.HybridSequential()
    net.add(nn.Dense(4, in_units=3))
net.initialize(mx.init.Xavier(), ctx=mx.cpu())
sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
tr = parallel.ShardedTrainer(net, lambda o, l: sce(o, l), optimizer="sgd")
m = mx.CheckpointManager(os.path.join(root, "ckpt"), async_save=False)
tr.attach_checkpoint_manager(m, period=1, install_signal_handler=False)
for _ in range(2):
    tr.step([mx.nd.array(np.ones((2, 3), np.float32), ctx=mx.cpu())],
            mx.nd.array(np.zeros(2, np.float32), ctx=mx.cpu()))
m.load()
telemetry.dump(os.path.join(root, "t1.json"))
tracing.export_trace(os.path.join(root, "trace.json"))
events.flush()
with open(os.path.join(root, "ledger.jsonl"), "w") as f:
    for i in range(4):
        f.write(json.dumps(perf_ledger.make_record(
            "resnet50_train_images_per_sec_per_chip", 100.0 + i, "img/s",
            run_id="run%d" % (i % 2))) + "\n")
"""


def _fleet(argv):
    results = faults.WorkerFleet(2, argv, cwd=REPO).wait(timeout=180)
    return [rc for rc, _ in results], results


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli"))
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _MAKE, root], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    rcs, out = _fleet(["-m", "mxnet_tpu_torch.testing.fleet_worker",
                       "--spool", os.path.join(root, "spool"),
                       "--steps", "6", "--straggler-rank", "1"])
    assert rcs == [0, 0], out
    gp = ["-m", "mxnet_tpu_torch.testing.goodput_worker",
          "--dir", os.path.join(root, "gp"),
          "--ckpt", os.path.join(root, "gpck"), "--steps", "8",
          "--save-every", "4"]
    rcs, out = _fleet(gp + ["--kill-rank", "0", "--kill-step", "6"])
    assert rcs[1] == 0 and rcs[0] != 0, out
    rcs, out = _fleet(gp)
    assert rcs == [0, 0], out
    return root


def _run(tools, tool, args):
    # a rank turns stale by the reader's clock (MXNET_FLEET_STALE, 30 s by
    # default); both readers get one cut that the artifacts' age cannot
    # cross while the test runs
    env = dict(os.environ, MXNET_FLEET_STALE="86400")
    r = subprocess.run([sys.executable, os.path.join(tools, tool + ".py")]
                       + args, capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=env)
    return r.returncode, r.stdout


def _mask_ages(text):
    """fleetz's rank rows carry the reader's age of each snapshot."""
    return "\n".join(re.sub(r"^(\d+\s+\d+\s+\d+\s+)\S+", r"\1AGE", line)
                     for line in text.splitlines())


def _drop_time(text):
    def drop(obj):
        if isinstance(obj, dict):
            return {k: drop(v) for k, v in obj.items()
                    if k not in ("time", "age_s")}
        if isinstance(obj, list):
            return [drop(v) for v in obj]
        return obj
    return json.dumps(drop(json.loads(text)), sort_keys=True)


CASES = {
    "telemetry_dump": ("telemetry_dump", ["{r}/t1.json"], None),
    "telemetry_dump_top": ("telemetry_dump", ["{r}/t1.json", "--top", "3"],
                           None),
    "telemetry_dump_diff": ("telemetry_dump",
                            ["--diff", "{r}/t0.json", "{r}/t1.json"], None),
    "telemetry_dump_merge": ("telemetry_dump",
                             ["--merge", "{r}/t0.json", "{r}/t1.json"],
                             None),
    "telemetry_dump_missing": ("telemetry_dump", ["{r}/absent.json"], None),
    "trace_view": ("trace_view", ["{r}/trace.json"], None),
    "trace_view_tree": ("trace_view", ["{r}/trace.json", "--tree"], None),
    "trace_view_fleet": ("trace_view", ["--fleet", "{r}/spool"], None),
    "events_query": ("events_query", ["{r}/events.jsonl"], None),
    "events_query_ckpt": ("events_query",
                          ["{r}/events.jsonl", "--kind", "checkpoint_save",
                           "--by", "outcome,mode"], None),
    "events_query_join": ("events_query",
                          ["{r}/events.jsonl", "--join", "{r}/trace.json"],
                          None),
    "fleetz": ("fleetz", ["{r}/spool"], _mask_ages),
    "fleetz_json": ("fleetz", ["{r}/spool", "--json"], _drop_time),
    "fleetz_empty": ("fleetz", ["{r}/no_spool"], None),
    "fleetz_stale": ("fleetz", ["{r}/spool", "--stale-after", "0"],
                     _mask_ages),
    "goodputz": ("goodputz", ["{r}/gp"], None),
    "goodputz_json": ("goodputz", ["{r}/gp", "--json"], _drop_time),
    "perf_report": ("perf_report", ["--ledger", "{r}/ledger.jsonl"], None),
    "perf_report_diff": ("perf_report", ["--ledger", "{r}/ledger.jsonl",
                                         "--diff", "run0", "run1"], None),
    "perf_report_goodput": ("perf_report",
                            ["--ledger", "{r}/ledger.jsonl", "--goodput",
                             "{r}/gp"], None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_the_jax_cli(art, tmp_path, case):
    tool, args, norm = CASES[case]
    outs = []
    for side, tools in (("jax", JAX_TOOLS), ("port", PORT_TOOLS)):
        # each side on its own copy: perf_report --goodput appends
        root = str(tmp_path / side)
        shutil.copytree(art, root)
        rc, out = _run(tools, tool, [a.format(r=root) for a in args])
        out = out.replace(root, "ROOT").replace("mxnet_tpu_torch",
                                                "mxnet_tpu")
        outs.append((rc, norm(out) if norm else out))
    assert outs[0] == outs[1]
    if not any(w in case for w in ("missing", "empty", "stale")):
        assert outs[0][0] == 0 and outs[0][1].strip(), outs[0]


def test_goodput_cli_reads_the_kill_and_resume(art):
    rc, out = _run(PORT_TOOLS, "goodputz", [os.path.join(art, "gp"),
                                             "--json"])
    assert rc == 0
    rep = json.loads(out)
    assert rep["active"] and rep["n_ranks"] == 2
    reasons = sorted(i["exit_reason"] for i in rep["incarnations"])
    assert "killed" in reasons and reasons.count("clean") == 3
    assert rep["buckets_s"]["ckpt_save"] > 0
    assert rep["buckets_s"]["ckpt_restore"] > 0


@pytest.mark.parametrize("tool,args", [
    ("fleetz", ["{r}/spool"]), ("goodputz", ["{r}/gp"]),
    ("perf_report", ["--ledger", "{r}/ledger.jsonl"])])
def test_cli_loads_its_module_without_the_package(art, tool, args):
    probe = ("import runpy, sys\n"
             "sys.argv = [sys.argv[1]] + sys.argv[2:]\n"
             "try:\n"
             "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
             "except SystemExit:\n"
             "    pass\n"
             "print('IMPORTED', sorted(m for m in sys.modules if m in "
             "('torch', 'mxnet_tpu_torch', 'jax', 'mxnet_tpu')))\n")
    r = subprocess.run(
        [sys.executable, "-c", probe, os.path.join(PORT_TOOLS, tool + ".py")]
        + [a.format(r=art) for a in args], capture_output=True, text=True,
        timeout=120, cwd=REPO)
    assert "IMPORTED []" in r.stdout, r.stdout + r.stderr
