"""The port's goodput ledger and fleet observatory (mxnet_tpu_torch.goodput,
mxnet_tpu_torch.fleet) against the JAX package's over the same files.

* goodput: one synthetic job dir — rank 0 killed after a committed
  checkpoint and resumed, rank 1 clean, one torn line — gives the same
  ``read_job`` and ``goodputz`` report (lost work, MTTR, buckets) in
  both packages, and a ledger the port's recorder writes reads the same
  in both;
* fleet: one synthetic spool of three ranks (one slow in data wait, one
  clock-skewed, one torn) gives the same ``read_spool``, ``merge_metrics``,
  ``clock_offsets``, ``straggler_report`` and ``fleetz``; snapshots the
  port's ``FleetPublisher`` writes (after a spool rendezvous of two
  ranks) read the same in both, with merged counters equal to the sum
  over the ranks.

Exact, except 1e-12 relative on float sums.  Report fields stamped with
the reading time (``time``, ``age_s``) are left out.
"""
import json
import math
import os
import threading

import pytest

from mxnet_tpu import fleet as jfleet
from mxnet_tpu import goodput as jgp
from mxnet_tpu import telemetry as jtel

from mxnet_tpu_torch import fleet as tfleet
from mxnet_tpu_torch import goodput as tgp
from mxnet_tpu_torch import telemetry as ttel

FLOAT_RTOL = 1e-12
T0 = 1_700_000_000.0


def _close(a, b, path="$"):
    """Deep equality; floats within FLOAT_RTOL relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], "%s.%s" % (path, k))
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=FLOAT_RTOL, abs_tol=0.0), \
            (path, a, b)
    else:
        assert a == b, (path, a, b)


def _drop(obj, keys):
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(v, keys) for v in obj]
    return obj


@pytest.fixture(autouse=True)
def _registries():
    for t in (jtel, ttel):
        t.reset()
        t.disable()
    yield
    for t in (jtel, ttel):
        t.reset()
        t.disable()
    for f in (jfleet, tfleet):
        f.set_spool(None)
    for g in (jgp, tgp):
        g.set_dir(None)


# ---------------------------------------------------------------------------
# goodput
# ---------------------------------------------------------------------------

def _ledger(path, recs, torn=False):
    with open(path, "w") as f:
        for rec in recs:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        if torn:
            f.write('{"type": "segment", "kind": "prod')


def _start(inc, rank, t, reason="fresh", resumed=None):
    return {"type": "incarnation_start", "format_version": 1,
            "incarnation": inc, "rank": rank, "n_procs": 2, "pid": 100 + rank,
            "time": t, "start_reason": reason, "resumed_from_step": resumed}


def _seg(kind, dur, t, **kw):
    return dict({"type": "segment", "kind": kind, "dur_s": dur, "time": t},
                **kw)


def _job(job):
    os.makedirs(job, exist_ok=True)
    # rank 0, first incarnation: killed at step 7, last commit at step 4
    recs = [_start("aaaaaa", 0, T0), _seg("startup", 2.0, T0 + 2.0),
            _seg("compile", 3.25, T0 + 5.25)]
    for s in range(1, 8):
        recs.append(_seg("productive_step", 0.5, T0 + 5.25 + 0.6 * s,
                         step=s, steps=1))
        if s == 4:
            recs.append(_seg("ckpt_save", 0.3, T0 + 8.0, step=4,
                             committed=True))
    recs.append(_seg("data_wait", 0.125, T0 + 10.0))
    _ledger(os.path.join(job, "goodput-r00000-aaaaaa.jsonl"), recs,
            torn=True)
    # rank 0, successor: resumed from step 4, clean exit at step 9
    recs = [_start("bbbbbb", 0, T0 + 20.0, "resume", 4),
            _seg("startup", 1.5, T0 + 21.5),
            _seg("ckpt_restore", 0.75, T0 + 22.25)]
    for s in range(5, 10):
        recs.append(_seg("productive_step", 0.5, T0 + 22.25 + 0.5 * (s - 4),
                         step=s, steps=1))
    recs.append(_seg("drain", 0.2, T0 + 25.0))
    recs.append({"type": "incarnation_end", "time": T0 + 25.5,
                 "exit_reason": "clean", "step": 9})
    _ledger(os.path.join(job, "goodput-r00000-bbbbbb.jsonl"), recs)
    # rank 1: one clean incarnation, a fused window of 4 steps
    recs = [_start("cccccc", 1, T0), _seg("startup", 2.5, T0 + 2.5),
            _seg("productive_step", 2.0, T0 + 4.5, step=4, steps=4),
            _seg("productive_step", 2.0, T0 + 6.5, step=8, steps=4),
            {"type": "incarnation_end", "time": T0 + 7.0,
             "exit_reason": "preempt", "step": 8}]
    _ledger(os.path.join(job, "goodput-r00001-cccccc.jsonl"), recs)
    return job


def test_goodput_report_agrees_over_one_job(tmp_path):
    job = _job(str(tmp_path / "job"))
    jjob, tjob = jgp.read_job(job), tgp.read_job(job)
    _close(tjob, jjob)
    assert tjob["torn_lines"] == 1
    jrep, trep = jgp.goodputz(dir=job), tgp.goodputz(dir=job)
    _close(_drop(trep, {"time"}), _drop(jrep, {"time"}))
    assert trep["kills"] == 1 and trep["lost_steps"] == 3
    assert trep["n_ranks"] == 2 and trep["n_incarnations"] == 3
    assert math.isclose(sum(trep["buckets_s"].values()), trep["wall_s"],
                        rel_tol=1e-9)
    assert tgp.render_report(trep).splitlines()[1:] == \
        jgp.render_report(jrep).splitlines()[1:]
    recs = tgp.ledger_records(trep, run_id="r")
    assert [r["metric"] for r in recs] == \
        [r["metric"] for r in jgp.ledger_records(jrep, run_id="r")]


def test_port_recorder_ledger_reads_the_same(tmp_path):
    job = str(tmp_path / "job")
    rec = tgp.GoodputRecorder(job, rank=0, n_procs=1,
                              flush_every=2).begin(started_at=T0)
    try:
        for s in range(1, 6):
            tgp.record_segment("productive_step", 0.01, step=s, steps=1)
        tgp.record_segment("ckpt_save", 0.02, step=5, committed=True)
        tgp.record_compile(0.5)
        with tgp.compile_guard():
            tgp.record_compile(9.0)          # owned by the guard holder
        tgp.record_segment("data_wait", 0.003)
    finally:
        rec.end("clean", step=5)
    assert not tgp.active()
    assert os.path.exists(rec.path + tgp.SIDECAR_SUFFIX)
    jrep, trep = jgp.goodputz(dir=job), tgp.goodputz(dir=job)
    _close(_drop(trep, {"time"}), _drop(jrep, {"time"}))
    assert trep["buckets_s"]["compile"] == 0.5
    assert trep["steps"] == 5 and trep["kills"] == 0


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------

def _snapshot(tel, steps, gap_s, step_s):
    tel.reset()
    tel.enable()
    for _ in range(steps):
        tel.HOST_GAP_SECONDS.observe(gap_s, loop="sharded")
        tel.PREFETCH_WAIT_SECONDS.observe(gap_s)
        tel.TRAIN_STEP_SECONDS.observe(step_s, loop="sharded")
        tel.TRAIN_STEPS.inc(loop="sharded")
    tel.DECODE_TOKENS.inc(steps * 3)
    tel.TRAIN_LOSS.set(1.0 + gap_s)


def _spool(spool):
    """Three ranks published through the JAX package's publisher (rank 2
    slow in data wait, rank 1 with a clock 0.75 s ahead), and a torn
    rank 3."""
    os.makedirs(spool, exist_ok=True)
    barrier = T0 + 3.0
    for rank, gap, off in ((0, 0.001, 0.0), (1, 0.001, 0.75),
                           (2, 0.02, 0.0)):
        _snapshot(jtel, 10, gap, 0.004)
        pub = jfleet.FleetPublisher(spool, rank=rank, n_procs=3,
                                    clock_offset=off, publish_trace=False)
        pub.barrier_wall = barrier + off
        assert pub.publish_once() is not None
    with open(os.path.join(spool, jfleet.SNAPSHOT_NAME % 3), "w") as f:
        f.write('{"rank": 3, "torn')
    with open(os.path.join(spool, jfleet.SIDECAR_NAME % 3), "w") as f:
        json.dump({"sha256": "0" * 64, "time": barrier}, f)
    jtel.reset()
    jtel.disable()
    return spool


def test_fleet_collector_agrees_over_one_spool(tmp_path):
    spool = _spool(str(tmp_path / "spool"))
    now = T0 + 1e9       # every rank ages the same in both readers
    jview = jfleet.read_spool(spool, stale_after=1e12, now=now)
    tview = tfleet.read_spool(spool, stale_after=1e12, now=now)
    _close(tview, jview)
    assert sorted(tview["ranks"]) == [0, 1, 2] and tview["torn"] == 1
    _close(tfleet.clock_offsets(tview["ranks"]),
           jfleet.clock_offsets(jview["ranks"]))
    assert tfleet.clock_offsets(tview["ranks"])[1] == pytest.approx(0.75)
    snaps = [r["snapshot"]["metrics"] for _, r in
             sorted(tview["ranks"].items())]
    _close(tfleet.merge_metrics(snaps), jfleet.merge_metrics(snaps))
    merged = tfleet.merge_metrics(snaps)
    steps = [s["series"][0]["value"] for s in
             (m["mxnet_tpu_train_steps_total"] for m in snaps)]
    assert merged["mxnet_tpu_train_steps_total"]["series"][0]["value"] \
        == sum(steps) == 30
    rep = tfleet.straggler_report(tview)
    _close(rep, jfleet.straggler_report(jview))
    assert rep["straggler"] == 2
    jz = jfleet.fleetz(spool=spool, stale_after=1e12)
    tz = tfleet.fleetz(spool=spool, stale_after=1e12)
    _close(_drop(tz, {"time", "age_s"}), _drop(jz, {"time", "age_s"}))


def test_port_publishers_rendezvous_and_merge(tmp_path):
    """Two port publishers attach through the spool rendezvous (threads
    stand in for the two worker processes) and each publishes its own
    registry values; both collectors read the same pod view."""
    spool = str(tmp_path / "spool")
    pubs = [tfleet.FleetPublisher(spool, rank=r, n_procs=2,
                                  publish_trace=False) for r in range(2)]
    errs = []

    def attach(p):
        try:
            p.attach(timeout=30)
        except Exception as e:        # noqa: BLE001 - reported below
            errs.append(e)

    ts = [threading.Thread(target=attach, args=(p,)) for p in pubs]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs
    assert all(p.barrier_wall is not None for p in pubs)
    for rank, p in enumerate(pubs):
        _snapshot(ttel, 4 + rank, 0.001 * (rank + 1), 0.003)
        assert p.publish_once() is not None
    ttel.reset()
    tz = tfleet.fleetz(spool=spool, stale_after=600)
    jz = jfleet.fleetz(spool=spool, stale_after=600)
    _close(_drop(tz, {"time", "age_s"}), _drop(jz, {"time", "age_s"}))
    assert sorted(tz["ranks"]) == ["0", "1"]
    assert not any(r["stale"] for r in tz["ranks"].values())
    merged = tz["merged_metrics"]["mxnet_tpu_train_steps_total"]
    assert merged["series"][0]["value"] == 4 + 5
