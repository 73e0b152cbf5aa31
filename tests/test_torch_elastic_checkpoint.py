"""The port's sharded, elastic checkpointing (parity:
tests/test_elastic_checkpoint.py), on CPU.

In-process: the sharded commit protocol against a single-process
``ShardedTrainer`` and against :class:`faults.FakeShardedArray` two-
process managers driven from threads — ownership, the sidecar barrier,
manifest-last commit, restricted (elastic) loads, interrupted-save
invisibility, retention sweeps of kill debris, torn shards, the
coordinated SIGTERM commit riding a periodic boundary, the checkpoint
events and ``/statusz``.  Multi-process: :class:`faults.WorkerFleet`
launches real OS processes running
``mxnet_tpu_torch.testing.elastic_worker --mode protocol`` (a kill in
the middle of a shard write -> fallback; SIGTERM on one rank -> one
pod-wide final commit; save on 2 processes, resume on 1 — bit for bit).

Sharded file parity with the JAX package, both directions, each package
writing from two threads as two processes: f32, int32 and bf16 arrays,
blobs and meta; each package's ``validate_sharded_checkpoint`` accepts
the other's files, the reader loads with every digest verified, and
after ``corrupt_shard`` both packages fall back to the same step.  The
JAX package cannot load a sharded bf16 array, its own included (it
fills an ``ml_dtypes`` bf16 buffer with the ``V2`` chunk ``np.load``
gives: "No cast function available", mxnet_tpu/checkpoint.py:1066-1075);
that reference caveat is pinned here, and the port loads such files
from either package.

Left out, as outside this slice: ``--mode trainer`` of the worker
(``test_fleet_trainer_mode_env_skip``: the port raises "not ported yet"
until the distributed bootstrap exists, checked below) and
``tools/dryrun_multihost.py --check-manifest``
(``test_check_manifest_cli``).
"""
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import jax
from mxnet_tpu import checkpoint as jck

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import checkpoint as ck
from mxnet_tpu_torch import events, parallel, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
import mxnet_tpu_torch.gluon as gluon
from mxnet_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "mxnet_tpu_torch", "tools")
CPU = mx.cpu()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _make_trainer(seed, **kw):
    mx.random.seed(seed)
    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(1))
    net.initialize(ctx=CPU)
    loss_fn = gluon.loss.L2Loss()
    tr = parallel.ShardedTrainer(net, lambda o, l: loss_fn(o, l),
                                 optimizer="adam",
                                 optimizer_params={"learning_rate": 0.05},
                                 **kw)
    return net, tr


_RNG = np.random.RandomState(0)
_X = _RNG.rand(16, 6).astype(np.float32)
_Y = (_X @ _RNG.rand(6, 1)).astype(np.float32)


def _batch(i):
    return nd.array(_X + 0.01 * i, ctx=CPU), nd.array(_Y, ctx=CPU)


def _sharded_mgr(directory, pkg=ck, **kw):
    kw.setdefault("keep_last", 3)
    kw.setdefault("async_save", False)
    return pkg.CheckpointManager(directory, sharded=True, **kw)


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


# ---------------------------------------------------------------------------
# single-process ShardedTrainer on the sharded path
# ---------------------------------------------------------------------------

def test_sharded_roundtrip_bit_for_bit(tmp_path):
    n_steps = 8
    _, tr = _make_trainer(7)
    ref = [float(tr.step([_batch(i)[0]], _batch(i)[1]))
           for i in range(n_steps)]

    _, tr1 = _make_trainer(7)
    m1 = _sharded_mgr(tmp_path)
    try:
        assert tr1.attach_checkpoint_manager(m1, period=3) == 0
        for i in range(4):
            x, y = _batch(i)
            tr1.step([x], y)
    finally:
        m1.uninstall_preemption_handler()
    assert m1.steps() == [3]
    step, problems = ck.validate_sharded_checkpoint(str(tmp_path))
    assert step == 3 and problems == []

    _, tr2 = _make_trainer(999)
    m2 = _sharded_mgr(tmp_path)
    try:
        assert tr2.attach_checkpoint_manager(m2, period=3) == 3
        c = m2.load()
        assert c.sharded and c.n_shards == 1 and c.n_hosts == 1
        rest = []
        for i in range(3, n_steps):
            x, y = _batch(i)
            rest.append(float(tr2.step([x], y)))
    finally:
        m2.uninstall_preemption_handler()
    assert rest == ref[3:], (rest, ref[3:])


def test_sharded_save_never_host_gathers(tmp_path, monkeypatch):
    """The sharded writer snapshots addressable shards only: a sharded
    array reaches ``_to_host`` shard by shard, never whole."""
    real = ck._to_host

    def guard(v):
        assert not ck._is_device_sharded(v), (
            "sharded save host-gathered a sharded array: %r" % (v,))
        return real(v)

    monkeypatch.setattr(ck, "_to_host", guard)
    _, tr = _make_trainer(7)
    m = _sharded_mgr(tmp_path)
    try:
        tr.attach_checkpoint_manager(m, period=1)
        x, y = _batch(0)
        tr.step([x], y)   # periodic sharded save runs under the guard
    finally:
        m.uninstall_preemption_handler()
    assert m.steps() == [1]
    g = np.arange(8, dtype=np.float32).reshape(4, 2)
    _sharded_mgr(tmp_path / "s").save(1, {"w": faults.FakeShardedArray(
        g, 1, 0)})
    # sanity: the dense path does gather (the guard bites)
    dense = ck.CheckpointManager(tmp_path / "dense", async_save=False)
    with pytest.raises(AssertionError):
        dense.save(1, {"p": faults.FakeShardedArray(g, 1, 0)})


# ---------------------------------------------------------------------------
# two-process ownership + elastic restore (FakeShardedArray, threads)
# ---------------------------------------------------------------------------

_G_W = np.arange(64, dtype=np.float32).reshape(8, 8)
_G_M = -2.0 * _G_W
_G_RNG = np.array([1, 2, 3], np.int64)


def _two_host_save(directory, step=10, pkg=ck, arrays=None, blobs=None,
                   meta=None):
    errs = []

    def worker(r):
        try:
            m = pkg.CheckpointManager(directory, keep_last=4,
                                      async_save=False, sharded=True,
                                      process_index=r, process_count=2,
                                      barrier_timeout=30)
            m.save(step, arrays(r) if arrays else
                   {"w": faults.FakeShardedArray(_G_W, 2, r),
                    "m": faults.FakeShardedArray(_G_M, 2, r),
                    "rng": _G_RNG},
                   blobs=blobs,
                   meta=meta or {"step": step, "mesh_axes": {"fsdp": 2},
                                 "layout": "fake"})
        except Exception as e:     # pragma: no cover - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs, errs


def test_two_host_ownership_and_elastic_restore(tmp_path):
    _two_host_save(tmp_path)
    m = _sharded_mgr(tmp_path)
    assert m.steps() == [10]
    with np.load(m.shard_data_path(10, 1)) as z:
        chunks = [z[k] for k in z.files]
    assert all(c.shape == (4, 8) for c in chunks)
    assert any(np.array_equal(c, _G_W[4:]) for c in chunks)
    side0 = json.load(open(m.shard_sidecar_path(10, 0)))
    side1 = json.load(open(m.shard_sidecar_path(10, 1)))
    assert any("blob" in c or c.get("array") == "rng"
               for c in side0["chunks"])
    assert all(c.get("array") != "rng" for c in side1["chunks"])

    c = m.load(context={"mesh_axes": {"fsdp": 1}, "layout": "fake"})
    assert c.sharded and c.n_shards == 2 and c.n_hosts == 2
    assert c.resharded is True and c.shards_read == 2
    assert np.array_equal(c.arrays["w"], _G_W)
    assert np.array_equal(c.arrays["m"], _G_M)
    assert np.array_equal(c.arrays["rng"], _G_RNG)

    r = m.load(restrict={"w": [[[0, 4], [0, 8]]],
                         "m": [[[0, 4], [0, 8]]]},
               context={"mesh_axes": {"fsdp": 2}, "layout": "fake"})
    assert r.shards_read == 1 and r.resharded is False
    assert np.array_equal(r.arrays["w"][:4], _G_W[:4])
    assert not r.arrays["w"][4:].any()
    assert np.array_equal(r.arrays["rng"], _G_RNG)


def test_interrupted_sharded_save_is_invisible(tmp_path, monkeypatch):
    m = _sharded_mgr(tmp_path)
    m.save(1, {"w": np.ones(4, np.float32)}, meta={"step": 1})
    real = ck.atomic_writer

    @contextlib.contextmanager
    def failing(path, *a, **kw):
        if "00000002.shards" in str(path):
            raise OSError("disk gone mid-shard-write")
        with real(path, *a, **kw) as f:
            yield f

    monkeypatch.setattr(ck, "atomic_writer", failing)
    with pytest.raises(OSError):
        m.save(2, {"w": np.zeros(4, np.float32)}, meta={"step": 2})
    monkeypatch.setattr(ck, "atomic_writer", real)
    assert m.steps() == [1]
    assert m.orphan_shard_dirs() == [m.shard_dir(2)]
    with _quiet():
        c = m.load()
    assert c.step == 1
    assert m.sweep_orphans() >= 1
    assert m.orphan_shard_dirs() == []


def test_retention_sweeps_kill_leftovers(tmp_path):
    faults.orphan_shard_dir(tmp_path, 1, n_shards=2)
    m = _sharded_mgr(tmp_path, keep_last=2)
    assert m.orphan_shard_dirs() == [m.shard_dir(1)]
    m.save(5, {"w": np.ones(4, np.float32)}, meta={"step": 5})
    m.save(10, {"w": np.ones(4, np.float32)}, meta={"step": 10})
    assert m.orphan_shard_dirs() == []
    assert m.steps() == [5, 10]
    m.request_coordinated_commit(10)
    (tmp_path / "ckpt-00000010.npz.123.tmp").write_bytes(b"torn")
    assert m.sweep_orphans() >= 2
    assert m.coordinated_commit_request() is None
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    assert m.steps() == [5, 10]


def test_torn_and_missing_shards_fall_back(tmp_path):
    m = _sharded_mgr(tmp_path, keep_last=10)
    for s in (1, 2, 3):
        m.save(s, {"w": np.full(4, float(s), np.float32)},
               meta={"step": s})
    telemetry.enable()
    try:
        before = telemetry.CHECKPOINT_SHARD_DIGEST_FAILURES.value()
        faults.corrupt_shard(tmp_path, 3, host=0, mode="tamper")
        with _quiet():
            c = m.load()
        assert c.step == 2
        assert telemetry.CHECKPOINT_SHARD_DIGEST_FAILURES.value() > before
    finally:
        telemetry.disable()
    faults.drop_shard(tmp_path, 2, host=0)
    with _quiet():
        assert m.load().step == 1
    faults.stale_manifest(tmp_path, 99)
    with _quiet():
        assert m.load().step == 1
    _, problems = ck.validate_sharded_checkpoint(str(tmp_path), step=99)
    assert problems
    step, problems = ck.validate_sharded_checkpoint(str(tmp_path), step=1)
    assert step == 1 and problems == []


def test_coordinated_commit_rides_periodic_boundary(tmp_path):
    _, tr = _make_trainer(7)
    m = _sharded_mgr(tmp_path)
    try:
        tr.attach_checkpoint_manager(m, period=2)
        m.uninstall_preemption_handler()
        m.install_preemption_handler(tr._checkpoint_payload,
                                     coordinated=True, gate=1)
        i = 0
        while tr.global_step < 10 and not m.preempted:
            if tr.global_step == 3:
                faults.send_preemption()
                assert m.coordinated_commit_request() is not None
                assert not m.preempted and m.latest_step() == 2
            x, y = _batch(i)
            tr.step([x], y)
            i += 1
    finally:
        m.uninstall_preemption_handler()
    assert m.preempted
    final = m.latest_step()
    assert final == 4
    c = m.load()
    assert c.meta["preempted"] is True and c.meta["coordinated"] is True
    assert m.coordinated_commit_request() is None
    step, problems = ck.validate_sharded_checkpoint(str(tmp_path))
    assert step == final and problems == []
    assert tr.check_preemption() is False


def test_checkpoint_events_and_statusz(tmp_path):
    path = str(tmp_path / "events.jsonl")
    events.reset()
    events.enable(path=path, sample=1.0)
    telemetry.enable()
    try:
        m = _sharded_mgr(tmp_path / "ckpt")
        m.save(7, {"w": np.ones(4, np.float32)},
               meta={"step": 7, "mesh_axes": {"fsdp": 1},
                     "layout": "fake"})
        m.load(context={"mesh_axes": {"fsdp": 2}, "layout": "fake"})
        events.flush()
        evs = [json.loads(line) for line in open(path) if line.strip()]
        saves = [e for e in evs if e["kind"] == "checkpoint_save"]
        loads = [e for e in evs if e["kind"] == "checkpoint_load"]
        assert saves and loads
        assert saves[0]["sharded"] is True
        assert saves[0]["n_shards"] == 1 and saves[0]["n_hosts"] == 1
        assert loads[0]["sharded"] is True
        assert loads[0]["resharded"] is True
        z = telemetry.statusz()["subsystems"]["checkpoint"]
        assert z["last_committed_step"] == 7
        assert z["shard_count"] == 1
        assert z["manifest_age_s"] is not None and z["manifest_age_s"] >= 0
        for key in ("shard_digest_failures", "elastic_resumes",
                    "orphan_shard_dirs", "preempt_requested"):
            assert key in z, key
        from mxnet_tpu_torch.monitor import TelemetryHeartbeat
        line = TelemetryHeartbeat().line()
        assert "ckpt step 7 shards 1 age" in line, line
    finally:
        events.disable()
        events.reset()
        telemetry.disable()
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "events_query.py"),
         path, "--kind", "checkpoint_save", "--by", "sharded,n_shards"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "True/1" in r.stdout


def test_elastic_restrict_is_none_on_one_card(tmp_path):
    _, tr = _make_trainer(2)
    x, y = _batch(0)
    tr.step([x], y)
    assert tr._elastic_restrict(ck.CheckpointManager(tmp_path)) is None
    assert tr._elastic_restrict(_sharded_mgr(tmp_path / "s")) is None
    two = _sharded_mgr(tmp_path / "t", process_index=0, process_count=2)
    assert tr._elastic_restrict(two) is None   # plain tensors: whole


# ---------------------------------------------------------------------------
# sharded file parity with the JAX package
# ---------------------------------------------------------------------------

def _parity_arrays(side, r):
    """Rank ``r``'s values: a sharded f32 array, a sharded int32 array,
    a host bf16 array (the JAX side's an ml_dtypes array, the port's a
    torch tensor) and a host int64 vector."""
    rng = np.random.RandomState(3)
    f = rng.randn(8, 3).astype(np.float32)
    i = rng.randint(-50, 50, (4, 4)).astype(np.int32)
    b = rng.randn(5).astype(np.float32)
    bf = np.asarray(jax.numpy.asarray(b, dtype=jax.numpy.bfloat16)) \
        if side == "jax" else torch.from_numpy(b).to(torch.bfloat16)
    return {"f": faults.FakeShardedArray(f, 2, r),
            "i": faults.FakeShardedArray(i, 2, r, axis=1),
            "b": bf, "v": np.arange(6, dtype=np.int64)}


_BLOBS = {"opt": b"\x07\x08state"}
_META = {"kind": "parity", "step": 4, "mesh_axes": {"fsdp": 2},
         "layout": "fake"}


def _want():
    rng = np.random.RandomState(3)
    f = rng.randn(8, 3).astype(np.float32)
    i = rng.randint(-50, 50, (4, 4)).astype(np.int32)
    b = rng.randn(5).astype(np.float32)
    bbits = torch.from_numpy(b).to(torch.bfloat16).view(torch.int16).numpy()
    return {"f": f.tobytes(), "i": i.tobytes(), "b": bbits.tobytes(),
            "v": np.arange(6, dtype=np.int64).tobytes()}


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_sharded_file_parity(tmp_path, writer, reader):
    wpkg = jck if writer == "jax" else ck
    rpkg = jck if reader == "jax" else ck
    for s in (3, 4):
        _two_host_save(tmp_path, step=s, pkg=wpkg,
                       arrays=lambda r: _parity_arrays(writer, r),
                       blobs=_BLOBS, meta=dict(_META, step=s))
    man = json.load(open(_sharded_mgr(tmp_path).manifest_path(4)))
    assert man["arrays"]["b"]["dtype"] == "bfloat16"
    assert man["n_processes"] == 2
    for pkg in (jck, ck):
        step, problems = pkg.validate_sharded_checkpoint(str(tmp_path))
        assert step == 4 and problems == [], (pkg.__name__, problems)
    want = _want()
    r = _sharded_mgr(tmp_path, pkg=rpkg)
    if reader == "port":
        c = r.load(step=4, verify=True)
        assert c.n_shards == 2 and c.meta == dict(_META, step=4)
        assert c.blobs == _BLOBS
        for k, raw in want.items():
            assert np.ascontiguousarray(c.arrays[k]).tobytes() == raw, k
        assert c.tensor("b").dtype == torch.bfloat16
    else:
        # the reference caveat: a sharded bf16 array does not load in
        # the JAX package, whoever wrote it
        with pytest.raises(ValueError, match="cast"):
            r.load(step=4, verify=True)
        # everything else of the port's files loads there, verified
        c = r.load(step=4, verify=True,
                   restrict={"b": [[[0, 0]]]})
        assert c.meta == dict(_META, step=4) and c.blobs == _BLOBS
        for k in ("f", "i", "v"):
            assert np.asarray(c.arrays[k]).tobytes() == want[k], k
    # the same digests as the other package's own files
    other = tmp_path / "other"
    _two_host_save(other, step=4, pkg=rpkg,
                   arrays=lambda r: _parity_arrays(reader, r),
                   blobs=_BLOBS, meta=dict(_META, step=4))
    mo = json.load(open(_sharded_mgr(other).manifest_path(4)))

    def digests(manifest):
        return sorted((c.get("array", c.get("blob")), c["sha256"])
                      for sc in manifest["shards"].values()
                      for c in sc["chunks"])

    assert digests(mo) == digests(man)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["flip", "tamper", "truncate"])
def test_sharded_corruption_falls_back_alike(tmp_path, writer, mode):
    wpkg = jck if writer == "jax" else ck
    for s in (1, 2):
        _two_host_save(tmp_path, step=s, pkg=wpkg,
                       arrays=lambda r: {
                           "w": faults.FakeShardedArray(_G_W * s, 2, r)},
                       meta={"step": s})
    faults.corrupt_shard(tmp_path, 2, host=1, mode=mode)
    steps = []
    for pkg in (jck, ck):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            c = _sharded_mgr(tmp_path, pkg=pkg).load()
        assert any("CORRUPT" in str(x.message) for x in rec)
        steps.append(c.step)
        _, problems = pkg.validate_sharded_checkpoint(str(tmp_path), step=2)
        assert problems
    assert steps == [1, 1]


# ---------------------------------------------------------------------------
# the real thing: a fleet of OS processes (protocol mode)
# ---------------------------------------------------------------------------

_BLOCK_RE = re.compile(
    r"ELASTIC_BLOCK rank=(\d+) step=(\d+) block=(\d+) ([0-9a-f]+)")


def _run_fleet(n_procs, worker_args, env=None, timeout=240):
    fleet = faults.WorkerFleet(
        n_procs, ["-m", "mxnet_tpu_torch.testing.elastic_worker"]
        + [str(a) for a in worker_args], env=env, cwd=REPO)
    return fleet.wait(timeout=timeout)


def _blocks(results, step):
    out = {}
    for _, text in results:
        for mt in _BLOCK_RE.finditer(text):
            if int(mt.group(2)) == step:
                out[int(mt.group(3))] = mt.group(4)
    return out


def _assert_all_ok(results):
    for rc, text in results:
        assert rc == 0, text


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    """One uninterrupted 2-rank protocol run to step 6 (saves at 2,4,6)."""
    d = tmp_path_factory.mktemp("pod_a")
    results = _run_fleet(2, ["--dir", d, "--steps", 6, "--save-every", 2,
                             "--run-id", "a0"])
    _assert_all_ok(results)
    blocks6 = _blocks(results, 6)
    assert sorted(blocks6) == [0, 1]
    return d, blocks6


def test_fleet_kill_mid_shard_write_falls_back(tmp_path, pod_run):
    _, ref6 = pod_run
    d = tmp_path / "pod"
    d.mkdir()
    results = _run_fleet(
        2, ["--dir", d, "--steps", 6, "--save-every", 2,
            "--run-id", "k0", "--kill-save-step", 4,
            "--kill-save-rank", 1],
        env={"MXNET_DIST_BARRIER_TIMEOUT": "4"})
    assert results[1][0] == 137, results[1][1]
    assert results[0][0] == 3 and "ELASTIC_SAVE_ABORTED" in results[0][1]
    m = _sharded_mgr(d)
    assert m.steps() == [2]
    assert os.path.isdir(m.shard_dir(4))
    results = _run_fleet(2, ["--dir", d, "--steps", 6,
                             "--save-every", 2, "--run-id", "k1"])
    _assert_all_ok(results)
    for _, text in results:
        assert "ELASTIC_RESUMED rank=" in text and "step=2" in text
    assert _blocks(results, 6) == ref6
    assert _sharded_mgr(d).orphan_shard_dirs() == []


def test_fleet_coordinated_preemption_single_final_commit(tmp_path):
    d = tmp_path / "pod"
    d.mkdir()
    results = _run_fleet(
        2, ["--dir", d, "--steps", 8, "--save-every", 2,
            "--run-id", "p0", "--preempt-step", 4, "--preempt-rank", 1])
    _assert_all_ok(results)
    commits = [re.search(r"ELASTIC_PREEMPT_COMMIT rank=\d+ step=(\d+)",
                         text) for _, text in results]
    assert all(commits), results
    assert {mt.group(1) for mt in commits} == {"4"}
    m = _sharded_mgr(d)
    assert m.latest_step() == 4
    c = m.load()
    assert c.meta["preempted"] is True and c.meta["coordinated"] is True
    assert c.n_shards == 2
    assert m.coordinated_commit_request() is None
    step, problems = ck.validate_sharded_checkpoint(str(d))
    assert step == 4 and problems == []
    # the JAX package validates the port's pod-written lineage too
    assert jck.validate_sharded_checkpoint(str(d)) == (4, [])


def test_fleet_elastic_resume_on_fewer_hosts(tmp_path, pod_run):
    src, ref6 = pod_run
    d = tmp_path / "pod"
    shutil.copytree(src, d)
    results = _run_fleet(1, ["--dir", d, "--steps", 8,
                             "--save-every", 2, "--run-id", "e0"])
    _assert_all_ok(results)
    assert "ELASTIC_RESUMED rank=0 step=6" in results[0][1]
    assert _blocks(results, 6) == ref6
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    ref = _run_fleet(1, ["--dir", fresh, "--steps", 8,
                         "--save-every", 2, "--run-id", "f0"])
    _assert_all_ok(ref)
    assert _blocks(results, 8) == _blocks(ref, 8)
    step, problems = ck.validate_sharded_checkpoint(str(d))
    assert step == 8 and problems == []


def test_worker_trainer_mode_is_not_ported_yet(tmp_path):
    from mxnet_tpu_torch.testing import elastic_worker

    with pytest.raises(MXNetError, match="not ported yet"):
        elastic_worker.main(["--dir", str(tmp_path), "--mode", "trainer"])
