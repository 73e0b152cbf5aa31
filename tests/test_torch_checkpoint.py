"""The port's fault-tolerance layer (mxnet_tpu_torch.checkpoint and
testing.faults) against the JAX package's, on CPU.

The cases of ``tests/test_checkpoint.py``, case by case, on the port:
torn writes (``FailingWriter``), bit-rot (``flip_bit``), truncation,
corrupt manifests, simulated preemption (``send_preemption`` -> SIGTERM),
retry with its deadline, the non-finite policies, the download retry,
kill-and-resume of a ``ShardedTrainer`` bit for bit (params, optimizer
state and the random stream restored), the preemption flush after
``step_many``, ``Module.fit`` resumed against an uninterrupted fit, and
the atomic-write guards over the port's tree.  Left out: the model
store's mirror (``test_model_store_uses_repo_mirror``), which is not
this layer.

Then what only two packages can show:

* file parity, both directions: a dense checkpoint of f32, int32 and
  bf16 arrays (bf16 stored as its 16-bit patterns, numpy ``V2``, with
  ``"bfloat16"`` in the manifest), blobs and meta, written by one
  package, loads in the other with every digest verified, arrays bit
  equal and meta equal; after ``flip_bit`` and ``truncate_file`` both
  packages fall back to the same step;
* the trainer: a small conv + BatchNorm + Dropout + Dense net through the
  port's ``ShardedTrainer`` (sgd momentum and adam) runs 3 steps, saves,
  and a fresh trainer from other weights resumes and runs 3 more: the 6
  losses and the final state are bit-equal to an uninterrupted run,
  Dropout included;
* the same net with Dropout at rate 0 (the two packages' generators
  never draw the same masks) from the same numpy weights in both
  packages: each resumes from its own checkpoint, and the port's losses
  stay within ``test_torch_sharded_trainer.py``'s rtol 1e-5 of the JAX
  package's; the JAX trainer's checkpoint restores into the port's
  trainer bit for bit, and its every ``param:`` and ``opt:`` array is
  within that file's state tolerance of the port's own state after the
  same steps, which holds only if the optimizer leaves are in the same
  order (sgd's ``mom``; adam's ``m``, ``t``, ``v``).  Its JAX key is
  left alone, with a warning.

Both sides run with f32 matmuls at full precision
(``jax.default_matmul_precision("float32")``,
``torch.set_float32_matmul_precision("highest")``).
"""
import hashlib
import json
import logging
import os
import re
import warnings

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jck
from mxnet_tpu import parallel as jparallel
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import checkpoint as ck
from mxnet_tpu_torch import parallel
from mxnet_tpu_torch.gluon import nn
import mxnet_tpu_torch.gluon as gluon
from mxnet_tpu_torch.name import NameManager as TNameManager
from mxnet_tpu_torch.testing import faults

CPU = mx.cpu()


# ---------------------------------------------------------------------------
# atomic writes + retry
# ---------------------------------------------------------------------------

def test_atomic_write_crash_leaves_previous_intact(tmp_path):
    p = str(tmp_path / "ckpt.bin")
    ck.atomic_write(p, b"generation-1")
    with pytest.raises(OSError):
        with ck.atomic_writer(p) as f:
            f.write(b"gen")
            raise OSError("simulated crash mid-write")
    assert open(p, "rb").read() == b"generation-1"
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_atomic_write_failing_writer_injection(tmp_path):
    p = str(tmp_path / "w.bin")
    ck.atomic_write(p, b"old-complete-data")
    with pytest.raises(OSError, match="injected"):
        with ck.atomic_writer(p) as f:
            wrapped = faults.FailingWriter(f, fail_after=4)
            wrapped.write(b"1234")
            wrapped.write(b"56789")  # exceeds budget -> OSError
    assert open(p, "rb").read() == b"old-complete-data"


def test_failing_open_only_bites_matching_writes(tmp_path):
    opener = faults.failing_open(3, only_suffix=".npz")
    with opener(str(tmp_path / "a.json"), "w") as f:
        f.write("untouched")
    f = opener(str(tmp_path / "b.npz"), "wb")
    with pytest.raises(OSError, match="injected"):
        f.write(b"12345")
    f.close()
    assert open(tmp_path / "b.npz", "rb").read() == b"123"


def test_retry_flaky_then_success_and_exhaustion():
    flaky = faults.FlakyCallable(2, value="ok")
    assert ck.retry(flaky, retries=3, backoff=0.001)() == "ok"
    assert flaky.calls == 3
    dead = faults.FlakyCallable(10, value="never")
    with pytest.raises(OSError):
        ck.retry(dead, retries=2, backoff=0.001)()
    assert dead.calls == 3
    bomb = faults.FlakyCallable(5, exc=ValueError("not transient"))
    with pytest.raises(ValueError):
        ck.retry(bomb, retries=3, backoff=0.001)()
    assert bomb.calls == 1


def test_retry_deadline_bounds_total_wall_clock():
    import time

    dead = faults.FlakyCallable(10, value="never")
    t0 = time.monotonic()
    with pytest.raises(OSError):
        ck.retry(dead, retries=50, backoff=0.2, jitter=0.0,
                 deadline=0.05)()
    assert time.monotonic() - t0 < 0.2
    assert dead.calls == 1
    flaky = faults.FlakyCallable(2, value="ok")
    assert ck.retry(flaky, retries=5, backoff=0.001, deadline=30.0)() \
        == "ok"
    assert flaky.calls == 3
    one = faults.FlakyCallable(10, value="never")
    with pytest.raises(OSError):
        ck.retry(one, retries=5, backoff=0.001, deadline=0.0)()
    assert one.calls == 1
    with pytest.raises(ValueError):
        ck.retry(lambda: None, deadline=-1.0)


# ---------------------------------------------------------------------------
# CheckpointManager: manifest, retention, corruption fallback, async
# ---------------------------------------------------------------------------

def _payload(v, n=32):
    return {"w": np.full(n, v, np.float32), "b": np.arange(3) + v}


def test_manager_roundtrip_and_manifest(tmp_path):
    m = ck.CheckpointManager(tmp_path, keep_last=4, async_save=False)
    m.save(3, _payload(3.0), blobs={"opt": b"\x01\x02"},
           meta={"epoch": 1, "note": "hi"})
    man = json.load(open(m.manifest_path(3)))
    assert man["format_version"] == ck.MANIFEST_FORMAT == 1
    assert man["step"] == 3
    assert set(man["arrays"]) == {"w", "b"}
    assert man["arrays"]["w"]["shape"] == [32]
    assert re.fullmatch("[0-9a-f]{64}", man["arrays"]["w"]["sha256"])
    assert man["blobs"]["opt"]["size"] == 2
    assert man["meta"]["note"] == "hi"
    c = m.load()
    assert c.step == 3 and c.blobs["opt"] == b"\x01\x02"
    np.testing.assert_array_equal(c.arrays["w"], _payload(3.0)["w"])
    assert m.latest_step() == 3


def test_retention_keeps_last_n(tmp_path):
    m = ck.CheckpointManager(tmp_path, keep_last=2, async_save=False)
    for s in range(5):
        m.save(s, _payload(float(s)))
    assert m.steps() == [3, 4]
    assert not os.path.exists(m.data_path(1))


def test_bitflip_detected_and_falls_back(tmp_path):
    m = ck.CheckpointManager(tmp_path, keep_last=4, async_save=False)
    m.save(1, _payload(1.0))
    m.save(2, _payload(2.0))
    blob = open(m.data_path(2), "rb").read()
    off = blob.find(_payload(2.0)["w"].tobytes()[:16])
    assert off > 0
    faults.flip_bit(m.data_path(2), offset=off + 5)
    with pytest.raises(ck.CheckpointCorruptError):
        m.load(step=2)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        c = m.load()
    assert c.step == 1
    assert any("CORRUPT" in str(w.message) for w in rec)
    np.testing.assert_array_equal(c.arrays["w"], _payload(1.0)["w"])


def test_digest_mismatch_on_valid_zip(tmp_path):
    m = ck.CheckpointManager(tmp_path, keep_last=4, async_save=False)
    m.save(7, _payload(7.0))
    forged = {"array:w": np.full(32, 9.0, np.float32),
              "array:b": np.arange(3) + 7}
    with open(m.data_path(7), "wb") as f:
        np.savez(f, **forged)
    with pytest.raises(ck.CheckpointCorruptError, match="digest mismatch"):
        m.load(step=7)


def test_corrupt_manifest_falls_back(tmp_path):
    m = ck.CheckpointManager(tmp_path, keep_last=4, async_save=False)
    m.save(1, _payload(1.0))
    m.save(2, _payload(2.0))
    faults.corrupt_file(m.manifest_path(2))
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        c = m.load()
    assert c.step == 1


def test_truncated_data_file_falls_back(tmp_path):
    m = ck.CheckpointManager(tmp_path, keep_last=4, async_save=False)
    m.save(1, _payload(1.0))
    m.save(2, _payload(2.0))
    faults.truncate_file(m.data_path(2), drop_bytes=64)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        c = m.load()
    assert c.step == 1
    faults.truncate_file(m.data_path(1), keep_bytes=10)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        assert m.load() is None


def test_async_overlap_serializes_and_commits_all(tmp_path):
    m = ck.CheckpointManager(tmp_path, keep_last=10, async_save=True)
    for s in range(6):
        m.save(s, _payload(float(s)))
    m.wait()
    assert m.steps() == list(range(6))
    for s in (0, 5):
        c = m.load(step=s)
        np.testing.assert_array_equal(c.arrays["w"], _payload(float(s))["w"])
    m.save(6, _payload(6.0))
    assert m.load().step == 6


@pytest.mark.parametrize("kind", ["numpy", "tensor", "ndarray"])
def test_async_save_snapshots_before_mutation(tmp_path, kind):
    """The host copy is taken in save(): mutating the source right after
    (a numpy array, a CPU tensor whose numpy() shares memory, an
    NDArray) does not reach the checkpoint."""
    m = ck.CheckpointManager(tmp_path, keep_last=2, async_save=True)
    arr = np.full(1024, 1.0, np.float32)
    src = {"numpy": arr, "tensor": torch.from_numpy(arr),
           "ndarray": nd.array(arr, ctx=CPU)}[kind]
    m.save(1, {"w": src})
    src[:] = -1.0
    m.wait()
    np.testing.assert_array_equal(m.load().arrays["w"],
                                  np.full(1024, 1.0, np.float32))


def test_async_writer_failure_surfaces_at_wait_and_next_save(tmp_path,
                                                            monkeypatch):
    m = ck.CheckpointManager(tmp_path, keep_last=2, async_save=True)
    real = ck.atomic_writer

    def broken(path, mode="wb"):
        raise OSError("disk gone")

    monkeypatch.setattr(ck, "atomic_writer", broken)
    m.save(1, _payload(1.0))
    with pytest.raises(OSError, match="disk gone"):
        m.wait()
    m.save(2, _payload(2.0))
    monkeypatch.setattr(ck, "atomic_writer", real)
    with pytest.raises(OSError, match="disk gone"):
        m.save(3, _payload(3.0))
    m.save(4, _payload(4.0))
    m.wait()
    assert m.steps() == [4]


def test_preemption_handler_flushes_final_checkpoint(tmp_path):
    import signal

    before = signal.getsignal(signal.SIGTERM)
    m = ck.CheckpointManager(tmp_path, keep_last=3, async_save=True)
    state = {"step": 11}
    m.install_preemption_handler(
        lambda: (state["step"], _payload(11.0), {"opt": b"s"},
                 {"epoch": 5}))
    try:
        faults.send_preemption()
    finally:
        m.uninstall_preemption_handler()
    assert signal.getsignal(signal.SIGTERM) is before
    assert m.preempted
    c = m.load()
    assert c.step == 11 and c.meta["preempted"] is True
    assert c.meta["epoch"] == 5 and c.blobs["opt"] == b"s"


# ---------------------------------------------------------------------------
# non-finite policy plumbing
# ---------------------------------------------------------------------------

def test_nonfinite_policy_resolution(monkeypatch):
    assert ck.nonfinite_policy("skip") == "skip"
    monkeypatch.setenv("MXNET_NONFINITE_POLICY", "raise")
    assert ck.nonfinite_policy(None) == "raise"
    with pytest.raises(mx.base.MXNetError):
        ck.nonfinite_policy("explode")


def test_check_finite_policies():
    ok = np.ones(3, np.float32)
    bad = np.array([1.0, np.nan], np.float32)
    assert ck.check_finite(bad, "off")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert ck.check_finite([ok, bad], "warn")
    assert rec
    assert not ck.check_finite(bad, "skip")
    with pytest.raises(ck.NonfiniteError):
        ck.check_finite(bad, "raise")
    assert ck.check_finite(np.array([1, 2]), "raise")


def test_clip_global_norm_policy():
    from mxnet_tpu_torch.gluon.utils import clip_global_norm

    def grads():
        return [nd.array(np.array([3.0, 4.0], np.float32), ctx=CPU),
                nd.array(np.array([np.nan], np.float32), ctx=CPU)]

    with pytest.raises(ck.NonfiniteError):
        clip_global_norm(grads(), 1.0, on_nonfinite="raise")
    g = grads()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        clip_global_norm(g, 1.0, on_nonfinite="skip")
    assert any("nan or inf" in str(w.message) for w in rec)
    np.testing.assert_array_equal(g[0].asnumpy(), [3.0, 4.0])
    g2 = [nd.array(np.array([3.0, 4.0], np.float32), ctx=CPU)]
    total = clip_global_norm(g2, 1.0)
    assert abs(total - 5.0) < 1e-5
    assert np.abs(g2[0].asnumpy()).max() < 1.0


def test_download_file_url_with_retry_and_sha1(tmp_path, monkeypatch):
    from mxnet_tpu_torch.gluon import utils as gutils
    import urllib.request as ur

    src = tmp_path / "weights.params"
    src.write_bytes(b"pretend-params" * 100)
    sha1 = hashlib.sha1(src.read_bytes()).hexdigest()
    url = "file://" + str(src)
    flaky = faults.FlakyCallable(1, fn=ur.urlopen)
    monkeypatch.setattr(ur, "urlopen", flaky)
    dst = str(tmp_path / "out" / "weights.params")
    got = gutils.download(url, path=dst, sha1_hash=sha1, retries=3)
    assert got == dst and flaky.calls == 2
    assert gutils.check_sha1(dst, sha1)
    with pytest.raises(OSError):
        gutils.download(url, path=str(tmp_path / "bad.params"),
                        sha1_hash="0" * 40, retries=1)
    assert not os.path.exists(tmp_path / "bad.params")


# ---------------------------------------------------------------------------
# ShardedTrainer: kill-and-resume bit-for-bit + NaN guards
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


def _host(t):
    return t.detach().cpu().numpy().copy()


def test_kill_and_resume_bit_for_bit(tmp_path):
    """SIGTERM mid-training -> flushed checkpoint -> a fresh trainer from
    another seed auto-resumes and the combined loss trajectory equals
    the uninterrupted run exactly."""
    n_steps = 8
    _, tr = _make_trainer(7)
    ref = []
    for i in range(n_steps):
        x, y = _batch(i)
        ref.append(float(tr.step([x], y)))

    _, tr1 = _make_trainer(7)
    m1 = ck.CheckpointManager(tmp_path, keep_last=3, async_save=True)
    assert tr1.attach_checkpoint_manager(m1, period=2) == 0
    part, i = [], 0
    try:
        while tr1.global_step < n_steps and not m1.preempted:
            if tr1.global_step == 4:
                faults.send_preemption()  # SIGTERM (handler flushes)
            x, y = _batch(i)
            part.append(float(tr1.step([x], y)))
            i += 1
    finally:
        m1.uninstall_preemption_handler()
    assert m1.preempted
    resume_from = m1.load().meta["step"]
    assert resume_from >= 4

    _, tr2 = _make_trainer(999)
    m2 = ck.CheckpointManager(tmp_path, keep_last=3, async_save=True)
    resumed = tr2.attach_checkpoint_manager(m2, period=2)
    assert resumed == resume_from
    rest, i = [], resumed
    try:
        while tr2.global_step < n_steps:
            x, y = _batch(i)
            rest.append(float(tr2.step([x], y)))
            i += 1
    finally:
        m2.wait()
        m2.uninstall_preemption_handler()
    full = part[:resumed] + rest
    assert len(full) == len(ref)
    assert all(a == b for a, b in zip(ref, full)), (ref, full)


def test_resume_falls_back_past_corrupt_latest(tmp_path):
    _, tr = _make_trainer(5)
    m = ck.CheckpointManager(tmp_path, keep_last=5, async_save=False)
    tr.attach_checkpoint_manager(m, period=1, install_signal_handler=False)
    for i in range(3):
        x, y = _batch(i)
        tr.step([x], y)
    good = _host(tr.param_arrays[0])
    x, y = _batch(3)
    tr.step([x], y)
    assert m.steps() == [1, 2, 3, 4]
    blob = open(m.data_path(4), "rb").read()
    off = blob.find(_host(tr.param_arrays[0]).tobytes()[:16])
    faults.flip_bit(m.data_path(4), offset=(off + 3) if off > 0 else None)
    _, tr2 = _make_trainer(77)
    m2 = ck.CheckpointManager(tmp_path, keep_last=5, async_save=False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        resumed = tr2.attach_checkpoint_manager(
            m2, install_signal_handler=False)
    assert resumed == 3
    assert any("CORRUPT" in str(w.message) for w in rec)
    np.testing.assert_array_equal(m2.load(step=3).arrays["param:0000"],
                                  good)
    # the deferred-shape restore applies on the first step
    x, y = _batch(3)
    loss = tr2.step([x], y)
    assert tr2.global_step == 4 and np.isfinite(float(loss))


def test_sharded_nonfinite_skip_discards_update():
    _, tr = _make_trainer(9, on_nonfinite="skip")
    x, y = _batch(0)
    tr.step([x], y)
    before = [_host(a) for a in tr.param_arrays]
    opt_before = _host(tr.opt_state["m"][0])
    xb = _X.copy()
    xb[0, 0] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loss = tr.step([nd.array(xb, ctx=CPU)], y)
    assert not np.isfinite(float(loss))
    assert tr.skipped_steps == 1
    after = [_host(a) for a in tr.param_arrays]
    assert all(np.array_equal(a, b) for a, b in zip(before, after))
    np.testing.assert_array_equal(_host(tr.opt_state["m"][0]), opt_before)
    loss2 = tr.step([x], y)
    assert np.isfinite(float(loss2))
    after2 = [_host(a) for a in tr.param_arrays]
    assert not all(np.array_equal(a, b) for a, b in zip(after, after2))


def test_sharded_nonfinite_raise():
    _, tr = _make_trainer(11, on_nonfinite="raise")
    xb = _X.copy()
    xb[0, 0] = np.inf
    with pytest.raises(ck.NonfiniteError):
        tr.step([nd.array(xb, ctx=CPU)], nd.array(_Y, ctx=CPU))


def test_preemption_flush_drains_fused_steps(tmp_path):
    """SIGTERM right after an async step_many: the flushed checkpoint
    holds the call's whole boundary — params bit for bit those of a
    per-step run to the same step."""
    _, ref = _make_trainer(7)
    for i in range(4):
        x, y = _batch(i)
        ref.step(x, y)
    ref_params = [_host(a) for a in ref.param_arrays]

    _, tr = _make_trainer(7, async_metrics=True, steps_per_call=4)
    m = ck.CheckpointManager(tmp_path, keep_last=2, async_save=True)
    assert tr.attach_checkpoint_manager(m) == 0
    try:
        tr.step_many([_batch(i) for i in range(4)])
        faults.send_preemption()
    finally:
        m.wait()
        m.uninstall_preemption_handler()
    assert m.preempted
    ckpt = m.load()
    assert ckpt.meta["step"] == 4
    for i, want in enumerate(ref_params):
        np.testing.assert_array_equal(ckpt.arrays["param:%04d" % i], want)
    tr.drain()


def test_signals_are_held_across_dispatch_and_commit(tmp_path,
                                                     monkeypatch):
    """With a manager attached, a SIGTERM raised inside the step is held
    until the step has committed: the flush then writes the new step.
    The step runs with SIGTERM unblocked, so a thread it makes does not
    inherit a mask."""
    import signal

    _, tr = _make_trainer(3)
    m = ck.CheckpointManager(tmp_path, keep_last=2, async_save=False)
    tr.attach_checkpoint_manager(m)
    real = tr._step_core
    fired = []

    def core(*a, **kw):
        if not fired:
            fired.append(True)
            assert signal.SIGTERM not in signal.pthread_sigmask(
                signal.SIG_BLOCK, [])
            os.kill(os.getpid(), signal.SIGTERM)   # held
            assert not m.preempted
        return real(*a, **kw)

    monkeypatch.setattr(tr, "_step_core", core)
    try:
        x, y = _batch(0)
        tr.step([x], y)
    finally:
        m.uninstall_preemption_handler()
    assert fired and m.preempted
    assert m.load().meta["step"] == 1


def test_goodput_recorder_begins_at_attach(tmp_path, monkeypatch):
    from mxnet_tpu_torch import goodput as tgp

    monkeypatch.setenv("MXNET_GOODPUT_DIR", str(tmp_path / "gp"))
    try:
        _, tr = _make_trainer(4)
        x, y = _batch(0)
        tr.step([x], y)
        assert not tgp.active()          # no recorder from a step alone
        m = ck.CheckpointManager(tmp_path / "c", async_save=False)
        tr.attach_checkpoint_manager(m, period=1,
                                     install_signal_handler=False)
        assert tgp.active()
        tr.step([x], y)
        tgp.note_exit("clean", step=tr.global_step)
        rep = tgp.goodputz(dir=str(tmp_path / "gp"))
        kinds = rep["buckets_s"]
        assert kinds["goodput"] > 0 and kinds["ckpt_save"] > 0
    finally:
        rec = tgp._recorder
        if rec is not None:
            rec.end("clean")
        tgp.set_dir(None)


# ---------------------------------------------------------------------------
# Module front-end: resume + guard
# ---------------------------------------------------------------------------

def _make_module():
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=1, name="fc")
    out = mx.sym.LinearRegressionOutput(fc, mx.sym.Variable("lro_label"),
                                        name="lro")
    return mx.mod.Module(out, data_names=["data"], label_names=["lro_label"],
                         context=CPU)


_MX = _RNG.rand(20, 4).astype(np.float32)
_MY = (_MX @ _RNG.rand(4, 1)).astype(np.float32)


def _mod_iter(X=None):
    with mx.Context(CPU):
        return mx.io.NDArrayIter(_MX if X is None else X, _MY, batch_size=5,
                                 label_name="lro_label")


def test_module_fit_checkpoint_resume_matches_uninterrupted(tmp_path):
    fitkw = dict(eval_metric="mse", optimizer="sgd",
                 optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    m = ck.CheckpointManager(tmp_path, keep_last=5, async_save=False)
    mod = _make_module()
    mx.random.seed(3)
    mod.fit(_mod_iter(), num_epoch=2, checkpoint_manager=m, **fitkw)
    assert m.steps() == [0, 1]
    mod2 = _make_module()
    m2 = ck.CheckpointManager(tmp_path, keep_last=5, async_save=False)
    mod2.fit(_mod_iter(), num_epoch=4, checkpoint_manager=m2, **fitkw)
    mod3 = _make_module()
    mx.random.seed(3)
    mod3.fit(_mod_iter(), num_epoch=4, **fitkw)
    a2, _ = mod2.get_params()
    a3, _ = mod3.get_params()
    for k in a3:
        np.testing.assert_array_equal(a2[k].asnumpy(), a3[k].asnumpy())


def test_module_fit_preemption_flush_and_resume(tmp_path):
    """SIGTERM inside an epoch: the flush saves the params of the batch
    reached, the fit leaves its loop, and the next fit re-enters the
    interrupted epoch from them."""
    fitkw = dict(eval_metric="mse", optimizer="sgd",
                 optimizer_params={"learning_rate": 0.1})
    m = ck.CheckpointManager(tmp_path, keep_last=5, async_save=False)
    mod = _make_module()
    calls = []

    def cb(param):
        calls.append(param.nbatch)
        if param.epoch == 1 and param.nbatch == 1:
            faults.send_preemption()

    mx.random.seed(3)
    mod.fit(_mod_iter(), num_epoch=3, checkpoint_manager=m,
            batch_end_callback=cb, **fitkw)
    assert m.preempted
    c = m.load()
    assert c.step == 1 and c.meta["partial"] is True
    assert c.meta["epoch"] == 0 and c.blobs["optimizer_states"]
    mod2 = _make_module()
    m2 = ck.CheckpointManager(tmp_path, keep_last=5, async_save=False)
    mod2.fit(_mod_iter(), num_epoch=3, checkpoint_manager=m2, **fitkw)
    assert not m2.preempted and m2.latest_step() == 2


def test_module_fit_resume_after_preemption_matches_a_fit_from_the_flush(
        tmp_path):
    """SIGTERM in the middle of epoch 1 with momentum: the flush holds
    the params the fit stopped at, bit for bit, and the auto-resumed fit
    equals one started by hand from the flushed params, optimizer state
    and epoch."""
    opt_params = {"learning_rate": 0.1, "momentum": 0.9}
    fitkw = dict(eval_metric="mse", optimizer="sgd",
                 optimizer_params=opt_params)
    m = ck.CheckpointManager(tmp_path, keep_last=5, async_save=False)
    mod = _make_module()
    seen = []

    def cb(param):
        seen.append((param.epoch, param.nbatch))
        if param.epoch == 1 and param.nbatch == 1:
            faults.send_preemption()

    mx.random.seed(3)
    mod.fit(_mod_iter(), num_epoch=3, checkpoint_manager=m,
            batch_end_callback=cb, **fitkw)
    assert m.preempted and seen[-1] == (1, 1)
    c = m.load()
    assert c.step == 1 and c.meta["partial"] is True
    epoch, arg, aux, opt = ck.split_module_payload(c)
    assert epoch == 0 and opt
    live = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    assert sorted(arg) == sorted(live)
    for k in live:
        np.testing.assert_array_equal(arg[k], live[k])

    resumed = _make_module()
    resumed.fit(_mod_iter(), num_epoch=3, checkpoint_manager=ck.
                CheckpointManager(tmp_path, keep_last=5, async_save=False),
                **fitkw)
    it = _mod_iter()
    by_hand = _make_module()
    by_hand.bind(it.provide_data, it.provide_label)
    arg_nd = {k: nd.array(v, ctx=CPU) for k, v in arg.items()}
    aux_nd = {k: nd.array(v, ctx=CPU) for k, v in aux.items()}
    by_hand.init_params(arg_params=arg_nd, aux_params=aux_nd)
    by_hand.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
    by_hand.set_optimizer_states_bytes(opt)
    by_hand.fit(it, num_epoch=3, begin_epoch=epoch + 1, arg_params=arg_nd,
                aux_params=aux_nd, force_init=True, **fitkw)
    a_r, _ = resumed.get_params()
    a_h, _ = by_hand.get_params()
    for k in a_h:
        np.testing.assert_array_equal(a_r[k].asnumpy(), a_h[k].asnumpy())
        assert not np.array_equal(a_r[k].asnumpy(), arg[k])


def test_module_fit_rejects_a_trainer_checkpoint(tmp_path):
    _, tr = _make_trainer(1)
    m = ck.CheckpointManager(tmp_path, async_save=False)
    x, y = _batch(0)
    tr.step([x], y)
    tr.save_checkpoint(m)
    with pytest.raises(ValueError, match="not written by"):
        _make_module().fit(_mod_iter(), num_epoch=1, checkpoint_manager=m)


def test_module_fit_nonfinite_policies():
    Xn = _MX.copy()
    Xn[7, 0] = np.nan
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        skip = _make_module()
        skip.fit(_mod_iter(Xn), num_epoch=1, eval_metric="mse",
                 on_nonfinite="skip")
        ok = _make_module()
        ok.fit(_mod_iter(Xn), num_epoch=1, eval_metric="mse",
               on_nonfinite="warn")
    a_skip, _ = skip.get_params()
    assert all(np.isfinite(v.asnumpy()).all() for v in a_skip.values())
    a_warn, _ = ok.get_params()
    assert any(not np.isfinite(v.asnumpy()).all() for v in a_warn.values())
    with pytest.raises(ck.NonfiniteError):
        bad = _make_module()
        bad.fit(_mod_iter(Xn), num_epoch=1, eval_metric="mse",
                on_nonfinite="raise")


# ---------------------------------------------------------------------------
# atomic-write guards over the port's tree
# ---------------------------------------------------------------------------

_RAW_OPEN_WB = re.compile(r"(?<![\w.])open\(\s*[^),]*,\s*['\"]wb?['\"]")
# streaming/record formats and the fault injectors write in place; the
# command-line tools under tools/ are the counterpart of the JAX
# package's repo-level tools/, which its own scan leaves out too
_RAW_WRITE_ALLOWLIST = {"recordio.py", "testing/faults.py"}


def _prod_sources():
    root = os.path.join(os.path.dirname(__file__), "..", "mxnet_tpu_torch")
    for dirpath, _dirs, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for fn in files:
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                if not rel.startswith("tools/"):
                    yield rel, full


def test_no_raw_binary_writes_in_production_tree():
    offenders = []
    for rel, full in _prod_sources():
        if rel in _RAW_WRITE_ALLOWLIST:
            continue
        src = open(full).read()
        if "pickle.dump(" in src:
            offenders.append((rel, "pickle.dump"))
        for m in _RAW_OPEN_WB.finditer(src):
            offenders.append((rel, m.group(0)))
    assert not offenders, offenders


def test_runtime_final_paths_only_appear_via_replace(tmp_path, monkeypatch):
    import builtins

    opened_w, replaced = [], []
    real_open, real_replace = builtins.open, os.replace

    def spy_open(path, mode="r", *a, **kw):
        if isinstance(mode, str) and ("w" in mode or "a" in mode):
            opened_w.append(str(path))
        return real_open(path, mode, *a, **kw)

    def spy_replace(src, dst, *a, **kw):
        replaced.append(str(dst))
        return real_replace(src, dst, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(os, "replace", spy_replace)

    finals = []
    p = str(tmp_path / "arrs.params")
    nd.save(p, {"w": nd.array(np.ones(4, np.float32), ctx=CPU)})
    finals.append(p)
    p = str(tmp_path / "arrs.bin")
    nd.save(p, [nd.array(np.ones(2, np.float32), ctx=CPU)], format="binary")
    finals.append(p)
    sym = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=1)
    mx.model.save_checkpoint(str(tmp_path / "net"), 0, sym,
                             {"w": nd.array(np.ones(1, np.float32),
                                            ctx=CPU)}, {})
    finals += [str(tmp_path / "net-symbol.json"),
               str(tmp_path / "net-0000.params")]
    m = ck.CheckpointManager(tmp_path, keep_last=2, async_save=False)
    m.save(1, {"w": np.ones(3, np.float32)})
    finals += [m.data_path(1), m.manifest_path(1)]
    for f in finals:
        assert os.path.exists(f)
        assert f in replaced, "%s never committed via os.replace" % f
        assert f not in opened_w, "%s was opened for writing directly" % f


def test_trainer_save_states_atomic(tmp_path):
    net = nn.Dense(2)
    net.initialize(ctx=CPU)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9})
    x = nd.array(np.ones((4, 3), np.float32), ctx=CPU)
    with mx.autograd.record():
        y = net(x)
        loss = (y * y).sum()
    loss.backward()
    tr.step(4)
    p = str(tmp_path / "trainer.states")
    tr.save_states(p)
    assert os.path.getsize(p) > 0
    blob = open(p, "rb").read()
    faults.truncate_file(p, keep_bytes=len(blob) // 2)
    with pytest.raises(Exception):
        tr.load_states(p)
    ck.atomic_write(p, blob)
    tr.load_states(p)


# ---------------------------------------------------------------------------
# the random stream's snapshot
# ---------------------------------------------------------------------------

def test_key_data_resumes_every_stream():
    mx.random.seed(5)
    g = mx.random.generator(torch.device("cpu"))
    torch.rand(3, generator=g)
    mx.random.host_rng().rand(2)
    snap = mx.random.get_key_data()
    assert snap.dtype == np.uint8 and snap.ndim == 1

    def draws():
        return (torch.rand(4, generator=mx.random.generator(
            torch.device("cpu"))).numpy(),
            mx.random.host_rng().rand(3), torch.rand(2).numpy())

    want = draws()
    mx.random.seed(99)
    draws()
    mx.random.set_key_data(snap)
    got = draws()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="JAX PRNG key"):
        mx.random.set_key_data(np.array([0, 7], np.uint32))


# ---------------------------------------------------------------------------
# file parity with the JAX package (dense)
# ---------------------------------------------------------------------------

def _parity_arrays():
    """f32, int32 and bf16 host values; bf16 as the JAX package holds it
    (an ml_dtypes array) and as the port does (a torch tensor)."""
    rng = np.random.RandomState(1)
    f = rng.randn(3, 5).astype(np.float32)
    i = rng.randint(-9, 9, (4,)).astype(np.int32)
    b = rng.randn(2, 6).astype(np.float32)
    jax_side = {"f": f, "i": i, "b": np.asarray(jax.numpy.asarray(
        b, dtype=jax.numpy.bfloat16))}
    port_side = {"f": torch.from_numpy(f), "i": i,
                 "b": torch.from_numpy(b).to(torch.bfloat16)}
    return jax_side, port_side


_BLOBS = {"opt": b"\x00\x01state"}
_META = {"kind": "parity", "epoch": 3, "nested": {"a": [1, 2]}}


def _pkg(name):
    return {"jax": jck, "port": ck}[name]


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_dense_file_parity(tmp_path, writer, reader):
    jside, pside = _parity_arrays()
    arrays = jside if writer == "jax" else pside
    w = _pkg(writer).CheckpointManager(tmp_path, keep_last=5,
                                       async_save=False)
    w.save(1, arrays, blobs=_BLOBS, meta=_META)
    w.save(2, arrays, blobs=_BLOBS, meta=dict(_META, epoch=4))
    man = json.load(open(w.manifest_path(2)))
    assert man["arrays"]["b"]["dtype"] == "bfloat16"
    with np.load(w.data_path(2)) as z:
        assert z["array:b"].dtype == np.dtype("V2")
    r = _pkg(reader).CheckpointManager(tmp_path, keep_last=5)
    c = r.load(step=2, verify=True)
    assert c.meta == dict(_META, epoch=4) and c.blobs == _BLOBS
    for k, v in jside.items():
        assert np.asarray(c.arrays[k]).tobytes() == np.asarray(v).tobytes()
    if reader == "port":
        b = c.tensor("b")
        assert b.dtype == torch.bfloat16
        assert torch.equal(b, pside["b"])
    # both packages' files are byte-compatible: the same manifest digests
    other = _pkg(reader).CheckpointManager(tmp_path / "o", async_save=False)
    other.save(2, jside if reader == "jax" else pside, blobs=_BLOBS,
               meta=dict(_META, epoch=4))
    m2 = json.load(open(other.manifest_path(2)))
    assert {k: v["sha256"] for k, v in m2["arrays"].items()} == \
        {k: v["sha256"] for k, v in man["arrays"].items()}
    assert {k: v["dtype"] for k, v in m2["arrays"].items()} == \
        {k: v["dtype"] for k, v in man["arrays"].items()}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_dense_corruption_falls_back_alike(tmp_path, writer, damage):
    jside, pside = _parity_arrays()
    w = _pkg(writer).CheckpointManager(tmp_path, keep_last=5,
                                       async_save=False)
    for s in (1, 2):
        w.save(s, jside if writer == "jax" else pside, meta={"s": s})
    if damage == "flip":
        blob = open(w.data_path(2), "rb").read()
        off = blob.find(jside["f"].tobytes()[:16])
        faults.flip_bit(w.data_path(2), offset=off + 2)
    else:
        faults.truncate_file(w.data_path(2), drop_bytes=64)
    steps = []
    for pkg in (jck, ck):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            c = pkg.CheckpointManager(tmp_path, keep_last=5).load()
        assert any("CORRUPT" in str(x.message) for x in rec)
        steps.append(c.step)
    assert steps == [1, 1]


# ---------------------------------------------------------------------------
# trainer parity: a conv + BatchNorm + Dropout + Dense net
# ---------------------------------------------------------------------------

NET_BATCH, NET_STEPS = 4, 6
NET_SGD = {"learning_rate": 1e-2, "momentum": 0.9, "wd": 1e-4}
NET_ADAM = {"learning_rate": 1e-3, "epsilon": 1e-3, "wd": 1e-4}
LOSS_RTOL = 1e-5      # tests/test_torch_sharded_trainer.py
STATE_ATOL_REL = 1e-4


def _net(pkg, name_manager, rate):
    with name_manager():
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Conv2D(4, 3, padding=1, in_channels=3),
                pkg.gluon.nn.BatchNorm(in_channels=4),
                pkg.gluon.nn.Activation("relu"),
                pkg.gluon.nn.Dropout(rate),
                pkg.gluon.nn.Flatten(),
                pkg.gluon.nn.Dense(3, in_units=4 * 6 * 6))
    return net


def _net_data():
    rng = np.random.RandomState(2)
    xs = [rng.randn(NET_BATCH, 3, 6, 6).astype(np.float32)
          for _ in range(NET_STEPS)]
    ys = [rng.randint(0, 3, NET_BATCH).astype(np.float32)
          for _ in range(NET_STEPS)]
    return xs, ys


def _weights():
    net = _net(jmx, JNameManager, 0.0)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(np.zeros((1, 3, 6, 6), np.float32)))
    return {n: p.data().asnumpy() for n, p in net.collect_params().items()}


def _tnet_trainer(weights, opt, rate, seed=0):
    mx.random.seed(seed)
    net = _net(mx, TNameManager, rate)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    mx.convert.load_from_numpy(net, weights)
    loss = gluon.loss.SoftmaxCrossEntropyLoss()
    params = NET_SGD if opt == "sgd" else NET_ADAM
    return parallel.ShardedTrainer(net, lambda o, l: loss(o, l),
                                   optimizer=opt,
                                   optimizer_params=dict(params))


def _jnet_trainer(weights, opt):
    jmx.random.seed(0)
    net = _net(jmx, JNameManager, 0.0)
    net.initialize(jmx.init.Xavier())
    net(jmx.nd.array(np.zeros((1, 3, 6, 6), np.float32)))
    for n, p in net.collect_params().items():
        p.set_data(jmx.nd.array(weights[n]))
    loss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = NET_SGD if opt == "sgd" else NET_ADAM
    return jparallel.ShardedTrainer(net, lambda o, l: loss(o, l),
                                    optimizer=opt,
                                    optimizer_params=dict(params))


def _tstep(tr, x, y):
    return float(tr.step([nd.array(x, ctx=CPU)], nd.array(y, ctx=CPU)))


def _jstep(tr, x, y):
    return float(np.asarray(tr.step([jmx.nd.array(x)], jmx.nd.array(y))))


def _port_state(tr):
    return [_host(t) for t in tr.param_arrays] + \
        [_host(t) for t in tr._opt_leaves(tr.opt_state)]


@pytest.fixture(scope="module")
def weights():
    with jax.default_matmul_precision("float32"):
        return _weights()


@pytest.fixture(autouse=True)
def _f32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_port_trainer_resume_bit_equal_with_dropout(tmp_path, weights, opt):
    xs, ys = _net_data()
    ref = _tnet_trainer(weights, opt, 0.5)
    want = [_tstep(ref, x, y) for x, y in zip(xs, ys)]
    want_state = _port_state(ref)

    tr = _tnet_trainer(weights, opt, 0.5)
    m = ck.CheckpointManager(tmp_path, keep_last=2, async_save=True)
    tr.attach_checkpoint_manager(m, install_signal_handler=False)
    got = [_tstep(tr, x, y) for x, y in zip(xs[:3], ys[:3])]
    tr.save_checkpoint(m)
    m.wait()
    other = {k: v * 0.5 + 0.1 for k, v in weights.items()}
    tr2 = _tnet_trainer(other, opt, 0.5, seed=11)
    m2 = ck.CheckpointManager(tmp_path, keep_last=2)
    assert tr2.attach_checkpoint_manager(
        m2, install_signal_handler=False) == 3
    got += [_tstep(tr2, x, y) for x, y in zip(xs[3:], ys[3:])]
    assert got == want
    for a, b in zip(_port_state(tr2), want_state):
        assert a.tobytes() == b.tobytes()
    assert len(set(want)) == NET_STEPS     # the steps really moved


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_both_packages_resume_from_their_own_checkpoints(tmp_path, weights,
                                                        opt):
    xs, ys = _net_data()
    losses = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        if side == "jax":
            tr = _jnet_trainer(weights, opt)
            m = jck.CheckpointManager(d, async_save=False)
            step = _jstep
        else:
            tr = _tnet_trainer(weights, opt, 0.0)
            m = ck.CheckpointManager(d, async_save=False)
            step = _tstep
        tr.attach_checkpoint_manager(m, install_signal_handler=False)
        out = [step(tr, x, y) for x, y in zip(xs[:3], ys[:3])]
        tr.save_checkpoint(m)
        other = {k: v * 0.0 for k, v in weights.items()}
        if side == "jax":
            tr2 = _jnet_trainer(other, opt)
            m2 = jck.CheckpointManager(d)
        else:
            tr2 = _tnet_trainer(other, opt, 0.0, seed=5)
            m2 = ck.CheckpointManager(d)
        assert tr2.attach_checkpoint_manager(
            m2, install_signal_handler=False) == 3
        out += [step(tr2, x, y) for x, y in zip(xs[3:], ys[3:])]
        losses[side] = out
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_jax_trainer_checkpoint_restores_into_the_port(tmp_path, weights,
                                                       opt, caplog):
    xs, ys = _net_data()
    jtr = _jnet_trainer(weights, opt)
    jm = jck.CheckpointManager(tmp_path, async_save=False)
    for x, y in zip(xs[:3], ys[:3]):
        _jstep(jtr, x, y)
    jtr.save_checkpoint(jm)
    own = _tnet_trainer(weights, opt, 0.0)
    for x, y in zip(xs[:3], ys[:3]):
        _tstep(own, x, y)

    tr = _tnet_trainer(weights, opt, 0.0, seed=9)
    with caplog.at_level(logging.WARNING, logger="mxnet_tpu_torch.parallel"):
        assert tr.attach_checkpoint_manager(
            ck.CheckpointManager(tmp_path),
            install_signal_handler=False) == 3
    assert any("JAX PRNG key" in r.getMessage() for r in caplog.records)
    c = ck.CheckpointManager(tmp_path).load()
    restored = _port_state(tr)
    keys = sorted(k for k in c.arrays if k.startswith("param:")) + \
        sorted(k for k in c.arrays if k.startswith("opt:"))
    assert len(keys) == len(restored)
    n_opt = sum(k.startswith("opt:") for k in keys)
    assert n_opt == {"sgd": 6, "adam": 13}[opt]
    for k, got in zip(keys, restored):
        assert got.tobytes() == np.asarray(c.arrays[k]).tobytes(), k
    # the leaf order: each restored leaf is the port's own leaf of the
    # same meaning after the same steps (m, t and v differ in kind and
    # scale, so a misplaced leaf fails)
    for k, got, mine in zip(keys, restored, _port_state(own)):
        assert got.shape == mine.shape and got.dtype == mine.dtype, k
        bound = STATE_ATOL_REL * max(1e-30, float(np.abs(mine).max())) \
            + 1e-5
        assert float(np.abs(got.astype(np.float64) - mine).max()) <= \
            bound, k
