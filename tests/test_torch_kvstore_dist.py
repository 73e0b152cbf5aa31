"""The port's parameter-server path on its own (mxnet_tpu_torch.
kvstore_server, kvstore.KVStoreDist, tools.launch): its versions of
tests/test_kvstore.py:168-380 (a dead worker, no retry that succeeds by
counting a survivor twice, async pushes applied at once, the server's
profiler commands, a push order that diverges), the store's methods, the
launcher on the CPU, and the two reference caveats the port does not copy.

Servers run in threads of this process on a socket that is already
listening (port 0), so no test waits for a server to start; every thread
and process is joined with a timeout that fails the test.
"""
import os
import pickle
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kvstore as kvs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore_server import KVServer, WorkerClient

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 30


def _server(n, sync=True):
    srv = KVServer("127.0.0.1", 0, n, sync_mode=sync)
    threading.Thread(target=srv.serve, daemon=True).start()
    return srv


def _clients(srv, n):
    return [WorkerClient("127.0.0.1", srv.port, rank=r, num_workers=n)
            for r in range(n)]


def _run_all(fns):
    """Run each fn in its own thread; returns their results, or raises the
    first error; a thread still running after JOIN_S fails the test."""
    out, errs = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i, f)) for i, f in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in ts), "a worker thread hung"
    if errs:
        raise errs[0]
    return out


def _cpu(a):
    return mx.nd.array(np.asarray(a, np.float32), ctx=mx.cpu())


def test_dead_worker_detection():
    """A worker dying mid-round gives its peer the server's error, not a
    hang (reference kvstore_dist.h node-failure handling)."""
    srv = _server(2)
    w0, w1 = _clients(srv, 2)
    w0.init("k", np.zeros(4, np.float32))
    errs = []

    def pusher():
        try:
            w0.push("k", np.ones(4, np.float32))
        except MXNetError as e:
            errs.append(str(e))

    t = threading.Thread(target=pusher)
    t.start()
    time.sleep(0.2)          # w0 now waits for w1's value
    w1.close()               # w1 dies without shutdown
    t.join(timeout=JOIN_S)
    assert not t.is_alive(), "push hung instead of failing"
    assert errs and "dead rank" in errs[0]
    assert w0.health() == [1]
    w0.close()
    srv.close()


def test_dead_worker_no_spurious_retry_success():
    """After a failure every retried round fails too, and the store never
    moves: the survivor's value is never counted twice."""
    srv = _server(2)
    w0, w1 = _clients(srv, 2)
    w0.init("k", np.zeros(2, np.float32))
    first = []

    def push_once():
        try:
            w0.push("k", np.ones(2, np.float32))
        except MXNetError as e:
            first.append(str(e))

    t = threading.Thread(target=push_once)
    t.start()
    time.sleep(0.2)
    w1.close()
    t.join(timeout=JOIN_S)
    assert first
    for _ in range(2):
        with pytest.raises(MXNetError):
            w0.push("k", np.ones(2, np.float32))
        with pytest.raises(MXNetError):
            w0.barrier()
    np.testing.assert_array_equal(w0.pull("k"), np.zeros(2, np.float32))
    w0.close()
    srv.close()


def test_async_mode_applies_immediately():
    """dist_async: each push runs the server's optimizer at once, without
    the other workers' values (upstream's async server needs an updater;
    here sgd at lr 1, so w -= g)."""
    srv = _server(2, sync=False)
    w0, w1 = _clients(srv, 2)
    w0.set_optimizer(pickle.dumps(mx.optimizer.SGD(learning_rate=1.0)))
    w0.init("3", np.zeros(3, np.float32))
    w0.push("3", np.ones(3, np.float32))
    w0.push("3", np.ones(3, np.float32))
    np.testing.assert_array_equal(w0.pull("3"), np.full(3, -2.0))
    w1.push("3", np.full(3, 5.0, np.float32))
    np.testing.assert_array_equal(w1.pull("3"), np.full(3, -7.0))
    # a sync server applies an explicitly async push at once too
    srv2 = _server(2)
    a, _b = _clients(srv2, 2)
    a.init("k", np.zeros(2, np.float32))
    a.push("k", np.full(2, 4.0, np.float32), sync=False)
    np.testing.assert_array_equal(a.pull("k"), np.full(2, 4.0))
    for c in (w0, w1, a, _b):
        c.close()
    srv.close()
    srv2.close()


def test_server_profiler_commands(tmp_path):
    """Worker-controlled server profiling through the store (reference
    tests/nightly/test_server_profiling.py): config, on, work, dump."""
    srv = _server(2)
    dump = str(tmp_path / "server_profile.json")
    stores = [kvs.KVStoreDist("dist_sync", client=c)
              for c in _clients(srv, 2)]

    def worker(kv):
        kv.init("w", _cpu(np.zeros((2, 2))))
        if kv.rank == 0:
            kv.send_command_to_servers("profiler_set_config", dump)
            kv.send_command_to_servers("profiler_state", "1")
        kv.barrier()
        kv.push("w", _cpu(np.ones((2, 2))))
        kv.barrier()
        if kv.rank == 0:
            kv.send_command_to_servers("profiler_pause", "1")
        kv.barrier()
        kv.push("w", _cpu(np.ones((2, 2))))   # paused: not counted
        kv.barrier()
        if kv.rank == 0:
            kv.send_command_to_servers("profiler_dump", "")
        kv.close()

    _run_all([lambda kv=kv: worker(kv) for kv in stores])
    import json

    stats = json.load(open(dump))
    assert stats["push"][0] == 2, stats
    assert stats["push"][1] > 0
    srv.close()


def test_push_order_divergence_fails_fast():
    """Workers pushing different key orders in sync mode get an error at
    once instead of waiting out the round timeout; a consistent retry
    then succeeds."""
    srv = _server(2)
    w0, w1 = _clients(srv, 2)
    w0.init("a", np.zeros(2, np.float32))
    w0.init("b", np.zeros(2, np.float32))
    errs = {}

    def push_seq(name, client, keys):
        try:
            client.push_batch([(k, np.ones(2, np.float32)) for k in keys])
            errs[name] = None
        except MXNetError as e:
            errs[name] = str(e)

    t0 = time.monotonic()
    _run_all([lambda: push_seq("w0", w0, ["a", "b"]),
              lambda: push_seq("w1", w1, ["b", "a"])])
    assert time.monotonic() - t0 < 20
    assert "divergence" in (errs["w0"] or "") and \
        "divergence" in (errs["w1"] or ""), errs
    np.testing.assert_array_equal(w0.pull("a"), np.zeros(2, np.float32))
    np.testing.assert_array_equal(w0.pull("b"), np.zeros(2, np.float32))
    _run_all([lambda: push_seq("w0", w0, ["a", "b"]),
              lambda: push_seq("w1", w1, ["a", "b"])])
    assert errs == {"w0": None, "w1": None}
    # no updater: the sum is assigned (caveat 1)
    np.testing.assert_array_equal(w0.pull("a"), np.full(2, 2.0))
    w0.close()
    w1.close()
    srv.close()


def test_many_workers_stress():
    """12 worker threads (more than this machine's cores) with a short
    switch interval, 20 sync rounds of 3 keys each: every pull is the
    exact sum of the round (integers), so a lost or doubled value in the
    server's shared round state would show."""
    n, rounds = 12, 20
    srv = _server(n)
    cs = _clients(srv, n)
    keys = ["a", "b", "c"]
    for k in keys:
        cs[0].init(k, np.zeros(5, np.float32))

    def worker(r):
        bad = []
        for i in range(rounds):
            cs[r].push_batch([(k, np.full(5, r + i + j, np.float32))
                              for j, k in enumerate(keys)])
            got = cs[r].pull_batch(keys)
            for j, v in enumerate(got):
                want = sum(w + i + j for w in range(n))
                if not (v == want).all():
                    bad.append((i, j, v[0], want))
        return bad

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        bad = _run_all([lambda r=r: worker(r) for r in range(n)])
    finally:
        sys.setswitchinterval(old)
    assert bad == [[]] * n
    for c in cs:
        c.close()
    srv.close()


def test_connection_past_num_workers_is_refused():
    srv = _server(1)
    (w0,) = _clients(srv, 1)
    with pytest.raises(MXNetError, match="all 1 workers are connected"):
        WorkerClient("127.0.0.1", srv.port, rank=1, num_workers=1)
    w0.close()
    srv.close()


@pytest.mark.parametrize("name,sync", [("dist_sync", True),
                                       ("dist_device_sync", True),
                                       ("dist_async", False)])
def test_create_returns_dist_store(monkeypatch, name, sync):
    srv = _server(1, sync=sync)
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", str(srv.port))
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_WORKER_RANK", "0")
    kv = kvs.create(name)
    assert isinstance(kv, kvs.KVStoreDist) and kv.type == name
    assert kv._sync is sync and (kv.rank, kv.num_workers) == (0, 1)
    kv.close()
    srv.close()


def test_create_dist_without_server_is_local(monkeypatch):
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    kv = kvs.create("dist_sync")
    assert type(kv) is kvs.KVStore and kv.num_workers == 1


def _local_and_dist():
    """A local store and a one-worker dist store."""
    srv = _server(1)
    return srv, [kvs.create("local"),
                 kvs.KVStoreDist("dist_sync", client=_clients(srv, 1)[0])]


def test_pushpull_row_sparse_pull_barrier():
    """pushpull, row_sparse_pull into a dense out and barrier on both
    stores (mxnet_tpu/kvstore.py:150-213); pull writes in place."""
    srv, stores = _local_and_dist()
    w = np.arange(12, dtype=np.float32).reshape(6, 2)
    for kv in stores:
        kv.init("w", _cpu(w))
        out = _cpu(np.zeros((6, 2)))
        storage = out._data.data_ptr()
        kv.pushpull("w", _cpu(w * 3), out=out)
        np.testing.assert_array_equal(out.asnumpy(), w * 3)   # assigned
        assert out._data.data_ptr() == storage
        rsp = _cpu(np.full((6, 2), 9.0))
        kv.row_sparse_pull("w", out=rsp, row_ids=_cpu([4, 1, 4]))
        want = np.zeros_like(w)
        want[[1, 4]] = w[[1, 4]] * 3
        np.testing.assert_array_equal(rsp.asnumpy(), want)
        kv.barrier()
        seen = []
        kv._set_updater(lambda k, g, s: seen.append(k))
        assert kv._updater is not None
        kv.send_command_to_servers("anything", "")
    stores[1].close()
    srv.close()


def test_optimizer_pickle_refuses_a_device_tensor():
    """The optimizer goes to the server as a pickle with no tensor off the
    CPU: a Trainer's parameters stay out (param_dict), and any other
    tensor that is not on the CPU is refused before it is sent."""
    srv = _server(1)
    kv = kvs.KVStoreDist("dist_sync", client=_clients(srv, 1)[0])
    net = mx.gluon.nn.Dense(3, in_units=2)
    net.initialize(ctx=mx.cpu())
    sched = mx.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "lr_scheduler": sched},
                               kvstore=kv)
    trainer._prepare_states()
    assert srv._optimizer.param_dict == {} and srv._optimizer.lr == 0.1
    assert srv._optimizer.lr_scheduler.factor == 0.5
    bad = mx.optimizer.SGD(learning_rate=0.1)
    bad.extra = torch.zeros(2, device="meta")
    with pytest.raises(MXNetError, match="parameter server runs on the host"):
        kv.set_optimizer(bad)
    kv.close()
    srv.close()


def test_caveat_push_without_updater_assigns():
    """Caveat 1: with no optimizer on the server, a sync round ASSIGNS the
    sum, as upstream's server does (CopyFromTo(merged, &stored)); the JAX
    server adds it to the stored value (mxnet_tpu/kvstore_server.py:111),
    so a Trainer with update_on_kvstore=False would pull weights plus
    gradients there."""
    from mxnet_tpu.kvstore_server import KVServer as JaxServer, \
        WorkerClient as JaxClient

    got = {}
    for name, server_cls, client_cls in (("port", KVServer, WorkerClient),
                                         ("jax", JaxServer, JaxClient)):
        srv = server_cls("127.0.0.1", 0, 2)
        port = srv._sock.getsockname()[1]
        threading.Thread(target=srv.serve, daemon=True).start()
        cs = [client_cls("127.0.0.1", port, rank=r, num_workers=2)
              for r in range(2)]
        cs[0].init("k", np.full(2, 10.0, np.float32))
        pulls = []
        for _ in range(2):
            _run_all([lambda c=c: c.push("k", np.full(2, c.rank + 1.0,
                                                      np.float32))
                      for c in cs])
            pulls.append(cs[0].pull("k")[0])
        got[name] = pulls
        for c in cs:
            c._sock.close()
        srv._sock.close()
    assert got["port"] == [3.0, 3.0]
    assert got["jax"] == [13.0, 16.0]


def test_caveat_server_optimizer_is_rescaled(monkeypatch):
    """Caveat 2: Trainer.step sets rescale_grad = 1 / batch_size before it
    creates the store (upstream 1.5's _check_and_rescale_grad), so the
    server's optimizer holds 1/8 at batch 8 and the update is lr x the
    batch mean.  The JAX Trainer pickles the optimizer first
    (mxnet_tpu/gluon/trainer.py:117-121): its server keeps rescale_grad
    1.0 and steps by lr x the batch sum, 8x as far."""
    import mxnet_tpu as jmx
    from mxnet_tpu.kvstore_server import KVServer as JaxServer

    rng = np.random.RandomState(0)
    w0 = rng.randn(2, 3).astype(np.float32)
    x = rng.randn(8, 3).astype(np.float32)
    grad = np.ones((8, 2), np.float32).T @ x      # d sum(x @ w.T) / dw
    res = {}
    for name, pkg, server_cls in (("port", mx, KVServer),
                                  ("jax", jmx, JaxServer)):
        srv = server_cls("127.0.0.1", 0, 1)
        threading.Thread(target=srv.serve, daemon=True).start()
        monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
        monkeypatch.setenv("DMLC_PS_ROOT_PORT",
                           str(srv._sock.getsockname()[1]))
        monkeypatch.setenv("DMLC_NUM_WORKER", "1")
        monkeypatch.setenv("DMLC_WORKER_RANK", "0")
        net = pkg.gluon.nn.Dense(2, in_units=3, use_bias=False)
        kw = {"ctx": pkg.cpu()}
        net.initialize(**kw)
        net.weight.set_data(pkg.nd.array(w0, **kw))
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1},
                                    kvstore="dist_sync")
        with pkg.autograd.record():
            loss = net(pkg.nd.array(x, **kw)).sum()
        loss.backward()
        trainer.step(8)
        res[name] = (srv._optimizer.rescale_grad,
                     net.weight.data().asnumpy())
        trainer._kvstore._client._sock.close()
        srv._sock.close()
    assert res["port"][0] == pytest.approx(1 / 8)
    assert res["jax"][0] == 1.0
    np.testing.assert_allclose(res["port"][1], w0 - 0.1 * grad / 8,
                               rtol=1e-6)
    np.testing.assert_allclose(res["jax"][1], w0 - 0.1 * grad, rtol=1e-6)


def test_trainer_warns_when_batch_size_changes():
    srv = _server(1)
    kv = kvs.KVStoreDist("dist_sync", client=_clients(srv, 1)[0])
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=kv)
    x = _cpu(np.ones((4, 3)))
    for bs, warns in ((4, False), (4, False), (2, True)):
        with mx.autograd.record():
            loss = net(x).sum()
        loss.backward()
        if warns:
            with pytest.warns(UserWarning, match="batch size changed"):
                trainer.step(bs)
        else:
            trainer.step(bs)
    kv.close()
    srv.close()


def _session_alive(sid):
    """Pids of live (not zombie) processes in session ``sid``."""
    alive = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            stat = (d / "stat").read_text()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        if int(fields[3]) == sid and fields[0] != "Z":
            alive.append(int(d.name))
    return alive


def _launch(n, command, timeout):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n", str(n),
         "--launcher", "local"] + command, cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        pytest.fail("the launcher did not finish in %d s" % timeout)
    deadline = time.monotonic() + 10
    while _session_alive(proc.pid) and time.monotonic() < deadline:
        time.sleep(0.1)
    left = _session_alive(proc.pid)
    if left:
        os.killpg(proc.pid, 9)
    return proc.returncode, out, err, left


_TRAIN = r"""
import json, os
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.examples import train_imagenet
mx.random.seed(int(os.environ["DMLC_WORKER_RANK"]))   # weights differ
res = train_imagenet.train(
    ["--kv-store", "dist_sync", "--benchmark", "1", "--network",
     "resnet18_v1", "--num-classes", "10", "--image-shape", "3,32,32",
     "--batch-size", "4", "--steps", "2", "--lr", "0.05"],
    ctx=mx.cpu(), hybridize=False)
params = [p.data().asnumpy() for p in res["net"].collect_params().values()
          if p.grad_req != "null"]
import hashlib
h = hashlib.sha1(b"".join(p.tobytes() for p in params)).hexdigest()
kv = res["trainer"]._kvstore
print("RESULT", json.dumps({"rank": kv.rank, "type": type(kv).__name__,
                            "losses": res["losses"].tolist(), "sha": h}))
kv.close()
"""


def test_launcher_trains_resnet18_on_two_workers():
    """train_imagenet --kv-store dist_sync under the port's launcher on the
    CPU: both workers finish, start from rank 0's weights (their own
    seeds differ) and end with the same parameters."""
    rc, out, err, left = _launch(2, [sys.executable, "-c", _TRAIN], 240)
    assert rc == 0, err[-3000:]
    assert left == []
    import json

    res = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
           if line.startswith("RESULT ")]
    assert sorted(r["rank"] for r in res) == [0, 1]
    assert all(r["type"] == "KVStoreDist" for r in res)
    assert res[0]["sha"] == res[1]["sha"]
    # the first forward runs on each worker's own weights; from the first
    # pull on, both hold the server's
    assert res[0]["losses"][0] != res[1]["losses"][0]
    assert res[0]["losses"][1:] == res[1]["losses"][1:]
    assert all(np.isfinite(r["losses"]).all() for r in res)


_FAIL = r"""
import os, sys, time
if os.environ["DMLC_WORKER_RANK"] == "1":
    sys.exit(3)
time.sleep(600)
"""


def test_launcher_failing_worker_stops_everything():
    """A worker that exits 3 makes the launcher exit 3 at once, and no
    process of the job (server, the other worker) is left behind."""
    t0 = time.monotonic()
    rc, _out, err, left = _launch(2, [sys.executable, "-c", _FAIL], 60)
    assert rc == 3, err[-2000:]
    assert time.monotonic() - t0 < 40
    assert left == []
