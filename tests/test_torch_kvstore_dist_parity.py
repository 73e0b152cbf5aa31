"""The port's parameter server held to the JAX package's
(mxnet_tpu/kvstore_server.py, kvstore.KVStoreDist) on the same seeded
numpy inputs: sync sums over push/pull and push_batch/pull_batch (bit for
bit with 2 workers; exactly representable values with 3, as an f32 sum of
3 or more follows the order the pushes arrive in), the server-side SGD,
2-bit compression on the workers with the residual carried over, and a
Trainer and Module.fit on two worker processes of each package.

Servers run in threads of this process on sockets already listening;
workers are threads, or processes joined with a timeout that fails the
test."""
import json
import os
import pickle
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import kvstore_server as jps
from mxnet_tpu.contrib.compression import GradientCompression as JaxGC
from mxnet_tpu_torch import kvstore as kvs
from mxnet_tpu_torch import kvstore_server as tps

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 60
PKGS = {"jax": jps, "port": tps}


def _server(ps, n, sync=True):
    srv = ps.KVServer("127.0.0.1", 0, n, sync_mode=sync)
    threading.Thread(target=srv.serve, daemon=True).start()
    return srv, srv._sock.getsockname()[1]


def _run_all(fns):
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


def _rounds(ps, n, values, api, optimizer=None):
    """Each of ``n`` workers pushes values[r][round] ({key: array}) a round
    and pulls every key after it; returns each worker's pulls."""
    srv, port = _server(ps, n)
    cs = [ps.WorkerClient("127.0.0.1", port, rank=r, num_workers=n)
          for r in range(n)]
    if optimizer is not None:
        cs[0].set_optimizer(pickle.dumps(optimizer))
    for rnd in values[0]:
        for k, v in rnd.items():
            cs[0].init(k, np.zeros_like(v))

    def worker(r):
        pulls = []
        for rnd in values[r]:
            keys = sorted(rnd)
            if api == "push":
                for k in keys:
                    cs[r].push(k, rnd[k])
                pulls.append([cs[r].pull(k) for k in keys])
            else:
                cs[r].push_batch([(k, rnd[k]) for k in keys])
                pulls.append(cs[r].pull_batch(keys))
        return pulls

    out = _run_all([lambda r=r: worker(r) for r in range(n)])
    for c in cs:
        c._sock.close()
    srv._sock.close()
    return out


def _values(n, rounds, integer, seed=0, fresh_keys=False):
    """values[worker][round] = {key: array}; with ``fresh_keys`` each round
    pushes keys of its own."""
    rng = np.random.RandomState(seed)
    shapes = {"0": (3, 5), "1": (7,), "w": (2, 2, 3)}

    def draw(shape):
        if integer:   # sums of these are exact in f32 in any order
            return rng.randint(-64, 64, shape).astype(np.float32) / 8
        return rng.randn(*shape).astype(np.float32)

    return [[{(k + "_%d" % rnd if fresh_keys else k): draw(s)
              for k, s in shapes.items()} for rnd in range(rounds)]
            for _ in range(n)]


@pytest.mark.parametrize("api", ["push", "push_batch"])
@pytest.mark.parametrize("n", [2, 3])
def test_sync_sums_match_jax(api, n):
    """No optimizer: 3 rounds, each over keys of its own initialised to 0
    (the JAX server adds a sum to the stored value where the port assigns
    it, caveat 1; from 0 the two agree): every pull is the round's sum,
    bit for bit the JAX package's and numpy's."""
    values = _values(n, 3, integer=(n > 2), fresh_keys=True)
    got = {name: _rounds(ps, n, values, api) for name, ps in PKGS.items()}
    for r in range(n):
        for rnd in range(3):
            for j, k in enumerate(sorted(values[0][rnd])):
                want = values[0][rnd][k]
                for w in range(1, n):
                    want = want + values[w][rnd][k]
                port = got["port"][r][rnd][j]
                jax = np.asarray(got["jax"][r][rnd][j])
                assert port.dtype == jax.dtype == np.float32
                assert port.tobytes() == jax.tobytes() == want.tobytes()


def test_server_sgd_matches_jax():
    """The server's SGD (momentum 0.9, wd 1e-4) on 2 workers' sums, 3
    rounds: the port's weights within 1e-6 relative of the JAX
    package's."""
    values = _values(2, 3, integer=False, seed=1)
    kw = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
          "rescale_grad": 0.5}
    jax = _rounds(jps, 2, values, "push_batch", jmx.optimizer.SGD(**kw))
    port = _rounds(tps, 2, values, "push_batch", mx.optimizer.SGD(**kw))
    for r in range(2):
        for rnd in range(3):
            for a, b in zip(port[r][rnd], jax[r][rnd]):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        assert [p.tobytes() for p in port[r][-1]] == \
            [p.tobytes() for p in port[0][-1]]
    assert np.abs(port[0][-1][0]).max() > 0.05


def test_compression_matches_jax():
    """2-bit compression on each worker's push (threshold 0.5), 3 rounds
    with the residual carried over: the port's pulls are bit for bit the
    sum of the JAX package's GradientCompression.compress_dequantize
    outputs, one compressor a worker."""
    values = _values(2, 3, integer=False, seed=2)
    keys = sorted(values[0][0])
    srv, port = _server(tps, 2)
    stores = [kvs.KVStoreDist("dist_sync", client=tps.WorkerClient(
        "127.0.0.1", port, rank=r, num_workers=2)) for r in range(2)]

    def worker(kv):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        kv.init(keys, [mx.nd.zeros(values[0][0][k].shape, ctx=mx.cpu())
                       for k in keys])
        pulls = []
        for rnd in values[kv.rank]:
            kv.push(keys, [mx.nd.array(rnd[k], ctx=mx.cpu()) for k in keys])
            outs = [mx.nd.zeros(rnd[k].shape, ctx=mx.cpu()) for k in keys]
            kv.pull(keys, out=outs)
            pulls.append([o.asnumpy() for o in outs])
        kv.close()
        return pulls

    got = _run_all([lambda kv=kv: worker(kv) for kv in stores])
    srv._sock.close()
    gcs = [JaxGC(type="2bit", threshold=0.5) for _ in range(2)]
    for rnd in range(3):
        for j, k in enumerate(keys):
            deq = [np.asarray(gcs[w].compress_dequantize(
                k, jmx.nd.array(values[w][rnd][k])).asnumpy(), np.float32)
                for w in range(2)]
            want = deq[0] + deq[1]
            assert set(np.unique(want)) <= {-1.0, -0.5, 0.0, 0.5, 1.0}
            for r in range(2):
                assert got[r][rnd][j].tobytes() == want.tobytes(), (rnd, k)


# --- a Trainer and Module.fit, two worker processes of each package ----

_WORKER = r"""
import json, os, sys
import numpy as np
pkg = sys.argv[1]
if pkg == "jax":
    import mxnet_tpu as mx
    kw = {}
else:
    import mxnet_tpu_torch as mx
    mx.jit._BACKEND = "aot_eager"   # Module's executor compiles
    kw = {"ctx": mx.cpu()}
ports, out_dir = sys.argv[2].split(","), sys.argv[3]
rank = int(os.environ["DMLC_WORKER_RANK"])
w = np.load(os.path.join(out_dir, "weights.npz"))
rng = np.random.RandomState(10 + rank)
x = rng.randn(12, 8).astype(np.float32)
y = rng.randint(0, 4, 12).astype(np.float32)
opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
# the JAX server's optimizer keeps rescale_grad 1.0 (caveat 2), so the JAX
# Trainer's step(4) is the port's step(1)
STEP_ARG = {"jax": 4, "port": 1}[pkg]

os.environ["DMLC_PS_ROOT_PORT"] = ports[0]
net = mx.gluon.nn.Sequential()
net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=8),
        mx.gluon.nn.Dense(4, in_units=16))
net.initialize(**kw)
params = list(net.collect_params().values())
for p, name in zip(params, ["w1", "b1", "w2", "b2"]):
    p.set_data(mx.nd.array(w[name], **kw))
trainer = mx.gluon.Trainer(net.collect_params(), "sgd", opt,
                           kvstore="dist_sync")
loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
for i in range(3):
    with mx.autograd.record():
        loss = loss_fn(net(mx.nd.array(x[4 * i:4 * i + 4], **kw)),
                       mx.nd.array(y[4 * i:4 * i + 4], **kw))
    loss.backward()
    trainer.step(STEP_ARG)
res = {"trainer_" + n: p.data().asnumpy()
       for n, p in zip(["w1", "b1", "w2", "b2"], params)}

os.environ["DMLC_PS_ROOT_PORT"] = ports[1]
data = mx.sym.var("data")
h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=16, name="fc1"),
                      act_type="relu")
sym = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(h, num_hidden=4, name="fc2"),
                           name="softmax")
mod = mx.mod.Module(sym, context=mx.cpu())
it = mx.io.NDArrayIter(mx.nd.array(x, **kw), mx.nd.array(y, **kw),
                       batch_size=4)
args = {"fc1_weight": w["w1"], "fc1_bias": w["b1"], "fc2_weight": w["w2"],
        "fc2_bias": w["b2"]}
mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
        optimizer_params=opt,
        arg_params={k: mx.nd.array(v, **kw) for k, v in args.items()})
arg, _aux = mod.get_params()
res.update({"module_" + k: v.asnumpy() for k, v in arg.items()})
np.savez(os.path.join(out_dir, "%s_%d.npz" % (pkg, rank)), **res)
print("DONE", pkg, rank)
"""


def _spawn(pkg, ports, out_dir, rank):
    env = dict(os.environ, DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_NUM_WORKER="2", DMLC_WORKER_RANK=str(rank),
               DMLC_RANK=str(rank), JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", _WORKER, pkg, ",".join(map(str, ports)),
         out_dir], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each package's 2 workers (processes), each running a Trainer (3
    steps of batch 4) against one server and Module.fit (one epoch of 3
    batches of 4) against another; their final parameters by name."""
    out_dir = str(tmp_path_factory.mktemp("dist_parity"))
    rng = np.random.RandomState(0)
    np.savez(os.path.join(out_dir, "weights.npz"),
             w1=rng.randn(16, 8).astype(np.float32) * 0.3,
             b1=rng.randn(16).astype(np.float32) * 0.1,
             w2=rng.randn(4, 16).astype(np.float32) * 0.3,
             b2=rng.randn(4).astype(np.float32) * 0.1)
    servers, procs = {}, []
    for pkg, ps in PKGS.items():
        servers[pkg] = [_server(ps, 2) for _ in range(2)]
        ports = [port for _srv, port in servers[pkg]]
        procs += [(pkg, _spawn(pkg, ports, out_dir, r)) for r in range(2)]
    errs = []
    for pkg, p in procs:
        try:
            _out, err = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for _pkg, q in procs:
                q.kill()
            pytest.fail("a %s worker did not finish in 150 s" % pkg)
        if p.returncode:
            errs.append("%s worker: %s" % (pkg, err[-3000:]))
    for pkg in servers:
        for srv, _port in servers[pkg]:
            srv._sock.close()
    assert not errs, "\n".join(errs)
    rescale = {pkg: [srv._optimizer.rescale_grad for srv, _ in servers[pkg]]
               for pkg in servers}
    return ({(pkg, r): dict(np.load(os.path.join(out_dir, "%s_%d.npz"
                                                 % (pkg, r))))
             for pkg in PKGS for r in range(2)}, rescale)


@pytest.mark.parametrize("path", ["trainer", "module"])
def test_two_workers_match_jax(trained, path):
    """After 3 updates each worker's parameters are within 1e-5 relative
    of the JAX package's, and the two workers agree bit for bit."""
    res, rescale = trained
    names = sorted(k for k in res["port", 0] if k.startswith(path))
    assert len(names) == 4
    for name in names:
        want = res["jax", 0][name]
        for r in range(2):
            got = res["port", r][name]
            assert got.tobytes() == res["port", 0][name].tobytes()
            err = np.abs(got - want).max() / np.abs(want).max()
            assert err <= 1e-5, (name, r, err)
        moved = np.abs(res["port", 0][name] - _initial(name)).max()
        assert moved > 1e-3 * np.abs(want).max(), name
    # the factor of caveat 2: Trainer's step(1) in the port against the
    # JAX Trainer's step(4); Module sets 1 / (4 x 2 workers) in both
    if path == "trainer":
        assert rescale["port"][0] == rescale["jax"][0] == 1.0
    else:
        assert rescale["port"][1] == rescale["jax"][1] == 1 / 8


def _initial(name):
    rng = np.random.RandomState(0)
    w = {"w1": rng.randn(16, 8).astype(np.float32) * 0.3,
         "b1": rng.randn(16).astype(np.float32) * 0.1,
         "w2": rng.randn(4, 16).astype(np.float32) * 0.3,
         "b2": rng.randn(4).astype(np.float32) * 0.1}
    short = {"fc1_weight": "w1", "fc1_bias": "b1", "fc2_weight": "w2",
             "fc2_bias": "b2"}
    key = name.split("_", 1)[1]
    return w[short.get(key, key)]
