"""The C ABI behind the unchanged ``cpp/`` headers, driven through the
port: the port's libmxtpu_runtime.so (``native.capi_library()``: its own
copies of mxtpu_predict.cc and mxtpu_api.cc, whose workers are
``mxnet_tpu_torch.predict_worker`` and ``.api_worker``) with the
unchanged clients ``cpp/test_predict.c`` and ``cpp/test_api_train.c``
linked against it (``native.capi_client``), held against the JAX
package's in-process forward on the same exported files: each case of
tests/test_c_predict.py and tests/test_c_api.py, and the no-fallback
rules (no card and no ``MXTPU_PREDICT_CPU``: the worker refuses; a worker
that cannot start: the call fails).

The workers run on the host (``MXTPU_PREDICT_CPU=1`` / ``MXTPU_API_CPU=1``)
with the Executor on ``aot_eager`` (``MXTPU_TEST_JIT_BACKEND``).  The
tests skip only where the JAX ones skip: no native toolchain.  JAX at
``default_matmul_precision("float32")``.  Tolerances: logits rtol 1e-5,
atol 1e-5 (the C client prints six decimals); the worker protocol's raw
f32 outputs and the MLP's printed losses against the JAX package's
library rtol 1e-5, atol 1e-6."""
import ctypes
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import native
from mxnet_tpu_torch.ndarray import legacy_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPP = os.path.join(REPO, "cpp")


@pytest.fixture(autouse=True)
def _precision():
    with jax.default_matmul_precision("float32"):
        yield


def _client(name):
    try:
        return str(native.capi_client(name))
    except RuntimeError as e:
        pytest.skip("native toolchain unavailable: %s" % str(e)[-300:])


def _env(**extra):
    env = dict(os.environ, MXTPU_PYTHON=sys.executable,
               MXTPU_TEST_JIT_BACKEND="aot_eager", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _resnet18_files(tmp_path):
    """tests/test_c_predict.py's model: resnet18_v1 (10 classes, Xavier)
    exported by the JAX package, its input, and its in-process logits."""
    from mxnet_tpu.gluon.model_zoo import vision

    net = vision.resnet18_v1(classes=10)
    net.initialize(jmx.init.Xavier())
    x = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    net(jmx.nd.array(x))
    want = net(jmx.nd.array(x)).asnumpy()[0]
    prefix = str(tmp_path / "rn18")
    net.export(prefix)
    inp = str(tmp_path / "input.f32")
    np.ascontiguousarray(x).tofile(inp)
    return prefix, inp, want


def _parse(stdout):
    lines = dict(ln.split(" ", 1) for ln in stdout.splitlines())
    top1, score = lines["TOP1"].split()
    return int(top1), float(score), [float(v) for v in
                                     lines["LOGITS"].split()]


def test_c_client_classifies_exported_resnet18(tmp_path):
    client = _client("test_predict")
    prefix, inp, want = _resnet18_files(tmp_path)
    r = subprocess.run(
        [client, prefix + "-symbol.json", prefix + "-0000.params", inp,
         "1", "3", "32", "32"], capture_output=True, text=True,
        env=_env(MXTPU_PREDICT_CPU="1"), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    top1, score, logits = _parse(r.stdout)
    assert top1 == int(np.argmax(want))
    np.testing.assert_allclose(score, want.max(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits, want[:3], rtol=1e-5, atol=1e-5)


def test_c_predict_error_reporting(tmp_path):
    """Bad symbol json yields a clean error, not a hang or a crash."""
    client = _client("test_predict")
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as f:
        f.write("{not json")
    params = str(tmp_path / "empty.params")
    legacy_io.save_binary(params, [np.zeros(1, np.float32)], ["arg:w"])
    inp = str(tmp_path / "i.f32")
    np.zeros(3, np.float32).tofile(inp)
    r = subprocess.run([client, bad, params, inp, "1", "3", "1", "1"],
                       capture_output=True, text=True,
                       env=_env(MXTPU_PREDICT_CPU="1"), timeout=120)
    assert r.returncode == 1
    assert "predict worker error" in r.stderr


def test_no_fallback_to_the_host(tmp_path):
    """Without MXTPU_PREDICT_CPU the worker binds on the card; with no
    card it refuses (a CUDA error through the C call), and a worker that
    cannot start fails the call."""
    client = _client("test_predict")
    prefix, inp, _ = _resnet18_files(tmp_path)
    argv = [client, prefix + "-symbol.json", prefix + "-0000.params", inp,
            "1", "3", "32", "32"]
    if not torch.cuda.is_available():
        env = _env()
        env.pop("MXTPU_PREDICT_CPU", None)
        r = subprocess.run(argv, capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode == 1
        assert "predict worker error" in r.stderr
        assert "CUDA is not available" in r.stderr
    r = subprocess.run(argv, capture_output=True, text=True,
                       env=_env(MXTPU_PYTHON=str(tmp_path / "no_python"),
                                MXTPU_PREDICT_CPU="1"), timeout=120)
    assert r.returncode == 1
    assert "create failed" in r.stderr


def test_worker_protocol_reload_params_with_aux(tmp_path):
    """Drive the port's worker over the wire: create, forward, hot-swap
    weights AND aux states (BatchNorm's running stats) by opcode 5; each
    output against the JAX package's in-process forward of the same
    parameters."""
    net = jmx.gluon.nn.HybridSequential()
    net.add(jmx.gluon.nn.Dense(4), jmx.gluon.nn.BatchNorm())
    net.initialize()
    x = np.random.RandomState(5).rand(2, 3).astype(np.float32)
    net(jmx.nd.array(x))
    prefix = str(tmp_path / "m")
    net.export(prefix)
    with open(prefix + "-symbol.json") as f:
        sym_json = f.read().encode()
    loaded = jmx.nd.load(prefix + "-0000.params")
    key = [k for k in loaded if "running_mean" in k][0]
    loaded[key] = jmx.nd.array(loaded[key].asnumpy() + 5.0)
    jmx.nd.save(prefix + "-0001.params", loaded)
    params = [open(prefix + "-%04d.params" % i, "rb").read()
              for i in (0, 1)]

    def jax_forward(i):
        sym = jmx.sym.load(prefix + "-symbol.json")
        p = jmx.nd.load(prefix + "-%04d.params" % i)
        args = {k[4:]: v for k, v in p.items() if k.startswith("arg:")}
        aux = {k[4:]: v for k, v in p.items() if k.startswith("aux:")}
        args["data"] = jmx.nd.array(x)
        ex = sym.bind(jmx.cpu(), args=args, aux_states=aux)
        return ex.forward(is_train=False)[0].asnumpy().ravel()

    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.predict_worker"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=_env(MXTPU_PREDICT_CPU="1"),
        cwd=REPO)

    def rpc(op, payload=b""):
        proc.stdin.write(struct.pack("<BQ", op, len(payload)) + payload)
        proc.stdin.flush()
        status, rlen = struct.unpack("<BQ", proc.stdout.read(9))
        body = proc.stdout.read(rlen) if rlen else b""
        assert status == 0, body
        return body

    try:
        create = struct.pack("<Q", len(sym_json)) + sym_json
        create += struct.pack("<Q", len(params[0])) + params[0]
        create += struct.pack("<I", 1) + struct.pack("<I", 4) + b"data"
        create += struct.pack("<I", 2) + struct.pack("<2I", 2, 3)
        reply = rpc(1, create)
        assert struct.unpack("<III", reply[:12]) == (1, 2, 2)
        rpc(2, struct.pack("<I", 4) + b"data" + x.tobytes())
        rpc(3)
        out1 = np.frombuffer(rpc(4, struct.pack("<I", 0)), np.float32)
        rpc(5, struct.pack("<Q", len(params[1])) + params[1])
        rpc(3)
        out2 = np.frombuffer(rpc(4, struct.pack("<I", 0)), np.float32)
        proc.stdin.write(struct.pack("<BQ", 0, 0))
        proc.stdin.flush()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert not np.allclose(out1, out2), "aux reload had no effect"
    np.testing.assert_allclose(out1, jax_forward(0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out2, jax_forward(1), rtol=1e-5, atol=1e-6)


def _mlp_json(path):
    data = tmx.sym.var("data")
    label = tmx.sym.var("label")
    h = tmx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = tmx.sym.Activation(h, act_type="relu", name="relu1")
    o = tmx.sym.FullyConnected(h, num_hidden=1, name="fc2")
    out = tmx.sym.LinearRegressionOutput(o, label, name="lro")
    with open(path, "w") as f:
        f.write(out.tojson())


def _losses(stdout):
    steps = [float(ln.split("mse=")[1]) for ln in stdout.splitlines()
             if ln.startswith("STEP ")]
    final = [ln for ln in stdout.splitlines()
             if ln.startswith("TRAIN OK")][0]
    return steps, float(final.split("first=")[1].split()[0]), \
        float(final.split("last=")[1])


def test_c_client_trains_mlp_end_to_end(tmp_path):
    """test_api_train through the port's library and api worker: symbol
    load, list-arguments, infer-shape, NDArray create/upload/fetch/
    in-place refresh, executor bind with gradients, forward/backward and
    in-place sgd_update; the loss falls 10x, and every printed loss is
    the JAX package's library's on the same client."""
    client = _client("test_api_train")
    sym_path = str(tmp_path / "mlp-symbol.json")
    _mlp_json(sym_path)
    r = subprocess.run([client, sym_path], capture_output=True, text=True,
                       env=_env(MXTPU_API_CPU="1"), timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert any(ln.startswith("ARGS ") for ln in lines)
    assert any(ln.startswith("INFER n_args=6 n_outs=1") for ln in lines)
    steps, first, last = _losses(r.stdout)
    assert last < first / 10.0
    # the same client on the JAX package's C ABI (cpp/'s sources, whose
    # worker is mxnet_tpu.api_worker), built into tmp_path, not cpp/
    jdir = tmp_path / "jax_capi"
    jdir.mkdir()
    for cmd in (["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", "-I", CPP,
                 os.path.join(CPP, "mxtpu_predict.cc"),
                 os.path.join(CPP, "mxtpu_api.cc"), "-o",
                 str(jdir / "libmxtpu_runtime.so"), "-shared", "-lpthread"],
                ["gcc", "-O2", "-Wall", "-I", CPP,
                 os.path.join(CPP, "test_api_train.c"), "-o",
                 str(jdir / "test_api_train"), "-L", str(jdir),
                 "-lmxtpu_runtime", "-Wl,-rpath,$ORIGIN"]):
        b = subprocess.run(cmd, capture_output=True, text=True)
        if b.returncode != 0:
            pytest.skip("native toolchain unavailable: %s"
                        % b.stderr[-300:])
    j = subprocess.run([str(jdir / "test_api_train"), sym_path],
                       capture_output=True, text=True,
                       env=_env(MXTPU_API_CPU="1"), timeout=600)
    assert j.returncode == 0, j.stdout + j.stderr
    jsteps, jfirst, jlast = _losses(j.stdout)
    np.testing.assert_allclose(steps + [first, last],
                               jsteps + [jfirst, jlast], rtol=1e-5,
                               atol=1e-6)


def test_list_arguments_zero_arg_symbol():
    """A symbol with no arguments lists cleanly, and cap == 0 fails
    without writing (tests/test_c_api.py's case, on the port's
    library)."""
    lib = ctypes.CDLL(str(_client("test_api_train").rsplit("/", 1)[0]
                          + "/libmxtpu_runtime.so"))
    lib.MXTPUSessionCreate.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
    lib.MXTPUSessionFree.argtypes = [ctypes.c_void_p]
    lib.MXTPUSymbolFromJSON.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64)]
    lib.MXTPUSymbolListArguments.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t]
    lib.mxtpu_api_last_error.restype = ctypes.c_char_p
    saved = {k: os.environ.get(k) for k in ("MXTPU_PYTHON", "MXTPU_API_CPU",
                                            "PYTHONPATH")}
    os.environ.update(MXTPU_PYTHON=sys.executable, MXTPU_API_CPU="1",
                      PYTHONPATH=_env()["PYTHONPATH"])
    sess = ctypes.c_void_p()
    try:
        assert lib.MXTPUSessionCreate(ctypes.byref(sess)) == 0, \
            lib.mxtpu_api_last_error()
        sym = tmx.sym.zeros((2, 2))
        assert sym.list_arguments() == []
        h = ctypes.c_uint64()
        assert lib.MXTPUSymbolFromJSON(
            sess, sym.tojson().encode(), ctypes.byref(h)) == 0, \
            lib.mxtpu_api_last_error()
        buf = ctypes.create_string_buffer(16)
        assert lib.MXTPUSymbolListArguments(sess, h.value, buf, 16) == 0, \
            lib.mxtpu_api_last_error()
        assert buf.value == b""
        assert lib.MXTPUSymbolListArguments(sess, h.value, buf, 0) == -1
    finally:
        lib.MXTPUSessionFree(sess)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
