"""The port's persistent compile cache (``config.enable_compile_cache``),
on CPU with inductor.

Two fresh processes compile the same hybridized block (a Dense/tanh/
Dense MLP, inference) with inductor, sharing one
``MXNET_COMPILE_CACHE_DIR``: the first misses and fills the directory,
the second reports ``COMPILE_CACHE_HITS`` >= 1 and no miss (telemetry
and ``jit.Compiled``'s own counts) and returns bit-equal outputs.  A
third process with ``MXNET_COMPILE_CACHE=0`` writes nothing into its
directory.  The caches are inductor's FX-graph cache and AOTAutograd's
cache; inductor reads its directory from the environment at first use,
so each case needs a process of its own (the tests' ``aot_eager``
backend has no FX-graph cache).
"""
import json
import os
import subprocess
import sys

import numpy as np

import mxnet_tpu_torch as tmx

_CHILD = r"""
import json, sys
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon import nn

telemetry.enable()
net = nn.HybridSequential()
net.add(nn.Dense(16, in_units=8, activation="tanh"), nn.Dense(4, in_units=16))
net.initialize(mx.init.Xavier(), ctx=mx.cpu())
rng = np.random.RandomState(0)
for p in net.collect_params().values():
    p.set_data(mx.nd.array(rng.randn(*p.shape).astype(np.float32) * 0.3,
                           ctx=mx.cpu()))
net.hybridize()
x = mx.nd.array(rng.randn(5, 8).astype(np.float32), ctx=mx.cpu())
out = net(x).asnumpy()
op = net._cached_op._compiled
print(json.dumps({
    "out": out.tolist(),
    "hits": op.cache_hits, "misses": op.cache_misses,
    "counts": op.cache_counts,
    "telemetry_hits": telemetry.COMPILE_CACHE_HITS.value(),
    "telemetry_misses": telemetry.COMPILE_CACHE_MISSES.value(),
    "dir": mx.config.get("MXNET_COMPILE_CACHE_DIR")}))
"""


def _child(cache_dir, on=True):
    env = dict(os.environ)
    env["MXNET_COMPILE_CACHE_DIR"] = str(cache_dir)
    env["MXNET_COMPILE_CACHE"] = "1" if on else "0"
    env.pop("TORCHINDUCTOR_CACHE_DIR", None)
    env.pop("TRITON_CACHE_DIR", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_second_process_hits_the_cache(tmp_path):
    shared = tmp_path / "shared"
    off_dir = tmp_path / "off"
    cold_p = _child(shared)
    off_p = _child(off_dir, on=False)
    cold = _result(cold_p)
    off = _result(off_p)
    warm = _result(_child(shared))

    assert cold["dir"] == str(shared)
    assert cold["misses"] >= 1 and cold["hits"] == 0
    assert cold["counts"]["fxgraph_cache_miss"] >= 1
    assert cold["telemetry_misses"] == cold["misses"]
    assert warm["hits"] >= 1 and warm["misses"] == 0
    assert warm["counts"]["fxgraph_cache_hit"] >= 1
    assert warm["telemetry_hits"] == warm["hits"] >= 1
    assert warm["telemetry_misses"] == 0
    np.testing.assert_array_equal(np.asarray(warm["out"]),
                                  np.asarray(cold["out"]))
    np.testing.assert_array_equal(np.asarray(off["out"]),
                                  np.asarray(cold["out"]))
    # MXNET_COMPILE_CACHE=0: no cache is consulted and nothing is written
    assert off["hits"] == off["misses"] == 0
    assert not off_dir.exists()


def test_enable_compile_cache_points_torch_at_the_directory(tmp_path,
                                                            monkeypatch):
    import torch._functorch.config as functorch_config
    import torch._inductor.config as inductor_config

    for name in ("TORCHINDUCTOR_CACHE_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(name, os.environ.get(name, ""))
    monkeypatch.setattr(inductor_config, "fx_graph_cache", False)
    monkeypatch.setattr(functorch_config, "enable_autograd_cache", False)
    d = tmx.config.enable_compile_cache(str(tmp_path / "cc"))
    assert d == str(tmp_path / "cc") and os.path.isdir(d)
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == d
    assert os.environ["TRITON_CACHE_DIR"] == os.path.join(d, "triton")
    assert inductor_config.fx_graph_cache
    assert functorch_config.enable_autograd_cache
    assert tmx.config.FLAGS["MXNET_COMPILE_CACHE"][0] == "1"
    assert tmx.config.FLAGS["MXNET_COMPILE_CACHE_DIR"][0] == os.path.join(
        os.path.expanduser("~"), ".cache", "mxnet_tpu_torch", "compile")
