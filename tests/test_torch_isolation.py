"""The port stands alone: importing mxnet_tpu_torch (with its parallel
engines, flash-attention op, generation engine and LM), building a full
resnet50_v1 on the CPU, and admitting into and decoding with a tiny LM's
GenerationEngine loads neither jax nor mxnet_tpu, and chip_smoke.py
imports neither.  The import check runs in a subprocess because this
test session has already imported jax (tests/conftest.py)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import sys
import numpy as np
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.parallel
import mxnet_tpu_torch.ops.attention
from mxnet_tpu_torch.gluon.model_zoo import vision
net = vision.resnet50_v1(classes=1000)
net.initialize(mx.init.Xavier(), ctx=mx.cpu())
out = net(mx.nd.array(np.zeros((1, 3, 64, 64), np.float32), ctx=mx.cpu()))
assert out.shape == (1, 1000), out.shape
trainable = [p for p in net.collect_params().values() if p.grad_req != "null"]
assert len(trainable) == 193, len(trainable)
import mxnet_tpu_torch.generate
from mxnet_tpu_torch.examples.transformer_lm import TransformerLM
lm = TransformerLM(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                   max_len=16)
lm.initialize(mx.init.Xavier(), ctx=mx.cpu())
eng = mxnet_tpu_torch.generate.GenerationEngine(
    lm, slots=2, cache_len=16, buckets=[8], device=mx.cpu())
slot, tok = eng.admit([1, 2, 3])
assert slot in eng.decode_step() and 0 <= tok < 32
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "mxnet_tpu"
             or m.startswith("mxnet_tpu."))
print("LOADED", bad)
"""


def test_port_imports_no_jax_and_no_mxnet_tpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


def _foreign(mods):
    return sorted(m for m in mods
                  if m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu"))


def test_chip_smoke_imports_no_jax_and_no_mxnet_tpu():
    mods = _imported_modules(ROOT / "chip_smoke.py")
    assert "mxnet_tpu_torch" in {m.split(".")[0] for m in mods}
    assert _foreign(mods) == []


def test_port_sources_import_no_jax_and_no_mxnet_tpu():
    for path in sorted((ROOT / "mxnet_tpu_torch").rglob("*.py")):
        assert _foreign(_imported_modules(path)) == [], path
