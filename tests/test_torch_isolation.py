"""The port stands alone: importing mxnet_tpu_torch (with its parallel
engines, flash-attention op, generation engine and LM, the optimizers
and their update ops, lr_scheduler, metric, gluon.utils, the engine,
runtime and util modules, legacy_io, the random ops, the model store and
the train_imagenet and dcgan examples), building a full resnet50_v1 and
every zoo network on the CPU, training two steps through the
train_imagenet entry, saving a network's parameters in both formats and
loading them through get_model(pretrained=True) from a local root, and
admitting into and decoding with a tiny LM's GenerationEngine, and the
data pipeline (mx.io, mx.image, mx.recordio, mx.native, mx.storage and
mx.gluon.data: writing a small .rec, reading it through ImageRecordIter
and a DataLoader, and one step of train_imagenet's --data-train loop),
and the symbolic layer (mx.sym, mx.mod, mx.model, mx.callback,
mx.monitor, mx.visualization: one Module update, one hybridized block
and an export / SymbolBlock.imports round trip, compiled with the
aot_eager backend), and the recurrent family and fusion (mx.gluon.rnn,
mx.gluon.contrib, mx.rnn, mx.nd.contrib.foreach, mx.sym.fusion and the
two examples: one LSTM step with its backward, one unrolled mx.rnn
stack and one apply_fusion), and the detection and int8 slice (the
contrib, ssd, deformable and quantization ops, contrib.quantization and
the ssd_detect_quant and quantize_calibrate examples: one int8
detection forward of quantize_model's graph), and the parameter-server
path (mx.kvstore_server, mx.tools.launch and KVStoreDist: a sync round of
two workers through the port's server with 2-bit compression and its
optimizer), and the observability layer (telemetry, tracing, profiler,
events, perf_ledger, goodput, fleet and monitor's heartbeat: two
ShardedTrainer steps with every layer on, their step breakdown, a
TokenServer request, a fleet snapshot and a goodput ledger, a profiler
window and the scrape endpoint) loads neither jax nor mxnet_tpu, and
chip_smoke.py imports neither.  The import check runs in a subprocess because this
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
mx.jit._BACKEND = "aot_eager"   # train_imagenet hybridizes
import mxnet_tpu_torch.parallel
import mxnet_tpu_torch.ops.attention
from mxnet_tpu_torch.gluon.model_zoo import vision
net = vision.resnet50_v1(classes=1000)
net.initialize(mx.init.Xavier(), ctx=mx.cpu())
out = net(mx.nd.array(np.zeros((1, 3, 64, 64), np.float32), ctx=mx.cpu()))
assert out.shape == (1, 1000), out.shape
trainable = [p for p in net.collect_params().values() if p.grad_req != "null"]
assert len(trainable) == 193, len(trainable)
import mxnet_tpu_torch.lr_scheduler
import mxnet_tpu_torch.metric
import mxnet_tpu_torch.gluon.utils
import mxnet_tpu_torch.ops.optimizer_ops
from mxnet_tpu_torch.examples import train_imagenet
nets = [vision.get_model(name, classes=10) for name in sorted(vision._models)]
assert len(nets) == 34
res = train_imagenet.train(["--benchmark", "1", "--network", "mobilenet0.25",
                            "--num-classes", "4", "--image-shape", "3,32,32",
                            "--batch-size", "2", "--steps", "1"], ctx=mx.cpu())
assert res["losses"].shape == (2,)
metric = mx.metric.create(["acc", "ce"])
metric.update([mx.nd.array(np.array([1.0]), ctx=mx.cpu())],
              [mx.nd.array(np.array([[0.2, 0.8]]), ctx=mx.cpu())])
import tempfile
import mxnet_tpu_torch.engine
import mxnet_tpu_torch.runtime
import mxnet_tpu_torch.util
import mxnet_tpu_torch.ndarray.legacy_io
import mxnet_tpu_torch.ops.random_ops
from mxnet_tpu_torch.gluon.model_zoo import model_store
from mxnet_tpu_torch.examples import dcgan
with tempfile.TemporaryDirectory() as root:
    for fmt in ("npz", "binary"):
        with mx.name.NameManager():
            src = vision.get_model("mobilenet0.25", classes=4)
        src.initialize(mx.init.Xavier(), ctx=mx.cpu())
        x = mx.nd.array(np.ones((1, 3, 32, 32), np.float32), ctx=mx.cpu())
        src(x)
        mx.nd.save(root + "/mobilenet0.25.params",
                   {k: p._reduce()
                    for k, p in src._collect_params_with_prefix().items()},
                   format=fmt)
        with mx.name.NameManager():
            net = vision.get_model("mobilenet0.25", classes=4,
                                   pretrained=True, root=root, ctx=mx.cpu())
        with mx.autograd.predict_mode():
            assert (net(x).asnumpy() == src(x).asnumpy()).all()
assert mx.runtime.Features().is_enabled("CPU")
import mxnet_tpu_torch.generate
from mxnet_tpu_torch.examples.transformer_lm import TransformerLM
lm = TransformerLM(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                   max_len=16)
lm.initialize(mx.init.Xavier(), ctx=mx.cpu())
eng = mxnet_tpu_torch.generate.GenerationEngine(
    lm, slots=2, cache_len=16, buckets=[8], device=mx.cpu())
slot, tok = eng.admit([1, 2, 3])
assert slot in eng.decode_step() and 0 <= tok < 32
import mxnet_tpu_torch.io
import mxnet_tpu_torch.image
import mxnet_tpu_torch.recordio
import mxnet_tpu_torch.native
import mxnet_tpu_torch.storage
import mxnet_tpu_torch.gluon.data
from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset, transforms
with tempfile.TemporaryDirectory() as root:
    rec = root + "/t.rec"
    w = mx.recordio.MXIndexedRecordIO(root + "/t.idx", rec, "w")
    rng = np.random.RandomState(0)
    for i in range(8):
        img = rng.randint(0, 256, (40, 44, 3)).astype(np.uint8)
        w.write_idx(i, mx.recordio.pack_img((0, float(i % 4), i, 0), img))
    w.close()
    it = mx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 32, 32),
                               batch_size=4, rand_crop=True, ctx=mx.cpu())
    assert [b.data[0].shape for b in it] == [(4, 3, 32, 32)] * 2
    it.close()
    ds = ImageRecordDataset(rec).transform_first(transforms.ToTensor())
    xb, yb = next(iter(mx.gluon.data.DataLoader(ds, batch_size=4,
                                                num_workers=2)))
    assert xb.shape == (4, 3, 40, 44)
    res = train_imagenet.train(["--data-train", rec, "--network",
                                "mobilenet0.25", "--num-classes", "4",
                                "--image-shape", "3,32,32", "--batch-size",
                                "8", "--num-epochs", "1"], ctx=mx.cpu())
    assert res["losses"].shape == (1,)
    mx.native.available()
    mx.storage.pool_stats()
import mxnet_tpu_torch.executor
from mxnet_tpu_torch.examples import train_mnist
assert (mx.sym, mx.symbol, mx.mod, mx.model, mx.callback,
        mx.monitor.Monitor, mx.visualization.print_summary)
mod = mx.mod.Module(train_mnist.mlp_symbol(), context=mx.cpu())
mod.bind(data_shapes=[("data", (4, 1, 28, 28))],
         label_shapes=[("softmax_label", (4,))])
mod.init_params(mx.init.Xavier())
mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
batch = mx.io.DataBatch([mx.nd.ones((4, 1, 28, 28), ctx=mx.cpu())],
                        [mx.nd.array([1, 2, 3, 4], ctx=mx.cpu())])
mod.forward_backward(batch)
mod.update()
assert mod.get_outputs()[0].shape == (4, 10)
lenet = train_mnist.lenet_gluon()
lenet.initialize(mx.init.Xavier(), ctx=mx.cpu())
lenet.hybridize()
xb = mx.nd.ones((2, 1, 28, 28), ctx=mx.cpu())
with mx.autograd.record():
    out = lenet(xb)
out.backward()
with tempfile.TemporaryDirectory() as root:
    pfile = lenet.export(root + "/lenet")
    blk = mx.gluon.SymbolBlock.imports(root + "/lenet-symbol.json", "data",
                                       pfile, ctx=mx.cpu())
    assert np.abs(blk(xb).asnumpy() - lenet(xb).asnumpy()).max() < 1e-5
import mxnet_tpu_torch.gluon.rnn
import mxnet_tpu_torch.gluon.contrib
import mxnet_tpu_torch.rnn
import mxnet_tpu_torch.fusion_cost
from mxnet_tpu_torch.examples import word_language_model, rnn_bucketing
assert mx.nd.contrib.foreach is mxnet_tpu_torch.ops.control_flow.foreach
lstm = mx.gluon.rnn.LSTM(8, num_layers=2, input_size=4)
lstm.initialize(mx.init.Xavier(), ctx=mx.cpu())
seq = mx.nd.ones((3, 2, 4), ctx=mx.cpu())
with mx.autograd.record():
    out, states = lstm(seq, lstm.begin_state(2, ctx=mx.cpu()))
out.backward()
assert out.shape == (3, 2, 8) and states[1].shape == (2, 2, 8)
cells = mx.rnn.SequentialRNNCell().add(mx.rnn.LSTMCell(4, prefix="a_"))
cells.unroll(2, inputs=mx.sym.var("data"), merge_outputs=True)
net = mx.sym.Activation(mx.sym.var("x") + mx.sym.var("y"), act_type="relu")
fused, fired = mx.sym.fusion.apply_fusion(net, "default")
assert [f[0] for f in fired] == ["add_act"]
import mxnet_tpu_torch.ops.contrib_ops
import mxnet_tpu_torch.ops.ssd
import mxnet_tpu_torch.ops.ssd_ops
import mxnet_tpu_torch.ops.deformable
import mxnet_tpu_torch.ops.quantization
import mxnet_tpu_torch.contrib.quantization
from mxnet_tpu_torch.examples import ssd_detect_quant, quantize_calibrate
with mx.name.NameManager():
    dsym = ssd_detect_quant.detection_symbol(3, width=4)
arg_shapes, _, _ = dsym.infer_shape(data=(1, 3, 16, 16))
rng = np.random.RandomState(0)
args = {n: mx.nd.array(rng.randn(*s).astype(np.float32) * 0.3, ctx=mx.cpu())
        for n, s in zip(dsym.list_arguments(), arg_shapes) if n != "data"}
qsym, qargs, _ = mx.contrib.quantization.quantize_model(dsym, args, {})
qargs["data"] = mx.nd.array(rng.rand(1, 3, 16, 16).astype(np.float32),
                            ctx=mx.cpu())
det = qsym.bind(ctx=mx.cpu(), args=qargs).forward()[0]
assert det.shape == (1, 80, 6)
import threading
import mxnet_tpu_torch.kvstore_server as ps
import mxnet_tpu_torch.tools.launch
srv = ps.KVServer("127.0.0.1", 0, 2)
threading.Thread(target=srv.serve, daemon=True).start()
stores = [mx.kv.KVStoreDist("dist_sync", client=ps.WorkerClient(
    "127.0.0.1", srv.port, rank=r, num_workers=2)) for r in range(2)]
pulled = [None, None]
def dist_worker(kv):
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=1.0))
    kv.init(["0"], [mx.nd.zeros((4,), ctx=mx.cpu())])
    kv.push(["0"], [mx.nd.ones((4,), ctx=mx.cpu())])
    out = mx.nd.zeros((4,), ctx=mx.cpu())
    kv.pull(["0"], out=[out])
    pulled[kv.rank] = out.asnumpy()
    kv.close()
ts = [threading.Thread(target=dist_worker, args=(kv,)) for kv in stores]
for t in ts:
    t.start()
for t in ts:
    t.join(timeout=60)
assert all((p == -1.0).all() for p in pulled), pulled
import urllib.request
from mxnet_tpu_torch import (telemetry, tracing, profiler, events,
                             perf_ledger, goodput, fleet, monitor)
from mxnet_tpu_torch import parallel as tpar
root = tempfile.mkdtemp()
telemetry.enable(); tracing.enable(); events.enable(path="", sample=1.0)
rec = goodput.GoodputRecorder(root + "/gp", rank=0, n_procs=1).begin()
with mx.name.NameManager():
    mlp = mx.gluon.nn.HybridSequential()
    mlp.add(mx.gluon.nn.Dense(4, in_units=3))
mlp.initialize(mx.init.Xavier(), ctx=mx.cpu())
sce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
st = tpar.ShardedTrainer(mlp, lambda o, l: sce(o, l), optimizer="sgd")
profiler.set_config(filename=root + "/profile.json")
profiler.start()
for _ in range(2):
    st.step([mx.nd.array(np.ones((2, 3), np.float32), ctx=mx.cpu())],
            mx.nd.array(np.zeros(2, np.float32), ctx=mx.cpu()))
profiler.stop()
profiler.dump()
assert st.step_breakdown().steps == 2
assert telemetry.TRAIN_STEPS.value(loop="sharded") == 2
pub = fleet.FleetPublisher(root + "/spool", rank=0, n_procs=1)
assert pub.publish_once() is not None
assert fleet.fleetz(spool=root + "/spool")["active"]
eng.evict(slot, "length")
ts = mxnet_tpu_torch.generate.TokenServer(eng, queue_depth=2,
                                          max_new_tokens=2)
assert len(ts.generate([1, 2, 3], timeout=60).tokens) == 2
ts.close()
assert [e["kind"] for e in events.recent()][-1] == "token_request"
rec.end("clean")
assert goodput.goodputz(dir=root + "/gp")["active"]
assert perf_ledger.validate_record(perf_ledger.make_record("m", 1.0, "u")) == []
monitor.TelemetryHeartbeat().line()
srv = telemetry.serve_scrape(port=0, host="127.0.0.1")
urllib.request.urlopen("http://127.0.0.1:%d/statusz" % srv.port,
                       timeout=10).read()
telemetry.stop_scrape()
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
