"""The port's examples/train_imagenet.py ``--data-train`` loop against the
JAX example's real-data loop (examples/train_imagenet.py:89-118) on CPU:
resnet18_v1, classes 10, 3x32x32 crops, batch 8, 2 epochs over a .rec of
JPEG images that the test writes with the port's recordio (smooth
images: 4x5 random colours upsampled to 36-44 x 40-48 pixels), from the
same numpy weights, in float32, the example's type.

The JAX side is that loop inline (its ``main()`` returns nothing): the
package's ``io.ImageRecordIter`` (shuffle, rand_crop, rand_mirror),
hybridize, ``Trainer`` sgd momentum 0.9 wd 1e-4 on kvstore 'device',
``metric.Accuracy``, ``reset()`` before each epoch; relu's derivative at
0 is the reference MXNet's (tests/torch_zoo_ref.py).  Matmul precision
is pinned in both packages (ROADMAP).  Each step's loss within 1e-4
relative and the accuracy equal after each epoch:

- the example's lr 0.1 over 8 images: one batch an epoch;
- ``--lr 1e-4`` over 24 images: three batches an epoch, 6 steps.

Why the several-batch case runs at lr 1e-4.  Two float32 runs of this
network part at the first relu or max-pool whose input lies within
their rounding gap of the switch point: relu's derivative steps from 0
to 1 there, so the gradient jumps.  On 16 images at lr 0.01, the port's
float32 weights after step 0 are 1.0e-5 (max relative, a parameter)
from the JAX float64 run's and the JAX float32 run's 1.6e-5.  Yet at
step 1, between those two sets of weights, two relus of the stem and
one max-pool argmax switch, and one unit of unit6's and one of unit7's
output relu, on the 1x1 maps of stage 4.  There a BatchNorm's beta
gradient is a sum over 8 values, so one switch moves it by about an
eighth.  The port's float32 loss at step 2 is then 2.4e-2 from the
float64 run's; the JAX float32 run had no such switch and is 3.0e-4
off.  And at lr 1e-3 over 24 images even the two float64 runs part
(6.1e-3 at step 4): the JAX package's BatchNorm takes its rsqrt in
float32.  The gap between two runs after a step scales with the
learning rate.  At lr 1e-4 it stays below the forward's own rounding,
where step 0 already agrees.  From the repo's root,

    PYTHONPATH=. python tests/test_torch_train_imagenet_rec.py \
        --images 16 --lr 0.01

prints these gaps and switch counts."""
import argparse
import contextlib
import tempfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import mxnet_tpu as jmx
from mxnet_tpu.gluon import block as jblock
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import train_imagenet

from torch_zoo_ref import reference_relu_gradient

BATCH, CLASSES, EPOCHS = 8, 10, 2
SHAPE = (3, 32, 32)


@contextlib.contextmanager
def pinned_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("float32"):
            yield
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.fixture(autouse=True)
def _precision(monkeypatch):
    # the loop hybridizes, as the JAX example does: compiled here with
    # torch.compile's aot_eager backend, which keeps the suite's time
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    with pinned_precision():
        yield


def _argv(rec):
    return ["--data-train", rec, "--network", "resnet18_v1",
            "--batch-size", str(BATCH), "--image-shape", "3,32,32",
            "--num-classes", str(CLASSES), "--num-epochs", str(EPOCHS)]


def write_rec(tmp_path, n, seed=3):
    """``n`` JPEG images (quality 90), labels in [0, 10); the .rec path."""
    path = str(tmp_path / "train.rec")
    w = trec.MXIndexedRecordIO(str(tmp_path / "train.idx"), path, "w")
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, wd = rng.randint(36, 45), rng.randint(40, 49)
        base = (rng.rand(4, 5, 3) * 255).astype(np.uint8)
        img = np.asarray(Image.fromarray(base).resize((wd, h),
                                                      Image.BILINEAR))
        w.write_idx(i, trec.pack_img(
            trec.IRHeader(0, float(rng.randint(CLASSES)), i, 0), img,
            quality=90))
    w.close()
    return path


def _jax_loop(rec, lr=0.1, dtype="float32", after_step=None):
    """examples/train_imagenet.py:89-118 on the JAX package at ``lr`` in
    ``dtype``, with each step's loss and each epoch's accuracy kept;
    ``after_step(net, x)`` after each step.  Returns them and the initial
    (float32) weights."""
    jmx.random.seed(0)
    with jmx.name.NameManager():
        net = jvision.get_model("resnet18_v1", classes=CLASSES)
    net.initialize(jmx.init.Xavier())
    jblock._abstract_eval_forward(net, [jmx.nd.zeros((BATCH,) + SHAPE)])
    w0 = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    if dtype != "float32":
        net.cast(dtype)
        for n, p in net.collect_params().items():
            p.set_data(jmx.nd.array(w0[n].astype(dtype), dtype=dtype))
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    train = jmx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=SHAPE, batch_size=BATCH, shuffle=True,
        rand_crop=True, rand_mirror=True, dtype=dtype)
    trainer = jmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": lr, "momentum": 0.9,
                                 "wd": 1e-4}, kvstore="device")
    metric = jmx.metric.Accuracy()
    net.hybridize()
    losses, accs = [], []
    with reference_relu_gradient():
        for _ in range(EPOCHS):
            train.reset()
            metric.reset()
            for batch in train:
                x, y = batch.data[0], batch.label[0]
                with jmx.autograd.record():
                    out = net(x)
                    loss = loss_fn(out, y)
                loss.backward()
                trainer.step(BATCH)
                metric.update([y], [out])
                losses.append(float(loss.asnumpy().mean()))
                if after_step is not None:
                    after_step(net, x.asnumpy())
            accs.append(metric.get()[1])
    return np.array(losses), accs, w0


def _check(res, want, want_acc, n_images):
    got = res["losses"]
    steps = EPOCHS * n_images // BATCH
    assert got.shape == (steps,) == want.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert [e["accuracy"] for e in res["epochs"]] == want_acc
    assert [e["batches"] for e in res["epochs"]] == \
        [n_images // BATCH] * EPOCHS
    assert len(res["step_s"]) == len(res["data_wait_s"]) == steps
    assert res["images_per_sec"] > 0
    # rand_crop is not the native decoder's configuration
    assert res["iterator"]._decoded["native"] == 0


def test_data_train_losses_and_accuracy_match_the_jax_example(tmp_path):
    rec = write_rec(tmp_path, BATCH)
    want, want_acc, w0 = _jax_loop(rec)
    with tmx.name.NameManager():
        res = train_imagenet.train(_argv(rec), ctx=tmx.cpu(), arg_params=w0)
    _check(res, want, want_acc, BATCH)


def test_data_train_three_batches_an_epoch(tmp_path):
    rec = write_rec(tmp_path, 3 * BATCH)
    want, want_acc, w0 = _jax_loop(rec, lr=1e-4)
    hooked = []
    with tmx.name.NameManager():
        res = train_imagenet.train(_argv(rec) + ["--lr", "1e-4"],
                                   ctx=tmx.cpu(), arg_params=w0,
                                   step_hook=hooked.append)
    _check(res, want, want_acc, 3 * BATCH)
    assert hooked == list(range(EPOCHS * 3))


def test_data_train_keeps_the_dist_guard(tmp_path, monkeypatch):
    """The loop's --kv-store dist_sync, once a guard, now trains through
    the port's parameter server (one worker; the server runs the sgd):
    its losses and accuracy match the JAX example's loop on kvstore
    'device', as the local run's do."""
    import threading

    from mxnet_tpu_torch.kvstore_server import KVServer

    rec = write_rec(tmp_path, BATCH)
    want, want_acc, w0 = _jax_loop(rec)
    srv = KVServer("127.0.0.1", 0, 1)
    threading.Thread(target=srv.serve, daemon=True).start()
    for key, value in (("DMLC_PS_ROOT_URI", "127.0.0.1"),
                       ("DMLC_PS_ROOT_PORT", str(srv.port)),
                       ("DMLC_NUM_WORKER", "1"), ("DMLC_WORKER_RANK", "0")):
        monkeypatch.setenv(key, value)
    with tmx.name.NameManager():
        res = train_imagenet.train(_argv(rec) + ["--kv-store", "dist_sync"],
                                   ctx=tmx.cpu(), arg_params=w0)
    assert type(res["trainer"]._kvstore) is tmx.kv.KVStoreDist
    assert srv._optimizer.rescale_grad == 1.0 / BATCH
    _check(res, want, want_acc, BATCH)
    res["trainer"]._kvstore.close()
    srv.close()


def test_data_train_runs_on_the_card_by_default(tmp_path):
    """Without ctx the loop runs on gpu(0); on a host without a card it
    raises rather than train on the CPU."""
    rec = write_rec(tmp_path, BATCH)
    if torch.cuda.is_available():
        res = train_imagenet.train(_argv(rec))
        assert all(p.data()._data.is_cuda
                   for p in res["net"].collect_params().values())
    else:
        with pytest.raises(MXNetError, match="CUDA is not available"):
            train_imagenet.train(_argv(rec))


# -- the diagnosis of the module doc, as a script ---------------------------

def _port_loop(rec, w0, lr, dtype, after_step):
    """The example's loop on the port's modules in ``dtype`` (train() runs
    float32 only), on the CPU; ``after_step(net)`` after each step."""
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

    ctx = tmx.cpu()
    with tmx.name.NameManager():
        net = tvision.get_model("resnet18_v1", classes=CLASSES)
    net.initialize(tmx.init.Xavier(), ctx=ctx)
    with tmx.autograd.pause():
        net(tmx.nd.zeros((BATCH,) + SHAPE, ctx=ctx))
    tmx.convert.load_from_numpy(net, w0)
    net.cast(dtype)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    train = tmx.io.ImageRecordIter(
        path_imgrec=rec, data_shape=SHAPE, batch_size=BATCH, shuffle=True,
        rand_crop=True, rand_mirror=True, dtype=dtype, ctx=ctx)
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": lr, "momentum": 0.9,
                                 "wd": 1e-4}, kvstore="device")
    losses = []
    for _ in range(EPOCHS):
        train.reset()
        for batch in train:
            x, y = batch.data[0], batch.label[0]
            with tmx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(BATCH)
            losses.append(float(loss._data.detach().mean()))
            after_step(net)
    train.close()
    return np.array(losses)


def _switches(w, x):
    """The port's float64 forward of ``x`` at weights ``w`` ({name:
    array}): [(layer, relu mask or max-pool argmax)] in order."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.gluon import nn as tnn
    from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

    ctx = tmx.cpu()
    with tmx.name.NameManager():
        net = tvision.get_model("resnet18_v1", classes=CLASSES)
    net.initialize(tmx.init.Xavier(), ctx=ctx)
    net(tmx.nd.zeros((BATCH,) + SHAPE, ctx=ctx))
    net.cast("float64")
    for n, p in net.collect_params().items():
        p.set_data(tmx.nd.array(w[n], dtype="float64", ctx=ctx))
    out = []

    def hook(blk, args, o):
        if isinstance(blk, tnn.MaxPool2D):
            _, idx = F.max_pool2d(args[0]._data, 3, 2, 1,
                                  return_indices=True)
            out.append(("max-pool", idx))
        else:  # an Activation, or a unit's relu(x + body(x))
            out.append(("relu %s" % type(blk).__name__, o._data > 0))

    def walk(blk):
        if isinstance(blk, (tnn.Activation, tnn.MaxPool2D)) or \
                type(blk).__name__ == "_Unit":
            blk.register_forward_hook(hook)
        for child in blk._children.values():
            walk(child)

    walk(net)
    with tmx.autograd.record():
        net(tmx.nd.array(x, dtype="float64", ctx=ctx))
    return out


def diagnose(images, lr):
    """Per-step loss gaps of the float32 runs and the port's float64 run
    from the JAX float64 run, and what switches at step 1 between the
    port's float32 weights after step 0 and the JAX float64 run's."""
    import pathlib

    rec = write_rec(pathlib.Path(tempfile.mkdtemp()), images)
    kept = {}

    def keeper(key):
        def keep(net, x=None):
            ws = kept.setdefault(key, [])
            ws.append({n: p.data().asnumpy().astype(np.float64)
                       for n, p in net.collect_params().items()})
            if x is not None:
                kept.setdefault(key + " x", []).append(x)
        return keep

    with pinned_precision():
        j32, _, w0 = _jax_loop(rec, lr, "float32", keeper("jax f32"))
        with jax.enable_x64(True):
            j64, _, _ = _jax_loop(rec, lr, "float64", keeper("jax f64"))
        p32 = _port_loop(rec, w0, lr, "float32", keeper("port f32"))
        p64 = _port_loop(rec, w0, lr, "float64", keeper("port f64"))
    np.set_printoptions(precision=2, linewidth=120)
    print("%d images, lr %g: loss relative to the JAX float64 run's, by "
          "step" % (images, lr))
    for name, v in (("jax f32", j32), ("port f32", p32),
                    ("port f64", p64)):
        print("  %-8s %s" % (name, np.abs(v - j64) / np.abs(j64)))
    ref = kept["jax f64"][0]
    for name in ("jax f32", "port f32"):
        w = kept[name][0]
        print("  %s weights after step 0: %.2g from the float64 run's "
              "(max relative, a parameter)" % (name, max(
                  np.abs(w[n] - ref[n]).max() / np.abs(ref[n]).max()
                  for n in ref)))
    x1 = kept["jax f64 x"][1]
    print("  at step 1, the JAX float64 weights against the port float32 "
          "weights (after step 0), in the port's float64 forward:")
    for (name, a), (_, b) in zip(_switches(ref, x1),
                                 _switches(kept["port f32"][0], x1)):
        print("    %-14s %-18s %d switched"
              % (name, tuple(a.shape), int((a != b).sum())))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=diagnose.__doc__)
    parser.add_argument("--images", type=int, default=16)
    parser.add_argument("--lr", type=float, default=0.01)
    args = parser.parse_args()
    diagnose(args.images, args.lr)
