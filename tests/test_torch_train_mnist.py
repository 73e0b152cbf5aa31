"""The port's train_mnist example (mxnet_tpu_torch/examples/train_mnist.py)
held against the JAX example's functions on the CPU at a small size:
the MLP symbol (its JSON) and the LeNet (its parameters), each trained
for a few updates in both packages from the same seeded numpy weights
on the same batches (parameters and logits within rtol 1e-5, atol 1e-6
x the largest magnitude for gradients' sake: LeNet's relu has exact
zeros, where JAX's derivative is 1/2 and the port's 0, so it runs under
``reference_relu_gradient``); then both of the port example's paths end
to end over idx-ubyte files the test writes (256 seeded images whose
labels can be learnt).  The compiled path runs with ``aot_eager``."""
import json
import struct

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from examples import train_mnist as jex

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import train_mnist as tex

from torch_zoo_ref import reference_relu_gradient

RTOL, ATOL = 1e-5, 1e-6
SGD = {"learning_rate": 0.05, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def write_mnist(root, n, seed=0):
    """idx-ubyte image and label files of ``n`` digits: a class's
    prototype plus noise, so the labels can be learnt."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, n).astype(np.uint8)
    protos = rng.rand(10, 28, 28)
    imgs = np.clip(protos[labels] + rng.rand(n, 28, 28) * 0.5, 0, 1)
    imgs = (imgs * 255).astype(np.uint8)
    with open(root / "train-images-idx3-ubyte", "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with open(root / "train-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return imgs.astype(np.float32)[:, None] / 255.0, labels.astype(np.float32)


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _iter(pkg, x, y, batch):
    if pkg is tmx:
        with tmx.cpu():
            return tmx.io.NDArrayIter(x, y, batch_size=batch,
                                      label_name="softmax_label")
    return jmx.io.NDArrayIter(x, y, batch_size=batch,
                              label_name="softmax_label")


def test_mlp_symbol_and_module_path_match_jax(tmp_path):
    x, y = write_mnist(tmp_path, 96)
    syms = {}
    for pkg, ex in ((tmx, tex), (jmx, jex)):
        with pkg.name.NameManager():
            syms[pkg] = ex.mlp_symbol()
    assert json.loads(syms[tmx].tojson()) == json.loads(syms[jmx].tojson())
    arg_shapes, _, _ = syms[tmx].infer_shape(data=(32, 1, 28, 28))
    rng = np.random.RandomState(1)
    w = {n: (rng.randn(*s) * 0.05).astype(np.float32)
         for n, s in zip(syms[tmx].list_arguments(), arg_shapes)
         if n not in ("data", "softmax_label")}
    res = []
    for pkg in (jmx, tmx):
        mod = pkg.mod.Module(syms[pkg], context=(
            tmx.cpu() if pkg is tmx else jmx.cpu()))
        mod.fit(_iter(pkg, x, y, 32), optimizer="sgd", optimizer_params=SGD,
                num_epoch=2, arg_params={k: _nd(pkg, v)
                                         for k, v in w.items()})
        res.append(({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                    mod.predict(_iter(pkg, x, y, 32)).asnumpy()))
    for k in res[0][0]:
        np.testing.assert_allclose(res[1][0][k], res[0][0][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=RTOL, atol=ATOL)


def test_lenet_gluon_path_matches_jax(tmp_path):
    x, y = write_mnist(tmp_path, 16)
    res = []
    with reference_relu_gradient():
        for pkg, ex in ((jmx, jex), (tmx, tex)):
            with pkg.name.NameManager():
                net = ex.lenet_gluon()
            net.initialize(ctx=tmx.cpu() if pkg is tmx else jmx.cpu())
            with pkg.autograd.pause():
                net(_nd(pkg, x[:8]))
            rng = np.random.RandomState(2)
            for name, p in sorted(net.collect_params().items()):
                p.set_data(_nd(pkg, (rng.randn(*p.data().shape) * 0.05)
                               .astype(np.float32)))
            net.hybridize()
            trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", SGD)
            loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
            for step in range(2):
                xb, yb = (_nd(pkg, a[step * 8:(step + 1) * 8])
                          for a in (x, y))
                with pkg.autograd.record():
                    out = net(xb)
                    loss = loss_fn(out, yb)
                loss.backward()
                trainer.step(8)
            res.append(({k: p.data().asnumpy()
                         for k, p in net.collect_params().items()},
                        out.asnumpy()))
    assert sorted(res[0][0]) == sorted(res[1][0])
    for k in res[0][0]:
        np.testing.assert_allclose(res[1][0][k], res[0][0][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=RTOL, atol=ATOL)


def test_port_example_both_paths_learn(tmp_path):
    write_mnist(tmp_path, 256)
    args = tex.parse_args(["--cpu", "--data-dir", str(tmp_path),
                           "--epochs", "2", "--batch-size", "32"])
    mod, score = tex.train_module(args)
    assert dict(score)["accuracy"] > 0.5    # chance is 0.1
    res = tex.train_gluon(args, max_steps=12)
    losses = res["losses"]
    assert losses.shape == (12,) and np.isfinite(losses).all()
    assert losses[-3:].mean() < losses[:3].mean()
    assert len(res["step_s"]) == 12
    with pytest.raises(SystemExit):
        tex.parse_args(["--kv-store", "dist_sync"])
