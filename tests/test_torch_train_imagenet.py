"""The port's examples/train_imagenet.py entry function against the JAX
example's gluon loop on CPU: resnet18_v2, classes 10, 3x32x32, batch 8,
``--benchmark 1 --lr 0.01``, one warm-up step and 2 timed steps from the
same weights.  The JAX side is examples/train_imagenet.py's benchmark
loop itself (hybridize, Trainer sgd momentum 0.9 with kvstore 'device',
record, backward, step) on its RandomState(0) batch, with relu's
derivative at 0 the reference MXNet's (tests/torch_zoo_ref.py).

The first loss (before any update) within rtol 1e-5.  The two after it
within 1e-2 of the first loss, and falling in both: in this run a relu input of the
third stage lies within f32 noise of 0 and the two packages put it on
different sides, which changes that element's gradient by its whole
size (the port's f32 gradients there are 2.7e-3 of the largest from a
float64 run of the same model, the JAX package's 9e-6; a float64 run
puts every other gradient within 1e-5).  Then the flags that are not
ported raise, and the entry runs on the card by default and raises
rather than fall back without one."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import train_imagenet

from torch_zoo_ref import reference_relu_gradient

BATCH, STEPS, CLASSES, LR = 8, 2, 10, "0.01"
ARGS = ["--benchmark", "1", "--network", "resnet18_v2", "--num-classes",
        str(CLASSES), "--image-shape", "3,32,32", "--batch-size",
        str(BATCH), "--steps", str(STEPS), "--lr", LR]


@pytest.fixture(autouse=True)
def _precision(monkeypatch):
    # the entry hybridizes, as the JAX example does: compiled here with
    # torch.compile's aot_eager backend, which keeps the suite's time
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _jax_loop():
    """examples/train_imagenet.py's --benchmark gluon loop (:63-82), its
    losses per step; returns them and the initial weights."""
    rng = np.random.RandomState(0)
    x = jmx.nd.array(rng.rand(BATCH, 3, 32, 32).astype(np.float32))
    y = jmx.nd.array(rng.randint(0, CLASSES, BATCH).astype(np.float32))
    jmx.random.seed(0)
    with jmx.name.NameManager():
        net = jvision.get_model("resnet18_v2", classes=CLASSES)
    net.initialize(jmx.init.Xavier())
    from mxnet_tpu.gluon import block as jblock

    jblock._abstract_eval_forward(net, [x])
    w0 = {n: p.data().asnumpy() for n, p in net.collect_params().items()}
    net.hybridize()
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = jmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": float(LR), "momentum": 0.9},
                                kvstore="device")
    losses = []
    with reference_relu_gradient():
        for _ in range(1 + STEPS):
            with jmx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(BATCH)
            losses.append(float(loss.asnumpy().mean()))
    return np.array(losses, np.float32), w0


def test_train_entry_losses_match_the_jax_example_loop():
    want, w0 = _jax_loop()
    with tmx.name.NameManager():
        res = train_imagenet.train(ARGS, ctx=tmx.cpu(), arg_params=w0)
    got = res["losses"]
    assert got.shape == (1 + STEPS,)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * want[0])
    assert got[-1] < got[0] and want[-1] < want[0]
    assert len(res["step_s"]) == STEPS and res["images_per_sec"] > 0
    assert res["trainer"]._fused_updates == 1 + STEPS


def test_sharded_flag_trains_through_the_sharded_trainer():
    with tmx.name.NameManager():
        res = train_imagenet.train(ARGS + ["--sharded"], ctx=tmx.cpu())
    assert isinstance(res["trainer"], tmx.parallel.ShardedTrainer)
    assert res["losses"].shape == (1 + STEPS,)
    assert np.isfinite(res["losses"]).all()


@pytest.mark.parametrize("extra, match", [
    (["--kv-store", "dist_sync"], "all 1 workers are connected"),
    (["--kv-store", "dist_device_sync"], "all 1 workers are connected"),
    (["--kv-store", "dist_async"], "all 1 workers are connected"),
])
def test_unported_flags_raise(monkeypatch, extra, match):
    """The dist kvstores are ported (tests/test_torch_kvstore_dist*.py run
    them under the launcher): the entry raises for them only where the
    parameter server refuses the worker, here one whose single worker
    slot is taken, and never waits on it."""
    import threading

    from mxnet_tpu_torch.kvstore_server import KVServer, WorkerClient

    srv = KVServer("127.0.0.1", 0, 1)
    threading.Thread(target=srv.serve, daemon=True).start()
    taken = WorkerClient("127.0.0.1", srv.port, rank=0, num_workers=1)
    for key, value in (("DMLC_PS_ROOT_URI", "127.0.0.1"),
                       ("DMLC_PS_ROOT_PORT", str(srv.port)),
                       ("DMLC_NUM_WORKER", "1"), ("DMLC_WORKER_RANK", "0")):
        monkeypatch.setenv(key, value)
    with pytest.raises(MXNetError, match=match):
        train_imagenet.train(ARGS + extra, ctx=tmx.cpu())
    taken.close()
    srv.close()


def test_without_benchmark_or_data_it_raises():
    argv = [a for a in ARGS if a not in ("--benchmark", "1")]
    with pytest.raises(MXNetError, match="--benchmark 1"):
        train_imagenet.train(argv, ctx=tmx.cpu())


def test_default_context_is_the_card_and_never_falls_back():
    """Without ctx the entry runs on gpu(0): on a host without a card it
    raises rather than train on the CPU; with one, its tensors are on
    the card."""
    if torch.cuda.is_available():
        res = train_imagenet.train(ARGS)
        assert all(p.data()._data.is_cuda
                   for p in res["net"].collect_params().values())
    else:
        with pytest.raises(MXNetError, match="CUDA is not available"):
            train_imagenet.train(ARGS)
