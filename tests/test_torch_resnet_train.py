"""Parity of the port's gluon training slice with the JAX package, on CPU.

The same small bottleneck ResNet v1 (ResNetV1(BottleneckV1, [1,1,1,1],
[16,32,64,128,256], classes=10), batch 4, 3x32x32) runs in both packages
from the same numpy weights and data: logits, gradients, and Trainer
steps through KVStore('device') with 2-bit compression (t 0.5) and
update_on_kvstore=True (sgd, momentum 0.9, wd 1e-4) in two runs:

- three steps on three batches at lr 0.01;
- five steps on one fixed batch at lr 0.1, the settings of
  ``chip_smoke.py``'s resnet50_v1 run.  There the loss falls for four
  steps and rises at the fifth in both packages: momentum 0.9 at lr 0.1
  overshoots on a fixed batch, and the JAX package is the witness that
  the rise is the optimizer's and not a fault of the port.

Tolerances: f32 with both packages pinned to full-precision matmuls.
Logits: rtol 1e-4 / atol 1e-5 elementwise.  Gradients: rtol 1e-4 of the
tensor's largest magnitude plus atol 1e-5.  Gradients here reach ~100
while holding elements near 0, and XLA and torch sum in different orders:
against a float64 run both packages' f32 gradients are off by ~2e-5 of
the tensor's scale (conv0: 1.8e-3 JAX, 2.0e-3 torch, at max |g| 99.7),
which an elementwise rtol cannot express for the near-zero elements.

2-bit compression is discontinuous: a gradient within f32 rounding of
+-t can take another code in the other package.  Parameters agree at
atol 1e-4 everywhere else.  Each position off by more is a flip: one
code level (+-t) at step s moves the rescaled gradient by one quantum
lr * t / batch, and momentum carries it into the final weight as
quantum * (1 + 0.9 + ... + 0.9 ** (steps - s)).  A flip also moves the
residual by -+t, which can flip the same element back at a later step,
so the difference must be within 1e-3 quantum of one such sum or of the
sum or difference of two of them; and flips must stay under 0.1% of the
elements.  The three-step run is at lr 0.01 because a flip perturbs the
next step's gradients by about one quantum: over three batches at lr 0.1
that outgrows f32 noise and cascades (hundreds of flips by step 3 and a
step-3 loss 1.8e-3 apart); at 0.01 one element in 135,506 flipped.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.name import NameManager as TNameManager

BATCH = 4
STEPS = 3
LR = 0.01
SMOKE_STEPS = 5       # chip_smoke.py's steps and learning rate
SMOKE_LR = 0.1
MOMENTUM = 0.9
THRESHOLD = 0.5
COMP = {"type": "2bit", "threshold": THRESHOLD}


def _data(steps, fixed):
    """``steps`` batches, or one batch ``steps`` times when ``fixed``."""
    rng = np.random.RandomState(0)
    n = 1 if fixed else steps
    xs = [rng.randn(BATCH, 3, 32, 32).astype(np.float32) for _ in range(n)]
    ys = [rng.randint(0, 10, BATCH).astype(np.float32) for _ in range(n)]
    if fixed:
        xs, ys = xs * steps, ys * steps
    return xs, ys


def _state(net):
    return {n: p.data().asnumpy().copy()
            for n, p in net.collect_params().items()}


def _run(mx, net, xs, ys, lr):
    """Logits and grads of step 1, losses and params after each step."""
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": lr, "momentum": MOMENTUM,
                                "wd": 1e-4},
                               kvstore=mx.kv.create("device"),
                               compression_params=dict(COMP),
                               update_on_kvstore=True)
    out = {"losses": []}
    for step, (x, y) in enumerate(zip(xs, ys)):
        xa, ya = _nd(mx, x), _nd(mx, y)
        with mx.autograd.record():
            logits = net(xa)
            loss = loss_fn(logits, ya)
        loss.backward()
        out["losses"].append(loss.asnumpy().copy())
        if step == 0:
            out["logits"] = logits.asnumpy().copy()
            out["grads"] = {n: p.grad().asnumpy().copy()
                            for n, p in net.collect_params().items()
                            if p.grad_req != "null"}
        trainer.step(BATCH)
    out["params"] = _state(net)
    return out


def _nd(mx, a):
    if mx is tmx:
        return tmx.nd.array(a, ctx=tmx.cpu())
    return jmx.nd.array(a)


def _build(vision, name_manager):
    with name_manager():
        return vision.ResNetV1(vision.BottleneckV1, [1, 1, 1, 1],
                               [16, 32, 64, 128, 256], classes=10)


def _both(steps, lr, fixed):
    """The same weights and data through both packages."""
    xs, ys = _data(steps, fixed)
    with jax.default_matmul_precision("float32"):
        jnet = _build(jvision, JNameManager)
        jmx.random.seed(0)
        jnet.initialize(jmx.init.Xavier())
        jnet(jmx.nd.array(xs[0]))  # finish deferred init (no stat update)
        weights = _state(jnet)
        jout = _run(jmx, jnet, xs, ys, lr)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        tnet = _build(tvision, TNameManager)
        tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        tmx.convert.load_from_numpy(tnet, weights)
        tout = _run(tmx, tnet, xs, ys, lr)
    finally:
        torch.set_float32_matmul_precision(prev)
    return {"jnet": jnet, "tnet": tnet, "weights": weights,
            "jax": jout, "torch": tout}


@pytest.fixture(scope="module")
def runs():
    return _both(STEPS, LR, fixed=False)


@pytest.fixture(scope="module")
def smoke_runs(runs):
    # after ``runs``: JAX's compiled ops are then cached and this run
    # takes seconds
    return _both(SMOKE_STEPS, SMOKE_LR, fixed=True)


def _flip_sizes(steps):
    """Final-weight moves, in quanta, of one flip at one step or of two
    flips of the same element at two steps (see the module docstring)."""
    carry = [sum(MOMENTUM ** i for i in range(steps - s))
             for s in range(steps)]
    sizes = set(carry)
    for i, a in enumerate(carry):
        for b in carry[i + 1:]:
            sizes.update((a + b, abs(a - b)))
    return np.array(sorted(sizes))


def _check_params_agree(out, lr, steps):
    quantum = lr * THRESHOLD / BATCH
    sizes = _flip_sizes(steps)
    flipped = total = 0
    for n, jv in out["jax"]["params"].items():
        tv = out["torch"]["params"][n]
        diff = np.abs(tv - jv)
        off = diff > 1e-4
        total += jv.size
        flipped += int(off.sum())
        # a code flip moves a weight by whole, momentum-carried quanta,
        # never by drift
        q = diff[off][:, None] / quantum
        assert np.all(np.abs(q - sizes[None, :]).min(axis=1) <= 1e-3), \
            (n, q.ravel())
    assert flipped <= 1e-3 * total, (flipped, total)


def test_param_names_and_shapes_equal(runs):
    jp = runs["jnet"].collect_params()
    tp = runs["tnet"].collect_params()
    assert list(jp.keys()) == list(tp.keys())
    assert list(tp.keys())[0] == "resnetv10_conv2d0_weight"
    for n in jp.keys():
        assert tuple(jp[n].shape) == tuple(tp[n].shape), n
        assert jp[n].grad_req == tp[n].grad_req, n


def test_forward_logits_agree(runs):
    np.testing.assert_allclose(runs["torch"]["logits"],
                               runs["jax"]["logits"], rtol=1e-4, atol=1e-5)


def test_gradients_agree(runs):
    jg, tg = runs["jax"]["grads"], runs["torch"]["grads"]
    assert set(jg) == set(tg)
    for n in jg:
        err = np.abs(tg[n] - jg[n]).max()
        assert err <= 1e-4 * np.abs(jg[n]).max() + 1e-5, (n, err)


def test_three_compressed_steps_losses_agree(runs):
    for step, (tl, jl) in enumerate(zip(runs["torch"]["losses"],
                                        runs["jax"]["losses"])):
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=str(step))


def test_three_compressed_steps_params_agree(runs):
    _check_params_agree(runs, LR, STEPS)


def test_smoke_settings_losses_agree(smoke_runs):
    for step, (tl, jl) in enumerate(zip(smoke_runs["torch"]["losses"],
                                        smoke_runs["jax"]["losses"])):
        np.testing.assert_allclose(tl, jl, rtol=1e-4, err_msg=str(step))


def test_smoke_settings_params_agree(smoke_runs):
    _check_params_agree(smoke_runs, SMOKE_LR, SMOKE_STEPS)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_smoke_settings_loss_falls_then_overshoots(smoke_runs, package):
    """lr 0.1 and momentum 0.9 on one fixed batch: the loss falls for
    four steps and rises at the fifth, in the JAX package as in the
    port."""
    losses = [float(v.mean()) for v in smoke_runs[package]["losses"]]
    assert losses[0] > losses[1] > losses[2] > losses[3] < losses[4], losses


def test_trained_params_moved(runs):
    """The run really trained: weights, BatchNorm scales and running
    stats left their starting values.  (The bottleneck convs' biases feed
    a BatchNorm, so their gradients are f32 noise far below t and never
    emit a code.)"""
    names = [n for n in runs["weights"] if not n.endswith("_bias")]
    still = [n for n in names
             if np.array_equal(runs["torch"]["params"][n],
                               runs["weights"][n])]
    assert not still


def _dense_two_steps(kvstore=None, **trainer_kw):
    """Dense(2, in_units=3), weights 1, lr 0.1, x = ones(1, 3), loss =
    sum of the outputs: every weight gradient is 1 per step."""
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize(tmx.init.One(), ctx=tmx.cpu())
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1},
                                kvstore=kvstore or tmx.kv.create("device"),
                                **trainer_kw)
    x = tmx.nd.ones((1, 3), ctx=tmx.cpu())
    for _ in range(2):
        with tmx.autograd.record():
            y = net(x)
        y.backward()
        trainer.step(1)
    return net.weight.data().asnumpy()


@pytest.mark.parametrize("trainer_kw, expect", [
    # no updater: push ASSIGNS the merged gradient (upstream's
    # `local = merged`), so this is plain SGD: 1 - 2 * 0.1
    ({}, 0.8),
    ({"update_on_kvstore": True}, 0.8),
    # 2-bit, t = 0.5: each step sends +0.5 and keeps 0.5 of residual
    ({"update_on_kvstore": True, "compression_params": COMP}, 0.9),
    # a string store on one context is bypassed: local SGD
    ({"kvstore": "device"}, 0.8),
])
def test_push_without_updater_assigns(trainer_kw, expect):
    np.testing.assert_allclose(_dense_two_steps(**trainer_kw),
                               np.full((2, 3), expect, np.float32),
                               rtol=1e-6)
