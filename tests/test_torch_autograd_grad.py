"""``autograd.grad`` (first and second order), ``autograd.Function`` and
``set_recording`` of the port held against the JAX package's on the CPU.

The same seeded numpy inputs and weights go through both packages.
Elementwise cases agree at rtol/atol 1e-5; the small network (a
convolution, training-mode BatchNorm, relu, pooling and a Dense layer,
batch 4 of 3x8x8) compares its second-order parameter gradients within
1e-4 of the largest over all parameters (the convolution's bias, ahead
of BatchNorm, has a true gradient of 0 and gets f32 noise of ~1e-11 in
both packages).  Matmul precision is pinned: JAX to
"float32", torch to "highest".
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL, NET_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _x(shape=(3, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _pkgs():
    return ((tmx, lambda a: tmx.nd.array(a, ctx=tmx.cpu())),
            (jmx, lambda a: jmx.nd.array(a)))


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _first_order(pkg, wrap):
    x = wrap(_x())
    x.attach_grad()
    with pkg.autograd.record():
        y = x * x * x + pkg.nd.sin(x)
    head = wrap(_x(seed=1))
    (g,) = pkg.autograd.grad(y, [x], head_grads=head, retain_graph=True)
    return [g.asnumpy(), x.grad.asnumpy()]


def test_grad_first_order_matches_jax_and_leaves_buffers():
    got, want = (_first_order(*p) for p in _pkgs())
    _close(got, want)
    np.testing.assert_allclose(got[0], (3 * _x() ** 2 + np.cos(_x()))
                               * _x(seed=1), rtol=1e-5)
    assert not got[1].any()      # the gradient buffer stays zero


def _second_order(pkg, wrap):
    x = wrap(_x())
    x.attach_grad()
    with pkg.autograd.record():
        y = (x * x * x + pkg.nd.sin(x)).sum()
        (gx,) = pkg.autograd.grad(y, [x], create_graph=True)
        z = (gx * gx).sum()
    z.backward()
    return [gx.asnumpy(), x.grad.asnumpy()]


def test_grad_create_graph_second_derivative_matches_jax():
    got, want = (_second_order(*p) for p in _pkgs())
    _close(got, want)
    x = _x()
    d1 = 3 * x ** 2 + np.cos(x)
    np.testing.assert_allclose(got[1], 2 * d1 * (6 * x - np.sin(x)),
                               rtol=1e-5, atol=1e-5)


def _mixed(pkg, wrap):
    a, b = wrap(_x()), wrap(_x(seed=1))
    a.attach_grad()
    b.attach_grad()
    with pkg.autograd.record():
        y = (a * b * b + pkg.nd.exp(a * 0.5)).sum()
        ga, gb = pkg.autograd.grad(y, [a, b], create_graph=True)
        z = (ga * gb).sum()
    z.backward()
    return [ga.asnumpy(), gb.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()]


def test_mixed_partials_match_jax():
    _close(*(_mixed(*p) for p in _pkgs()))


def test_grad_needs_attached_variables():
    x = tmx.nd.array(_x(), ctx=tmx.cpu())
    with tmx.autograd.record():
        y = x * 2
    with pytest.raises(MXNetError, match="attach_grad"):
        tmx.autograd.grad(y, [x])


def test_unreached_variable_gets_zeros():
    a, b = (tmx.nd.array(_x(seed=s), ctx=tmx.cpu()) for s in (0, 1))
    a.attach_grad()
    b.attach_grad()
    with tmx.autograd.record():
        y = (a * 3).sum()
    ga, gb = tmx.autograd.grad(y, [a, b])
    np.testing.assert_allclose(ga.asnumpy(), np.full((3, 4), 3.0))
    assert gb.shape == (3, 4) and not gb.asnumpy().any()


def test_set_recording():
    assert not tmx.autograd.is_recording()
    assert tmx.autograd.set_recording(True) is False
    try:
        assert tmx.autograd.is_recording()
        x = tmx.nd.array(_x(), ctx=tmx.cpu())
        x.attach_grad()
        y = (x * x).sum()
    finally:
        assert tmx.autograd.set_recording(False) is True
    y.backward()
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * _x(), rtol=1e-6)


# ---------------------------------------------------------------------------
# Function
# ---------------------------------------------------------------------------

def _sigmoid_fn(pkg, wrap):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + pkg.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = wrap(_x())
    x.attach_grad()
    f = Sigmoid()
    with pkg.autograd.record():
        y = f(x)
        z = (y * wrap(_x(seed=2))).sum()
    z.backward()
    return [y.asnumpy(), x.grad.asnumpy(), f(x).asnumpy()]


def test_function_matches_jax():
    got, want = (_sigmoid_fn(*p) for p in _pkgs())
    _close(got, want)
    sig = 1 / (1 + np.exp(-_x()))
    np.testing.assert_allclose(got[1], sig * (1 - sig) * _x(seed=2),
                               rtol=1e-5, atol=1e-6)


def _two_outputs(pkg, wrap):
    class SplitScale(pkg.autograd.Function):
        def forward(self, a, b):
            self.save_for_backward(a, b)
            return a * b, a + 2 * b

        def backward(self, d1, d2):
            a, b = self.saved_tensors
            return d1 * b + d2, d1 * a + 2 * d2

    a, b = wrap(_x()), wrap(_x(seed=1))
    a.attach_grad()
    b.attach_grad()
    with pkg.autograd.record():
        p, q = SplitScale()(a, b)
        z = (p * 3 + q * q).sum()
    z.backward()
    return [p.asnumpy(), q.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()]


def test_function_with_two_inputs_and_outputs_matches_jax():
    _close(*(_two_outputs(*p) for p in _pkgs()))


# ---------------------------------------------------------------------------
# second order through a small network
# ---------------------------------------------------------------------------

def _small_net(pkg):
    nn = pkg.gluon.nn
    with pkg.name.NameManager():
        net = nn.HybridSequential()
        net.add(nn.Conv2D(6, 3, padding=1, in_channels=3),
                nn.BatchNorm(in_channels=6), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(5, in_units=6))
    return net


def _net_second_order(pkg, wrap, ctx, weights):
    net = _small_net(pkg)
    net.initialize(pkg.init.Zero(), ctx=ctx)
    for name, p in net.collect_params().items():
        p.set_data(wrap(weights[name]))
    x = wrap(_x((4, 3, 8, 8), 3))
    x.attach_grad()
    y = wrap(np.array([0, 3, 1, 4], np.float32))
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    with pkg.autograd.record():
        loss = loss_fn(net(x), y).sum()
        (gx,) = pkg.autograd.grad(loss, [x], create_graph=True)
        penalty = (gx * gx).sum()
    penalty.backward()
    return {n: p.grad().asnumpy() for n, p in net.collect_params().items()
            if p.grad_req != "null"}


def test_double_backward_through_a_small_net_matches_jax():
    net = _small_net(tmx)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    net(tmx.nd.array(np.zeros((1, 3, 8, 8), np.float32), ctx=tmx.cpu()))
    rng = np.random.RandomState(5)
    weights = {n: (rng.randn(*p.shape) * 0.3 + (1.0 if n.endswith(
        ("gamma", "running_var")) else 0.0)).astype(np.float32)
        for n, p in net.collect_params().items()}
    weights = {n: np.abs(w) if n.endswith("running_var") else w
               for n, w in weights.items()}
    got = _net_second_order(tmx, lambda a: tmx.nd.array(a, ctx=tmx.cpu()),
                            tmx.cpu(), weights)
    want = _net_second_order(jmx, jmx.nd.array, jmx.cpu(), weights)
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name in got:
        assert np.isfinite(got[name]).all()
        err = np.abs(got[name] - want[name]).max() / scale
        assert err <= NET_REL, (name, err)
