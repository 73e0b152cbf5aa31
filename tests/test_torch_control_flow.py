"""The port's control flow (``mx.nd.contrib`` and ``mx.sym.contrib``
foreach, while_loop and cond) held against the JAX package's on the
CPU: each case runs in both packages on the same numpy inputs (a seed),
eagerly (a Python loop over taped ops in both) and inside a hybridized
block (the port's compiled graph, with ``aot_eager``: foreach unrolled,
while_loop as the masked loop of ``max_iterations`` steps, cond as a
``torch.where`` over both branches; JAX's lax.scan and lax.cond), with
outputs, padding rows and gradients compared; the graph ops ``_foreach``,
``_while_loop`` and ``_cond`` run through an ``Executor`` (forward and
gradients).  rtol 1e-5, atol 1e-6."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _nd(pkg, a):
    a = np.asarray(a, np.float32)
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _close(a, b):
    a = a.asnumpy() if hasattr(a, "asnumpy") else a
    b = b.asnumpy() if hasattr(b, "asnumpy") else b
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _both(fn):
    return fn(tmx), fn(jmx)


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_foreach_simple():
    def run(pkg):
        step = lambda data, states: (data + states[0],  # noqa: E731
                                     [states[0] * 2])
        data = _nd(pkg, np.arange(8).reshape(4, 2))
        outs, final = pkg.nd.contrib.foreach(step, data,
                                             [_nd(pkg, np.ones(2))])
        return outs.asnumpy(), final[0].asnumpy()

    got, want = _both(run)
    expect = np.arange(8).reshape(4, 2) + np.array([[1], [2], [4], [8]])
    _close(got[0], expect)
    _close(got[1], np.full(2, 16.0))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_foreach_list_data_and_grad():
    d1v, d2v = _rand(3, 4, seed=1), _rand(3, 4, seed=2)

    def run(pkg):
        d1, d2 = _nd(pkg, d1v), _nd(pkg, d2v)
        d1.attach_grad()

        def step(eles, states):
            a, b = eles
            new_s = states[0] + a * b
            return [a + new_s, new_s * 2], [new_s]

        with pkg.autograd.record():
            outs, final = pkg.nd.contrib.foreach(step, [d1, d2],
                                                 [_nd(pkg, np.zeros(4))])
            loss = outs[0].sum() + (outs[1] * final[0]).sum()
        loss.backward()
        return [o.asnumpy() for o in outs], d1.grad.asnumpy()

    got, want = _both(run)
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    _close(got[1], want[1])


def test_foreach_zero_length():
    def run(pkg):
        outs, final = pkg.nd.contrib.foreach(
            lambda d, s: (d * 2, [s[0] + d]), _nd(pkg, np.zeros((0, 3))),
            [_nd(pkg, np.ones(3))])
        return outs.shape, final[0].asnumpy()

    got, want = _both(run)
    assert got[0] == want[0] == (0, 3)
    _close(got[1], want[1])


def _hybrid_foreach(pkg):
    class Net(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x, s0):
            out, states = F.contrib.foreach(
                lambda d, s: (d * 2 + s[0] * d, [s[0] + d]), x, [s0])
            return out, states[0]

    return Net()


def _run_hybrid(pkg, make, inputs, hybridize):
    net = make(pkg)
    if hybridize:
        net.hybridize()
    arrs = [_nd(pkg, a) for a in inputs]
    for a in arrs:
        a.attach_grad()
    with pkg.autograd.record():
        out = net(*arrs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        loss = sum((o * (i + 1)).sum() for i, o in enumerate(outs))
    loss.backward()
    res = [o.asnumpy() for o in outs] + [a.grad.asnumpy() for a in arrs]
    if hybridize and pkg is tmx:
        assert len(net._cached_op._compiled) == 1
    return res


@pytest.mark.parametrize("hybridize", [False, True])
def test_foreach_in_hybrid_block(hybridize):
    inputs = [_rand(4, 3, seed=3), _rand(3, seed=4)]
    got = _run_hybrid(tmx, _hybrid_foreach, inputs, hybridize)
    want = _run_hybrid(jmx, _hybrid_foreach, inputs, hybridize)
    for g, w in zip(got, want):
        _close(g, w)


def test_while_loop_simple():
    def run(pkg):
        cond = lambda i, s: i <= 5  # noqa: E731
        func = lambda i, s: ([i + s], [i + 1, s + i])  # noqa: E731
        loop_vars = (_nd(pkg, [0]), _nd(pkg, [1]))
        outputs, states = pkg.nd.contrib.while_loop(cond, func, loop_vars,
                                                    max_iterations=10)
        return outputs[0].asnumpy(), [s.asnumpy() for s in states]

    got, want = _both(run)
    np.testing.assert_array_equal(got[0][:6, 0], [1, 2, 4, 7, 11, 16])
    assert got[0].shape == (10, 1)
    np.testing.assert_array_equal(got[0][6:], 0)   # zero padding
    _close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        _close(g, w)


def test_while_loop_grad():
    def run(pkg):
        x = _nd(pkg, [2.0])
        x.attach_grad()

        def func(i, acc):
            return None, [i + 1, acc * x]

        with pkg.autograd.record():
            _, states = pkg.nd.contrib.while_loop(
                lambda i, acc: i < 3, func,
                [_nd(pkg, [0.0]), _nd(pkg, [1.0])], max_iterations=5)
            loss = states[1].sum()
        loss.backward()
        return x.grad.asnumpy()

    got, want = _both(run)
    _close(got, [12.0])   # acc = x^3
    _close(got, want)


def _hybrid_while(pkg):
    class Net(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, x, limit):
            outs, (i, acc) = F.contrib.while_loop(
                lambda i, acc: i < limit,
                lambda i, acc: ([acc * x], [i + 1, acc * x + 1]),
                [F.zeros_like(limit), F.ones_like(x)], max_iterations=6)
            return outs[0], acc

    return Net()


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("limit", [3.0, 9.0])
def test_while_loop_in_hybrid_block(hybridize, limit):
    """The compiled path runs the masked loop: rows past the stop are
    zeros and the loop variables keep their last values, as the JAX
    package's masked scan gives; ``limit`` 9 runs into max_iterations."""
    inputs = [_rand(2, seed=5) + 0.5, np.array([limit], np.float32)]
    got = _run_hybrid(tmx, _hybrid_while, inputs, hybridize)
    want = _run_hybrid(jmx, _hybrid_while, inputs, hybridize)
    assert got[0].shape == (6, 2)
    for g, w in zip(got, want):
        _close(g, w)


def test_cond_eager():
    def run(pkg):
        x, y = _nd(pkg, [1.0, 2.0]), _nd(pkg, [3.0, 4.0])
        x.attach_grad()
        outs = []
        for p in (1.0, 0.0):
            with pkg.autograd.record():
                out = pkg.nd.contrib.cond(_nd(pkg, [p]), lambda: x * y,
                                          lambda: x - y)
            out.backward()
            outs += [out.asnumpy(), x.grad.asnumpy().copy()]
        return outs

    got, want = _both(run)
    _close(got[0], [3.0, 8.0])
    _close(got[2], [-2.0, -2.0])
    for g, w in zip(got, want):
        _close(g, w)


def _hybrid_cond(pkg):
    class Net(pkg.gluon.HybridBlock):
        def hybrid_forward(self, F, p, a, b):
            return F.contrib.cond(p, lambda: [a * 2, a * b],
                                  lambda: [b * 3, a - b])

    return Net()


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("pred", [1.0, 0.0])
def test_cond_in_hybrid_block(hybridize, pred):
    inputs = [np.array([pred], np.float32), _rand(3, seed=6),
              _rand(3, seed=7)]
    got = _run_hybrid(tmx, _hybrid_cond, inputs, hybridize)
    want = _run_hybrid(jmx, _hybrid_cond, inputs, hybridize)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        _close(g, w)


def _bind_run(pkg, sym, args, grad_names=()):
    ctx = tmx.cpu() if pkg is tmx else jmx.cpu()
    arrs = {k: _nd(pkg, v) for k, v in args.items()}
    grads = {k: _nd(pkg, np.zeros_like(args[k])) for k in grad_names}
    ex = sym.bind(ctx=ctx, args=arrs, args_grad=grads or None,
                  grad_req={k: "write" if k in grad_names else "null"
                            for k in args})
    outs = ex.forward(is_train=bool(grad_names))
    res = [o.asnumpy() for o in outs]
    if grad_names:
        ex.backward([_nd(pkg, np.ones_like(o)) for o in res])
        res += [ex.grad_dict[k].asnumpy() for k in grad_names]
    return res


def test_sym_foreach_executor():
    def run(pkg):
        data, init, w = (pkg.sym.var(n) for n in ("data", "init", "w"))
        outs, states = pkg.sym.contrib.foreach(
            lambda d, s: (d * w + s[0], [s[0] + d]), data, [init])
        return _bind_run(pkg, pkg.sym.Group([outs * 2, states[0]]),
                         {"data": _rand(3, 2, seed=8),
                          "init": _rand(2, seed=9), "w": _rand(2, seed=10)},
                         grad_names=("data", "w"))

    got, want = _both(run)
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("start", [0.0, 5.0])
def test_sym_while_loop_executor(start):
    def run(pkg):
        v, k = pkg.sym.var("v"), pkg.sym.var("k")
        outs, final = pkg.sym.contrib.while_loop(
            cond=lambda i, acc: i < 4,
            func=lambda i, acc: ([acc * k], [i + 1, acc + i * k]),
            loop_vars=[v, pkg.sym.ones((1,))], max_iterations=8)
        return _bind_run(pkg, pkg.sym.Group([outs[0], final[1]]),
                         {"v": np.array([start], np.float32),
                          "k": np.array([1.5], np.float32)},
                         grad_names=("k",))

    got, want = _both(run)
    assert got[0].shape == (8, 1)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("p", [2.0, -2.0])
def test_sym_cond_executor(p):
    def run(pkg):
        ps, a = pkg.sym.var("p"), pkg.sym.var("a")
        out = pkg.sym.contrib.cond(ps > 0, lambda: a * a, lambda: a - 1)
        return _bind_run(pkg, out, {"p": np.array([p], np.float32),
                                    "a": np.array([5.0], np.float32)},
                         grad_names=("a",))

    got, want = _both(run)
    for g, w in zip(got, want):
        _close(g, w)


def test_foreach_capture_grad():
    def run(pkg):
        w = _nd(pkg, [3.0])
        w.attach_grad()
        with pkg.autograd.record():
            outs, _ = pkg.nd.contrib.foreach(
                lambda d, s: (d * w, [s[0]]), _nd(pkg, np.ones((4, 1))),
                [_nd(pkg, np.zeros(1))])
            loss = outs.sum()
        loss.backward()
        return w.grad.asnumpy()

    got, want = _both(run)
    _close(got, [4.0])
    _close(got, want)


def test_contrib_namespaces():
    assert tmx.nd.contrib.foreach is tmx.ops.control_flow.foreach
    assert tmx.sym.contrib.while_loop is tmx.ops.control_flow.sym_while_loop
    for short in ("BilinearResize2D", "conv_bn_relu", "add_act",
                  "act_scale_add", "layer_norm_fused", "norm_act"):
        assert hasattr(tmx.nd.contrib, short)
        assert hasattr(tmx.sym.contrib, "_contrib_" + short)
