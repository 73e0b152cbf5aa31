"""The port's custom operators (mxnet_tpu_torch.operator: CustomOp,
CustomOpProp, register, mx.nd.Custom, mx.sym.Custom) held against the JAX
package's on the CPU: each case of tests/test_custom_op.py run through
both packages on the same numpy inputs and weights, then upstream's
custom_softmax loss head in the Executor (against SoftmaxOutput too),
auxiliary states eagerly and in a compiled block, and the infer_shape /
infer_type contract.  The port's compiled path (hybridize, the Executor)
runs with ``aot_eager`` (``jit._BACKEND``), as the other CPU suites do;
the Custom call is the ``mxnet_tpu_torch::custom`` op there.  JAX at
``default_matmul_precision("float32")``, torch at ``"highest"``;
tolerance rtol 1e-5, atol 1e-6."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6
PKGS = {"jax": jmx, "torch": tmx}
SEEN = []   # devices of the arrays the port's user forward received


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"), tmx.cpu():
        yield
    torch.set_float32_matmul_precision(prev)


def _register(mx):
    """tests/test_custom_op.py's three ops, upstream's custom_softmax and
    an op with an auxiliary state, written against ``mx``'s API and
    registered in its registry."""

    @mx.operator.register("sqr_t")
    class SqrProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Sqr()

    class Sqr(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            if mx is tmx:
                SEEN.append(in_data[0]._data.device.type)
            self.assign(out_data[0], req[0], in_data[0] * in_data[0])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])

    @mx.operator.register("mult_t")
    class MultProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["lhs", "rhs"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Mult()

    class Mult(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0] * in_data[1])

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], in_data[1] * out_grad[0])
            self.assign(in_grad[1], req[1], in_data[0] * out_grad[0])

    @mx.operator.register("no_input_op_t")
    class NoInputProp(mx.operator.CustomOpProp):
        def __init__(self, length, depth):
            super().__init__(need_top_grad=False)
            self.length = int(length)
            self.depth = int(depth)

        def list_arguments(self):
            return []

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [], [(self.length, self.depth)], []

        def infer_type(self, in_type):
            return [], [np.float32], []

        def create_operator(self, ctx, shapes, dtypes):
            return NoInputOp(self.length, self.depth)

    class NoInputOp(mx.operator.CustomOp):
        def __init__(self, length, depth):
            self.output = np.arange(length * depth, dtype=np.float32) \
                .reshape(length, depth)

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], mx.nd.array(self.output))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            pass

    # upstream example/numpy-ops/custom_softmax.py: softmax forward,
    # p - onehot(label) backward, no top gradient
    @mx.operator.register("softmax_t")
    class SoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            data_shape = in_shape[0]
            label_shape = (in_shape[0][0],)
            return [data_shape, label_shape], [data_shape], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()

    class Softmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            y = mx.nd.exp(x - x.max(axis=1, keepdims=True))
            y = y / y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1]
            y = out_data[0]
            onehot = mx.nd.one_hot(label, depth=y.shape[1])
            self.assign(in_grad[0], req[0], y - onehot)

    # an auxiliary state counting forward calls (written in place)
    @mx.operator.register("count_t")
    class CountProp(mx.operator.CustomOpProp):
        def list_arguments(self):
            return ["data"]

        def list_auxiliary_states(self):
            return ["calls"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], [(1,)]

        def create_operator(self, ctx, shapes, dtypes):
            return Count()

    class Count(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            aux[0][:] = aux[0] + 1
            self.assign(out_data[0], req[0], in_data[0] * 3.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 3.0)


for _pkg in PKGS.values():
    _register(_pkg)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", list(PKGS))
def test_forward_eager(name):
    mx = PKGS[name]
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    y = mx.nd.Custom(mx.nd.array(x), op_type="sqr_t")
    _close(y.asnumpy(), x ** 2)


def test_forward_eager_matches_jax_and_sees_device_arrays():
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    SEEN.clear()
    got = tmx.nd.Custom(tmx.nd.array(x), op_type="sqr_t").asnumpy()
    want = jmx.nd.Custom(jmx.nd.array(x), op_type="sqr_t").asnumpy()
    _close(got, want)
    # the user's forward got the input's own tensor, not a host copy
    assert SEEN == ["cpu"]


def _backward(mx, x):
    a = mx.nd.array(x)
    a.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(a, op_type="sqr_t")
        loss = y.sum()
    loss.backward()
    return y.asnumpy(), a.grad.asnumpy()


def test_backward():
    x = np.array([1.0, 2.0, 3.0], np.float32)
    got, want = _backward(tmx, x), _backward(jmx, x)
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[1], 2 * x)


def _two_inputs(mx, av, bv):
    a, b = mx.nd.array(av), mx.nd.array(bv)
    a.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(lhs=a, rhs=b, op_type="mult_t")
        y.backward()
    return y.asnumpy(), a.grad.asnumpy(), b.grad.asnumpy()


def test_two_inputs_kwargs():
    rng = np.random.RandomState(1)
    av, bv = rng.rand(3, 2).astype(np.float32), rng.rand(3, 2).astype(
        np.float32)
    got, want = _two_inputs(tmx, av, bv), _two_inputs(jmx, av, bv)
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[1], bv)
    _close(got[2], av)


def test_no_input():
    got = tmx.nd.Custom(length=4, depth=3, op_type="no_input_op_t")
    want = jmx.nd.Custom(length=4, depth=3, op_type="no_input_op_t")
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    np.testing.assert_array_equal(
        got.asnumpy(), np.arange(12, dtype=np.float32).reshape(4, 3))
    assert got.context == tmx.cpu()


def _hybrid_train(mx, w, b, x, steps=5):
    class Net(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = mx.gluon.nn.Dense(2, in_units=3)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="sqr_t")

    net = Net()
    net.initialize()
    net.dense.weight.set_data(mx.nd.array(w))
    net.dense.bias.set_data(mx.nd.array(b))
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    xs = mx.nd.array(x)
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = net(xs).sum()
        loss.backward()
        trainer.step(4)
        losses.append(float(loss.asscalar()))
    return losses, net.dense.weight.data().asnumpy()


def test_custom_in_hybrid_block_trains():
    """A Custom op training inside a hybridized block: the port's
    compiled graph holds the mxnet_tpu_torch::custom op."""
    rng = np.random.RandomState(2)
    w = rng.uniform(-0.5, 0.5, (2, 3)).astype(np.float32)
    b = np.zeros(2, np.float32)
    x = rng.rand(4, 3).astype(np.float32)
    got, gw = _hybrid_train(tmx, w, b, x)
    want, ww = _hybrid_train(jmx, w, b, x)
    _close(got, want)
    _close(gw, ww)
    assert got[-1] < got[0]


def test_custom_in_hybrid_block_matches_eager():
    """The compiled call and the eager call give the same values and
    gradients (the port's block, hybridized against not)."""
    rng = np.random.RandomState(3)
    w = rng.uniform(-0.5, 0.5, (2, 3)).astype(np.float32)
    b = rng.rand(2).astype(np.float32)
    x = rng.rand(4, 3).astype(np.float32)
    outs = []
    for hybrid in (False, True):
        net = tmx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(tmx.gluon.nn.Dense(2, in_units=3))
        net.initialize()
        net[0].weight.set_data(tmx.nd.array(w))
        net[0].bias.set_data(tmx.nd.array(b))
        if hybrid:
            net.hybridize()
        xs = tmx.nd.array(x)
        with tmx.autograd.record():
            y = tmx.nd.Custom(net(xs), op_type="sqr_t")
            y.backward()
        outs.append((y.asnumpy(), net[0].weight.grad().asnumpy()))
    for e, h in zip(*outs):
        _close(h, e)


def _softmax_block(mx, w, x, label, hybrid):
    """Dense then the custom_softmax head inside one block: its outputs
    and the Dense weight's gradient."""
    class Head(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.fc = mx.gluon.nn.Dense(w.shape[0], in_units=w.shape[1],
                                            use_bias=False)

        def hybrid_forward(self, F, x, label):
            return F.Custom(data=self.fc(x), label=label,
                            op_type="softmax_t")

    net = Head()
    net.initialize()
    net.fc.weight.set_data(mx.nd.array(w))
    if hybrid:
        net.hybridize()
    with mx.autograd.record():
        y = net(mx.nd.array(x), mx.nd.array(label))
    y.backward()
    return y.asnumpy(), net.fc.weight.grad().asnumpy()


def test_custom_softmax_block_on_inductor(monkeypatch):
    """The default backend (inductor) compiles the block that holds the
    mxnet_tpu_torch::custom op and its backward: the same outputs and
    gradient as the block run eagerly and as the JAX package's
    hybridized block."""
    monkeypatch.setattr(tmx.jit, "_BACKEND", None)
    rng = np.random.RandomState(5)
    w = (rng.randn(4, 5) * 0.5).astype(np.float32)
    x = rng.randn(6, 5).astype(np.float32)
    label = rng.randint(0, 4, 6).astype(np.float32)
    got = _softmax_block(tmx, w, x, label, hybrid=True)
    eager = _softmax_block(tmx, w, x, label, hybrid=False)
    want = _softmax_block(jmx, w, x, label, hybrid=True)
    for g, e, wv in zip(got, eager, want):
        _close(g, e)
        _close(g, wv)


def _executor(mx, x):
    data = mx.sym.var("data")
    out = mx.sym.Custom(data=data, op_type="sqr_t", name="sqr")
    gx = mx.nd.array(np.zeros(x.shape, np.float32))
    ex = out.bind(mx.cpu(), args={"data": mx.nd.array(x)},
                  args_grad={"data": gx})
    y = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(mx.nd.array(np.ones(x.shape, np.float32)))
    return y, gx.asnumpy()


def test_custom_symbol_executor():
    x = np.array([2.0, 3.0], np.float32)
    got, want = _executor(tmx, x), _executor(jmx, x)
    for g, w in zip(got, want):
        _close(g, w)
    _close(got[0], [4.0, 9.0])
    _close(got[1], [4.0, 6.0])


def _softmax_head(mx, op, x, label, w):
    s = mx.sym
    fc = s.FullyConnected(s.var("data"), num_hidden=w.shape[0],
                          no_bias=True, name="fc")
    if op == "custom":
        out = s.Custom(data=fc, label=s.var("softmax_label"),
                       op_type="softmax_t", name="softmax")
    else:
        out = s.SoftmaxOutput(fc, s.var("softmax_label"), name="softmax")
    gw = mx.nd.array(np.zeros(w.shape, np.float32))
    ex = out.bind(mx.cpu(), args={"data": mx.nd.array(x),
                                  "softmax_label": mx.nd.array(label),
                                  "fc_weight": mx.nd.array(w)},
                  args_grad={"fc_weight": gw},
                  grad_req={"data": "null", "softmax_label": "null",
                            "fc_weight": "write"})
    p = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    return p, gw.asnumpy()


def test_custom_softmax_head_in_the_executor():
    """Upstream's custom_softmax as a loss head in the Executor: the same
    probabilities and weight gradient as the JAX package's, and as
    SoftmaxOutput's."""
    rng = np.random.RandomState(4)
    x = rng.randn(6, 5).astype(np.float32)
    w = (rng.randn(4, 5) * 0.5).astype(np.float32)
    label = rng.randint(0, 4, 6).astype(np.float32)
    got = _softmax_head(tmx, "custom", x, label, w)
    want = _softmax_head(jmx, "custom", x, label, w)
    ref = _softmax_head(tmx, "softmax_output", x, label, w)
    for g, wv, r in zip(got, want, ref):
        _close(g, wv)
        _close(g, r)


def test_aux_state_written_eagerly_and_warned_when_traced():
    x = np.arange(4, dtype=np.float32)
    for mx in (tmx, jmx):
        calls = mx.nd.array(np.zeros(1, np.float32))
        y = mx.nd.Custom(mx.nd.array(x), calls, op_type="count_t")
        y = mx.nd.Custom(mx.nd.array(x), calls=calls, op_type="count_t")
        _close(y.asnumpy(), x * 3)
        assert calls.asnumpy().tolist() == [2.0]
    data = tmx.sym.var("data")
    out = tmx.sym.Custom(data=data, calls=tmx.sym.var("calls"),
                         op_type="count_t")
    # a symbol's Custom aux state is one of its arguments, as in the JAX
    # package
    assert out.list_arguments() == ["data", "calls"]
    with pytest.warns(RuntimeWarning, match="auxiliary-state mutations"):
        ex = out.bind(tmx.cpu(), args={"data": tmx.nd.array(x),
                                       "calls": tmx.nd.array(np.zeros(1))},
                      grad_req="null")
        y = ex.forward()[0]
    _close(y.asnumpy(), x * 3)


def test_contract_checks():
    x = tmx.nd.array(np.ones((2, 2), np.float32))
    with pytest.raises(MXNetError, match="not registered"):
        tmx.nd.Custom(x, op_type="no_such_op_t")
    with pytest.raises(MXNetError, match="requires op_type"):
        tmx.nd.Custom(x)
    with pytest.raises(MXNetError, match="missing inputs"):
        tmx.nd.Custom(op_type="mult_t", lhs=x)
    with pytest.raises(MXNetError, match="unmatched inputs"):
        tmx.nd.Custom(x, x, x, op_type="mult_t")
    with pytest.raises(MXNetError, match="subclass of CustomOpProp"):
        tmx.operator.register("bad_t")(object)
    assert tmx.operator.get_prop_cls("sqr_t").__name__ == "SqrProp"
    # shape inference answers from the prop, through both packages
    for mx in (tmx, jmx):
        s = mx.sym.Custom(data=mx.sym.var("data"), op_type="sqr_t")
        assert s.infer_shape(data=(3, 7))[1] == [(3, 7)]
    prop = tmx.operator.CustomOpProp()
    jprop = jmx.operator.CustomOpProp()
    assert prop.declare_backward_dependency([1], [2], [3]) == \
        jprop.declare_backward_dependency([1], [2], [3])
    assert prop.infer_storage_type(["default"]) == \
        jprop.infer_storage_type(["default"])
