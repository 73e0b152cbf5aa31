"""The port's core modules held against the JAX package on CPU: context,
NDArray + autograd, initializer, the slice's layers and ops, loss, SGD,
kvstore and weight conversion.  Inputs come from numpy with a seed and go
to both packages; f32 tolerances are rtol 1e-5 unless a test says why."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError


def _t(a):
    return tmx.nd.array(a, ctx=tmx.cpu())


def _j(a):
    return jmx.nd.array(a)


def test_default_context_is_gpu_and_never_falls_back():
    assert tmx.current_context() == tmx.gpu(0)
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        assert tmx.nd.zeros((2,)).context == tmx.cpu()
    if torch.cuda.is_available():
        assert tmx.nd.zeros((2,)).context == tmx.gpu(0)
    else:
        with pytest.raises(MXNetError, match="CUDA is not available"):
            tmx.nd.zeros((2,))


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_attach_grad_backward_matches_jax(grad_req):
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    grads = []
    for mx, nd in ((tmx, _t), (jmx, _j)):
        a = nd(x)
        a.attach_grad(grad_req=grad_req)
        for _ in range(2):
            with mx.autograd.record():
                y = a * a + a * 2.0
            y.backward()
        grads.append(a.grad.asnumpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6)
    scale = 2.0 if grad_req == "add" else 1.0
    np.testing.assert_allclose(grads[0], scale * (2 * x + 2), rtol=1e-6)


def test_ops_outside_record_build_no_graph():
    a = _t(np.ones((2, 2), np.float32))
    a.attach_grad()
    assert not (a * 3.0)._data.requires_grad
    with tmx.autograd.record():
        with tmx.autograd.pause():
            assert not (a * 3.0)._data.requires_grad
        assert (a * 3.0)._data.requires_grad


def test_inplace_add_keeps_buffer():
    a = _t(np.zeros(4, np.float32))
    buf = a._data
    a += _t(np.ones(4, np.float32))
    assert a._data is buf
    np.testing.assert_array_equal(a.asnumpy(), np.ones(4))


def test_xavier_bounds_and_seeded_stream():
    def draw():
        tmx.random.seed(7)
        p = tmx.gluon.Parameter("w_weight", shape=(64, 32, 3, 3))
        p.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        return p.data().asnumpy()

    a, b = draw(), draw()
    np.testing.assert_array_equal(a, b)
    bound = np.sqrt(3.0 / ((32 * 9 + 64 * 9) / 2.0))
    assert np.abs(a).max() <= bound and np.abs(a).max() > 0.9 * bound


@pytest.mark.parametrize("shape, kernel, stride, pad, conv, ptype", [
    ((2, 3, 9, 9), (3, 3), (2, 2), (1, 1), "valid", "max"),
    # 'full' on a size where torch's ceil mode would drop the last window
    ((1, 2, 5, 5), (2, 2), (2, 2), (1, 1), "full", "max"),
    ((2, 3, 7, 5), (3, 3), (2, 2), (0, 0), "full", "avg"),
    ((2, 4, 7, 7), (1, 1), (1, 1), (0, 0), "valid", "global_avg"),
])
def test_pooling_matches_jax(shape, kernel, stride, pad, conv, ptype):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    kw = dict(kernel=kernel, stride=stride, pad=pad, pooling_convention=conv,
              pool_type="avg" if ptype == "global_avg" else ptype,
              global_pool=ptype == "global_avg")
    t = tmx.nd.Pooling(_t(x), **kw).asnumpy()
    j = jmx.nd.Pooling(_j(x), **kw).asnumpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def _layer_pair(make_t, make_j, x):
    with tmx.name.NameManager():
        tl = make_t(tmx)
    with jmx.name.NameManager():
        jl = make_j(jmx)
    tl.initialize(ctx=tmx.cpu())
    jl.initialize()
    tl(_t(x))
    jl(_j(x))
    tmx.convert.load_from_numpy(tl, {n: p.data().asnumpy() for n, p in
                                     jl.collect_params().items()})
    return tl, jl


@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_conv_and_dense_forward_match_jax(layer):
    rng = np.random.RandomState(2)
    if layer == "conv":
        x = rng.randn(2, 3, 11, 11).astype(np.float32)

        def make(mx):
            return mx.gluon.nn.Conv2D(5, kernel_size=3, strides=2, padding=1)
    else:
        x = rng.randn(4, 3, 2, 2).astype(np.float32)

        def make(mx):
            return mx.gluon.nn.Dense(7, activation="relu")
    tl, jl = _layer_pair(make, make, x)
    assert list(tl.collect_params().keys()) == \
        list(jl.collect_params().keys())
    with jax.default_matmul_precision("float32"):
        j = jl(_j(x)).asnumpy()
    np.testing.assert_allclose(tl(_t(x)).asnumpy(), j, rtol=1e-5, atol=1e-6)


def test_hybridize_runs_eagerly_with_same_result():
    x = np.random.RandomState(6).randn(2, 3).astype(np.float32)
    seq = tmx.gluon.nn.HybridSequential()
    seq.add(tmx.gluon.nn.Dense(4),
            tmx.gluon.nn.HybridLambda(lambda F, v: F.relu(v) * 2.0),
            tmx.gluon.nn.HybridLambda("relu"))
    seq.initialize(ctx=tmx.cpu())
    before = seq(_t(x)).asnumpy()
    seq.hybridize()
    np.testing.assert_array_equal(seq(_t(x)).asnumpy(), before)
    w = seq[0].weight.data().asnumpy()
    np.testing.assert_allclose(before, 2 * np.maximum(x @ w.T, 0),
                               rtol=1e-5, atol=1e-6)


def test_batchnorm_training_matches_jax():
    """Batch statistics with the biased variance, and the moving-stat
    update m * running + (1 - m) * batch, as the JAX layer."""
    x = (np.random.RandomState(3).randn(6, 4, 5, 5) * 3 + 1).astype(
        np.float32)

    def make(mx):
        return mx.gluon.nn.BatchNorm()
    tl, jl = _layer_pair(make, make, x)
    outs = []
    for mx, nd, layer in ((tmx, _t, tl), (jmx, _j, jl)):
        with mx.autograd.record():
            y = layer(nd(x))
        outs.append((y.asnumpy(), layer.running_mean.data().asnumpy(),
                     layer.running_var.data().asnumpy()))
    for t, j in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    var = x.transpose(1, 0, 2, 3).reshape(4, -1).var(axis=1)  # biased
    np.testing.assert_allclose(outs[0][2], 0.9 + 0.1 * var, rtol=1e-5)
    # inference uses the moving stats
    np.testing.assert_allclose(tl(_t(x)).asnumpy(), jl(_j(x)).asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_softmax_ce_loss_matches_jax():
    rng = np.random.RandomState(4)
    pred = rng.randn(5, 10).astype(np.float32)
    label = rng.randint(0, 10, 5).astype(np.float32)
    t = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(_t(pred), _t(label))
    j = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(_j(pred), _j(label))
    assert t.shape == (5,)
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-5)


@pytest.mark.parametrize("momentum, clip", [(0.0, None), (0.9, 0.3)])
def test_sgd_updates_match_jax(momentum, clip):
    """rescale -> clip -> + wd * w, then the (momentum) step."""
    rng = np.random.RandomState(5)
    w0 = rng.randn(20).astype(np.float32)
    gs = [rng.randn(20).astype(np.float32) for _ in range(3)]
    results = []
    for mx, nd in ((tmx, _t), (jmx, _j)):
        opt = mx.optimizer.create("sgd", learning_rate=0.1,
                                  momentum=momentum, wd=0.01,
                                  rescale_grad=0.5, clip_gradient=clip)
        upd = mx.optimizer.get_updater(opt)
        w = nd(w0)
        for g in gs:
            upd(0, nd(g), w)
        results.append(w.asnumpy())
    np.testing.assert_allclose(results[0], results[1], rtol=1e-6, atol=1e-7)


def test_kvstore_types():
    assert tmx.kv.create("device").type == "device"
    assert tmx.kv.create("local").type == "local"
    with pytest.raises(MXNetError, match="not ported"):
        tmx.kv.create("dist_sync")
    with pytest.raises(MXNetError, match="unknown"):
        tmx.kv.create("nope")


def test_load_from_numpy_rejects_mismatch():
    net = tmx.gluon.nn.Dense(3, in_units=2)
    net.initialize(ctx=tmx.cpu())
    good = {n: np.zeros(p.shape, np.float32)
            for n, p in net.collect_params().items()}
    tmx.convert.load_from_numpy(net, good)
    name = next(iter(good))
    with pytest.raises(MXNetError, match="missing"):
        tmx.convert.load_from_numpy(
            net, {k: v for k, v in good.items() if k != name})
    with pytest.raises(MXNetError, match="extra"):
        tmx.convert.load_from_numpy(net, dict(good, other=np.zeros(1)))
    with pytest.raises(MXNetError, match="shape"):
        tmx.convert.load_from_numpy(net, dict(good, **{
            name: np.zeros((9, 9), np.float32)}))
