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


def test_kvstore_types(monkeypatch):
    """The factory takes what the JAX package's takes, with the same
    result: the local types, and a ``dist*`` type without a parameter
    server, are single-process stores of that type (rank 0 of 1)."""
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    for name in ("local", "device", "nccl", "local_allreduce_cpu",
                 "local_allreduce_device", "dist_sync", "dist_async",
                 "dist_device_sync"):
        t, j = tmx.kv.create(name), jmx.kv.create(name)
        assert (t.type, t.rank, t.num_workers) == \
            (j.type, j.rank, j.num_workers) == (name, 0, 1)
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    with pytest.raises(MXNetError, match="not ported"):
        tmx.kv.create("dist_sync")
    for mx in (tmx, jmx):
        with pytest.raises(mx.base.MXNetError, match="unknown"):
            mx.kv.create("nope")


def _dense_steps(mx, nd, kvstore, steps=3):
    """Dense(3, in_units=5) from the same numpy weights, ``steps`` steps
    of sgd (momentum 0.9, wd 1e-3) on softmax cross-entropy through a
    Trainer on ``kvstore``; returns (update_on_kvstore, params)."""
    rng = np.random.RandomState(11)
    w0 = {"weight": rng.randn(3, 5).astype(np.float32),
          "bias": rng.randn(3).astype(np.float32)}
    net = mx.gluon.nn.Dense(3, in_units=5)
    kw = {"ctx": tmx.cpu()} if mx is tmx else {}
    net.initialize(**kw)
    for p in net.collect_params().values():
        p.set_data(nd(w0[p.name.rsplit("_", 1)[1]]))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-3}, kvstore=kvstore)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    for _ in range(steps):
        x = nd(rng.randn(4, 5).astype(np.float32))
        y = nd(rng.randint(0, 3, 4).astype(np.float32))
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(4)
    return trainer._update_on_kvstore, {
        p.name.rsplit("_", 1)[1]: p.data().asnumpy()
        for p in net.collect_params().values()}


def test_trainer_on_dist_sync_without_server_matches_jax(monkeypatch):
    """``kvstore="dist_sync"`` on one process trains through a
    single-process store with update_on_kvstore (the JAX package's
    default for ``dist*``), to the JAX package's params within 1e-6."""
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    on_kv_t, t = _dense_steps(tmx, _t, "dist_sync")
    on_kv_j, j = _dense_steps(jmx, _j, "dist_sync")
    assert on_kv_t is True and on_kv_j is True
    for name in ("weight", "bias"):
        np.testing.assert_allclose(t[name], j[name], rtol=0, atol=1e-6)


class _Schedule:
    """A small lr scheduler: base_lr halved every two updates."""

    def __init__(self):
        self.base_lr = None

    def __call__(self, num_update):
        return self.base_lr * 0.5 ** (num_update // 2)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_optimizer_keywords_and_update_counts_match_jax(dtype):
    """The JAX constructor's keywords (multi_precision, lazy_update,
    begin_num_update, param_idx2name, lr_scheduler): num_update and each
    index's count after N updates, the scheduler's lr sequence, the
    weights (f16 through an f32 master copy) and the name-based wd_mult,
    equal to the JAX package's."""
    rng = np.random.RandomState(2)
    w0 = [rng.randn(6).astype(dtype) for _ in range(2)]
    gs = [[rng.randn(6).astype(dtype) for _ in range(2)] for _ in range(5)]
    out = []
    for mx, nd in ((tmx, _t), (jmx, _j)):
        opt = mx.optimizer.create(
            "sgd", learning_rate=0.2, momentum=0.9, wd=0.01,
            multi_precision=True, lazy_update=True, begin_num_update=3,
            param_idx2name={0: "fc_weight", 1: "fc_bias"},
            lr_scheduler=_Schedule())
        upd = mx.optimizer.get_updater(opt)
        ws = [nd(w) for w in w0]
        lrs, counts = [], []
        for step in gs:
            for i, g in enumerate(step):
                upd(i, nd(g), ws[i])
                lrs.append(opt._get_lr(i))
                counts.append(opt.num_update)
        with pytest.raises(mx.base.MXNetError, match="LRScheduler"):
            opt.set_learning_rate(0.5)
        out.append((lrs, counts, dict(opt._index_update_count),
                    opt.begin_num_update, opt.lazy_update, opt.wd_mult,
                    [w.asnumpy() for w in ws]))
    (tl, tc, ti, tb, tz, twd, tw), (jl, jc, ji, jb, jz, jwd, jw) = out
    assert tc == jc and tc[-1] == 3 + 5 and ti == ji == {0: 8, 1: 8}
    np.testing.assert_allclose(tl, jl, rtol=1e-7)
    assert (tb, tz, twd) == (jb, jz, jwd) == (3, True, {"fc_bias": 0.0})
    for a, b in zip(tw, jw):
        assert a.dtype == b.dtype == np.dtype(dtype)
        np.testing.assert_allclose(a.astype(np.float32),
                                   b.astype(np.float32), rtol=1e-6,
                                   atol=1e-7)


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
