"""The port's Module API (mxnet_tpu_torch.module, model, callback) held
against the JAX package's on the CPU: Module.fit for 5 updates with
score and predict, BucketingModule over two bucket keys,
SequentialModule, PythonLossModule, save_checkpoint read by the other
package's load_checkpoint (both ways), Speedometer and do_checkpoint.
Every run starts from the same seeded numpy weights in both packages;
the compiled path runs with ``aot_eager`` (``jit._BACKEND``).  JAX at
``default_matmul_precision("float32")``, torch at ``"highest"``;
parameters, outputs and scores agree within rtol 1e-5, atol 1e-6."""
import logging
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL, ATOL = 1e-5, 1e-6
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _ctx(pkg):
    return tmx.cpu() if pkg is tmx else jmx.cpu()


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _mlp(pkg, hidden=8, classes=4):
    s = pkg.sym
    with pkg.name.NameManager():
        net = s.FullyConnected(s.var("data"), num_hidden=hidden, name="fc1")
        net = s.Activation(net, act_type="tanh")
        net = s.FullyConnected(net, num_hidden=classes, name="fc2")
        return s.SoftmaxOutput(net, s.var("softmax_label"), name="softmax")


def _data(n=40, dim=6, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype(np.float32)
    y = rng.randint(0, classes, n).astype(np.float32)
    return x, y


def _iter(pkg, x, y, batch=8):
    if pkg is tmx:
        with tmx.cpu():
            return tmx.io.NDArrayIter(x, y, batch_size=batch,
                                      label_name="softmax_label")
    return jmx.io.NDArrayIter(x, y, batch_size=batch,
                              label_name="softmax_label")


def _weights(sym, shapes, seed=1):
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}


def _np(params):
    return {k: v.asnumpy() for k, v in params.items()}


def _assert_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _fit_mlp(pkg, num_epoch=1):
    x, y = _data()
    sym = _mlp(pkg)
    w = _weights(sym, {"data": (8, 6), "softmax_label": (8,)})
    mod = pkg.mod.Module(sym, context=_ctx(pkg))
    it = _iter(pkg, x, y)
    mod.fit(it, optimizer="sgd", optimizer_params=SGD, num_epoch=num_epoch,
            arg_params={k: _nd(pkg, v) for k, v in w.items()})
    return mod, it


def test_module_fit_score_predict_match_jax():
    res = []
    for pkg in (jmx, tmx):
        mod, it = _fit_mlp(pkg)      # 40 samples, batch 8: 5 updates
        arg, aux = mod.get_params()
        score = dict(mod.score(it, "acc"))
        ce = dict(mod.score(it, "ce"))
        pred = mod.predict(it).asnumpy()
        res.append((_np(arg), score, ce, pred, mod.output_shapes))
    _assert_dicts(res[1][0], res[0][0])
    assert res[1][1] == pytest.approx(res[0][1], rel=RTOL)
    assert res[1][2] == pytest.approx(res[0][2], rel=RTOL)
    np.testing.assert_allclose(res[1][3], res[0][3], rtol=RTOL, atol=ATOL)
    assert res[1][3].shape == (40, 4)
    assert res[1][4] == res[0][4] == [("softmax_output", (8, 4))]


def test_module_forward_backward_update_and_input_grads_match_jax():
    x, y = _data(n=8)
    res = []
    for pkg in (jmx, tmx):
        sym = _mlp(pkg)
        mod = pkg.mod.Module(sym, context=_ctx(pkg))
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("softmax_label", (8,))],
                 inputs_need_grad=True)
        w = _weights(sym, {"data": (8, 6), "softmax_label": (8,)})
        mod.init_params(arg_params={k: _nd(pkg, v) for k, v in w.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        batch = pkg.io.DataBatch([_nd(pkg, x)], [_nd(pkg, y)])
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        grads = mod.get_input_grads()[0].asnumpy()
        res.append((_np(mod.get_params()[0]), grads,
                    mod.get_outputs()[0].asnumpy()))
    _assert_dicts(res[1][0], res[0][0])
    for i in (1, 2):
        np.testing.assert_allclose(res[1][i], res[0][i], rtol=RTOL,
                                   atol=ATOL)


def _bucket_sym(pkg):
    def gen(key):
        s = pkg.sym
        data = s.var("data")
        net = s.mean(data, axis=1, keepdims=True)
        net = s.FullyConnected(net, num_hidden=3, name="fc")
        net = s.SoftmaxOutput(net, s.var("softmax_label"), name="softmax")
        return net, ("data",), ("softmax_label",)
    return gen


def test_bucketing_module_two_keys_matches_jax():
    rng = np.random.RandomState(4)
    batches = [(k, rng.randn(4, k).astype(np.float32),
                rng.randint(0, 3, 4).astype(np.float32))
               for k in (5, 3, 5, 3)]
    res = []
    for pkg in (jmx, tmx):
        mod = pkg.mod.BucketingModule(_bucket_sym(pkg), default_bucket_key=5,
                                      context=_ctx(pkg))
        mod.bind(data_shapes=[("data", (4, 5))],
                 label_shapes=[("softmax_label", (4,))])
        w = np.random.RandomState(2).randn(3, 1).astype(np.float32)
        mod.init_params(arg_params={"fc_weight": _nd(pkg, w),
                                    "fc_bias": _nd(pkg, np.zeros(3, "f"))})
        mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
        outs = []
        for key, x, y in batches:
            b = pkg.io.DataBatch(
                [_nd(pkg, x)], [_nd(pkg, y)], bucket_key=key,
                provide_data=[pkg.io.DataDesc("data", (4, key))],
                provide_label=[pkg.io.DataDesc("softmax_label", (4,))])
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        assert sorted(mod._mods_by_key) == [3, 5]
        res.append((_np(mod.get_params()[0]), outs))
    _assert_dicts(res[1][0], res[0][0])
    for g, w in zip(res[1][1], res[0][1]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _softmax_grad(pkg):
    def grad(scores, labels):
        p = scores.asnumpy()
        onehot = np.eye(p.shape[1], dtype=np.float32)[
            labels.asnumpy().astype(int)]
        return _nd(pkg, (p - onehot) / p.shape[0])
    return grad


@pytest.mark.parametrize("head", ["module", "python_loss"])
def test_sequential_module_matches_jax(head):
    x, y = _data(n=16, seed=5)
    res = []
    for pkg in (jmx, tmx):
        s = pkg.sym
        with pkg.name.NameManager():
            body = s.Activation(s.FullyConnected(
                s.var("data"), num_hidden=5, name="fc1"), act_type="relu")
            if head == "module":
                top = s.SoftmaxOutput(
                    s.FullyConnected(s.var("data"), num_hidden=4,
                                     name="fc2"),
                    s.var("softmax_label"), name="softmax")
                second = pkg.mod.Module(top, context=_ctx(pkg))
            else:
                top = s.softmax(s.FullyConnected(
                    body, num_hidden=4, name="fc2"))
                body = top
                second = pkg.mod.PythonLossModule(
                    grad_func=_softmax_grad(pkg))
        seq = pkg.mod.SequentialModule()
        seq.add(pkg.mod.Module(body, label_names=None, context=_ctx(pkg)))
        seq.add(second, take_labels=True, auto_wiring=True)
        w = {"fc1_weight": np.random.RandomState(8).randn(5, 6) * 0.3,
             "fc1_bias": np.zeros(5),
             "fc2_weight": np.random.RandomState(9).randn(4, 5) * 0.3,
             "fc2_bias": np.zeros(4)}
        seq.fit(_iter(pkg, x, y), optimizer="sgd", optimizer_params=SGD,
                num_epoch=1, arg_params={k: _nd(pkg, v.astype(np.float32))
                                         for k, v in w.items()},
                allow_missing=True)
        res.append((_np(seq.get_params()[0]),
                    seq.get_outputs()[0].asnumpy()))
    _assert_dicts(res[1][0], res[0][0])
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_checkpoint_loads_in_the_other_package(direction, tmp_path):
    src, dst = (tmx, jmx) if direction == "torch_to_jax" else (jmx, tmx)
    mod, _ = _fit_mlp(src)
    prefix = str(tmp_path / "mlp")
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    assert os.path.exists(prefix + "-symbol.json")
    assert os.path.exists(prefix + "-0003.states")
    sym, arg, aux = dst.model.load_checkpoint(prefix, 3)
    assert sym.list_arguments() == mod.symbol.list_arguments()
    _assert_dicts(_np(arg), _np(mod.get_params()[0]))
    # the loaded module predicts what the source does
    x, y = _data()
    loaded = dst.mod.Module.load(prefix, 3, context=_ctx(dst))
    loaded.bind(data_shapes=[("data", (8, 6))],
                label_shapes=[("softmax_label", (8,))], for_training=False)
    got = loaded.predict(_iter(dst, x, y)).asnumpy()
    want = mod.predict(_iter(src, x, y)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_module_optimizer_states_round_trip(tmp_path):
    mod, it = _fit_mlp(tmx)
    fname = str(tmp_path / "opt.states")
    mod.save_optimizer_states(fname)
    mod2, _ = _fit_mlp(tmx)
    mod2.load_optimizer_states(fname)
    for k, v in mod._updater.states.items():
        np.testing.assert_array_equal(mod2._updater.states[k].asnumpy(),
                                      v.asnumpy())


def test_speedometer_and_do_checkpoint(tmp_path, caplog):
    x, y = _data()
    sym = _mlp(tmx)
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    prefix = str(tmp_path / "ck")
    with caplog.at_level(logging.INFO):
        mod.fit(_iter(tmx, x, y), optimizer="sgd", optimizer_params=SGD,
                num_epoch=2,
                batch_end_callback=[tmx.callback.Speedometer(8, 2),
                                    tmx.callback.log_train_metric(2)],
                epoch_end_callback=tmx.callback.do_checkpoint(prefix, 2))
    speed = [r.getMessage() for r in caplog.records
             if "Speed:" in r.getMessage()]
    assert len(speed) == 4 and "samples/sec" in speed[0]
    assert any("Train-accuracy" in r.getMessage() for r in caplog.records)
    # period 2: only epoch 2 is written
    assert sorted(os.listdir(tmp_path)) == ["ck-0002.params",
                                            "ck-symbol.json"]
    _, arg, _ = jmx.model.load_checkpoint(prefix, 2)
    _assert_dicts(_np(arg), _np(mod.get_params()[0]))
    bar = tmx.callback.ProgressBar(total=4)
    bar(tmx.model.BatchEndParam(0, 2, None))


def test_feedforward_and_dist_kvstore():
    x, y = _data()
    ff = tmx.model.FeedForward(_mlp(tmx), ctx=tmx.cpu(), num_epoch=1,
                               learning_rate=0.1)
    ff.fit(_iter(tmx, x, y))
    assert ff.predict(_iter(tmx, x, y)).shape == (40, 4)
    # a dist kvstore with no parameter server named is a single-process
    # store of that type that runs the optimizer (update_on_kvstore), as
    # in the JAX package: the same update as the local path's
    params = {}
    for kvstore in ("local", "dist_sync"):
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (8, 6))],
                 label_shapes=[("softmax_label", (8,))])
        w = _weights(_mlp(tmx), {"data": (8, 6), "softmax_label": (8,)})
        mod.init_params(arg_params={k: _nd(tmx, v) for k, v in w.items()},
                        force_init=True)
        mod.init_optimizer(kvstore=kvstore, optimizer_params=SGD)
        assert mod._update_on_kvstore is (kvstore == "dist_sync")
        mod.forward_backward(tmx.io.DataBatch([_nd(tmx, x[:8])],
                                              [_nd(tmx, y[:8])]))
        mod.update()
        params[kvstore] = _np(mod.get_params()[0])
    assert mod._kvstore.type == "dist_sync"
    _assert_dicts(params["dist_sync"], params["local"])
    with pytest.raises(MXNetError, match="not ported"):
        tmx.mod.Module(_mlp(tmx), context=tmx.cpu(), aot="auto")


def test_monitor_collects_outputs_and_weights():
    x, y = _data()
    mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
    mon = tmx.monitor.Monitor(1, pattern=".*")
    mod.fit(_iter(tmx, x, y), optimizer="sgd", optimizer_params=SGD,
            num_epoch=1, monitor=mon)
    mon.tic()
    mod.forward(tmx.io.DataBatch([_nd(tmx, x[:8])], [_nd(tmx, y[:8])]))
    rows = mon.toc()
    names = [name for _, name, _ in rows]
    assert "softmax_output" in names and "fc1_weight" in names
