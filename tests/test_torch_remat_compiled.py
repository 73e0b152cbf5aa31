"""``remat_policy`` on the port's compiled paths, ``hybridize()`` (CachedOp)
and ``Module`` (Executor), held to remat off in the port and to the JAX
package with the same policy, on CPU.

Each policy of ``remat.list_policies()``:

- ``hybridize(remat_policy=...)`` on a Conv/BatchNorm/tanh/Dropout(0)/
  MaxPool/Dense net (``test_torch_hybridize.py``'s), two
  forward/backward passes of softmax cross-entropy: outputs, gradients
  and moving stats bit-equal to the port's hybridized net without remat,
  and within that file's tolerance of the JAX package's hybridized net
  with the same policy (rtol 1e-5, atol 1e-6; gradients atol 1e-6 x the
  largest gradient);
- ``Module(remat_policy=...)`` on a Convolution/BatchNorm/relu/
  FullyConnected/SoftmaxOutput symbol, two forward/backward/update
  steps of sgd: parameters and moving stats bit-equal to the port's
  Module without remat and within rtol 1e-5, atol 1e-6 of the JAX
  package's Module with the same policy.

The compiled path runs with ``aot_eager`` (``jit._BACKEND``), so the
checkpointed region traces through dynamo with ``fullgraph=True``: a
graph break would fail these tests.
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
X_SHAPE = (4, 2, 8, 8)
POLICIES = ["full", "nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable", "everything_saveable",
            "offload_dots"]


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _nd(pkg, a):
    return pkg.nd.array(a, ctx=tmx.cpu()) if pkg is tmx else pkg.nd.array(a)


def _ctx(pkg):
    return tmx.cpu() if pkg is tmx else jmx.cpu()


def _net(pkg, seed=0):
    nn = pkg.gluon.nn
    with pkg.name.NameManager():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(momentum=0.8),
                    nn.Activation("tanh"), nn.Dropout(0.0),
                    nn.MaxPool2D(2, 2), nn.Flatten(), nn.Dense(5))
    net.initialize(ctx=_ctx(pkg))
    with pkg.autograd.pause():
        net(_nd(pkg, np.zeros(X_SHAPE, np.float32)))
    rng = np.random.RandomState(seed)
    for name, p in sorted(net.collect_params().items()):
        shape = p.data().shape
        v = rng.rand(*shape) + 0.5 if name.endswith("var") \
            else rng.randn(*shape) * 0.5
        p.set_data(_nd(pkg, v.astype(np.float32)))
    return net


def _train(pkg, net, steps=2):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for i in range(steps):
        rng = np.random.RandomState(1 + i)
        x = rng.randn(*X_SHAPE).astype(np.float32)
        y = rng.randint(0, 5, X_SHAPE[0]).astype(np.float32)
        with pkg.autograd.record():
            out = net(_nd(pkg, x))
            loss = loss_fn(out, _nd(pkg, y))
        loss.backward()
    params = net.collect_params()
    return (out.asnumpy(),
            {k: p.grad().asnumpy() for k, p in params.items()
             if p.grad_req != "null"},
            {k: p.data().asnumpy() for k, p in params.items()
             if k.endswith(("running_mean", "running_var"))})


def _assert_run(got, want, exact):
    check = np.testing.assert_array_equal if exact else \
        (lambda a, b, **kw: np.testing.assert_allclose(
            a, b, rtol=RTOL, **kw))
    if exact:
        check(got[0], want[0])
    else:
        check(got[0], want[0], atol=ATOL)
    scale = max(np.abs(g).max() for g in want[1].values())
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        if exact:
            check(got[1][k], want[1][k], err_msg=k)
        else:
            check(got[1][k], want[1][k], atol=ATOL * scale, err_msg=k)
    for k in want[2]:
        if exact:
            check(got[2][k], want[2][k], err_msg=k)
        else:
            check(got[2][k], want[2][k], atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def hybrid_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmx.jit, "_BACKEND", "aot_eager")
        net = _net(tmx)
        net.hybridize()
        return _train(tmx, net)


def _count_regions(monkeypatch):
    """Count the checkpoint regions traced (dynamo runs the Python of a
    compiled function once a key)."""
    calls = []
    real = tmx.remat.checkpoint_region

    def counted(fn, args, policy, arrays=()):
        calls.append(policy.name)
        return real(fn, args, policy, arrays)
    monkeypatch.setattr(tmx.remat, "checkpoint_region", counted)
    return calls


@pytest.mark.parametrize("policy", POLICIES)
def test_hybridize_remat(hybrid_off, policy, monkeypatch):
    calls = _count_regions(monkeypatch)
    net = _net(tmx)
    net.hybridize(remat_policy=policy)
    got = _train(tmx, net)
    assert calls and set(calls) == {policy}
    assert len(net._cached_op._compiled) == 1
    _assert_run(got, hybrid_off, exact=True)
    jnet = _net(jmx)
    jnet.hybridize(remat_policy=policy)
    _assert_run(got, _train(jmx, jnet), exact=False)


def _conv_symbol(pkg):
    s = pkg.sym
    with pkg.name.NameManager():
        net = s.Convolution(s.var("data"), num_filter=4, kernel=(3, 3),
                            pad=(1, 1), name="conv")
        net = s.BatchNorm(net, momentum=0.8, name="bn")
        net = s.Activation(net, act_type="relu")
        net = s.FullyConnected(s.flatten(net), num_hidden=3, name="fc")
        return s.SoftmaxOutput(net, s.var("softmax_label"), name="softmax")


def _module_run(pkg, policy):
    sym = _conv_symbol(pkg)
    shapes = {"data": X_SHAPE, "softmax_label": (X_SHAPE[0],)}
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    rng = np.random.RandomState(2)
    args = {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in shapes}
    aux = {n: (rng.rand(*s) + 0.5).astype(np.float32)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    mod = pkg.mod.Module(sym, context=_ctx(pkg), remat_policy=policy)
    mod.bind(data_shapes=[("data", X_SHAPE)],
             label_shapes=[("softmax_label", (X_SHAPE[0],))])
    mod.init_params(arg_params={k: _nd(pkg, v) for k, v in args.items()},
                    aux_params={k: _nd(pkg, v) for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    for i in range(2):
        r = np.random.RandomState(10 + i)
        batch = pkg.io.DataBatch(
            [_nd(pkg, r.randn(*X_SHAPE).astype(np.float32))],
            [_nd(pkg, r.randint(0, 3, X_SHAPE[0]).astype(np.float32))])
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    a, x = mod.get_params()
    return {k: v.asnumpy() for k, v in {**a, **x}.items()}


@pytest.fixture(scope="module")
def module_off():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmx.jit, "_BACKEND", "aot_eager")
        return _module_run(tmx, None)


@pytest.mark.parametrize("policy", POLICIES)
def test_module_remat(module_off, policy, monkeypatch):
    calls = _count_regions(monkeypatch)
    got = _module_run(tmx, policy)
    assert calls and set(calls) == {policy}
    assert sorted(got) == sorted(module_off)
    for k in module_off:
        np.testing.assert_array_equal(got[k], module_off[k], err_msg=k)
    want = _module_run(jmx, policy)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
