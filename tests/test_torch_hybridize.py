"""The port's hybridize() (CachedOp over torch.compile), export and
SymbolBlock, Parameter.var and autograd.get_symbol, held against the
port's eager blocks and the JAX package's hybridized ones on the CPU:
a Conv/BatchNorm/Dropout(0)/Dense net's outputs, gradients under
grad_req write and add, and moving stats; hybridize(False); the flags
that raise; export read by the other package's SymbolBlock.imports in
both directions; and every zoo family's symbolic forward (the graph
export writes) against the JAX package's.  Weights come from numpy with a seed and are set by
name in both packages.  The compiled path runs with ``aot_eager``
(``jit._BACKEND``) except in ``test_inductor_compiles_the_mlp``, the one
CPU test of inductor's code generation.  JAX at
``default_matmul_precision("float32")``, torch at ``"highest"``;
tolerance rtol 1e-5, atol 1e-6 against JAX (gradients: atol 1e-6 x the
step's largest gradient, as a conv bias before a BatchNorm has an exact
gradient of 0 and f32 noise in both packages), and bit equality between
the port's eager and hybridized runs where the backend runs the same
kernels (aot_eager)."""
import json

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

import torch_zoo_ref

RTOL, ATOL = 1e-5, 1e-6
X_SHAPE = (4, 2, 8, 8)


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


def _batch(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(*X_SHAPE).astype(np.float32),
            rng.randint(0, 5, X_SHAPE[0]).astype(np.float32))


def _train(pkg, net, steps=2, grad_req="write"):
    """``steps`` forward/backward passes of softmax cross-entropy (no
    update): outputs of the last, gradients, moving stats."""
    for p in net.collect_params().values():
        if p.grad_req != "null":
            p.grad_req = grad_req
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    for i in range(steps):
        x, y = _batch(seed=1 + i)
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


def _assert_run(got, want, exact=False):
    if exact:
        np.testing.assert_array_equal(got[0], want[0])
    else:
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    assert sorted(got[1]) == sorted(want[1])
    scale = max(np.abs(g).max() for g in want[1].values())
    for k in want[1]:
        if exact:
            np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)
        else:
            np.testing.assert_allclose(got[1][k], want[1][k], rtol=RTOL,
                                       atol=ATOL * scale, err_msg=k)
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_hybridized_matches_eager_and_jax(grad_req):
    eager = _train(tmx, _net(tmx), grad_req=grad_req)
    net = _net(tmx)
    net.hybridize()
    hyb = _train(tmx, net, grad_req=grad_req)
    assert len(net._cached_op._compiled) == 1
    _assert_run(hyb, eager, exact=True)
    jnet = _net(jmx)
    jnet.hybridize()
    _assert_run(hyb, _train(jmx, jnet, grad_req=grad_req))


def test_hybridized_inference_and_new_shape():
    net, ref = _net(tmx), _net(tmx)
    net.hybridize()
    x, _ = _batch()
    np.testing.assert_array_equal(net(_nd(tmx, x)).asnumpy(),
                                  ref(_nd(tmx, x)).asnumpy())
    # a new batch size is a new key: compiled again, still equal
    np.testing.assert_array_equal(net(_nd(tmx, x[:2])).asnumpy(),
                                  ref(_nd(tmx, x[:2])).asnumpy())
    assert len(net._cached_op._compiled) == 2
    assert net._cached_op.compile_seconds > 0


def test_hybridize_false_returns_to_eager():
    net = _net(tmx)
    net.hybridize()
    x, _ = _batch()
    net(_nd(tmx, x))
    net.hybridize(False)
    assert net._cached_op is None
    assert all(not c._active for c in net._children.values())
    calls = []
    net[0].register_forward_hook(lambda b, a, o: calls.append(o.shape))
    net(_nd(tmx, x))
    assert calls == [(4, 4, 8, 8)]


def test_flags():
    net = _net(tmx)
    with pytest.raises(MXNetError, match="not ported yet"):
        net.hybridize(aot="x")
    # remat_policy is ported (remat.py): an unknown name raises as in the
    # JAX package
    with pytest.raises(ValueError, match="unknown remat_policy"):
        net.hybridize(remat_policy="x")
    with pytest.raises(TypeError):
        net.hybridize(nonsense=True)
    with pytest.raises(MXNetError):
        net.hybridize(dtype_policy="no_such_policy")
    # static_alloc / static_shape change nothing
    ref = _net(tmx)
    net.hybridize(static_alloc=True, static_shape=True)
    x, _ = _batch()
    np.testing.assert_array_equal(net(_nd(tmx, x)).asnumpy(),
                                  ref(_nd(tmx, x)).asnumpy())


def test_dtype_policy_hybridized():
    net = _net(tmx)
    net.hybridize(dtype_policy="bf16_mixed")
    x, _ = _batch()
    out = net(_nd(tmx, x))
    assert out.dtype == np.float32
    ref = _net(tmx)(_nd(tmx, x)).asnumpy()
    np.testing.assert_allclose(out.asnumpy(), ref, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_export_imports_in_the_other_package(direction, tmp_path):
    src, dst = (tmx, jmx) if direction == "torch_to_jax" else (jmx, tmx)
    net = _net(src)
    net.hybridize()
    x, _ = _batch()
    want = net(_nd(src, x)).asnumpy()
    path = str(tmp_path / "net")
    fname = net.export(path, epoch=2)
    assert fname.endswith("net-0002.params")
    kw = {"ctx": tmx.cpu()} if dst is tmx else {}
    blk = dst.gluon.SymbolBlock.imports(path + "-symbol.json", ["data"],
                                        fname, **kw)
    assert sorted(blk.collect_params()) == sorted(net.collect_params())
    np.testing.assert_allclose(blk(_nd(dst, x)).asnumpy(), want, rtol=RTOL,
                               atol=ATOL)


def test_symbol_block_trains_like_the_source(tmp_path):
    net = _net(tmx)
    path = str(tmp_path / "net")
    fname = net.export(path)
    blk = tmx.gluon.SymbolBlock.imports(path + "-symbol.json", "data", fname,
                                        ctx=tmx.cpu())
    # in training the exported BatchNorm takes batch statistics and
    # updates its moving stats, as the gluon layer does
    _assert_run(_train(tmx, blk), _train(tmx, _net(tmx)))
    sym = tmx.sym.load(path + "-symbol.json")
    blk2 = tmx.gluon.SymbolBlock(sym, tmx.sym.var("data"))
    x, _ = _batch()
    out = blk2(_nd(tmx, x))     # parameters initialized from inferred shapes
    assert out.shape == (4, 5)
    assert blk2.collect_params()["hybridsequential0_dense0_weight"] \
        .data().shape == (5, 64)


def test_parameter_var_matches_jax():
    attrs = []
    for pkg in (tmx, jmx):
        with pkg.name.NameManager():
            d = pkg.gluon.nn.Dense(3, in_units=4)
        d.weight.lr_mult = 2.0
        v = d.weight.var()
        assert v is d.weight.var()
        assert v.list_arguments() == ["dense0_weight"]
        attrs.append(v.attr_dict())
    assert attrs[0] == attrs[1]


def test_hybrid_forward_symbolic_matches_jax():
    t, j = [json.loads(_net(pkg)._to_symbol().tojson())
            for pkg in (tmx, jmx)]
    # one attribute differs: the JAX layer writes use_global_stats=True
    # when it exports in predict mode, the port's (and the reference's)
    # writes the layer's own setting, so that a bound export trains with
    # batch statistics
    bn = [n for n in j["nodes"] if n["op"] == "BatchNorm"]
    assert [n["attrs"]["use_global_stats"] for n in bn] == ["True"]
    bn[0]["attrs"]["use_global_stats"] = "False"
    assert t == j


def test_get_symbol_matches_jax():
    rng = np.random.RandomState(0)
    x, w, b = (rng.randn(2, 4).astype(np.float32),
               rng.randn(3, 4).astype(np.float32),
               rng.randn(3).astype(np.float32))
    syms, outs = [], []
    for pkg in (tmx, jmx):
        xs = [_nd(pkg, a) for a in (x, w, b)]
        for a in xs:
            a.attach_grad()
        with pkg.name.NameManager():
            with pkg.autograd.record():
                y = pkg.nd.FullyConnected(*xs, num_hidden=3)
                z = pkg.nd.tanh(y) * 2.0 + y
            sym = pkg.autograd.get_symbol(z)
        syms.append(json.loads(sym.tojson()))
        args = dict(zip(sym.list_arguments(), xs))
        kw = {"ctx": tmx.cpu()} if pkg is tmx else {}
        outs.append(sym.eval(**kw, **args)[0].asnumpy())
    assert syms[0] == syms[1]
    np.testing.assert_allclose(outs[0], outs[1], rtol=RTOL, atol=ATOL)


def test_inductor_compiles_the_mlp(monkeypatch):
    """The default backend (inductor) on the CPU, once: an MLP's
    hybridized forward and gradients against its eager self."""
    monkeypatch.setattr(tmx.jit, "_BACKEND", None)
    nets = []
    for _ in range(2):
        with tmx.name.NameManager():
            net = tmx.gluon.nn.HybridSequential()
            net.add(tmx.gluon.nn.Dense(8, activation="tanh"),
                    tmx.gluon.nn.Dense(3))
        net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
        nets.append(net)
    x = np.random.RandomState(3).randn(4, 5).astype(np.float32)
    with tmx.autograd.pause():
        nets[0](_nd(tmx, x))
    for p, q in zip(nets[0].collect_params().values(),
                    nets[1].collect_params().values()):
        q.shape = p.shape
        q.initialize(ctx=tmx.cpu(), force_reinit=True)
        q.set_data(p.data())
    nets[1].hybridize()
    res = []
    for net in nets:
        with tmx.autograd.record():
            out = net(_nd(tmx, x))
        (out * out).backward()
        res.append((out.asnumpy(), [p.grad().asnumpy()
                                    for p in net.collect_params().values()]))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=RTOL, atol=ATOL)
    for g, w in zip(res[1][1], res[0][1]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", sorted(torch_zoo_ref.FAMILIES))
def test_zoo_symbolic_forward_matches_jax(family):
    """Every zoo family's hybrid_forward under ``F = mx.sym`` (the graph
    ``export`` writes) equals the JAX package's, BatchNorm's
    use_global_stats aside (see test_hybrid_forward_symbolic_matches_jax)."""
    t, j = [json.loads(torch_zoo_ref.build(pkg, family, small=False)
                       ._to_symbol().tojson()) for pkg in (tmx, jmx)]
    for node in j["nodes"]:
        if node["op"] == "BatchNorm":
            assert node["attrs"]["use_global_stats"] == "True"
            node["attrs"]["use_global_stats"] = "False"
    assert t == j
