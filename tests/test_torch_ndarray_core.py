"""The port's NDArray core held against the JAX package's on the CPU:
Queue 3 faults 4-6 (in-place operators, ``nd.array``'s dtype and
context, iteration), the storage rule (first-axis basic slices and
``reshape`` share storage, every other op copies), ``__setitem__``, the
NDArray methods and module functions, the engine facade,
``runtime.Features`` and ``util``.

Values are held at rtol 1e-6 / atol 1e-6 against the JAX package on the
same seeded numpy inputs with the same dtype (the methods run the same
registry ops there); the storage rule and iteration are held to
upstream MXNet, not to the JAX package, whose arrays are immutable and
whose iteration never ends (ROADMAP, reference caveats).  Matmul
precision is pinned: JAX to "float32", torch to "highest".
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _x(shape=(3, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a, dtype=None):
    return tmx.nd.array(a, ctx=tmx.cpu(), dtype=dtype)


def _j(a, dtype=None):
    return jmx.nd.array(a, dtype=dtype)


def _same(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# fault 4: in-place operators
# ---------------------------------------------------------------------------

def _dense_step(pkg, ctx):
    """ROADMAP's case: Dense(1, in_units=2) from One(), one backward of
    net(x).sum() at x = ones, then w -= 0.1 * grad per parameter."""
    net = pkg.gluon.nn.Dense(1, in_units=2)
    net.initialize(pkg.init.One(), ctx=ctx)
    x = pkg.nd.array(np.ones((1, 2), np.float32), ctx=ctx)
    with pkg.autograd.record():
        y = net(x).sum()
    y.backward()
    for p in net.collect_params().values():
        w = p.data()
        w -= 0.1 * p.grad()
    return net.weight.data().asnumpy(), net.bias.data().asnumpy()


def test_hand_written_update_changes_the_parameter_in_both():
    tw, tb = _dense_step(tmx, tmx.cpu())
    jw, jb = _dense_step(jmx, jmx.cpu())
    np.testing.assert_allclose(tw, [[0.9, 0.9]], rtol=1e-6)
    _same(tw, jw)
    _same(tb, jb)


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/=", "%="])
@pytest.mark.parametrize("rhs", ["scalar", "array", "broadcast"])
def test_inplace_operator_writes_the_same_storage(op, rhs):
    a = np.abs(_x()) + 0.5
    b = {"scalar": 1.5, "array": np.abs(_x(seed=1)) + 0.5,
         "broadcast": np.abs(_x((1, 4), seed=1)) + 0.5}[rhs]
    results = []
    for pkg, wrap in ((tmx, _t), (jmx, _j)):
        x = wrap(a)
        alias = x
        other = b if rhs == "scalar" else wrap(b)
        exec("x %s other" % op)
        assert x is alias
        results.append(x.asnumpy())
    _same(*results)
    t = _t(a)
    ptr = t._data.data_ptr()
    exec("t %s (b if rhs == 'scalar' else _t(b))" % op)
    assert t._data.data_ptr() == ptr       # no new buffer


def test_inplace_on_int_array_keeps_its_dtype():
    x = _t(np.arange(6, dtype=np.int32).reshape(2, 3))
    ptr = x._data.data_ptr()
    x += 2
    x *= 3
    x %= 5
    assert x.dtype == np.int32 and x._data.data_ptr() == ptr
    np.testing.assert_array_equal(
        x.asnumpy(), ((np.arange(6).reshape(2, 3) + 2) * 3) % 5)


def _recorded_inplace(pkg, wrap, op):
    x = wrap(_x())
    x.attach_grad()
    with pkg.autograd.record():
        y = x * 2.0
        exec("y %s 0.5" % op)
        z = (y * y).sum()
    z.backward()
    return y.asnumpy(), x.grad.asnumpy()


@pytest.mark.parametrize("op", ["+=", "-="])
def test_inplace_operator_under_record_gives_jax_gradients(op):
    got = _recorded_inplace(tmx, _t, op)
    want = _recorded_inplace(jmx, _j, op)
    for g, w in zip(got, want):
        _same(g, w, rtol=1e-5, atol=1e-5)


def test_inplace_operator_under_record_rebinds_the_saved_array():
    """Inside record() the array the graph saved is not overwritten."""
    x = _t(_x())
    x.attach_grad()
    with tmx.autograd.record():
        y = x * x
        x -= 1.0
        z = (y + x).sum()
    z.backward()
    np.testing.assert_allclose(x.asnumpy(), _x() - 1.0, rtol=1e-6)
    # d/dx of x*x at the old value, plus 1 for the rebound x (the JAX
    # package's tape counts both for the one variable)
    np.testing.assert_allclose(x.grad.asnumpy(), 2 * _x() + 1.0,
                               rtol=1e-6)
    jx = _j(_x())
    jx.attach_grad()
    with jmx.autograd.record():
        jy = jx * jx
        jx -= 1.0
        jz = (jy + jx).sum()
    jz.backward()
    _same(x.grad.asnumpy(), jx.grad.asnumpy())


def _rebound_variable_steps(pkg, wrap, op, steps=3):
    """``steps`` record/backward rounds, each rebinding the marked
    variable ``x`` by ``op`` between two uses of it; the values and
    gradients of every round."""
    x = wrap(np.abs(_x()) + 0.5)
    x.attach_grad()
    out = []
    for _ in range(steps):
        with pkg.autograd.record():
            y = x * x
            exec("x %s 1.5" % op)
            z = (y + x * x * 3.0).sum()
        z.backward()
        out += [x.asnumpy(), x.grad.asnumpy()]
    return out


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_rebound_variable_stays_trainable_over_rounds(op):
    """Round after round the rebound variable keeps its gradient (a
    stale one, or a second backward through a freed graph, would show
    from round 2)."""
    got = _rebound_variable_steps(tmx, _t, op)
    want = _rebound_variable_steps(jmx, _j, op)
    for g, w in zip(got, want):
        _same(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fault 5: nd.array's dtype and context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", [
    [[1, 2], [3, 4]], [1.5, 2.5], 3, [True, False],
    np.arange(4, dtype=np.int64), np.arange(4, dtype=np.float64),
    np.arange(4, dtype=np.uint8), np.arange(4, dtype=np.int32),
    np.arange(4, dtype=np.float16)],
    ids=["int-list", "float-list", "int", "bool-list", "int64", "float64",
         "uint8", "int32", "float16"])
def test_array_dtype_matches_jax(source):
    _same(_t(source).asnumpy(), _j(source).asnumpy())


def test_array_of_ndarray_keeps_its_context_and_copies():
    src = _t(_x())
    out = tmx.nd.array(src)         # no ctx: the source's, not gpu(0)
    assert out.context == tmx.cpu()
    out += 1
    np.testing.assert_array_equal(src.asnumpy(), _x())
    _same(tmx.nd.array(src, dtype="float16").asnumpy(),
          jmx.nd.array(_j(_x()), dtype="float16").asnumpy())


def test_list_data_flows_through_layers_like_jax():
    results = []
    for pkg, ctx in ((tmx, tmx.cpu()), (jmx, jmx.cpu())):
        net = pkg.gluon.nn.Dense(3, in_units=2)
        net.initialize(pkg.init.One(), ctx=ctx)
        x = pkg.nd.array([[1, 2]], ctx=ctx)
        x += 0.5
        out = pkg.nd.softmax(net(x))
        results.append([out.asnumpy(), (x % 2).asnumpy(),
                        np.float32(x[0, 0].asscalar())])
    for g, w in zip(*results):
        _same(g, w)


# ---------------------------------------------------------------------------
# fault 6: iteration
# ---------------------------------------------------------------------------

def test_iteration_stops_after_the_last_row():
    x = _t(_x((3, 2)))
    rows = [r.asnumpy() for r in x]
    assert len(rows) == 3
    np.testing.assert_array_equal(np.stack(rows), _x((3, 2)))
    assert len(list(x)) == 3
    np.testing.assert_array_equal(np.asarray(x), _x((3, 2)))
    np.testing.assert_array_equal(np.array(x, dtype=np.float64),
                                  _x((3, 2)).astype(np.float64))


@pytest.mark.parametrize("key", [3, -4, (0, 2), (1, -3)])
def test_integer_index_out_of_range_raises_index_error(key):
    x = _t(_x((3, 2)))
    with pytest.raises(IndexError):
        x[key]


# ---------------------------------------------------------------------------
# the storage rule (upstream MXNet's), and __setitem__
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("derive,shares", [
    (lambda b: b[0:2], True), (lambda b: b[1], True),
    (lambda b: b[1:], True), (lambda b: b.reshape(-1), True),
    (lambda b: b.reshape((4, 3)), True), (lambda b: b[0:3:2], False),
    (lambda b: b[:, 1:3], False), (lambda b: b[1, 2:], False),
    (lambda b: b.T, False), (lambda b: b.transpose(), False),
    (lambda b: b.flatten(), False), (lambda b: b.astype("float32"), False),
    (lambda b: b.expand_dims(0), False), (lambda b: b.squeeze(), False),
    (lambda b: b.slice_axis(0, 0, 2), False),
    (lambda b: b.broadcast_to((3, 4)), False),
    (lambda b: b.detach(), True)],
    ids=["rows", "row", "tail", "reshape", "reshape2", "step2", "cols",
         "row-cols", "T", "transpose", "flatten", "astype-same",
         "expand_dims", "squeeze", "slice_axis", "broadcast_to",
         "detach"])
def test_storage_rule(derive, shares):
    base = _x()
    b = _t(base)
    a = derive(b)
    a += 1.0
    changed = not np.array_equal(b.asnumpy(), base)
    assert changed == shares


def test_write_through_a_first_axis_slice():
    b = _t(np.zeros((3, 4), np.float32))
    b[0:2][:] = 5.0
    b[2][1] = 7.0
    want = np.zeros((3, 4), np.float32)
    want[0:2] = 5.0
    want[2, 1] = 7.0
    np.testing.assert_array_equal(b.asnumpy(), want)


SETITEM = [
    ((1,), 2.5), ((slice(None),), 1.0), ((slice(0, 2),), "row"),
    (((1, 2),), -3.0), (((slice(None), 1),), "col"), (([0, 2],), "row"),
    ((Ellipsis,), 4.0), (((slice(None), slice(1, 3)),), "block")]


@pytest.mark.parametrize("key,value", SETITEM,
                         ids=["int", "all", "rows", "elem", "col", "list",
                              "ellipsis", "block"])
def test_setitem_matches_jax(key, value):
    key = key[0]
    vals = {"row": _x((1, 4), 3), "col": _x((3,), 4),
            "block": _x((3, 2), 5)}
    got = []
    for wrap in (_t, _j):
        x = wrap(_x())
        v = vals[value] if isinstance(value, str) else value
        x[key] = wrap(v) if isinstance(v, np.ndarray) and key != [0, 2] \
            else v
        got.append(x.asnumpy())
    _same(*got)


def test_setitem_raises_under_record_on_a_recorded_array():
    x = _t(_x())
    x.attach_grad()
    with tmx.autograd.record():
        y = x * 2
        with pytest.raises(MXNetError, match="recorded computation"):
            y[0] = 1.0
    z = _t(_x())
    with tmx.autograd.record():
        z[0] = 1.0      # not in the graph: written
    assert z.asnumpy()[0, 0] == 1.0


# ---------------------------------------------------------------------------
# NDArray methods and module functions
# ---------------------------------------------------------------------------

_D = np.random.RandomState(7).permutation(24).astype(np.float32)\
    .reshape(2, 3, 4) / 7.0    # distinct values: no ties to order
METHODS = [
    ("expand_dims", lambda a: a.expand_dims(1)),
    ("flatten", lambda a: a.flatten()),
    ("squeeze", lambda a: a.reshape((2, 1, 12)).squeeze(axis=1)),
    ("split", lambda a: a.split(2, axis=0)),
    ("split_squeeze", lambda a: a.split(3, axis=1, squeeze_axis=True)),
    ("slice", lambda a: a.slice((0, 1), (2, 3))),
    ("slice_step", lambda a: a.slice((0, 2, 0), (2, None, 4),
                                     (1, -1, 2))),
    ("take", lambda a: a.take(_W(np.array([2, 0], np.float32)), axis=1)),
    ("one_hot", lambda a: a.one_hot(5)),
    ("pick", lambda a: a.pick(_W(np.array([[0, 3, 1], [2, 2, 0]],
                                          np.float32)))),
    ("clip", lambda a: a.clip(0.5, 2.0)),
    ("abs", lambda a: a.abs()), ("sign", lambda a: (a - 1).sign()),
    ("sqrt", lambda a: a.sqrt()), ("square", lambda a: a.square()),
    ("exp", lambda a: a.exp()), ("log", lambda a: (a + 1).log()),
    ("relu", lambda a: (a - 1).relu()), ("sigmoid", lambda a: a.sigmoid()),
    ("tanh", lambda a: a.tanh()), ("softmax", lambda a: a.softmax()),
    ("log_softmax", lambda a: a.log_softmax(axis=1)),
    ("sum", lambda a: a.sum(axis=1)), ("mean", lambda a: a.mean()),
    ("nansum", lambda a: a.nansum(axis=(0, 2))),
    ("prod", lambda a: a.prod(axis=2, keepdims=True)),
    ("max", lambda a: a.max(axis=0)), ("min", lambda a: a.min()),
    ("norm", lambda a: a.norm(axis=1)),
    ("argmax", lambda a: a.argmax(axis=2)),
    ("argmin", lambda a: a.argmin(axis=1, keepdims=True)),
    ("argsort", lambda a: a.argsort(axis=2, is_ascend=False)),
    ("sort", lambda a: a.sort(axis=1)),
    ("topk", lambda a: a.topk(axis=2, k=2)),
    ("topk_value", lambda a: a.topk(k=3, ret_typ="value", is_ascend=True)),
    ("dot", lambda a: a.dot(_W(_x((4, 5), 2)))),
    ("broadcast_to", lambda a: a[:, :1].broadcast_to((2, 5, 4))),
    ("broadcast_like", lambda a: a[:1].broadcast_like(a)),
    ("tile", lambda a: a.tile((2, 1, 1))),
    ("repeat", lambda a: a.repeat(2, axis=1)),
    ("flip", lambda a: a.flip(axis=2)),
    ("zeros_like", lambda a: a.zeros_like()),
    ("ones_like", lambda a: a.ones_like()),
    ("T", lambda a: a[0].T), ("detach", lambda a: a.detach()),
    ("reshape_like", lambda a: a.reshape_like(_W(np.zeros((4, 6))))),
    ("tostype", lambda a: a.tostype("default")),
    ("copy", lambda a: a.copy()),
]
_WRAP = []


def _W(a):
    return _WRAP[-1](a)


@pytest.mark.parametrize("name,fn", METHODS, ids=[m[0] for m in METHODS])
def test_method_matches_jax(name, fn):
    outs = []
    for wrap in (_t, _j):
        _WRAP.append(wrap)
        try:
            out = fn(wrap(_D))
        finally:
            _WRAP.pop()
        outs.append([o.asnumpy() for o in out]
                    if isinstance(out, list) else [out.asnumpy()])
    for g, w in zip(*outs):
        _same(g, w)


def test_scalar_conversions():
    x = _t(np.array([2.75], np.float32))
    assert x.item() == 2.75 and float(x) == 2.75 and int(x) == 2
    assert x.asscalar() == jmx.nd.array([2.75]).asscalar()
    assert _t(np.array([2.75], np.float32)).stype == "default"
    # sparse storage is ported: tostype casts, as the JAX package's does
    m = _t(np.array([[0.0, 2.75]], np.float32))
    csr = m.tostype("csr")
    assert csr.stype == "csr"
    np.testing.assert_array_equal(csr.asnumpy(), m.asnumpy())
    np.testing.assert_array_equal(
        csr.data.asnumpy(),
        jmx.nd.array([[0.0, 2.75]]).tostype("csr").data.asnumpy())
    with pytest.raises(MXNetError, match="stype"):
        x.tostype("dense")


FUNCTIONS = [
    ("empty", lambda nd, w: nd.empty((2, 3)) * 0),
    ("full", lambda nd, w: nd.full((2, 3), 1.5)),
    ("full_int", lambda nd, w: nd.full((2,), 3, dtype="int32")),
    ("concatenate", lambda nd, w: nd.concatenate([w(_x((2, 3))),
                                                  w(_x((1, 3), 1))])),
    ("concat", lambda nd, w: nd.concat(w(_x((2, 3))), w(_x((2, 1), 1)),
                                       dim=1)),
    ("stack", lambda nd, w: nd.stack(w(_x((2, 3))), w(_x((2, 3), 1)),
                                     axis=1)),
    ("stack_list", lambda nd, w: nd.stack([w(_x((2, 3))),
                                           w(_x((2, 3), 1))])),
    ("moveaxis", lambda nd, w: nd.moveaxis(w(_D), 0, 2)),
]


@pytest.mark.parametrize("name,fn", FUNCTIONS, ids=[f[0] for f in FUNCTIONS])
def test_module_function_matches_jax(name, fn):
    with tmx.cpu():
        got = fn(tmx.nd, _t).asnumpy()
    _same(got, fn(jmx.nd, _j).asnumpy())


def test_onehot_encode_and_waitall():
    idx = np.array([1, 0, 3], np.float32)
    got = tmx.nd.onehot_encode(_t(idx), _t(np.zeros((3, 4), np.float32)))
    want = jmx.nd.onehot_encode(_j(idx), _j(np.zeros((3, 4), np.float32)))
    _same(got.asnumpy(), want.asnumpy())
    tmx.nd.waitall()
    got.wait_to_read()
    got.wait_to_write()


# ---------------------------------------------------------------------------
# engine, runtime, util
# ---------------------------------------------------------------------------

def test_engine_facade(monkeypatch):
    from mxnet_tpu_torch import engine

    eng = engine.get()
    assert eng is engine.Engine.get()
    prev = eng.engine_type
    try:
        eng.set_engine_type("NaiveEngine")
        assert eng.is_naive
        _same((_t(_x()) * 2).asnumpy(), (_j(_x()) * 2).asnumpy())
    finally:
        eng.set_engine_type(prev)
    assert not eng.is_naive
    eng.record_exception(ValueError("deferred"))
    with pytest.raises(ValueError, match="deferred"):
        _t(_x()).wait_to_read()
    eng.wait_for_all()      # raised once, then clear
    with engine.bulk(16):
        assert eng.bulk_size == 16
    assert engine.set_bulk_size(4) == 0
    assert engine.set_bulk_size(0) == 4


def test_engine_type_knob(monkeypatch):
    from mxnet_tpu_torch import config, engine

    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert config.get("MXNET_ENGINE_TYPE") == "NaiveEngine"
    assert engine.Engine().is_naive


def test_runtime_features_and_util():
    from mxnet_tpu_torch import runtime, util

    feats = runtime.Features()
    jfeats = jmx.runtime.Features()
    assert set(feats) == set(jfeats)
    for name in ("TPU", "XLA", "PALLAS"):
        assert not feats.is_enabled(name)
    assert feats.is_enabled("cpu")
    assert feats.is_enabled("CUDA") == (torch.version.cuda is not None)
    with pytest.raises(RuntimeError, match="unknown"):
        feats.is_enabled("WARP_DRIVE")
    assert len(runtime.feature_list()) == len(feats)
    assert util.get_gpu_count() == torch.cuda.device_count()
    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="CUDA device"):
            util.get_gpu_memory(0)
    assert not util.is_np_shape()

    @util.use_np_shape
    def inside():
        return util.is_np_shape()

    assert inside() and not util.is_np_shape()
