"""The port's sparse storage held against the JAX package's on the CPU:
RowSparseNDArray and CSRNDArray (construction, components, check_format,
the lazy dense view and its RuntimeWarning), the functions of
ndarray/sparse.py, ``_csr_matmul`` with its gradients against
``jax.vjp``, the mx.nd functions that reach the sparse paths, the
row-sparse KVStore push with SGD's lazy update and ``row_sparse_pull``
into a RowSparseNDArray, a two-worker ``dist_device_sync``
``row_sparse_pull`` through the port's parameter server (workers as
threads, then as processes under the port's launcher, with the timeouts
of tests/test_torch_kvstore_dist.py), the
``Parameter(stype=, grad_stype=)`` repair with ``SparseEmbedding``, and
``test_utils``.

The same numpy components go through both packages.  Values agree
exactly where no arithmetic runs (components, gathers, casts), else at
rtol 1e-6 (f32, the KVStore steps: weights and momentum) or rtol 1e-5 /
atol 1e-6 (products and gradients).  Indices are int64 in the port and
int32 in the JAX package (x64 off), so they are compared by value.
Matmul precision is pinned: JAX to "float32", torch to "highest".
"""
import threading
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.base import MXNetError as JError
from mxnet_tpu.ndarray import sparse as jsp
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kvstore as tkvs
from mxnet_tpu_torch.base import MXNetError as TError
from mxnet_tpu_torch.kvstore_server import KVServer, WorkerClient
from mxnet_tpu_torch.ndarray import sparse as tsp
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL, KV_RTOL = 1e-5, 1e-6, 1e-6
JOIN_S = 30
CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


@pytest.fixture
def no_densify():
    """Any RuntimeWarning (a densification) fails the test."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        yield


def _sparse_dense(shape, density, seed):
    r = np.random.RandomState(seed)
    a = r.randn(*shape).astype(np.float32)
    return a * (r.rand(*shape) < density)


def _rows(shape, nrows, seed):
    """(values, ascending distinct rows) of a row-sparse array."""
    r = np.random.RandomState(seed)
    rows = np.sort(r.choice(shape[0], nrows, replace=False))
    return r.randn(nrows, *shape[1:]).astype(np.float32), rows


def _csr_parts(shape, density, seed):
    d = _sparse_dense(shape, density, seed)
    rows, cols = np.nonzero(d)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                        minlength=shape[0]))])
    return d, d[rows, cols], cols.astype(np.int64), indptr.astype(np.int64)


def _same_components(t, j, names):
    for n in names:
        got, want = getattr(t, n).asnumpy(), getattr(j, n).asnumpy()
        assert got.shape == want.shape, (n, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=n)


def _t(a):
    return tmx.nd.array(a, ctx=CPU, dtype=np.asarray(a).dtype)


# ---------------------------------------------------------------------------
# construction, components, conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 3), (7, 2, 3), (5,)])
def test_row_sparse_array_from_components_and_dense(shape, no_densify):
    vals, rows = _rows(shape, 3, seed=len(shape))
    t = tsp.row_sparse_array((vals, rows), shape=shape, ctx=CPU)
    j = jsp.row_sparse_array((vals, rows), shape=shape)
    assert isinstance(t, tsp.RowSparseNDArray) and t.stype == "row_sparse"
    assert t.shape == j.shape and t.dtype == j.dtype
    assert t.context == CPU and t.indices._data.dtype == torch.int64
    _same_components(t, j, ("data", "indices"))
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    dense = _sparse_dense(shape, 0.4, seed=3)
    t2 = tsp.row_sparse_array(dense, ctx=CPU)
    j2 = jsp.row_sparse_array(dense)
    _same_components(t2, j2, ("data", "indices"))
    np.testing.assert_array_equal(t2.asnumpy(), dense)


def test_sparse_array_from_components_needs_its_shape():
    vals, rows = _rows((9, 2), 3, seed=1)
    with pytest.raises(TError, match="shape"):
        tsp.row_sparse_array((vals, rows), ctx=CPU)
    with pytest.raises(TError, match="shape"):
        tsp.csr_matrix((vals[:, 0], rows, [0, 1, 3]), ctx=CPU)


def test_csr_matrix_from_components_and_dense(no_densify):
    d, vals, cols, indptr = _csr_parts((6, 9), 0.3, seed=0)
    t = tsp.csr_matrix((vals, cols, indptr), shape=d.shape, ctx=CPU)
    j = jsp.csr_matrix((vals, cols, indptr), shape=d.shape)
    assert isinstance(t, tsp.CSRNDArray) and t.stype == "csr"
    _same_components(t, j, ("data", "indices", "indptr"))
    np.testing.assert_array_equal(t.asnumpy(), d)
    t2 = tsp.csr_matrix(_t(d))
    j2 = jsp.csr_matrix(jmx.nd.array(d))
    _same_components(t2, j2, ("data", "indices", "indptr"))
    t.check_format()
    t2.check_format()


@pytest.mark.parametrize("stype", ["row_sparse", "csr"])
def test_cast_storage_tostype_and_zeros(stype, no_densify):
    d = _sparse_dense((8, 5), 0.3, seed=4)
    comps = ("data", "indices") + (("indptr",) if stype == "csr" else ())
    t = tsp.cast_storage(_t(d), stype)
    j = jsp.cast_storage(jmx.nd.array(d), stype)
    _same_components(t, j, comps)
    via = _t(d).tostype(stype)
    _same_components(via, j, comps)
    back = t.tostype("default")
    assert type(back) is tmx.nd.NDArray
    np.testing.assert_array_equal(back.asnumpy(), d)
    assert back._data.data_ptr() != t.data._data.data_ptr()
    other = "csr" if stype == "row_sparse" else "row_sparse"
    np.testing.assert_array_equal(t.tostype(other).asnumpy(), d)
    assert tsp.cast_storage(t, stype) is t and t.tostype(stype) is t
    z = tsp.zeros_sparse(stype, (4, 3), ctx=CPU)
    jz = jsp.zeros_sparse(stype, (4, 3))
    _same_components(z, jz, comps)
    np.testing.assert_array_equal(z.asnumpy(), np.zeros((4, 3)))
    assert tmx.nd.cast_storage(_t(d), stype=stype).stype == stype
    np.testing.assert_array_equal(
        tmx.nd.cast_storage(t, stype="default").asnumpy(), d)


def test_nd_namespace_exports_sparse():
    assert tmx.nd.sparse is tsp
    assert tmx.nd.csr_matrix is tsp.csr_matrix
    assert tmx.nd.row_sparse_array is tsp.row_sparse_array
    x = _t(np.ones((2, 2), np.float32))
    x.attach_grad(stype="row_sparse")
    assert x.grad.shape == (2, 2)


@pytest.mark.parametrize("case", ["indptr_length", "indptr_start",
                                  "decreasing", "nnz", "column_range",
                                  "unsorted", "duplicate"])
def test_check_format_errors(case):
    vals = np.ones(4, np.float32)
    cols = np.array([0, 2, 1, 3], np.int64)
    indptr = np.array([0, 2, 4], np.int64)
    shape = (2, 4)
    if case == "indptr_length":
        indptr = np.array([0, 2, 3, 4], np.int64)
    elif case == "indptr_start":
        indptr = np.array([1, 2, 4], np.int64)
    elif case == "decreasing":
        indptr = np.array([0, 3, 2], np.int64)
    elif case == "nnz":
        indptr = np.array([0, 2, 3], np.int64)
    elif case == "column_range":
        cols = np.array([0, 2, 1, 4], np.int64)
    elif case == "unsorted":
        cols = np.array([2, 0, 1, 3], np.int64)
    else:
        cols = np.array([0, 2, 3, 3], np.int64)
    t = tsp.csr_matrix((vals, cols, indptr), shape=shape, ctx=CPU)
    j = jsp.csr_matrix((vals, cols, indptr), shape=shape)
    with pytest.raises(JError) as je:
        j.check_format()
    with pytest.raises(TError) as te:
        t.check_format()
    assert str(te.value) == str(je.value)


def test_dense_view_warns_and_rebind_rederives():
    vals, rows = _rows((5, 2), 2, seed=6)
    t = tsp.row_sparse_array((vals, rows), shape=(5, 2), ctx=CPU)
    with pytest.warns(RuntimeWarning, match="densified"):
        out = t + 1
    np.testing.assert_array_equal(out.asnumpy(), t.asnumpy() + 1)
    # from then on the dense view is the value: an in-place write is
    # seen by the components
    t += 2
    assert isinstance(t, tsp.RowSparseNDArray)
    np.testing.assert_array_equal(t.indices.asnumpy(), np.arange(5))
    t._rebind(_t(np.array([[0, 0], [0, 0], [3, 3], [0, 0], [0, 0]],
                          np.float32))._data)
    np.testing.assert_array_equal(t.indices.asnumpy(), [2])
    np.testing.assert_array_equal(t.data.asnumpy(), [[3.0, 3.0]])
    j = jsp.row_sparse_array((vals, rows), shape=(5, 2))
    j._rebind(jnp.asarray(np.array([[0, 0], [0, 0], [3, 3], [0, 0],
                                    [0, 0]], np.float32)))
    _same_components(t, j, ("data", "indices"))
    c = tsp.cast_storage(_t(np.eye(3, dtype=np.float32)), "csr")
    c[1, 2] = 5.0
    np.testing.assert_array_equal(c.indices.asnumpy(), [0, 1, 2, 2])


# ---------------------------------------------------------------------------
# retain, add_rsp_rsp, scatter_op, the nd functions
# ---------------------------------------------------------------------------


def test_retain_and_add_rsp_rsp(no_densify):
    va, ra = _rows((12, 3), 5, seed=7)
    vb, rb = _rows((12, 3), 4, seed=8)
    ta = tsp.row_sparse_array((va, ra), shape=(12, 3), ctx=CPU)
    tb = tsp.row_sparse_array((vb, rb), shape=(12, 3), ctx=CPU)
    ja = jsp.row_sparse_array((va, ra), shape=(12, 3))
    jb = jsp.row_sparse_array((vb, rb), shape=(12, 3))
    keep = np.array([ra[1], ra[3], 11, 0], np.int64)
    _same_components(tsp.retain(ta, _t(keep)),
                     jsp.retain(ja, jmx.nd.array(keep)),
                     ("data", "indices"))
    t, j = tsp.add_rsp_rsp(ta, tb), jsp.add_rsp_rsp(ja, jb)
    _same_components(t, j, ("data", "indices"))
    np.testing.assert_array_equal(t.asnumpy(), ta.asnumpy() + tb.asnumpy())
    with pytest.raises(TError):
        tsp.retain(_t(va), _t(keep))
    np.testing.assert_array_equal(
        tmx.nd._sparse_retain(ta, _t(keep)).asnumpy(),
        jmx.nd._sparse_retain(jmx.nd.array(ja.asnumpy()),
                              jmx.nd.array(keep)).asnumpy())


@pytest.mark.parametrize("name", ["plus_scalar", "minus_scalar",
                                  "elemwise_div"])
def test_scatter_op(name, no_densify):
    vals, rows = _rows((6, 2), 3, seed=9)
    den = (np.random.RandomState(2).rand(6, 2) + 0.5).astype(np.float32)
    kw = {"other": _t(den)} if name == "elemwise_div" else {"scalar": 2.5}
    jkw = {"other": jmx.nd.array(den)} if name == "elemwise_div" \
        else {"scalar": 2.5}
    t = tsp.scatter_op(name, tsp.row_sparse_array(
        (vals, rows), shape=(6, 2), ctx=CPU), **kw)
    j = jsp.scatter_op(name, jsp.row_sparse_array(
        (vals, rows), shape=(6, 2)), **jkw)
    assert isinstance(t, tsp.RowSparseNDArray)
    _same_components(t, j, ("data", "indices"))
    d = _sparse_dense((4, 5), 0.4, seed=1)
    if name != "elemwise_div":
        tc = tsp.scatter_op(name, tsp.cast_storage(_t(d), "csr"), **kw)
        jc = jsp.scatter_op(name, jsp.cast_storage(jmx.nd.array(d), "csr"),
                            **jkw)
        _same_components(tc, jc, ("data", "indices", "indptr"))
    # dense input: the plain op; the nd function on a sparse input keeps
    # its storage
    dkw = {"other": _t(den)} if name == "elemwise_div" else {"scalar": 2.5}
    djkw = {"other": jmx.nd.array(den)} if name == "elemwise_div" \
        else {"scalar": 2.5}
    np.testing.assert_allclose(
        tsp.scatter_op(name, _t(den + 1), **dkw).asnumpy(),
        jsp.scatter_op(name, jmx.nd.array(den + 1), **djkw).asnumpy(),
        rtol=RTOL)
    fn = getattr(tmx.nd, "_scatter_" + name)
    args = (tsp.row_sparse_array((vals, rows), shape=(6, 2), ctx=CPU),)
    out = fn(*args, _t(den)) if name == "elemwise_div" \
        else fn(*args, scalar=2.5)
    assert isinstance(out, tsp.RowSparseNDArray)
    _same_components(out, j, ("data", "indices"))


@pytest.mark.parametrize("axis,keepdims", [(None, False), (0, False),
                                           (1, True), (1, False),
                                           ((0, 1), True)])
def test_square_sum_of_row_sparse(axis, keepdims, no_densify):
    vals, rows = _rows((7, 4), 3, seed=10)
    t = tsp.row_sparse_array((vals, rows), shape=(7, 4), ctx=CPU)
    got = tmx.nd._square_sum(t, axis=axis, keepdims=keepdims)
    dense = jsp.row_sparse_array((vals, rows), shape=(7, 4)).asnumpy()
    want = jmx.nd._square_sum(jmx.nd.array(dense), axis=axis,
                              keepdims=keepdims).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.asnumpy(), want, rtol=RTOL, atol=ATOL)


def test_sparse_adagrad_update_on_row_sparse_rows():
    r = np.random.RandomState(11)
    w = r.randn(6, 3).astype(np.float32)
    h = r.rand(6, 3).astype(np.float32)
    vals, rows = _rows((6, 3), 2, seed=12)
    attrs = {"lr": 0.1, "epsilon": 1e-7, "rescale_grad": 0.5,
             "clip_gradient": 0.8}
    tw, th = _t(w), _t(h)
    g = tsp.row_sparse_array((vals, rows), shape=(6, 3), ctx=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        tmx.nd._sparse_adagrad_update(tw, g, th, **attrs)
    jw, jh = jmx.nd.array(w), jmx.nd.array(h)
    jmx.nd._sparse_adagrad_update(jw, jmx.nd.array(g.asnumpy()), jh, **attrs)
    # a zero gradient row leaves weight and history as they were, so the
    # dense op agrees with the row-wise one everywhere
    np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), rtol=RTOL)
    np.testing.assert_allclose(th.asnumpy(), jh.asnumpy(), rtol=RTOL)
    others = np.setdiff1d(np.arange(6), rows)
    np.testing.assert_array_equal(tw.asnumpy()[others], w[others])
    with pytest.raises(TError, match="wd"):
        tmx.nd._sparse_adagrad_update(tw, g, th, lr=0.1, wd=0.1)


# ---------------------------------------------------------------------------
# dot and _csr_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("rhs_shape", ["matrix", "vector"])
def test_dot_and_csr_matmul_gradients(transpose_a, rhs_shape):
    d, vals, cols, indptr = _csr_parts((6, 5), 0.4, seed=13)
    n = d.shape[0] if transpose_a else d.shape[1]
    r = np.random.RandomState(14)
    rhs = r.randn(*((n, 3) if rhs_shape == "matrix" else (n,)))\
        .astype(np.float32)
    tc = tsp.csr_matrix((vals, cols, indptr), shape=d.shape, ctx=CPU)
    jc = jsp.csr_matrix((vals, cols, indptr), shape=d.shape)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        got = tsp.dot(tc, _t(rhs), transpose_a=transpose_a)
    want = jsp.dot(jc, jmx.nd.array(rhs), transpose_a=transpose_a)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.asnumpy(),
                               (d.T if transpose_a else d) @ rhs,
                               rtol=RTOL, atol=ATOL)
    # gradients of vals and rhs: torch autograd against jax.vjp
    rows = np.repeat(np.arange(d.shape[0]), np.diff(indptr))
    out_rows = d.shape[1] if transpose_a else d.shape[0]
    attrs = {"out_rows": out_rows, "transpose_a": transpose_a}
    cot = r.randn(*want.shape).astype(np.float32)
    jfn = jreg.get_op("_csr_matmul").fn
    _, vjp = jax.vjp(lambda v, b: jfn(v, jnp.asarray(cols.astype(np.int32)),
                                      jnp.asarray(rows.astype(np.int32)), b,
                                      **attrs), jnp.asarray(vals),
                     jnp.asarray(rhs))
    jgv, jgb = vjp(jnp.asarray(cot))
    tv = torch.tensor(vals, requires_grad=True)
    tb = torch.tensor(rhs, requires_grad=True)
    out = treg.get_op("_csr_matmul").fn(tv, torch.tensor(cols),
                                        torch.tensor(rows), tb, **attrs)
    gv, gb = torch.autograd.grad(out, [tv, tb], torch.tensor(cot))
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=RTOL,
                               atol=ATOL)


def test_dot_through_autograd_record():
    d, vals, cols, indptr = _csr_parts((5, 4), 0.5, seed=15)
    rhs = np.random.RandomState(16).randn(4, 2).astype(np.float32)
    tc = tsp.csr_matrix((vals, cols, indptr), shape=d.shape, ctx=CPU)
    tw = _t(rhs)
    tw.attach_grad()
    with tmx.autograd.record():
        y = tsp.dot(tc, tw)
        y.backward()
    jc = jsp.csr_matrix((vals, cols, indptr), shape=d.shape)
    jw = jmx.nd.array(rhs)
    jw.attach_grad()
    with jmx.autograd.record():
        jy = jsp.dot(jc, jw)
        jy.backward()
    np.testing.assert_allclose(tw.grad.asnumpy(), jw.grad.asnumpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw.grad.asnumpy(),
                               d.T @ np.ones((5, 2), np.float32), rtol=RTOL)


def test_dot_of_other_storage_is_dense():
    d = _sparse_dense((4, 3), 0.5, seed=17)
    rhs = np.random.RandomState(18).randn(3, 2).astype(np.float32)
    t = tsp.dot(tsp.cast_storage(_t(d), "row_sparse"), _t(rhs))
    j = jsp.dot(jsp.cast_storage(jmx.nd.array(d), "row_sparse"),
                jmx.nd.array(rhs))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# KVStore and the optimizers
# ---------------------------------------------------------------------------

KV_SHAPE = (40, 3)


def _kv_grads(step):
    """Two row-sparse gradients a step, their rows overlapping."""
    va, ra = _rows(KV_SHAPE, 6, seed=100 + step)
    vb, rb = _rows(KV_SHAPE, 5, seed=200 + step)
    return (va, ra), (vb, rb)


def _kv_pair(opt_kw):
    w0 = np.random.RandomState(3).randn(*KV_SHAPE).astype(np.float32)
    stores = []
    for pkg, arr in ((tmx, _t), (jmx, jmx.nd.array)):
        kv = pkg.kv.create("device")
        kv.init(7, arr(w0))
        if opt_kw is not None:
            kv.set_optimizer(pkg.optimizer.SGD(**opt_kw))
        stores.append(kv)
    return w0, stores


def _push_steps(stores, steps):
    touched = set()
    for s in range(steps):
        (va, ra), (vb, rb) = _kv_grads(s)
        touched |= set(ra) | set(rb)
        stores[0].push(7, [
            tsp.row_sparse_array((va, ra), shape=KV_SHAPE, ctx=CPU),
            tsp.row_sparse_array((vb, rb), shape=KV_SHAPE, ctx=CPU)])
        stores[1].push(7, [jsp.row_sparse_array((va, ra), shape=KV_SHAPE),
                           jsp.row_sparse_array((vb, rb), shape=KV_SHAPE)])
    return np.array(sorted(touched))


def test_kvstore_row_sparse_push_lazy_momentum_sgd():
    opt = dict(learning_rate=0.1, momentum=0.9, wd=1e-2, rescale_grad=0.5,
               clip_gradient=1.5, lazy_update=True)
    w0, (tkv, jkv) = _kv_pair(opt)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        touched = _push_steps((tkv, jkv), 3)
    tw, jw = tkv._store["7"].asnumpy(), jkv._store["7"].asnumpy()
    tm = tkv._updater.states[7].asnumpy()
    jm = jkv._updater.states[7].asnumpy()
    np.testing.assert_allclose(tw, jw, rtol=KV_RTOL, atol=0)
    np.testing.assert_allclose(tm, jm, rtol=KV_RTOL, atol=1e-9)
    untouched = np.setdiff1d(np.arange(KV_SHAPE[0]), touched)
    assert len(untouched) > 5
    np.testing.assert_array_equal(tw[untouched], w0[untouched])
    np.testing.assert_array_equal(tm[untouched], 0.0)
    np.testing.assert_array_equal(jw[untouched], w0[untouched])
    assert np.all(tm[touched] != 0)


def test_sgd_dense_update_decays_every_momentum_row():
    """lazy_update=False densifies (with the warning): the momentum of a
    row no gradient touched decays, where the lazy update keeps it."""
    w = _t(np.ones((4, 2), np.float32))
    g = tsp.row_sparse_array((np.ones((1, 2), np.float32), [1]),
                             shape=(4, 2), ctx=CPU)
    lazy = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
    dense = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                              lazy_update=False)
    for opt in (lazy, dense):
        m = _t(np.full((4, 2), 0.5, np.float32))
        wt = w.copy()
        if opt is dense:
            with pytest.warns(RuntimeWarning):
                opt.update(0, wt, g, m)
        else:
            opt.update(0, wt, g, m)
        got = m.asnumpy()
        assert got[1, 0] == np.float32(0.9 * 0.5 - 0.1)
        assert got[0, 0] == (0.5 if opt is lazy else np.float32(0.45))


def test_adam_densifies_a_row_sparse_gradient():
    w0 = np.random.RandomState(4).randn(5, 2).astype(np.float32)
    vals, rows = _rows((5, 2), 2, seed=5)
    tw, jw = _t(w0), jmx.nd.array(w0)
    to = tmx.optimizer.Adam(learning_rate=0.01, lazy_update=True)
    jo = jmx.optimizer.Adam(learning_rate=0.01, lazy_update=True)
    with pytest.warns(RuntimeWarning, match="densified"):
        to.update(0, tw, tsp.row_sparse_array((vals, rows), shape=(5, 2),
                                              ctx=CPU),
                  to.create_state(0, tw))
    with pytest.warns(RuntimeWarning):
        jo.update(0, jw, jsp.row_sparse_array((vals, rows), shape=(5, 2)),
                  jo.create_state(0, jw))
    np.testing.assert_allclose(tw.asnumpy(), jw.asnumpy(), rtol=RTOL)


def test_kvstore_row_sparse_push_without_updater_adds_rows():
    w0, (tkv, jkv) = _kv_pair(None)
    _push_steps((tkv, jkv), 2)
    np.testing.assert_allclose(tkv._store["7"].asnumpy(),
                               jkv._store["7"].asnumpy(), rtol=KV_RTOL)
    # a dense push still assigns (reference KVStoreLocal)
    tkv.push(7, _t(np.ones(KV_SHAPE, np.float32)))
    np.testing.assert_array_equal(tkv._store["7"].asnumpy(), 1.0)


def test_row_sparse_pull_into_row_sparse_out(no_densify):
    w0, (tkv, jkv) = _kv_pair(None)
    ids = np.array([9, 2, 9, 31, 0], np.int64)
    tout = tsp.zeros_sparse("row_sparse", KV_SHAPE, ctx=CPU)
    jout = jsp.zeros_sparse("row_sparse", KV_SHAPE)
    tkv.row_sparse_pull(7, out=tout, row_ids=_t(ids))
    jkv.row_sparse_pull(7, out=jout, row_ids=jmx.nd.array(ids))
    _same_components(tout, jout, ("data", "indices"))
    np.testing.assert_array_equal(tout.indices.asnumpy(), [0, 2, 9, 31])
    np.testing.assert_array_equal(tout.data.asnumpy(), w0[[0, 2, 9, 31]])
    assert tout.shape == KV_SHAPE
    # a dense out keeps the row-masked value
    dense = _t(np.full(KV_SHAPE, 7.0, np.float32))
    tkv.row_sparse_pull(7, out=dense, row_ids=_t(ids))
    want = np.zeros_like(w0)
    want[[0, 2, 9, 31]] = w0[[0, 2, 9, 31]]
    np.testing.assert_array_equal(dense.asnumpy(), want)


def test_mixed_storage_push_is_dense():
    w0, (tkv, _) = _kv_pair(None)
    va, ra = _rows(KV_SHAPE, 3, seed=1)
    rsp = tsp.row_sparse_array((va, ra), shape=KV_SHAPE, ctx=CPU)
    ones = np.ones(KV_SHAPE, np.float32)
    tkv.push(7, [rsp, _t(ones)])
    np.testing.assert_allclose(tkv._store["7"].asnumpy(),
                               rsp.asnumpy() + ones, rtol=RTOL)


def _server(n):
    srv = KVServer("127.0.0.1", 0, n, sync_mode=True)
    threading.Thread(target=srv.serve, daemon=True).start()
    return srv


def test_dist_device_sync_row_sparse_pull_two_workers():
    """Two workers of the port's parameter server: each pushes a
    row-sparse gradient (densified before the wire), the server sums
    them, and row_sparse_pull into a RowSparseNDArray gathers the
    requested rows of the pulled value."""
    srv = _server(2)
    clients = [WorkerClient("127.0.0.1", srv.port, rank=r, num_workers=2)
               for r in range(2)]
    stores = [tkvs.KVStoreDist("dist_device_sync", client=c)
              for c in clients]
    w0 = np.random.RandomState(5).randn(*KV_SHAPE).astype(np.float32)
    grads = [_rows(KV_SHAPE, 4, seed=300 + r) for r in range(2)]
    ids = np.array([grads[0][1][0], 5, grads[1][1][2], 5], np.int64)
    outs, errs = [None, None], []

    def worker(rank):
        try:
            kv = stores[rank]
            kv.init("emb", _t(w0))
            vals, rows = grads[rank]
            kv.push("emb", tsp.row_sparse_array((vals, rows),
                                                shape=KV_SHAPE, ctx=CPU))
            out = tsp.zeros_sparse("row_sparse", KV_SHAPE, ctx=CPU)
            kv.row_sparse_pull("emb", out=out, row_ids=_t(ids))
            outs[rank] = out
            kv.close()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in ts), "a worker thread hung"
    if errs:
        raise errs[0]
    total = sum(tsp.row_sparse_array(g, shape=KV_SHAPE, ctx=CPU).asnumpy()
                for g in grads)
    rows = np.unique(ids)
    for out in outs:
        assert isinstance(out, tsp.RowSparseNDArray)
        np.testing.assert_array_equal(out.indices.asnumpy(), rows)
        # the server without an optimizer assigns the round's sum
        np.testing.assert_allclose(out.data.asnumpy(), total[rows],
                                   rtol=RTOL)
    srv.close()


_RSP_WORKER = r"""
import json, os
import numpy as np
import mxnet_tpu_torch as mx
rank = int(os.environ["DMLC_WORKER_RANK"])
shape = (40, 3)
grads = []
for seed in (300, 301):
    r = np.random.RandomState(seed)
    rows = np.sort(r.choice(shape[0], 4, replace=False))
    grads.append((r.randn(4, 3).astype(np.float32), rows))
kv = mx.kv.create("dist_device_sync")
kv.init("emb", mx.nd.array(np.zeros(shape, np.float32), ctx=mx.cpu()))
kv.push("emb", mx.nd.sparse.row_sparse_array(grads[rank], shape=shape,
                                             ctx=mx.cpu()))
out = mx.nd.sparse.zeros_sparse("row_sparse", shape, ctx=mx.cpu())
ids = [grads[0][1][0], 5, grads[1][1][2], 5, grads[0][1][3]]
kv.row_sparse_pull("emb", out=out, row_ids=mx.nd.array(
    np.array(ids), ctx=mx.cpu()))
print("RESULT", json.dumps({
    "rank": kv.rank, "type": type(kv).__name__, "stype": out.stype,
    "ids": [int(i) for i in ids], "rows": out.indices.asnumpy().tolist(),
    "data": out.data.asnumpy().tolist()}), flush=True)
kv.close()
"""


def test_dist_device_sync_row_sparse_pull_two_processes():
    """The same through the port's launcher: a server and two worker
    processes, each pushing its row-sparse gradient and pulling rows
    into a RowSparseNDArray."""
    import json
    import sys

    from test_torch_kvstore_dist import _launch

    rc, out, err, left = _launch(2, [sys.executable, "-c", _RSP_WORKER],
                                 180)
    assert rc == 0, err[-3000:]
    assert left == []
    res = [json.loads(line[line.index("RESULT ") + 7:])
           for line in out.splitlines() if "RESULT " in line]
    assert sorted(r["rank"] for r in res) == [0, 1], (out[-2000:],
                                                      err[-2000:])
    total = np.zeros(KV_SHAPE, np.float32)
    for seed in (300, 301):
        r = np.random.RandomState(seed)
        rows = np.sort(r.choice(KV_SHAPE[0], 4, replace=False))
        total[rows] += r.randn(4, 3).astype(np.float32)
    for r in res:
        assert r["type"] == "KVStoreDist" and r["stype"] == "row_sparse"
        rows = np.unique(r["ids"])
        assert r["rows"] == rows.tolist()
        assert np.abs(total[rows]).min(axis=1).max() > 0
        np.testing.assert_allclose(r["data"], total[rows], rtol=RTOL)


# ---------------------------------------------------------------------------
# fault 10: Parameter(stype=, grad_stype=), row_sparse_data, SparseEmbedding
# ---------------------------------------------------------------------------


def test_parameter_stype_and_row_sparse_data():
    w = np.random.RandomState(19).randn(10, 4).astype(np.float32)
    for pkg, ctx in ((tmx, CPU), (jmx, None)):
        p = pkg.gluon.Parameter("w", shape=(10, 4), stype="row_sparse",
                                grad_stype="row_sparse")
        assert p._stype == "row_sparse" and p._grad_stype == "row_sparse"
        p.initialize(init=pkg.init.Zero(), ctx=ctx)
        p.set_data(pkg.nd.array(w) if ctx is None else _t(w))
        rows = pkg.nd.array(np.array([1, 3], np.float32)) if ctx is None \
            else _t(np.array([1, 3], np.float32))
        np.testing.assert_array_equal(p.row_sparse_data(rows).asnumpy(), w)
        assert len(p.list_row_sparse_data(rows)) == 1
        pd = pkg.gluon.ParameterDict("blk_")
        q = pd.get("emb", shape=(3, 2), stype="row_sparse",
                   grad_stype="row_sparse")
        assert q._stype == q._grad_stype == "row_sparse"
    x = np.array([[1, 3, 3], [0, 9, 1]], np.float32)
    cot = np.random.RandomState(20).randn(2, 3, 4).astype(np.float32)
    res = []
    for pkg, arr, ctx in ((tmx, _t, CPU), (jmx, jmx.nd.array, None)):
        blk = pkg.gluon.contrib.nn.SparseEmbedding(10, 4)
        assert blk.weight._stype == blk.weight._grad_stype == "row_sparse"
        blk.initialize(ctx=ctx)
        blk.weight.set_data(arr(w))
        xs = arr(x)
        with pkg.autograd.record():
            y = blk(xs)
            loss = (y * arr(cot)).sum()
        loss.backward()
        res.append((y.asnumpy(), blk.weight.grad().asnumpy()))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=RTOL)
    np.testing.assert_allclose(res[0][1], res[1][1], rtol=RTOL, atol=ATOL)
    assert np.all(res[0][1][[2, 4, 5, 6, 7, 8]] == 0)


# ---------------------------------------------------------------------------
# test_utils
# ---------------------------------------------------------------------------


def test_test_utils_rand_ndarray_and_assertions():
    from mxnet_tpu_torch import test_utils as tu

    tu.set_default_context(CPU)
    try:
        np.random.seed(0)
        rsp = tu.rand_ndarray((50, 4), "row_sparse", density=0.3)
        np.random.seed(0)
        want = jmx.test_utils.rand_ndarray((50, 4), "row_sparse",
                                           density=0.3)
        assert isinstance(rsp, tsp.RowSparseNDArray)
        _same_components(rsp, want, ("data", "indices"))
        csr = tu.rand_ndarray((6, 7), "csr", density=0.5)
        assert isinstance(csr, tsp.CSRNDArray) and csr.context == CPU
        csr.check_format()
        dense = tu.rand_ndarray((3, 2))
        assert dense.stype == "default" and dense.context == CPU
        tu.assert_almost_equal(dense, dense.asnumpy() + 1e-7)
        with pytest.raises(AssertionError, match="max abs err"):
            tu.assert_almost_equal(dense, dense.asnumpy() + 1.0)
        assert tu.same(dense, dense.asnumpy())
        assert tu.almost_equal(dense, dense.asnumpy())
        tu.assert_exception(lambda: 1 / 0, ZeroDivisionError)
        assert tu.default_context() == CPU
        assert len(tu.rand_shape_nd(3)) == 3
    finally:
        tu.set_default_context(None)


def test_test_utils_check_numeric_gradient(monkeypatch):
    from mxnet_tpu_torch import jit
    from mxnet_tpu_torch import test_utils as tu

    monkeypatch.setattr(jit, "_BACKEND", "aot_eager")
    x = tmx.sym.var("x")
    y = tmx.sym.var("y")
    sym = tmx.sym.sum(x * y + tmx.sym.square(x))
    r = np.random.RandomState(21)
    loc = {"x": r.randn(2, 3), "y": r.randn(2, 3)}
    tu.check_numeric_gradient(sym, loc, ctx=CPU, numeric_eps=1e-2,
                              rtol=1e-2, atol=1e-2)
    out = tu.simple_forward(sym, ctx=CPU, x=loc["x"].astype(np.float32),
                            y=loc["y"].astype(np.float32))
    np.testing.assert_allclose(out, np.sum(loc["x"] * loc["y"]
                                           + loc["x"] ** 2), rtol=1e-5)
