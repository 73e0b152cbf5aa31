"""The port's DGL graph ops (mxnet_tpu_torch/ops/dgl_graph.py, exported
by ``mx.nd.contrib``) and ``rand_zipfian`` held against the JAX package's
on the CPU.

Both packages sample on the host with numpy; each test points both
packages' ``random.host_rng`` at its own ``np.random.RandomState`` of one
seed, so the same draws happen in the same order and every output agrees
exactly: the sampled ids, layers and probabilities by value, each
sub-graph CSR by its shape and components.  ``rand_zipfian`` draws its
uniforms from each package's device stream, so it is held to the
distribution's mean and variance within 5 standard errors over 10^5
draws, and its expected counts to the JAX function's formula.  Matmul
precision is pinned (JAX "float32", torch "highest"), as in every
parity test, though these functions multiply no matrices.
"""
import math

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
SE = 5.0


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _graph(n=30, degree=6, seed=0):
    """A random directed graph without self loops: (data = edge ids
    1..nnz, indices, indptr)."""
    r = np.random.RandomState(seed)
    cols, indptr = [], [0]
    for v in range(n):
        k = r.randint(1, 2 * degree)
        nbr = np.sort(r.choice(np.setdiff1d(np.arange(n), [v]), k,
                               replace=False))
        cols.extend(nbr)
        indptr.append(len(cols))
    cols = np.array(cols, np.int64)
    return (np.arange(1, len(cols) + 1, dtype=np.int64), cols,
            np.array(indptr, np.int64), (n, n))


def _pair(graph):
    data, cols, indptr, shape = graph
    return (tmx.nd.sparse.csr_matrix((data, cols, indptr), shape=shape,
                                     ctx=CPU, dtype=np.int64),
            jmx.nd.sparse.csr_matrix((data, cols, indptr), shape=shape,
                                     dtype=np.int64))


@pytest.fixture
def same_host_rng(monkeypatch):
    def seed(s):
        t, j = np.random.RandomState(s), np.random.RandomState(s)
        monkeypatch.setattr(tmx.random, "host_rng", lambda: t)
        monkeypatch.setattr(jmx.random, "host_rng", lambda: j)
    return seed


def _equal(got, want):
    got = got if isinstance(got, list) else [got]
    want = want if isinstance(want, list) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g).__name__ == type(w).__name__
        assert g.shape == w.shape
        if g.stype == "csr":
            assert g.context == CPU
            for part in ("data", "indices", "indptr"):
                np.testing.assert_array_equal(
                    getattr(g, part).asnumpy(), getattr(w, part).asnumpy(),
                    err_msg=part)
        else:
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())


def _ids(pkg, values):
    arr = np.array(values, np.int64)
    return pkg.nd.array(arr, ctx=CPU) if pkg is tmx else pkg.nd.array(arr)


@pytest.mark.parametrize("seeds,hops,neighbors,max_v", [
    ([[0, 1, 2, 3, 4]], 1, 2, 12),
    ([[0]], 2, 3, 10),
    ([[5]], 3, 2, 6),
    ([[0, 7], [3, 11, 20]], 2, 2, 15),
])
def test_uniform_sample(same_host_rng, seeds, hops, neighbors, max_v):
    tg, jg = _pair(_graph())
    same_host_rng(3)
    kw = dict(num_args=1 + len(seeds), num_hops=hops,
              num_neighbor=neighbors, max_num_vertices=max_v)
    got = tmx.nd.contrib.dgl_csr_neighbor_uniform_sample(
        tg, *[_ids(tmx, s) for s in seeds], **kw)
    want = jmx.nd.contrib.dgl_csr_neighbor_uniform_sample(
        jg, *[_ids(jmx, s) for s in seeds], **kw)
    assert len(got) == 3 * len(seeds)
    _equal(got, want)
    got[len(seeds)].check_format(full_check=True)


def test_non_uniform_sample(same_host_rng):
    tg, jg = _pair(_graph(seed=1))
    prob = np.random.RandomState(4).rand(30).astype(np.float32)
    same_host_rng(5)
    kw = dict(num_args=3, num_hops=2, num_neighbor=2, max_num_vertices=14)
    got = tmx.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
        tg, tmx.nd.array(prob, ctx=CPU), _ids(tmx, [0, 4, 9]), **kw)
    want = jmx.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
        jg, jmx.nd.array(prob), _ids(jmx, [0, 4, 9]), **kw)
    assert len(got) == 4
    _equal(got, want)


@pytest.mark.parametrize("return_mapping", [False, True])
def test_subgraph(return_mapping):
    tg, jg = _pair(_graph(seed=2))
    vlists = [[0, 1, 3, 8, 20], [2, 5, 6, 7, 11, 12, 29]]
    kw = dict(num_args=3, return_mapping=return_mapping)
    got = tmx.nd.contrib.dgl_subgraph(tg, *[_ids(tmx, v) for v in vlists],
                                      **kw)
    want = jmx.nd.contrib.dgl_subgraph(jg, *[_ids(jmx, v) for v in vlists],
                                       **kw)
    assert len(got) == (4 if return_mapping else 2)
    _equal(got, want)
    with pytest.raises(tmx.base.MXNetError, match="sorted"):
        tmx.nd.contrib.dgl_subgraph(tg, _ids(tmx, [3, 1]))


def test_graph_compact(same_host_rng):
    tg, jg = _pair(_graph(seed=3))
    same_host_rng(6)
    kw = dict(num_args=2, num_hops=2, num_neighbor=3, max_num_vertices=40)
    tid, tsub, _ = tmx.nd.contrib.dgl_csr_neighbor_uniform_sample(
        tg, _ids(tmx, [0, 1]), **kw)
    jid, jsub, _ = jmx.nd.contrib.dgl_csr_neighbor_uniform_sample(
        jg, _ids(jmx, [0, 1]), **kw)
    n = int(tid.asnumpy()[-1])
    for mapping in (False, True):
        got = tmx.nd.contrib.dgl_graph_compact(
            tsub, tid, graph_sizes=n, return_mapping=mapping)
        want = jmx.nd.contrib.dgl_graph_compact(
            jsub, jid, graph_sizes=n, return_mapping=mapping)
        _equal(got, want)
    with pytest.raises(tmx.base.MXNetError, match="graph_sizes"):
        tmx.nd.contrib.dgl_graph_compact(tsub, tid, graph_sizes=n + 1)


def test_adjacency_and_edge_id():
    tg, jg = _pair(_graph(seed=4))
    _equal(tmx.nd.contrib.dgl_adjacency(tg),
           jmx.nd.contrib.dgl_adjacency(jg))
    assert tmx.nd.contrib.dgl_adjacency(tg).dtype == np.float32
    u, v = [0, 0, 2, 7, 29, 13], [1, 0, 3, 7, 28, 2]
    _equal(tmx.nd.contrib.edge_id(tg, _ids(tmx, u), _ids(tmx, v)),
           jmx.nd.contrib.edge_id(jg, _ids(jmx, u), _ids(jmx, v)))


def test_rand_zipfian_moments_and_expected_counts():
    n, rmax = 10 ** 5, 1000
    true = np.array([0, 5, 999], np.float32)
    tmx.random.seed(11)
    sampled, exp_true, exp_sampled = tmx.nd.contrib.rand_zipfian(
        tmx.nd.array(true, ctx=CPU), n, rmax)
    assert sampled.shape == (n,) and sampled.dtype == np.int32
    assert sampled.context == CPU
    k = np.arange(rmax, dtype=np.float64)
    p = (np.log(k + 2) - np.log(k + 1)) / np.log(rmax + 1)
    mean, var = (p * k).sum(), (p * k * k).sum() - (p * k).sum() ** 2
    v = sampled.asnumpy().astype(np.float64)
    assert v.min() >= 0 and v.max() < rmax
    dev2 = (v - v.mean()) ** 2
    assert abs(v.mean() - mean) / math.sqrt(var / n) <= SE
    assert abs(dev2.mean() - var) / (dev2.std() / math.sqrt(n)) <= SE
    _, jexp_true, _ = jmx.nd.contrib.rand_zipfian(jmx.nd.array(true), n,
                                                  rmax)
    np.testing.assert_allclose(exp_true.asnumpy(), jexp_true.asnumpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        exp_sampled.asnumpy(),
        (np.log((v + 2) / (v + 1)) / np.log(rmax + 1) * n)
        .astype(np.float32), rtol=1e-6)
    tmx.random.seed(11)
    again = tmx.nd.contrib.rand_zipfian(tmx.nd.array(true, ctx=CPU), n,
                                        rmax)[0]
    np.testing.assert_array_equal(again.asnumpy(), sampled.asnumpy())


def test_host_rng_follows_seed():
    tmx.random.seed(42)
    a = tmx.random.host_rng().rand(3)
    tmx.random.seed(42)
    np.testing.assert_array_equal(tmx.random.host_rng().rand(3), a)
    np.testing.assert_array_equal(np.random.RandomState(42).rand(3), a)
