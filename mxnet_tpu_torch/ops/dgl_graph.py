"""DGL graph-sampling ops, ``mx.nd.contrib.dgl_*`` (parity:
mxnet_tpu/ops/dgl_graph.py; reference src/operator/contrib/dgl_graph.cc:
``_contrib_dgl_csr_neighbor_uniform_sample:766``, the non-uniform
variant, ``_contrib_dgl_subgraph:1141``, ``_contrib_edge_id:1300``,
``_contrib_dgl_adjacency:1376``, ``_contrib_dgl_graph_compact``).

These prepare graphs: hash maps, frontiers of variable size, outputs
whose size depends on the data.  The reference registers CPU kernels
only, and the JAX package runs them as host numpy over the CSR's
components; so does the port, drawing from ``random.host_rng()``.  A
call copies the graph's components to the host once and returns its
arrays on the graph's device.

Conventions shared with the reference:
- a graph is a square CSRNDArray whose ``data`` holds the edge ids;
- a sampled-vertex array has ``max_num_vertices + 1`` entries, the last
  the number of vertices sampled, unused ones -1.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array
from ..ndarray.sparse import CSRNDArray

__all__ = [
    "dgl_csr_neighbor_uniform_sample", "dgl_csr_neighbor_non_uniform_sample",
    "dgl_subgraph", "dgl_graph_compact", "dgl_adjacency", "edge_id",
]


def _host(x):
    """``x`` (an NDArray or array-like) as host numpy."""
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def _csr_parts(csr):
    """(data, indices, indptr) of a CSRNDArray as host int64 numpy, and
    the context its arrays lie in."""
    if not isinstance(csr, CSRNDArray):
        raise MXNetError("expected a CSRNDArray graph, got %r" % type(csr))
    return ((csr.data.asnumpy().astype(np.int64),
             csr.indices.asnumpy().astype(np.int64),
             csr.indptr.asnumpy().astype(np.int64)), csr.context)


def _make_csr(data, indices, indptr, shape, ctx):
    return CSRNDArray(array(np.asarray(data, np.int64), ctx=ctx),
                      array(np.asarray(indices, np.int64), ctx=ctx),
                      array(np.asarray(indptr, np.int64), ctx=ctx), shape)


def _pick_neighbors(cols, eids, limit, rng, prob=None):
    """At most ``limit`` of a row's edges: all of a small row (the
    reference's GetUniformSample fast path), else a draw without
    replacement, uniform or weighted by ``prob[col]`` (whose vertex and
    edge lists the reference then sorts each on its own)."""
    n = len(cols)
    if n <= limit:
        return cols, eids
    if prob is None:
        keep = np.sort(rng.choice(n, size=limit, replace=False))
        return cols[keep], eids[keep]
    w = prob[cols].astype(np.float64)
    w_sum = w.sum()
    if w_sum <= 0:
        raise MXNetError("non_uniform_sample: probabilities sum to zero "
                         "on a sampled row")
    keep = rng.choice(n, size=limit, replace=False, p=w / w_sum)
    return np.sort(cols[keep]), np.sort(eids[keep])


def _sample_one(parts, shape, seed_nd, prob, num_hops, num_neighbor,
                max_num_vertices, rng, ctx):
    """BFS neighbour sampling from one seed set (the reference's
    SampleSubgraph, dgl_graph.cc:530)."""
    vals, cols, indptr = parts
    seeds = _host(seed_nd).astype(np.int64).ravel()
    if max_num_vertices < len(seeds):
        raise MXNetError("max_num_vertices < number of seed vertices")

    level = {}          # vertex -> BFS layer
    frontier = []       # (vertex, layer) in discovery order
    for s in seeds:
        if s not in level:
            level[int(s)] = 0
            frontier.append((int(s), 0))

    picked = {}         # expanded vertex -> (neighbour cols, edge ids)
    idx = 0
    while idx < len(frontier) and len(level) < max_num_vertices:
        v, lay = frontier[idx]
        idx += 1
        if lay >= num_hops:
            continue
        lo, hi = indptr[v], indptr[v + 1]
        nbr, eid = _pick_neighbors(cols[lo:hi], vals[lo:hi], num_neighbor,
                                   rng, prob)
        picked[v] = (nbr, eid)
        for u in nbr:
            if len(level) >= max_num_vertices:
                break
            u = int(u)
            if u not in level:
                level[u] = lay + 1
                frontier.append((u, lay + 1))

    for v, lay in frontier[idx:]:
        if lay < num_hops:
            warnings.warn(
                "dgl sample truncated at max_num_vertices=%d before all "
                "hops were expanded; use fewer seeds or a larger budget"
                % max_num_vertices, RuntimeWarning)
            break

    verts = np.sort(np.fromiter(level.keys(), np.int64, len(level)))
    nv = len(verts)

    sample_id = np.full(max_num_vertices + 1, -1, np.int64)
    sample_id[:nv] = verts
    sample_id[-1] = nv
    layer = np.full(max_num_vertices, -1, np.int64)
    layer[:nv] = [level[int(v)] for v in verts]

    # the sub-graph's rows follow the sorted vertices; vertices not
    # expanded get empty rows, rows past nv repeat the last offset
    out_indptr = np.zeros(max_num_vertices + 1, np.int64)
    out_cols, out_eids = [], []
    for i, v in enumerate(verts):
        nbr, eid = picked.get(int(v), ((), ()))
        out_cols.extend(nbr)
        out_eids.extend(eid)
        out_indptr[i + 1] = len(out_cols)
    out_indptr[nv + 1:] = out_indptr[nv]
    sub_csr = _make_csr(out_eids, out_cols, out_indptr,
                        (max_num_vertices, shape[1]), ctx)

    outs = [array(sample_id, ctx=ctx), sub_csr]
    if prob is not None:
        sub_prob = np.full(max_num_vertices, -1, np.float32)
        sub_prob[:nv] = prob[verts]
        outs.append(array(sub_prob, ctx=ctx))
    outs.append(array(layer, ctx=ctx))
    return outs


def _sample(csr, seeds, prob, num_hops, num_neighbor, max_num_vertices):
    from .. import random as _random

    parts, ctx = _csr_parts(csr)
    rng = _random.host_rng()
    per_seed = [_sample_one(parts, csr.shape, s, prob, num_hops,
                            num_neighbor, max_num_vertices, rng, ctx)
                for s in seeds]
    # grouped as the reference's: every sample_id, every sub-graph, ...
    grouped = [out for group in zip(*per_seed) for out in group]
    return grouped[0] if len(grouped) == 1 else grouped


def _sample_attrs(kwargs):
    kwargs.pop("num_args", None)
    return (int(kwargs.pop("num_hops", 1)),
            int(kwargs.pop("num_neighbor", 2)),
            int(kwargs.pop("max_num_vertices", 100)))


def dgl_csr_neighbor_uniform_sample(csr, *seeds, **kwargs):
    """Uniform neighbour sampling.  Per seed array: the sampled vertex ids
    (max_num_vertices + 1, the last the count), a sub-graph CSR whose
    data are the original edge ids, and each vertex's BFS layer."""
    return _sample(csr, seeds, None, *_sample_attrs(kwargs))


def dgl_csr_neighbor_non_uniform_sample(csr, probability, *seeds, **kwargs):
    """Neighbour sampling weighted by ``probability`` (one a vertex); adds
    each sampled vertex's probability between the sub-graph and the
    layers."""
    prob = _host(probability).astype(np.float32)
    return _sample(csr, seeds, prob, *_sample_attrs(kwargs))


def dgl_subgraph(csr, *vlists, **kwargs):
    """The subgraph each (sorted) vertex list induces: vertices
    renumbered 0..n-1, the edges between listed vertices kept, their data
    renumbered to new edge ids; with ``return_mapping`` a second CSR each
    holds the original edge ids."""
    return_mapping = bool(kwargs.pop("return_mapping", False))
    kwargs.pop("num_args", None)
    (vals, cols, indptr), ctx = _csr_parts(csr)
    subs, mappings = [], []
    for vl in vlists:
        vid = _host(vl).astype(np.int64).ravel()
        if np.any(np.diff(vid) < 0):
            raise MXNetError("dgl_subgraph: vertex list must be sorted")
        old2new = {int(v): i for i, v in enumerate(vid)}
        n = len(vid)
        out_indptr = np.zeros(n + 1, np.int64)
        new_cols, orig_eids = [], []
        for i, v in enumerate(vid):
            for j in range(indptr[v], indptr[v + 1]):
                nc = old2new.get(int(cols[j]))
                if nc is not None:
                    new_cols.append(nc)
                    orig_eids.append(vals[j])
            out_indptr[i + 1] = len(new_cols)
        subs.append(_make_csr(np.arange(len(new_cols), dtype=np.int64),
                              new_cols, out_indptr, (n, n), ctx))
        if return_mapping:
            mappings.append(_make_csr(orig_eids, new_cols, out_indptr,
                                      (n, n), ctx))
    outs = subs + mappings
    return outs[0] if len(outs) == 1 else outs


def dgl_graph_compact(*args, **kwargs):
    """Renumber sampled sub-graphs' global vertex ids to 0..size-1 from
    their sampled-id arrays, giving square CSRs.  Inputs are (csr1, ...,
    csrN, vids1, ..., vidsN) with ``graph_sizes`` one a graph."""
    return_mapping = bool(kwargs.pop("return_mapping", False))
    graph_sizes = kwargs.pop("graph_sizes")
    kwargs.pop("num_args", None)
    if isinstance(graph_sizes, (int, np.integer)):
        graph_sizes = (graph_sizes,)
    graph_sizes = tuple(int(g) for g in graph_sizes)
    num_g = len(args) // 2
    if len(args) != 2 * num_g or num_g != len(graph_sizes):
        raise MXNetError("dgl_graph_compact: need one vid array and one "
                         "graph_size per input graph")
    outs, mappings = [], []
    for g in range(num_g):
        csr, vids, size = args[g], args[g + num_g], graph_sizes[g]
        (vals, cols, indptr), ctx = _csr_parts(csr)
        ids = _host(vids).astype(np.int64).ravel()
        if int(ids[-1]) != size:
            raise MXNetError("dgl_graph_compact: vid array's last element "
                             "must equal graph_sizes")
        old2new = {int(v): i for i, v in enumerate(ids[:size])}
        if -1 in old2new:
            raise MXNetError("dgl_graph_compact: -1 in the first "
                             "graph_size vertex ids")
        out_indptr = indptr[:size + 1]
        nnz = int(out_indptr[-1])
        try:
            new_cols = np.fromiter((old2new[int(c)] for c in cols[:nnz]),
                                   np.int64, nnz)
        except KeyError as e:
            raise MXNetError(
                "dgl_graph_compact: sub-graph references vertex %s that "
                "is not among the first graph_size sampled ids (the "
                "sample was likely truncated at max_num_vertices)"
                % e.args[0]) from None
        outs.append(_make_csr(np.arange(nnz, dtype=np.int64), new_cols,
                              out_indptr, (size, size), ctx))
        if return_mapping:
            mappings.append(_make_csr(vals[:nnz], new_cols, out_indptr,
                                      (size, size), ctx))
    outs = outs + mappings
    return outs[0] if len(outs) == 1 else outs


def dgl_adjacency(csr):
    """The graph's adjacency matrix: its sparsity, f32 ones as data
    (reference DGLAdjacencyForwardEx)."""
    (_, cols, indptr), ctx = _csr_parts(csr)
    return CSRNDArray(array(np.ones(len(cols), np.float32), ctx=ctx),
                      array(cols, ctx=ctx), array(indptr, ctx=ctx),
                      csr.shape)


def edge_id(csr, u, v):
    """``data[u[i], v[i]]`` for each pair, or -1 where there is no such
    edge, in the CSR data's type (reference EdgeIDForwardCsrImpl)."""
    (vals, cols, indptr), ctx = _csr_parts(csr)
    uu = _host(u).astype(np.int64).ravel()
    vv = _host(v).astype(np.int64).ravel()
    out = np.full(len(uu), -1, vals.dtype)
    for i, (a, b) in enumerate(zip(uu, vv)):
        lo, hi = indptr[a], indptr[a + 1]
        hit = np.nonzero(cols[lo:hi] == b)[0]
        if len(hit):
            out[i] = vals[lo + hit[0]]
    return array(out, ctx=ctx)
