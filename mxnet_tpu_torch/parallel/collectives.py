"""Collectives by mesh axis name, for code run under ``shard_map``.

What ``jax.lax`` gives the sequence-parallel engines inside a JAX
``shard_map`` (``axis_size``, ``axis_index``, ``ppermute`` and tiled
``all_to_all``), on the process sub-group of one axis of the
``DeviceMesh`` that ``shard_map`` binds for the call.  Both data movers
are autograd-aware: ``ppermute``'s backward sends the gradient along the
inverse permutation, ``all_to_all``'s backward is the inverse
all-to-all.  On an axis of size 1 both are the identity, as in JAX.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

__all__ = ["axis_size", "axis_index", "ppermute", "all_to_all", "bind_mesh"]

_bound = threading.local()


@contextlib.contextmanager
def bind_mesh(mesh):
    """Bind ``mesh``'s axis names for the calls made inside the block."""
    stack = _bound.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def _bound_mesh(axis_name):
    stack = getattr(_bound, "stack", None)
    mesh = stack[-1] if stack else None
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        raise NameError("unbound axis name %r: call inside shard_map over a "
                        "mesh with that axis" % (axis_name,))
    return mesh


def _size(mesh, axis_name):
    return mesh.mesh.shape[mesh.mesh_dim_names.index(axis_name)]


def axis_size(axis_name):
    """Number of ranks along ``axis_name`` (``lax.psum(1, axis_name)``)."""
    return _size(_bound_mesh(axis_name), axis_name)


def axis_index(axis_name):
    """This rank's index along ``axis_name`` (``lax.axis_index``)."""
    return _bound_mesh(axis_name).get_local_rank(axis_name)


def _ppermute(x, mesh, axis_name, perm):
    x = x.contiguous()  # gloo and NCCL send and receive dense buffers
    me = mesh.get_local_rank(axis_name)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if not srcs:  # nothing arrives here: zeros, as in JAX
        out = torch.zeros_like(x)
    elif srcs == [me]:
        out = x.clone()
    else:
        out = torch.empty_like(x)
    group = mesh.get_group(axis_name)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, d), group)
           for d in dsts if d != me]
    ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group)
            for s in srcs if s != me]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, perm):
        ctx.mesh, ctx.axis_name = mesh, axis_name
        ctx.inverse = [(d, s) for s, d in perm]
        return _ppermute(x, mesh, axis_name, perm)

    @staticmethod
    def backward(ctx, g):
        return (_ppermute(g, ctx.mesh, ctx.axis_name, ctx.inverse),
                None, None, None)


def ppermute(x, axis_name, perm):
    """Send ``x`` from axis index ``s`` to ``d`` for each ``(s, d)`` in
    ``perm`` (``lax.ppermute``); an index nothing is sent to gets zeros."""
    mesh = _bound_mesh(axis_name)
    perm = [(int(s), int(d)) for s, d in perm]
    if len({s for s, _ in perm}) != len(perm) or \
            len({d for _, d in perm}) != len(perm):
        raise ValueError("ppermute: %s is not a permutation" % (perm,))
    if _size(mesh, axis_name) == 1 and perm == [(0, 0)]:
        return x
    return _PPermute.apply(x, mesh, axis_name, perm)


def _all_to_all(x, mesh, axis_name, split_axis, concat_axis):
    n = _size(mesh, axis_name)
    if x.shape[split_axis] % n:
        raise ValueError("all_to_all: dimension %d of size %d does not split "
                         "into %d chunks" % (split_axis, x.shape[split_axis],
                                             n))
    xs = x.movedim(split_axis, 0)
    send = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis_name))
    # recv[j] is rank j's chunk for this rank: concatenate in rank order
    return torch.cat([recv[j].movedim(0, split_axis) for j in range(n)],
                     dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis_name, split_axis, concat_axis):
        ctx.args = (mesh, axis_name, concat_axis, split_axis)
        return _all_to_all(x, mesh, axis_name, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, *ctx.args),) + (None,) * 4


def all_to_all(x, axis_name, split_axis, concat_axis):
    """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``): split
    ``split_axis`` into one chunk per rank, send chunk ``j`` to rank ``j``
    and concatenate the chunks received along ``concat_axis`` in rank
    order."""
    mesh = _bound_mesh(axis_name)
    if _size(mesh, axis_name) == 1:
        return x
    return _AllToAll.apply(x, mesh, axis_name, split_axis % x.dim(),
                           concat_axis % x.dim())


def _all_gather(x, mesh, axis_name, dim):
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(mesh, axis_name))]
    dist.all_gather(parts, x, group=mesh.get_group(axis_name))
    return torch.cat(parts, dim=dim)


def _my_chunk(x, mesh, axis_name, dim):
    n = _size(mesh, axis_name)
    if x.shape[dim] % n:
        raise ValueError("dimension %d of size %d is not divisible by the "
                         "'%s' axis size %d" % (dim, x.shape[dim], axis_name,
                                                n))
    c = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis_name) * c, c)


class _Shard(torch.autograd.Function):
    """This rank's chunk of a global tensor; the backward all-gathers the
    chunks' gradients into the global gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name, dim):
        ctx.args = (mesh, axis_name, dim)
        return _my_chunk(x, mesh, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_gather(g, *ctx.args),) + (None,) * 3


class _Gather(torch.autograd.Function):
    """The global tensor from every rank's chunk; the backward keeps this
    rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis_name, dim):
        ctx.args = (mesh, axis_name, dim)
        return _all_gather(x, mesh, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        return (_my_chunk(g, *ctx.args).contiguous(),) + (None,) * 3


def shard(x, mesh, axis_name, dim):
    """This rank's chunk of ``x`` along ``dim`` over ``axis_name``."""
    if _size(mesh, axis_name) == 1:
        return x
    return _Shard.apply(x, mesh, axis_name, dim)


def gather(x, mesh, axis_name, dim):
    """Every rank's chunk along ``dim`` over ``axis_name``, concatenated in
    rank order."""
    if _size(mesh, axis_name) == 1:
        return x
    return _Gather.apply(x, mesh, axis_name, dim)
