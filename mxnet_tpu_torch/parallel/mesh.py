"""Device mesh and ``shard_map`` for the port (counterpart of
``mxnet_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, one device per rank, with named axes in
``MESH_AXES`` order; each axis has its own process sub-group, which the
collectives of ``parallel.collectives`` use.  ``shard_map`` runs a
function SPMD on every rank: it slices each global tensor to this
rank's shard, binds the mesh's axis names, runs the function and
all-gathers the outputs, so every rank returns the global result as a
JAX ``shard_map`` does.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..context import Context, current_context
from . import collectives

__all__ = ["make_mesh", "local_mesh", "MeshConfig", "shard_map", "P",
           "PartitionSpec", "parse_mesh", "require_axes", "mesh_shape",
           "MESH_AXES", "DATA_AXES"]

# Canonical axis order, outermost first: dp neighbors sit farthest apart,
# fsdp next, and mp/tp innermost (the JAX package's layout recipe).
MESH_AXES = ("dp", "fsdp", "pp", "ep", "sp", "mp", "tp")

# Axes the *batch* dimension shards over.
DATA_AXES = ("dp", "fsdp")


class PartitionSpec(tuple):
    """One entry per leading tensor dim: ``None`` (replicated) or a mesh
    axis name (sharded over it).  Dims past the last entry are
    replicated, as in JAX."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


P = PartitionSpec


class MeshConfig:
    """Named axis sizes for a parallelism layout."""

    def __init__(self, dp=1, tp=1, pp=1, sp=1, ep=1, fsdp=1):
        self.dp, self.tp, self.pp, self.sp, self.ep = dp, tp, pp, sp, ep
        self.fsdp = fsdp

    def axes(self):
        return {k: v for k, v in
                (("dp", self.dp), ("fsdp", self.fsdp), ("tp", self.tp),
                 ("pp", self.pp), ("sp", self.sp), ("ep", self.ep))
                if v > 1} or {"dp": 1}


def _world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def parse_mesh(spec):
    """Parse a mesh spec string like ``"dp=2,fsdp=2,tp=2"`` into an axis
    dict.

    Also accepts a dict / :class:`MeshConfig` (returned as axes) and
    ``None``/``""`` (returns None).  Axis names are validated against
    :data:`MESH_AXES`; sizes must be positive ints.  ``"auto"`` maps the
    ranks of the default process group (one device each; 1 without a
    group) onto a single ``dp`` axis."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, MeshConfig):
        return spec.axes()
    if isinstance(spec, dict):
        axes = dict(spec)
    else:
        if not isinstance(spec, str):
            raise ValueError("mesh spec must be a 'dp=2,fsdp=2' string, "
                             "dict, or MeshConfig; got %r" % (spec,))
        if spec.strip() == "auto":
            return {"dp": _world_size()}
        axes = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError("bad mesh spec %r: each entry must be "
                                 "axis=size (e.g. 'dp=2,fsdp=2')" % (spec,))
            name, _, size = part.partition("=")
            axes[name.strip()] = size.strip()
    out = {}
    for name, size in axes.items():
        if name not in MESH_AXES:
            raise ValueError("unknown mesh axis %r (supported: %s)"
                             % (name, list(MESH_AXES)))
        try:
            n = int(size)
        except (TypeError, ValueError):
            n = -1
        if n < 1:
            raise ValueError("mesh axis %s=%r must be a positive int"
                             % (name, size))
        out[name] = n
    return out or None


def mesh_shape(mesh):
    """``{axis: size}`` of a mesh (``{}`` for None)."""
    if mesh is None:
        return {}
    return {str(a): int(s) for a, s in zip(mesh.mesh_dim_names,
                                           mesh.mesh.shape)}


def require_axes(mesh, axes, who="this module"):
    """Loud validation that ``mesh`` carries every named axis."""
    if isinstance(axes, str):
        axes = (axes,)
    have = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    missing = [a for a in axes if a not in have]
    if missing:
        raise ValueError(
            "%s needs mesh axis(es) %s but the mesh has %s — build the "
            "mesh with make_mesh({'%s': N, ...}) or mesh='%s=N'"
            % (who, missing, list(have) or "no axes", missing[0],
               missing[0]))
    return mesh


def _device_type(devices):
    if devices is None:
        devices = current_context()
    if isinstance(devices, Context):
        devices = devices.torch_device
    kind = torch.device(devices).type
    if kind not in ("cuda", "cpu"):
        raise ValueError("make_mesh: devices must be 'cuda' or 'cpu' (or a "
                         "Context or torch.device); got %r" % (devices,))
    return kind


def make_mesh(axes=None, devices=None):
    """Build a ``DeviceMesh`` from named axis sizes, e.g. {'dp': 2, 'sp': 2}.

    ``devices`` names the device type of every rank: ``'cuda'`` or
    ``'cpu'``, a ``torch.device`` or a ``Context`` (default: the current
    context, ``gpu(0)`` unless a ``cpu()`` scope is active).  The mesh
    covers every rank of the default process group, in ``MESH_AXES``
    order.  Without a process group, a mesh of one device starts a
    one-rank group itself (NCCL for CUDA, gloo for the CPU, over an
    in-process store); a larger mesh needs
    ``torch.distributed.init_process_group`` to have run on every rank.
    Unknown axis names raise."""
    kind = _device_type(devices)
    if axes is None:
        axes = {"dp": _world_size()}
    unknown = [a for a in axes if a not in MESH_AXES]
    if unknown:
        raise ValueError("unknown mesh axis names %s (supported: %s)"
                         % (unknown, list(MESH_AXES)))
    order = [a for a in MESH_AXES if a in axes]
    sizes = [int(axes[a]) for a in order]
    n = math.prod(sizes)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                "make_mesh(%s) needs %d ranks: call "
                "torch.distributed.init_process_group on every rank first"
                % (dict(axes), n))
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n != world:
        raise ValueError("mesh needs %d devices, the process group has %d "
                         "ranks (the mesh covers every rank)" % (n, world))
    from .. import telemetry as _telemetry

    # topology gauge: one series per axis of the most recent mesh (a
    # no-op with telemetry off)
    for a, s in zip(order, sizes):
        _telemetry.MESH_DEVICES.set(int(s), axis=a)
    return DeviceMesh(kind, torch.arange(n).reshape(sizes),
                      mesh_dim_names=tuple(order))


def local_mesh(dp=None):
    """Mesh over every rank with one 'dp' axis."""
    return make_mesh({"dp": dp or _world_size()})


def _dims(spec, ndim):
    """(dim, axis) pairs of a spec for a tensor of ``ndim`` dims."""
    if len(spec) > ndim:
        raise ValueError("spec %r has more entries than the tensor's %d "
                         "dims" % (spec, ndim))
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def shard_map(f, mesh, in_specs, out_specs):
    """Run ``f`` SPMD over ``mesh`` (``jax.shard_map``, narrowed to what
    the sequence-parallel engines use: tensor arguments, one tensor out).

    ``in_specs`` has one :class:`P` per argument and ``out_specs`` is one
    :class:`P`, each entry ``None`` or an axis name.  Every rank slices
    each global tensor to its shard, runs ``f`` with the mesh's axis
    names bound (for ``parallel.collectives``), and all-gathers the
    output by ``out_specs``, so every rank returns the global tensor.
    Slicing and gathering are autograd-aware: gradients of the global
    inputs come back whole on every rank."""
    for spec in tuple(in_specs) + (out_specs,):
        require_axes(mesh, [a for a in spec if a is not None],
                     who="shard_map")

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError("shard_map: %d arguments for %d in_specs"
                            % (len(args), len(in_specs)))
        local = []
        for x, spec in zip(args, in_specs):
            for dim, axis in _dims(spec, x.dim()):
                x = collectives.shard(x, mesh, axis, dim)
            local.append(x)
        with collectives.bind_mesh(mesh):
            out = f(*local)
        for dim, axis in _dims(out_specs, out.dim()):
            out = collectives.gather(out, mesh, axis, dim)
        return out

    return run
