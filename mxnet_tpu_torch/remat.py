"""Activation rematerialization (parity: mxnet_tpu/remat.py).

One registry maps the JAX package's policy names onto non-reentrant
``torch.utils.checkpoint`` with selective-checkpoint contexts, so every
entry point spells them the same way:

* ``Executor`` / ``Symbol.bind`` / ``simple_bind`` (``remat_policy=``)
* ``gluon.HybridBlock.hybridize(remat_policy=...)``, through ``CachedOp``
* ``Module(..., remat_policy=...)`` and
  ``parallel.ShardedTrainer(..., remat_policy=...)``
* ``MXNET_REMAT_POLICY`` (config.py), the default of all of the above
  when the keyword is left unset.

The policies follow jax's own definitions (``jax/_src/ad_checkpoint.py``):

==================================  =====================================
policy                              saved in the forward; the rest is
                                    recomputed in the backward
==================================  =====================================
``full``, ``nothing_saveable``      nothing but the region's inputs
``dots_saveable``                   outputs of ``mm``, ``addmm``, ``bmm``,
                                    ``baddbmm``, ``convolution``,
                                    ``_scaled_mm``
``dots_with_no_batch_dims_saveable``  outputs of ``mm`` and ``addmm``
``everything_saveable``             everything (a no-op barrier)
``offload_dots``                    the ``mm`` / ``addmm`` outputs, parked
                                    in pinned host memory
==================================  =====================================

Random ops (``torch.Tag.nondeterministic_seeded``) are always saved by
the selective policies.  Where a region is recomputed whole (``full``),
the framework generators of ``mx.random`` are rewound to their state at
the region's forward, so dropout draws the same mask, and set back after,
so the stream advances once.

**A region carries its own setup.**  Eager recomputation runs inside
``backward``, on a CUDA tensor's autograd thread, after the caller's
scopes have closed.  So each region captures, at its forward, the
framework's thread-local state it reads (autograd's recording and
training flags, the dtype-policy and fusion scopes, the block's trace,
swap and probe flags, the generators) and the tensors its parameters
hold, and installs them around the recompute; BatchNorm's moving-stat
updates of a recompute go to a throwaway aux sink, never pushed twice.
Under ``torch.compile`` the region traces as one checkpoint region with
no graph break, and the partitioner recomputes it at graph level.

**Granularity.**  A compiled region (``CachedOp``, ``Executor``) is the
whole function, as in the JAX package: the compiler schedules the
recompute op by op.  Eager recomputation of one region rebuilds every
activation at once at the start of ``backward`` and saves no memory, so
the eager ``ShardedTrainer`` makes each child of the net's outermost
sequential container (:func:`segments`) a region of its own, recomputed
when the backward reaches it; the ops outside them (the head, the loss)
save as usual.  A net with no sequential container is one region.
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["list_policies", "resolve_policy", "apply_remat",
           "checkpoint_region", "segments", "segment_scope"]

_aten = torch.ops.aten
_DOTS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
                   _aten.convolution, _aten._scaled_mm))
_NO_BATCH_DOTS = frozenset((_aten.mm, _aten.addmm))


def _is_random(op):
    return torch.Tag.nondeterministic_seeded in op.tags


def _saving(packets):
    """A selective-checkpoint policy that saves the outputs of the ops in
    ``packets`` (and every random op) and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    def policy(ctx, op, *args, **kwargs):
        if op.overloadpacket in packets or _is_random(op):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _everything(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE


def _offload_tags(ctx, op, *args, **kwargs):
    """``offload_dots`` under ``torch.compile``: the ``mm`` / ``addmm``
    outputs are tagged for the partitioner's CPU offload."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op.overloadpacket in _NO_BATCH_DOTS:
        return CheckpointPolicy.MUST_CPU_OFFLOAD
    if _is_random(op):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _sac_contexts(sac):
    """A ``context_fn`` for ``sac``, made outside any trace (dynamo takes
    a function made before tracing, not one made inside it)."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    def context_fn():
        return create_selective_checkpoint_contexts(sac)
    return context_fn


class _Policy:
    """A resolved policy: its name and the ``context_fn`` of the eager and
    the compiled checkpoint (None = recompute everything)."""

    def __init__(self, name, sac=None, offload=False):
        self.name = name
        if offload:
            self.eager = _offload_contexts
            self.compiled = _sac_contexts(_offload_tags)
        elif sac is None:
            self.eager = self.compiled = None
        else:
            self.eager = self.compiled = _sac_contexts(sac)

    def __repr__(self):
        return "remat policy %r" % (self.name,)


_TABLE = None


def _policies():
    global _TABLE
    if _TABLE is None:
        _TABLE = {
            "full": _Policy("full"),
            "nothing_saveable": _Policy("nothing_saveable"),
            "dots_saveable": _Policy("dots_saveable", _saving(_DOTS)),
            "dots_with_no_batch_dims_saveable": _Policy(
                "dots_with_no_batch_dims_saveable",
                _saving(_NO_BATCH_DOTS)),
            "everything_saveable": _Policy("everything_saveable",
                                           _everything),
            "offload_dots": _Policy("offload_dots", offload=True),
        }
    return _TABLE


def list_policies():
    """Recognized ``remat_policy`` names (plus 'none')."""
    return ["none"] + sorted(_policies())


def resolve_policy(policy):
    """Normalize a remat policy selector.

    Returns ``(active, resolved)``: ``active`` False means "do not
    checkpoint at all"; ``resolved`` is what :func:`checkpoint_region`
    and :func:`segment_scope` take.

    Accepts ``None`` (the ``MXNET_REMAT_POLICY`` default), ''/'none'
    (off), a registered name (see :func:`list_policies`), or a callable
    selective-checkpoint policy ``(ctx, op, *args, **kwargs) ->
    torch.utils.checkpoint.CheckpointPolicy``.
    """
    if policy is None:
        from . import config

        policy = config.get("MXNET_REMAT_POLICY")
    if policy in ("", "none", None, False):
        return False, None
    if isinstance(policy, _Policy):
        return True, policy
    if callable(policy):
        return True, _Policy(getattr(policy, "__name__", "custom"), policy)
    table = _policies()
    if policy not in table:
        raise ValueError(
            "unknown remat_policy %r (recognized: %s; or pass a "
            "torch.utils.checkpoint selective policy callable)"
            % (policy, list_policies()))
    return True, table[policy]


# ---------------------------------------------------------------------------
# the state a region carries
# ---------------------------------------------------------------------------

def _devices(args, out=None):
    """The devices of the tensors in ``args`` (nested tuples and lists)."""
    out = set() if out is None else out
    for a in args:
        if isinstance(a, torch.Tensor):
            out.add(a.device)
        elif isinstance(a, (list, tuple)):
            _devices(a, out)
    return sorted(out, key=str)


def _flags():
    """The thread-local flags a region's forward reads: autograd's
    recording and training, the dtype-policy and fusion scopes, and the
    block's trace, swap and probe states."""
    from . import autograd as _ag
    from . import dtype_policy as _dtp
    from . import fusion_cost as _fc
    from .gluon import block as _blk

    ag = _ag._st()
    return (ag.recording, ag.training, _dtp._scope_state.policy,
            _fc._plan_state.plan, _blk._trace_state.active,
            _blk._swap_state.map, _blk._probe_state.active)


def _set_flags(flags):
    from . import autograd as _ag
    from . import dtype_policy as _dtp
    from . import fusion_cost as _fc
    from .gluon import block as _blk

    ag = _ag._st()
    (ag.recording, ag.training, _dtp._scope_state.policy,
     _fc._plan_state.plan, _blk._trace_state.active,
     _blk._swap_state.map, _blk._probe_state.active) = flags


class _Snapshot:
    """The framework's thread-local state at a region's forward, and the
    tensors ``arrays`` (NDArrays) held then."""

    def __init__(self, arrays, devices):
        from . import random as _random

        self.arrays = [(a, a._data) for a in arrays]
        self.flags = _flags()
        rs = _random._st()
        for d in devices:
            _random.generator(d)   # made now, so its start state is seen
        self.seed = rs.seed
        self.gens = rs.gens
        self.gen_states = {k: g.get_state() for k, g in rs.gens.items()}

    @contextlib.contextmanager
    def installed(self):
        """Run a recompute inside the captured state; everything is set
        back after, the generators included."""
        from . import random as _random
        from .gluon import block as _blk

        rs = _random._st()
        prev_arrays = [(a, a._data) for a, _ in self.arrays]
        prev_flags = _flags()
        prev_sink = _blk._aux_sink.sink
        prev_rs = (rs.seed, rs.gens)
        prev_gen_states = {k: g.get_state() for k, g in self.gens.items()}
        for a, t in self.arrays:
            a._data = t
        _set_flags(self.flags)
        _blk._aux_sink.sink = []       # a recompute's moving stats: dropped
        rs.seed, rs.gens = self.seed, self.gens
        for k, s in self.gen_states.items():
            self.gens[k].set_state(s)
        try:
            yield
        finally:
            for k, s in prev_gen_states.items():
                self.gens[k].set_state(s)
            rs.seed, rs.gens = prev_rs
            _blk._aux_sink.sink = prev_sink
            _set_flags(prev_flags)
            for a, t in prev_arrays:
                a._data = t


# ---------------------------------------------------------------------------
# offload_dots, eagerly: a pair of dispatch modes
# ---------------------------------------------------------------------------

def _offload_contexts():
    from torch.utils._python_dispatch import TorchDispatchMode

    parked = []

    class Park(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket in _NO_BATCH_DOTS:
                if out.is_cuda:
                    host = torch.empty(out.shape, dtype=out.dtype,
                                       device="cpu", pin_memory=True)
                    host.copy_(out.detach(), non_blocking=True)
                    parked.append((host, out.device))
                else:
                    parked.append((out.detach(), out.device))
            elif _is_random(func):
                parked.append((out.detach(), out.device))
            return out

    class Fetch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.i = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket in _NO_BATCH_DOTS or _is_random(func):
                t, device = parked[self.i]
                self.i += 1
                return t.to(device, non_blocking=True)
            return func(*args, **(kwargs or {}))

    return Park(), Fetch()


def checkpoint_region(fn, args, policy, arrays=()):
    """``fn(*args)`` as one checkpoint region under ``policy`` (resolved
    by :func:`resolve_policy`); ``arrays`` are NDArrays whose tensors are
    installed again around an eager recompute."""
    from torch.utils.checkpoint import checkpoint

    if torch.compiler.is_compiling():
        kw = {} if policy.compiled is None \
            else {"context_fn": policy.compiled}
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    kw = {} if policy.eager is None else {"context_fn": policy.eager}
    snap = _Snapshot(arrays, _devices(args))
    runs = [0]

    def region(*a):
        runs[0] += 1
        if runs[0] == 1:
            return fn(*a)
        with snap.installed():
            return fn(*a)
    # early_stop=False: a recompute runs its region to the end, so no
    # stop signal crosses the framework's op-error wrapping
    return checkpoint(region, *args, use_reentrant=False, early_stop=False,
                      **kw)


def compile_scope():
    """The dynamo setting a compiled region needs (held around each call
    of a compiled function that holds one): the region's side effects on
    the framework's thread-locals and the aux sink run once, in the
    forward.  The compiled backward recomputes the region's graph, never
    its Python, so there is nothing to replay."""
    import torch._dynamo

    return torch._dynamo.config.patch(
        skip_fwd_side_effects_in_bwd_under_checkpoint=True)


def apply_remat(fn, policy):
    """Wrap ``fn`` in one checkpoint region per ``policy`` (see
    :func:`resolve_policy`); returns ``fn`` unchanged when the policy is
    off.  ``fn`` takes and returns tensors (nested in tuples, lists or
    dicts); the framework state it reads is carried into its recompute
    (module doc)."""
    active, resolved = resolve_policy(policy)
    if not active:
        return fn

    def remat_fn(*args):
        return checkpoint_region(fn, args, resolved)
    return remat_fn


# ---------------------------------------------------------------------------
# eager segments (ShardedTrainer)
# ---------------------------------------------------------------------------

def segments(block):
    """The children of ``block``'s outermost sequential container (depth
    first), or None when it has none: the eager regions of a net (module
    doc)."""
    from .gluon import nn

    seq = (nn.HybridSequential, nn.Sequential)
    stack = [block]
    while stack:
        b = stack.pop(0)
        if isinstance(b, seq) and len(b._children):
            return list(b._children.values())
        stack = list(b._children.values()) + stack
    return None


class _SegState(threading.local):
    def __init__(self):
        self.blocks = None     # ids of the region blocks while a forward
        self.policy = None     # runs under segment_scope, and their policy
        self.open = False      # inside a region's forward


_seg = _SegState()


@contextlib.contextmanager
def segment_scope(blocks, policy):
    """Inside, each call of a block of ``blocks`` runs as its own
    checkpoint region under ``policy`` (resolved) (``Block.__call__`` asks
    :func:`is_segment`)."""
    prev = (_seg.blocks, _seg.policy, _seg.open)
    _seg.blocks = {id(b) for b in blocks}
    _seg.policy = policy
    _seg.open = False
    try:
        yield
    finally:
        _seg.blocks, _seg.policy, _seg.open = prev


def is_segment(block):
    """Whether this call of ``block`` is to be a region (one attribute
    read outside :func:`segment_scope`)."""
    blocks = _seg.blocks
    return blocks is not None and not _seg.open and id(block) in blocks


def run_segment(block, args):
    """``block(*args)`` (NDArrays) as one checkpoint region under the
    scope's policy; the tensors its parameters hold now are installed
    again around the recompute."""
    from .gluon.block import _flatten_nested, _regroup_nested
    from .ndarray.ndarray import NDArray

    arrays = [p.data() for p in block.collect_params().values()]
    meta = {}

    def fn(*xs):
        prev = _seg.open
        _seg.open = True
        try:
            out = block(*[NDArray(x) for x in xs])
        finally:
            _seg.open = prev
        flat, meta["tmpl"] = _flatten_nested(out)
        return tuple(o._data for o in flat)

    outs = checkpoint_region(fn, tuple(a._data for a in args), _seg.policy,
                             arrays)
    return _regroup_nested(meta["tmpl"], [NDArray(o) for o in outs])
