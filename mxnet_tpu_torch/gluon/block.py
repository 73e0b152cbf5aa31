"""Gluon Block / HybridBlock (parity: mxnet_tpu/gluon/block.py,
python/mxnet/gluon/block.py Block :127, HybridBlock :671).

Names follow the reference exactly: a top-level block takes
``<alias><n>_`` from the NameManager and each child ``<alias><k>_`` from
its parent's scope counter, so parameter names (e.g.
``resnetv10_conv2d0_weight``) match the JAX package's and weights carry
across by name.

``hybridize()`` compiles (parity: mxnet_tpu/gluon/block.py:402-640, where
``CachedOp`` is ``jax.jit``): ``CachedOp`` builds one pure function
``(inputs, params) -> (outputs, moving-stat values)`` from the block's
forward, with the parameters swapped for the function's tensors
(``swapped_params``) and BatchNorm's updates collected by the aux sink,
and runs it through ``jit.Compiled``, the ``torch.compile`` wrapper the
symbolic ``Executor`` uses too: one compiled object for each (train or
eval, recording, input and parameter shapes and dtypes).  The moving
stats are rebound after each call; gradients flow through torch autograd
into each parameter's grad buffer.  Given a ``Symbol``, a HybridBlock
calls ``hybrid_forward(mx.sym, ...)`` with each parameter's ``var()``:
``export`` writes that graph and the parameters, and ``SymbolBlock`` runs
such a graph through the same compiled path.

``save_parameters`` writes the block's parameters under their structural
names (``features.0.weight``, the attribute path), as the JAX package's
does, as npz; ``load_parameters`` reads npz or the reference binary
format from either package, and also a file of full names
(``ParameterDict.save``).

``parallel.ShardedTrainer`` runs a block's forward with its parameters
swapped for the step's tensors.  It installs an aux sink, a list into
which BatchNorm hands ``(parameter, new_value)`` for its moving stats
instead of rebinding them, so that the step applies them after the
update and its non-finite guard can discard them, and it sets the trace
flag, under which blocks skip their deferred-initialization check (every
parameter has been swapped in).  ``swapped_params`` is the same recipe
for inference (``generate.GenerationEngine``): inside it the given
parameters read as the given tensors, in the calling thread only.
"""
from __future__ import annotations

import contextlib
from contextlib import nullcontext
import re
import threading
from collections import OrderedDict

import numpy as np

import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray
from .. import autograd
from .. import dtype_policy as _dtp
from .. import fusion_cost as _fc
from .. import jit as _jit
from .. import remat as _remat
from ..name import NameManager, Prefix
from ..symbol import symbol as _symbol
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock", "CachedOp",
           "swapped_params"]


class _Local(threading.local):
    """A thread-local whose attributes hold ``defaults`` from each
    thread's first use: a compiled graph guards on what it reads there,
    and an attribute that appeared after the first trace would recompile
    it."""

    def __init__(self, **defaults):
        self.__dict__.update(defaults)


_aux_sink = _Local(sink=None)


def _current_aux_sink():
    return getattr(_aux_sink, "sink", None)


_trace_state = _Local(active=False)


def _is_tracing():
    return getattr(_trace_state, "active", False)


# set while a hybridized block probes its forward eagerly (CachedOp):
# blocks inside then run eagerly instead of compiling
_probe_state = _Local(active=False)


def _is_probing():
    return getattr(_probe_state, "active", False)


_swap_state = _Local(map=None)


def _param_data(param, read=None):
    """``param``'s value as a block's forward should read it: the
    swapped-in tensor inside ``swapped_params`` (a compiled forward,
    ShardedTrainer), else ``read(param)`` (default ``param.data()``); for
    blocks that read their parameters in ``forward`` instead of taking
    them in ``hybrid_forward``."""
    swap = getattr(_swap_state, "map", None)
    if swap is not None and param in swap:
        return swap[param]
    return param.data() if read is None else read(param)


@contextlib.contextmanager
def swapped_params(params, arrays, training=False):
    """Run a block's forward against supplied parameter tensors (parity:
    mxnet_tpu/gluon/block.py:54): inside, each gluon ``Parameter`` of
    ``params`` reads as the matching tensor of ``arrays``, blocks skip
    their deferred-initialization check, and autograd's training flag is
    ``training``; all is restored on exit.  The swap is local to the
    calling thread, so a server's worker can decode with the committed
    tensors while another thread runs the same block on its own
    parameters."""
    prev_map = getattr(_swap_state, "map", None)
    swap = dict(prev_map or {})
    swap.update((p, NDArray(a)) for p, a in zip(params, arrays))
    prev_train = autograd.set_training(training)
    prev_trace = _is_tracing()
    _swap_state.map = swap
    _trace_state.active = True
    try:
        yield
    finally:
        _swap_state.map = prev_map
        _trace_state.active = prev_trace
        autograd.set_training(prev_train)


def _abstract_eval_forward(block, args):
    """Finish deferred parameter inits (parity: block.py:82).  torch has
    no ``eval_shape``, so this runs ``block`` once on ``args`` for real,
    under ``autograd.pause()`` and with moving-stat updates discarded.
    Returns the forward's output."""
    prev_sink = getattr(_aux_sink, "sink", None)
    _aux_sink.sink = []
    try:
        with autograd.pause():
            return block(*args)
    finally:
        _aux_sink.sink = prev_sink


class _BlockScope:
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        self._name_scope = Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, *a):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(*a)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


class Block:
    """Base class for all layers and models (parity: block.py:127)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(prefix, params,
                                                        self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}
        self._forward_pre_hooks = OrderedDict()
        self._forward_hooks = OrderedDict()

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join("  (%s): %s" % (k, v)
                           for k, v in self._children.items())
        return "%s(\n%s\n)" % (self.__class__.__name__, modstr)

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if name in self._reg_params and self._reg_params[name] is not value:
                raise MXNetError("Overriding Parameter attribute %s is not "
                                 "allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children.values():
            ret.update(cld.collect_params(select=select))
        return ret

    def _collect_params_with_prefix(self, prefix=""):
        """{structural name: Parameter}: attribute names joined by dots
        (``features.0.weight``), the names ``save_parameters`` writes."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._children.items():
            ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward."""
        self._forward_pre_hooks[len(self._forward_pre_hooks)] = hook
        return _HookHandle(self._forward_pre_hooks,
                           len(self._forward_pre_hooks) - 1)

    def register_forward_hook(self, hook):
        """``hook(block, args, output)`` after each forward."""
        self._forward_hooks[len(self._forward_hooks)] = hook
        return _HookHandle(self._forward_hooks, len(self._forward_hooks) - 1)

    def apply(self, fn):
        """``fn(block)`` on every child, depth first, then on this block."""
        for cld in self._children.values():
            cld.apply(fn)
        fn(self)
        return self

    def cast(self, dtype):
        """Cast every parameter to ``dtype`` (BatchNorm keeps float16's
        parameters at float32)."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def summary(self, *inputs):
        """Print each block's name, type and parameter count."""
        rows = []

        def walk(block, indent=""):
            n = sum(int(np.prod(p.shape or ()))
                    for p in block._reg_params.values())
            rows.append((indent + block.name, block.__class__.__name__, n))
            for c in block._children.values():
                walk(c, indent + "  ")

        walk(self)
        print("%-50s %-20s %s" % ("Layer", "Type", "Params"))
        for name, typ, n in rows:
            print("%-50s %-20s %d" % (name, typ, n))

    # -- (de)serialization ------------------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Save the parameters under their structural names, as npz
        (parity: block.py:334)."""
        from ..ndarray import ndarray as _nd

        params = self._collect_params_with_prefix()
        _nd.save(filename, {k: p._reduce() for k, p in params.items()})

    save_params = save_parameters

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a file of ``save_parameters`` (or of full parameter
        names), in either format, from either package.  An uninitialized
        parameter is initialized on ``ctx`` (default: the current
        context) from the file's value."""
        from ..ndarray import ndarray as _nd

        loaded = _nd.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not isinstance(loaded, dict):
            raise MXNetError("load_parameters expects a dict file")
        if loaded and params and not any("." in k for k in loaded) \
                and not set(loaded) & set(params):
            # saved with full names (ParameterDict.save)
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra)
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError("Parameter '%s' is missing in file %s"
                                     % (name, filename))
        for name, value in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise MXNetError("Parameter '%s' in file is not present "
                                     "in this Block" % name)
                continue
            params[name]._load_value(value, ctx)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def __call__(self, *args):
        if _remat.is_segment(self) and \
                all(isinstance(a, NDArray) for a in args):
            # one eager remat region of a ShardedTrainer step (remat.py)
            return _remat.run_segment(self, args)
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        with autograd.grad_mode():
            out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError


def _flatten_nested(out):
    """Flatten nested list/tuple output into (flat list, template); the
    template mirrors the nesting with flat-list indices at the leaves
    (parity: mxnet_tpu/gluon/block.py:120)."""
    flat = []
    return flat, _flatten_into(out, flat)


def _flatten_into(o, flat):
    # a module-level function: a nested recursive closure would hold
    # ``flat`` (the outputs, and through their grad_fn the whole step's
    # graph) in a reference cycle until the garbage collector ran
    if isinstance(o, (list, tuple)):
        t = [_flatten_into(x, flat) for x in o]
        return t if isinstance(o, list) else tuple(t)
    flat.append(o)
    return len(flat) - 1


def _regroup_nested(tmpl, flat):
    if isinstance(tmpl, (list, tuple)):
        vals = [_regroup_nested(t, flat) for t in tmpl]
        return vals if isinstance(tmpl, list) else tuple(vals)
    return flat[tmpl]


_NOT_PORTED_FLAGS = ("aot",)


class CachedOp:
    """A hybridized block's compiled forward (parity:
    mxnet_tpu/gluon/block.py:402; src/imperative/cached_op.cc).

    For each new key (train or eval, recording, input and parameter
    shapes and dtypes) the block first runs once eagerly without grad
    (a probe, which also finishes deferred initialization), to learn the
    nesting of its outputs and which parameters take moving-stat
    updates; then the pure function is compiled for that key.
    ``static_alloc`` and ``static_shape`` change nothing, as in the JAX
    package; ``dtype_policy`` casts each parameter to its compute dtype
    by name, installs the policy's scope, and casts outputs to the
    policy's output dtype and moving stats back to their storage dtype.
    ``remat_policy`` (else ``MXNET_REMAT_POLICY``) makes a training key's
    pure function one checkpoint region (``remat.py``), which the compiled
    graph recomputes in its backward per the policy.
    ``fusion`` (else ``MXNET_FUSION``) is resolved into a fusion plan
    when a key first runs and installed (``fusion_cost.scope``) around
    that key's probe and compiled calls, where an op's shape-specialized
    fast path (LayerNorm's) consults it; a block has no graph to
    rewrite.
    """

    def __init__(self, block, static_alloc=False, static_shape=False,
                 remat_policy=None, fusion=None, aot=None,
                 dtype_policy=None):
        self._block = block
        self._policy = _dtp.resolve_policy(dtype_policy)
        self._remat, self._remat_policy = _remat.resolve_policy(remat_policy)
        _fc.resolve_fusion(fusion)   # a bad spec fails at hybridize()
        self._fusion = fusion
        self._params = list(block.collect_params().values())
        # key -> (output template, aux parameters, fusion plan)
        self._meta = {}
        self._compiled = _jit.Compiled(self._pure, "cachedop")

    @property
    def compile_seconds(self):
        return self._compiled.compile_seconds

    def _pure(self, inputs, params):
        """(input tensors, parameter tensors) -> (output tensors, new
        moving-stat tensors); compiled per key.  A training key under a
        remat policy runs it as one checkpoint region."""
        if self._remat and autograd.is_training() and \
                torch.is_grad_enabled():
            return _remat.checkpoint_region(self._region, (inputs, params),
                                            self._remat_policy)
        return self._region(inputs, params)

    def _region(self, inputs, params):
        policy = self._policy
        if policy is not None:
            params = [policy.cast_compute(p.name, a)
                      for p, a in zip(self._params, params)]
        prev_sink = getattr(_aux_sink, "sink", None)
        sink = []
        _aux_sink.sink = sink
        try:
            with swapped_params(self._params, params,
                                training=autograd.is_training()):
                out = self._block.forward(*[NDArray(x) for x in inputs])
        finally:
            _aux_sink.sink = prev_sink
        flat, _ = _flatten_nested(out)
        outs = [o._data for o in flat]
        aux = [v._data if isinstance(v, NDArray) else v for _, v in sink]
        if policy is not None:
            outs = [policy.cast_output(o) for o in outs]
            aux = [v.to(p.data()._data.dtype)
                   for (p, _), v in zip(sink, aux)]
        return tuple(outs), tuple(aux)

    def _probe(self, inputs):
        """Run the block eagerly once, without grad, with its moving-stat
        updates discarded: (output template, aux parameters)."""
        prev_sink = getattr(_aux_sink, "sink", None)
        sink = []
        _aux_sink.sink = sink
        _probe_state.active = True
        try:
            with torch.no_grad():
                out = self._block.forward(*inputs)
        finally:
            _probe_state.active = False
            _aux_sink.sink = prev_sink
        _, tmpl = _flatten_nested(out)
        return tmpl, [p for p, _ in sink]

    def __call__(self, *inputs):
        try:
            par_t = [p.data()._data for p in self._params]
        except DeferredInitializationError:
            self._probe(inputs)     # finishes the deferred inits
            par_t = [p.data()._data for p in self._params]
        in_t = [x._data for x in inputs]
        recording = autograd.is_recording()
        key = (autograd.is_training(), recording, _jit.signature(in_t),
               _jit.signature(par_t))
        if key not in self._meta:
            # resolved once a key, so the compiled graph sees one plan
            plan = _fc.resolve_fusion(self._fusion)
            with _fc.scope(plan):
                self._meta[key] = self._probe(inputs) + (plan,)
        tmpl, aux_params, plan = self._meta[key]
        with torch.set_grad_enabled(recording), _dtp.scope(self._policy), \
                _fc.scope(plan), \
                _remat.compile_scope() if self._remat else nullcontext():
            outs, aux = self._compiled(key, in_t, par_t)
        for p, v in zip(aux_params, aux):
            p.data()._rebind(v)
        return _regroup_nested(tmpl, [NDArray(o) for o in outs])


class HybridBlock(Block):
    """Block written against ``F``, eager until ``hybridize()`` (parity:
    mxnet_tpu/gluon/block.py:643)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_op = None
        self._flags = {}

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  remat_policy=None, fusion=None, aot=None,
                  dtype_policy=None):
        """Compile this block's forward with ``torch.compile`` (``active``)
        or go back to eager.  ``fusion`` installs a fusion plan around the
        compiled forward (``CachedOp``).  ``remat_policy`` and ``aot`` are
        not ported yet and raise unless None."""
        flags = {"static_alloc": static_alloc, "static_shape": static_shape,
                 "remat_policy": remat_policy, "fusion": fusion, "aot": aot,
                 "dtype_policy": dtype_policy}
        for name in _NOT_PORTED_FLAGS:
            if flags[name] is not None:
                raise MXNetError("hybridize(%s=%r): not ported yet"
                                 % (name, flags[name]))
        _remat.resolve_policy(remat_policy)
        _dtp.resolve_policy(dtype_policy)
        _fc.resolve_fusion(fusion)
        self._active = active
        self._flags = flags
        self._cached_op = None
        for cld in self._children.values():
            cld.hybridize(active, **flags)

    def cast(self, dtype):
        self._cached_op = None
        super().cast(dtype)

    def infer_shape(self, *args):
        """Complete deferred parameter shapes from inputs (parity:
        block.py:662)."""
        self._infer_param_shapes(*args)

    def _infer_param_shapes(self, *args):
        pass

    def _ensure_initialized(self, *args):
        try:
            for p in self._reg_params.values():
                p.data()
        except DeferredInitializationError:
            self._infer_param_shapes(*args)
            for p in self._reg_params.values():
                p._finish_deferred_init()

    def forward(self, x, *args):
        if isinstance(x, _symbol.Symbol):
            from .. import symbol as F

            params = {k: p.var() for k, p in self._reg_params.items()}
            with self.name_scope():
                return self.hybrid_forward(F, x, *args, **params)
        if not isinstance(x, NDArray):
            raise MXNetError("forward expects NDArray or Symbol, got %r"
                             % type(x))
        if self._active and not _is_tracing() and not _is_probing():
            if self._cached_op is None:
                self._cached_op = CachedOp(self, **self._flags)
            return self._cached_op(x, *args)
        from .. import ndarray as F

        if not _is_tracing():
            self._ensure_initialized(x, *args)
        swap = getattr(_swap_state, "map", None)
        params = {k: swap[p] if swap is not None and p in swap
                  else p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # -- export ----------------------------------------------------------
    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write ``path-symbol.json`` (this block's graph on a ``data``
        variable) and ``path-%04d.params`` (its arguments and aux states
        as ``arg:``/``aux:`` keys); returns the params file's name
        (parity: mxnet_tpu/gluon/block.py:730)."""
        from ..ndarray import ndarray as _nd

        sym = self._to_symbol()
        sym.save("%s-symbol.json" % path)
        aux_names = set(sym.list_auxiliary_states())
        existing = set(sym.list_arguments()) | aux_names
        arg_dict = {}
        for name, param in self.collect_params().items():
            if name in existing:
                kind = "aux:" if name in aux_names else "arg:"
                arg_dict[kind + name] = param._reduce()
        fname = "%s-%04d.params" % (path, epoch)
        _nd.save(fname, arg_dict)
        return fname

    def _to_symbol(self):
        out = self(_symbol.var("data"))
        if isinstance(out, (list, tuple)):
            out = _symbol.Group(out)
        return out


class SymbolBlock(HybridBlock):
    """A Symbol with its parameters as a Block (parity:
    mxnet_tpu/gluon/block.py:755).  Its forward runs the symbol's graph
    function through the compiled path (``jit.Compiled``), one compiled
    object for each (train or eval, recording, input shapes and dtypes);
    in training BatchNorm's moving stats are rebound after each call."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        sym = _symbol.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [_symbol.var(n) for n in input_names])
        if param_file is not None:
            from ..ndarray import ndarray as _nd

            loaded = _nd.load(param_file, ctx=cpu())
            loaded = {k.split(":", 1)[-1]: v for k, v in loaded.items()}
            for name, param in ret.collect_params().items():
                if name in loaded:
                    param._load_value(loaded[name], ctx)
        return ret

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=None)
        if isinstance(outputs, (list, tuple)):
            outputs = _symbol.Group(outputs)
        if isinstance(inputs, _symbol.Symbol):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        aux_names = outputs.list_auxiliary_states()
        for name in outputs.list_arguments() + aux_names:
            if name not in self._input_names:
                self.params.get(name, allow_deferred_init=True,
                                grad_req="null" if name in aux_names
                                else "write")
        self._aux_names = aux_names
        graph_fn, _, _ = outputs._build_fn()

        def run(values, is_train, device):
            return graph_fn(values, is_train=is_train, device=device)

        self._compiled = _jit.Compiled(run, "symbolblock")

    def _finish_init(self, args):
        """Initialize the parameters no file gave, their shapes inferred
        from the inputs'."""
        missing = [p for p in self.params.values() if p._data is None]
        if not missing:
            return
        shapes = {n: x.shape for n, x in zip(self._input_names, args)}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**shapes)
        names = self._symbol.list_arguments() + self._aux_names
        known = dict(zip(names, arg_shapes + aux_shapes))
        ctx = args[0].context
        for p in missing:
            p.shape = known[p.name]
            if p._deferred_init:
                p._finish_deferred_init()
            else:
                p.initialize(ctx=ctx)

    def forward(self, *args):
        if isinstance(args[0], _symbol.Symbol):
            raise MXNetError("SymbolBlock takes NDArrays")
        self._finish_init(args)
        values = {n: x._data for n, x in zip(self._input_names, args)}
        values.update((name, p.data()._data)
                      for name, p in self.params.items())
        is_train = autograd.is_training()
        recording = autograd.is_recording()
        key = (is_train, recording, _jit.signature(values.values()))
        device = args[0]._data.device
        with torch.set_grad_enabled(recording):
            outs, aux = self._compiled(key, values, is_train, device)
        for name, v in aux.items():
            self.params[name].data()._rebind(v)
        nds = [NDArray(o) for o in outs]
        return nds[0] if len(nds) == 1 else nds


class _HookHandle:
    def __init__(self, hooks, idx):
        self._hooks = hooks
        self._idx = idx

    def detach(self):
        self._hooks.pop(self._idx, None)
