"""Gluon Block / HybridBlock (parity: mxnet_tpu/gluon/block.py,
python/mxnet/gluon/block.py Block :127, HybridBlock :671).

Names follow the reference exactly: a top-level block takes
``<alias><n>_`` from the NameManager and each child ``<alias><k>_`` from
its parent's scope counter, so parameter names (e.g.
``resnetv10_conv2d0_weight``) match the JAX package's and weights carry
across by name.  ``hybridize()`` is accepted and the block still runs
eagerly: there is no compiled path in this port yet.

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
import re
import threading
from collections import OrderedDict

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .. import autograd
from ..name import NameManager
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "swapped_params"]

_aux_sink = threading.local()


def _current_aux_sink():
    return getattr(_aux_sink, "sink", None)


_trace_state = threading.local()


def _is_tracing():
    return getattr(_trace_state, "active", False)


_swap_state = threading.local()


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
        return self

    def __exit__(self, *a):
        if self._block._empty_prefix:
            return
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

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        """``hook(block, args, output)`` after each forward."""
        self._forward_hooks[len(self._forward_hooks)] = hook
        return _HookHandle(self._forward_hooks, len(self._forward_hooks) - 1)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children.values():
            cld.hybridize(active, **kwargs)

    def __call__(self, *args):
        with autograd.grad_mode():
            out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """Block written against ``F`` (parity: block.py:671).  Runs eagerly;
    ``hybridize()`` only records the request."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False

    def hybridize(self, active=True, **kwargs):
        self._active = active
        super().hybridize(active, **kwargs)

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
        if not isinstance(x, NDArray):
            raise MXNetError("forward expects NDArray, got %r" % type(x))
        from .. import ndarray as F

        if not _is_tracing():
            self._ensure_initialized(x, *args)
        swap = getattr(_swap_state, "map", None)
        params = {k: swap[p] if swap is not None and p in swap
                  else p.data() for k, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class _HookHandle:
    def __init__(self, hooks, idx):
        self._hooks = hooks
        self._idx = idx

    def detach(self):
        self._hooks.pop(self._idx, None)
