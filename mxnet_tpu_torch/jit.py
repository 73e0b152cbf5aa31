"""The compiled path shared by ``CachedOp`` (``hybridize()``) and the
symbolic ``Executor``: the port's counterpart of ``jax.jit``.

``Compiled(fn, name)`` holds one ``torch.compile`` object for each key
the caller gives (train or eval, recording, the input shapes and
dtypes), as ``jax.jit`` retraces for a new signature.  Each key's object
compiles its own copy of ``fn``'s code, so dynamo's per-code cache (and
its recompile limit) sees one signature per copy.  Compilation is
``fullgraph=True``: a construct dynamo cannot trace is an error, as an
untraceable construct is for ``jax.jit``, and never a silent fall back
to eager Python.  ``dynamic=False``: a new shape is a new key.

The backend is inductor unless ``_BACKEND`` names another (the CPU tests
set ``"aot_eager"``, which skips inductor's code generation).  It is a
test hook, not a setting: a process that a test starts (a C ABI worker)
inherits it through ``MXTPU_TEST_JIT_BACKEND``.

The first call of each key is the compile feed of the observability
layer (the JAX package's jax.monitoring bridge): its wall time goes to
``telemetry.note_compile`` (``COMPILES``, ``COMPILE_SECONDS`` and the
goodput ledger's compile bucket), and the change it made in dynamo's
persistent-cache counters (inductor's FX-graph cache and AOTAutograd's
cache, ``config.enable_compile_cache``) to ``telemetry.note_compile_cache``
(``COMPILE_CACHE_HITS`` / ``_MISSES``; a bypass counts as a miss).
``cache_hits`` / ``cache_misses`` sum them over the keys, and
``cache_counts`` keeps each counter's own sum.
"""
from __future__ import annotations

import os
import time
import types

import torch

from . import telemetry as _telemetry

__all__ = ["Compiled", "signature"]

# (dynamo counter group, name) of the persistent caches; a key's first
# call reads the change in each
_CACHE_COUNTERS = (("inductor", "fxgraph_cache_hit"),
                   ("inductor", "fxgraph_cache_miss"),
                   ("inductor", "fxgraph_cache_bypass"),
                   ("aot_autograd", "autograd_cache_hit"),
                   ("aot_autograd", "autograd_cache_miss"),
                   ("aot_autograd", "autograd_cache_bypass"))

# the torch.compile backend; None is torch's default (inductor)
_BACKEND = os.environ.get("MXTPU_TEST_JIT_BACKEND") or None


def signature(tensors):
    """The shapes and dtypes of ``tensors``: part of a compile key."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _cache_counts():
    from torch._dynamo.utils import counters

    return [counters[group][name] for group, name in _CACHE_COUNTERS]


def _fresh_copy(fn, tag):
    """``fn`` (a function or bound method) with a code object of its own
    (dynamo caches per code object)."""
    if isinstance(fn, types.MethodType):
        return types.MethodType(_fresh_copy(fn.__func__, tag), fn.__self__)
    code = fn.__code__.replace(co_name="%s_%s" % (fn.__code__.co_name, tag))
    return types.FunctionType(code, fn.__globals__, code.co_name,
                              fn.__defaults__, fn.__closure__)


class Compiled:
    """``fn`` compiled once for each key.  ``compile_seconds`` sums the
    wall time of each key's first call (trace, compile and one run)."""

    def __init__(self, fn, name):
        self._fn = fn
        self._name = name
        self._compiled = {}
        self.compile_seconds = 0.0
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_counts = {name: 0 for _, name in _CACHE_COUNTERS}

    def __len__(self):
        return len(self._compiled)

    def __call__(self, key, *args):
        c = self._compiled.get(key)
        if c is not None:
            return c(*args)
        tag = "%s_%d" % (self._name, len(self._compiled))
        c = torch.compile(_fresh_copy(self._fn, tag), backend=_BACKEND
                          or "inductor", fullgraph=True, dynamic=False)
        before = _cache_counts()
        t0 = time.perf_counter()
        out = c(*args)
        dt = time.perf_counter() - t0
        delta = [b - a for a, b in zip(before, _cache_counts())]
        for (_, name), d in zip(_CACHE_COUNTERS, delta):
            self.cache_counts[name] += d
        hits = delta[0] + delta[3]
        misses = delta[1] + delta[2] + delta[4] + delta[5]
        self.cache_hits += hits
        self.cache_misses += misses
        self.compile_seconds += dt
        self._compiled[key] = c
        _telemetry.note_compile(dt)
        _telemetry.note_compile_cache(hits, misses)
        return out
