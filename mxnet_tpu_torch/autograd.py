"""Autograd over ``torch.autograd`` (parity: mxnet_tpu/autograd.py,
python/mxnet/autograd.py record/pause :122,146, mark_variables :197,
backward :243, grad :270, Function :385).

Recording is MXNet's explicit scope: ops run with torch's grad mode on
only inside ``record()`` (the NDArray ops and blocks ask ``grad_mode()``).
A marked variable is a leaf tensor with ``requires_grad``; ``backward``
runs ``torch.autograd.backward`` and then moves each leaf's ``.grad`` into
the variable's MXNet gradient buffer, honouring ``grad_req`` ('write'
replaces, 'add' accumulates), so torch's own accumulation never leaks
from one backward to the next.

``grad`` returns the gradients instead (``torch.autograd.grad``); with
``create_graph=True`` they are themselves recorded, so a ``backward``
through them gives second derivatives.  ``Function`` runs a user's
forward and backward on NDArrays as a ``torch.autograd.Function``.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function", "grad_mode", "get_symbol"]


class _State(threading.local):
    # set in each thread's first use: a compiled graph's guards on these
    # attributes never see one appear
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()
# every NDArray with an attached gradient, by id; weak, so dropped arrays
# leave.  Not a WeakSet: a set compares members with ``==``, which an
# NDArray answers elementwise.
_marked = {}
# the leaves a marked variable held before an in-place operator rebound
# it inside record(), by the variable's id: the graph recorded before the
# rebind ends there, and their gradients count for the variable as the
# JAX package's tape counts both values for one variable
_retired = {}


def _mark(var):
    key = id(var)

    def _drop(ref, key=key):
        if _marked.get(key) is ref:
            del _marked[key]

    _marked[key] = weakref.ref(var, _drop)


def retire(var):
    """Keep ``var``'s current leaf as a gradient source of ``var`` (it is
    about to be rebound inside ``record()``)."""
    _retired.setdefault(id(var), []).append(var._data)


def _st():
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    st = _st()
    prev = st.recording
    st.recording = bool(is_record)
    return prev


def set_training(train_mode_):
    st = _st()
    prev = st.training
    st.training = bool(train_mode_)
    return prev


def grad_mode():
    """torch grad-mode context matching the MXNet recording state."""
    return torch.set_grad_enabled(is_recording())


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._enter_record = is_record
        self._enter_train = train_mode_
        self._prev = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._enter_record is not None:
            st.recording = self._enter_record
        if self._enter_train is not None:
            st.training = self._enter_train
        return self

    def __exit__(self, *a):
        st = _st()
        st.recording, st.training = self._prev


def record(train_mode=True):
    """``with autograd.record():`` (parity: autograd.py:122)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers (parity: autograd.mark_variables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        _retired.pop(id(var), None)
        var._grad = g
        var._grad_req = req
        var._data = var._data.detach().requires_grad_(
            req != "null" and var._data.is_floating_point())
        _mark(var)


def _heads(heads, head_grads):
    """The recorded head tensors and their gradients (ones by default)."""
    from .ndarray.ndarray import NDArray

    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    tensors, grads = [], []
    for h, hg in zip(heads, head_grads):
        if not h._data.requires_grad:
            continue
        tensors.append(h._data)
        grads.append(torch.ones_like(h._data) if hg is None else hg._data)
    return tensors, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the marked variables' buffers; the
    default head gradient is ones (parity: autograd.backward)."""
    tensors, grads = _heads(heads, head_grads)
    if not tensors:
        return
    variables = [v for v in (r() for r in list(_marked.values()))
                 if v is not None and v._grad is not None
                 and v._data.requires_grad]
    leaves = {id(v): [v._data] + _retired.get(id(v), []) for v in variables}
    for ts in leaves.values():
        for t in ts:
            t.grad = None
    prev = set_training(train_mode)
    try:
        torch.autograd.backward(tensors, grads, retain_graph=retain_graph)
    finally:
        set_training(prev)
    for v in variables:
        parts = [t.grad for t in leaves[id(v)] if t.grad is not None]
        for t in leaves[id(v)]:
            t.grad = None
        if not retain_graph:
            _retired.pop(id(v), None)
        if not parts:
            continue
        g = parts[0] if len(parts) == 1 else sum(parts)
        if v._grad_req == "add":
            v._grad._data.add_(g)
        elif v._grad_req != "null":
            v._grad._data = g.to(v._grad._data.dtype)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (each with an
    attached gradient), returned as NDArrays; the variables' gradient
    buffers stay as they are (parity: autograd.grad, autograd.py:329).
    With ``create_graph=True`` the gradients are recorded, so they can be
    differentiated again.  A variable the heads do not reach gets
    zeros."""
    from .base import MXNetError
    from .ndarray.ndarray import NDArray

    if isinstance(variables, NDArray):
        variables = [variables]
    for v in variables:
        if not v._data.requires_grad:
            raise MXNetError("variables passed to grad() must have attached "
                             "grad (attach_grad) and participate in the "
                             "graph")
    tensors, grads = _heads(heads, head_grads)
    if retain_graph is None:
        retain_graph = create_graph
    prev = set_training(train_mode)
    try:
        got = torch.autograd.grad(
            tensors, [v._data for v in variables], grads,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    finally:
        set_training(prev)
    return [NDArray(torch.zeros_like(v._data.detach()) if g is None else g)
            for v, g in zip(variables, got)]


def get_symbol(x):
    """The Symbol of the registry ops that made ``x`` inside ``record()``
    (parity: mxnet_tpu/autograd.py:424).  Each recorded op leaves a record
    on its outputs (``NDArray._producer``); an input no recorded op made
    becomes a new variable ``data<k>`` at each visit, numbered in
    visiting order, as in the JAX package."""
    from .symbol import symbol as _sym

    counter = [0]
    cache = {}

    def build(prod):
        if prod is None:
            counter[0] += 1
            return _sym.var("data%d" % counter[0])
        rec, out_index, n_out = prod
        if id(rec) not in cache:
            op_name, attrs, srcs = rec
            cache[id(rec)] = _sym._invoke_sym(
                op_name, [build(p) for p in srcs], dict(attrs))
        out = cache[id(rec)]
        return out[out_index] if n_out > 1 else out

    return build(x._producer)


class Function:
    """A differentiable function written on NDArrays (parity:
    autograd.Function, autograd.py:451): subclasses define ``forward``
    and ``backward``, which torch runs as a ``torch.autograd.Function``
    when the call is recorded.  ``save_for_backward`` keeps arrays for
    ``backward`` in ``saved_tensors``."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray

        if not is_recording():
            with pause(is_training()):
                return self.forward(*inputs)
        fn = self
        single = []

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *raw):
                with pause(is_training()):
                    outs = fn.forward(*[NDArray(r) for r in raw])
                single.append(not isinstance(outs, (list, tuple)))
                outs = [outs] if single[0] else list(outs)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *out_grads):
                with pause(is_training()):
                    igrads = fn.backward(*[NDArray(g) for g in out_grads])
                if not isinstance(igrads, (list, tuple)):
                    igrads = [igrads]
                return tuple(g._data if isinstance(g, NDArray) else g
                             for g in igrads)

        outs = [NDArray(t) for t in _Apply.apply(*[x._data for x in inputs])]
        return outs[0] if single[0] else outs
