"""Autograd over ``torch.autograd`` (parity: mxnet_tpu/autograd.py,
python/mxnet/autograd.py record/pause :122,146, mark_variables :197,
backward :243).

Recording is MXNet's explicit scope: ops run with torch's grad mode on
only inside ``record()`` (the NDArray ops and blocks ask ``grad_mode()``).
A marked variable is a leaf tensor with ``requires_grad``; ``backward``
runs ``torch.autograd.backward`` and then moves each leaf's ``.grad`` into
the variable's MXNet gradient buffer, honouring ``grad_req`` ('write'
replaces, 'add' accumulates), so torch's own accumulation never leaks
from one backward to the next.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_training", "mark_variables", "backward",
           "grad_mode"]

_state = threading.local()
# every NDArray with an attached gradient, by id; weak, so dropped arrays
# leave.  Not a WeakSet: a set compares members with ``==``, which an
# NDArray answers elementwise.
_marked = {}


def _mark(var):
    key = id(var)

    def _drop(ref, key=key):
        if _marked.get(key) is ref:
            del _marked[key]

    _marked[key] = weakref.ref(var, _drop)


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


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
        var._grad = g
        var._grad_req = req
        var._data = var._data.detach().requires_grad_(
            req != "null" and var._data.is_floating_point())
        _mark(var)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the marked variables' buffers; the
    default head gradient is ones (parity: autograd.backward)."""
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
    if not tensors:
        return
    variables = [v for v in (r() for r in list(_marked.values()))
                 if v is not None and v._grad is not None
                 and v._data.requires_grad]
    for v in variables:
        v._data.grad = None
    prev = set_training(train_mode)
    try:
        torch.autograd.backward(tensors, grads, retain_graph=retain_graph)
    finally:
        set_training(prev)
    for v in variables:
        g = v._data.grad
        if g is None:
            continue
        v._data.grad = None
        if v._grad_req == "add":
            v._grad._data.add_(g)
        elif v._grad_req != "null":
            v._grad._data = g.to(v._grad._data.dtype)
