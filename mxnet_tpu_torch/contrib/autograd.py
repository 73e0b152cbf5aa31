"""Legacy contrib autograd API (parity: mxnet_tpu/contrib/autograd.py,
python/mxnet/contrib/autograd.py): the pre-gluon surface
(train_section / test_section, compute_gradient, grad_and_loss) as a
thin adapter over ``mxnet_tpu_torch.autograd``.
"""
from __future__ import annotations

import functools

from .. import autograd as _ag
from ..ndarray.ndarray import NDArray, zeros

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "grad"]


def set_is_training(is_train):
    """Returns the previous recording state (training follows)."""
    prev = _ag.set_recording(is_train)
    _ag.set_training(is_train)
    return prev


def train_section():
    """``with train_section():`` is ``autograd.record()``."""
    return _ag.record(train_mode=True)


def test_section():
    """``with test_section():`` is ``autograd.pause()``."""
    return _ag.pause(train_mode=False)


def mark_variables(variables, gradients, grad_reqs="write"):
    _ag.mark_variables(variables, gradients, grad_reqs)


def backward(outputs, out_grads=None, retain_graph=False):
    _ag.backward(outputs, head_grads=out_grads, retain_graph=retain_graph)


def compute_gradient(outputs):
    """Deprecated spelling of backward."""
    return backward(outputs)


def grad_and_loss(func, argnum=None):
    """Wrap ``func`` to return (gradients, outputs) a call; each gradient
    lies where its argument does."""

    @functools.wraps(func)
    def wrapped(*args):
        idxs = argnum if argnum is not None else list(range(len(args)))
        idxs = [idxs] if isinstance(idxs, int) else list(idxs)
        tracked = [args[i] for i in idxs]
        grads = [zeros(a.shape, ctx=a.context, dtype=a.dtype)
                 for a in tracked]
        mark_variables(tracked, grads)
        with train_section():
            outputs = func(*args)
        backward([outputs] if isinstance(outputs, NDArray) else outputs)
        return grads, outputs

    return wrapped


def grad(func, argnum=None):
    """Wrap ``func`` to return only the gradients."""
    wrapped = grad_and_loss(func, argnum)

    @functools.wraps(func)
    def only_grads(*args):
        return wrapped(*args)[0]

    return only_grads
