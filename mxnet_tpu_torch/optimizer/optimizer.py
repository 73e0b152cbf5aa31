"""Optimizers of the slice (parity: mxnet_tpu/optimizer/optimizer.py —
Optimizer, SGD, Updater, create, get_updater; update arithmetic of
mxnet_tpu/ops/optimizer_ops.py:20-45).

Updates write the weight and the momentum in place (``torch.no_grad``),
as the reference's fused sgd kernels do; the JAX package rebinds fresh
arrays instead.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray

__all__ = ["Optimizer", "SGD", "Updater", "create", "register",
           "get_updater"]

_OPT_REGISTRY = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


class Optimizer:
    """Learning rate, weight decay, gradient rescale and clip; per-index
    ``lr_mult``/``wd_mult`` come from the Trainer's ``param_dict``.  (No
    lr scheduler or multi-precision path is ported yet.)"""

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=0.01, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.param_dict = param_dict or {}

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_learning_rate(self, lr):
        self.lr = lr

    def _get_lr(self, index):
        p = self.param_dict.get(index)
        return self.lr * (p.lr_mult if p is not None else 1.0)

    def _get_wd(self, index):
        p = self.param_dict.get(index)
        return self.wd * (p.wd_mult if p is not None else 1.0)


def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    """rescale -> clip -> + wd * w (optimizer_ops.py:20 order)."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * g; w += mom``, or
    ``w -= lr * g`` without momentum (sgd_update / sgd_mom_update)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return NDArray(torch.zeros_like(weight._data.detach()))

    def update(self, index, weight, grad, state):
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = _prep(grad._data, self.rescale_grad, self.clip_gradient, wd,
                      w)
            if state is None:
                w.sub_(lr * g)
            else:
                m = state._data
                m.copy_(self.momentum * m - lr * g)
                w.add_(m)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _OPT_REGISTRY:
        raise MXNetError("optimizer %r is not ported" % name)
    return _OPT_REGISTRY[key](**kwargs)


class Updater:
    """Per-index state holder that applies the optimizer (parity:
    optimizer.Updater :1621)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
