"""Optimizers of the slice (parity: mxnet_tpu/optimizer/optimizer.py —
Optimizer, SGD, Updater, create, get_updater; update arithmetic of
mxnet_tpu/ops/optimizer_ops.py:20-57).

Updates write the weight and the momentum in place (``torch.no_grad``),
as the reference's fused sgd kernels do; the JAX package rebinds fresh
arrays instead.
"""
from __future__ import annotations

import numpy as np
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
    """Learning rate (or an ``lr_scheduler`` called with ``num_update``),
    weight decay, gradient rescale and clip; per-index ``lr_mult`` and
    ``wd_mult`` from the Trainer's ``param_dict``, else by name through
    ``param_idx2name`` (names that end in neither ``_weight`` nor
    ``_gamma`` get no weight decay) and the symbol's ``__lr_mult__`` /
    ``__wd_mult__`` attributes.  ``multi_precision`` keeps an f32 master
    copy of each f16 weight."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = ((sym.attr_dict(), sym.list_arguments())
                         if sym is not None else ())
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype == np.float16:
            master = NDArray(weight._data.detach().to(torch.float32))
            return self.create_state(index, master), master
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """The update on the f32 master copy of an f16 weight, then the
        weight rounded from it (parity: mp_sgd_update / mp_sgd_mom_update
        of optimizer_ops.py:44-57)."""
        if self.multi_precision and weight.dtype == np.float16:
            inner, master = state
            self.update(index, master,
                        NDArray(grad._data.to(torch.float32)), inner)
            with torch.no_grad():
                weight._data.copy_(master._data)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined.")
        self.lr = lr

    def _attr_mults(self, key):
        out = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and key in attr[name]:
                    out[name] = float(attr[name][key])
        return out

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._attr_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not (n.endswith("_weight") or n.endswith("_gamma"))}
        self.wd_mult.update(self._attr_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        for idx in index if isinstance(index, (list, tuple)) else [index]:
            count = self._index_update_count.get(idx, self.begin_num_update)
            self._index_update_count[idx] = count + 1
            self.num_update = max(count + 1, self.num_update)

    def _mult(self, index, attr, by_name):
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in by_name:
            return by_name[index]
        if index in self.idx2name:
            return by_name.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        return lr * self._mult(index, "lr_mult", self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._mult(index, "wd_mult", self.wd_mult)


def _prep(grad, rescale_grad, clip_gradient, wd, weight):
    """rescale -> clip -> + wd * w (optimizer_ops.py:20 order)."""
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * g; w += mom``, or
    ``w -= lr * g`` without momentum (sgd_update / sgd_mom_update).
    ``lazy_update`` is kept for the reference's row-sparse path, which the
    port does not have (every gradient is dense)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return NDArray(torch.zeros_like(weight._data.detach()))

    def update(self, index, weight, grad, state):
        self._update_count(index)
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
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)
