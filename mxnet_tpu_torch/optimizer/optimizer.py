"""Optimizers (parity: mxnet_tpu/optimizer/optimizer.py:31-613 — the base
class with its multipliers, schedules and f32 master copies, the 15
registered optimizers, ``Updater`` with ``get_states`` / ``set_states``,
``create`` and ``get_updater``).

Every update writes the weight and its states in place: through the
update ops of ``ops/optimizer_ops.py`` where the JAX class calls them,
else by the JAX class's arithmetic in the same order on the tensors,
under ``torch.no_grad``.  The JAX package rebinds fresh arrays instead.
States live on their weight's device; a state loaded by ``set_states``
moves there on its first use.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray, _invoke_nd, array
from ..ndarray.sparse import RowSparseNDArray
from .. import random as _random

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "RMSProp",
           "AdaDelta", "Ftrl", "Adamax", "Nadam", "Signum", "SignSGD",
           "SGLD", "FTML", "DCASGD", "LBSGD", "Test", "create", "register",
           "get_updater", "Updater"]

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

    def _kw(self, index, clip_key="clip_gradient"):
        """The update op's common attributes for ``index``."""
        return {"lr": self._get_lr(index), "wd": self._get_wd(index),
                "rescale_grad": self.rescale_grad,
                clip_key: self.clip_gradient or -1.0}

    def _grad(self, grad):
        """rescale, then clip (the JAX classes' NDArray prologue)."""
        g = grad._data * self.rescale_grad
        if self.clip_gradient:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def __getstate__(self):
        # the Trainer's Parameters stay out of a states blob (they hold
        # the weights); load_states sets param_dict again
        d = self.__dict__.copy()
        d["param_dict"] = {}
        return d


def _zeros(weight):
    return NDArray(torch.zeros_like(weight._data.detach()))


@register
class SGD(Optimizer):
    """SGD with momentum through sgd_update / sgd_mom_update, and the mp_
    pair for an f16 weight under ``multi_precision``.  A
    ``RowSparseNDArray`` gradient with ``lazy_update`` (the default) takes
    the lazy path: only the gradient's rows of the weight and the
    momentum are read or written (parity: mxnet_tpu/optimizer/
    optimizer.py:170-201), so the other rows keep their weight and their
    momentum; with ``lazy_update=False`` it is densified and every row's
    momentum decays.  ``gluon.Trainer`` fuses the updates of a plain
    ``SGD`` into one multi-tensor program."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        if self.lazy_update and isinstance(grad, RowSparseNDArray):
            self._lazy_update(index, weight, grad, state)
            return
        kw = self._kw(index)
        if state is not None:
            _invoke_nd("sgd_mom_update", [weight, grad, state],
                       dict(kw, momentum=self.momentum))
        else:
            _invoke_nd("sgd_update", [weight, grad], kw)

    def _lazy_update(self, index, weight, grad, state):
        """The update on the gradient's rows alone: rescale, clip, + wd *
        w, then the momentum step, in the JAX class's order."""
        lr, wd = self._get_lr(index), self._get_wd(index)
        rows = grad.indices._data
        w = weight._data
        with torch.no_grad():
            g = grad.data._data.to(w.dtype) * self.rescale_grad
            if self.clip_gradient:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            g = g + wd * w[rows]
            if state is not None:
                m = state._data
                new_m = self.momentum * m[rows] - lr * g
                m.index_copy_(0, rows, new_m)
                w.index_add_(0, rows, new_m)
            else:
                w.index_add_(0, rows, -lr * g)

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and weight.dtype == np.float16:
            inner, w32 = state
            self._update_count(index)
            kw = self._kw(index)
            if inner is not None:
                _invoke_nd("mp_sgd_mom_update", [weight, grad, inner, w32],
                           dict(kw, momentum=self.momentum))
            else:
                _invoke_nd("mp_sgd_update", [weight, grad, w32], kw)
        else:
            self.update(index, weight, grad, state)


@register
class LBSGD(SGD):
    """Large-batch SGD (the reference's warmup arguments are accepted; the
    update is SGD's, as in the JAX class)."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)


@register
class Signum(Optimizer):
    """signum_update with momentum, signsgd_update without."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros(weight) if self.momentum != 0.0 else None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._kw(index)
        if state is not None:
            _invoke_nd("signum_update", [weight, grad, state],
                       dict(kw, momentum=self.momentum, wd_lh=self.wd_lh))
        else:
            _invoke_nd("signsgd_update", [weight, grad], kw)


SignSGD = Signum


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        d, v, z = state
        _invoke_nd("ftml_update", [weight, grad, d, v, z],
                   dict(self._kw(index, "clip_grad"), beta1=self.beta1,
                        beta2=self.beta2, epsilon=self.epsilon,
                        t=self._index_update_count[index]))


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD; its state keeps a copy of the weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (None if self.momentum == 0.0 else _zeros(weight),
                NDArray(weight._data.detach().clone()))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        mom, prev = state
        w, p = weight._data, prev._data
        with torch.no_grad():
            g = self._grad(grad)
            delta = self.lamda * g * g * (w - p)
            if mom is not None:
                m = mom._data
                m.copy_(self.momentum * m - lr * (g + wd * w + delta))
                w.copy_(w + m)
            else:
                w.copy_(w - lr * (g + wd * w + delta))
            p.copy_(w)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: half an SGD step plus
    N(0, lr) noise drawn on the weight's device from the framework
    generator there."""

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = self._grad(grad)
            noise = torch.normal(0.0, math.sqrt(lr), tuple(w.shape),
                                 generator=_random.next_key(w.device),
                                 dtype=w.dtype, device=w.device)
            w.copy_(w - lr / 2 * (g + wd * w) + noise)


@register
class Adam(Optimizer):
    """adam_update with the bias corrections folded into the rate.
    ``lazy_update`` is accepted; a row-sparse gradient is densified (with
    the RuntimeWarning), as in the JAX class."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        kw = self._kw(index)
        kw["lr"] *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        _invoke_nd("adam_update", [weight, grad, mean, var],
                   dict(kw, beta1=self.beta1, beta2=self.beta2,
                        epsilon=self.epsilon))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        w, s = weight._data, state._data
        with torch.no_grad():
            g = self._grad(grad) + wd * w
            s.copy_(s + g * g)
            w.copy_(w - lr * g / ((s ** 0.5) + self.float_stable_eps))


@register
class RMSProp(Optimizer):
    """rmsprop_update, or rmspropalex_update when ``centered``."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return _zeros(weight), _zeros(weight), _zeros(weight)
        return (_zeros(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = dict(self._kw(index), gamma1=self.gamma1, epsilon=self.epsilon,
                  clip_weights=self.clip_weights or -1.0)
        if not self.centered:
            _invoke_nd("rmsprop_update", [weight, grad, state[0]], kw)
        else:
            n, g, delta = state
            _invoke_nd("rmspropalex_update", [weight, grad, n, g, delta],
                       dict(kw, gamma2=self.gamma2))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        w, acc_g, acc_delta = weight._data, state[0]._data, state[1]._data
        rho, eps = self.rho, self.epsilon
        with torch.no_grad():
            g = self._grad(grad)
            acc_g.copy_(rho * acc_g + (1 - rho) * g * g)
            delta = ((acc_delta + eps) ** 0.5) / ((acc_g + eps) ** 0.5) * g
            acc_delta.copy_(rho * acc_delta + (1 - rho) * delta * delta)
            w.copy_(w - delta - wd * w)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        z, n = state
        _invoke_nd("ftrl_update", [weight, grad, z, n],
                   dict(self._kw(index), lamda1=self.lamda1, beta=self.beta))


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1.0 - self.beta1 ** t)
        wd = self._get_wd(index)
        w, m, u = weight._data, state[0]._data, state[1]._data
        with torch.no_grad():
            g = grad._data * self.rescale_grad + wd * w
            if self.clip_gradient:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            m.copy_(self.beta1 * m + (1.0 - self.beta1) * g)
            u.copy_(torch.maximum(self.beta2 * u, torch.abs(g)))
            w.copy_(w - lr * m / u)


@register
class Nadam(Optimizer):
    """Nesterov Adam; ``m_schedule`` advances on every update call, over
    all parameters, as in the JAX class."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros(weight), _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        b1, b2 = self.beta1, self.beta2
        momentum_t = b1 * (1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                  * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        w, m, v = weight._data, state[0]._data, state[1]._data
        with torch.no_grad():
            g = grad._data * self.rescale_grad + wd * w
            if self.clip_gradient:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            m.copy_(b1 * m + (1.0 - b1) * g)
            v.copy_(b2 * v + (1.0 - b2) * g * g)
            g_prime = g / (1.0 - self.m_schedule)
            m_prime = m / (1.0 - m_schedule_next)
            v_prime = v / (1.0 - b2 ** t)
            m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
            w.copy_(w - lr * m_bar / ((v_prime ** 0.5) + self.epsilon))


@register
class NAG(Optimizer):
    """nag_mom_update with momentum, sgd_update without."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._kw(index)
        if state is not None:
            _invoke_nd("nag_mom_update", [weight, grad, state],
                       dict(kw, momentum=self.momentum))
        else:
            _invoke_nd("sgd_update", [weight, grad], kw)


@register
class Test(Optimizer):
    """w += rescale * g; the state holds a copy of the new weight."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        w = weight._data
        with torch.no_grad():
            w.copy_(w + grad._data * self.rescale_grad)
            state._data.copy_(w)


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _OPT_REGISTRY:
        raise MXNetError("optimizer %r not registered" % name)
    return _OPT_REGISTRY[key](**kwargs)


def _map_state(fn, state):
    if isinstance(state, (list, tuple)):
        return tuple(_map_state(fn, s) for s in state)
    return fn(state)


class Updater:
    """Per-index state holder that applies the optimizer (parity:
    mxnet_tpu/optimizer/optimizer.py:556-608, the reference's
    optimizer.Updater :1621).  ``get_states`` pickles the states as numpy
    arrays (with the optimizer when ``dump_optimizer``); ``set_states``
    takes such a blob, the JAX package's included, and keeps the states
    on the CPU until each one's first use moves it to its weight's
    device (``states_synced``)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def state(self, index, weight):
        """The state of ``index``: created for ``weight`` at first use, or
        moved to ``weight``'s device after ``set_states``."""
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            ctx = weight.context
            self.states[index] = _map_state(
                lambda s: s.as_in_context(ctx) if isinstance(s, NDArray)
                else s, self.states[index])
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        self.optimizer.update_multi_precision(
            index, weight, grad, self.state(index, weight))

    def get_states(self, dump_optimizer=False):
        states = {k: _map_state(
            lambda s: s.asnumpy() if isinstance(s, NDArray) else s, v)
            for k, v in self.states.items()}
        if dump_optimizer:
            return pickle.dumps((states, self.optimizer))
        return pickle.dumps(states)

    def set_states(self, states):
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2 and \
                isinstance(states[1], Optimizer):
            states, self.optimizer = states
        self.states = {k: _map_state(
            lambda s: array(s, ctx=cpu(), dtype=s.dtype)
            if isinstance(s, np.ndarray) else s, v)
            for k, v in states.items()}
        self.states_synced = dict.fromkeys(self.states, False)


def get_updater(optimizer):
    return Updater(optimizer)
