"""Gluon Trainer (parity: mxnet_tpu/gluon/trainer.py; reference
python/mxnet/gluon/trainer.py — kvstore setup :169, step :298,
allreduce_grads :327, update :359).

Store rules as in the JAX package (trainer.py:71-91): a string store on a
single context is bypassed (local updates) unless it is ``dist*``; a
``KVStore`` object is used.  With ``update_on_kvstore`` (the default for a
``dist*`` store) the store runs the optimizer and ``step`` pulls the new
weights back; without it, ``step`` pushes the gradients, pulls their sum
back into them and updates locally.  A ``dist*`` store gets every key in
one ``init`` call and the trainer pulls them back, so each worker starts
from rank 0's weights (upstream's ``_init_params``).  ``step`` sets the
optimizer's ``rescale_grad`` before it creates the store, as upstream
1.5's ``_check_and_rescale_grad`` does, so the optimizer a parameter
server unpickles holds 1 / batch_size; the JAX package creates the store
first and the server's copy keeps the unscaled factor
(mxnet_tpu/gluon/trainer.py:117-121).  The local update of a plain
``SGD`` (not ``multi_precision``) with no store on one context is one
multi-tensor program over all the parameters (``_try_fused_update``, the
counterpart of the JAX package's one jitted update, trainer.py:177-257);
any other optimizer loops over the parameters through the ``Updater``.
"""
from __future__ import annotations

import warnings

import torch

from .parameter import ParameterDict, Parameter
from .. import optimizer as opt
from .. import kvstore as kvs
from ..checkpoint import atomic_write

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got %s." % type(params))
        self._params = []
        self._param2idx = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise ValueError("First argument must be a list or dict of "
                                 "Parameters, got list of %s." % type(param))
            self._param2idx[param.name] = i
            self._params.append(param)
        self._compression_params = compression_params
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._check_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._params_to_init = list(self._params)
        # the fused SGD update's plan key and how many steps it took
        self._fused_key = None
        self._fused_updates = 0

    def _check_contexts(self):
        contexts = None
        for param in self._params:
            ctx = param.list_ctx()
            if contexts is not None and contexts != ctx:
                raise ValueError("All Parameters must be initialized on the "
                                 "same set of contexts")
            contexts = ctx
        return contexts

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts]

    def _init_kvstore(self):
        kvstore = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        if kvstore is None or (isinstance(kvstore, str)
                               and len(self._contexts) == 1
                               and not kvstore.startswith("dist")):
            # single device: local updates, no kvstore needed
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            store = kvs.create(kvstore) if isinstance(kvstore, str) \
                else kvstore
            self._kvstore = store
            if update_on_kvstore is None:
                update_on_kvstore = store.type.startswith("dist")
            self._update_on_kvstore = update_on_kvstore
            if self._compression_params:
                store.set_gradient_compression(self._compression_params)
            if self._update_on_kvstore:
                store.set_optimizer(self._optimizer)
        self._kv_initialized = True

    def _init_params(self):
        store = self._kvstore
        if store is not None and self._params_to_init:
            keys = [self._param2idx[p.name] for p in self._params_to_init]
            store.init(keys, [p.list_data()[0] for p in self._params_to_init])
            if store.type.startswith("dist"):
                store.pull(keys, [p.list_data() for p in self._params_to_init])
        self._params_to_init = []

    def _prepare_states(self):
        """Set up the store and its keys on first use."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._params_to_init:
            self._init_params()

    @property
    def learning_rate(self):
        if self._optimizer.lr_scheduler is not None:
            return self._optimizer._get_lr(0)
        return self._optimizer.lr

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _rescale(self, batch_size):
        scale = self._scale / batch_size
        if self._update_on_kvstore and self._kvstore is not None and \
                self._kvstore.type.startswith("dist") and \
                self._optimizer.rescale_grad != scale:
            warnings.warn("the batch size changed after the first step: the "
                          "parameter server's optimizer keeps rescale_grad "
                          "%g, not %g" % (self._optimizer.rescale_grad, scale))
        self._optimizer.rescale_grad = scale

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce gradients and update, rescaling by 1 / batch_size."""
        self._rescale(batch_size)
        self._prepare_states()
        self._allreduce_grads()
        self._update()

    def allreduce_grads(self):
        self._prepare_states()
        self._allreduce_grads()

    def _trainable(self):
        return [i for i, p in enumerate(self._params) if p.grad_req != "null"]

    def _allreduce_grads(self):
        if self._kvstore is None:
            return
        keys = self._trainable()
        if not keys:
            return
        grads = [self._params[i].list_grad() for i in keys]
        self._kvstore.push(keys, grads, priority=0)
        if not self._update_on_kvstore:
            self._kvstore.pull(keys, grads, priority=0, ignore_sparse=False)

    def update(self, batch_size, ignore_stale_grad=False):
        self._prepare_states()
        if self._kvstore and self._update_on_kvstore:
            raise ValueError("update() when parameters are updated on "
                             "kvstore is not supported. Try setting "
                             "`update_on_kvstore` to False.")
        self._rescale(batch_size)
        self._update()

    def _update(self):
        if self._try_fused_update():
            return
        keys = self._trainable()
        if self._kvstore and self._update_on_kvstore:
            if keys:
                self._kvstore.pull(keys, [self._params[i].list_data()
                                          for i in keys], priority=0)
            return
        for i in keys:
            param = self._params[i]
            for upd, arr, grad in zip(self._updaters, param.list_data(),
                                      param.list_grad()):
                upd(i, grad, arr)

    def _try_fused_update(self):
        """The SGD update of every parameter as one multi-tensor program
        (``torch._foreach_*``, a few launches over all the tensors in
        place of 2-3 per parameter), in the per-parameter ops' order:
        g = rescale * grad, clipped, + wd * w; then mom = momentum * mom -
        lr * g and w += mom, or w -= lr * g.  The momentum buffers are the
        Updater's states, so ``save_states`` sees them.  The plan (the
        parameters in order and their state) is rebuilt when the
        parameters, ``momentum`` or ``clip_gradient`` change, as the JAX
        trainer's jit key is.  Returns False, and the loop runs, for any
        other optimizer (an SGD subclass too), ``multi_precision``, a
        kvstore or several contexts."""
        o = self._optimizer
        if type(o) is not opt.SGD or o.multi_precision or \
                self._kvstore is not None or len(self._contexts) != 1:
            return False
        params = [p for p in self._params
                  if p.grad_req != "null" and p._data is not None]
        if not params:
            return False
        key = (tuple(p.name for p in params), float(o.momentum),
               o.clip_gradient)
        if self._fused_key != key:
            self._fused_idxs = [self._param2idx[p.name] for p in params]
            self._fused_key = key
        upd = self._updaters[0]
        idxs = self._fused_idxs
        states = [upd.state(i, p.list_data()[0])
                  for i, p in zip(idxs, params)]
        for i in idxs:
            o._update_count(i)
        lrs = [float(o._get_lr(i)) for i in idxs]
        wds = [float(o._get_wd(i)) for i in idxs]
        ws = [p.list_data()[0]._data for p in params]
        gs = [p.list_grad()[0]._data for p in params]
        clip = o.clip_gradient
        with torch.no_grad():
            g = torch._foreach_mul(gs, float(o.rescale_grad))
            if clip:
                torch._foreach_clamp_min_(g, -clip)
                torch._foreach_clamp_max_(g, clip)
            torch._foreach_add_(g, torch._foreach_mul(ws, wds))
            torch._foreach_mul_(g, lrs)
            if states[0] is None:
                torch._foreach_sub_(ws, g)
            else:
                ms = [st._data for st in states]
                torch._foreach_mul_(ms, float(o.momentum))
                torch._foreach_sub_(ms, g)
                torch._foreach_add_(ws, ms)
        self._fused_updates += 1
        return True

    def save_states(self, fname):
        """Write the optimizer and its states (parity: trainer.py:259):
        through the store's updater with ``update_on_kvstore``, else the
        local Updater's ``get_states(dump_optimizer=True)``."""
        self._prepare_states()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
        else:
            atomic_write(fname,
                         self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read what ``save_states`` wrote (or a states blob without the
        optimizer, the JAX package's included); the optimizer gets this
        trainer's parameters back."""
        self._prepare_states()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._updaters[0].optimizer
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = {i: param for i, param
                                      in enumerate(self._params)}
