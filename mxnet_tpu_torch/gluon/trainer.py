"""Gluon Trainer (parity: mxnet_tpu/gluon/trainer.py; reference
python/mxnet/gluon/trainer.py — kvstore setup :169, step :298,
allreduce_grads :327, update :359).

Store rules as in the JAX package (trainer.py:71-91): a string store on a
single context is bypassed (local updates); a ``KVStore`` object is used.
With ``update_on_kvstore`` the store runs the optimizer and ``step``
pulls the new weights back.  The local update is a plain loop over the
parameters (the JAX package fuses it into one jitted program).
"""
from __future__ import annotations

from .parameter import ParameterDict, Parameter
from .. import optimizer as opt
from .. import kvstore as kvs

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
        if self._kvstore is not None:
            for param in self._params_to_init:
                self._kvstore.init(self._param2idx[param.name],
                                   param.list_data()[0])
        self._params_to_init = []

    def _ensure_kvstore(self):
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

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce gradients and update, rescaling by 1 / batch_size."""
        self._ensure_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update()

    def allreduce_grads(self):
        self._ensure_kvstore()
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
        self._ensure_kvstore()
        if self._kvstore and self._update_on_kvstore:
            raise ValueError("update() when parameters are updated on "
                             "kvstore is not supported. Try setting "
                             "`update_on_kvstore` to False.")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
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
