"""BucketingModule (parity: mxnet_tpu/module/bucketing_module.py;
python/mxnet/module/bucketing_module.py:36 — one Module per bucket key,
sharing parameters).  Each bucket is its own compiled signature, and
parameters are shared across buckets by copying through the default
bucket's arrays."""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        self._default_bucket_key = default_bucket_key
        self._gen_fn = sym_gen
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names or []
        self._state_names = state_names or []
        self._group2ctxs = group2ctxs
        self._compression_params = compression_params
        self._mods_by_key = {}
        self._active_mod = None
        self._active_key = None
        self._host_params_stale = False
        self._monitor = None
        self._grad_req = None

    def _reset_bind(self):
        self.binded = False
        self._mods_by_key = {}
        self._active_mod = None
        self._active_key = None

    @property
    def data_names(self):
        if self.binded:
            return self._active_mod.data_names
        _, data_names, _ = self._generate_symbol(self._default_bucket_key)
        return data_names

    @property
    def output_names(self):
        if self.binded:
            return self._active_mod.output_names
        symbol, _, _ = self._generate_symbol(self._default_bucket_key)
        return symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded, "BucketingModule is not bound"
        return self._active_mod.data_shapes

    @property
    def label_shapes(self):
        assert self.binded, "BucketingModule is not bound"
        return self._active_mod.label_shapes

    @property
    def output_shapes(self):
        assert self.binded, "BucketingModule is not bound"
        return self._active_mod.output_shapes

    @property
    def symbol(self):
        assert self.binded, "BucketingModule is not bound"
        return self._active_mod.symbol

    def _generate_symbol(self, bucket_key):
        return self._gen_fn(bucket_key)

    def get_params(self):
        assert self.params_initialized
        # the child Module's own flag is named _params_dirty
        self._active_mod._params_dirty = self._host_params_stale
        params = self._active_mod.get_params()
        self._host_params_stale = False
        return params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "BucketingModule is not bound"
        self._active_mod.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init,
                                      allow_extra=allow_extra)
        self._host_params_stale = False
        self.params_initialized = True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._active_mod.set_params(arg_params, aux_params,
                                     allow_missing=allow_missing,
                                     force_init=force_init,
                                     allow_extra=allow_extra)
        self._host_params_stale = False
        self.params_initialized = True

    def _new_module(self, symbol, data_names, label_names):
        """One Module per bucket, all sharing this module's config."""
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names,
                      group2ctxs=self._group2ctxs,
                      compression_params=self._compression_params)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        symbol, data_names, label_names = self._generate_symbol(
            self._default_bucket_key)
        module = self._new_module(symbol, data_names, label_names)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    force_rebind=False, shared_module=None, grad_req=grad_req)
        self._active_mod = module
        self._active_key = self._default_bucket_key
        self._mods_by_key[self._default_bucket_key] = module
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._mods_by_key:
            symbol, data_names, label_names = self._generate_symbol(bucket_key)
            module = self._new_module(symbol, data_names,
                                      label_names)
            module.bind(data_shapes, label_shapes, self._active_mod.for_training,
                        self._active_mod.inputs_need_grad,
                        force_rebind=False,
                        shared_module=self._mods_by_key[self._default_bucket_key],
                        grad_req=self._grad_req)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._mods_by_key[bucket_key] = module
        self._active_mod = self._mods_by_key[bucket_key]
        self._active_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized, \
            "bind() and init_params() must run first"
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._active_mod.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        # other buckets borrow the active module's optimizer state at
        # switch time (see forward's _optimizer/_updater/_kvstore copy)
        self.optimizer_initialized = True

    def prepare(self, data_batch, sparse_row_id_fn=None):
        assert self.binded and self.params_initialized, \
            "bind() and init_params() must run first"
        bucket_key = data_batch.bucket_key
        original_bucket_key = self._active_key
        data_shapes = data_batch.provide_data
        label_shapes = data_batch.provide_label
        self.switch_bucket(bucket_key, data_shapes, label_shapes)
        self.switch_bucket(original_bucket_key, None, None)

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized, \
            "bind() and init_params() must run first"
        bucket_key = getattr(data_batch, "bucket_key",
                             self._default_bucket_key)
        prev = self._active_mod
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        if self._active_mod is not prev and prev.params_initialized:
            arg, aux = prev.get_params()
            self._active_mod.set_params(arg, aux)
            self._active_mod.optimizer_initialized = \
                prev.optimizer_initialized
            self._active_mod._optimizer = prev._optimizer
            self._active_mod._updater = prev._updater
            self._active_mod._kvstore = prev._kvstore
            self._active_mod._update_on_kvstore = prev._update_on_kvstore
        self._active_mod.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized, \
            "bind() and init_params() must run first"
        self._active_mod.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._host_params_stale = True
        self._active_mod.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized, \
            "bind() and init_params() must run first"
        return self._active_mod.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._active_mod.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized, \
            "bind() and init_params() must run first"
        self._active_mod.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        assert self.binded, "BucketingModule is not bound"
        self._monitor = mon
        for mod in self._mods_by_key.values():
            mod.install_monitor(mon)
