"""Module: symbol + executor-group driver (parity: mxnet_tpu/module/
module.py; python/mxnet/module/module.py:40 — bind:364,
init_optimizer:474, forward:575, backward:629, update:646).  Each
executor runs its symbol as one compiled function (``executor``).

``init_optimizer`` works over the port's ``kvstore`` and ``optimizer``;
a ``dist*`` kvstore raises, as the distributed store is not ported.
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..context import cpu, Context, current_context
from ..ndarray.ndarray import zeros
from .. import optimizer as opt
from .. import kvstore as kvs
from ..io.io import DataDesc
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


def _descs(shapes):
    """Normalize (name, shape) tuples / DataDesc into DataDesc list."""
    if not shapes:
        return None
    return [s if isinstance(s, DataDesc) else DataDesc(*s) for s in shapes]


class Module(BaseModule):
    """Executes one Symbol over one or more contexts with data parallelism."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None,
                 remat_policy=None, fusion=None, aot=None,
                 dtype_policy=None):
        super().__init__(logger=logger)
        from ..executor import _not_ported
        from ..fusion_cost import resolve_fusion

        _not_ported(remat_policy=remat_policy, aot=aot)
        resolve_fusion(fusion)   # a bad spec fails here, not at bind
        self._remat_policy = remat_policy
        self._fusion = fusion
        self._aot = aot
        self._dtype_policy = dtype_policy
        ctxs = context if context is not None else current_context()
        if isinstance(ctxs, Context):
            ctxs = [ctxs]
        self._context = ctxs
        self._work_load_list = work_load_list or [1] * len(ctxs)
        self._group2ctxs = group2ctxs
        self._symbol = symbol
        self._classify_inputs(symbol, data_names, label_names, state_names,
                              fixed_param_names)
        self._arg_params = self._aux_params = None
        self._params_dirty = False
        self._compression_params = compression_params
        self._optimizer = self._kvstore = self._update_on_kvstore = None
        self._updater = self._preload_opt_states = None
        self._exec_group = self._data_shapes = self._label_shapes = None

    def _classify_inputs(self, symbol, data_names, label_names, state_names,
                         fixed_param_names):
        """Split symbol arguments into data/label/state/param name lists."""
        data_names = list(data_names or [])
        label_names = list(label_names or [])
        state_names = list(state_names or [])
        fixed_param_names = list(fixed_param_names or [])
        for names, kind, strict in ((data_names, "data", True),
                                    (label_names, "label", False),
                                    (state_names, "state", True),
                                    (fixed_param_names, "fixed_param", True)):
            _check_input_names(symbol, names, kind, strict)
        args = symbol.list_arguments()
        non_params = set(data_names) | set(label_names) | set(state_names)
        self._data_names, self._state_names = data_names, state_names
        self._label_names = [n for n in label_names if n in args]
        self._fixed_param_names = fixed_param_names
        self._param_names = [a for a in args if a not in non_params]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        from ..model import load_checkpoint

        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint

        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, *self.get_params())
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------
    data_names = property(lambda self: self._data_names)
    label_names = property(lambda self: self._label_names)
    output_names = property(lambda self: self._output_names)

    def _bound(self, attr):
        assert self.binded, "module is not bound"
        return getattr(self, attr)

    data_shapes = property(lambda self: self._bound("_data_shapes"))
    label_shapes = property(lambda self: self._bound("_label_shapes"))

    @property
    def output_shapes(self):
        self._bound("_exec_group")
        # shape inference, not execution — valid right after bind()
        feed = {d.name: d.shape for d in self._data_shapes}
        if self._label_shapes:
            feed.update({l.name: l.shape for l in self._label_shapes})
        _, out_shapes, _ = self._symbol.infer_shape(**feed)
        return list(zip(self._output_names, out_shapes))

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    def get_params(self):
        self._require()
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        from ..initializer import InitDesc, Uniform

        if initializer is None:
            initializer = Uniform(0.01)
        attrs = self._symbol.attr_dict()

        def _fill(store, source):
            for name in sorted(store):
                arr = store[name]
                desc = InitDesc(name, attrs.get(name, None))
                if source is None:
                    initializer(desc, arr)
                elif name in source:
                    if source[name] is not arr:
                        source[name].copyto(arr)
                elif not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                elif initializer is not None:
                    initializer(desc, arr)

        _fill(self._arg_params, arg_params)
        _fill(self._aux_params, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    # ------------------------------------------------------------------
    # Binding
    # ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if not for_training:
            assert not inputs_need_grad
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)

        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group, self.logger,
            self._fixed_param_names, grad_req, self._state_names,
            self._group2ctxs, remat_policy=self._remat_policy,
            fusion=self._fusion, aot=self._aot,
            dtype_policy=self._dtype_policy)
        self.binded = True

        if shared_module is not None and shared_module.params_initialized:
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
        elif self._arg_params is None:
            exec0 = self._exec_group.execs[0]
            # the module's own copies live on the host, as upstream's
            self._arg_params = {
                n: zeros(exec0.arg_dict[n].shape,
                         dtype=exec0.arg_dict[n].dtype, ctx=cpu())
                for n in self._param_names if n in exec0.arg_dict}
            self._aux_params = {n: zeros(a.shape, dtype=a.dtype, ctx=cpu())
                                for n, a in exec0.aux_dict.items()}
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = self._data_shapes = self._label_shapes = None

    def reshape(self, data_shapes, label_shapes=None):
        assert self.binded, "Module not bound"
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes)
        self._exec_group.bind_exec(self._data_shapes, self._label_shapes,
                                   reshape=True)
        self._exec_group.set_params(self._arg_params, self._aux_params)

    # ------------------------------------------------------------------
    # Optimizer
    # ------------------------------------------------------------------
    def _effective_batch_size(self, kvstore_obj):
        bs = self._exec_group.batch_size
        if kvstore_obj and "dist" in kvstore_obj.type and \
                "_sync" in kvstore_obj.type:
            bs *= kvstore_obj.num_workers
        return bs

    def _build_optimizer(self, optimizer, optimizer_params, rescale_grad):
        idx2name = dict(enumerate(self._param_names))
        if isinstance(optimizer, str):
            params = dict(optimizer_params)
            params.setdefault("rescale_grad", rescale_grad)
            return opt.create(optimizer, sym=self.symbol,
                              param_idx2name=idx2name, **params)
        assert isinstance(optimizer, opt.Optimizer)
        if optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but rescale_grad "
                "is not normalized to 1.0/batch_size/num_workers (%s vs. "
                "%s).", optimizer.rescale_grad, rescale_grad)
        if not optimizer.idx2name:
            optimizer.idx2name = idx2name
        return optimizer

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        if isinstance(kvstore, str) and "dist" in kvstore:
            raise MXNetError("kvstore %r: the distributed kvstore is not "
                             "ported yet" % kvstore)
        if isinstance(kvstore, str):
            # reference _create_kvstore: a local store with one device
            # is skipped entirely — the store's accumulate semantics are
            # only meaningful as a cross-device reduce buffer
            if "dist" not in kvstore and len(self._context) == 1:
                store = None
            else:
                store = kvs.create(kvstore)
        else:
            store = kvstore
        update_on_kvstore = False   # only a dist store updates on itself
        rescale = 1.0 / self._effective_batch_size(store)
        self._optimizer = self._build_optimizer(optimizer, optimizer_params,
                                                rescale)
        self._kvstore = store
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if store:
            if self._compression_params:
                store.set_gradient_compression(self._compression_params)
            for idx, name in enumerate(self._param_names):
                if name in self._arg_params:
                    store.init(idx, self._arg_params[name])
            if update_on_kvstore:
                store.set_optimizer(self._optimizer)
        if not update_on_kvstore:
            self._updater = opt.get_updater(self._optimizer)
        self.optimizer_initialized = True

        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # ------------------------------------------------------------------
    # Compute
    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require()
        first = data_batch[0] if isinstance(data_batch, list) else data_batch
        incoming = tuple(d.shape for d in first.data)
        bound = tuple(d.shape for d in self._data_shapes)
        if incoming != bound:
            self.reshape(*self._shapes_from_batch(data_batch, incoming))
        self._exec_group.forward(data_batch, is_train)

    def _shapes_from_batch(self, batch, incoming):
        """Derive (data_descs, label_descs) for a shape-changing batch."""
        if getattr(batch, "provide_data", None):
            dshapes = batch.provide_data
        else:
            dshapes = [DataDesc(d.name, s, d.dtype, d.layout)
                       for d, s in zip(self._data_shapes, incoming)]
        if getattr(batch, "provide_label", None):
            lshapes = batch.provide_label
        elif getattr(batch, "label", None):
            lshapes = [DataDesc(d.name, arr.shape, d.dtype, d.layout)
                       for d, arr in zip(self._label_shapes, batch.label)]
        else:
            lshapes = None
        return dshapes, lshapes

    def backward(self, out_grads=None):
        self._require()
        self._exec_group.backward(out_grads=out_grads)

    def _grad_walk(self):
        """Yield (idx, name, grad_list, arg_list) per learnable param."""
        for idx, name in enumerate(self._param_names):
            grads = [e.grad_dict[name] for e in self._exec_group.execs
                     if name in e.grad_dict]
            if grads:
                args = [e.arg_dict[name] for e in self._exec_group.execs
                        if name in e.grad_dict]
                yield idx, name, grads, args

    def update(self):
        self._require()
        assert self.optimizer_initialized, "optimizer not initialized"
        self._params_dirty = True
        if self._update_on_kvstore:
            for idx, _, grads, args in self._grad_walk():
                self._kvstore.push(idx, grads)
                self._kvstore.pull(idx, args)
            return
        if self._kvstore:
            # Reduce across devices through the store, then update locally.
            for idx, _, grads, _ in self._grad_walk():
                self._kvstore.push(idx, grads)
                self._kvstore.pull(idx, grads)
        for idx, _, grads, args in self._grad_walk():
            for g, a in zip(grads, args):
                self._updater(idx, g, a)

    def get_outputs(self, merge_multi_context=True):
        self._require()
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require()
        assert self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    def _outputs_finite(self):
        """Device-side probe for the fit non-finite guard: reduce every
        float output to ONE boolean on device and sync only that,
        instead of transferring full output arrays to the host each
        batch (the per-batch ``asnumpy`` the guard used to pay)."""
        flags = [torch.isfinite(o._data).all() for o in self.get_outputs()
                 if o._data.is_floating_point() or o._data.is_complex()]
        if not flags:
            return True
        return bool(torch.stack(flags).all())

    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        if self._kvstore and self._update_on_kvstore:
            for idx, name in enumerate(self._param_names):
                if name in self._arg_params:
                    self._kvstore.pull(idx, [self._arg_params[name]])
        self._params_dirty = False

    # ------------------------------------------------------------------
    # Optimizer state persistence
    # ------------------------------------------------------------------
    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized, "optimizer not initialized"
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            from ..checkpoint import atomic_write

            atomic_write(fname, self._updater.get_states())

    def get_optimizer_states_bytes(self):
        """Serialized optimizer state, or None when it lives on a dist
        kvstore (CheckpointManager blob source)."""
        assert self.optimizer_initialized, "optimizer not initialized"
        if self._update_on_kvstore:
            return None
        return self._updater.get_states()

    def set_optimizer_states_bytes(self, states):
        """Restore optimizer state from bytes (CheckpointManager blob)."""
        assert self.optimizer_initialized, "optimizer not initialized"
        if self._update_on_kvstore:
            raise MXNetError("cannot restore optimizer-state bytes when "
                             "updates run on a dist kvstore")
        self._updater.set_states(states)

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized, "optimizer not initialized"
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def install_monitor(self, mon):
        assert self.binded, "Module not bound"
        self._exec_group.install_monitor(mon)
