"""SequentialModule: chain several modules end to end.

Parity: mxnet_tpu/module/sequential_module.py, ``python/mxnet/module/sequential_module.py`` — same
metas (``take_labels``, ``auto_wiring``), same chaining contract: each
module's outputs become the next module's data, labels are shared by
every module that asked for them, and backward threads input-gradients
in reverse.
"""
from __future__ import annotations

import logging

from .base_module import BaseModule

__all__ = ["SequentialModule"]


class _ChainBatch:
    """Minimal data-batch view handed to an inner module."""

    def __init__(self, data, label, pad=0):
        self.data = data
        self.label = label
        self.pad = pad


class SequentialModule(BaseModule):
    """Container chaining modules; outputs of module i feed module i+1."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"
    _KNOWN_METAS = frozenset({META_TAKE_LABELS, META_AUTO_WIRING})

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._data_shapes = None
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append ``module``; meta kwargs steer label/wiring behavior.
        Returns self for chaining."""
        unknown = set(kwargs) - self._KNOWN_METAS
        if unknown:
            raise ValueError('Unknown meta "%s", a typo?' % unknown.pop())
        self._modules.append(module)
        self._metas.append(kwargs)
        # adding resets bind/init state
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # ------------------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for m in self._modules:
            arg, aux = m.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params, allow_missing=True,
                          force_init=force_init, allow_extra=True)

        # duplicate parameter names across sub-modules are a wiring bug
        seen = {}
        for i, m in enumerate(self._modules):
            arg, aux = m.get_params()
            for name in list(arg) + list(aux):
                if name in seen:
                    raise ValueError(
                        "Duplicate parameter %r in modules %d and %d"
                        % (name, seen[name], i))
                seen[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._modules, "Attempting to bind an empty SequentialModule"
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = label_shapes

        feed = data_shapes
        needs_label = False
        for i, (m, meta) in enumerate(zip(self._modules, self._metas)):
            if meta.get(self.META_TAKE_LABELS):
                lshapes = label_shapes
                needs_label = True
            else:
                lshapes = None
            if meta.get(self.META_AUTO_WIRING):
                names = m.data_names
                assert len(names) == len(feed)
                feed = [(new, shape) for new, (_, shape)
                        in zip(names, feed)]
            m.bind(data_shapes=feed, label_shapes=lshapes,
                   for_training=for_training,
                   inputs_need_grad=inputs_need_grad or
                   (for_training and i > 0),
                   force_rebind=force_rebind, grad_req=grad_req)
            feed = m.output_shapes
        if not needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    # ------------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = _ChainBatch(data_batch.data,
                            getattr(data_batch, "label", None),
                            getattr(data_batch, "pad", 0))
        for m in self._modules:
            m.forward(batch, is_train=is_train)
            batch = _ChainBatch(m.get_outputs(), batch.label, batch.pad)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i, m in reversed(list(enumerate(self._modules))):
            m.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = m.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._modules[0].get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized
        for m, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS):
                m.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        assert self.binded
        for m in self._modules:
            m.install_monitor(mon)
