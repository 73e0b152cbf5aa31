"""PythonModule / PythonLossModule: modules implemented in Python.

Parity: mxnet_tpu/module/python_module.py, ``python/mxnet/module/python_module.py`` — a
convenience base that stubs the Module interface for parameterless
Python computations, and a loss head whose backward is a user-supplied
``grad_func(scores, labels)``.
"""
from __future__ import annotations

import logging

from .. import ndarray as nd
from ..ndarray.ndarray import NDArray
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclass and override ``forward``/``backward`` (and
    ``_compute_output_shapes``) to run arbitrary Python per batch; all
    parameter/optimizer plumbing defaults to no-ops."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # -- bookkeeping ----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    # -- params (none by default) ---------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        if self._label_shapes is None:
            return
        if pre_sliced:
            raise RuntimeError("PythonModule does not support pre-sliced "
                               "labels")
        eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert grad_req == "write", "Python module only supports write"
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """Loss head: forward stores scores/labels; backward produces the
    score gradient from ``grad_func(scores, labels)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        assert len(data_names) == 1 and len(label_names) == 1
        self._name = name
        self._pred = None
        self._target = None
        self._pred_grad = None
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_fn = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._pred = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train:
            self._target = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._pred]

    def backward(self, out_grads=None):
        assert out_grads is None, "For a loss module, out_grads should " \
            "be None"
        assert self.for_training
        if self._grad_fn is None:
            raise NotImplementedError(
                "provide grad_func or override _backward_impl")
        grad = self._grad_fn(self._pred, self._target)
        if not isinstance(grad, NDArray):
            grad = nd.array(grad, ctx=self._pred.context)
        self._pred_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        assert merge_multi_context
        return [self._pred_grad]
