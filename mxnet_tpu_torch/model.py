"""Legacy model API: checkpointing + FeedForward (parity:
mxnet_tpu/model.py; python/mxnet/model.py — save_checkpoint:394 and
load_checkpoint:424 write and read ``prefix-symbol.json`` and
``prefix-%04d.params``; a pair either package writes loads in the
other)."""
from __future__ import annotations

import logging

from . import ndarray
from . import symbol as sym
from .context import cpu

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward",
           "BatchEndParam"]

from .module.base_module import BatchEndParam  # noqa: E402


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Checkpoint = symbol json + params blob (parity: model.py:394).
    The symbol file is written atomically (``checkpoint.atomic_write``)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    ndarray.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """Parity: model.py:424."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = ndarray.load("%s-%04d.params" % (prefix, epoch), ctx=cpu())
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


class FeedForward:
    """Deprecated-but-present legacy API (parity: model.py FeedForward).
    Thin adapter over Module."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from . import initializer as init_mod

        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _make_module(self, data, label_name="softmax_label"):
        from .module import Module

        data_names = [d.name for d in data.provide_data]
        label_names = [l.name for l in (data.provide_label or [])]
        mod = Module(self.symbol, data_names=data_names,
                     label_names=label_names or None, context=self.ctx)
        return mod

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            on_nonfinite=None):
        self._module = self._make_module(X)
        self._module.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, optimizer=self.optimizer,
                         optimizer_params=self.kwargs or (
                             ("learning_rate", 0.01),),
                         initializer=self.initializer,
                         arg_params=self.arg_params,
                         aux_params=self.aux_params,
                         allow_missing=True, num_epoch=self.num_epoch,
                         begin_epoch=self.begin_epoch, monitor=monitor,
                         on_nonfinite=on_nonfinite)
        self.arg_params, self.aux_params = self._module.get_params()

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        assert self._module is not None or self.arg_params is not None
        if self._module is None:
            self._module = self._make_module(X)
            self._module.bind(data_shapes=X.provide_data,
                              label_shapes=X.provide_label,
                              for_training=False)
            self._module.set_params(self.arg_params, self.aux_params or {})
        return self._module.predict(X, num_batch=num_batch, reset=reset)

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)
