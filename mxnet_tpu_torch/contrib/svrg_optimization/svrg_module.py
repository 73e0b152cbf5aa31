"""SVRG optimization module (parity:
mxnet_tpu/contrib/svrg_optimization/svrg_module.py;
python/mxnet/contrib/svrg_optimization/svrg_module.py).

As the JAX package does, one Module keeps a parameter snapshot and the
full-gradient table and applies the SVRG-corrected gradient

    g_i(w) - g_i(w_snapshot) + mu        (mu = full gradient at snapshot)

before the optimizer step.  The gradient sums and ``mu`` lie where the
executor's gradients do (the card unless the Module was bound on the
host).
"""
from __future__ import annotations

import logging

from ... import metric as _metric
from ...module.module import Module
from ...ndarray.ndarray import NDArray

__all__ = ["SVRGModule"]


class SVRGModule(Module):
    """Module with SVRG variance-reduced updates.

    Every ``update_freq`` epochs, ``update_full_grads`` walks the whole
    training set at the current weights to record the weight snapshot
    and the full-batch gradient ``mu``; later steps correct each
    minibatch gradient with the snapshot gradient of the same batch.
    """

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None, update_freq=2):
        super().__init__(symbol, data_names=data_names,
                         label_names=label_names, logger=logger,
                         context=context, work_load_list=work_load_list,
                         fixed_param_names=fixed_param_names,
                         state_names=state_names, group2ctxs=group2ctxs,
                         compression_params=compression_params)
        if not isinstance(update_freq, int) or update_freq < 1:
            raise ValueError("update_freq must be a positive integer")
        if len(self._context) > 1:
            raise NotImplementedError(
                "SVRGModule supports a single context")
        self.update_freq = update_freq
        self._snapshot = None          # name -> NDArray (weights at mu)
        self._mu = None                # name -> NDArray (full gradient)

    # ------------------------------------------------------------------
    def update_full_grads(self, train_data):
        """Snapshot the weights and sum the full-dataset gradient at that
        snapshot (reference svrg_module.py:292)."""
        self._require()
        arg_params, aux_params = self.get_params()
        self._snapshot = {k: v.copy() for k, v in arg_params.items()}
        saved_aux = {k: v.copy() for k, v in aux_params.items()}
        sums = {}
        train_data.reset()
        nbatch = 0
        for batch in train_data:
            self.forward(batch, is_train=True)
            self.backward()
            for _i, name, grads, _args in self._grad_walk():
                g = grads[0]._data
                sums[name] = g.clone() if name not in sums \
                    else sums[name] + g
            nbatch += 1
        train_data.reset()
        # the statistics pass must not disturb aux state (BN moving
        # mean/var): restore what the extra training forwards changed
        self.set_params(arg_params, saved_aux)
        if nbatch == 0:
            raise ValueError("train_data yielded no batches")
        self._mu = {k: NDArray(v / nbatch) for k, v in sums.items()}

    def _snapshot_batch_grads(self, data_batch):
        """Gradients of the current batch at the snapshot weights."""
        arg_params, aux_params = self.get_params()
        live = {k: v.copy() for k, v in arg_params.items()}
        live_aux = {k: v.copy() for k, v in aux_params.items()}
        self.set_params(self._snapshot, aux_params)
        self.forward(data_batch, is_train=True)
        self.backward()
        snap_grads = {name: grads[0].copy()
                      for _i, name, grads, _a in self._grad_walk()}
        self.set_params(live, live_aux)
        return snap_grads

    def forward_backward(self, data_batch):
        """Forward and backward, then the SVRG correction in place once a
        snapshot exists."""
        snap_grads = self._snapshot_batch_grads(data_batch) \
            if self._mu is not None else None
        self.forward(data_batch, is_train=True)
        self.backward()
        if snap_grads is not None:
            for _i, name, grads, _a in self._grad_walk():
                corrected = (grads[0]._data - snap_grads[name]._data
                             + self._mu[name]._data)
                grads[0]._rebind(corrected)

    # ------------------------------------------------------------------
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """Module.fit with a full-gradient refresh every ``update_freq``
        epochs (reference svrg_module.py:395)."""
        assert num_epoch is not None, "please specify number of epochs"
        if initializer is None:
            from ... import initializer as _init

            initializer = _init.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params,
                         allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        eval_metric = eval_metric if isinstance(
            eval_metric, _metric.EvalMetric) else _metric.create(
                eval_metric)
        validation_metric = validation_metric or eval_metric

        for epoch in range(begin_epoch, num_epoch):
            if epoch % self.update_freq == 0:
                self.update_full_grads(train_data)
            eval_metric.reset()
            self._fit_epoch(train_data, epoch, eval_metric,
                            batch_end_callback, monitor,
                            sparse_row_id_fn)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            arg_p, aux_p = self.get_params()
            self.set_params(arg_p, aux_p)
            if epoch_end_callback is not None:
                from ...module.base_module import _as_list

                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
