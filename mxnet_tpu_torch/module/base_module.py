"""BaseModule: the train/eval/predict driver (parity:
mxnet_tpu/module/base_module.py; python/mxnet/module/base_module.py, the
``fit`` loop at :409).  ``fit`` does the set-up and per-epoch
bookkeeping, ``_fit_epoch`` one pass over the iterator.  This layer is
host-side orchestration: the subclasses run compiled executors.

``fit`` reports as the JAX package's does: ``Module.fit.epoch`` and
``Module.fit.batch`` spans, the ``TRAIN_*`` and ``HOST_GAP_SECONDS``
series under ``loop="module"``, ``TRAIN_EPOCHS``, and a flight-recorder
bundle (``tracing.record_crash``) when it raises.  The JAX package's
``checkpoint_manager`` (auto-resume, preemption flush) is not ported.
"""
from __future__ import annotations

import logging
import time

import numpy as np

from .. import checkpoint as _ckpt
from .. import metric as _metric
from .. import telemetry as _telemetry
from .. import tracing as _tracing
from .. import ndarray
from ..context import cpu

__all__ = ["BaseModule", "_check_input_names", "_as_list"]


def _as_list(obj):
    return obj if isinstance(obj, list) else [obj]


def _fire(callbacks, arg):
    """Invoke one callback or a list of them with ``arg``."""
    if callbacks is None:
        return
    for cb in _as_list(callbacks):
        cb(arg)


def _coerce_metric(m):
    return m if isinstance(m, _metric.EvalMetric) else _metric.create(m)


def _check_input_names(symbol, names, typename, throw):
    """Warn or raise when a declared input name is absent from the symbol."""
    known = symbol.list_arguments()
    for name in names:
        if name not in known:
            msg = ("You created Module with Module(..., %s_names=%s) but "
                   "input with name '%s' is not found in "
                   "symbol.list_arguments()." % (typename, str(names), name))
            if throw:
                raise ValueError(msg)
            logging.warning(msg)


class BatchEndParam:
    """Namespace handed to batch-end callbacks."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class BaseModule:
    """Abstract base for every Module flavour.

    Subclasses provide bind/init/forward/backward/update; this class
    provides everything built from those primitives (fit, score, predict).
    """

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0

    def _require(self, *, params=True):
        assert self.binded, "call bind() first"
        if params:
            assert self.params_initialized, "call init_params() first"

    def _metric_labels(self, batch):
        """Labels for update_metric, handling pre-sliced list batches."""
        if isinstance(batch, list):
            return [b.label for b in batch], True
        return batch.label, False

    # ------------------------------------------------------------------
    # Composite operations
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Evaluate on ``eval_data``; returns metric name/value pairs."""
        self._require()
        if reset:
            eval_data.reset()
        eval_metric = _coerce_metric(eval_metric)
        eval_metric.reset()

        nbatch = -1
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                nbatch -= 1
                break
            self.forward(batch, is_train=False)
            labels, sliced = self._metric_labels(batch)
            self.update_metric(eval_metric, labels, pre_sliced=sliced)
            _fire(batch_end_callback,
                  BatchEndParam(epoch=epoch, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals()))
        _fire(score_end_callback,
              BatchEndParam(epoch=epoch, nbatch=nbatch + 1,
                            eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def _unpadded_outputs(self, batch, copy=False):
        """Forward outputs with the iterator's pad rows stripped."""
        keep = lambda o: o[0:o.shape[0] - batch.pad]
        outs = [keep(o) for o in self.get_outputs()]
        return [o.copy() for o in outs] if copy else outs

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        self._require()
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            yield (self._unpadded_outputs(batch), nbatch, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """Run inference over the iterator; concatenate batches by default."""
        self._require()
        if reset:
            eval_data.reset()
        collected = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            collected.append(self._unpadded_outputs(batch, copy=True))
        if not collected:
            return collected
        if not merge_batches:
            return collected
        width = len(collected[0])
        if any(len(outs) != width for outs in collected):
            raise ValueError("Cannot merge batches: output arity varies "
                             "across mini-batches (bucketing?)")
        merged = [ndarray.concatenate([outs[i] for outs in collected])
                  for i in range(width)]
        if width == 1 and not always_output_list:
            return merged[0]
        return merged

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _fit_epoch(self, train_data, epoch, eval_metric, batch_end_callback,
                   monitor, sparse_row_id_fn, on_nonfinite="off"):
        """One pass over ``train_data``; returns final metric pairs.

        The next batch is pulled only AFTER forward_backward/update on the
        current one — iterators are allowed to recycle their batch buffer
        once next() is called (the reference C++-iterator contract).

        ``on_nonfinite`` guards each step: under ``"skip"`` a batch whose
        outputs contain NaN/Inf is discarded BEFORE update() so params
        and optimizer state keep their previous values; ``"warn"``
        reports and proceeds, ``"raise"`` aborts.
        """
        final_pairs = []
        it = iter(train_data)
        try:
            batch = next(it)
        except StopIteration:
            return final_pairs
        nbatch = 0
        tel = _telemetry.enabled()
        tr_on = _tracing.enabled()
        prev_dispatch_end = None
        while batch is not None:
            sp = _tracing.begin("Module.fit.batch",
                                args={"epoch": epoch, "batch": nbatch}) \
                if tr_on else None
            t_batch0 = time.perf_counter() if tel else None
            if tel and prev_dispatch_end is not None:
                # dispatch-to-dispatch idle: host time this loop spent
                # outside forward/backward/update
                _telemetry.HOST_GAP_SECONDS.observe(
                    max(0.0, t_batch0 - prev_dispatch_end), loop="module")
            if monitor is not None:
                monitor.tic()
            self.forward_backward(batch)
            apply_update = True
            if on_nonfinite != "off":
                # one boolean reduced on the device when the subclass
                # offers it (Module), instead of every output on the host
                fin = getattr(self, "_outputs_finite", None)
                if fin is not None:
                    probe = np.float32(0.0 if fin() else np.nan)
                else:
                    probe = [o.asnumpy() for o in self.get_outputs()]
                apply_update = _ckpt.check_finite(
                    probe, on_nonfinite,
                    what="outputs (epoch %d batch %d)" % (epoch, nbatch),
                    logger=self.logger)
            if apply_update:
                self.update()
            else:
                _telemetry.TRAIN_SKIPPED_STEPS.inc(loop="module")
            if tel:
                prev_dispatch_end = time.perf_counter()
            try:
                upcoming = next(it)
                self.prepare(upcoming, sparse_row_id_fn=sparse_row_id_fn)
            except StopIteration:
                upcoming = None
            labels, sliced = self._metric_labels(batch)
            self.update_metric(eval_metric, labels, pre_sliced=sliced)
            if monitor is not None:
                monitor.toc_print()
            if upcoming is None:
                final_pairs = eval_metric.get_name_value()
            _fire(batch_end_callback,
                  BatchEndParam(epoch=epoch, nbatch=nbatch,
                                eval_metric=eval_metric, locals=locals()))
            if sp is not None:
                sp.end()
            if tel:
                dt = time.perf_counter() - t_batch0
                _telemetry.TRAIN_STEP_SECONDS.observe(dt, loop="module")
                _telemetry.TRAIN_STEPS.inc(loop="module")
                data = getattr(batch, "data", None)
                if data and dt > 0:
                    shp = getattr(data[0], "shape", None)
                    if shp:
                        _telemetry.TRAIN_SAMPLES_PER_SEC.set(
                            int(shp[0]) / dt)
            batch = upcoming
            nbatch += 1
        return final_pairs

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None, on_nonfinite=None):
        """Train over ``train_data`` for ``num_epoch`` epochs (parity:
        base_module.py:409 — same knobs, callback firing points and
        logging).  ``on_nonfinite``: the NaN/Inf step-guard policy
        (off/warn/skip/raise; None = MXNET_NONFINITE_POLICY)."""
        assert num_epoch is not None, "please specify number of epochs"
        on_nonfinite = _ckpt.nonfinite_policy(on_nonfinite)
        if initializer is None:
            from .. import initializer as _init
            initializer = _init.Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        eval_metric = _coerce_metric(eval_metric)
        if validation_metric is None:
            validation_metric = eval_metric

        outer_span = _tracing.current_span()
        try:
            for epoch in range(begin_epoch, num_epoch):
                start = time.time()
                sp = _tracing.begin("Module.fit.epoch",
                                    args={"epoch": epoch}) \
                    if _tracing.enabled() else None
                eval_metric.reset()
                train_pairs = self._fit_epoch(
                    train_data, epoch, eval_metric, batch_end_callback,
                    monitor, sparse_row_id_fn, on_nonfinite=on_nonfinite)
                for name, val in train_pairs:
                    self.logger.info("Epoch[%d] Train-%s=%f", epoch, name,
                                     val)
                self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                                 time.time() - start)
                _telemetry.TRAIN_EPOCHS.inc()

                arg_params, aux_params = self.get_params()
                self.set_params(arg_params, aux_params)
                if epoch_end_callback is not None:
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_params, aux_params)

                if eval_data is not None:
                    pairs = self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch)
                    for name, val in pairs:
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                train_data.reset()
                if sp is not None:
                    sp.end()
        except Exception as e:
            # postmortem bundle for a crashed fit (a no-op unless the
            # flight recorder is armed), taken before the unwind so the
            # failing step's epoch and batch spans are still open in it
            _tracing.record_crash("exception-fit", e,
                                  extra={"layer": "Module.fit"})
            # then close the orphaned spans: a dead span left as the
            # contextvar parent would corrupt the parentage of every
            # span recorded after a caught-and-retried fit
            _tracing.unwind_to(outer_span)
            raise

    # ------------------------------------------------------------------
    # Parameter persistence
    # ------------------------------------------------------------------
    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        blob = {"arg:" + k: v.as_in_context(cpu())
                for k, v in arg_params.items()}
        blob.update({"aux:" + k: v.as_in_context(cpu())
                     for k, v in aux_params.items()})
        ndarray.save(fname, blob)

    def load_params(self, fname):
        arg_params, aux_params = {}, {}
        for key, value in ndarray.load(fname, ctx=cpu()).items():
            kind, _, name = key.partition(":")
            if kind == "arg":
                arg_params[name] = value
            elif kind == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # ------------------------------------------------------------------
    # Interface for subclasses
    # ------------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError("data_names: subclass responsibility")

    @property
    def output_names(self):
        raise NotImplementedError("output_names: subclass responsibility")

    @property
    def data_shapes(self):
        raise NotImplementedError("data_shapes: subclass responsibility")

    @property
    def label_shapes(self):
        raise NotImplementedError("label_shapes: subclass responsibility")

    @property
    def output_shapes(self):
        raise NotImplementedError("output_shapes: subclass responsibility")

    def get_params(self):
        raise NotImplementedError("get_params: subclass responsibility")

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError("init_params: subclass responsibility")

    def install_monitor(self, mon):
        raise NotImplementedError("install_monitor: subclass responsibility")

    def prepare(self, data_batch, sparse_row_id_fn=None):
        pass

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError("forward: subclass responsibility")

    def backward(self, out_grads=None):
        raise NotImplementedError("backward: subclass responsibility")

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError("get_outputs: subclass responsibility")

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError("get_input_grads: subclass responsibility")

    def update(self):
        raise NotImplementedError("update: subclass responsibility")

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError("update_metric: subclass responsibility")

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError("bind: subclass responsibility")

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError("init_optimizer: subclass responsibility")
