"""Training callbacks.

Parity: mxnet_tpu/callback.py, the reference's ``python/mxnet/callback.py`` (Speedometer,
do_checkpoint, module_checkpoint, log_train_metric, ProgressBar). Organised
around two small pieces: an epoch-periodic checkpoint factory and a
throughput clock that the batch callbacks share.
"""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric", "ProgressBar",
           "module_checkpoint"]


def _every_n_epochs(period, action):
    """Return an epoch-end callback firing ``action(epoch_1based)``."""
    period = max(1, int(period))

    def _cb(iter_no, sym=None, arg=None, aux=None):
        epoch = iter_no + 1
        if epoch % period == 0:
            action(epoch, sym, arg, aux)

    return _cb


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving a Module checkpoint every ``period`` epochs."""
    return _every_n_epochs(
        period,
        lambda epoch, *_: mod.save_checkpoint(prefix, epoch,
                                              save_optimizer_states))


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving symbol + params every ``period`` epochs."""
    from .model import save_checkpoint

    return _every_n_epochs(
        period,
        lambda epoch, sym, arg, aux: save_checkpoint(prefix, epoch, sym,
                                                     arg, aux))


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the live training metric every ``period``."""

    def _cb(param):
        metric = param.eval_metric
        if metric is None or param.nbatch % period != 0:
            return
        for name, value in metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            metric.reset()

    return _cb


class _Throughput:
    """Wall-clock sample/sec counter reset on epoch wrap."""

    def __init__(self, batch_size):
        self._bs = batch_size
        self._t0 = None
        self._seen = 0

    def update(self, nbatch):
        """Advance to batch ``nbatch``; return samples/sec or None if warming."""
        now = time.time()
        if nbatch < self._seen or self._t0 is None:   # new epoch / first call
            self._t0, self._seen = now, nbatch
            return None
        elapsed = now - self._t0
        done = nbatch - self._seen
        self._t0, self._seen = now, nbatch
        if elapsed <= 0:
            return float("inf")
        return done * self._bs / elapsed


class Speedometer:
    """Logs samples/sec (and optionally metrics) every ``frequent`` batches."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._clock = _Throughput(batch_size)
        self._primed = False

    def __call__(self, param):
        n = param.nbatch
        if not self._primed or n == 0:
            self._clock.update(n)
            self._primed = True
            return
        if n % self.frequent != 0:
            return
        speed = self._clock.update(n)
        if speed is None:
            return
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            text = "".join("\t%s=%f" % kv for kv in pairs)
            logging.info("Epoch[%d] Batch [%d-%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, n - self.frequent, n, speed, text)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, n, speed)


class ProgressBar:
    """Text progress bar over a known total number of batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        ticks = int(round(self.bar_len * frac))
        bar = "=" * ticks + "-" * (self.bar_len - ticks)
        logging.info("[%s] %s%%\r", bar, int(round(100.0 * frac)))
