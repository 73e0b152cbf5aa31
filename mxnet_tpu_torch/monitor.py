"""Monitor: per-layer stat hooks (parity: mxnet_tpu/monitor.py:185-253;
python/mxnet/monitor.py:33 and the executor monitor callback of
src/executor/graph_executor.cc:105).  A predicate (name filter), a
collector (the callback executors call with each output) and a drain
(``toc``) that renders the stats; the weights are sampled again at
every drain.  The JAX package's telemetry heartbeat is not ported."""
from __future__ import annotations

import logging
import re

from .ndarray.ndarray import NDArray

__all__ = ["Monitor"]


def _default_stat(x):
    """|x|₂ / sqrt(n) — the reference's asum-style magnitude stat."""
    return x.norm() / (x.size ** 0.5)


def _render(value):
    """Stat value(s) -> tab-joined display string."""
    values = value if isinstance(value, list) else [value]
    parts = []
    for v in values:
        if not isinstance(v, NDArray):
            raise TypeError("stat_func must return NDArray(s), got %r"
                            % type(v))
        scalarish = v.shape in ((), (1,))
        parts.append(str(v.asscalar() if scalarish else v.asnumpy()))
    return "\t".join(parts) + "\t"


class Monitor:
    """Samples a statistic of matching tensors every `interval` steps.

    Usage parity with the reference: ``install`` on executors (Module
    does this via ``install_monitor``), call ``tic()`` before each
    forward and ``toc_print()`` after.
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 monitor_all=False):
        self.interval = interval
        self.stat_func = stat_func or _default_stat
        self.sort = sort
        self.monitor_all = monitor_all
        self._match = re.compile(pattern).match
        self._collecting = False
        self._records = []          # (step, name, stat)
        self._step = 0
        self._executors = []

    # executors call this with every intermediate (name, array)
    def stat_helper(self, name, value):
        if self._collecting and self._match(str(name)):
            self._records.append((self._step, str(name),
                                  self.stat_func(value)))

    def install(self, exe):
        exe.set_monitor_callback(self.stat_helper, self.monitor_all)
        self._executors.append(exe)

    @property
    def activated(self):
        return self._collecting

    def _sync_params(self):
        for exe in self._executors:
            for arr in exe.arg_arrays:
                arr.wait_to_read()

    def tic(self):
        """Arm collection if this step is on the interval."""
        if self._step % self.interval == 0:
            self._sync_params()
            self._records = []
            self._collecting = True
        self._step += 1

    def toc(self):
        """Disarm and return [(step, name, rendered stat)] collected
        since tic, plus a fresh stat of every matching parameter."""
        if not self._collecting:
            return []
        self._sync_params()
        for exe in self._executors:
            for name, arr in zip(exe._arg_names, exe.arg_arrays):
                if self._match(name):
                    self._records.append((self._step, name,
                                          self.stat_func(arr)))
        self._collecting = False
        if self.sort:
            self._records.sort(key=lambda r: r[1])
        out = [(step, name, _render(stat))
               for step, name, stat in self._records]
        self._records = []
        return out

    def toc_print(self):
        for step, name, rendered in self.toc():
            logging.info("Batch: %7d %-30s %s", step, name, rendered)
