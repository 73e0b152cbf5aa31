"""TensorBoard metric logging callback (parity:
mxnet_tpu/contrib/tensorboard.py, python/mxnet/contrib/tensorboard.py
LogMetricsCallback).

A real SummaryWriter when a tensorboard package is importable
(tensorboardX first, then ``torch.utils.tensorboard``, as the JAX
package tries them); otherwise an append-only JSONL scalar log,
``scalars.jsonl`` in the same directory, one row an ``add_scalar``.
"""
from __future__ import annotations

import json
import os
import time

__all__ = ["LogMetricsCallback"]


class _JsonlWriter:
    """Fallback scalar writer: one JSON object an add_scalar call."""

    def __init__(self, logging_dir):
        os.makedirs(logging_dir, exist_ok=True)
        self._path = os.path.join(logging_dir, "scalars.jsonl")

    def add_scalar(self, tag, value, global_step=None):
        with open(self._path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value),
                                "step": global_step,
                                "wall_time": time.time()}) + "\n")

    def flush(self):
        pass


def _make_writer(logging_dir):
    for mod, cls in (("tensorboardX", "SummaryWriter"),
                     ("torch.utils.tensorboard", "SummaryWriter")):
        try:
            m = __import__(mod, fromlist=[cls])
            if hasattr(m, cls):
                return getattr(m, cls)(logging_dir)
        except Exception:
            continue
    return _JsonlWriter(logging_dir)


class LogMetricsCallback:
    """Batch-end callback streaming eval metrics to TensorBoard (or the
    JSONL fallback)."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = _make_writer(logging_dir)

    def __call__(self, param):
        self.step += 1
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = "%s-%s" % (self.prefix, name)
            self.summary_writer.add_scalar(name, value,
                                           global_step=self.step)
