"""KVStore 'local'/'device'/'nccl' (parity: mxnet_tpu/kvstore.py KVStore;
reference include/mxnet/kvstore.h, src/kvstore/kvstore_local.h,
python/mxnet/kvstore.py).

Single process: ``push`` reduces the list of per-worker values for a key
(after 2-bit compression, when set, with one error-feedback residual per
key and worker), then either runs the updater on the stored value or,
without one, ASSIGNS the merged value to it, as the reference's
KVStoreLocal does (``local = merged``).  With compression, a push of a
list compresses every (key, worker) entry of the list in one batched call
(one launch of each kernel on the card), split only where a key repeats,
so that its second occurrence sees the residual the first one left.
``pull`` copies the stored value into each output.  The ``dist*`` types
run as a single-process store of that type unless ``DMLC_PS_ROOT_URI``
names a parameter server, which is not ported yet.
"""
from __future__ import annotations

import os

import torch

from .base import MXNetError
from .checkpoint import atomic_write
from . import optimizer as opt

__all__ = ["KVStore", "create"]


def _key_value_lists(keys, vals):
    if isinstance(keys, (str, int)):
        keys = [keys]
        vals = [vals]
    return list(keys), [v if isinstance(v, (list, tuple)) else [v]
                        for v in vals]


def _runs(keys):
    """Index runs of the push list in which no key repeats."""
    runs, seen = [[]], set()
    for i, k in enumerate(keys):
        if k in seen:
            runs.append([])
            seen = set()
        runs[-1].append(i)
        seen.add(k)
    return runs


class KVStore:
    """Single-process store ('local', 'device', 'nccl', ...; 'dist*' without
    a parameter server)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._gc = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        keys, vals = _key_value_lists(key, value)
        for k, vlist in zip(keys, vals):
            if str(k) not in self._store:
                self._store[str(k)] = vlist[0].copy()

    @staticmethod
    def _reduce(vlist, fresh):
        """Sum of the per-worker values in worker order.  A single value
        that is ``fresh`` (a dequantized view nothing else holds) is the
        sum itself; otherwise the sum goes to a new buffer."""
        if fresh and len(vlist) == 1:
            return vlist[0]
        out = vlist[0].copy()
        for v in vlist[1:]:
            out += v
        return out

    def _compress(self, keys, vals):
        """Per key, the dequantized values of its workers, all (key, worker)
        entries in one batched call."""
        entries = [((k, w), v) for k, vlist in zip(keys, vals)
                   for w, v in enumerate(vlist)]
        deq = iter(self._gc.compress_dequantize_batch(
            [e for e, _ in entries], [v for _, v in entries]))
        return [[next(deq) for _ in vlist] for vlist in vals]

    def push(self, key, value, priority=0):
        keys, vals = _key_value_lists(key, value)
        keys = [str(k) for k in keys]
        for k in keys:
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
        for run in _runs(keys):
            run_keys = [keys[i] for i in run]
            run_vals = [vals[i] for i in run]
            if self._gc is not None:
                run_vals = self._compress(run_keys, run_vals)
            for k, vlist in zip(run_keys, run_vals):
                agg = self._reduce(vlist, fresh=self._gc is not None)
                if self._updater is not None:
                    self._updater(int(k) if k.isdigit() else k, agg,
                                  self._store[k])
                else:
                    self._store[k] = agg

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _key_value_lists(key, out)
        for k, olist in zip(keys, outs):
            k = str(k)
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            src = self._store[k]._data
            for o in olist:
                with torch.no_grad():
                    o._data.copy_(src)

    def set_updater(self, updater):
        self._updater = updater

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self.set_updater(opt.get_updater(optimizer))

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the updater's states (parity: kvstore.py:199)."""
        if self._updater is None:
            raise MXNetError("there is no optimizer")
        atomic_write(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("there is no optimizer")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    def set_gradient_compression(self, compression_params):
        """Engage 2-bit compression (parity: kvstore.py:394): every later
        push quantizes each worker's gradient with its own residual and
        aggregates the dequantized values."""
        from .contrib.compression import GradientCompression

        self._gc = GradientCompression(**dict(compression_params))


def create(name="local"):
    """Factory (parity: mxnet_tpu/kvstore.py create; kvstore.cc:40-72)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device",
                "device", "nccl"):
        return KVStore(name)
    if name.startswith("dist"):
        if os.environ.get("DMLC_PS_ROOT_URI") is None:
            # no parameter server: a single-process store (one worker)
            return KVStore(name)
        raise MXNetError("kvstore type %r with a parameter server is not "
                         "ported yet" % name)
    raise MXNetError("unknown kvstore type %r" % name)
