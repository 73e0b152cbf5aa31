"""KVStore 'local'/'device' (parity: mxnet_tpu/kvstore.py KVStore;
reference include/mxnet/kvstore.h, src/kvstore/kvstore_local.h,
python/mxnet/kvstore.py).

Single process: ``push`` reduces the list of per-worker values for a key
(after 2-bit compression, when set, with one error-feedback residual per
key and worker), then either runs the updater on the stored value or,
without one, ASSIGNS the merged value to it, as the reference's
KVStoreLocal does (``local = merged``).  ``pull`` copies the stored value
into each output.  The distributed types are not ported yet.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from . import optimizer as opt

__all__ = ["KVStore", "create"]


def _key_value_lists(keys, vals):
    if isinstance(keys, (str, int)):
        keys = [keys]
        vals = [vals]
    return list(keys), [v if isinstance(v, (list, tuple)) else [v]
                        for v in vals]


class KVStore:
    """Single-process store ('local' / 'device')."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._gc = None

    @property
    def type(self):
        return self._type

    def init(self, key, value):
        keys, vals = _key_value_lists(key, value)
        for k, vlist in zip(keys, vals):
            if str(k) not in self._store:
                self._store[str(k)] = vlist[0].copy()

    @staticmethod
    def _reduce(vlist):
        """Sum of the per-worker values, in a fresh buffer."""
        out = vlist[0].copy()
        for v in vlist[1:]:
            out += v
        return out

    def _maybe_compress(self, k, vlist):
        if self._gc is None:
            return vlist
        return [self._gc.compress_dequantize((k, i), v)
                for i, v in enumerate(vlist)]

    def push(self, key, value, priority=0):
        keys, vals = _key_value_lists(key, value)
        for k, vlist in zip(keys, vals):
            k = str(k)
            if k not in self._store:
                raise MXNetError("key %s not initialized" % k)
            agg = self._reduce(self._maybe_compress(k, vlist))
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

    def set_gradient_compression(self, compression_params):
        """Engage 2-bit compression (parity: kvstore.py:394): every later
        push quantizes each worker's gradient with its own residual and
        aggregates the dequantized values."""
        from .contrib.compression import GradientCompression

        self._gc = GradientCompression(**dict(compression_params))


def create(name="local"):
    """Factory (parity: kvstore.cc:40-72)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "device"):
        return KVStore(name)
    if name.startswith("dist"):
        raise MXNetError("kvstore type %r is not ported yet" % name)
    raise MXNetError("unknown kvstore type %r" % name)
