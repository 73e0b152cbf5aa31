"""KVStore 'local'/'device'/'nccl' and 'dist*' (parity: mxnet_tpu/kvstore.py
KVStore and KVStoreDist; reference include/mxnet/kvstore.h,
src/kvstore/kvstore_local.h, kvstore_dist.h, python/mxnet/kvstore.py).

Single process: ``push`` reduces the list of per-worker values for a key
(after 2-bit compression, when set, with one error-feedback residual per
key and worker), then either runs the updater on the stored value or,
without one, ASSIGNS the merged value to it, as the reference's
KVStoreLocal does (``local = merged``).  With compression, a push of a
list compresses every (key, worker) entry of the list in one batched call
(one launch of each kernel on the card), split only where a key repeats,
so that its second occurrence sees the residual the first one left.
``pull`` copies the stored value into each output.

``dist*`` with ``DMLC_PS_ROOT_URI`` set is ``KVStoreDist``, a worker of the
parameter server in ``kvstore_server.py``; without it, a single-process
store of that type.  ``KVStoreDist.push`` sends a push list as one message
(the values reduced per key, compressed first when set, in one batched
call) after one device-to-host copy of the whole list; the wire carries
the dequantized f32 values, as the JAX package's does.  ``pull`` writes
the server's values into each output in place, so parameters keep their
device and storage.  Rank 0 sends the initial values and every worker
waits at a barrier, as upstream's ``InitImpl``; the ``Trainer`` and
``Module`` then pull them, so every worker starts from rank 0's weights.

Row-sparse values (parity: mxnet_tpu/kvstore.py:37-56, :110-131):
a push of a list of ``RowSparseNDArray``s sums them with ``add_rsp_rsp``
and hands the row-sparse sum to the updater (SGD's lazy update reads and
writes only its rows); without an updater its rows are added into the
stored value.  A list that mixes storage types is pushed dense.
``row_sparse_pull`` into a ``RowSparseNDArray`` gathers only the
requested rows (deduplicated, ascending) of the stored value on its
device; a dense ``out`` gets the stored value with every other row zero.
``KVStoreDist`` densifies a row-sparse push before the wire and serves
``row_sparse_pull`` from the pulled value, as the JAX store does.
"""
from __future__ import annotations

import io
import os
import pickle

import numpy as np
import torch

from .base import MXNetError
from .checkpoint import atomic_write
from .ndarray.ndarray import NDArray
from .ndarray.sparse import (BaseSparseNDArray, RowSparseNDArray,
                             add_rsp_rsp)
from . import optimizer as opt

__all__ = ["KVStore", "KVStoreDist", "create"]


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


def _row_sparse(vlist):
    return all(isinstance(v, RowSparseNDArray) for v in vlist)


def _dense(vlist):
    """The list with its sparse values cast to dense storage."""
    return [v.tostype("default") if isinstance(v, BaseSparseNDArray) else v
            for v in vlist]


def _rsp_pull_into(out, row_ids, src):
    """Write the rows ``row_ids`` of the stored value ``src`` (a tensor)
    into ``out``: as components of a ``RowSparseNDArray`` (a gather of
    the unique rows on ``src``'s device), or into a dense ``out`` with
    every other row zero."""
    if isinstance(out, RowSparseNDArray):
        rows = torch.unique(row_ids._data.reshape(-1).to(src.device,
                                                          torch.int64))
        device = out._device()
        out._assign_rows(NDArray(src[rows].to(device)),
                         NDArray(rows.to(device)), src.shape)
        return
    with torch.no_grad():
        out._data.copy_(_row_masked(src, row_ids))


def _row_masked(value, row_ids):
    """``value`` with every row outside ``row_ids`` zeroed (by a 0/1
    multiply, as the JAX package's ``_rsp_pull_into``)."""
    rows = torch.unique(row_ids._data.reshape(-1).to(torch.int64).cpu())
    mask = torch.zeros(value.shape[0], dtype=value.dtype)
    mask[rows] = 1
    return value * mask.to(value.device).reshape(
        (-1,) + (1,) * (value.dim() - 1))


def _to_host(arrays):
    """numpy copies of NDArrays: one device-to-host copy of them all where
    they lie on one card in one dtype."""
    ts = [a._data.detach() for a in arrays]
    if not ts or not ts[0].is_cuda or any(
            t.device != ts[0].device or t.dtype != ts[0].dtype for t in ts):
        return [t.cpu().numpy() for t in ts]
    flat = torch.cat([t.reshape(-1) for t in ts]).cpu().numpy()
    out, off = [], 0
    for t in ts:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def _write(outs, vals):
    """Each output of each key gets its key's value (numpy), in place."""
    with torch.no_grad():
        for val, olist in zip(vals, outs):
            src = torch.from_numpy(np.ascontiguousarray(val))
            for o in olist:
                o._data.copy_(src.reshape(o._data.shape))


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
            rsp_keys = {keys[i] for i in run if _row_sparse(vals[i])}
            for i in run:
                if keys[i] in rsp_keys:
                    self._push_row_sparse(keys[i], vals[i])
            run = [i for i in run if keys[i] not in rsp_keys]
            run_keys = [keys[i] for i in run]
            run_vals = [_dense(vals[i]) for i in run]
            if self._gc is not None:
                run_vals = self._compress(run_keys, run_vals)
            for k, vlist in zip(run_keys, run_vals):
                agg = self._reduce(vlist, fresh=self._gc is not None)
                if self._updater is not None:
                    self._updater(int(k) if k.isdigit() else k, agg,
                                  self._store[k])
                else:
                    self._store[k] = agg

    def _push_row_sparse(self, k, vlist):
        agg = vlist[0]
        for v in vlist[1:]:
            agg = add_rsp_rsp(agg, v)
        if self._updater is not None:
            self._updater(int(k) if k.isdigit() else k, agg, self._store[k])
            return
        st = self._store[k]._data
        with torch.no_grad():
            st.index_add_(0, agg.indices._data.to(st.device),
                          agg.data._data.to(st.device, st.dtype))

    def _value(self, k):
        if k not in self._store:
            raise MXNetError("key %s not initialized" % k)
        return self._store[k]._data

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _key_value_lists(key, out)
        for k, olist in zip(keys, outs):
            src = self._value(str(k))
            for o in olist:
                with torch.no_grad():
                    o._data.copy_(src)

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out=out, priority=priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows in ``row_ids`` (parity: kvstore.py:155): a
        ``RowSparseNDArray`` out receives them as its components, a dense
        ``out`` the stored value with every other row zero."""
        keys, outs = _key_value_lists(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(outs[0])
        for k, olist in zip(keys, outs):
            src = self._value(str(k))
            for o, rid in zip(olist, row_ids):
                _rsp_pull_into(o, rid, src)

    def barrier(self):
        pass

    def send_command_to_servers(self, head, body):
        pass

    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

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


class _HostPickler(pickle.Pickler):
    """Refuses a tensor off the CPU: the server would need the card."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise MXNetError("the optimizer holds a tensor on %s; the "
                             "parameter server runs on the host" % obj.device)
        return NotImplemented


class KVStoreDist(KVStore):
    """A worker of the parameter server (parity: mxnet_tpu/kvstore.py
    KVStoreDist; reference kvstore_dist.h).  ``client`` is a connected
    ``kvstore_server.WorkerClient``; by default one from the DMLC_*
    variables.  A worker process holds one such store: the server takes
    NumWorkers connections."""

    def __init__(self, kv_type, client=None):
        super().__init__(kv_type)
        from .kvstore_server import WorkerClient

        self._sync = "async" not in kv_type
        self._client = client if client is not None \
            else WorkerClient.from_env()

    @property
    def rank(self):
        return self._client.rank

    @property
    def num_workers(self):
        return self._client.num_workers

    def init(self, key, value):
        keys, vals = _key_value_lists(key, value)
        if self.rank == 0:
            for k, v in zip(keys, _to_host([vl[0] for vl in vals])):
                self._client.init(str(k), v)
        self._client.barrier()

    def push(self, key, value, priority=0):
        keys, vals = _key_value_lists(key, value)
        keys = [str(k) for k in keys]
        vals = [_dense(vl) for vl in vals]
        aggs = []
        for run in _runs(keys):
            run_vals = [vals[i] for i in run]
            if self._gc is not None:
                run_vals = self._compress([keys[i] for i in run], run_vals)
            aggs += [vl[0] if len(vl) == 1
                     else self._reduce(vl, fresh=self._gc is not None)
                     for vl in run_vals]
        items = list(zip(keys, _to_host(aggs)))
        if len(items) == 1:
            self._client.push(items[0][0], items[0][1], sync=self._sync)
        else:
            self._client.push_batch(items, sync=self._sync)

    def _value(self, k):
        return torch.from_numpy(np.ascontiguousarray(self._client.pull(k)))

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _key_value_lists(key, out)
        keys = [str(k) for k in keys]
        vals = [self._client.pull(keys[0])] if len(keys) == 1 \
            else self._client.pull_batch(keys)
        _write(outs, vals)

    def set_optimizer(self, optimizer):
        """Send the optimizer to the server, which runs it on every sum
        (``Optimizer.__getstate__`` leaves the Trainer's parameters out)."""
        buf = io.BytesIO()
        _HostPickler(buf, protocol=4).dump(optimizer)
        self._client.set_optimizer(buf.getvalue())
        self._optimizer = optimizer

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise MXNetError("the optimizer states of a dist kvstore live on "
                         "the parameter server")

    def load_optimizer_states(self, fname):
        raise MXNetError("the optimizer states of a dist kvstore live on "
                         "the parameter server")

    def barrier(self):
        self._client.barrier()

    def send_command_to_servers(self, head, body):
        self._client.command(head, body)

    def close(self):
        """End this worker cleanly: a barrier, then rank 0 stops the
        server (upstream's kStopServer at exit)."""
        self._client.barrier()
        if self.rank == 0:
            self._client.shutdown()
        self._client.close()


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
        return KVStoreDist(name)
    raise MXNetError("unknown kvstore type %r" % name)
