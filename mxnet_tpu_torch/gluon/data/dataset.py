"""Datasets (parity: mxnet_tpu/gluon/data/dataset.py,
python/mxnet/gluon/data/dataset.py).

Decomposition: every derived dataset here is one of two views over a
base dataset — an *index view* (filter/shard/take remap positions) or
a *mapping view* (transform applies a function per item).  The
reference grows a class per operation; two view classes cover them all.
"""
from __future__ import annotations

import os
import threading

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "_DownloadedDataset"]


class Dataset:
    """Random-access collection: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError("Dataset subclasses define __getitem__")

    def __len__(self):
        raise NotImplementedError("Dataset subclasses define __len__")

    # ---- derived views -------------------------------------------------
    def filter(self, fn):
        keep = [i for i in range(len(self)) if fn(self[i])]
        return _IndexView(self, keep)

    def shard(self, num_shards, index):
        if not 0 <= index < num_shards:
            raise ValueError("shard index %d out of range (%d shards)"
                             % (index, num_shards))
        # same partition rule as the reference: the first `len % num`
        # shards get one extra element
        base, extra = divmod(len(self), num_shards)
        start = base * index + min(index, extra)
        stop = start + base + (1 if index < extra else 0)
        return _IndexView(self, range(start, stop))

    def take(self, count):
        n = len(self) if count is None else min(count, len(self))
        return _IndexView(self, range(n))

    def transform(self, fn, lazy=True):
        view = _MapView(self, fn)
        if lazy:
            return view
        return SimpleDataset([view[i] for i in range(len(view))])

    def transform_first(self, fn, lazy=True):
        def first_only(item, *rest):
            return (fn(item),) + rest if rest else fn(item)

        return self.transform(first_only, lazy)


class _IndexView(Dataset):
    """Positions remapped through an index sequence."""

    def __init__(self, base, indices):
        self._base = base
        self._indices = indices

    def __getitem__(self, idx):
        return self._base[self._indices[idx]]

    def __len__(self):
        return len(self._indices)


class _MapView(Dataset):
    """fn applied per item; tuple items splat into fn's arguments."""

    def __init__(self, base, fn):
        self._base = base
        self._fn = fn

    def __getitem__(self, idx):
        item = self._base[idx]
        return self._fn(*item) if isinstance(item, tuple) \
            else self._fn(item)

    def __len__(self):
        return len(self._base)


class SimpleDataset(Dataset):
    """Wrap any sequence."""

    def __init__(self, data):
        self._data = data

    def __getitem__(self, idx):
        return self._data[idx]

    def __len__(self):
        return len(self._data)


class ArrayDataset(Dataset):
    """Zip N equal-length arrays; items are tuples (or scalars for N=1)."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("ArrayDataset needs at least one array")
        lengths = [len(a) for a in arrays]
        if len(set(lengths)) != 1:
            raise ValueError("all arrays must share one length, got %s"
                             % lengths)
        self._columns = [a if isinstance(a, (list, tuple))
                         or hasattr(a, "shape") else list(a)
                         for a in arrays]
        self._n = lengths[0]

    def __getitem__(self, idx):
        if len(self._columns) == 1:
            return self._columns[0][idx]
        return tuple(col[idx] for col in self._columns)

    def __len__(self):
        return self._n


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec) file (reference:
    gluon/data/dataset.py RecordFileDataset over MXIndexedRecordIO).

    Reads are serialized on the one file handle (a seek then a read), so
    a DataLoader's worker threads each get the record they asked for;
    the JAX package's dataset shares the handle unguarded."""

    def __init__(self, filename):
        from ...recordio import MXIndexedRecordIO

        self.filename = filename
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = MXIndexedRecordIO(self.idx_file, filename, "r")
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)


class _DownloadedDataset(Dataset):
    """Base for the vision datasets: subclasses fill _data/_label in
    _get_data()."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        pair = (self._data[idx], self._label[idx])
        return self._transform(*pair) if self._transform else pair

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError("_DownloadedDataset subclasses load "
                                  "their arrays here")
