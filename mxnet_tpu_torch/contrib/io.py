"""contrib IO: the gluon DataLoader as a Module DataIter (parity:
mxnet_tpu/contrib/io.py, python/mxnet/contrib/io.py DataLoaderIter).

One lookahead batch sets the shapes; a short last batch is zero-padded
to the batch size with ``pad`` set.  Batches stay where the loader puts
them (the host); ``Module.forward`` copies them to its context.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from ..io.io import DataBatch, DataDesc, DataIter
from ..ndarray.ndarray import NDArray

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """Wrap a gluon DataLoader so that Module.fit can consume it."""

    def __init__(self, loader, data_name="data",
                 label_name="softmax_label", dtype="float32"):
        self._loader = loader
        self.dtype = dtype
        probe_data, probe_label = next(iter(loader))
        super().__init__(int(probe_data.shape[0]))
        np_dtype = np.dtype(dtype)
        self._data_desc = DataDesc(data_name, tuple(probe_data.shape),
                                   np_dtype)
        self._label_desc = DataDesc(label_name, tuple(probe_label.shape),
                                    np_dtype)
        self.reset()

    @property
    def provide_data(self):
        return [self._data_desc]

    @property
    def provide_label(self):
        return [self._label_desc]

    def reset(self):
        self._iter = iter(self._loader)

    def _full(self, arr):
        """Cast and zero-pad a short batch to the batch size."""
        t = arr._data if isinstance(arr, NDArray) \
            else torch.as_tensor(np.asarray(arr))
        t = t.to(torch_dtype(self.dtype))
        short = self.batch_size - t.shape[0]
        if short <= 0:
            return NDArray(t), 0
        pad = t.new_zeros((short,) + tuple(t.shape[1:]))
        return NDArray(torch.cat([t, pad])), short

    def next(self):
        data, label = next(self._iter)
        data, pad = self._full(data)
        label, _ = self._full(label)
        return DataBatch(data=[data], label=[label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
