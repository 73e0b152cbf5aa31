"""ImageRecordIter: the RecordIO image pipeline (parity:
mxnet_tpu/io/image_record.py, src/io/iter_image_recordio_2.cc:50-817,
ImageRecordIOParser2): sharded .rec reading (``part_index`` /
``num_parts``), threaded JPEG decode and augmentation
(``preprocess_threads``), ``prefetch_buffer`` batches in flight,
``round_batch`` wrap-around padding, and the augmenter knobs (resize /
rand_crop / rand_mirror / mean / std / scale).

Decode and augmentation run in a thread pool: PIL's JPEG codec and numpy
release the GIL, so ``preprocess_threads`` batches decode while the card
trains.  The draws are the JAX package's: the epoch's order from
``RandomState(seed + epoch)``, each batch's crops then mirrors from
``RandomState((seed + 77777 * epoch + batch_id) & 0x7FFFFFFF)``, so the
two packages give the same pixels.  A plain centre-crop of 3-channel
images with scalar labels takes the native decoder (``native``, libjpeg
on C++ threads) when it built; a batch it refuses goes to the Python
path, and ``_decoded`` counts the batches each decoder produced.

The device step: each batch is decoded into one uint8 host buffer (pinned
when the iterator's context is a card; a fresh one a batch, so no buffer
is reused while its copy is in flight), copied with
``non_blocking=True`` (4x fewer bytes than f32) and normalized on the
card, ``((u8 - mean) / std) * scale`` in f32 cast to ``dtype``, the JAX
package's arithmetic in its order.  Labels go to the same device.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import current_context
from ..ndarray.ndarray import NDArray
from ..recordio import MXRecordIO, unpack
from .io import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter"]


def _parse_shape(v):
    if isinstance(v, str):
        v = v.strip("()[] ").split(",")
    return tuple(int(x) for x in v)


class ImageRecordIter(DataIter):
    """Threaded RecordIO -> JPEG decode -> augment -> device batches on
    ``ctx`` (default: the current context, ``gpu(0)``)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 part_index=0, num_parts=1, preprocess_threads=None,
                 prefetch_buffer=4, resize=-1, rand_crop=False,
                 rand_mirror=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0, seed=0,
                 round_batch=True, data_name="data",
                 label_name="softmax_label", dtype="float32", ctx=None,
                 **kwargs):
        super().__init__(batch_size)
        self._path_rec = path_imgrec
        self._path_idx = path_imgidx
        self._data_shape = _parse_shape(data_shape)
        if len(self._data_shape) != 3:
            raise MXNetError("data_shape must be (channels, height, width)")
        self._label_width = int(label_width)
        self._shuffle = bool(shuffle)
        self._resize = int(resize)
        self._rand_crop = bool(rand_crop)
        self._rand_mirror = bool(rand_mirror)
        self._mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self._std = np.array([std_r, std_g, std_b], np.float32)
        self._scale = float(scale)
        self._seed = int(seed)
        self._round_batch = bool(round_batch)
        self._dtype = torch_dtype(dtype)
        self._data_name = data_name
        self._label_name = label_name
        self._device = (ctx or current_context()).torch_device
        self._pin = self._device.type == "cuda"

        if preprocess_threads is None:
            from .. import config as _config

            preprocess_threads = _config.get("MXNET_CPU_WORKER_NTHREADS")
        self._nthreads = int(preprocess_threads)
        # the native decoder (libjpeg on C++ threads) takes plain
        # centre-crops of 3-channel data with scalar labels
        from .. import native as _native

        self._native_ok = (
            self._label_width == 1 and self._data_shape[0] == 3
            and self._resize <= 0 and not self._rand_crop
            and not self._rand_mirror and _native.available())
        # one native call in flight at a time: decode_batch runs nthreads
        # C++ threads itself, so one crew a pool worker would oversubscribe
        # nthreads^2-fold
        self._native_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._decoded = {"native": 0, "python": 0}
        self._positions = self._index_positions(part_index, num_parts)
        if not self._positions:
            raise MXNetError("shard %d/%d of %s holds no records"
                             % (part_index, num_parts, path_imgrec))
        self._tl = threading.local()
        self._norm = None
        self._pool = ThreadPoolExecutor(max_workers=self._nthreads,
                                        thread_name_prefix="imgrec")
        self._depth = max(2, int(prefetch_buffer))
        self._epoch = 0
        self._order = None
        self._cursor = 0
        self._pending = deque()
        self.reset()

    # -- index and sharding ------------------------------------------------
    def _index_positions(self, part_index, num_parts):
        """Byte offsets of every record of this worker's shard."""
        idx_path = self._path_idx
        if idx_path is None and os.path.exists(self._path_rec[:-4]
                                               + ".idx"):
            idx_path = self._path_rec[:-4] + ".idx"
        positions = []
        if idx_path and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        positions.append(int(parts[1]))
        else:
            from .. import native as _native

            if _native.available():
                positions = _native.recordio_index(self._path_rec)
            else:
                rec = MXRecordIO(self._path_rec, "r")
                while True:
                    pos = rec.tell()
                    if rec.read() is None:
                        break
                    positions.append(pos)
                rec.close()
        # a contiguous shard a worker, as the reference's
        n = len(positions)
        lo = (n * part_index) // num_parts
        hi = (n * (part_index + 1)) // num_parts
        return positions[lo:hi]

    def _reader(self):
        r = getattr(self._tl, "reader", None)
        if r is None:
            r = MXRecordIO(self._path_rec, "r")
            self._tl.reader = r
        return r

    # -- iterator contract -------------------------------------------------
    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 else \
            (self.batch_size, self._label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self._epoch += 1
        order = np.arange(len(self._positions))
        if self._shuffle:
            np.random.RandomState(self._seed + self._epoch).shuffle(order)
        self._order = order
        self._cursor = 0
        # a batch already decoding cannot be cancelled: it sees the new
        # epoch and stops at its next image (_load_batch)
        for fut in self._pending:
            fut.cancel()
        self._pending.clear()
        for _ in range(self._depth):
            self._submit()

    def _submit(self):
        if self._cursor >= len(self._order):
            return
        take = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        pad = 0
        if len(take) < self.batch_size:
            short = self.batch_size - len(take)
            pad = short
            if self._round_batch:
                # np.resize cycles: right even when the whole shard is
                # smaller than the shortfall
                take = np.concatenate([take, np.resize(self._order, short)])
            elif len(take) == 0:
                return
            else:
                take = np.concatenate([take, np.resize(take, short)])
        batch_id = self._cursor // self.batch_size
        self._pending.append(
            self._pool.submit(self._load_batch, take, pad, batch_id,
                              self._epoch))

    def next(self):
        if not self._pending:
            raise StopIteration
        fut = self._pending.popleft()
        self._submit()
        data_u8, label, pad = fut.result()
        data, label = self._to_device(data_u8, label)
        return DataBatch(data=[data], label=[label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def _to_device(self, data_u8, label):
        """The uint8 batch and its labels onto the device, the data
        normalized there."""
        dev = self._device
        u8 = data_u8.to(dev, non_blocking=True)
        label = label.to(dev, non_blocking=True)
        if self._norm is None:
            c = self._data_shape[0]
            self._norm = (
                torch.as_tensor(self._mean[:c], device=dev).reshape(
                    1, c, 1, 1),
                torch.as_tensor(self._std[:c], device=dev).reshape(
                    1, c, 1, 1))
        mean, std = self._norm
        x = (u8.to(torch.float32) - mean) / std
        if self._scale != 1.0:
            x = x * self._scale
        return NDArray(x.to(self._dtype)), NDArray(label)

    # -- decode + augment (pool threads) ----------------------------------
    def _host(self, shape, dtype):
        """A host buffer for one batch: pinned for a card's copy."""
        return torch.empty(shape, dtype=dtype, pin_memory=self._pin)

    def _count(self, decoder):
        with self._count_lock:
            self._decoded[decoder] += 1

    def _load_batch(self, order_idx, pad, batch_id, epoch):
        c, h, w = self._data_shape
        if self._native_ok:
            got = self._load_batch_native(order_idx, pad)
            if got is not None:
                self._count("native")
                return got
        data_t = self._host((self.batch_size, c, h, w), torch.uint8)
        label_t = self._host((self.batch_size,) if self._label_width == 1
                             else (self.batch_size, self._label_width),
                             torch.float32)
        data, label = data_t.numpy(), label_t.numpy()
        rng = np.random.RandomState(
            (self._seed + 77_777 * epoch + batch_id) & 0x7FFFFFFF)
        reader = self._reader()
        for slot, oi in enumerate(order_idx):
            if epoch != self._epoch:
                return None  # reset() or close() dropped this batch
            reader.seek(self._positions[int(oi)])
            header, img_bytes = unpack(reader.read())
            data[slot] = self._decode_augment(img_bytes, rng)
            lab = np.atleast_1d(np.asarray(header.label, np.float32))
            label[slot] = lab[0] if self._label_width == 1 else \
                lab[:self._label_width]
        self._count("python")
        return data_t, label_t, pad

    def _load_batch_native(self, order_idx, pad):
        """Whole-batch read + decode in C++ (no GIL); None when a record
        fails, and the Python path takes this and every later batch."""
        from .. import native as _native

        _c, h, w = self._data_shape
        positions = [self._positions[int(i)] for i in order_idx]
        with self._native_lock:
            batch_hwc, labels, failed = _native.decode_batch(
                self._path_rec, positions, h, w, threads=self._nthreads)
        if failed:
            self._native_ok = False
            return None
        data_t = self._host((self.batch_size, 3, h, w), torch.uint8)
        label_t = self._host((self.batch_size,), torch.float32)
        np.copyto(data_t.numpy(), batch_hwc.transpose(0, 3, 1, 2))
        np.copyto(label_t.numpy(), labels)
        return data_t, label_t, pad

    def _decode_augment(self, img_bytes, rng):
        import io as _io

        from PIL import Image

        c, h, w = self._data_shape
        img = Image.open(_io.BytesIO(img_bytes))
        img = img.convert("RGB" if c == 3 else "L")
        if self._resize > 0:
            ow, oh = img.size
            if ow < oh:
                img = img.resize((self._resize,
                                  max(1, oh * self._resize // ow)))
            else:
                img = img.resize((max(1, ow * self._resize // oh),
                                  self._resize))
        ow, oh = img.size
        if ow < w or oh < h:
            img = img.resize((max(ow, w), max(oh, h)))
            ow, oh = img.size
        if self._rand_crop:
            x0 = int(rng.randint(0, ow - w + 1))
            y0 = int(rng.randint(0, oh - h + 1))
        else:
            x0, y0 = (ow - w) // 2, (oh - h) // 2
        img = img.crop((x0, y0, x0 + w, y0 + h))
        arr = np.asarray(img, np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self._rand_mirror and rng.randint(2):
            arr = arr[:, ::-1, :]
        # normalization happens on the device (_to_device): the pool only
        # moves uint8 bytes, keeping the host's cores for the JPEG codec
        return arr.transpose(2, 0, 1)

    def close(self):
        """Stop the decode pool (batches in flight are dropped)."""
        self._epoch += 1  # running batches stop at their next image
        for fut in self._pending:
            fut.cancel()
        self._pending.clear()
        self._pool.shutdown(wait=True)

    def __del__(self):
        pool = getattr(self, "_pool", None)
        if pool is not None:
            try:
                pool.shutdown(wait=False, cancel_futures=True)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass
