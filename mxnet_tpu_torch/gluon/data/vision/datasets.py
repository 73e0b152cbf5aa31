"""Vision datasets (parity: mxnet_tpu/gluon/data/vision/datasets.py,
python/mxnet/gluon/data/vision/datasets.py: MNIST, FashionMNIST,
CIFAR10/100, ImageRecordDataset, ImageFolderDataset).  Nothing is
downloaded: datasets read local files under ``root`` (idx-ubyte, CIFAR
binary, .rec, an image folder) or, where the files are absent and
``synthetic`` is not False, make the JAX package's deterministic
synthetic data from the same seeds.  Images are host arrays, as
upstream's are; a DataLoader's ``pin_memory`` / ``device_prefetch``
moves batches to the card.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....base import MXNetError
from ....context import cpu
from ....ndarray.ndarray import array
from ..dataset import Dataset, _DownloadedDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "SyntheticImageDataset"]


def _read_idx_images(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(num, rows, cols, 1)


def _read_idx_labels(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)


class MNIST(_DownloadedDataset):
    _train_files = (("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),)
    _test_files = (("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),)

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None, synthetic=None):
        self._train = train
        self._synthetic = synthetic
        super().__init__(root, transform)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        img_base, lbl_base = files[0]
        found = None
        for ext in ("", ".gz"):
            ip = os.path.join(self._root, img_base + ext)
            lp = os.path.join(self._root, lbl_base + ext)
            if os.path.exists(ip) and os.path.exists(lp):
                found = (ip, lp)
                break
        if found is None:
            if self._synthetic is False:
                raise MXNetError("MNIST data not found under %s" % self._root)
            # deterministic synthetic fallback (no network in this env)
            rng = np.random.RandomState(42 if self._train else 43)
            n = 60000 if self._train else 10000
            n = min(n, 8192)
            self._label = rng.randint(0, 10, size=(n,)).astype(np.int32)
            base = rng.rand(10, 28, 28, 1).astype(np.float32)
            imgs = base[self._label] * 255
            noise = rng.rand(n, 28, 28, 1) * 64
            self._data = array(np.clip(imgs + noise, 0,
                                       255).astype(np.uint8), ctx=cpu())
            return
        self._data = array(_read_idx_images(found[0]), ctx=cpu())
        self._label = _read_idx_labels(found[1])


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None, synthetic=None):
        super().__init__(root, train, transform, synthetic)


class CIFAR10(_DownloadedDataset):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None, synthetic=None):
        self._train = train
        self._synthetic = synthetic
        self._archive_file = "cifar-10-binary"
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(
                -1, 3072 + 1)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        if self._train:
            filenames = ["data_batch_%d.bin" % i for i in range(1, 6)]
        else:
            filenames = ["test_batch.bin"]
        paths = [os.path.join(self._root, f) for f in filenames]
        if not all(os.path.exists(p) for p in paths):
            sub = os.path.join(self._root, "cifar-10-batches-bin")
            paths2 = [os.path.join(sub, f) for f in filenames]
            if all(os.path.exists(p) for p in paths2):
                paths = paths2
            else:
                if self._synthetic is False:
                    raise MXNetError("CIFAR10 data not found under %s"
                                     % self._root)
                rng = np.random.RandomState(7 if self._train else 8)
                n = min(50000 if self._train else 10000, 8192)
                self._label = rng.randint(0, 10, size=(n,)).astype(np.int32)
                self._data = array(
                    (rng.rand(n, 32, 32, 3) * 255).astype(np.uint8),
                    ctx=cpu())
                return
        data, label = zip(*(self._read_batch(p) for p in paths))
        self._data = array(np.concatenate(data), ctx=cpu())
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None, synthetic=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform, synthetic)


class ImageRecordDataset(Dataset):
    """Dataset over a .rec of packed images (reference: datasets.py
    ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset

        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from ....recordio import unpack
        from ....image.image import imdecode

        record = self._record[idx]
        header, img = unpack(record)
        label = header.label
        if hasattr(label, "__len__") and len(label) == 1:
            label = float(label[0])
        data = imdecode(img, self._flag)
        if self._transform is not None:
            return self._transform(data, label)
        return data, label

    def __len__(self):
        return len(self._record)


class ImageFolderDataset(Dataset):
    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from ....image.image import imread

        img = imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class SyntheticImageDataset(Dataset):
    """Deterministic synthetic images for benchmarking input-bound-free
    training (counterpart of `train_imagenet.py --benchmark 1`)."""

    def __init__(self, num_samples=1024, shape=(224, 224, 3), num_classes=1000,
                 seed=0):
        rng = np.random.RandomState(seed)
        self._num = num_samples
        self._classes = num_classes
        self._shape = shape
        self._data = (rng.rand(min(num_samples, 256), *shape) * 255).astype(
            np.uint8)
        self._label = rng.randint(0, num_classes,
                                  size=(num_samples,)).astype(np.int32)

    def __len__(self):
        return self._num

    def __getitem__(self, idx):
        return array(self._data[idx % len(self._data)], ctx=cpu()), \
            self._label[idx]
