"""Image IO and augmentation (parity: mxnet_tpu/image/image.py,
python/mxnet/image/image.py, src/io/image_aug_default.cc).

JPEG decode on the host through OpenCV where it is installed, else PIL
(as the JAX package chooses); augmentation in numpy with the same draws
from ``np.random`` in the same order, so that a seed gives both packages
the same pixels.  Decoded images are host arrays (``cpu()``), as
upstream's ``imdecode`` gives; an augmenter's result keeps its input's
context, and a crop or flip is an array of its own (upstream slices and
flips by copy), so writing into it never changes the source.
``ImageIter`` batches go to the current context (``gpu(0)`` unless the
caller is inside ``with mx.cpu():``).  ``ImageRecordIterPy`` is the
threaded RecordIO pipeline of ``io.image_record``.
"""
from __future__ import annotations

import io as _io
import os

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray, array

__all__ = ["imdecode", "imdecode_np", "imencode", "imread", "imresize",
           "copyMakeBorder",
           "resize_short", "fixed_crop", "center_crop", "random_crop",
           "random_size_crop", "color_normalize", "CreateAugmenter",
           "Augmenter", "ResizeAug", "ForceResizeAug", "RandomCropAug",
           "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "RandomOrderAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "RandomGrayAug", "ImageIter",
           "ImageRecordIterPy"]

try:
    import cv2  # noqa: F401

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


def _pil():
    """PIL's Image module (imported on first use: the package imports
    without it, and only the codec paths need it)."""
    from PIL import Image

    return Image


def _host(src):
    """numpy pixels of an NDArray or array-like."""
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def _like(out, src):
    """numpy ``out`` as an NDArray on ``src``'s context (the host for
    numpy input)."""
    return array(out, ctx=src.context if isinstance(src, NDArray) else cpu())


def imdecode_np(buf, flag=1, to_rgb=True):
    """Decode compressed image bytes -> numpy HWC uint8."""
    if _HAS_CV2:
        import cv2

        img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                           cv2.IMREAD_COLOR if flag else
                           cv2.IMREAD_GRAYSCALE)
        if flag and to_rgb:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if not flag:
            img = img[..., None]
        return img
    img = _pil().open(_io.BytesIO(buf))
    img = img.convert("RGB" if flag else "L")
    arr = np.asarray(img, dtype=np.uint8)
    if not flag:
        arr = arr[..., None]
    return arr


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decoded HWC uint8 image, a host array."""
    return array(imdecode_np(bytes(buf), flag, to_rgb), ctx=cpu())


def imencode(img, quality=95, img_fmt=".jpg"):
    img = np.asarray(_host(img), dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    pimg = _pil().fromarray(img)
    bio = _io.BytesIO()
    fmt = "JPEG" if "jpg" in img_fmt or "jpeg" in img_fmt else "PNG"
    if fmt == "JPEG" and pimg.mode not in ("RGB", "L"):
        pimg = pimg.convert("RGB")
    pimg.save(bio, format=fmt, quality=quality)
    return bio.getvalue()


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w, h, interp=1):
    pil = _pil()
    pimg = pil.fromarray(_host(src).astype(np.uint8).squeeze())
    out = np.asarray(pimg.resize((w, h), pil.BILINEAR if interp else
                                 pil.NEAREST))
    if out.ndim == 2:
        out = out[..., None]
    return _like(out, src)


def copyMakeBorder(src, top, bot, left, right, border_type=0, value=0.0):
    """Pad an HWC image with a border (parity: the reference's
    ``_cvcopyMakeBorder`` op, src/io/image_io.cc).  border_type follows
    the OpenCV enum: 0=constant(value), 1=replicate, 2=reflect,
    3=wrap, 4=reflect-101."""
    img = _host(src)
    pad = ((top, bot), (left, right)) + ((0, 0),) * (img.ndim - 2)
    modes = {0: "constant", 1: "edge", 2: "symmetric", 3: "wrap",
             4: "reflect"}
    if border_type not in modes:
        raise MXNetError("copyMakeBorder: unknown border_type %r"
                         % (border_type,))
    if border_type == 0:
        out = np.pad(img, pad, mode="constant", constant_values=value)
    else:
        out = np.pad(img, pad, mode=modes[border_type])
    return _like(out, src)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """The (x0, y0, w, h) window of ``src`` as an array of its own,
    resized to ``size`` (w, h) if given."""
    out = NDArray(src._data[y0:y0 + h, x0:x0 + w].clone())
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = int(np.random.uniform(0, w - new_w + 1))
    y0 = int(np.random.uniform(0, h - new_h + 1))
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (float, int)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = np.random.uniform(area[0], area[1]) * src_area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        new_ratio = np.exp(np.random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = np.random.randint(0, w - new_w + 1)
            y0 = np.random.randint(0, h - new_h + 1)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def _on(x, src):
    """``x`` (NDArray, numpy or number) as an operand for ``src``: an
    NDArray on ``src``'s context, or the number itself."""
    if x is None or isinstance(x, (int, float, np.generic)):
        return x
    if isinstance(x, NDArray):
        return x.as_in_context(src.context)
    return array(np.asarray(x, np.float32), ctx=src.context)


def color_normalize(src, mean, std=None):
    mean, std = _on(mean, src), _on(std, src)
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if np.random.rand() < self.p:
            return NDArray(torch.flip(src._data, [1]))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class RandomOrderAug(Augmenter):
    """Apply a list of augmenters in random order (reference image.py
    RandomOrderAug — used by ColorJitterAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for i in np.random.permutation(len(self.ts)):
            src = self.ts[i](src)
        return src


# ITU-R BT.601 luma weights: the channel mix every grayscale/contrast/
# saturation jitter below is built on
_LUMA = np.array([0.299, 0.587, 0.114], np.float32)


class BrightnessJitterAug(Augmenter):
    """src *= 1 + U(-brightness, brightness)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.brightness, self.brightness)
        return _like(_host(src).astype(np.float32) * alpha, src)


class ContrastJitterAug(Augmenter):
    """Blend with the image's mean luma: flattens or exaggerates the
    dynamic range by 1±contrast."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.contrast, self.contrast)
        img = _host(src).astype(np.float32)
        gray_mean = (img[..., :3] * _LUMA).sum() * 3.0 / img.size
        return _like(img * alpha + gray_mean * (1.0 - alpha), src)


class SaturationJitterAug(Augmenter):
    """Blend each pixel with its own luma (per-pixel gray) by 1±saturation."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.saturation, self.saturation)
        img = _host(src).astype(np.float32)
        gray = (img[..., :3] * _LUMA).sum(axis=-1, keepdims=True)
        return _like(img * alpha + gray * (1.0 - alpha), src)


class HueJitterAug(Augmenter):
    """Rotate chroma in YIQ space by U(-hue, hue) * pi (the classic
    RGB->YIQ->rotate->RGB hue shift, reference image.py HueJitterAug)."""

    _TYIQ = np.array([[0.299, 0.587, 0.114],
                      [0.596, -0.274, -0.321],
                      [0.211, -0.523, 0.311]], np.float32)
    _ITYIQ = np.array([[1.0, 0.956, 0.621],
                       [1.0, -0.272, -0.647],
                       [1.0, -1.107, 1.705]], np.float32)

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = np.random.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        rot = np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], np.float32)
        t = (self._ITYIQ @ rot @ self._TYIQ).T
        return _like(_host(src).astype(np.float32) @ t, src)


class ColorJitterAug(RandomOrderAug):
    """brightness/contrast/saturation jitters in random order."""

    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise: add eigvec @ (N(0,alphastd)*eigval)
    per image (reference image.py LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _like(_host(src).astype(np.float32) + rgb.astype(np.float32),
                     src)


class RandomGrayAug(Augmenter):
    """With probability p, collapse RGB to luma replicated over channels."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if np.random.rand() < self.p:
            img = _host(src).astype(np.float32)
            gray = (img[..., :3] * _LUMA).sum(axis=-1, keepdims=True)
            return _like(np.broadcast_to(
                gray, gray.shape[:-1] + (3,)).copy(), src)
        return src


# ImageNet RGB covariance eigen-decomposition used by the reference's
# pca_noise path (image.py CreateAugmenter)
_PCA_EIGVAL = np.array([55.46, 4.794, 1.148], np.float32)
_PCA_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], np.float32)


def color_jitter_auglist(brightness=0, contrast=0, saturation=0, hue=0,
                         pca_noise=0, rand_gray=0):
    """The pixel-value augmenter sub-list shared by CreateAugmenter and
    CreateDetAugmenter (color stages are bbox-independent)."""
    auglist = []
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(pca_noise, _PCA_EIGVAL, _PCA_EIGVEC))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    return auglist


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (reference: image.py
    CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(_RandomSizedCropAug(crop_size, inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    auglist.extend(color_jitter_auglist(brightness, contrast, saturation,
                                        hue, pca_noise, rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(_ColorNormalizeAug(mean, std))
    return auglist


class _RandomSizedCropAug(Augmenter):
    def __init__(self, size, interp):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, (0.08, 1.0),
                                (3 / 4.0, 4 / 3.0), self.interp)[0]


class _ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, np.float32) if mean is not None \
            else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class ImageIter:
    """Python image iterator over .rec or .lst+images (reference:
    python/mxnet/image/image.py ImageIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 last_batch_handle="pad", **kwargs):
        from ..io.io import DataDesc
        from ..recordio import MXIndexedRecordIO

        if not (path_imgrec or path_imglist or isinstance(imglist, list)):
            raise MXNetError("ImageIter needs path_imgrec, path_imglist or "
                             "an imglist")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.dtype = dtype
        self.imgrec = None
        self.seq = None
        self.imglist = None
        if path_imgrec:
            if path_imgidx is None:
                path_imgidx = os.path.splitext(path_imgrec)[0] + ".idx"
            self.imgrec = MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self.seq = list(self.imgrec.keys)
        elif path_imglist:
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in fin:
                    line = line.strip().split("\t")
                    label = np.array(line[1:-1], dtype=np.float32)
                    key = int(line[0])
                    imglist[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist
                self.seq = imgkeys
            self.path_root = path_root
        else:
            result = {}
            imgkeys = []
            for index, img in enumerate(imglist):
                key = str(index)
                if len(img) > 2:
                    label = np.array(img[:-1], dtype=np.float32)
                elif isinstance(img[0], (list, tuple, np.ndarray)):
                    label = np.array(img[0], dtype=np.float32)
                else:
                    label = np.array([img[0]], dtype=np.float32)
                result[key] = (label, img[-1])
                imgkeys.append(key)
            self.imglist = result
            self.seq = imgkeys
            self.path_root = path_root
        if num_parts > 1:
            if not part_index < num_parts:
                raise MXNetError("part_index %d out of %d parts"
                                 % (part_index, num_parts))
            n = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n:(part_index + 1) * n]
        self.shuffle = shuffle
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self.cur = 0
        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape, dtype)]
        self.provide_label = [DataDesc(
            label_name,
            (batch_size,) if label_width == 1
            else (batch_size, label_width), np.float32)]
        self.reset()

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        from ..recordio import unpack

        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                header, img = unpack(self.imgrec.read_idx(idx))
                return header.label, img
            label, fname = self.imglist[idx]
            return label, self.read_image(fname)
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = unpack(s)
        return header.label, img

    def read_image(self, fname):
        with open(os.path.join(self.path_root, fname), "rb") as fin:
            return fin.read()

    def imdecode(self, s):
        return imdecode(s)

    def augmentation_transform(self, data):
        for aug in self.auglist:
            data = aug(data)
        return data

    def next(self):
        from ..io.io import DataBatch

        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, h, w, c), dtype=np.float32)
        batch_label = np.zeros((batch_size, self.label_width),
                               dtype=np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                data = self.augmentation_transform(self.imdecode(s))
                batch_data[i] = data.asnumpy().astype(np.float32)
                batch_label[i] = label
                i += 1
        except StopIteration:
            if not i:
                raise
        pad = batch_size - i
        batch_data = np.transpose(batch_data, (0, 3, 1, 2))  # NCHW
        label_out = batch_label[:, 0] if self.label_width == 1 \
            else batch_label
        return DataBatch([array(batch_data)], [array(label_out)], pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self


def ImageRecordIterPy(path_imgrec=None, data_shape=None, batch_size=1,
                      **kwargs):
    """Back-compat alias (old signature preserved): the threaded RecordIO
    pipeline lives in io.image_record.ImageRecordIter."""
    from ..io.image_record import ImageRecordIter

    return ImageRecordIter(path_imgrec=path_imgrec, data_shape=data_shape,
                           batch_size=batch_size, **kwargs)
