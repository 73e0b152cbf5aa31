"""Detection-aware image augmenters + ImageDetIter (parity:
mxnet_tpu/image/detection.py, python/mxnet/image/detection.py: the
DetAugmenter family, CreateDetAugmenter, ImageDetIter over .rec/.lst
with the im2rec detection label layout).

The box arithmetic is the JAX package's numpy, drawing from Python's
``random`` in the same order; pixels follow image.py's placement rules.

Design: all bbox bookkeeping is vectorized numpy on the host (labels are
small (N,5+) float arrays in normalized [0,1] corner coords); images
stay NDArrays so the pixel ops share the classification augmenters.
The crop/pad proposal samplers keep the reference's acceptance
contracts (min_object_covered / min_eject_coverage / aspect & area
ranges / max_attempts) with their own decomposition: one geometry
sampler + one constraint checker + one label projector each.
"""
from __future__ import annotations

import json
import logging
import random

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array
from .image import (CastAug, ForceResizeAug, ImageIter, ResizeAug,
                    _ColorNormalizeAug, _like, color_jitter_auglist,
                    fixed_crop)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


# --- vectorized box helpers (normalized corner boxes (N,4)) -----------

def _areas(boxes):
    return (np.maximum(0.0, boxes[:, 2] - boxes[:, 0])
            * np.maximum(0.0, boxes[:, 3] - boxes[:, 1]))


def _clip_to_window(boxes, x1, y1, x2, y2):
    """Intersection of each box with a window; degenerate rows -> 0."""
    out = np.empty_like(boxes)
    out[:, 0] = np.maximum(boxes[:, 0], x1)
    out[:, 1] = np.maximum(boxes[:, 1], y1)
    out[:, 2] = np.minimum(boxes[:, 2], x2)
    out[:, 3] = np.minimum(boxes[:, 3], y2)
    bad = (out[:, 0] >= out[:, 2]) | (out[:, 1] >= out[:, 3])
    out[bad] = 0.0
    return out


class DetAugmenter:
    """Base detection augmenter: __call__(src, label) -> (src, label)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline (labels
    pass through untouched — safe only for geometry-preserving augs)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def dumps(self):
        return [self.__class__.__name__.lower(), self.augmenter.dumps()]

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply one randomly chosen member (or none, with skip_prob)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def dumps(self):
        return [self.__class__.__name__.lower(),
                [a.dumps() for a in self.aug_list]]

    def __call__(self, src, label):
        if self.aug_list and random.random() >= self.skip_prob:
            src, label = random.choice(self.aug_list)(src, label)
        return src, label


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and x-coordinates with probability p."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if random.random() < self.p:
            src = NDArray(torch.flip(src._data, [1]))
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Constraint-satisfying random crop (reference detection.py:152).

    Accepts a crop window only if every object it touches is covered by
    at least ``min_object_covered``; objects retaining under
    ``min_eject_coverage`` of their area after the crop are dropped from
    the label."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.enabled = (0 < area_range[1] and area_range[0] <= area_range[1]
                        and 0 < aspect_ratio_range[0]
                        <= aspect_ratio_range[1])
        if not self.enabled:
            logging.warning("DetRandomCropAug disabled: bad area/aspect "
                            "ranges %s %s", area_range, aspect_ratio_range)

    def _sample_window(self, height, width):
        """One candidate (x, y, w, h) in pixels, or None."""
        import math

        ratio = random.uniform(*self.aspect_ratio_range)
        if ratio <= 0:
            return None
        lo_h = int(round(math.sqrt(self.area_range[0] * height * width
                                   / ratio)))
        hi_h = int(round(math.sqrt(self.area_range[1] * height * width
                                   / ratio)))
        hi_h = min(hi_h, height, int(width / ratio))
        lo_h = min(lo_h, hi_h)
        if hi_h < 1:
            return None
        h = random.randint(max(1, lo_h), max(1, hi_h))
        w = int(round(h * ratio))
        if w < 1 or w > width:
            return None
        area = w * h
        if not (self.area_range[0] * height * width * 0.99 <= area
                <= self.area_range[1] * height * width * 1.01):
            return None
        y = random.randint(0, height - h)
        x = random.randint(0, width - w)
        return x, y, w, h

    def _covered_enough(self, boxes, x1, y1, x2, y2):
        """True when every object touching the window is covered at
        least min_object_covered (and at least one is)."""
        areas = _areas(boxes)
        live = areas > 0
        if not live.any():
            return False
        inter = _areas(_clip_to_window(boxes[live], x1, y1, x2, y2))
        cov = inter / areas[live]
        cov = cov[cov > 0]
        return cov.size > 0 and cov.min() > self.min_object_covered

    def _project_labels(self, label, x, y, w, h, height, width):
        """Re-express labels in the crop's frame; eject tiny leftovers.
        Returns None when no object survives."""
        wx1, wy1 = x / width, y / height
        ww, wh = w / width, h / height
        out = label.copy()
        before = _areas(out[:, 1:5])
        out[:, 1:5] = _clip_to_window(out[:, 1:5], wx1, wy1,
                                      wx1 + ww, wy1 + wh)
        out[:, [1, 3]] = (out[:, [1, 3]] - wx1) / ww
        out[:, [2, 4]] = (out[:, [2, 4]] - wy1) / wh
        out[:, 1:5] = np.clip(out[:, 1:5], 0.0, 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            keep_frac = _areas(out[:, 1:5]) * ww * wh / before
        valid = ((out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
                 & (keep_frac > self.min_eject_coverage))
        if not valid.any():
            return None
        return out[valid]

    def __call__(self, src, label):
        if not self.enabled:
            return src, label
        height, width = src.shape[0], src.shape[1]
        if height <= 0 or width <= 0:
            return src, label
        for _ in range(self.max_attempts):
            win = self._sample_window(height, width)
            if win is None:
                continue
            x, y, w, h = win
            if (w * h) < 2:
                continue
            if not self._covered_enough(label[:, 1:5], x / width,
                                        y / height, (x + w) / width,
                                        (y + h) / height):
                continue
            new_label = self._project_labels(label, x, y, w, h, height,
                                             width)
            if new_label is None:
                continue
            return fixed_crop(src, x, y, w, h, None), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random canvas expansion (reference detection.py:323): the image
    lands at a random offset inside a larger pad_val-filled canvas and
    boxes are re-normalized to the canvas."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(128, 128, 128)):
        if not isinstance(pad_val, (list, tuple)):
            pad_val = (pad_val,)
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.pad_val = pad_val
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = (area_range[1] > 1.0
                        and area_range[0] <= area_range[1]
                        and 0 < aspect_ratio_range[0]
                        <= aspect_ratio_range[1])
        if not self.enabled:
            logging.warning("DetRandomPadAug disabled: bad area/aspect "
                            "ranges %s %s", area_range, aspect_ratio_range)

    def _sample_canvas(self, height, width):
        import math

        ratio = random.uniform(*self.aspect_ratio_range)
        if ratio <= 0:
            return None
        lo_h = int(round(math.sqrt(self.area_range[0] * height * width
                                   / ratio)))
        hi_h = int(round(math.sqrt(self.area_range[1] * height * width
                                   / ratio)))
        lo_h = max(lo_h, height, int(round(width / ratio)))
        if lo_h > hi_h:
            return None
        h = random.randint(lo_h, hi_h)
        w = int(round(h * ratio))
        if (h - height) < 2 or (w - width) < 2:
            return None
        y = random.randint(0, h - height)
        x = random.randint(0, w - width)
        return x, y, w, h

    def __call__(self, src, label):
        if not self.enabled:
            return src, label
        height, width = src.shape[0], src.shape[1]
        if height <= 0 or width <= 0:
            return src, label
        for _ in range(self.max_attempts):
            canvas = self._sample_canvas(height, width)
            if canvas is None:
                continue
            x, y, w, h = canvas
            img = src.asnumpy()
            out = np.empty((h, w, img.shape[2]), dtype=img.dtype)
            out[:] = np.asarray(self.pad_val, dtype=img.dtype)
            out[y:y + height, x:x + width] = img
            new_label = label.copy()
            new_label[:, [1, 3]] = (new_label[:, [1, 3]] * width + x) / w
            new_label[:, [2, 4]] = (new_label[:, [2, 4]] * height + y) / h
            return _like(out, src), new_label
        return src, label


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """Bundle several crop samplers (list-valued params broadcast
    against scalars) behind one random selector."""
    params = [min_object_covered, aspect_ratio_range, area_range,
              min_eject_coverage, max_attempts]
    as_lists = [p if isinstance(p, list) else [p] for p in params]
    n = max(len(p) for p in as_lists)
    for i, p in enumerate(as_lists):
        if len(p) != n:
            if len(p) != 1:
                raise MXNetError("parameter lists must align")
            as_lists[i] = p * n
    augs = [DetRandomCropAug(min_object_covered=moc,
                             aspect_ratio_range=arr, area_range=ar,
                             min_eject_coverage=mec, max_attempts=ma)
            for moc, arr, ar, mec, ma in zip(*as_lists)]
    return DetRandomSelectAug(augs, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmentation pipeline (reference
    detection.py:482): crop/flip/pad are bbox-aware; pixel-only stages
    are borrowed from the classification augmenters."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        auglist.append(CreateMultiRandCropAugmenter(
            min_object_covered, aspect_ratio_range,
            (area_range[0], min(1.0, area_range[1])), min_eject_coverage,
            max_attempts, skip_prob=1 - rand_crop))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        pad_aug = DetRandomPadAug(aspect_ratio_range,
                                  (1.0, area_range[1]), max_attempts,
                                  pad_val)
        auglist.append(DetRandomSelectAug([pad_aug], 1 - rand_pad))
    auglist.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    # pixel-value jitters are bbox-independent: borrow the shared
    # classification color stages (reference appends ColorJitterAug/
    # HueJitterAug/LightingAug/RandomGrayAug here — detection.py:482;
    # until r4 these params were silently dropped, ADVICE r3 medium)
    for aug in color_jitter_auglist(brightness, contrast, saturation,
                                    hue, pca_noise, rand_gray):
        auglist.append(DetBorrowAug(aug))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(_ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection batch iterator (reference detection.py:624).

    Labels use the im2rec detection layout: flat
    ``[header_width, obj_width, extras..., (id x1 y1 x2 y2 ...)*]`` per
    image; batches carry ``(B, max_objects, obj_width)`` with unused
    rows filled with -1."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 **kwargs):
        det_kwargs = {}
        for key in ("resize", "rand_crop", "rand_pad", "rand_gray",
                    "rand_mirror", "mean", "std", "brightness", "contrast",
                    "saturation", "pca_noise", "hue", "inter_method",
                    "min_object_covered", "aspect_ratio_range",
                    "area_range", "min_eject_coverage", "max_attempts",
                    "pad_val"):
            if key in kwargs:
                det_kwargs[key] = kwargs.pop(key)
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         path_imgidx=path_imgidx, shuffle=shuffle,
                         part_index=part_index, num_parts=num_parts,
                         aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name,
                         **kwargs)
        if aug_list is None:
            self.auglist = CreateDetAugmenter(tuple(data_shape),
                                              **det_kwargs)
        else:
            self.auglist = aug_list
        self.label_shape = self._estimate_label_shape()
        from ..io.io import DataDesc

        self.provide_label = [DataDesc(
            label_name, (batch_size,) + self.label_shape, np.float32)]

    # --- label plumbing ----------------------------------------------

    @staticmethod
    def _parse_label(label):
        """Flat raw label -> (num_objects, obj_width) array."""
        if isinstance(label, NDArray):
            label = label.asnumpy()
        raw = np.asarray(label, np.float32).ravel()
        if raw.size < 7:
            raise MXNetError("detection label too short: %d values"
                             % raw.size)
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if obj_width < 5 or (raw.size - header_width) % obj_width != 0:
            raise MXNetError(
                "label size %d inconsistent with header %d / object "
                "width %d" % (raw.size, header_width, obj_width))
        out = raw[header_width:].reshape(-1, obj_width)
        valid = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
        if not valid.any():
            raise MXNetError("sample has no valid boxes")
        return out[valid]

    def _estimate_label_shape(self):
        max_objects, obj_width = 0, 5
        self.reset()
        try:
            while True:
                label, _ = self.next_sample()
                parsed = self._parse_label(label)
                max_objects = max(max_objects, parsed.shape[0])
                obj_width = parsed.shape[1]
        except StopIteration:
            pass
        self.reset()
        if max_objects == 0:
            raise MXNetError("no valid detection labels found")
        return (max_objects, obj_width)

    def reshape(self, data_shape=None, label_shape=None):
        from ..io.io import DataDesc

        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            self.provide_data = [DataDesc(
                self.provide_data[0].name,
                (self.batch_size,) + self.data_shape)]
        if label_shape is not None:
            self.check_label_shape(label_shape)
            self.label_shape = tuple(label_shape)
            self.provide_label = [DataDesc(
                self.provide_label[0].name,
                (self.batch_size,) + self.label_shape, np.float32)]

    def check_label_shape(self, label_shape):
        if len(label_shape) != 2:
            raise MXNetError("label_shape must be (max_objects, width)")
        if label_shape[0] < self.label_shape[0] \
                or label_shape[1] != self.label_shape[1]:
            raise MXNetError(
                "new label shape %s cannot hold current labels %s"
                % (label_shape, self.label_shape))

    def sync_label_shape(self, it, verbose=False):
        """Grow both iterators to the common label shape (reference:
        detection.py:959) — train/val must batch identically."""
        if not isinstance(it, ImageDetIter):
            raise MXNetError("sync_label_shape needs an ImageDetIter")
        combined = (max(self.label_shape[0], it.label_shape[0]),
                    self.label_shape[1])
        self.reshape(label_shape=combined)
        it.reshape(label_shape=combined)
        if verbose:
            logging.info("synced label shape to %s", (combined,))
        return it

    def augmentation_transform(self, data, label):
        for aug in self.auglist:
            data, label = aug(data, label)
        return data, label

    def next(self):
        from ..io.io import DataBatch

        batch_size = self.batch_size
        c, h, w = self.data_shape
        max_obj, obj_w = self.label_shape
        batch_data = np.zeros((batch_size, h, w, c), np.float32)
        batch_label = np.full((batch_size, max_obj, obj_w), -1.0,
                              np.float32)
        i = 0
        try:
            while i < batch_size:
                raw_label, s = self.next_sample()
                try:
                    img = self.imdecode(s)
                    label = self._parse_label(raw_label)
                    img, label = self.augmentation_transform(img, label)
                except MXNetError as e:
                    logging.debug("skipping invalid sample: %s", e)
                    continue
                batch_data[i] = img.asnumpy().astype(np.float32)
                n = min(label.shape[0], max_obj)
                batch_label[i, :n] = label[:n]
                i += 1
        except StopIteration:
            if not i:
                raise
        pad = batch_size - i
        batch_data = np.transpose(batch_data, (0, 3, 1, 2))
        return DataBatch([array(batch_data)], [array(batch_label)],
                         pad=pad)

    def draw_next(self, color=None, thickness=2, mean=None, std=None,
                  clip=True, waitKey=None, window_name="draw_next"):
        """Yield augmented images (HWC uint8 numpy) with their boxes
        rasterized — the reference's debug visualizer, minus cv2."""
        while True:
            try:
                raw_label, s = self.next_sample()
                img = self.imdecode(s)
                label = self._parse_label(raw_label)
                img, label = self.augmentation_transform(img, label)
            except StopIteration:
                return
            except MXNetError:
                continue
            canvas = np.ascontiguousarray(
                np.clip(img.asnumpy(), 0, 255)).astype(np.uint8)
            hh, ww = canvas.shape[0], canvas.shape[1]
            col = color or (0, 255, 0)
            t = max(1, int(thickness))
            for row in label:
                x1 = int(np.clip(row[1], 0, 1) * (ww - 1))
                y1 = int(np.clip(row[2], 0, 1) * (hh - 1))
                x2 = int(np.clip(row[3], 0, 1) * (ww - 1))
                y2 = int(np.clip(row[4], 0, 1) * (hh - 1))
                canvas[y1:y1 + t, x1:x2] = col
                canvas[max(0, y2 - t):y2, x1:x2] = col
                canvas[y1:y2, x1:x1 + t] = col
                canvas[y1:y2, max(0, x2 - t):x2] = col
            yield canvas
