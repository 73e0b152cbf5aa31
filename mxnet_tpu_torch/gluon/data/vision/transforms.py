"""Vision transforms (parity: mxnet_tpu/gluon/data/vision/transforms.py,
python/mxnet/gluon/data/vision/transforms.py: ToTensor, Normalize, Resize,
crops, flips, colour jitter), as the port's Blocks and HybridBlocks, on
the image ops of ``mx.image``.  Each result stays on its input's
context; the draws come from ``np.random`` in the JAX package's order.
"""
from __future__ import annotations

import numpy as np
import torch

from ...block import Block, HybridBlock
from ...nn import Sequential, HybridSequential
from ....ndarray.ndarray import NDArray, array

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomHue",
           "RandomColorJitter", "RandomLighting"]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        with self.name_scope():
            hybrid = []
            for i in transforms:
                if isinstance(i, HybridBlock):
                    hybrid.append(i)
                    continue
                elif len(hybrid) == 1:
                    self.add(hybrid[0])
                    hybrid = []
                elif len(hybrid) > 1:
                    hblock = HybridSequential()
                    for j in hybrid:
                        hblock.add(j)
                    self.add(hblock)
                    hybrid = []
                self.add(i)
            if len(hybrid) == 1:
                self.add(hybrid[0])
            elif len(hybrid) > 1:
                hblock = HybridSequential()
                for j in hybrid:
                    hblock.add(j)
                self.add(hblock)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.Cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def hybrid_forward(self, F, x):
        x = F.Cast(x, dtype="float32") / 255.0
        if x.ndim == 3:
            return x.transpose((2, 0, 1))
        return x.transpose((0, 3, 1, 2))


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype=np.float32)
        self._std = np.asarray(std, dtype=np.float32)

    def hybrid_forward(self, F, x):
        mean = self._mean.reshape((-1, 1, 1))
        std = self._std.reshape((-1, 1, 1))
        return (x - array(mean, ctx=x.context)) / array(std, ctx=x.context)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._keep = keep_ratio

    def forward(self, x):
        from ....image.image import imresize

        w, h = self._size
        return imresize(x, w, h)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)

    def forward(self, x):
        from ....image.image import center_crop

        return center_crop(x, self._size)[0]


class RandomCrop(Block):
    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._pad = pad

    def forward(self, x):
        from ....image.image import random_crop

        return random_crop(x, self._size)[0]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (tuple, list)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        from ....image.image import random_size_crop

        return random_size_crop(x, self._size, self._scale, self._ratio)[0]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return NDArray(torch.flip(x._data, [1]))
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if np.random.rand() < 0.5:
            return NDArray(torch.flip(x._data, [0]))
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._args = (max(0, 1 - brightness), 1 + brightness)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        return x * alpha


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._args = (max(0, 1 - contrast), 1 + contrast)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        gray = x.mean()
        return x * alpha + gray * (1 - alpha)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._args = (max(0, 1 - saturation), 1 + saturation)

    def forward(self, x):
        alpha = np.random.uniform(*self._args)
        coef = array(np.asarray([[[0.299]], [[0.587]], [[0.114]]],
                                dtype=np.float32).reshape(1, 1, 3),
                     ctx=x.context)
        gray = (x * coef).sum(axis=2, keepdims=True)
        return x * alpha + gray * (1 - alpha)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        # approximate hue jitter via yiq rotation
        alpha = np.random.uniform(-self._hue, self._hue)
        u = np.cos(alpha * np.pi)
        w = np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0],
                       [0.0, u, -w],
                       [0.0, w, u]], dtype=np.float32)
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], dtype=np.float32)
        t_rgb = np.linalg.inv(t_yiq).astype(np.float32)
        m = t_rgb.dot(bt).dot(t_yiq)
        mt = torch.as_tensor(np.ascontiguousarray(m.T),
                             device=x._data.device)
        return NDArray((x._data.reshape(-1, 3) @ mt).reshape(x.shape))


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._transforms = []
        if brightness:
            self._transforms.append(RandomBrightness(brightness))
        if contrast:
            self._transforms.append(RandomContrast(contrast))
        if saturation:
            self._transforms.append(RandomSaturation(saturation))
        if hue:
            self._transforms.append(RandomHue(hue))

    def forward(self, x):
        order = np.random.permutation(len(self._transforms))
        for i in order:
            x = self._transforms[i](x)
        return x


class RandomLighting(Block):
    """PCA-noise lighting jitter (AlexNet-style)."""

    _eigval = np.array([55.46, 4.794, 1.148], dtype=np.float32)
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.8140],
                        [-0.5836, -0.6948, 0.4203]], dtype=np.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        alpha = np.random.normal(0, self._alpha, size=(3,)).astype(np.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return x + array(rgb.astype(np.float32), ctx=x.context)
