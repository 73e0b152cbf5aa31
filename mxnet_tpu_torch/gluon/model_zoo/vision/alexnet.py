"""AlexNet (Krizhevsky et al.).

Parity: mxnet_tpu/gluon/model_zoo/vision/alexnet.py, after the reference's
python/mxnet/gluon/model_zoo/vision/alexnet.py; the
conv trunk is a spec table interpreted in one loop.
"""
from __future__ import annotations

from ... import nn
from ._builder import Classifier, load_pretrained

__all__ = ["AlexNet", "alexnet"]

# (channels, kernel, stride, pad, pool_after?)
_TRUNK = [(64, 11, 4, 2, True), (192, 5, 1, 2, True),
          (384, 3, 1, 1, False), (256, 3, 1, 1, False),
          (256, 3, 1, 1, True)]


class AlexNet(Classifier):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            for ch, k, s, p, pool in _TRUNK:
                f.add(nn.Conv2D(ch, kernel_size=k, strides=s, padding=p,
                                activation="relu"))
                if pool:
                    f.add(nn.MaxPool2D(pool_size=3, strides=2))
            f.add(nn.Flatten())
            for _ in range(2):
                f.add(nn.Dense(4096, activation="relu"))
                f.add(nn.Dropout(rate=0.5))
            self.features = f
            self.output = nn.Dense(classes)


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    """Parity: model_zoo.vision.alexnet."""
    return load_pretrained(AlexNet(**kwargs), pretrained, "alexnet", ctx,
                           root)
