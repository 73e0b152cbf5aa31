"""SqueezeNet 1.0/1.1 (Iandola et al. 1602.07360).

Parity: mxnet_tpu/gluon/model_zoo/vision/squeezenet.py, after the reference's
python/mxnet/gluon/model_zoo/vision/squeezenet.py.
Each version is a schedule of fire modules + pool positions interpreted
in one loop.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._builder import Classifier, load_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1", "get_squeezenet"]


class _Fire(HybridBlock):
    """squeeze 1x1 -> expand {1x1, 3x3} concatenated on channels."""

    def __init__(self, squeeze, expand, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.squeeze = nn.Conv2D(squeeze, kernel_size=1,
                                     activation="relu")
            self.left = nn.Conv2D(expand, kernel_size=1, activation="relu")
            self.right = nn.Conv2D(expand, kernel_size=3, padding=1,
                                   activation="relu")

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.left(x), self.right(x), dim=1)


# version -> (stem conv (ch,k,s), schedule of 'P' (pool) and (sq, ex))
_SPECS = {
    "1.0": ((96, 7, 2),
            ["P", (16, 64), (16, 64), (32, 128), "P", (32, 128),
             (48, 192), (48, 192), (64, 256), "P", (64, 256)]),
    "1.1": ((64, 3, 2),
            ["P", (16, 64), (16, 64), "P", (32, 128), (32, 128), "P",
             (48, 192), (48, 192), (64, 256), (64, 256)]),
}


class SqueezeNet(Classifier):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _SPECS:
            raise ValueError("Unsupported SqueezeNet version %s: 1.0 or 1.1 "
                             "expected" % version)
        (ch, k, s), schedule = _SPECS[version]
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            f.add(nn.Conv2D(ch, kernel_size=k, strides=s, activation="relu"))
            for item in schedule:
                if item == "P":
                    f.add(nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True))
                else:
                    f.add(_Fire(*item))
            f.add(nn.Dropout(0.5))
            self.features = f
            # conv classifier head (no Dense): 1x1 conv -> GAP -> flatten
            out = nn.HybridSequential(prefix="")
            out.add(nn.Conv2D(classes, kernel_size=1, activation="relu"))
            out.add(nn.GlobalAvgPool2D())
            out.add(nn.Flatten())
            self.output = out


def get_squeezenet(version, pretrained=False, ctx=None, root=None, **kwargs):
    """Parity: model_zoo.vision.get_squeezenet."""
    return load_pretrained(SqueezeNet(version, **kwargs), pretrained,
                           "squeezenet%s" % version, ctx, root)


def squeezenet1_0(**kwargs):
    """SqueezeNet 1.0."""
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    """SqueezeNet 1.1 (same accuracy, ~2.4x cheaper)."""
    return get_squeezenet("1.1", **kwargs)
