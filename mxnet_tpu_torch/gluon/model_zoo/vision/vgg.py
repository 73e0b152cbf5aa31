"""VGG 11/13/16/19, with and without BatchNorm (Simonyan & Zisserman).

Parity: mxnet_tpu/gluon/model_zoo/vision/vgg.py, after the reference's
python/mxnet/gluon/model_zoo/vision/vgg.py (same
factories / layer schedule); built from a width table interpreted in one
loop rather than transcribed layer lists.
"""
from __future__ import annotations

from ... import nn
from ....initializer import Xavier
from ._builder import Classifier, load_pretrained

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]

# depth -> convs per stage; stage widths are fixed
_STAGES = {11: [1, 1, 2, 2, 2], 13: [2, 2, 2, 2, 2],
           16: [2, 2, 3, 3, 3], 19: [2, 2, 4, 4, 4]}
_WIDTHS = [64, 128, 256, 512, 512]


class VGG(Classifier):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        conv_init = dict(
            weight_initializer=Xavier(rnd_type="gaussian",
                                      factor_type="out", magnitude=2),
            bias_initializer="zeros")
        fc_init = dict(weight_initializer="normal",
                       bias_initializer="zeros")
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            for reps, width in zip(layers, filters):
                for _ in range(reps):
                    f.add(nn.Conv2D(width, kernel_size=3, padding=1,
                                    **conv_init))
                    if batch_norm:
                        f.add(nn.BatchNorm())
                    f.add(nn.Activation("relu"))
                f.add(nn.MaxPool2D(strides=2))
            for _ in range(2):  # fc6/fc7 with dropout
                f.add(nn.Dense(4096, activation="relu", **fc_init))
                f.add(nn.Dropout(rate=0.5))
            self.features = f
            self.output = nn.Dense(classes, **fc_init)


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """Parity: model_zoo.vision.get_vgg."""
    net = VGG(_STAGES[num_layers], _WIDTHS, **kwargs)
    suffix = "_bn" if kwargs.get("batch_norm") else ""
    return load_pretrained(net, pretrained, "vgg%d%s" % (num_layers, suffix),
                           ctx, root)


def _factory(depth, bn):
    def make(**kwargs):
        if bn:
            kwargs["batch_norm"] = True
        return get_vgg(depth, **kwargs)

    make.__name__ = "vgg%d%s" % (depth, "_bn" if bn else "")
    make.__doc__ = "VGG-%d%s factory." % (depth, " +BN" if bn else "")
    return make


vgg11 = _factory(11, False)
vgg13 = _factory(13, False)
vgg16 = _factory(16, False)
vgg19 = _factory(19, False)
vgg11_bn = _factory(11, True)
vgg13_bn = _factory(13, True)
vgg16_bn = _factory(16, True)
vgg19_bn = _factory(19, True)
