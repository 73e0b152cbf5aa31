"""ResNet v1 (He et al. 1512.03385; parity:
mxnet_tpu/gluon/model_zoo/vision/resnet.py).

Only v1 is ported.  Class names are the JAX package's (``_ResNet``,
``_Unit``, ``ResNetV1``) because gluon derives parameter names from them:
``resnet50_v1()`` names its parameters ``_resnet<n>_...`` and
``ResNetV1(...)`` ``resnetv1<n>_...``, exactly as there.
"""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._builder import Classifier, conv_block

__all__ = ["ResNetV1", "BasicBlockV1", "BottleneckV1", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "get_resnet"]

# depth -> (bottleneck?, units per stage, per-stage output channels)
_SPECS = {
    18: (False, [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: (False, [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: (True, [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: (True, [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: (True, [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


class _Unit(HybridBlock):
    """One v1 residual unit: relu(x + body(x)).  The bottleneck's 1x1
    convs carry a bias (upstream quirk kept for parameter parity) and its
    stride sits on the leading 1x1."""

    def __init__(self, channels, stride, bottleneck, match_dims, **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4 if bottleneck else channels
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            # conv plan rows: (channels, kernel, stride, biased?)
            if bottleneck:
                plan = [(mid, 1, stride, True), (mid, 3, 1, False),
                        (channels, 1, 1, True)]
            else:
                plan = [(mid, 3, stride, False), (channels, 3, 1, False)]
            for i, (ch, k, s, biased) in enumerate(plan):
                last = i == len(plan) - 1
                self.body.add(conv_block(ch, k, s, bias=biased,
                                         act=None if last else "relu"))
            if match_dims:
                self.shortcut = None
            else:
                self.shortcut = conv_block(channels, 1, stride, act=None)

    def hybrid_forward(self, F, x):
        res = x if self.shortcut is None else self.shortcut(x)
        return F.relu(res + self.body(x))


class BasicBlockV1(_Unit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, False, not downsample, **kwargs)


class BottleneckV1(_Unit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, True, not downsample, **kwargs)


class _ResNet(Classifier):
    """Stem, unit stages and a pooled classifier head from a spec."""

    def __init__(self, bottleneck, units, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        assert len(channels) == len(units) + 1
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            if thumbnail:  # CIFAR-style bare 3x3 conv, no pooling
                f.add(nn.Conv2D(channels[0], kernel_size=3, strides=1,
                                padding=1, use_bias=False))
            else:
                f.add(conv_block(channels[0], 7, 2, 3))
                f.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            in_ch = channels[0]
            for si, (out_ch, n) in enumerate(zip(channels[1:], units)):
                for ui in range(n):
                    stride = 2 if (ui == 0 and si > 0) else 1
                    f.add(_Unit(out_ch, stride, bottleneck,
                                match_dims=(stride == 1 and in_ch == out_ch)))
                    in_ch = out_ch
            f.add(nn.GlobalAvgPool2D())
            f.add(nn.Flatten())
            self.features = f
            self.output = nn.Dense(classes, in_units=in_ch)


class ResNetV1(_ResNet):
    """Reference-signature constructor (block class + explicit layout)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(block is BottleneckV1, list(layers), list(channels),
                         classes=classes, thumbnail=thumbnail, **kwargs)


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Parity: model_zoo.vision.get_resnet (v1 only; no pretrained files)."""
    if num_layers not in _SPECS:
        raise ValueError("Invalid number of layers: %d. Options are %s" % (
            num_layers, sorted(_SPECS)))
    if version != 1:
        raise ValueError("only resnet version 1 is ported")
    if pretrained:
        raise ValueError("pretrained weights are not available in the port")
    bottleneck, units, channels = _SPECS[num_layers]
    return _ResNet(bottleneck, units, channels, **kwargs)


def _factory(depth):
    def make(**kwargs):
        return get_resnet(1, depth, **kwargs)

    make.__name__ = "resnet%d_v1" % depth
    make.__doc__ = "ResNet-%d v1 factory." % depth
    return make


resnet18_v1 = _factory(18)
resnet34_v1 = _factory(34)
resnet50_v1 = _factory(50)
resnet101_v1 = _factory(101)
resnet152_v1 = _factory(152)
