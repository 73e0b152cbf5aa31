"""ResNet v1/v2 (He et al. 1512.03385, 1603.05027).

Parity: mxnet_tpu/gluon/model_zoo/vision/resnet.py, after the reference's
python/mxnet/gluon/model_zoo/vision/resnet.py — same
factory names, same layer counts/channel schedule, same `.features` /
`.output` contract.  Construction here is a spec table interpreted by a
single unified residual unit, not per-variant block classes.
"""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ._builder import Classifier, conv_block, load_pretrained

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
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
    """One residual unit, covering all four (version, bottleneck) combos.

    v1: relu(x + body(x)) with post-activation convs; the bottleneck's
        1x1 convs carry a bias (upstream quirk kept for param parity) and
        the stride sits on the leading 1x1.
    v2: pre-activation (BN-relu first; the projection shortcut taps the
        pre-activated tensor); the bottleneck's stride sits on the middle
        3x3 per He et al. 1603.05027.
    """

    def __init__(self, channels, stride, version, bottleneck,
                 match_dims, **kwargs):
        super().__init__(**kwargs)
        self._version = version
        mid = channels // 4 if bottleneck else channels
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            if version == 2:
                self.pre = nn.HybridSequential(prefix="")
                self.pre.add(nn.BatchNorm(), nn.Activation("relu"))
            # conv plan rows: (channels, kernel, stride, biased?)
            if bottleneck and version == 1:
                plan = [(mid, 1, stride, True), (mid, 3, 1, False),
                        (channels, 1, 1, True)]
            elif bottleneck:
                plan = [(mid, 1, 1, False), (mid, 3, stride, False),
                        (channels, 1, 1, False)]
            else:
                plan = [(mid, 3, stride, False), (channels, 3, 1, False)]
            for i, (ch, k, s, biased) in enumerate(plan):
                last = i == len(plan) - 1
                if version == 1:
                    self.body.add(conv_block(ch, k, s, bias=biased,
                                             act=None if last else "relu"))
                else:
                    if i > 0:  # first conv is fed by self.pre
                        self.body.add(nn.BatchNorm(), nn.Activation("relu"))
                    self.body.add(nn.Conv2D(ch, kernel_size=k, strides=s,
                                            padding=k // 2, use_bias=False))
            if match_dims:
                self.shortcut = None
            elif version == 1:
                self.shortcut = conv_block(channels, 1, stride, act=None)
            else:
                self.shortcut = nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False)

    def hybrid_forward(self, F, x):
        if self._version == 2:
            pre = self.pre(x)
            res = x if self.shortcut is None else self.shortcut(pre)
            return res + self.body(pre)
        res = x if self.shortcut is None else self.shortcut(x)
        return F.relu(res + self.body(x))


# API-compat aliases for the reference's four block classes
class BasicBlockV1(_Unit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, 1, False, not downsample, **kwargs)


class BottleneckV1(_Unit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, 1, True, not downsample, **kwargs)


class BasicBlockV2(_Unit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, 2, False, not downsample, **kwargs)


class BottleneckV2(_Unit):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, 2, True, not downsample, **kwargs)


class _ResNet(Classifier):
    """Interpret a spec (units per stage + channel schedule) into stem,
    unit stages, and a pooled classifier head."""

    def __init__(self, version, bottleneck, units, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        assert len(channels) == len(units) + 1
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            if version == 2:
                # no-affine input normalisation, shared by both stems
                f.add(nn.BatchNorm(scale=False, center=False))
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
                    f.add(_Unit(out_ch, stride, version, bottleneck,
                                match_dims=(stride == 1 and in_ch == out_ch)))
                    in_ch = out_ch
            if version == 2:
                f.add(nn.BatchNorm(), nn.Activation("relu"))
            f.add(nn.GlobalAvgPool2D())
            f.add(nn.Flatten())
            self.features = f
            self.output = nn.Dense(classes, in_units=in_ch)


class ResNetV1(_ResNet):
    """Reference-signature constructor (block class + explicit layout)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(1, block in (BottleneckV1, BottleneckV2),
                         list(layers), list(channels), classes=classes,
                         thumbnail=thumbnail, **kwargs)


class ResNetV2(_ResNet):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(2, block in (BottleneckV1, BottleneckV2),
                         list(layers), list(channels), classes=classes,
                         thumbnail=thumbnail, **kwargs)


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """Parity: model_zoo.vision.get_resnet."""
    if num_layers not in _SPECS:
        raise ValueError("Invalid number of layers: %d. Options are %s" % (
            num_layers, sorted(_SPECS)))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    bottleneck, units, channels = _SPECS[num_layers]
    net = _ResNet(version, bottleneck, units, channels, **kwargs)
    return load_pretrained(net, pretrained,
                           "resnet%d_v%d" % (num_layers, version), ctx, root)


def _factory(version, depth):
    def make(**kwargs):
        return get_resnet(version, depth, **kwargs)

    make.__name__ = "resnet%d_v%d" % (depth, version)
    make.__doc__ = "ResNet-%d v%d factory." % (depth, version)
    return make


resnet18_v1 = _factory(1, 18)
resnet34_v1 = _factory(1, 34)
resnet50_v1 = _factory(1, 50)
resnet101_v1 = _factory(1, 101)
resnet152_v1 = _factory(1, 152)
resnet18_v2 = _factory(2, 18)
resnet34_v2 = _factory(2, 34)
resnet50_v2 = _factory(2, 50)
resnet101_v2 = _factory(2, 101)
resnet152_v2 = _factory(2, 152)
