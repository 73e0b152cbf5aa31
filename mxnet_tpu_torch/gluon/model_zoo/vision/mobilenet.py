"""MobileNet v1 (1704.04861) and v2 (1801.04381), width multipliers
1.0/0.75/0.5/0.25.

Parity: mxnet_tpu/gluon/model_zoo/vision/mobilenet.py, after the reference's
python/mxnet/gluon/model_zoo/vision/mobilenet.py.
v1 is a (channels, stride) table of depthwise-separable units; v2 a
(expansion, channels, stride) table of inverted residuals.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._builder import Classifier, conv_block, load_pretrained

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25",
           "get_mobilenet", "get_mobilenet_v2"]

# v1: (output channels @ multiplier 1.0, stride) per separable unit
_V1_UNITS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
             (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
             (1024, 1)]
# v2: (expansion t, output channels, stride) per inverted-residual unit
_V2_UNITS = [(1, 16, 1),
             (6, 24, 2), (6, 24, 1),
             (6, 32, 2), (6, 32, 1), (6, 32, 1),
             (6, 64, 2), (6, 64, 1), (6, 64, 1), (6, 64, 1),
             (6, 96, 1), (6, 96, 1), (6, 96, 1),
             (6, 160, 2), (6, 160, 1), (6, 160, 1),
             (6, 320, 1)]


def _sep_unit(in_ch, out_ch, stride):
    """Depthwise 3x3 + pointwise 1x1 (the v1 building block)."""
    from ._builder import stack

    return stack(conv_block(in_ch, 3, stride, groups=in_ch),
                 conv_block(out_ch, 1))


class _InvertedResidual(HybridBlock):
    """v2 unit: 1x1 expand (relu6) -> 3x3 depthwise (relu6) -> 1x1
    project (linear); identity add when stride 1 and widths match."""

    def __init__(self, expansion, in_ch, out_ch, stride, **kwargs):
        super().__init__(**kwargs)
        self._residual = stride == 1 and in_ch == out_ch
        mid = in_ch * expansion
        with self.name_scope():
            body = nn.HybridSequential(prefix="")
            # the expansion 1x1 is present even at t=1 (reference
            # LinearBottleneck keeps it unconditionally)
            body.add(conv_block(mid, 1, relu6=True))
            body.add(conv_block(mid, 3, stride, groups=mid, relu6=True))
            body.add(conv_block(out_ch, 1, act=None))
            self.body = body

    def hybrid_forward(self, F, x):
        out = self.body(x)
        return x + out if self._residual else out


def _scaled(ch, multiplier):
    return max(1, int(ch * multiplier))


def _version_suffix(multiplier):
    """Model-store name fragment: 1.0 -> '1.0', 0.75 -> '0.75'."""
    text = "%.2f" % multiplier
    return text[:-1] if text.endswith("0") else text


class MobileNet(Classifier):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            in_ch = _scaled(32, multiplier)
            f.add(conv_block(in_ch, 3, 2))
            for ch, stride in _V1_UNITS:
                out_ch = _scaled(ch, multiplier)
                f.add(_sep_unit(in_ch, out_ch, stride))
                in_ch = out_ch
            f.add(nn.GlobalAvgPool2D())
            f.add(nn.Flatten())
            self.features = f
            self.output = nn.Dense(classes)


class MobileNetV2(Classifier):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            in_ch = _scaled(32, multiplier)
            f.add(conv_block(in_ch, 3, 2, relu6=True))
            for t, ch, stride in _V2_UNITS:
                out_ch = _scaled(ch, multiplier)
                f.add(_InvertedResidual(t, in_ch, out_ch, stride))
                in_ch = out_ch
            last = _scaled(1280, multiplier) if multiplier > 1.0 else 1280
            f.add(conv_block(last, 1, relu6=True))
            f.add(nn.GlobalAvgPool2D())
            self.features = f
            # v2 head: 1x1 conv classifier then flatten
            out = nn.HybridSequential(prefix="output_")
            with out.name_scope():
                out.add(nn.Conv2D(classes, 1, use_bias=False, prefix="pred_"))
                out.add(nn.Flatten())
            self.output = out


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  **kwargs):
    """Parity: model_zoo.vision.get_mobilenet."""
    return load_pretrained(MobileNet(multiplier, **kwargs), pretrained,
                           "mobilenet%s" % _version_suffix(multiplier), ctx,
                           root)


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, root=None,
                     **kwargs):
    """Parity: model_zoo.vision.get_mobilenet_v2."""
    return load_pretrained(MobileNetV2(multiplier, **kwargs), pretrained,
                           "mobilenetv2_%s" % _version_suffix(multiplier),
                           ctx, root)


def _factory(maker, multiplier, name):
    def make(**kwargs):
        return maker(multiplier, **kwargs)

    make.__name__ = name
    make.__doc__ = "%s at width multiplier %s." % (name, multiplier)
    return make


mobilenet1_0 = _factory(get_mobilenet, 1.0, "mobilenet1_0")
mobilenet0_75 = _factory(get_mobilenet, 0.75, "mobilenet0_75")
mobilenet0_5 = _factory(get_mobilenet, 0.5, "mobilenet0_5")
mobilenet0_25 = _factory(get_mobilenet, 0.25, "mobilenet0_25")
mobilenet_v2_1_0 = _factory(get_mobilenet_v2, 1.0, "mobilenet_v2_1_0")
mobilenet_v2_0_75 = _factory(get_mobilenet_v2, 0.75, "mobilenet_v2_0_75")
mobilenet_v2_0_5 = _factory(get_mobilenet_v2, 0.5, "mobilenet_v2_0_5")
mobilenet_v2_0_25 = _factory(get_mobilenet_v2, 0.25, "mobilenet_v2_0_25")
