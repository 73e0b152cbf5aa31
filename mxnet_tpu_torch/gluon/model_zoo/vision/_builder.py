"""Shared builders for the vision model zoo (parity:
mxnet_tpu/gluon/model_zoo/vision/_builder.py:19-63)."""
from __future__ import annotations

from ....base import MXNetError
from ... import nn
from ...block import HybridBlock

__all__ = ["conv_block", "Classifier", "stack", "check_pretrained"]


def conv_block(channels, kernel, stride=1, pad=None, groups=1, act="relu",
               use_bn=True, bias=False, bn_eps=1e-5, relu6=False):
    """conv -> [BN] -> [activation] as one HybridSequential.  ``pad=None``
    is k//2; ``relu6`` clips the activation at 6 (the MobileNets)."""
    if pad is None:
        pad = kernel // 2
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                      padding=pad, groups=groups, use_bias=bias))
    if use_bn:
        seq.add(nn.BatchNorm(epsilon=bn_eps))
    if act:
        if relu6:
            seq.add(nn.HybridLambda(
                lambda F, x: F.clip(F.relu(x), 0.0, 6.0), prefix="relu6_"))
        else:
            seq.add(nn.Activation(act))
    return seq


def stack(*layers):
    """Compose layers or blocks into a HybridSequential."""
    seq = nn.HybridSequential(prefix="")
    for layer in layers:
        seq.add(layer)
    return seq


def check_pretrained(pretrained):
    """``pretrained=True`` needs model_store.py, which downloads the
    weights; it is not ported."""
    if pretrained:
        raise MXNetError("pretrained weights are not ported yet "
                         "(model_store.py downloads them)")


class Classifier(HybridBlock):
    """features -> output, the zoo-wide network shape (``.features`` and
    ``.output``, as fine-tuning code expects)."""

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)
