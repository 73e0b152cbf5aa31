"""Shared builders for the vision model zoo (parity:
mxnet_tpu/gluon/model_zoo/vision/_builder.py)."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["conv_block", "Classifier"]


def conv_block(channels, kernel, stride=1, pad=None, groups=1, act="relu",
               use_bn=True, bias=False, bn_eps=1e-5):
    """conv -> [BN] -> [activation] as one HybridSequential; ``pad=None``
    is k//2."""
    if pad is None:
        pad = kernel // 2
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                      padding=pad, groups=groups, use_bias=bias))
    if use_bn:
        seq.add(nn.BatchNorm(epsilon=bn_eps))
    if act:
        seq.add(nn.Activation(act))
    return seq


class Classifier(HybridBlock):
    """features -> output, the zoo-wide network shape."""

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)
