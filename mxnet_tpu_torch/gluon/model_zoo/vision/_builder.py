"""Shared builders for the vision model zoo (parity:
mxnet_tpu/gluon/model_zoo/vision/_builder.py:19-63)."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock

__all__ = ["conv_block", "Classifier", "stack", "load_pretrained"]


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


def load_pretrained(net, pretrained, name, ctx=None, root=None):
    """With ``pretrained``, load ``name``'s weights from the model store
    (a local ``{root}/{name}.params`` or the ``MXNET_GLUON_REPO`` mirror)
    into ``net`` on ``ctx`` (default: the current context)."""
    if pretrained:
        from ..model_store import get_model_file

        net.load_parameters(get_model_file(name, root=root), ctx=ctx)
    return net


class Classifier(HybridBlock):
    """features -> output, the zoo-wide network shape (``.features`` and
    ``.output``, as fine-tuning code expects)."""

    def hybrid_forward(self, F, x):
        x = self.features(x)
        return self.output(x)
