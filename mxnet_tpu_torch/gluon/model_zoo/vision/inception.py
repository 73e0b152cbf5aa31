"""Inception v3 (Szegedy et al. 1512.00567).

Parity: mxnet_tpu/gluon/model_zoo/vision/inception.py, after the reference's
python/mxnet/gluon/model_zoo/vision/inception.py.
Each inception module is a *branch table*: a list of conv-chain specs
(or a pool marker) concatenated on channels — one generic module class
interprets every variant (A/B/C/D/E), instead of one builder per letter.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._builder import Classifier, load_pretrained

__all__ = ["Inception3", "inception_v3"]


def _conv(ch, kernel, stride=1, pad=0):
    """conv-BN-relu with possibly asymmetric kernels (e.g. 1x7)."""
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(ch, kernel_size=kernel, strides=stride, padding=pad,
                      use_bias=False))
    seq.add(nn.BatchNorm(epsilon=0.001))
    seq.add(nn.Activation("relu"))
    return seq


class _Module(HybridBlock):
    """Concat of branches; each branch is a chain of conv specs
    (ch, kernel, stride, pad) or the string 'avgpool'/'maxpool'."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        self._n = len(branches)
        with self.name_scope():
            for i, chain in enumerate(branches):
                seq = nn.HybridSequential(prefix="branch%d_" % i)
                for step in chain:
                    if step == "avgpool":
                        seq.add(nn.AvgPool2D(pool_size=3, strides=1,
                                             padding=1))
                    elif step == "maxpool":
                        seq.add(nn.MaxPool2D(pool_size=3, strides=2))
                    else:
                        seq.add(_conv(*step))
                setattr(self, "branch%d" % i, seq)

    def hybrid_forward(self, F, x):
        outs = [getattr(self, "branch%d" % i)(x) for i in range(self._n)]
        return F.concat(*outs, dim=1)


def _a(pool_ch):  # 35x35 modules
    return _Module([
        [(64, 1)],
        [(48, 1), (64, 5, 1, 2)],
        [(64, 1), (96, 3, 1, 1), (96, 3, 1, 1)],
        ["avgpool", (pool_ch, 1)],
    ])


def _b():  # 35->17 reduction
    return _Module([
        [(384, 3, 2)],
        [(64, 1), (96, 3, 1, 1), (96, 3, 2)],
        ["maxpool"],
    ])


def _c(mid):  # 17x17 modules with factorized 7x7
    return _Module([
        [(192, 1)],
        [(mid, 1), (mid, (1, 7), 1, (0, 3)), (192, (7, 1), 1, (3, 0))],
        [(mid, 1), (mid, (7, 1), 1, (3, 0)), (mid, (1, 7), 1, (0, 3)),
         (mid, (7, 1), 1, (3, 0)), (192, (1, 7), 1, (0, 3))],
        ["avgpool", (192, 1)],
    ])


def _d():  # 17->8 reduction
    return _Module([
        [(192, 1), (320, 3, 2)],
        [(192, 1), (192, (1, 7), 1, (0, 3)), (192, (7, 1), 1, (3, 0)),
         (192, 3, 2)],
        ["maxpool"],
    ])


class _SplitBranch(HybridBlock):
    """E-module sub-branch: a stem then two parallel convs concatenated
    (the 3x3 -> {1x3, 3x1} expansion)."""

    def __init__(self, stem_specs, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.stem = nn.HybridSequential(prefix="stem_")
            for spec in stem_specs:
                self.stem.add(_conv(*spec))
            self.left = _conv(384, (1, 3), 1, (0, 1))
            self.right = _conv(384, (3, 1), 1, (1, 0))

    def hybrid_forward(self, F, x):
        x = self.stem(x)
        return F.concat(self.left(x), self.right(x), dim=1)


class _E(HybridBlock):  # 8x8 modules
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.branch0 = _conv(320, 1)
            self.branch1 = _SplitBranch([(384, 1)])
            self.branch2 = _SplitBranch([(448, 1), (384, 3, 1, 1)])
            self.branch3 = nn.HybridSequential(prefix="branch3_")
            self.branch3.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
            self.branch3.add(_conv(192, 1))

    def hybrid_forward(self, F, x):
        return F.concat(self.branch0(x), self.branch1(x), self.branch2(x),
                        self.branch3(x), dim=1)


class Inception3(Classifier):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            f.add(_conv(32, 3, 2))
            f.add(_conv(32, 3))
            f.add(_conv(64, 3, 1, 1))
            f.add(nn.MaxPool2D(pool_size=3, strides=2))
            f.add(_conv(80, 1))
            f.add(_conv(192, 3))
            f.add(nn.MaxPool2D(pool_size=3, strides=2))
            for pool_ch in (32, 64, 64):
                f.add(_a(pool_ch))
            f.add(_b())
            for mid in (128, 160, 160, 192):
                f.add(_c(mid))
            f.add(_d())
            f.add(_E(), _E())
            f.add(nn.AvgPool2D(pool_size=8))
            f.add(nn.Dropout(0.5))
            self.features = f
            self.output = nn.Dense(classes)


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """Parity: model_zoo.vision.inception_v3 (input 299x299)."""
    return load_pretrained(Inception3(**kwargs), pretrained, "inceptionv3",
                           ctx, root)
