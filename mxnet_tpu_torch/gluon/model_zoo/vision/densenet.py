"""DenseNet 121/161/169/201 (Huang et al. 1608.06993).

Parity: mxnet_tpu/gluon/model_zoo/vision/densenet.py, after the reference's
python/mxnet/gluon/model_zoo/vision/densenet.py.
Each depth is (init features, growth rate, layers-per-block); dense
connectivity is expressed with an explicit concat in the unit's forward
instead of nested Concurrent/Identity wrappers.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._builder import Classifier, load_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]

# depth -> (stem channels, growth rate k, units per dense block)
_SPECS = {121: (64, 32, [6, 12, 24, 16]),
          161: (96, 48, [6, 12, 36, 24]),
          169: (64, 32, [6, 12, 32, 32]),
          201: (64, 32, [6, 12, 48, 32])}


def _bn_relu_conv(channels, kernel):
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.BatchNorm(), nn.Activation("relu"),
            nn.Conv2D(channels, kernel_size=kernel, padding=kernel // 2,
                      use_bias=False))
    return seq


class _DenseUnit(HybridBlock):
    """BN-relu-1x1 (bottleneck to bn_size*k) then BN-relu-3x3 (k new
    feature maps), output concatenated onto the running feature stack."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = nn.HybridSequential(prefix="")
            self.body.add(_bn_relu_conv(bn_size * growth_rate, 1))
            self.body.add(_bn_relu_conv(growth_rate, 3))
            if dropout:
                self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


class DenseNet(Classifier):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            f.add(nn.Conv2D(num_init_features, kernel_size=7, strides=2,
                            padding=3, use_bias=False))
            f.add(nn.BatchNorm(), nn.Activation("relu"))
            f.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            ch = num_init_features
            for bi, n_units in enumerate(block_config):
                for _ in range(n_units):
                    f.add(_DenseUnit(growth_rate, bn_size, dropout))
                ch += n_units * growth_rate
                if bi != len(block_config) - 1:
                    # transition: halve channels and spatial dims
                    ch //= 2
                    f.add(_bn_relu_conv(ch, 1))
                    f.add(nn.AvgPool2D(pool_size=2, strides=2))
            f.add(nn.BatchNorm(), nn.Activation("relu"))
            f.add(nn.GlobalAvgPool2D())
            f.add(nn.Flatten())
            self.features = f
            self.output = nn.Dense(classes)


def _factory(depth):
    def make(pretrained=False, ctx=None, root=None, **kwargs):
        stem, k, blocks = _SPECS[depth]
        return load_pretrained(DenseNet(stem, k, blocks, **kwargs),
                               pretrained, "densenet%d" % depth, ctx, root)

    make.__name__ = "densenet%d" % depth
    make.__doc__ = "DenseNet-%d factory." % depth
    return make


densenet121 = _factory(121)
densenet161 = _factory(161)
densenet169 = _factory(169)
densenet201 = _factory(201)
