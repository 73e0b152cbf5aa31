"""Gluon contrib nn layers (parity: mxnet_tpu/gluon/contrib/nn.py; the
reference's python/mxnet/gluon/contrib/nn/basic_layers.py): Concurrent,
HybridConcurrent, Identity, SparseEmbedding, SyncBatchNorm and
PixelShuffle1D/2D/3D."""
from __future__ import annotations

from ..block import Block, HybridBlock, _param_data
from .. import nn as _nn
from ... import ndarray as nd

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


class HybridConcurrent(HybridBlock):
    """Run child blocks on the same input and concat the outputs
    (reference: gluon/contrib/nn/basic_layers.py HybridConcurrent)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis
        self._order = []

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)
            self._order.append(block)

    def hybrid_forward(self, F, x):
        outs = [block(x) for block in self._order]
        return F.concat(*outs, dim=self.axis)


class Concurrent(HybridConcurrent):
    pass


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class SparseEmbedding(Block):
    """Embedding for large vocabularies (reference: basic_layers.py:118).
    The port has no row-sparse storage: the weight and its gradient are
    dense, and the gradient is nonzero only in the rows looked up, as the
    row-sparse one is."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._dtype = dtype
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim),
            init=weight_initializer, dtype=dtype)

    def forward(self, x):
        return nd.Embedding(x, _param_data(self.weight),
                            input_dim=self._input_dim,
                            output_dim=self._output_dim, dtype=self._dtype,
                            sparse_grad=True)

    def __repr__(self):
        return "%s(%d -> %d, %s)" % (self.__class__.__name__,
                                     self._input_dim, self._output_dim,
                                     self._dtype)


class SyncBatchNorm(_nn.BatchNorm):
    """Cross-device BatchNorm (reference: src/operator/contrib/
    sync_batch_norm.cc).  On one card it is BatchNorm over axis 1."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=running_variance_initializer,
                         in_channels=in_channels, **kwargs)


class _PixelShuffle(HybridBlock):
    """Shared sub-pixel shuffle: split the channel axis into
    (C, f_1..f_d), interleave each factor with its spatial axis, and
    merge: one reshape, transpose and reshape (reference:
    basic_layers.py:244, arXiv:1609.05158)."""

    def __init__(self, factor, dims):
        super().__init__()
        try:
            self._factors = (int(factor),) * dims
        except TypeError:
            self._factors = tuple(int(f) for f in factor)
            assert len(self._factors) == dims, \
                "expected %d factors, got %d" % (dims, len(self._factors))

    def hybrid_forward(self, F, x):
        fs = self._factors
        d = len(fs)
        n, c_in = x.shape[0], x.shape[1]
        spatial = x.shape[2:]
        c_out = c_in
        for f in fs:
            c_out //= f
        # (N, C, f1..fd, S1..Sd) -> (N, C, S1, f1, ..., Sd, fd)
        x = x.reshape((n, c_out) + fs + spatial)
        perm = [0, 1]
        for i in range(d):
            perm += [2 + d + i, 2 + i]
        x = x.transpose(perm)
        merged = tuple(s * f for s, f in zip(spatial, fs))
        return x.reshape((n, c_out) + merged)

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__,
                           self._factors if len(self._factors) > 1
                           else self._factors[0])


class PixelShuffle1D(_PixelShuffle):
    """(N, f*C, W) -> (N, C, W*f)."""

    def __init__(self, factor):
        super().__init__(factor, 1)


class PixelShuffle2D(_PixelShuffle):
    """(N, f1*f2*C, H, W) -> (N, C, H*f1, W*f2)."""

    def __init__(self, factor):
        super().__init__(factor, 2)


class PixelShuffle3D(_PixelShuffle):
    """(N, f1*f2*f3*C, D, H, W) -> (N, C, D*f1, H*f2, W*f3)."""

    def __init__(self, factor):
        super().__init__(factor, 3)
