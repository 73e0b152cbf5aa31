"""Gluon contrib (parity: mxnet_tpu/gluon/contrib/; the reference's
python/mxnet/gluon/contrib/): the nn, rnn and data submodules, with the
nn layers also exported flat, as the JAX package does."""
from . import nn
from . import rnn
from . import data
from .nn import (Concurrent, HybridConcurrent, Identity, SparseEmbedding,
                 SyncBatchNorm, PixelShuffle1D, PixelShuffle2D,
                 PixelShuffle3D)

__all__ = ["nn", "rnn", "data", "Concurrent", "HybridConcurrent",
           "Identity", "SparseEmbedding", "SyncBatchNorm",
           "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D"]
