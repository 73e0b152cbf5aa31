"""Gluon layers of the slice (parity: mxnet_tpu/gluon/nn/)."""
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
