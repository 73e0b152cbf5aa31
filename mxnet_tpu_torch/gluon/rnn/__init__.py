"""Gluon's recurrent cells and fused recurrent layers (parity:
mxnet_tpu/gluon/rnn/)."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import *  # noqa: F401,F403
