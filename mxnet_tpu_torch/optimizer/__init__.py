"""Optimizers (parity: mxnet_tpu/optimizer/)."""
from .optimizer import *  # noqa: F401,F403
from .optimizer import Optimizer, SGD, Updater, create, get_updater  # noqa: F401
