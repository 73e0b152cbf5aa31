"""Gluon data API (parity: mxnet_tpu/gluon/data/,
python/mxnet/gluon/data/)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
