"""Model zoo (parity: mxnet_tpu/gluon/model_zoo/)."""
from . import vision  # noqa: F401
