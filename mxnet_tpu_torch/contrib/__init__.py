"""Contrib modules of the port (parity: mxnet_tpu/contrib/)."""
from . import compression  # noqa: F401
from . import quantization  # noqa: F401
