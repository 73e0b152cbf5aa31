"""mx.contrib.svrg_optimization (parity:
mxnet_tpu/contrib/svrg_optimization/)."""
from .svrg_module import SVRGModule  # noqa: F401
