"""Contrib modules of the port (parity: mxnet_tpu/contrib/; ``onnx``
waits for its own slice)."""
from . import quantization  # noqa: F401
from . import ndarray  # noqa: F401
from . import symbol  # noqa: F401
from . import autograd  # noqa: F401
from . import compression  # noqa: F401
from . import io  # noqa: F401
from . import svrg_optimization  # noqa: F401
from . import tensorboard  # noqa: F401
from . import tensorrt  # noqa: F401
from . import text  # noqa: F401
