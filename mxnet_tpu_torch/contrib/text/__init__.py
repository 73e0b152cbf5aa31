"""mx.contrib.text (parity: mxnet_tpu/contrib/text/)."""
from . import embedding  # noqa: F401
from . import utils  # noqa: F401
from . import vocab  # noqa: F401
from .vocab import Vocabulary  # noqa: F401
