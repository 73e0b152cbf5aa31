"""Gluon: the imperative NN API (parity: mxnet_tpu/gluon/)."""
from .parameter import Parameter, ParameterDict  # noqa: F401
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import model_zoo  # noqa: F401
from . import utils  # noqa: F401
from . import data  # noqa: F401
from . import rnn  # noqa: F401
from . import contrib  # noqa: F401
