"""mx.nd namespace: NDArray plus one function per registered op,
generated from the op registry (parity: mxnet_tpu/ndarray/__init__.py).
This module is also the ``F`` that ``hybrid_forward`` receives."""
from ..ops import tensor as _ops_tensor  # noqa: F401 (registers ops)
from ..ops import nn as _ops_nn  # noqa: F401 (registers ops)
from ..ops import extended as _ops_extended  # noqa: F401 (registers ops)
from ..ops import optimizer_ops as _ops_opt  # noqa: F401 (registers ops)
from ..ops import random_ops as _ops_random  # noqa: F401 (registers ops)
from ..ops import fused as _ops_fused  # noqa: F401 (registers ops)
from ..ops import control_flow as _ops_cf  # noqa: F401 (registers ops)
from ..ops import contrib_ops as _ops_contrib  # noqa: F401 (registers ops)
from ..ops import ssd_ops as _ops_ssd  # noqa: F401 (registers ops)
from ..ops import deformable as _ops_def  # noqa: F401 (registers ops)
from ..ops import quantization as _ops_quant  # noqa: F401 (registers ops)
from .. import operator as _operator  # noqa: F401 (registers Custom)
from ..ops.registry import list_ops as _list_ops
from ..ops.utils import scalar_or_array as _soa

from .ndarray import (  # noqa: F401
    NDArray, array, zeros, ones, empty, full, arange, concatenate, concat,
    stack, moveaxis, onehot_encode, waitall, save, load, _invoke_nd,
)
from . import register as _register
from . import sparse  # noqa: F401 (registers _csr_matmul)
from .sparse import csr_matrix, row_sparse_array  # noqa: F401

_register.populate(globals())
sparse.nd_overrides(globals())

maximum = _soa(NDArray, _invoke_nd, "broadcast_maximum", "_maximum_scalar")
minimum = _soa(NDArray, _invoke_nd, "broadcast_minimum", "_minimum_scalar")
hypot = _soa(NDArray, _invoke_nd, "broadcast_hypot", "_hypot_scalar")
# Custom-op surface: orders kwarg inputs by the prop's declared argument
# names (mx.operator)
Custom = _operator.make_nd_custom()


def __getattr__(name):
    # mx.nd.contrib is mx.contrib.ndarray, imported on first use (it
    # imports this module)
    if name == "contrib":
        from ..contrib import ndarray as _contrib_nd
        return _contrib_nd
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "concatenate", "concat", "stack", "moveaxis", "onehot_encode",
           "waitall", "save", "load", "maximum", "minimum",
           "hypot", "sparse", "csr_matrix", "row_sparse_array"] + _list_ops()
