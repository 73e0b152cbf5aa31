"""mx.nd namespace: NDArray plus one function per registered op,
generated from the op registry (parity: mxnet_tpu/ndarray/__init__.py).
This module is also the ``F`` that ``hybrid_forward`` receives."""
from ..ops import tensor as _ops_tensor  # noqa: F401 (registers ops)
from ..ops import nn as _ops_nn  # noqa: F401 (registers ops)
from ..ops.registry import list_ops as _list_ops
from ..ops.utils import scalar_or_array as _soa

from .ndarray import NDArray, array, zeros, ones, arange, _invoke_nd
from . import register as _register

_register.populate(globals())

maximum = _soa(NDArray, _invoke_nd, "broadcast_maximum", "_maximum_scalar")
minimum = _soa(NDArray, _invoke_nd, "broadcast_minimum", "_minimum_scalar")
hypot = _soa(NDArray, _invoke_nd, "broadcast_hypot", "_hypot_scalar")

__all__ = ["NDArray", "array", "zeros", "ones", "arange", "maximum",
           "minimum", "hypot"] + _list_ops()
