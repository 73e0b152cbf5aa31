"""Base types for the PyTorch/CUDA port (parity: mxnet_tpu/base.py,
python/mxnet/base.py)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["MXNetError", "numeric_types", "torch_dtype", "numpy_dtype",
           "_Null"]


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


numeric_types = (float, int, np.generic)


class _NullType:
    """Placeholder for a missing keyword (parity: mxnet.base._Null)."""

    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "_Null"

    def __bool__(self):
        return False


_Null = _NullType()

_NP_TO_TORCH = {
    np.dtype("float32"): torch.float32,
    np.dtype("float64"): torch.float64,
    np.dtype("float16"): torch.float16,
    np.dtype("uint8"): torch.uint8,
    np.dtype("int8"): torch.int8,
    np.dtype("int32"): torch.int32,
    np.dtype("int64"): torch.int64,
    np.dtype("bool"): torch.bool,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def torch_dtype(dtype):
    """numpy dtype / dtype name / torch dtype -> torch dtype (None -> f32).
    Names numpy lacks, such as ``"bfloat16"``, resolve through torch."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _NP_TO_TORCH[np.dtype(dtype)]
    except (KeyError, TypeError) as e:
        named = getattr(torch, dtype, None) if isinstance(dtype, str) \
            else None
        if isinstance(named, torch.dtype):
            return named
        raise MXNetError("unsupported dtype %r" % (dtype,)) from e


def numpy_dtype(dtype):
    """torch dtype -> numpy scalar type (what NDArray.dtype reports)."""
    return _TORCH_TO_NP[dtype].type
