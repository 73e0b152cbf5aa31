"""TensorRT toggle surface (parity: mxnet_tpu/contrib/tensorrt.py,
python/mxnet/contrib/tensorrt.py).

The port builds on no TensorRT runtime: the toggle is accepted and
remembered, graph rewriting is a no-op, and ``tensorrt_bind`` raises with
the port's own routes spelled out.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["set_use_tensorrt", "get_use_tensorrt",
           "get_optimized_symbol", "tensorrt_bind"]

_use_tensorrt = False


def set_use_tensorrt(status):
    global _use_tensorrt
    _use_tensorrt = bool(status)


def get_use_tensorrt():
    return _use_tensorrt


def get_optimized_symbol(executor):
    """The bound symbol: the port runs it through ``torch.compile``, so it
    is the optimized graph."""
    return executor._symbol if hasattr(executor, "_symbol") else None


def tensorrt_bind(symbol, ctx, all_params, **kwargs):
    raise MXNetError(
        "TensorRT is not part of the port: bind the symbol normally (the "
        "executor compiles it with torch.compile) or use "
        "contrib.quantization.quantize_model for int8 inference")
