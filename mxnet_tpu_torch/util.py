"""Misc utilities (parity: mxnet_tpu/util.py:13-61,
python/mxnet/util.py): the card count and memory, and the numpy-shape
switches."""
from __future__ import annotations

import functools
import os

import torch

from .base import MXNetError

__all__ = ["makedirs", "get_gpu_count", "get_gpu_memory", "use_np_shape",
           "is_np_shape", "set_np_shape", "wraps_safely"]


def makedirs(d):
    os.makedirs(os.path.expanduser(d), exist_ok=True)


def get_gpu_count():
    return torch.cuda.device_count()


def get_gpu_memory(gpu_dev_id=0):
    """(free, total) bytes of card ``gpu_dev_id``, as upstream's
    ``gpu_memory_info`` (``torch.cuda.mem_get_info``)."""
    if gpu_dev_id >= torch.cuda.device_count():
        raise MXNetError("gpu(%d) requested but %d CUDA device(s) exist"
                         % (gpu_dev_id, torch.cuda.device_count()))
    return torch.cuda.mem_get_info(gpu_dev_id)


_np_shape = False


def set_np_shape(active):
    global _np_shape
    prev = _np_shape
    _np_shape = bool(active)
    return prev


def is_np_shape():
    return _np_shape


def use_np_shape(func):
    @functools.wraps(func)
    def _with_np_shape(*args, **kwargs):
        prev = set_np_shape(True)
        try:
            return func(*args, **kwargs)
        finally:
            set_np_shape(prev)

    return _with_np_shape


def wraps_safely(wrapped, assigned=functools.WRAPPER_ASSIGNMENTS):
    return functools.wraps(wrapped, assigned=assigned)
