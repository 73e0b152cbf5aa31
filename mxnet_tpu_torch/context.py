"""Device context (parity: mxnet_tpu/context.py, python/mxnet/context.py).

A Context names a ``torch.device``: ``gpu(i)`` is ``cuda:i`` and ``cpu()``
is the host.  The implicit context is ``gpu(0)``.  Asking a GPU context
for its device when CUDA is unavailable raises ``MXNetError``; nothing
falls back to the CPU unless the caller passes ``cpu()``.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context"]

_context_stack = threading.local()


class Context:
    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = device_id

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self):
        """The torch.device this context names."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s requested but CUDA is not available; pass mx.cpu() "
                "explicitly to run on the host" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%s requested but only %d CUDA device(s) exist"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    @staticmethod
    def from_device(device):
        """Context of a torch.device."""
        if device.type == "cuda":
            return Context("gpu", device.index or 0)
        return Context("cpu", 0)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        if not hasattr(_context_stack, "stack"):
            _context_stack.stack = []
        _context_stack.stack.append(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        _context_stack.stack.pop()


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    return Context("gpu", device_id)


def current_context():
    """Innermost ``with ctx:`` scope, else ``gpu(0)``."""
    stack = getattr(_context_stack, "stack", None)
    if stack:
        return stack[-1]
    return Context("gpu", 0)
