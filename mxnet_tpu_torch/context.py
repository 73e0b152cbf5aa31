"""Device context (parity: mxnet_tpu/context.py, python/mxnet/context.py).

A Context names a ``torch.device``: ``gpu(i)`` is ``cuda:i`` and ``cpu()``
is the host.  ``cpu_pinned()`` (device type 3) is the host too: arrays
made on it are page-locked (``pin_memory()``) when a card is present, so
their copies to the card can run asynchronously; without a card they are
plain host arrays.  The implicit context (``default_context()``) is
``gpu(0)``.  Asking a GPU context for its device when CUDA is
unavailable raises ``MXNetError``; nothing falls back to the CPU unless
the caller passes ``cpu()``.  ``tpu`` and ``num_tpus`` stay out: they
name a device this card is not.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "cpu_pinned", "current_context",
           "num_gpus", "default_context", "device"]

_context_stack = threading.local()


class Context:
    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3}

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
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "%s requested but CUDA is not available; pass mx.cpu() "
                "explicitly to run on the host" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("%s requested but only %d CUDA device(s) exist"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def place(self, tensor):
        """``tensor`` (on this context's device) as this context holds
        it: page-locked for ``cpu_pinned`` when a card is present."""
        if self.device_typeid == 3 and torch.cuda.is_available() and \
                not tensor.is_pinned():
            return tensor.pin_memory()
        return tensor

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


def cpu_pinned(device_id=0):
    """Page-locked host memory (module doc)."""
    return Context("cpu_pinned", device_id)


# ``device`` alias matching later-mxnet naming
device = Context


def num_gpus():
    """The number of CUDA cards torch sees."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_context():
    """The implicit context: ``gpu(0)``.  The JAX package answers the
    host when it sees no accelerator; the port keeps the card, and a
    host run names ``cpu()`` (module doc)."""
    return Context("gpu", 0)


def current_context():
    """Innermost ``with ctx:`` scope, else :func:`default_context`."""
    stack = getattr(_context_stack, "stack", None)
    if stack:
        return stack[-1]
    return default_context()
