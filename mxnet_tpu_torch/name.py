"""Automatic names for top-level blocks (parity: mxnet_tpu/name.py,
python/mxnet/name.py).  ``with NameManager():`` starts a fresh counter,
so ``resnet50_v1()`` built inside one is named ``_resnet0_`` again."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_local = threading.local()


class NameManager:
    def __init__(self):
        self._counter = {}

    def get(self, name, hint):
        if name:
            return name
        hint = hint.lower()
        n = self._counter.get(hint, 0)
        self._counter[hint] = n + 1
        return "%s%d" % (hint, n)

    def __enter__(self):
        if not hasattr(_local, "stack"):
            _local.stack = [NameManager()]
        _local.stack.append(self)
        return self

    def __exit__(self, *a):
        _local.stack.pop()

    @staticmethod
    def current():
        if not hasattr(_local, "stack"):
            _local.stack = [NameManager()]
        return _local.stack[-1]


class Prefix(NameManager):
    """Names with a fixed prefix: a block's scope names the symbol nodes
    its ``hybrid_forward`` makes ``<block prefix><op><n>``."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)


def current():
    return NameManager.current()
