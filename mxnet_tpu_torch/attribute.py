"""Attribute scopes for symbols (parity: mxnet_tpu/attribute.py,
python/mxnet/attribute.py)."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]

_local = threading.local()


class AttrScope:
    def __init__(self, **kwargs):
        self._attr = kwargs

    def get(self, attr):
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        if not hasattr(_local, "stack"):
            _local.stack = [AttrScope()]
        attr = _local.stack[-1]._attr.copy()
        attr.update(self._attr)
        scope = AttrScope(**attr)
        _local.stack.append(scope)
        self._scope = scope
        return self

    def __exit__(self, *a):
        _local.stack.pop()

    @staticmethod
    def current():
        if not hasattr(_local, "stack"):
            _local.stack = [AttrScope()]
        return _local.stack[-1]


def current():
    return AttrScope.current()
