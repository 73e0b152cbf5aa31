"""Carry parameters across from numpy arrays keyed by gluon name.

The JAX package's weights cross as ``{p.name: p.data().asnumpy() for p in
net.collect_params().values()}`` (running stats included); the two
packages never share a random stream, so numpy is the only common ground.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["load_from_numpy"]


def load_from_numpy(block, arrays):
    """Set every parameter of ``block`` from ``arrays`` ({name: ndarray}).
    Raises MXNetError on a missing or extra name or a shape mismatch; a
    parameter whose shape was deferred takes the array's shape."""
    params = block.collect_params()
    missing = sorted(set(params.keys()) - set(arrays))
    extra = sorted(set(arrays) - set(params.keys()))
    if missing or extra:
        raise MXNetError("load_from_numpy: missing %s, extra %s"
                         % (missing, extra))
    for name, p in params.items():
        value = arrays[name]
        known = p.shape is not None and all(s > 0 for s in p.shape)
        if known and tuple(p.shape) != tuple(value.shape):
            raise MXNetError("load_from_numpy: %s has shape %s, array %s"
                             % (name, p.shape, tuple(value.shape)))
        p.set_data(value)
