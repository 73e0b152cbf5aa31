"""Carry parameters across from numpy arrays keyed by gluon name.

The JAX package's weights cross as ``{p.name: p.data().asnumpy() for p in
net.collect_params().values()}`` (running stats included); the two
packages never share a random stream, so numpy is the only common ground.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError

__all__ = ["load_from_numpy", "params_from_numpy"]


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


def params_from_numpy(arrays, ctx=None):
    """{name: numpy array} -> {name: NDArray} on ``ctx`` (the current
    context unless given), each keeping its dtype (int8 included): a
    symbolic model's ``arg_params`` / ``aux_params`` (or
    ``quantize_model``'s int8 ones) carried across for ``Module.set_params``
    and ``bind``."""
    from .ndarray.ndarray import array

    return {name: array(np.asarray(value), ctx=ctx,
                        dtype=np.asarray(value).dtype)
            for name, value in arrays.items()}
