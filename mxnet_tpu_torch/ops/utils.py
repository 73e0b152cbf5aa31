"""Attribute parsers shared by the op bodies (parity: mxnet_tpu/ops/utils.py).

Attributes arrive as Python objects from ``mx.nd`` or as strings (a
symbol's JSON), so every op normalizes them through these helpers.
"""
from __future__ import annotations

import ast

import numpy as np
import torch

from ..base import torch_dtype


def pbool(v, default=False):
    if v is None:
        return default
    if isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    return bool(v)


def pint(v, default=None):
    if v is None:
        return default
    return int(v)


def pfloat(v, default=None):
    if v is None:
        return default
    return float(v)


def ptuple(v, ndim=None, default=None):
    """Parse a shape-like attr: accepts tuple/list/int/str '(2, 2)'."""
    if v is None:
        return default
    if isinstance(v, str):
        v = v.strip()
        if v in ("None", ""):
            return default
        v = ast.literal_eval(v)
    if isinstance(v, (int, np.integer)):
        v = (int(v),)
    t = tuple(int(x) for x in v)
    if ndim is not None and len(t) == 1 and ndim > 1:
        t = t * ndim
    return t


def pdtype(v, default=torch.float32):
    """A dtype attr (name, numpy or torch dtype) as a ``torch.dtype``."""
    if v is None:
        return default
    return torch_dtype(v)


def paxis(v, default=None):
    """Parse an axis attr that may be int, tuple, None or their strings."""
    if v is None or (isinstance(v, str) and v.strip() in ("None", "")):
        return default
    if isinstance(v, str):
        v = ast.literal_eval(v.strip())
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return int(v)


def normalize_axis(axis, ndim):
    if axis < 0:
        axis += ndim
    return axis


def scalar_or_array(array_type, invoke, broadcast_op, scalar_op):
    """A reference-style maximum/minimum/hypot: array-array -> the
    broadcast op, array-scalar -> the scalar op (commutative ops only)."""

    def fn(lhs, rhs):
        if isinstance(lhs, array_type) and isinstance(rhs, array_type):
            return invoke(broadcast_op, [lhs, rhs], {})
        if isinstance(lhs, array_type):
            return invoke(scalar_op, [lhs], {"scalar": float(rhs)})
        if isinstance(rhs, array_type):
            return invoke(scalar_op, [rhs], {"scalar": float(lhs)})
        raise TypeError("need at least one %s argument"
                        % array_type.__name__)

    fn.__name__ = broadcast_op.replace("broadcast_", "")
    return fn
