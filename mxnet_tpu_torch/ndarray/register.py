"""Generation of the ``mx.nd`` op namespace from the op registry (parity:
mxnet_tpu/ndarray/register.py; python/mxnet/ndarray/register.py:31,160).
Each function closes over its registry entry."""
from __future__ import annotations

import inspect

import numpy as np
import torch

from ..ops import registry as _registry
from .ndarray import NDArray, _invoke_nd


def _is_arrayish(x):
    return isinstance(x, (NDArray, np.ndarray, torch.Tensor))


def _param_names(info):
    try:
        sig = inspect.signature(info.fn)
    except (TypeError, ValueError):
        return []
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.POSITIONAL_ONLY)]


def _make_op_func(op_name, info):
    pnames = _param_names(info)

    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        inputs = []
        pos_attrs = []
        attrs = {}
        for a in args:
            if isinstance(a, (list, tuple)) and a \
                    and all(_is_arrayish(x) for x in a):
                inputs.extend(a)
            elif _is_arrayish(a):
                inputs.append(a)
            else:
                pos_attrs.append(a)
        # non-array positionals name the op's parameters that follow its
        # array inputs (the reference generates one signature per op)
        if pos_attrs:
            tail = [n for n in pnames[len(inputs):] if n not in kwargs]
            if len(tail) >= len(pos_attrs):
                attrs.update(zip(tail, pos_attrs))
            else:
                attrs.setdefault("scalar", pos_attrs[0])
        attrs.update(kwargs)
        return _invoke_nd(op_name, inputs, attrs, out=out)

    op_func.__name__ = op_name
    op_func.__doc__ = info.doc
    return op_func


def populate(namespace):
    """Attach one generated function per registered op (aliases too)."""
    for name in _registry.list_ops():
        namespace[name] = _make_op_func(name, _registry.get_op(name))
    return namespace
