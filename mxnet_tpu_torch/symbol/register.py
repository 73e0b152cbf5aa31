"""Generation of ``mx.sym`` from the op registry (parity:
mxnet_tpu/symbol/register.py; python/mxnet/symbol/register.py:35,201)."""
from __future__ import annotations

from ..ops import registry as _registry
from .symbol import Symbol, _invoke_sym


def _make_op_func(op_name, info):
    def op_func(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("attr", None)
        inputs = []
        attrs = {}
        for a in args:
            if isinstance(a, Symbol):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a and all(
                    isinstance(x, Symbol) for x in a):
                inputs.extend(a)
            else:
                attrs.setdefault("scalar", a)
        attrs.update(kwargs)
        return _invoke_sym(op_name, inputs, attrs, name=name)

    op_func.__name__ = op_name
    op_func.__doc__ = info.doc
    return op_func


def populate(namespace):
    """Attach one generated function per registered op (aliases too)."""
    for name in _registry.list_ops():
        namespace[name] = _make_op_func(name, _registry.get_op(name))
    return namespace
