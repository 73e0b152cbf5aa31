"""``mx.sym.contrib`` (parity: mxnet_tpu/contrib/symbol.py; the
reference's generated mx.sym.contrib namespace): each ``_contrib_*``
registry op under its short and its full name, and the symbolic
foreach, while_loop and cond."""
from ..symbol.symbol import _invoke_sym as _inv
from ..ops.registry import list_ops as _list_ops
from ..ops.control_flow import (sym_foreach as foreach,  # noqa: F401
                                sym_while_loop as while_loop,
                                sym_cond as cond)


def _make(name):
    def fn(*args, **kwargs):
        kwargs.pop("out", None)
        sym_name = kwargs.pop("name", None)
        return _inv(name, list(args), kwargs, name=sym_name)

    fn.__name__ = name
    return fn


for _op in _list_ops():
    if _op.startswith("_contrib_"):
        globals()[_op[len("_contrib_"):]] = _make(_op)
        globals()[_op] = _make(_op)
del _op
