"""``mx.nd.contrib`` (parity: mxnet_tpu/contrib/ndarray.py; the
reference's generated mx.nd.contrib namespace): each ``_contrib_*``
registry op under its short and its full name, and the control-flow
functions foreach, while_loop and cond."""
from ..ndarray.ndarray import _invoke_nd as _inv
from ..ops.registry import list_ops as _list_ops
from ..ops.control_flow import foreach, while_loop, cond  # noqa: F401


def _make(name):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        return _inv(name, list(args), kwargs, out=out)

    fn.__name__ = name
    return fn


for _op in _list_ops():
    if _op.startswith("_contrib_"):
        globals()[_op[len("_contrib_"):]] = _make(_op)
        globals()[_op] = _make(_op)
del _op

isnan = _make("isnan")
isinf = _make("isinf")
isfinite = _make("isfinite")
