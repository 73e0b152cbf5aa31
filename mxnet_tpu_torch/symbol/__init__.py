"""``mx.sym`` (parity: mxnet_tpu/symbol/__init__.py): the Symbol class and
one generated function per registry op.  The graph-fusion passes
(``symbol/fusion.py``) and ``Custom`` are not ported yet."""
from .. import ndarray as _nd  # noqa: F401 (registers every op)
from .symbol import (Symbol, var, Variable, Group, load, load_json,  # noqa: F401
                     zeros, ones, pow, _invoke_sym)
from . import register as _register
from ..ops.utils import scalar_or_array as _soa

_register.populate(globals())

maximum = _soa(Symbol, _invoke_sym, "broadcast_maximum", "_maximum_scalar")
minimum = _soa(Symbol, _invoke_sym, "broadcast_minimum", "_minimum_scalar")
hypot = _soa(Symbol, _invoke_sym, "broadcast_hypot", "_hypot_scalar")
