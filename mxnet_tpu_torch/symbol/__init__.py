"""``mx.sym`` (parity: mxnet_tpu/symbol/__init__.py): the Symbol class,
one generated function per registry op, and the graph-fusion passes
(``symbol/fusion.py``); ``Custom`` invokes a registered custom operator
(``mx.operator``)."""
from .. import ndarray as _nd  # noqa: F401 (registers every op)
from .symbol import (Symbol, var, Variable, Group, load, load_json,  # noqa: F401
                     zeros, ones, pow, _invoke_sym)
from . import register as _register
from . import fusion  # noqa: F401
from .fusion import (fold_batchnorm, fuse_conv_bn_relu,  # noqa: F401
                     apply_fusion, list_patterns)
from ..ops.utils import scalar_or_array as _soa
from .. import operator as _operator

_register.populate(globals())

maximum = _soa(Symbol, _invoke_sym, "broadcast_maximum", "_maximum_scalar")
minimum = _soa(Symbol, _invoke_sym, "broadcast_minimum", "_minimum_scalar")
hypot = _soa(Symbol, _invoke_sym, "broadcast_hypot", "_hypot_scalar")
Custom = _operator.make_sym_custom()


def __getattr__(name):
    # mx.sym.contrib is mx.contrib.symbol, imported on first use (it
    # imports this package)
    if name == "contrib":
        from ..contrib import symbol as _contrib_sym
        return _contrib_sym
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
