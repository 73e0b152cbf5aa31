"""Gluon Parameter / ParameterDict / Constant (parity:
mxnet_tpu/gluon/parameter.py, python/mxnet/gluon/parameter.py :43, :632).

A Parameter holds one NDArray per context.  Shapes with unknown (0)
dimensions defer initialization to the first forward, which infers them
from the input.  ``ParameterDict.save``/``load`` write and read full
parameter names through ``nd.save`` (npz) and ``nd.load`` (either
format); the arrays are read on the host and copied to each parameter's
contexts.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, cpu, current_context
from ..ndarray.ndarray import NDArray, array
from .. import initializer
from .. import autograd

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict"]


class DeferredInitializationError(MXNetError):
    pass


def _shape_known(shape):
    return shape is not None and all(s is not None and s > 0 for s in shape)


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True, stype="default", grad_stype="default"):
        self._data = None  # OrderedDict ctx -> NDArray
        self._grad = None
        self.name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = grad_req if differentiable else "null"
        # the storage types are recorded; data and gradient stay dense, as
        # in the JAX package (row_sparse_data returns the dense data)
        self._stype = stype
        self._grad_stype = grad_stype
        self._deferred_init = ()

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                      self.dtype)

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        unknown_ok = all(s1 in (0, None) or s1 == s2
                         for s1, s2 in zip(self._shape, new_shape))
        if not (len(self._shape) == len(new_shape) and unknown_ok):
            raise MXNetError("cannot reset shape %s -> %s for %s"
                             % (self._shape, new_shape, self.name))
        self._shape = tuple(new_shape)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
        elif self._data is not None:
            self._init_grad()

    # -- init ----------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        default_init = default_init or initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = [current_context()]
        if isinstance(ctx, Context):
            ctx = [ctx]
        if init is None:
            init = default_init if self.init is None else self.init
        if not _shape_known(self._shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init, None)
                return
            raise MXNetError("Cannot initialize Parameter '%s' because it "
                             "has invalid shape %s." % (self.name,
                                                        self._shape))
        self._deferred_init = (init, ctx, default_init, None)
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        if not self._deferred_init:
            return
        init, ctx, default_init, data = self._deferred_init
        self._deferred_init = ()
        if not _shape_known(self._shape):
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred (shape=%s)." % (self.name,
                                                             self._shape))
        with autograd.pause():
            if data is None:
                data = NDArray(torch.zeros(self._shape,
                                           dtype=torch_dtype(self.dtype),
                                           device=ctx[0].torch_device))
                chosen = init if init is not None else (
                    self.init if self.init is not None else default_init)
                if isinstance(chosen, str):
                    chosen = initializer.create(chosen)
                chosen(initializer.InitDesc(self.name), data)
            self._init_impl(data, ctx)

    def _init_impl(self, data, ctx_list):
        self._data = OrderedDict()
        for ctx in ctx_list:
            self._data[ctx] = data if ctx == data.context \
                else data.copyto(ctx)
        self._init_grad()

    def _init_grad(self):
        if self._grad_req == "null":
            self._grad = None
            return
        self._grad = OrderedDict()
        for ctx, d in self._data.items():
            g = NDArray(torch.zeros_like(d._data.detach()))
            self._grad[ctx] = g
            autograd.mark_variables([d], [g], grad_reqs=self._grad_req)

    # -- accessors -------------------------------------------------------------
    def _check_and_get(self, arr_dict, ctx):
        if arr_dict is not None:
            if ctx is list:
                return list(arr_dict.values())
            if ctx is None:
                if len(arr_dict) == 1:
                    return list(arr_dict.values())[0]
                ctx = current_context()
            if ctx in arr_dict:
                return arr_dict[ctx]
            raise MXNetError("Parameter '%s' was not initialized on context "
                             "%s." % (self.name, ctx))
        if self._deferred_init:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet." % self.name)
        raise MXNetError("Parameter '%s' has not been initialized. You "
                         "should call .initialize() first." % self.name)

    def data(self, ctx=None):
        return self._check_and_get(self._data, ctx)

    def list_data(self):
        return self._check_and_get(self._data, list)

    def row_sparse_data(self, row_id):
        """The data for the rows ``row_id`` (parity: mxnet_tpu/gluon/
        parameter.py:281): the whole dense data, as there."""
        return self.data()

    def list_row_sparse_data(self, row_id):
        return self.list_data()

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise MXNetError("Parameter '%s' does not have gradients "
                             "(grad_req='null')" % self.name)
        return self._check_and_get(self._grad, ctx)

    def list_grad(self):
        if self._data is not None and self._grad is None:
            raise MXNetError("Parameter '%s' does not have gradients"
                             % self.name)
        return self._check_and_get(self._grad, list)

    def list_ctx(self):
        if self._data is None:
            if self._deferred_init:
                return self._deferred_init[1]
            raise MXNetError("Parameter '%s' not initialized" % self.name)
        return list(self._data.keys())

    def set_data(self, data):
        """Overwrite every replica (a deferred parameter takes ``data`` as
        its initial value and finishes initializing)."""
        self.shape = data.shape
        if self._data is None:
            if not self._deferred_init:
                raise MXNetError("Parameter '%s' has not been initialized"
                                 % self.name)
            init, ctx, default_init, _ = self._deferred_init
            self._deferred_init = (init, ctx, default_init,
                                   data if isinstance(data, NDArray)
                                   else array(data, ctx=ctx[0]))
            self._finish_deferred_init()
            return
        src = data._data if isinstance(data, NDArray) \
            else torch.as_tensor(np.asarray(data))
        for d in self.list_data():
            d._rebind(src.to(d._data.device, d._data.dtype, copy=True))

    def _load_value(self, value, ctx=None):
        """Take ``value`` (a host NDArray) as the data; an uninitialized
        parameter is initialized from it on ``ctx`` (default: its deferred
        contexts, else the current context)."""
        self.shape = value.shape
        if self._data is None:
            value = NDArray(value._data.to(torch_dtype(self.dtype)))
            if self._deferred_init:
                init, dctx, default_init, _ = self._deferred_init
                ctx = ctx or dctx
            else:
                init = default_init = None
            if isinstance(ctx, Context):
                ctx = [ctx]
            self._deferred_init = (init, ctx or [current_context()],
                                   default_init, value)
            self._finish_deferred_init()
            return
        self.set_data(value)

    def _reduce(self):
        """The data averaged over the contexts (parity :312)."""
        data = self.list_data()
        if len(data) == 1:
            return data[0]
        with torch.no_grad():
            out = torch.stack([d._data.to(data[0]._data.device)
                               for d in data]).mean(0)
        return NDArray(out)

    def zero_grad(self):
        """Set every gradient buffer to 0, in place."""
        if self._grad is None:
            return
        with torch.no_grad():
            for g in self._grad.values():
                g._data.zero_()

    def reset_ctx(self, ctx):
        """Move the parameter (its data averaged over the old contexts) to
        ``ctx``, a context or a list of them, with fresh gradients."""
        if isinstance(ctx, Context):
            ctx = [ctx]
        if self._data is not None:
            data = self._reduce()
            with autograd.pause():
                self._init_impl(NDArray(data._data.detach()), ctx)
        elif self._deferred_init:
            init, _, default_init, data = self._deferred_init
            self._deferred_init = (init, ctx, default_init, data)
        else:
            raise MXNetError("Cannot reset context for Parameter '%s' "
                             "because it has not been initialized."
                             % self.name)

    def cast(self, dtype):
        """Cast the data (and new, zero gradients) to ``dtype``."""
        self.dtype = dtype
        if self._data is None:
            return
        with autograd.pause():
            self._data = OrderedDict(
                (ctx, NDArray(d._data.detach().to(torch_dtype(dtype))))
                for ctx, d in self._data.items())
            self._init_grad()

    def var(self):
        """The parameter as a symbol variable of its name, with its shape,
        dtype, multipliers and initializer as attributes (parity:
        mxnet_tpu/gluon/parameter.py:274)."""
        if getattr(self, "_var", None) is None:
            from ..symbol import symbol as _sym

            self._var = _sym.var(self.name, shape=self.shape,
                                 dtype=self.dtype, lr_mult=self.lr_mult,
                                 wd_mult=self.wd_mult, init=self.init)
        return self._var


class Constant(Parameter):
    """A parameter of fixed ``value`` that takes no gradient (parity
    :288)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = array(value, ctx=cpu())
        self.value = value

        class Init(initializer.Initializer):
            def _init_weight(self, _, arr):
                value.copyto(arr)

            _init_default = _init_weight

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=np.dtype(value.dtype).name, init=Init(),
                         differentiable=False)


class ParameterDict:
    """Dict of Parameters with a name prefix and sharing (parity :632)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "{name}(\n{content}\n)".format(
            name=name, content="\n".join("  " + repr(v)
                                         for v in self.values()))

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter ``prefix + name``, made with ``kwargs`` if new.
        For an existing one the keywords merge as the JAX package's do
        (:349-371): a partial shape fills its unknown (0) dimensions, an
        attribute that is None takes the keyword."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape" and v is not None and len(v) == len(existing):
                param._shape = tuple(a if a not in (0, None) else b
                                     for a, b in zip(existing, v))
        return param

    def get_constant(self, name, value=None):
        """The constant ``prefix + name``, made from ``value`` if new."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError("No constant named '%s'" % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError("Cannot update self with other because they "
                                 "have different Parameters with the same "
                                 "name '%s'" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        default = init or initializer.Uniform()
        if verbose and init is not None:
            init.set_verbosity(verbose=verbose)
        for v in self.values():
            v.initialize(None, ctx, default, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self.values():
            v.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` of every parameter (``lr_mult``,
        ``grad_req``, ...)."""
        for v in self.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=""):
        """Save every parameter's data (averaged over its contexts) under
        its name less ``strip_prefix``."""
        from ..ndarray import ndarray as _nd

        arg_dict = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise MXNetError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with it"
                    % (strip_prefix, param.name))
            arg_dict[param.name[len(strip_prefix):]] = param._reduce()
        _nd.save(filename, arg_dict)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load the parameters saved by ``save`` (names prefixed with
        ``restore_prefix``); an uninitialized one is initialized on
        ``ctx`` (default: the current context) from the file's value."""
        from ..ndarray import ndarray as _nd

        arg_dict = _nd.load(filename, ctx=cpu())
        if not isinstance(arg_dict, dict):
            raise MXNetError("load expects a dict-saved file")
        arg_dict = {restore_prefix + k: v for k, v in arg_dict.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in arg_dict:
                    raise MXNetError("Parameter '%s' is missing in file "
                                     "'%s'" % (name, filename))
        for name, value in arg_dict.items():
            if name not in self._params:
                if not ignore_extra:
                    raise MXNetError(
                        "Parameter '%s' loaded from file '%s' is not "
                        "present in ParameterDict" % (name, filename))
                continue
            self._params[name]._load_value(value, ctx)
