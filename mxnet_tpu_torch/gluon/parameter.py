"""Gluon Parameter / ParameterDict (parity: mxnet_tpu/gluon/parameter.py,
python/mxnet/gluon/parameter.py :43, :632).

A Parameter holds one NDArray per context.  Shapes with unknown (0)
dimensions defer initialization to the first forward, which infers them
from the input.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import Context, current_context
from ..ndarray.ndarray import NDArray, array
from .. import initializer
from .. import autograd

__all__ = ["DeferredInitializationError", "Parameter", "ParameterDict"]


class DeferredInitializationError(MXNetError):
    pass


def _shape_known(shape):
    return shape is not None and all(s is not None and s > 0 for s in shape)


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None, allow_deferred_init=False,
                 differentiable=True):
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
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
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
        for v in self.values():
            v.initialize(None, ctx, default, force_reinit=force_reinit)
