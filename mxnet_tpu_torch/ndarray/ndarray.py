"""NDArray over ``torch.Tensor`` (parity: mxnet_tpu/ndarray/ndarray.py,
python/mxnet/ndarray/ndarray.py).

Only the surface the gluon training slice uses is ported: construction
(``array``, ``zeros``, ``ones``), ``asnumpy``, ``copy``/``copyto``,
``_rebind``, ``+ - *`` with in-place ``+=``, ``attach_grad``/``.grad``,
and ``shape``/``dtype``/``context``.  Operations run with torch's grad
mode on only while ``autograd.record()`` is active.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, numeric_types, numpy_dtype, torch_dtype
from ..context import Context, current_context
from .. import autograd

__all__ = ["NDArray", "array", "zeros", "ones", "apply"]


def _raw(x):
    return x._data if isinstance(x, NDArray) else x


def apply(fn, *args, **kwargs):
    """Run a torch function on NDArray arguments under the recording
    state's grad mode; wrap tensor results (a tuple stays a tuple)."""
    with autograd.grad_mode():
        out = fn(*[_raw(a) for a in args], **kwargs)
    if isinstance(out, tuple):
        return tuple(NDArray(o) for o in out)
    return NDArray(out)


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")

    # numpy operators defer to us
    __array_priority__ = 1000.0

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %r"
                             % type(data))
        self._data = data
        self._grad = None
        self._grad_req = "null"

    # -- properties --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def context(self):
        return Context.from_device(self._data.device)

    ctx = context

    @property
    def grad(self):
        return self._grad

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    # -- mutation ------------------------------------------------------------
    def _rebind(self, new_data):
        """Point this array at new contents (the in-place write of the
        reference).  A marked variable stays a grad-requiring leaf."""
        if not isinstance(new_data, torch.Tensor):
            new_data = torch.as_tensor(np.asarray(new_data),
                                       device=self._data.device)
        new_data = new_data.detach()
        if self._grad is not None and self._data.requires_grad:
            new_data = new_data.requires_grad_(True)
        self._data = new_data
        return self

    # -- conversion ----------------------------------------------------------
    def asnumpy(self):
        return self._data.detach().cpu().numpy()

    def asscalar(self):
        return self.asnumpy().item()

    def copy(self):
        return apply(torch.clone, self)

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        if isinstance(other, NDArray):
            other._rebind(self._data.to(other._data.device,
                                        other._data.dtype, copy=True))
            return other
        raise MXNetError("copyto target must be NDArray or Context")

    def mean(self):
        return apply(torch.mean, self)

    # -- autograd --------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data.detach()))],
            grad_reqs=grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- arithmetic --------------------------------------------------------------
    def _binary(self, other, fn):
        if isinstance(other, NDArray) or isinstance(other, numeric_types):
            return apply(fn, self, other)
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, torch.add)

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, torch.sub)

    def __mul__(self, o):
        return self._binary(o, torch.mul)

    __rmul__ = __mul__

    def __neg__(self):
        return apply(torch.neg, self)

    def __iadd__(self, o):
        """In place, as the reference's ``+=`` (no new buffer)."""
        with torch.no_grad():
            self._data.add_(_raw(o))
        return self


def _ctx_device(ctx):
    return (ctx or current_context()).torch_device


def array(source_array, ctx=None, dtype=None):
    """Copy numpy data (or an NDArray) onto ``ctx`` (default: the current
    context, ``gpu(0)``)."""
    if isinstance(source_array, NDArray):
        src = source_array.asnumpy()
    else:
        src = np.asarray(source_array)
    if dtype is None:
        dtype = src.dtype if src.dtype != np.float64 else np.float32
    return NDArray(torch.tensor(src, dtype=torch_dtype(dtype),
                                device=_ctx_device(ctx)))


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype),
                               device=_ctx_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(torch.ones(shape, dtype=torch_dtype(dtype),
                              device=_ctx_device(ctx)))
