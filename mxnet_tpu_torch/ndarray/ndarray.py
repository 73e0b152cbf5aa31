"""NDArray over ``torch.Tensor`` (parity: mxnet_tpu/ndarray/ndarray.py,
python/mxnet/ndarray/ndarray.py).

Every operation goes through the op registry (``_invoke_nd``), under
torch's grad mode only while ``autograd.record()`` is active.  Ported:
construction (``array``, ``zeros``, ``ones``, ``arange``), ``asnumpy``,
``copy``/``copyto``, ``astype``, ``reshape``, ``transpose``, basic and
array indexing, the arithmetic operators with broadcasting and their
reflected forms, the comparisons (which return the lhs dtype, as the
reference's do), in-place ``+=``, ``attach_grad``/``.grad``, and
``shape``/``dtype``/``context``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, numeric_types, numpy_dtype, torch_dtype
from ..context import Context, current_context
from ..ops.registry import get_op, clean_attrs
from .. import autograd

__all__ = ["NDArray", "array", "zeros", "ones", "arange"]


# 64-bit host data arrives as 32-bit, as in the JAX package (x64 off)
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _as_nd(x, device):
    """NDArray of ``x`` (an NDArray, tensor, numpy array or number) on
    ``device``."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if np.isscalar(x) or isinstance(x, (list, tuple, np.ndarray)):
        a = np.asarray(x)
        a = a.astype(_NARROW.get(a.dtype, a.dtype), copy=False)
        return NDArray(torch.as_tensor(a, device=device))
    raise MXNetError("cannot convert %r to NDArray" % (type(x),))


def _invoke_nd(op_name, inputs, attrs, out=None):
    """Run registry op ``op_name`` on NDArray (or array-like) ``inputs``
    (parity: ndarray.py:708).  A differentiable op runs under the
    recording state's grad mode, so torch autograd records it inside
    ``autograd.record()``; the others run without grad.  Outputs wrap as
    NDArrays (a list for several); ``mutate_inputs`` rebinds the mutated
    inputs to the results."""
    info = get_op(op_name)
    attrs = clean_attrs(attrs)
    anchor = next((x for x in inputs if isinstance(x, NDArray)), None)
    device = anchor._data.device if anchor is not None \
        else (attrs.get("ctx") or current_context()).torch_device
    nd_inputs = [_as_nd(x, device) for x in inputs]
    if info.num_inputs == 0:
        attrs["ctx"] = device
    raw = [x._data for x in nd_inputs]
    try:
        with (autograd.grad_mode() if info.differentiable
              else torch.no_grad()):
            result = info.fn(*raw, **attrs)
    except Exception as e:
        raise MXNetError("error in operator %s: %s" % (op_name, e)) from e
    rets = result if isinstance(result, tuple) else (result,)
    if info.mutate_inputs:
        for idx, r in zip(info.mutate_inputs, rets):
            nd_inputs[idx]._rebind(r)
        main = nd_inputs[info.mutate_inputs[0]]
        if out is not None and out is not main:
            out._rebind(main._data)
            return out
        return main
    outputs = [NDArray(r) for r in rets]
    if out is not None:
        if isinstance(out, (list, tuple)):
            for o, r in zip(out, outputs):
                o._rebind(r._data)
            return list(out)
        out._rebind(outputs[0]._data)
        return out
    return outputs[0] if len(outputs) == 1 else outputs


def _index_key(key, device):
    """An index with NDArrays, lists and numpy arrays as tensors on
    ``device``; the second value says whether it holds an array."""
    if isinstance(key, NDArray):
        return key._data, True
    if isinstance(key, (list, np.ndarray)):
        arr = np.asarray(key) if len(key) else np.asarray(key, np.int64)
        return torch.as_tensor(arr, device=device), True
    if isinstance(key, tuple):
        parts = [_index_key(k, device) for k in key]
        return tuple(p for p, _ in parts), any(a for _, a in parts)
    return key, False


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

    def __len__(self):
        return self.shape[0]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("ambiguous truth value of multi-element NDArray")

    def __hash__(self):
        return id(self)

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

    def astype(self, dtype, copy=True):
        if not copy and self._data.dtype == torch_dtype(dtype):
            return self
        return _invoke_nd("Cast", [self], {"dtype": dtype})

    def copy(self):
        return _invoke_nd("_copy", [self], {})

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        if isinstance(other, NDArray):
            other._rebind(self._data.to(other._data.device,
                                        other._data.dtype, copy=True))
            return other
        raise MXNetError("copyto target must be NDArray or Context")

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return _invoke_nd("mean", [self], {"axis": axis,
                                           "keepdims": keepdims,
                                           "exclude": exclude})

    def sum(self, axis=None, keepdims=False, exclude=False):
        return _invoke_nd("sum", [self], {"axis": axis,
                                          "keepdims": keepdims,
                                          "exclude": exclude})

    # -- shape -----------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return _invoke_nd("Reshape", [self],
                          {"shape": shape,
                           "reverse": kwargs.get("reverse", False)})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _invoke_nd("transpose", [self], {"axes": axes or None})

    def __getitem__(self, key):
        key, has_array = _index_key(key, self._data.device)
        if has_array and isinstance(key, torch.Tensor):
            return _invoke_nd("_index_array", [self, NDArray(key)], {})
        # basic indexing, or a tuple mixing arrays and slices: torch
        # records either
        return _invoke_nd("_index_static", [self], {"key": key})

    # -- autograd --------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        autograd.mark_variables(
            [self], [NDArray(torch.zeros_like(self._data.detach()))],
            grad_reqs=grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- arithmetic --------------------------------------------------------------
    def _binop(self, other, op_nd, op_sc, reverse=False):
        if isinstance(other, NDArray):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _invoke_nd(op_nd, [lhs, rhs], {})
        if isinstance(other, numeric_types):
            return _invoke_nd(op_sc, [self], {"scalar": float(other)})
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", "_rdiv_scalar", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binop(o, "broadcast_mod", "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binop(o, "broadcast_power", "_rpower_scalar",
                           reverse=True)

    def __neg__(self):
        return _invoke_nd("negative", [self], {})

    def __abs__(self):
        return _invoke_nd("abs", [self], {})

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __iadd__(self, o):
        """In place, as the reference's ``+=`` (no new buffer)."""
        with torch.no_grad():
            self._data.add_(o._data if isinstance(o, NDArray) else o)
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


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """``[start, stop)`` by ``step`` on ``ctx`` (default: the current
    context), float32 unless ``dtype`` says otherwise."""
    return _invoke_nd("_arange", [], {"start": start, "stop": stop,
                                      "step": step, "repeat": repeat,
                                      "dtype": dtype or "float32",
                                      "ctx": ctx})
