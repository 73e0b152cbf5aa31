"""NDArray over ``torch.Tensor`` (parity: mxnet_tpu/ndarray/ndarray.py,
python/mxnet/ndarray/ndarray.py).

Every operation goes through the op registry (``_invoke_nd``), under
torch's grad mode only while ``autograd.record()`` is active.

Storage follows upstream MXNet: a basic index on the first axis alone
(``x[i]``, or ``x[a:b]`` with step 1) and the ``reshape`` method share
storage with their source, so writing through them writes the source;
every other op, other basic indexes among them, returns an array of its
own (an op whose torch result would alias an input is copied).  The JAX
package shares nothing, its arrays being immutable.

In-place operators (``+=``, ``-=``, ``*=``, ``/=``, ``%=``) and
``x[key] = v`` write into the array's own storage outside ``record()``.
Inside ``record()`` the operators rebind the array to the recorded
result instead, as the JAX package does, so that no tensor autograd
saved for backward is overwritten; ``x[key] = v`` raises there on an
array that takes part in the recorded graph.  An integer index past the
first axis raises ``IndexError``, so iteration stops after the last row
as upstream's does.

``save``/``load`` write and read two formats: npz with ``mxtpu:v1:``
keys, and the reference binary format of ``legacy_io``; a file either
package writes loads in the other.
"""
from __future__ import annotations

import io

import numpy as np
import torch

from ..base import MXNetError, numeric_types, numpy_dtype, torch_dtype
from ..context import Context, current_context
from ..ops.registry import get_op, clean_attrs
from .. import autograd
from .. import engine as _engine

__all__ = ["NDArray", "array", "zeros", "ones", "empty", "full", "arange",
           "concatenate", "concat", "stack", "moveaxis", "onehot_encode",
           "waitall", "save", "load"]


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


def _storage(t):
    return t.untyped_storage().data_ptr()


def _own(r, inputs):
    """``r``, or a contiguous copy of it where it shares storage with one
    of ``inputs`` (a torch view, a detached alias or the input itself).
    A result that is no view and starts at no input's address is fresh,
    and its storage is not looked up (most ops' results)."""
    if r._base is None:
        p = r.data_ptr()
        for x in inputs:
            if p == x.data_ptr():
                break
        else:
            return r
    if r.numel() and any(_storage(r) == _storage(x) for x in inputs):
        return r.clone(memory_format=torch.contiguous_format)
    return r


def _invoke_nd(op_name, inputs, attrs, out=None, view=False):
    """Run registry op ``op_name`` on NDArray (or array-like) ``inputs``
    (parity: ndarray.py:708).  A differentiable op runs under the
    recording state's grad mode, so torch autograd records it inside
    ``autograd.record()``; the others run without grad.  Outputs wrap as
    NDArrays (a list for several) with storage of their own unless
    ``view`` (the first-axis index and ``reshape``); ``mutate_inputs``
    rebinds the mutated inputs to the results.  An op's ``IndexError``
    stays an ``IndexError``; any other error becomes ``MXNetError``."""
    info = get_op(op_name)
    attrs = clean_attrs(attrs)
    # an array given by keyword (CTCLoss's lengths) reaches the op as
    # that keyword's tensor
    attrs = {k: v._data if isinstance(v, NDArray) else v
             for k, v in attrs.items()}
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
    except IndexError as e:
        raise IndexError("error in operator %s: %s" % (op_name, e)) from e
    except Exception as e:
        raise MXNetError("error in operator %s: %s" % (op_name, e)) from e
    eng = _engine.get()
    if eng.is_naive:
        eng.sync(device)
    rets = result if isinstance(result, tuple) else (result,)
    if info.mutate_inputs:
        for idx, r in zip(info.mutate_inputs, rets):
            if r is not nd_inputs[idx]._data:  # else updated in place
                nd_inputs[idx]._rebind(r)
        main = nd_inputs[info.mutate_inputs[0]]
        if out is not None and out is not main:
            out._rebind(main._data)
            return out
        return main
    # a compiled graph's outputs are fresh tensors: no storage to check
    compiling = torch.compiler.is_compiling()
    if not view and not compiling:
        rets = [_own(r, raw) for r in rets]
    outputs = [NDArray(r) for r in rets]
    if autograd.is_recording() and not compiling:
        # the op that made each output, for autograd.get_symbol: its
        # inputs' records (None for an array no recorded op made), never
        # the tensors, so the records keep no memory alive
        rec = (op_name, {k: v for k, v in attrs.items()
                         if not isinstance(v, torch.Tensor) and k != "ctx"},
               [x._producer for x in nd_inputs])
        for i, o in enumerate(outputs):
            o._producer = (rec, i, len(outputs))
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


def _is_int(k):
    return isinstance(k, (int, np.integer)) and not isinstance(k, bool)


def _check_int_bounds(key, shape):
    """``IndexError`` for an integer index outside its axis (torch would
    raise one too, but only after the op's wrapping)."""
    parts = key if isinstance(key, tuple) else (key,)
    axis = 0
    for k in parts:
        if k is None:
            continue
        if k is Ellipsis:
            return      # later parts count from the end: left to torch
        if _is_int(k) and axis < len(shape) \
                and not -shape[axis] <= k < shape[axis]:
            raise IndexError("index %d is out of bounds for axis %d with "
                             "size %d" % (k, axis, shape[axis]))
        axis += 1


def _first_axis_basic(key):
    """Whether ``key`` indexes the first axis alone by an integer or a
    step-1 slice: the indexes that share storage, as upstream's."""
    if isinstance(key, tuple):
        if len(key) != 1:
            return False
        key = key[0]
    if _is_int(key):
        return True
    return isinstance(key, slice) and key.step in (None, 1)


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "_producer", "__weakref__")

    # numpy operators defer to us
    __array_priority__ = 1000.0

    def __init__(self, data):
        if not isinstance(data, torch.Tensor):
            raise MXNetError("NDArray wraps a torch.Tensor, got %r"
                             % type(data))
        self._data = data
        self._grad = None
        self._grad_req = "null"
        self._producer = None

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
        t = self._data
        if t.device.type == "cpu" and torch.cuda.is_available() and \
                t.is_pinned():
            return Context("cpu_pinned", 0)
        return Context.from_device(t.device)

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        if self.ndim < 2:
            return self.copy()
        return _invoke_nd("transpose", [self], {})

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

    def __len__(self):
        return self.shape[0]

    def __iter__(self):
        for i in range(self.shape[0]):
            yield self[i]

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

    def _inplace(self, o, op_nd, op_sc, method):
        """``self op= o``.  Inside ``record()`` a rebind to the recorded
        result (a marked variable stays a leaf, as the JAX package's
        variable keeps its tape entry); outside it a write into this
        array's storage, by torch's in-place method where the result keeps
        this array's dtype and shape, else through the op and a copy."""
        if not isinstance(o, (NDArray,) + numeric_types):
            return NotImplemented
        if autograd.is_recording():
            res = self._binop(o, op_nd, op_sc)._data
            if self._grad is None:
                self._data = res
                return self
            if self._data.is_leaf:
                autograd.retire(self)
            return self._rebind(res)
        t = self._data
        other = o._data if isinstance(o, NDArray) else (
            o.item() if isinstance(o, np.generic) else o)
        with torch.no_grad():
            direct = torch.result_type(t, other) == t.dtype and (
                not isinstance(other, torch.Tensor)
                or torch.broadcast_shapes(t.shape, other.shape) == t.shape)
            if direct and method == "div_" and not t.is_floating_point():
                direct = False
            if direct:
                getattr(t, method)(other)
            else:
                t.copy_(self._binop(o, op_nd, op_sc)._data)
        return self

    def __iadd__(self, o):
        return self._inplace(o, "broadcast_add", "_plus_scalar", "add_")

    def __isub__(self, o):
        return self._inplace(o, "broadcast_sub", "_minus_scalar", "sub_")

    def __imul__(self, o):
        return self._inplace(o, "broadcast_mul", "_mul_scalar", "mul_")

    def __itruediv__(self, o):
        return self._inplace(o, "broadcast_div", "_div_scalar", "div_")

    __idiv__ = __itruediv__

    def __imod__(self, o):
        return self._inplace(o, "broadcast_mod", "_mod_scalar", "remainder_")

    def __setitem__(self, key, value):
        """Write ``value`` (an NDArray, array-like or number, broadcast)
        at ``key`` in place (parity: ndarray.py:409).  Raises under
        ``record()`` on an array that takes part in the recorded graph."""
        if autograd.is_recording() and self._data.requires_grad:
            raise MXNetError(
                "in-place assignment to an NDArray that is part of a "
                "recorded computation is not supported; use .detach()")
        t = self._data
        key, _ = _index_key(key, t.device)
        _check_int_bounds(key, t.shape)
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, numeric_types + (bool,)):
            value = torch.as_tensor(np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(t.device, t.dtype)
        elif isinstance(value, np.generic):
            value = value.item()
        with torch.no_grad():
            t[key] = value

    # -- conversion ----------------------------------------------------------
    def asnumpy(self):
        return self._data.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        # one host copy for np.asarray(x), not one __getitem__ a row
        out = self.asnumpy()
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        if copy:
            out = out.copy()
        return out

    def asscalar(self):
        return self.asnumpy().item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def wait_to_read(self):
        _engine.get().wait_for_var(self._data)

    def wait_to_write(self):
        _engine.get().wait_for_var(self._data)

    def astype(self, dtype, copy=True):
        if not copy and self._data.dtype == torch_dtype(dtype):
            return self
        return _invoke_nd("Cast", [self], {"dtype": dtype})

    def copy(self):
        return _invoke_nd("_copy", [self], {})

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray(other.place(self._data.detach().to(
                other.torch_device, copy=True)))
        if isinstance(other, NDArray):
            other._rebind(self._data.to(other._data.device,
                                        other._data.dtype, copy=True))
            return other
        raise MXNetError("copyto target must be NDArray or Context")

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def detach(self):
        """The same storage, out of the recorded graph."""
        return NDArray(self._data.detach())

    def tostype(self, stype):
        """This array (``"default"``), or a sparse one of its value
        (``"csr"``, ``"row_sparse"``; ndarray.sparse.cast_storage)."""
        if stype == "default":
            return self
        from .sparse import cast_storage

        return cast_storage(self, stype)

    # -- shape -----------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """A view of this array's storage in ``shape`` (MXNet's special
        codes 0, -1, -2, -3, -4)."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return _invoke_nd("Reshape", [self],
                          {"shape": shape,
                           "reverse": kwargs.get("reverse", False)},
                          view=True)

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def expand_dims(self, axis):
        return _invoke_nd("expand_dims", [self], {"axis": axis})

    def flatten(self):
        return _invoke_nd("Flatten", [self], {})

    def squeeze(self, axis=None):
        return _invoke_nd("squeeze", [self], {"axis": axis})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _invoke_nd("transpose", [self], {"axes": axes or None})

    def swapaxes(self, dim1, dim2):
        return _invoke_nd("swapaxes", [self], {"dim1": dim1, "dim2": dim2})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke_nd("SliceChannel", [self],
                          {"num_outputs": num_outputs, "axis": axis,
                           "squeeze_axis": squeeze_axis})

    def slice(self, begin, end, step=None):
        return _invoke_nd("slice", [self],
                          {"begin": begin, "end": end, "step": step})

    def slice_axis(self, axis, begin, end):
        return _invoke_nd("slice_axis", [self],
                          {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return _invoke_nd("take", [self, indices],
                          {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kw):
        return _invoke_nd("one_hot", [self], dict(kw, depth=depth))

    def pick(self, index, axis=-1, keepdims=False):
        return _invoke_nd("pick", [self, index],
                          {"axis": axis, "keepdims": keepdims})

    def clip(self, a_min, a_max):
        return _invoke_nd("clip", [self], {"a_min": a_min, "a_max": a_max})

    def softmax(self, axis=-1):
        return _invoke_nd("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return _invoke_nd("log_softmax", [self], {"axis": axis})

    def _reduce(self, op, axis, keepdims, exclude=False):
        return _invoke_nd(op, [self], {"axis": axis, "keepdims": keepdims,
                                       "exclude": exclude})

    def sum(self, axis=None, keepdims=False, exclude=False):
        return self._reduce("sum", axis, keepdims, exclude)

    def mean(self, axis=None, keepdims=False, exclude=False):
        return self._reduce("mean", axis, keepdims, exclude)

    def nansum(self, axis=None, keepdims=False, **kw):
        return self._reduce("nansum", axis, keepdims)

    def prod(self, axis=None, keepdims=False, **kw):
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False, **kw):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False, **kw):
        return self._reduce("min", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke_nd("norm", [self], {"ord": ord, "axis": axis,
                                           "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return _invoke_nd("argmax", [self], {"axis": axis,
                                             "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return _invoke_nd("argmin", [self], {"axis": axis,
                                             "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return _invoke_nd("argsort", [self], {"axis": axis,
                                              "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return _invoke_nd("sort", [self], {"axis": axis,
                                           "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _invoke_nd("topk", [self], {"axis": axis, "k": k,
                                           "ret_typ": ret_typ,
                                           "is_ascend": is_ascend})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke_nd("dot", [self, other],
                          {"transpose_a": transpose_a,
                           "transpose_b": transpose_b})

    def broadcast_to(self, shape):
        return _invoke_nd("broadcast_to", [self], {"shape": shape})

    def broadcast_like(self, other):
        return _invoke_nd("broadcast_like", [self, other], {})

    def tile(self, reps):
        return _invoke_nd("tile", [self], {"reps": reps})

    def repeat(self, repeats=1, axis=None):
        return _invoke_nd("repeat", [self], {"repeats": repeats,
                                             "axis": axis})

    def flip(self, axis):
        return _invoke_nd("reverse", [self], {"axis": axis})

    def zeros_like(self, **kw):
        return _invoke_nd("zeros_like", [self], {})

    def ones_like(self, **kw):
        return _invoke_nd("ones_like", [self], {})

    def __getitem__(self, key):
        view = _first_axis_basic(key)
        key, has_array = _index_key(key, self._data.device)
        if has_array and isinstance(key, torch.Tensor):
            return _invoke_nd("_index_array", [self, NDArray(key)], {})
        if not has_array:
            _check_int_bounds(key, self.shape)
        # basic indexing, or a tuple mixing arrays and slices: torch
        # records either
        return _invoke_nd("_index_static", [self], {"key": key}, view=view)

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

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

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


# the unary math methods (parity: ndarray.py:253-278)
for _name in ("abs", "sign", "sqrt", "square", "exp", "log", "relu",
              "sigmoid", "tanh"):
    setattr(NDArray, _name,
            (lambda op: lambda self: _invoke_nd(op, [self], {}))(_name))


def _ctx_device(ctx):
    return (ctx or current_context()).torch_device


def array(source_array, ctx=None, dtype=None):
    """A copy of ``source_array`` on ``ctx`` (parity: ndarray.py:789).  An
    NDArray keeps its context unless ``ctx`` is given; other data goes to
    ``ctx`` or the current context (``gpu(0)``).  Without ``dtype``, a
    Python list or number becomes float32, and a numpy array keeps its
    dtype except float64 -> float32 and int64 -> int32."""
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
        device = src.device if ctx is None else ctx.torch_device
        out = src.to(device, torch_dtype(dtype) if dtype is not None
                     else src.dtype, copy=True)
        return NDArray(out if ctx is None else ctx.place(out))
    src = np.asarray(source_array)
    if dtype is None:
        if not isinstance(source_array, np.ndarray):
            dtype = np.float32 if src.dtype.kind in "fiu" else src.dtype
        else:
            dtype = _NARROW.get(src.dtype, src.dtype)
    return NDArray(_placed(torch.tensor(src, dtype=torch_dtype(dtype),
                                        device=_ctx_device(ctx)), ctx))


def _placed(tensor, ctx):
    """``tensor`` as ``ctx`` holds it (page-locked for ``cpu_pinned``)."""
    return tensor if ctx is None else ctx.place(tensor)


def zeros(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(_placed(torch.zeros(shape, dtype=torch_dtype(dtype),
                                       device=_ctx_device(ctx)), ctx))


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(_placed(torch.ones(shape, dtype=torch_dtype(dtype),
                                      device=_ctx_device(ctx)), ctx))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def full(shape, val, ctx=None, dtype=None, out=None):
    return _invoke_nd("_full", [], {"shape": shape, "value": val,
                                    "dtype": dtype or "float32", "ctx": ctx},
                      out=out)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """``[start, stop)`` by ``step`` on ``ctx`` (default: the current
    context), float32 unless ``dtype`` says otherwise."""
    return _invoke_nd("_arange", [], {"start": start, "stop": stop,
                                      "step": step, "repeat": repeat,
                                      "dtype": dtype or "float32",
                                      "ctx": ctx})


def concatenate(arrays, axis=0, always_copy=True):
    return _invoke_nd("Concat", list(arrays), {"dim": axis})


def concat(*arrays, dim=1, **kw):
    return _invoke_nd("Concat", list(arrays), {"dim": dim})


def stack(*arrays, axis=0, **kw):
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return _invoke_nd("stack", list(arrays), {"axis": axis})


def moveaxis(tensor, source, destination):
    return _invoke_nd("moveaxis", [tensor],
                      {"source": source, "destination": destination})


def onehot_encode(indices, out):
    """One-hot rows of ``indices`` written into ``out`` (its second axis
    is the depth)."""
    res = _invoke_nd("one_hot", [indices], {"depth": out.shape[1]})
    out._rebind(res._data.to(out._data.dtype))
    return out


def waitall():
    _engine.get().wait_for_all()


# ---------------------------------------------------------------------------
# serialization (parity: ndarray.py:883-949)
# ---------------------------------------------------------------------------

_SAVE_PREFIX = "mxtpu:v1:"


def _host(a):
    if not isinstance(a, NDArray):
        raise MXNetError("save expects NDArrays, got %r" % type(a))
    return a.asnumpy()


def save(fname, data, format="npz"):
    """Save an NDArray, a list or a dict of them: ``format="npz"`` (keys
    ``mxtpu:v1:<i>`` or ``mxtpu:v1:dict:<name>``) or ``"binary"`` (the
    reference's list format)."""
    if isinstance(data, NDArray):
        names, arrays = None, [_host(data)]
    elif isinstance(data, (list, tuple)):
        names, arrays = None, [_host(a) for a in data]
    elif isinstance(data, dict):
        names = list(data.keys())
        arrays = [_host(data[k]) for k in names]
    else:
        raise MXNetError("save expects NDArray, list or dict")
    if format == "binary":
        from . import legacy_io

        legacy_io.save_binary(fname, arrays, names or ())
        return
    if format != "npz":
        raise MXNetError("unknown save format %r (use 'npz' or 'binary')"
                         % (format,))
    if names is None:
        keyed = {"%s%d" % (_SAVE_PREFIX, i): a for i, a in enumerate(arrays)}
    else:
        keyed = {"%sdict:%s" % (_SAVE_PREFIX, k): a
                 for k, a in zip(names, arrays)}
    buf = io.BytesIO()
    np.savez(buf, **keyed)
    from ..checkpoint import atomic_write

    atomic_write(fname, buf.getvalue())


def load(fname, ctx=None):
    """Arrays saved by ``save`` in either format (or by the JAX package),
    on ``ctx`` (default: the current context): a dict for a dict save,
    else a list."""
    from . import legacy_io

    if ctx is None:
        ctx = current_context()
    if legacy_io.is_binary_format(fname):
        arrays, names = legacy_io.load_binary(fname)
        if names:
            return {k: array(a, ctx=ctx) for k, a in zip(names, arrays)}
        return [array(a, ctx=ctx) for a in arrays]
    with np.load(fname, allow_pickle=False) as f:
        keys = list(f.keys())
        dict_prefix = _SAVE_PREFIX + "dict:"
        if any(k.startswith(dict_prefix) for k in keys):
            return {k[len(dict_prefix):]: array(f[k], ctx=ctx) for k in keys}
        order = sorted(keys, key=lambda k: int(k[len(_SAVE_PREFIX):]))
        return [array(f[k], ctx=ctx) for k in order]

