"""Tensor ops on torch tensors (parity: mxnet_tpu/ops/tensor.py):
elementwise, broadcast and scalar arithmetic, comparisons, reductions,
dot/batch_dot, reshaping, indexing, init ops and softmax.

Each op is one or a few torch calls; the dtype rules are the JAX
package's (comparisons return the lhs dtype, argmax returns the data's
dtype, a scalar keeps an integer array integer when it is integral).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register
from .utils import pbool, pint, pfloat, ptuple, pdtype, paxis, normalize_axis

# ---------------------------------------------------------------------------
# elemwise binary (same shape) and broadcast binary
# ---------------------------------------------------------------------------

_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": torch.remainder,     # jnp.mod: the sign follows the divisor
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
}

for _name, _fn in _BINARY.items():
    mx_name = {"add": "elemwise_add", "sub": "elemwise_sub",
               "mul": "elemwise_mul", "div": "elemwise_div"}.get(_name)
    if mx_name:
        register(mx_name, num_inputs=2, aliases=("_" + _name,))(
            (lambda f: lambda lhs, rhs, **kw: f(lhs, rhs))(_fn))
    register("broadcast_" + _name, num_inputs=2)(
        (lambda f: lambda lhs, rhs, **kw: f(lhs, rhs))(_fn))

_CMP = {
    "equal": torch.eq, "not_equal": torch.ne,
    "greater": torch.gt, "greater_equal": torch.ge,
    "lesser": torch.lt, "lesser_equal": torch.le,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}

for _name, _fn in _CMP.items():
    # MXNet comparisons return the lhs dtype, not bool
    register("broadcast_" + _name, num_inputs=2, differentiable=False)(
        (lambda f: lambda lhs, rhs, **kw: f(lhs, rhs).to(lhs.dtype))(_fn))


def _is_int(x):
    return not x.is_floating_point() and x.dtype != torch.bool


def _op_scalar(x, s, min_int=None):
    """Scalar operand coercion: an integral scalar keeps an integer array
    integer (the reference's scalar ops do not promote int -> float);
    ``min_int`` floors the int coercion (power rejects negative integer
    exponents on int arrays)."""
    f = pfloat(s, 0.0)
    if _is_int(x) and math.isfinite(f) and f == int(f) \
            and (min_int is None or f >= min_int):
        return int(f)
    return f


_SCALAR_OPS = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_maximum_scalar": lambda x, s: torch.clamp(x, min=s),
    "_minimum_scalar": lambda x, s: torch.clamp(x, max=s),
    "_hypot_scalar": lambda x, s: torch.hypot(
        *(t.to(torch.float32) if _is_int(t) else t
          for t in (x, torch.full_like(x, s)))),
}

for _name, _fn in _SCALAR_OPS.items():
    register(_name)(
        (lambda f, lo: lambda data, scalar=0.0, **kw:
            f(data, _op_scalar(data, scalar, min_int=lo)))(
                _fn, 0 if _name == "_power_scalar" else None))

_SCALAR_CMP = {
    "_equal_scalar": torch.eq, "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt, "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt, "_lesser_equal_scalar": torch.le,
}
for _name, _fn in _SCALAR_CMP.items():
    register(_name, differentiable=False)(
        (lambda f: lambda data, scalar=0.0, **kw:
            f(data, pfloat(scalar, 0.0)).to(data.dtype))(_fn))

_SCALAR_LOGIC = {
    "_logical_and_scalar": torch.logical_and,
    "_logical_or_scalar": torch.logical_or,
    "_logical_xor_scalar": torch.logical_xor,
}
for _name, _fn in _SCALAR_LOGIC.items():
    register(_name, differentiable=False)(
        (lambda f: lambda data, scalar=0.0, **kw:
            f(data, torch.tensor(pfloat(scalar, 0.0), device=data.device))
            .to(data.dtype))(_fn))

# ---------------------------------------------------------------------------
# elemwise unary
# ---------------------------------------------------------------------------

_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc, "square": torch.square, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "exp": torch.exp, "log": torch.log,
    "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
    "expm1": torch.expm1, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "arcsin": torch.asin, "arccos": torch.acos,
    "arctan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "arcsinh": torch.asinh, "arccosh": torch.acosh,
    "arctanh": torch.atanh, "degrees": torch.rad2deg,
    "radians": torch.deg2rad, "reciprocal": torch.reciprocal,
    "negative": torch.neg, "erf": torch.erf, "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)),
}
for _name, _fn in _UNARY.items():
    register(_name)((lambda f: lambda data, **kw: f(data))(_fn))

for _name, _fn in {"isnan": torch.isnan, "isinf": torch.isinf,
                   "isfinite": torch.isfinite,
                   "logical_not": torch.logical_not}.items():
    register(_name, differentiable=False)(
        (lambda f: lambda data, **kw: f(data).to(data.dtype))(_fn))

register("_copy")(lambda data, **kw: data.clone())
register("identity")(lambda data, **kw: data)
register("BlockGrad", aliases=("stop_gradient",))(
    lambda data, **kw: data.detach())
register("make_loss")(lambda data, **kw: data)
register("zeros_like", differentiable=False)(
    lambda data, **kw: torch.zeros_like(data))
register("ones_like", differentiable=False)(
    lambda data, **kw: torch.ones_like(data))


@register("clip")
def _clip(data, a_min=None, a_max=None, **kw):
    return torch.clamp(data, pfloat(a_min), pfloat(a_max))


@register("Cast", aliases=("cast",))
def _cast(data, dtype="float32", **kw):
    return data.to(pdtype(dtype))


@register("_index_static")
def _index_static(data, key=None, **kw):
    """Basic indexing (ints, slices, Ellipsis, None), recorded like any
    op (reference: ndarray.py:507)."""
    return data[key]


@register("_index_array", num_inputs=2)
def _index_array(data, idx, **kw):
    """Indexing by an integer or boolean array."""
    if idx.is_floating_point():
        idx = idx.to(torch.int64)
    return data[idx]


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _reduce(kind, data, axis=None, keepdims=False, exclude=False):
    axis = paxis(axis)
    keepdims = pbool(keepdims)
    if axis is None:
        axes = tuple(range(data.dim()))
    else:
        axes = axis if isinstance(axis, tuple) else (axis,)
        axes = tuple(normalize_axis(a, data.dim()) for a in axes)
        if pbool(exclude):
            axes = tuple(i for i in range(data.dim()) if i not in axes)
    if not axes:
        # jnp's reduction over no axis is the identity; torch's empty
        # dim list would reduce over every axis
        return data
    if kind == "prod":
        out = data
        for a in sorted(axes, reverse=True):
            out = torch.prod(out, dim=a, keepdim=keepdims)
        return out
    if kind == "mean":
        if not data.is_floating_point():
            data = data.to(torch.float32)
        return torch.mean(data, dim=axes, keepdim=keepdims)
    fn = {"sum": torch.sum, "max": torch.amax, "min": torch.amin}[kind]
    out = fn(data, dim=axes, keepdim=keepdims)
    return out.to(data.dtype) if _is_int(data) else out


for _name in ("sum", "mean", "prod", "max", "min"):
    register(_name, aliases=((_name + "_axis",)
                             if _name in ("sum", "max", "min") else ()))(
        (lambda k: lambda data, axis=None, keepdims=False, exclude=False,
            **kw: _reduce(k, data, axis, keepdims, exclude))(_name))


def _arg(fn, data, axis, keepdims):
    axis = paxis(axis)
    keepdims = pbool(keepdims)
    if axis is None:
        out = fn(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, dim=axis, keepdim=keepdims)
    return out.to(data.dtype)  # the reference returns the input dtype


@register("argmax", differentiable=False)
def _argmax(data, axis=None, keepdims=False, **kw):
    """Index of the first maximum (torch and XLA both pick the first)."""
    return _arg(torch.argmax, data, axis, keepdims)


@register("argmin", differentiable=False)
def _argmin(data, axis=None, keepdims=False, **kw):
    return _arg(torch.argmin, data, axis, keepdims)


@register("argmax_channel", differentiable=False)
def _argmax_channel(data, **kw):
    return torch.argmax(data, dim=1).to(data.dtype)


# ---------------------------------------------------------------------------
# broadcast helpers
# ---------------------------------------------------------------------------


@register("broadcast_to")
def _broadcast_to(data, shape=None, **kw):
    shape = ptuple(shape)
    tgt = tuple(s if s != 0 else d for s, d in zip(shape, data.shape))
    return torch.broadcast_to(data, tgt)


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(data, axis=None, size=None, **kw):
    axes = paxis(axis)
    sizes = ptuple(size)
    if not isinstance(axes, tuple):
        axes = (axes,)
    tgt = list(data.shape)
    for a, s in zip(axes, sizes):
        tgt[normalize_axis(a, data.dim())] = s
    return torch.broadcast_to(data, tuple(tgt))


@register("broadcast_like", num_inputs=2)
def _broadcast_like(lhs, rhs, **kw):
    return torch.broadcast_to(lhs, rhs.shape)


# ---------------------------------------------------------------------------
# dot / batch_dot (cuBLAS through torch; MXU through XLA there)
# ---------------------------------------------------------------------------


@register("dot", num_inputs=2)
def _dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    if pbool(transpose_a):
        lhs = lhs.T if lhs.dim() == 2 else torch.movedim(lhs, 0, -1)
    if pbool(transpose_b):
        rhs = rhs.T if rhs.dim() == 2 else torch.movedim(rhs, -1, 0)
    if lhs.dim() == 1 and rhs.dim() == 1:
        return torch.dot(lhs, rhs)
    # MXNet's dot contracts the last axis of lhs with the first of rhs
    return torch.tensordot(lhs, rhs, dims=([lhs.dim() - 1], [0]))


@register("batch_dot", num_inputs=2)
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    if pbool(transpose_a):
        lhs = lhs.transpose(-1, -2)
    if pbool(transpose_b):
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


def _mx_reshape(shape, src_shape):
    """MXNet reshape with the special codes 0, -1, -2, -3, -4 (reference:
    src/operator/tensor/matrix_op-inl.h InferReshapeShape)."""
    out = []
    src = list(src_shape)
    i = 0
    k = 0
    shape = list(shape)
    while k < len(shape):
        s = shape[k]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[k + 1], shape[k + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            k += 2
        else:
            out.append(s)
            i += 1
        k += 1
    if -1 in out:
        known = 1
        for v in out:
            if v != -1:
                known *= v
        total = int(np.prod(src_shape)) if src_shape else 1
        out[out.index(-1)] = total // known
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def _reshape(data, shape=None, reverse=False, **kw):
    shape = ptuple(shape)
    if pbool(reverse):
        rshape = _mx_reshape(list(reversed(shape)),
                             list(reversed(data.shape)))
        return data.reshape(tuple(reversed(rshape)))
    return data.reshape(_mx_reshape(shape, tuple(data.shape)))


@register("Flatten", aliases=("flatten",))
def _flatten(data, **kw):
    return data.reshape(data.shape[0], -1)


@register("transpose")
def _transpose(data, axes=None, **kw):
    axes = ptuple(axes)
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("expand_dims")
def _expand_dims(data, axis=0, **kw):
    return data.unsqueeze(pint(axis, 0))


@register("squeeze")
def _squeeze(data, axis=None, **kw):
    axis = paxis(axis)
    return data.squeeze() if axis is None else data.squeeze(axis)


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(data, dim1=0, dim2=0, **kw):
    return data.transpose(pint(dim1, 0), pint(dim2, 0))


@register("slice_axis")
def _slice_axis(data, axis=0, begin=0, end=None, **kw):
    axis = normalize_axis(pint(axis, 0), data.dim())
    e = None if (end is None or end == "None") else pint(end)
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(pint(begin, 0), e)
    return data[tuple(idx)]


@register("Concat", num_inputs=-1, aliases=("concat",))
def _concat(*data, dim=1, num_args=None, **kw):
    return torch.cat(data, dim=pint(dim, 1))


@register("stack", num_inputs=-1)
def _stack(*data, axis=0, num_args=None, **kw):
    return torch.stack(data, dim=pint(axis, 0))


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------


@register("take", num_inputs=2)
def _take(a, indices, axis=0, mode="clip", **kw):
    """Rows of ``a`` along ``axis``: out-of-range indices clamp ('clip',
    the default), wrap ('wrap'), or raise ('raise', checked on the
    host)."""
    axis = normalize_axis(pint(axis, 0), a.dim())
    mode = mode or "clip"
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    if mode == "raise":
        if idx.numel() and (int(idx.min()) < -n or int(idx.max()) >= n):
            raise IndexError(
                "take(mode='raise'): index out of bounds for axis %d "
                "with size %d" % (axis, n))
        mode = "wrap"       # validated indices in [-n, n): -1 -> n-1
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(idx.shape)
                       + tuple(a.shape[axis + 1:]))


@register("where", num_inputs=3)
def _where(condition, x, y, **kw):
    if condition.dim() < x.dim() and condition.dim() == 1:
        condition = condition.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(condition != 0, x, y)


# ---------------------------------------------------------------------------
# init ops: no array inputs, so the caller's context arrives as ``ctx``
# (a torch.device; ``ndarray._invoke_nd`` resolves it)
# ---------------------------------------------------------------------------


@register("_zeros", num_inputs=0, differentiable=False)
def _zeros(shape=None, dtype="float32", ctx=None, **kw):
    return torch.zeros(ptuple(shape, default=()), dtype=pdtype(dtype),
                       device=ctx)


@register("_ones", num_inputs=0, differentiable=False)
def _ones(shape=None, dtype="float32", ctx=None, **kw):
    return torch.ones(ptuple(shape, default=()), dtype=pdtype(dtype),
                      device=ctx)


@register("_full", num_inputs=0, differentiable=False)
def _full(shape=None, value=0.0, dtype="float32", ctx=None, **kw):
    return torch.full(ptuple(shape, default=()), pfloat(value, 0.0),
                      dtype=pdtype(dtype), device=ctx)


@register("_arange", num_inputs=0, differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype="float32", ctx=None, **kw):
    start = pfloat(start, 0.0)
    if stop is None or stop == "None":
        start, stop = 0.0, start
    out = torch.arange(start, pfloat(stop), pfloat(step, 1.0),
                       dtype=pdtype(dtype), device=ctx)
    r = pint(repeat, 1)
    return torch.repeat_interleave(out, r) if r > 1 else out


# ---------------------------------------------------------------------------
# softmax
# ---------------------------------------------------------------------------


@register("softmax")
def _softmax(data, axis=-1, temperature=None, **kw):
    t = pfloat(temperature)
    if t and t != 1.0:
        data = data / t
    return torch.softmax(data, dim=paxis(axis, -1))
