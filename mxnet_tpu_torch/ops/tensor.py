"""Tensor ops on torch tensors (parity: mxnet_tpu/ops/tensor.py):
elementwise, broadcast and scalar arithmetic, comparisons, reductions,
dot/batch_dot and the ``linalg_*`` ops (``torch.linalg``), reshaping,
slicing, indexing and scatter, init ops, ordering, softmax/softmin, and
the reference's aliases of these (``_Plus``, ``broadcast_plus``,
``_MulScalar``, ...).

Each op is one or a few torch calls; the dtype rules are the JAX
package's (comparisons return the lhs dtype, argmax returns the data's
dtype, a scalar keeps an integer array integer when it is integral).
"""
from __future__ import annotations

import ast
import math

import numpy as np
import torch

from .registry import register, alias
from .utils import (pbool, pint, pfloat, ptuple, pdtype, paxis,
                    paxis_or_none, normalize_axis)

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
    "cbrt": lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0),
    "rcbrt": lambda x: 1.0 / (torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)),
}
for _name, _fn in _UNARY.items():
    register(_name)((lambda f: lambda data, **kw: f(data))(_fn))

for _name, _fn in {"isnan": torch.isnan, "isinf": torch.isinf,
                   "isfinite": torch.isfinite,
                   "logical_not": torch.logical_not}.items():
    register(_name, differentiable=False)(
        (lambda f: lambda data, **kw: f(data).to(data.dtype))(_fn))

register("hard_sigmoid")(
    lambda data, alpha=0.2, beta=0.5, **kw:
        torch.clamp(pfloat(alpha, 0.2) * data + pfloat(beta, 0.5), 0.0, 1.0))
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
    if kind in ("prod", "nanprod"):
        out = data if kind == "prod" else torch.where(
            torch.isnan(data), torch.ones_like(data), data)
        for a in sorted(axes, reverse=True):
            out = torch.prod(out, dim=a, keepdim=keepdims)
        return out
    if kind == "mean":
        if not data.is_floating_point():
            data = data.to(torch.float32)
        return torch.mean(data, dim=axes, keepdim=keepdims)
    fn = {"sum": torch.sum, "max": torch.amax, "min": torch.amin,
          "nansum": torch.nansum}[kind]
    out = fn(data, dim=axes, keepdim=keepdims)
    return out.to(data.dtype) if _is_int(data) else out


for _name in ("sum", "mean", "prod", "max", "min", "nansum", "nanprod"):
    register(_name, aliases=((_name + "_axis",)
                             if _name in ("sum", "max", "min") else ()))(
        (lambda k: lambda data, axis=None, keepdims=False, exclude=False,
            **kw: _reduce(k, data, axis, keepdims, exclude))(_name))


@register("norm")
def _norm(data, ord=2, axis=None, keepdims=False, **kw):
    """The L1 norm (``ord=1``) or the L2 norm over ``axis`` (all by
    default), as sqrt(sum(x^2)) there."""
    if pint(ord, 2) == 1:
        return _reduce("sum", torch.abs(data), axis, keepdims)
    return torch.sqrt(_reduce("sum", torch.square(data), axis, keepdims))


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
        # math.prod: dynamo would trace np.prod into a CPU tensor op
        total = math.prod(src_shape)
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


@register("Pad", aliases=("pad",))
def _pad(data, mode="constant", pad_width=None, constant_value=0.0, **kw):
    """Pad by ``pad_width`` = (before, after) per axis, flattened:
    'constant' with ``constant_value``, 'reflect' (the edge not
    repeated) or 'edge'.  torch pads the reflect and edge modes over the
    last 1-3 axes only, so the leading pairs must be zero there."""
    pw = ptuple(pad_width)
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode == "constant":
        widths = [w for lo_hi in reversed(pairs) for w in lo_hi]
        return torch.nn.functional.pad(
            data, widths, value=pfloat(constant_value, 0.0))
    n = data.dim()
    m = n - 2 if 1 <= n - 2 <= 3 else n - 1
    if any(sum(pairs[:n - m], ())):
        raise ValueError("Pad %s: only the last %d axes can be padded"
                         % (mode, m))
    widths = [w for lo_hi in reversed(pairs[n - m:]) for w in lo_hi]
    return torch.nn.functional.pad(
        data, widths, mode="reflect" if mode == "reflect" else "replicate")


# ---------------------------------------------------------------------------
# softmax
# ---------------------------------------------------------------------------


@register("softmax")
def _softmax(data, axis=-1, temperature=None, **kw):
    t = pfloat(temperature)
    if t and t != 1.0:
        data = data / t
    return torch.softmax(data, dim=paxis(axis, -1))


# ---------------------------------------------------------------------------
# softmin, smooth_l1, khatri_rao, scatter arithmetic
# ---------------------------------------------------------------------------


@register("softmin")
def _softmin(data, axis=-1, **kw):
    return torch.softmax(-data, dim=paxis(axis, -1))


@register("smooth_l1")
def _smooth_l1(data, scalar=1.0, **kw):
    s2 = pfloat(scalar, 1.0) ** 2
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * torch.square(data),
                       absd - 0.5 / s2)


@register("khatri_rao", num_inputs=-1)
def _khatri_rao(*mats, **kw):
    """Column-wise Kronecker product of matrices with equal columns."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("ij,kj->ikj", out, m).reshape(-1, out.shape[1])
    return out


# the reference keeps these for sparse storage; on dense arrays they are
# the plain ops (mxnet_tpu/ops/tensor.py:833-857)
register("_scatter_elemwise_div", num_inputs=2)(
    lambda lhs, rhs, **kw: lhs / rhs)
register("_scatter_plus_scalar")(
    lambda data, scalar=0.0, **kw: data + pfloat(scalar, 0.0))
register("_scatter_minus_scalar")(
    lambda data, scalar=0.0, **kw: data - pfloat(scalar, 0.0))


# ---------------------------------------------------------------------------
# linalg_* (reference: src/operator/tensor/la_op.cc; torch.linalg, which
# runs LAPACK on the host and cuSOLVER/cuBLAS on the card)
# ---------------------------------------------------------------------------


def _t(x):
    return x.transpose(-1, -2)


@register("_linalg_gemm", num_inputs=3, aliases=("linalg_gemm",))
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0, axis=-3, **kw):
    A = _t(A) if pbool(transpose_a) else A
    B = _t(B) if pbool(transpose_b) else B
    return pfloat(alpha, 1.0) * torch.matmul(A, B) + pfloat(beta, 1.0) * C


@register("_linalg_gemm2", num_inputs=2, aliases=("linalg_gemm2",))
def _linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0,
                  **kw):
    A = _t(A) if pbool(transpose_a) else A
    B = _t(B) if pbool(transpose_b) else B
    return pfloat(alpha, 1.0) * torch.matmul(A, B)


register("_linalg_potrf", aliases=("linalg_potrf",))(
    lambda A, **kw: torch.linalg.cholesky(A))
register("_linalg_syrk", aliases=("linalg_syrk",))(
    lambda A, transpose=False, alpha=1.0, **kw:
        pfloat(alpha, 1.0) * (torch.matmul(_t(A), A) if pbool(transpose)
                              else torch.matmul(A, _t(A))))
register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))(
    lambda A, **kw: torch.sum(torch.log(torch.diagonal(A, 0, -2, -1)), -1))
register("_linalg_extractdiag", aliases=("linalg_extractdiag",))(
    lambda A, offset=0, **kw: torch.diagonal(A, pint(offset, 0), -2, -1))


def _solve_tri(A, B, lower):
    """X with tri(A) X = B, tri(A) the lower (or upper) triangle of A."""
    tri = torch.tril(A) if lower else torch.triu(A)
    return torch.linalg.solve_triangular(tri, B, upper=not lower)


@register("_linalg_trsm", num_inputs=2, aliases=("linalg_trsm",))
def _linalg_trsm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0, **kw):
    """alpha op(A)^-1 B, or alpha B op(A)^-1 with ``rightside``; A lower
    (or upper) triangular, op(A) = A^T with ``transpose``."""
    lower = pbool(lower, True)
    if pbool(transpose):
        A, lower = _t(A), not lower
    B = pfloat(alpha, 1.0) * B
    if pbool(rightside):
        return _t(_solve_tri(_t(A), _t(B), not lower))
    return _solve_tri(A, B, lower)


@register("_linalg_trmm", num_inputs=2, aliases=("linalg_trmm",))
def _linalg_trmm(A, B, transpose=False, rightside=False, lower=True,
                 alpha=1.0, **kw):
    """alpha op(A) B, or alpha B op(A) with ``rightside``."""
    tri = torch.tril(A) if pbool(lower, True) else torch.triu(A)
    if pbool(transpose):
        tri = _t(tri)
    prod = torch.matmul(B, tri) if pbool(rightside) else torch.matmul(tri, B)
    return pfloat(alpha, 1.0) * prod


@register("_linalg_potri", aliases=("linalg_potri",))
def _linalg_potri(A, lower=True, **kw):
    """inv(A A^T) from the Cholesky factor A (lower), inv(A^T A) for an
    upper one: two triangular solves against I."""
    lo = pbool(lower, True)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    Ainv = _solve_tri(A, eye.expand(A.shape), lo)
    return torch.matmul(_t(Ainv), Ainv) if lo else torch.matmul(Ainv, _t(Ainv))


@register("_linalg_gelqf", num_outputs=2, aliases=("linalg_gelqf",))
def _linalg_gelqf(A, **kw):
    """A = L Q with row-orthonormal Q, as the transposed QR of A^T.  The
    rows' signs are the factorization library's."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    return _t(q), _t(r)


@register("_linalg_syevd", num_outputs=2, aliases=("linalg_syevd",))
def _linalg_syevd(A, **kw):
    """(U, L) with U A = diag(L) U: U's rows are the eigenvectors
    (ascending L), each up to sign."""
    w, v = torch.linalg.eigh(A)
    return _t(v), w


# ---------------------------------------------------------------------------
# shape manipulation and slicing
# ---------------------------------------------------------------------------


@register("moveaxis")
def _moveaxis(data, source=0, destination=0, **kw):
    return torch.movedim(data, paxis(source), paxis(destination))


def _opt_tuple(v):
    """A begin/end/step attribute as a tuple whose entries may be None."""
    if v is None:
        return ()
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, np.integer)):
        v = (v,)
    return tuple(None if x is None else int(x) for x in v)


def _axis_slice(data, axis, begin, end, step):
    """``data`` sliced on ``axis`` as Python slices it, negative steps
    included (torch's slicing takes positive steps only)."""
    start, stop, step = slice(begin, end, step).indices(data.shape[axis])
    if step > 0:
        return data[(slice(None),) * axis + (slice(start, stop, step),)]
    idx = torch.arange(start, stop, step, device=data.device)
    return torch.index_select(data, axis, idx)


@register("slice", aliases=("crop",))
def _slice(data, begin=None, end=None, step=None, **kw):
    """Per-axis [begin:end:step]; missing or None entries take the whole
    axis."""
    begin, end, step = _opt_tuple(begin), _opt_tuple(end), _opt_tuple(step)
    for i in range(data.dim()):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) and step[i] != 0 else None
        if (b, e, s) != (None, None, None):
            data = _axis_slice(data, i, b, e, s)
    return data


@register("slice_like", num_inputs=2)
def _slice_like(data, shape_like, axes=None, **kw):
    axes = ptuple(axes)
    if not axes:
        axes = tuple(range(shape_like.dim()))
    for a in axes:
        a = normalize_axis(a, data.dim())
        data = data.narrow(a, 0, shape_like.shape[a])
    return data


def _split_num_outputs(attrs):
    return pint(attrs.get("num_outputs"), 1)


@register("SliceChannel", num_outputs=_split_num_outputs,
          aliases=("split",))
def _split(data, num_outputs=1, axis=1, squeeze_axis=False, **kw):
    num = pint(num_outputs, 1)
    axis = normalize_axis(pint(axis, 1), data.dim())
    if data.shape[axis] % num:
        raise ValueError("cannot split axis %d of size %d into %d equal "
                         "parts" % (axis, data.shape[axis], num))
    parts = torch.split(data, data.shape[axis] // num, dim=axis)
    if pbool(squeeze_axis):
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts) if num > 1 else parts[0]


@register("tile")
def _tile(data, reps=None, **kw):
    return torch.tile(data, ptuple(reps))


@register("repeat")
def _repeat(data, repeats=1, axis=None, **kw):
    """Each element ``repeats`` times along ``axis`` (the flattened array
    when None)."""
    return torch.repeat_interleave(data, pint(repeats, 1), dim=paxis(axis))


@register("reverse", aliases=("flip",))
def _reverse(data, axis=None, **kw):
    ax = paxis(axis)
    return torch.flip(data, ax if isinstance(ax, tuple) else (ax,))


@register("depth_to_space")
def _depth_to_space(data, block_size=1, **kw):
    b = pint(block_size, 1)
    n, c, h, w = data.shape
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(data, block_size=1, **kw):
    b = pint(block_size, 1)
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("diag")
def _diag(data, k=0, axis1=0, axis2=1, **kw):
    k = pint(k, 0)
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, k, pint(axis1, 0), pint(axis2, 1))


# int32, as the JAX package's with x64 off
register("shape_array", differentiable=False)(
    lambda data, **kw: torch.tensor(data.shape, dtype=torch.int32,
                                    device=data.device))
register("size_array", differentiable=False)(
    lambda data, **kw: torch.tensor([data.numel()], dtype=torch.int32,
                                    device=data.device))


# ---------------------------------------------------------------------------
# indexing and scatter
# ---------------------------------------------------------------------------


@register("batch_take", num_inputs=2)
def _batch_take(a, indices, **kw):
    """a[i, indices[i]] for each row i."""
    return torch.gather(a, 1, indices.to(torch.int64).reshape(-1, 1))[:, 0]


@register("one_hot", differentiable=False)
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
             dtype="float32", **kw):
    """One-hot rows along a new last axis; an index outside [0, depth)
    gives a row of ``off_value``, as jax.nn.one_hot's zeros do."""
    depth = pint(depth, 0)
    hot = (indices.to(torch.int64).unsqueeze(-1)
           == torch.arange(depth, device=indices.device)).to(pdtype(dtype))
    off = pfloat(off_value, 0.0)
    return hot * (pfloat(on_value, 1.0) - off) + off


def _nd_index(indices):
    idx = indices.to(torch.int64)
    return tuple(idx[i] for i in range(idx.shape[0]))


@register("gather_nd", num_inputs=2)
def _gather_nd(data, indices, **kw):
    """data[indices[0], ..., indices[M-1]] (indices of shape (M, ...))."""
    return data[_nd_index(indices)]


@register("scatter_nd", num_inputs=2, differentiable=False)
def _scatter_nd(data, indices, shape=None, **kw):
    out = torch.zeros(ptuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(indices), data)


# ---------------------------------------------------------------------------
# init ops with no array input (the caller's context arrives as ``ctx``)
# ---------------------------------------------------------------------------


@register("_linspace", num_inputs=0, differentiable=False)
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              ctx=None, **kw):
    start, stop, num = pfloat(start, 0.0), pfloat(stop, 1.0), pint(num, 50)
    if pbool(endpoint, True):
        return torch.linspace(start, stop, num, dtype=pdtype(dtype),
                              device=ctx)
    return torch.linspace(start, stop, num + 1, dtype=pdtype(dtype),
                          device=ctx)[:num]


@register("_eye", num_inputs=0, differentiable=False)
def _eye(N=0, M=0, k=0, dtype="float32", ctx=None, **kw):
    n = pint(N, 0)
    m = pint(M, 0) or n
    rows = torch.arange(n, device=ctx)[:, None]
    cols = torch.arange(m, device=ctx)[None, :]
    return (cols - rows == pint(k, 0)).to(pdtype(dtype))


# ---------------------------------------------------------------------------
# ordering (reference: ordering_op.cc); ties keep the JAX package's order
# (a stable ascending sort, flipped for descending)
# ---------------------------------------------------------------------------


def _order_axis(data, axis):
    ax = paxis_or_none(axis, -1)
    if ax is None:              # flattened-input semantics
        return data.reshape(-1), 0
    return data, ax


@register("sort", differentiable=False)
def _sort(data, axis=-1, is_ascend=True, **kw):
    data, ax = _order_axis(data, axis)
    out = torch.sort(data, dim=ax, stable=True).values
    return out if pbool(is_ascend, True) else torch.flip(out, (ax,))


@register("argsort", differentiable=False)
def _argsort(data, axis=-1, is_ascend=True, dtype="float32", **kw):
    data, ax = _order_axis(data, axis)
    out = torch.argsort(data, dim=ax, stable=True)
    if not pbool(is_ascend, True):
        out = torch.flip(out, (ax,))
    return out.to(pdtype(dtype))


def _topk_num_outputs(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


@register("topk", num_outputs=_topk_num_outputs, differentiable=False)
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32", **kw):
    """The k largest (smallest with ``is_ascend``) along ``axis``: their
    values, indices (in ``dtype``), a 0/1 mask of them, or both values
    and indices."""
    data, ax = _order_axis(data, axis)
    ax = normalize_axis(ax, data.dim())
    vals, idxs = torch.topk(data, pint(k, 1), dim=ax,
                            largest=not pbool(is_ascend, False), sorted=True)
    ret_typ = ret_typ or "indices"
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idxs.to(pdtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(ax, idxs, 1)
    return vals, idxs.to(pdtype(dtype))


# ---------------------------------------------------------------------------
# the reference's other names of these ops (mxnet_tpu/ops/tensor.py and the
# reference's legacy operator names)
# ---------------------------------------------------------------------------

_ALIASES = {
    "elemwise_add": ("_Plus", "_plus", "_grad_add"),
    "elemwise_sub": ("_Minus", "_minus"),
    "elemwise_mul": ("_Mul",),
    "elemwise_div": ("_Div",),
    "broadcast_add": ("broadcast_plus",),
    "broadcast_sub": ("broadcast_minus",),
    "broadcast_mod": ("_Mod", "_mod"),
    "broadcast_power": ("_Power", "_power"),
    "broadcast_maximum": ("_Maximum", "_maximum"),
    "broadcast_minimum": ("_Minimum", "_minimum"),
    "broadcast_hypot": ("_Hypot", "_hypot"),
    "broadcast_equal": ("_Equal", "_equal"),
    "broadcast_not_equal": ("_Not_Equal", "_not_equal"),
    "broadcast_greater": ("_Greater", "_greater"),
    "broadcast_greater_equal": ("_Greater_Equal", "_greater_equal"),
    "broadcast_lesser": ("_Lesser", "_lesser"),
    "broadcast_lesser_equal": ("_Lesser_Equal", "_lesser_equal"),
    "broadcast_logical_and": ("_Logical_And", "_logical_and"),
    "broadcast_logical_or": ("_Logical_Or", "_logical_or"),
    "broadcast_logical_xor": ("_Logical_Xor", "_logical_xor"),
    "_plus_scalar": ("_PlusScalar",),
    "_minus_scalar": ("_MinusScalar",),
    "_rminus_scalar": ("_RMinusScalar",),
    "_mul_scalar": ("_MulScalar",),
    "_div_scalar": ("_DivScalar",),
    "_rdiv_scalar": ("_RDivScalar",),
    "_mod_scalar": ("_ModScalar",),
    "_rmod_scalar": ("_RModScalar",),
    "_power_scalar": ("_PowerScalar",),
    "_rpower_scalar": ("_RPowerScalar",),
    "_maximum_scalar": ("_MaximumScalar",),
    "_minimum_scalar": ("_MinimumScalar",),
    "_hypot_scalar": ("_HypotScalar",),
    "_equal_scalar": ("_EqualScalar",),
    "_not_equal_scalar": ("_NotEqualScalar",),
    "_greater_scalar": ("_GreaterScalar",),
    "_greater_equal_scalar": ("_GreaterEqualScalar",),
    "_lesser_scalar": ("_LesserScalar",),
    "_lesser_equal_scalar": ("_LesserEqualScalar",),
    "_logical_and_scalar": ("_LogicalAndScalar",),
    "_logical_or_scalar": ("_LogicalOrScalar",),
    "_logical_xor_scalar": ("_LogicalXorScalar",),
    "Concat": ("_rnn_param_concat",),
}
for _name, _names in _ALIASES.items():
    for _a in _names:
        alias(_name, _a)
