"""The rest of mxnet_tpu/ops/extended.py: its training heads (MakeLoss
:170, SVMOutput :197; the reference's make_loss.cc and svm_output.cc),
its quantized pass-through ops (:676-730: int8 stays int8) and its other
56 registry names (:57-163, :185-235, :242-673, :731-900): the plain
tensor ops, the gradient ops, the spatial ops, fft, boolean_mask and
bipartite matching, the image ops, the per-row and ``*_like`` samplers,
the fused multi-tensor updates, Correlation, ``_scatter_set_nd`` and the
dense registry versions of ``_sparse_retain`` and
``_sparse_adagrad_update``.

Each JAX ``custom_vjp`` is a ``torch.autograd.Function``: the forward is
the identity and the backward seeds or scales the gradient.  The update
ops write their weights and states in place, as ``optimizer_ops.py``
does.  The samplers draw from the generator of the device they write to
(``random_ops._gen``); draws are held to their distributions, not to the
JAX package's bits.  Bipartite matching loops over its rounds on the
device, as the JAX op's ``fori_loop`` does.
"""
from __future__ import annotations

import ast

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import _bilinear, _one_hot, pooling
from .optimizer_ops import _clip, _write
from .random_ops import _gen, _gamma, _rowwise
from .registry import register
from .utils import (normalize_axis, paxis, pbool, pdtype, pfloat, pftuple,
                    pint, ptuple)

__all__ = ["make_loss", "svm_output"]


class _ScaleGradFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


@register("MakeLoss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null",
              **kw):
    """Identity forward; the backward scales the incoming gradient by
    ``grad_scale`` (``valid_thresh`` and ``normalization`` change
    nothing, as in the JAX op)."""
    return _ScaleGradFn.apply(data, pfloat(grad_scale, 1.0))


class _SVMOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, margin, reg, linear):
        ctx.save_for_backward(x, y)
        ctx.attrs = (margin, reg, linear)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        # a loss head: the gradient comes from the labels and the
        # incoming gradient is ignored, as for SoftmaxOutput
        x, y = ctx.saved_tensors
        m, reg, linear = ctx.attrs
        target = _one_hot(y, x.shape[1], -1, x.dtype) * 2 - 1
        viol = (m - target * x) > 0
        if linear:
            gx = torch.where(viol, -target * reg, torch.zeros_like(x))
        else:
            gx = torch.where(viol, -2 * (m - target * x) * target * reg,
                             torch.zeros_like(x))
        return gx, None, None, None, None


@register("SVMOutput", num_inputs=2)
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False, **kw):
    """Forward is the identity (the scores); the hinge loss on ``label``
    (squared unless ``use_linear``) drives the backward."""
    return _SVMOutputFn.apply(data, label, pfloat(margin, 1.0),
                              pfloat(regularization_coefficient, 1.0),
                              pbool(use_linear))


# ---------------------------------------------------------------------------
# quantized pass-through ops (int8 stays int8)
# ---------------------------------------------------------------------------


@register("_contrib_quantized_act", num_inputs=3, num_outputs=3,
          differentiable=False)
def _quantized_act(data, min_range, max_range, act_type="relu", **kw):
    if act_type != "relu":
        raise NotImplementedError("quantized activation only supports relu")
    return torch.clamp(data, min=0), torch.zeros_like(min_range), max_range


@register("_contrib_quantized_flatten", num_inputs=3, num_outputs=3,
          differentiable=False)
def _quantized_flatten(data, min_range, max_range, **kw):
    return data.reshape(data.shape[0], -1), min_range, max_range


@register("_contrib_quantized_pooling", num_inputs=3, num_outputs=3,
          differentiable=False)
def _quantized_pooling(data, min_range, max_range, **kw):
    """Pooling of the int8 codes (pooled as f32, which holds them
    exactly; torch has no int8 pooling), back in the input's type."""
    return (pooling(data.to(torch.float32), **kw).to(data.dtype),
            min_range, max_range)


@register("_contrib_quantized_concat", num_inputs=-1, num_outputs=3,
          differentiable=False, aliases=("_quantized_concat",))
def _quantized_concat(*arrays, num_args=None, dim=1, **kw):
    """int8 concat with range reconciliation (reference
    src/operator/quantization/quantized_concat.cc): inputs arrive as
    (data..., arg0_min, arg0_max, arg1_min, arg1_max, ...); each block is
    rescaled from its own range to the widest common one."""
    n = pint(num_args, len(arrays) // 3)
    datas = arrays[:n]
    mins = tuple(arrays[n + 2 * i] for i in range(n))
    maxs = tuple(arrays[n + 2 * i + 1] for i in range(n))
    out_min, out_max = mins[0], maxs[0]
    for m in mins[1:]:
        out_min = torch.minimum(out_min, m)
    for m in maxs[1:]:
        out_max = torch.maximum(out_max, m)

    def scale_of(lo, hi):
        r = torch.maximum(torch.abs(lo), torch.abs(hi))
        return r / torch.full_like(r, 127.0)

    out_scale = scale_of(out_min, out_max)
    blocks = []
    for d, mn, mx in zip(datas, mins, maxs):
        rescaled = torch.round(d.to(torch.float32)
                               * (scale_of(mn, mx) / out_scale))
        blocks.append(torch.clamp(rescaled, -127, 127).to(d.dtype))
    return (torch.cat(blocks, dim=pint(dim, 1)),
            out_min.reshape(()).to(torch.float32),
            out_max.reshape(()).to(torch.float32))


# ---------------------------------------------------------------------------
# tensor utilities (mxnet_tpu/ops/extended.py:57-163)
# ---------------------------------------------------------------------------


@register("add_n", num_inputs=-1, aliases=("ElementWiseSum",))
def add_n(*arrays, num_args=None, **kw):
    """The sum of the inputs, added left to right."""
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


@register("round")
def _round(data, **kw):
    """Half to even, as ``jnp.round``."""
    return torch.round(data)


@register("reshape_like", num_inputs=2)
def _reshape_like(lhs, rhs, **kw):
    return lhs.reshape(rhs.shape)


@register("_identity_with_attr_like_rhs", num_inputs=2)
def _identity_like_rhs(lhs, rhs, **kw):
    return lhs


@register("_zeros_without_dtype", num_inputs=0, differentiable=False)
def _zeros_without_dtype(shape=None, ctx=None, dtype=None, **kw):
    return torch.zeros(ptuple(shape, default=()),
                       dtype=pdtype(dtype) if dtype is not None
                       else torch.float32, device=ctx)


def _edges(lo, hi, bins, dtype, device):
    """``jnp.histogram_bin_edges``: a zero-width range widened by 0.5 each
    side, then ``jnp.linspace``'s ``lo (1 - t) + hi t`` with the last edge
    ``hi`` exactly."""
    lo = torch.as_tensor(lo, dtype=dtype, device=device)
    hi = torch.as_tensor(hi, dtype=dtype, device=device)
    flat = lo == hi
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    t = (torch.arange(bins, dtype=dtype, device=device)
         / torch.tensor(bins, dtype=dtype, device=device))
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


@register("_histogram", num_inputs=-1, num_outputs=2, differentiable=False)
def _histogram(data, *maybe_bins, bin_cnt=None, range=None, **kw):
    """(counts int32, edges): ``bin_cnt`` bins over ``range`` (default the
    data's min and max) or the given edges; each bin half-open but the
    last, values outside dropped, as ``jnp.histogram``.  ``range`` is
    read as floats, as upstream's; the JAX op truncates it to integers
    (``ptuple``)."""
    x = data.reshape(-1)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if maybe_bins:
        edges = maybe_bins[0]
        e = edges.to(x.dtype)
    else:
        cnt = pint(bin_cnt, 10)
        if range is not None:
            lo, hi = pftuple(range)[:2]
        else:
            lo, hi = x.min(), x.max()
        e = edges = _edges(lo, hi, cnt, x.dtype, x.device)
    n = e.numel()
    idx = torch.searchsorted(e, x, right=True)
    idx = torch.where(x == e[-1], torch.full_like(idx, n - 1), idx)
    counts = torch.bincount(idx, minlength=n + 1)[1:n]
    return counts.to(torch.int32), edges


@register("_ravel_multi_index", differentiable=False,
          aliases=("ravel_multi_index",))
def _ravel_multi_index(data, shape=None, **kw):
    """Row-major flat indices of the columns of ``data`` (ndim, N)."""
    dims = ptuple(shape)
    strides = np.concatenate([np.cumprod(dims[::-1])[::-1][1:], [1]])
    s = torch.as_tensor(strides, dtype=data.dtype, device=data.device)
    return torch.sum(data * s[:, None], dim=0).to(data.dtype)


@register("_unravel_index", differentiable=False,
          aliases=("unravel_index",))
def _unravel_index(data, shape=None, **kw):
    """(ndim, N) coordinates of the flat indices ``data`` in ``shape``."""
    dims = ptuple(shape)
    idx = data.to(torch.int64)
    out = []
    for d in reversed(dims):
        out.append(torch.remainder(idx, d))
        idx = torch.div(idx, d, rounding_mode="floor")
    return torch.stack(out[::-1]).to(data.dtype)


@register("_square_sum")
def _square_sum(data, axis=None, keepdims=False, **kw):
    ax = paxis(axis)
    dims = tuple(range(data.dim())) if ax is None else ax
    return torch.sum(data.square(), dim=dims, keepdim=pbool(keepdims))


@register("_split_v2", num_outputs=lambda attrs: (
    pint(attrs.get("sections"), 0) or
    len(ptuple(attrs.get("indices"), default=())) + 1))
def _split_v2(data, indices=None, axis=0, squeeze_axis=False, sections=0,
              **kw):
    """``sections`` equal parts, or the parts between the split points
    ``indices`` (a leading 0 gives an empty first part), as
    ``jnp.split``."""
    ax = normalize_axis(pint(axis, 0), data.dim())
    sections = pint(sections, 0)
    if sections:
        if data.shape[ax] % sections:
            raise ValueError("array split does not result in an equal "
                             "division")
        parts = torch.split(data, data.shape[ax] // sections, dim=ax)
    else:
        parts = torch.tensor_split(
            data, list(ptuple(indices, default=())), dim=ax)
    if pbool(squeeze_axis):
        parts = [p.squeeze(ax) for p in parts]
    return tuple(parts) if len(parts) > 1 else parts[0]


def _opt_tuple(v):
    """A begin/end/step attribute whose entries may be None."""
    if v is None:
        return ()
    if isinstance(v, str):
        v = ast.literal_eval(v.strip() or "()")
    if isinstance(v, (int, np.integer)):
        v = (v,)
    return tuple(None if x is None else int(x) for x in v)


def _slice_index(data, begin, end, step):
    """The index of ``data[begin:end:step]`` per axis: slices, or, where a
    step is negative (torch has no negative slices), one index tensor an
    axis, shaped to broadcast as an outer product."""
    b, e = _opt_tuple(begin), _opt_tuple(end)
    s = _opt_tuple(step) or (1,) * len(b)
    sl = [slice(bb, ee, ss or 1) for bb, ee, ss in zip(b, e, s)]
    if all(x.step > 0 for x in sl):
        return tuple(sl)
    idx = []
    for ax, x in enumerate(sl):
        r = torch.arange(*x.indices(data.shape[ax]), device=data.device)
        idx.append(r.reshape([-1 if i == ax else 1
                              for i in range(len(sl))]))
    return tuple(idx)


@register("_slice_assign", num_inputs=2, aliases=("_crop_assign",))
def _slice_assign(data, value, begin=None, end=None, step=None, **kw):
    out = data.clone()
    out[_slice_index(data, begin, end, step)] = value.to(data.dtype)
    return out


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(data, scalar=0.0, begin=None, end=None, step=None,
                         **kw):
    out = data.clone()
    out[_slice_index(data, begin, end, step)] = pfloat(scalar, 0.0)
    return out


@register("cast_storage")
def _cast_storage_op(data, stype="default", **kw):
    """The identity on tensors: storage types live in the NDArray layer
    (``mx.nd.cast_storage`` and ``tostype`` reach ndarray.sparse)."""
    return data


# ---------------------------------------------------------------------------
# gradient ops (:185-235)
# ---------------------------------------------------------------------------


@register("_contrib_gradientmultiplier")
def _gradient_multiplier(data, scalar=1.0, **kw):
    """Identity forward; the backward multiplies the gradient by
    ``scalar``."""
    return _ScaleGradFn.apply(data, pfloat(scalar, 1.0))


@register("IdentityAttachKLSparseReg")
def _identity_kl_sparse(data, sparseness_target=0.1, penalty=0.001,
                        momentum=0.9, **kw):
    """The identity, as in the JAX op (the KL penalty's gradient is not
    added there either)."""
    return data


# ---------------------------------------------------------------------------
# spatial ops (:242-338)
# ---------------------------------------------------------------------------


def _bilinear_gather(data, gx, gy):
    """``data`` (N, C, H, W) sampled at fractional pixels ``gx``/``gy``
    (N, Ho, Wo), zero outside."""
    from .deformable import bilinear_mix

    N, C, H, W = data.shape
    flat = data.reshape(N, C, H * W)

    def gather(yc, xc):
        idx = (yc * W + xc).reshape(N, 1, -1).expand(N, C, -1)
        return torch.gather(flat, 2, idx).reshape(
            (N, C) + tuple(yc.shape[2:]))

    return bilinear_mix(gather, gy[:, None], gx[:, None], H, W)


@register("BilinearSampler", num_inputs=2)
def _bilinear_sampler(data, grid, cudnn_off=None, **kw):
    """``grid`` (N, 2, Ho, Wo) in [-1, 1]: channel 0 x, channel 1 y."""
    _N, _C, H, W = data.shape
    gx = (grid[:, 0] + 1) * (W - 1) / 2
    gy = (grid[:, 1] + 1) * (H - 1) / 2
    return _bilinear_gather(data, gx, gy)


def _unit_grid(H, W, dtype, device):
    ys = torch.linspace(-1, 1, H, dtype=dtype, device=device)
    xs = torch.linspace(-1, 1, W, dtype=dtype, device=device)
    return torch.meshgrid(ys, xs, indexing="ij")


@register("GridGenerator", num_inputs=-1)
def _grid_generator(data, transform_type="affine", target_shape=None,
                    **kw):
    """affine: each (2, 3) theta applied to the target's unit grid; warp:
    the (N, 2, H, W) flow, in pixels, added to the identity grid."""
    if transform_type == "affine":
        H, W = ptuple(target_shape, default=(0, 0))
        N = data.shape[0]
        theta = data.reshape(N, 2, 3)
        gy, gx = _unit_grid(H, W, data.dtype, data.device)
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones(H * W, dtype=data.dtype,
                                       device=data.device)])
        return torch.einsum("nij,jk->nik", theta, base).reshape(N, 2, H, W)
    N, _two, H, W = data.shape
    gy, gx = _unit_grid(H, W, data.dtype, data.device)
    ident = torch.stack([gx, gy])[None]
    norm = torch.tensor([2.0 / max(W - 1, 1), 2.0 / max(H - 1, 1)],
                        dtype=data.dtype, device=data.device)
    return ident + data * norm.reshape(1, 2, 1, 1)


@register("SpatialTransformer", num_inputs=2)
def _spatial_transformer(data, loc, target_shape=None,
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=None, **kw):
    grid = _grid_generator(loc, transform_type="affine",
                           target_shape=target_shape)
    return _bilinear_sampler(data, grid)


@register("Crop", num_inputs=-1)
def _crop(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False,
          num_args=1, **kw):
    """The (h, w) window of ``h_w`` (or of the second input's spatial
    shape) at ``offset`` or centred."""
    data = inputs[0]
    if len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = ptuple(h_w, default=(0, 0))
    H, W = data.shape[2], data.shape[3]
    if pbool(center_crop):
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = ptuple(offset, default=(0, 0))
    return data[:, :, y0:y0 + th, x0:x0 + tw]


@register("_contrib_AdaptiveAvgPooling2D")
def _adaptive_avg_pool(data, output_size=None, **kw):
    """Cell (i, j) averages rows [floor(iH/oh), ceil((i+1)H/oh)) and the
    columns alike: the reference's and torch's binning."""
    size = ptuple(output_size, default=(1, 1))
    if len(size) == 1:
        size = size * 2
    return F.adaptive_avg_pool2d(data, size)


# ---------------------------------------------------------------------------
# fft, boolean_mask, bipartite matching (:344-427)
# ---------------------------------------------------------------------------


@register("_contrib_fft", differentiable=False)
def _fft(data, compute_size=128, **kw):
    """Last-axis FFT, real and imaginary parts interleaved on the last
    axis (which doubles), f32."""
    out = torch.fft.fft(data.to(torch.complex64), dim=-1)
    packed = torch.stack([out.real, out.imag], dim=-1)
    return packed.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],))\
        .to(torch.float32)


@register("_contrib_ifft", differentiable=False)
def _ifft(data, compute_size=128, **kw):
    """The inverse of ``_contrib_fft``'s layout, not normalized: n times
    the inverse transform's real part, as the reference's."""
    n = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (n, 2))
    cplx = torch.complex(pairs[..., 0].to(torch.float32),
                         pairs[..., 1].to(torch.float32))
    return torch.fft.ifft(cplx, dim=-1).real.to(torch.float32) * n


@register("_contrib_boolean_mask", num_inputs=2, static_inputs=(1,),
          aliases=("boolean_mask",))
def _boolean_mask(data, index, axis=0, **kw):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero;
    the output's shape depends on the mask's values.  The gradient goes
    to the kept slices."""
    keep = torch.nonzero(index.reshape(-1) != 0).reshape(-1)
    return torch.index_select(data, pint(axis, 0), keep)


@register("_contrib_bipartite_matching", num_outputs=2,
          differentiable=False)
def _bipartite_matching(data, is_ascend=False, threshold=None, topk=-1,
                        **kw):
    """Greedy matching over score matrices (reference bounding_box.cc):
    each round takes the best remaining (row, column) pair of every
    matrix while it passes the threshold strictly, for min(N, M) rounds
    (or ``topk``); (row -> column, column -> row) as f32, -1 unmatched."""
    thr = pfloat(threshold, 0.5)
    asc = pbool(is_ascend)
    k = pint(topk, -1)
    work = data.reshape((-1,) + tuple(data.shape[-2:])).to(torch.float32)\
        .clone()
    B, N, M = work.shape
    rounds = min(N, M) if k <= 0 else min(k, N, M)
    bad = float("inf") if asc else float("-inf")
    rows = torch.full((B, N), -1.0, device=data.device)
    cols = torch.full((B, M), -1.0, device=data.device)
    b = torch.arange(B, device=data.device)
    for _ in range(rounds):
        flat = work.reshape(B, -1)
        pick = torch.argmin(flat, 1) if asc else torch.argmax(flat, 1)
        i, j = pick // M, pick % M
        best = flat[b, pick]
        ok = best < thr if asc else best > thr
        rows[b, i] = torch.where(ok, j.to(torch.float32), rows[b, i])
        cols[b, j] = torch.where(ok, i.to(torch.float32), cols[b, j])
        okf = ok[:, None]
        work[b, i, :] = torch.where(okf, bad, work[b, i, :])
        work[b, :, j] = torch.where(okf, bad, work[b, :, j])
    return (rows.reshape(data.shape[:-1]),
            cols.reshape(tuple(data.shape[:-2]) + (M,)))


# ---------------------------------------------------------------------------
# image ops (:433-473)
# ---------------------------------------------------------------------------


@register("_image_to_tensor")
def _image_to_tensor(data, **kw):
    """HWC [0, 255] -> CHW f32 [0, 1] (batched: NHWC -> NCHW)."""
    x = data.to(torch.float32) / 255.0
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize")
def _image_normalize(data, mean=(0, 0, 0), std=(1, 1, 1), **kw):
    """(data - mean) / std per channel of CHW or NCHW data."""
    m = torch.tensor(pftuple(mean, default=(0, 0, 0)), dtype=torch.float32,
                     device=data.device)
    s = torch.tensor(pftuple(std, default=(1, 1, 1)), dtype=torch.float32,
                     device=data.device)
    c = data.shape[0] if data.dim() == 3 else data.shape[1]
    shape = (c, 1, 1) if data.dim() == 3 else (1, c, 1, 1)
    return (data - m[:c].reshape(shape)) / s[:c].reshape(shape)


def _nearest_index(n_in, n_out, device):
    """``jax.image.resize``'s nearest taps: floor((i + 0.5) n_in / n_out),
    computed in f32."""
    off = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * n_in / n_out
    return torch.floor(off).to(torch.int64)


@register("_image_resize", differentiable=False)
def _image_resize(data, size=None, keep_ratio=False, interp=1, **kw):
    """HWC or NHWC data to (h, w) of ``size`` = (w, h): bilinear (f32,
    half-pixel centres, antialiased when shrinking, as
    ``jax.image.resize``) or nearest (``interp`` 0, the input's type)."""
    sz = ptuple(size, default=(0, 0))
    if len(sz) == 1:
        sz = sz * 2
    w, h = sz
    x = data if data.dim() == 4 else data[None]
    if pint(interp, 1):
        y = _bilinear(x.to(torch.float32).permute(0, 3, 1, 2), h, w)
        y = y.permute(0, 2, 3, 1)
    else:
        y = x[:, _nearest_index(x.shape[1], h, x.device)]
        y = y[:, :, _nearest_index(x.shape[2], w, x.device)]
    return y if data.dim() == 4 else y[0]


@register("_image_crop", differentiable=False)
def _image_crop(data, x=0, y=0, width=0, height=0, **kw):
    x0, y0 = pint(x, 0), pint(y, 0)
    w, h = pint(width, 0), pint(height, 0)
    if data.dim() == 3:
        return data[y0:y0 + h, x0:x0 + w, :]
    return data[:, y0:y0 + h, x0:x0 + w, :]


# ---------------------------------------------------------------------------
# per-row samplers and the *_like samplers (:480-584): ``shape`` draws for
# each element of the parameter arrays, or one draw per element of ``data``
# ---------------------------------------------------------------------------


def _draw_shape(param, shape):
    s = ptuple(shape, default=()) or ()
    return tuple(param.shape) + s, s


def _per_row(param, s, full):
    return _rowwise(param, s).expand(full).to(torch.float32).contiguous()


@register("_sample_exponential", uses_rng=True, differentiable=False)
def _sample_exponential(lam, shape=None, dtype="float32", **kw):
    full, s = _draw_shape(lam, shape)
    e = torch.empty(full, dtype=pdtype(dtype), device=lam.device)\
        .exponential_(1.0, generator=_gen(lam.device))
    return e / _rowwise(lam, s)


@register("_sample_gamma", uses_rng=True, num_inputs=2,
          differentiable=False)
def _sample_gamma(alpha, beta, shape=None, dtype="float32", **kw):
    full, s = _draw_shape(alpha, shape)
    g = _gamma(_per_row(alpha, s, full), full, alpha.device,
               _gen(alpha.device))
    return (g * _rowwise(beta, s)).to(pdtype(dtype))


@register("_sample_poisson", uses_rng=True, differentiable=False)
def _sample_poisson(lam, shape=None, dtype="float32", **kw):
    full, s = _draw_shape(lam, shape)
    return torch.poisson(_per_row(lam, s, full),
                         generator=_gen(lam.device)).to(pdtype(dtype))


@register("_sample_negative_binomial", uses_rng=True, num_inputs=2,
          differentiable=False)
def _sample_negative_binomial(k, p, shape=None, dtype="float32", **kw):
    """Poisson of a Gamma(k, (1 - p) / p) rate."""
    full, s = _draw_shape(k, shape)
    gen = _gen(k.device)
    pp = _per_row(p, s, full)
    lam = _gamma(_per_row(k, s, full), full, k.device, gen) * (1 - pp) / pp
    return torch.poisson(lam, generator=gen).to(pdtype(dtype))


@register("_sample_generalized_negative_binomial", uses_rng=True,
          num_inputs=2, differentiable=False)
def _sample_gen_negative_binomial(mu, alpha, shape=None, dtype="float32",
                                  **kw):
    """Poisson of a Gamma(1 / alpha, mu alpha) rate: mean mu, variance
    mu + alpha mu^2."""
    full, s = _draw_shape(mu, shape)
    gen = _gen(mu.device)
    m, a = _per_row(mu, s, full), _per_row(alpha, s, full)
    r = 1.0 / torch.clamp(a, min=1e-12)
    lam = _gamma(r, full, mu.device, gen) * m * a
    return torch.poisson(lam, generator=gen).to(pdtype(dtype))


def _like_uniform(shape, dev, gen, a):
    return torch.empty(shape, device=dev).uniform_(a["low"], a["high"],
                                                   generator=gen)


def _like_normal(shape, dev, gen, a):
    return torch.empty(shape, device=dev).normal_(generator=gen) \
        * a["scale"] + a["loc"]


def _like_exponential(shape, dev, gen, a):
    return torch.empty(shape, device=dev).exponential_(
        1.0, generator=gen) / a["lam"]


def _like_gamma(shape, dev, gen, a):
    return _gamma(a["alpha"], shape, dev, gen) * a["beta"]


def _like_poisson(shape, dev, gen, a):
    return torch.poisson(torch.full(shape, a["lam"], device=dev),
                         generator=gen)


def _like_negative_binomial(shape, dev, gen, a):
    lam = _gamma(a["k"], shape, dev, gen) * (1 - a["p"]) / max(a["p"], 1e-12)
    return torch.poisson(lam, generator=gen)


def _like_gen_negative_binomial(shape, dev, gen, a):
    lam = _gamma(1.0 / max(a["alpha"], 1e-12), shape, dev, gen) \
        * a["mu"] * a["alpha"]
    return torch.poisson(lam, generator=gen)


def _register_like(name, draw):
    @register(name, uses_rng=True, differentiable=False)
    def _like(data, loc=0.0, scale=1.0, lam=1.0, low=0.0, high=1.0,
              alpha=1.0, beta=1.0, mu=1.0, k=1, p=1, **kw):
        attrs = dict(loc=pfloat(loc, 0.0), scale=pfloat(scale, 1.0),
                     lam=pfloat(lam, 1.0), low=pfloat(low, 0.0),
                     high=pfloat(high, 1.0), alpha=pfloat(alpha, 1.0),
                     beta=pfloat(beta, 1.0), mu=pfloat(mu, 1.0),
                     k=pfloat(k, 1), p=pfloat(p, 1))
        out = draw(tuple(data.shape), data.device, _gen(data.device), attrs)
        return out.to(data.dtype)

    _like.__doc__ = "One draw per element of ``data``, in its type."
    return _like


for _name, _draw in (
        ("_random_uniform_like", _like_uniform),
        ("_random_normal_like", _like_normal),
        ("_random_exponential_like", _like_exponential),
        ("_random_gamma_like", _like_gamma),
        ("_random_poisson_like", _like_poisson),
        ("_random_negative_binomial_like", _like_negative_binomial),
        ("_random_generalized_negative_binomial_like",
         _like_gen_negative_binomial)):
    _register_like(_name, _draw)
del _name, _draw


# ---------------------------------------------------------------------------
# fused updates (:590-673, :741-790): rescale, clip, then the update, in
# the JAX op's order; weights and states written in place
# ---------------------------------------------------------------------------


def _multi_attrs(kw, n):
    lrs = list(pftuple(kw.get("lrs"), default=(0.01,) * n))
    wds = list(pftuple(kw.get("wds"), default=(0.0,) * n))
    return lrs, wds


def _scaled(g, rescale_grad, clip_gradient):
    return _clip(g * pfloat(rescale_grad, 1.0), clip_gradient)


@register("multi_sgd_update", num_inputs=-1,
          num_outputs=lambda a: pint(a.get("num_weights"), 1),
          mutate_inputs=tuple(2 * i for i in range(60)),
          differentiable=False)
def _multi_sgd_update(*arrays, num_weights=None, rescale_grad=1.0,
                      clip_gradient=-1.0, **kw):
    """(weight, grad) pairs: w -= lr (g + wd w) each."""
    n = pint(num_weights, len(arrays) // 2)
    lrs, wds = _multi_attrs(kw, n)
    ws = [arrays[2 * i] for i in range(n)]
    new = [w - lrs[i] * (_scaled(arrays[2 * i + 1], rescale_grad,
                                 clip_gradient) + wds[i] * w)
           for i, w in enumerate(ws)]
    return _write(ws, new)


@register("multi_sgd_mom_update", num_inputs=-1,
          num_outputs=lambda a: 2 * pint(a.get("num_weights"), 1),
          mutate_inputs=tuple(x for i in range(60)
                              for x in (3 * i, 3 * i + 2)),
          differentiable=False)
def _multi_sgd_mom_update(*arrays, num_weights=None, momentum=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """(weight, grad, mom) triples."""
    n = pint(num_weights, len(arrays) // 3)
    lrs, wds = _multi_attrs(kw, n)
    mom = pfloat(momentum, 0.0)
    dsts, srcs = [], []
    for i in range(n):
        w, g, m = arrays[3 * i], arrays[3 * i + 1], arrays[3 * i + 2]
        g = _scaled(g, rescale_grad, clip_gradient)
        new_m = mom * m - lrs[i] * (g + wds[i] * w)
        dsts += [w, m]
        srcs += [w + new_m, new_m]
    return _write(dsts, srcs)


@register("multi_mp_sgd_update", num_inputs=-1,
          num_outputs=lambda a: 2 * pint(a.get("num_weights"), 1),
          mutate_inputs=tuple(x for i in range(60)
                              for x in (3 * i, 3 * i + 2)),
          differentiable=False)
def _multi_mp_sgd_update(*arrays, num_weights=None, rescale_grad=1.0,
                         clip_gradient=-1.0, **kw):
    """(weight, grad, weight32) triples: the step on the f32 master copy,
    the weight its cast."""
    n = pint(num_weights, len(arrays) // 3)
    lrs, wds = _multi_attrs(kw, n)
    dsts, srcs = [], []
    for i in range(n):
        w, g, w32 = arrays[3 * i], arrays[3 * i + 1], arrays[3 * i + 2]
        g = _scaled(g.to(torch.float32), rescale_grad, clip_gradient)
        new_w32 = w32 - lrs[i] * (g + wds[i] * w32)
        dsts += [w, w32]
        srcs += [new_w32.to(w.dtype), new_w32]
    return _write(dsts, srcs)


@register("multi_mp_sgd_mom_update", num_inputs=-1,
          num_outputs=lambda a: 3 * pint(a.get("num_weights"), 1),
          mutate_inputs=tuple(x for i in range(60)
                              for x in (4 * i, 4 * i + 2, 4 * i + 3)),
          differentiable=False)
def _multi_mp_sgd_mom_update(*arrays, num_weights=None, momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """(weight, grad, mom, weight32) quadruples."""
    n = pint(num_weights, len(arrays) // 4)
    lrs, wds = _multi_attrs(kw, n)
    mom = pfloat(momentum, 0.0)
    dsts, srcs = [], []
    for i in range(n):
        w, g, m, w32 = arrays[4 * i:4 * i + 4]
        g = _scaled(g.to(torch.float32), rescale_grad, clip_gradient)
        new_m = mom * m - lrs[i] * (g + wds[i] * w32)
        new_w32 = w32 + new_m
        dsts += [w, m, w32]
        srcs += [new_w32.to(w.dtype), new_m, new_w32]
    return _write(dsts, srcs)


@register("_mp_adamw_update", num_inputs=5, num_outputs=4,
          mutate_inputs=(0, 2, 3, 4), differentiable=False)
def _mp_adamw_update(weight, grad, mean, var, weight32, lr=None,
                     beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                     eta=1.0, rescale_grad=1.0, clip_gradient=-1.0, **kw):
    """AdamW on the f32 master copy: w32 -= eta (lr m / (sqrt(v) + eps) +
    wd w32)."""
    g = _scaled(grad.to(torch.float32), rescale_grad, clip_gradient)
    b1, b2 = pfloat(beta1, 0.9), pfloat(beta2, 0.999)
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * g.square()
    w32 = weight32 - pfloat(eta, 1.0) * (
        pfloat(lr) * new_mean / (torch.sqrt(new_var) + pfloat(epsilon, 1e-8))
        + pfloat(wd, 0.0) * weight32)
    return _write([weight, mean, var, weight32],
                  [w32.to(weight.dtype), new_mean, new_var, w32])


@register("_contrib_group_adagrad_update", num_inputs=3, num_outputs=2,
          mutate_inputs=(0, 2), differentiable=False)
def _group_adagrad_update(weight, grad, history, lr=None, rescale_grad=1.0,
                          clip_gradient=-1.0, epsilon=1e-5, **kw):
    """AdaGrad with one history value a row (the mean square over the
    row's other axes; history (rows, 1) for 2-D weights).  The results
    are new arrays, as the JAX op's: a history of another shape is
    broadcast there."""
    g = _scaled(grad, rescale_grad, clip_gradient)
    grp = torch.mean(g.square(), dim=tuple(range(1, g.dim())),
                     keepdim=True) if g.dim() > 1 else g.square()
    new_hist = history + grp
    return (weight - pfloat(lr) * g / (torch.sqrt(new_hist)
                                       + pfloat(epsilon, 1e-5)), new_hist)


# ---------------------------------------------------------------------------
# _scatter_set_nd (:731), Correlation (:792-856), the dense sparse ops
# (:858-900)
# ---------------------------------------------------------------------------


@register("_scatter_set_nd", num_inputs=3, mutate_inputs=(0,))
def _scatter_set_nd(lhs, indices, rhs, shape=None, **kw):
    """``lhs`` with ``rhs`` written at the gather_nd-style ``indices``
    (ndim, N) (reference indexing_op.cc)."""
    idx = tuple(indices[i].to(torch.int64) for i in range(indices.shape[0]))
    out = lhs.clone()
    out[idx] = rhs.to(lhs.dtype)
    return out


@register("Correlation", num_inputs=2, num_outputs=1)
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True, **kw):
    """FlowNet's correlation (reference correlation.cc): for each output
    pixel, a kernel_size^2 patch of data1 against data2's patches on a
    (2R+1)^2 grid of displacements (R = max_displacement / stride2), the
    product (or absolute difference) averaged over patch and channels;
    displacements on the channel axis, vertical the slow one."""
    ks = pint(kernel_size, 1)
    if ks % 2 == 0:
        raise MXNetError("Correlation: kernel size should be odd number "
                         "(reference correlation-inl.h:81)")
    md, s1, s2 = pint(max_displacement, 1), pint(stride1, 1), \
        pint(stride2, 1)
    pad = pint(pad_size, 0)
    mul = pbool(is_multiply, True)
    _n, c, h, w = data1.shape
    p1 = F.pad(data1, (pad, pad, pad, pad))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    kr = (ks - 1) // 2
    border = md + kr
    ph, pw = h + 2 * pad, w + 2 * pad
    top_h = -(-(ph - 2 * border) // s1)
    top_w = -(-(pw - 2 * border) // s1)
    grid_r = md // s2
    sumelems = ks * ks * c
    ext_h = (top_h - 1) * s1 + ks
    ext_w = (top_w - 1) * s1 + ks
    a = p1[:, :, md:md + ext_h, md:md + ext_w]
    outs = []
    for pi in range(2 * grid_r + 1):
        dy = (pi - grid_r) * s2
        for oi in range(2 * grid_r + 1):
            dx = (oi - grid_r) * s2
            b = p2[:, :, md + dy:md + dy + ext_h, md + dx:md + dx + ext_w]
            e = (a * b if mul else torch.abs(a - b)).sum(dim=1)
            win = F.avg_pool2d(e[:, None], ks, stride=s1,
                               divisor_override=1)[:, 0]
            outs.append(win / sumelems)
    return torch.stack(outs, dim=1)


@register("_sparse_retain", num_inputs=2)
def _sparse_retain_op(data, indices, **kw):
    """``data`` with every row not in ``indices`` zero (reference
    sparse_retain.cc) on a dense tensor; ``mx.nd._sparse_retain`` of a
    RowSparseNDArray keeps its components (ndarray.sparse.retain)."""
    keep = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    keep[indices.to(torch.int64)] = True
    return torch.where(keep.reshape((-1,) + (1,) * (data.dim() - 1)),
                       data, torch.zeros((), dtype=data.dtype,
                                         device=data.device))


@register("_sparse_adagrad_update", num_inputs=3, mutate_inputs=(0, 2),
          num_outputs=2, differentiable=False)
def _sparse_adagrad_update(weight, grad, history, lr=None, epsilon=1e-7,
                           rescale_grad=1.0, clip_gradient=-1.0, wd=0.0,
                           **kw):
    """AdaGrad step on dense tensors (reference optimizer_op.cc
    _sparse_adagrad_update); ``mx.nd._sparse_adagrad_update`` with a
    RowSparseNDArray gradient updates only its rows."""
    g = _scaled(grad, rescale_grad, clip_gradient)
    wd_f = pfloat(wd, 0.0)
    if wd_f:
        g = g + wd_f * weight
    new_hist = history + g.square()
    new_w = weight - pfloat(lr) * g / (torch.sqrt(new_hist)
                                       + pfloat(epsilon, 1e-7))
    return _write([weight, history], [new_w, new_hist])
