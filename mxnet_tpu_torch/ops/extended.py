"""The training heads of mxnet_tpu/ops/extended.py (parity: MakeLoss
:170, SVMOutput :197; the reference's make_loss.cc and svm_output.cc)
and its quantized pass-through ops (:676-730: int8 stays int8).  Each
JAX ``custom_vjp`` is a ``torch.autograd.Function``: the forward is the
identity and the backward seeds the loss gradient."""
from __future__ import annotations

import torch

from .nn import _one_hot, pooling
from .registry import register
from .utils import pbool, pfloat, pint

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
