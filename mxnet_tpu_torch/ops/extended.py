"""The training heads of mxnet_tpu/ops/extended.py (parity: MakeLoss
:170, SVMOutput :197; the reference's make_loss.cc and svm_output.cc).
Each JAX ``custom_vjp`` is a ``torch.autograd.Function``: the forward is
the identity and the backward seeds the loss gradient."""
from __future__ import annotations

import torch

from .nn import _one_hot
from .registry import register
from .utils import pbool, pfloat

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
