"""The fused ops that the graph-fusion patterns emit (parity:
mxnet_tpu/ops/fused.py; symbol/fusion.py rewrites graphs into them).

They are compositions of torch calls, as the JAX ones are of jnp calls.
Two recipes recur:

* ``_contrib_conv_bn_relu`` and ``_contrib_norm_act`` keep only the
  normalization's input (the convolution's output) and the per-channel
  affine for the backward, and recompute the normalize-and-activate tail
  there (``torch.utils.checkpoint`` without reentry, the counterpart of
  the JAX ops' ``jax.checkpoint``): one activation-sized tensor fewer
  held from the forward to the backward.  The tail is the BatchNorm op's
  own ``F.batch_norm`` call and the Activation op's function, so the
  fused op gives what the unfused Convolution -> BatchNorm
  (-> Activation) graph gives, with or without the activation, in
  training and in prediction.
* ``_contrib_layer_norm_fused`` computes the statistics in one pass
  (mean and mean of squares in f32, ``var = E[x^2] - E[x]^2`` clamped at
  0): a different rounding from LayerNorm's, so its pattern is off until
  a cost table measures it faster.

``_contrib_add_act`` and ``_contrib_act_scale_add`` are the same torch
expressions as the graphs they replace, one node each.

The conv bias comes last among the inputs, so the auxiliary states keep
their positions with and without it: ``data, weight, gamma, beta,
moving_mean, moving_var[, bias]``.  Outputs are BatchNorm's ``(out,
mean, var)`` with one visible output; the executor updates the moving
stats from them as it does for BatchNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import autograd
from .nn import _CONV, _window_attrs, activation
from .registry import register
from .utils import pbool, pint, pfloat, ptuple, normalize_axis

__all__ = ["conv_bn_relu", "add_act", "act_scale_add", "layer_norm_fast",
           "norm_act"]


def _apply_act(x, act):
    """The Activation op's own function, so the fused expression and its
    gradient are the unfused graph's."""
    return activation(x, act_type=act) if act else x


def _norm_act(x, mean, var, g, b, eps, act, training):
    """BatchNorm over axis 1 (batch statistics when ``training``, else
    ``mean``/``var``), then the activation."""
    if training:
        out = F.batch_norm(x, None, None, g, b, training=True, eps=eps)
    else:
        out = F.batch_norm(x, mean, var, g, b, training=False, eps=eps)
    return _apply_act(out, act)


def _bn_tail(x, moving_mean, moving_var, gamma, beta, eps, fix_gamma,
             use_global_stats, act):
    """``(out, mean, var)`` of BatchNorm -> activation on ``x``, the tail
    recomputed in the backward."""
    g = torch.ones_like(gamma) if pbool(fix_gamma, True) else gamma
    training = not pbool(use_global_stats) and autograd.is_training()
    if training:
        red = [i for i in range(x.dim()) if i != 1]
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=red, correction=0)
    else:
        mean, var = moving_mean, moving_var
    out = checkpoint(_norm_act, x, mean, var, g, beta, eps, act or "",
                     training, use_reentrant=False)
    return out, mean, var


@register("_contrib_conv_bn_relu", num_inputs=-1, num_outputs=3,
          visible_outputs=1)
def conv_bn_relu(data, weight, gamma, beta, moving_mean, moving_var,
                 bias=None, kernel=None, stride=None, dilate=None, pad=None,
                 num_filter=None, num_group=1, no_bias=True, layout=None,
                 workspace=None, cudnn_tune=None, cudnn_off=None,
                 eps=1e-3, momentum=0.9, fix_gamma=True,
                 use_global_stats=False, act_type="relu", **kw):
    """Convolution -> BatchNorm [-> activation] as one op.  ``eps`` and
    ``fix_gamma`` default as the BatchNorm op's do: the fusion pass
    copies only the attributes that were set."""
    nd = data.dim() - 2
    _, stride, dilate, pad = _window_attrs(kernel, stride, dilate, pad, nd)
    if pbool(no_bias, True):
        bias = None
    y = _CONV[nd](data, weight, bias, stride=stride, padding=pad,
                  dilation=dilate, groups=pint(num_group, 1))
    return _bn_tail(y, moving_mean, moving_var, gamma, beta,
                    pfloat(eps, 1e-3), fix_gamma, use_global_stats, act_type)


@register("_contrib_add_act", num_inputs=2)
def add_act(lhs, rhs, act_type="relu", **kw):
    """(lhs + rhs) -> activation: a bias add or a residual join (the
    ResNet v1 unit's tail) and its activation."""
    return _apply_act(lhs + rhs, act_type or "relu")


@register("_contrib_act_scale_add", num_inputs=-1)
def act_scale_add(data, *rest, act_type="relu", scalar=None, **kw):
    """activation -> scale -> add as one op.  With ``scalar`` the inputs
    are (data, addend) and the scale is the scalar; else (data, scale,
    addend)."""
    y = _apply_act(data, act_type or "relu")
    if scalar is not None:
        (add_rhs,) = rest
        y = y * float(scalar)
    else:
        mul_rhs, add_rhs = rest
        y = y * mul_rhs
    return y + add_rhs


def layer_norm_fast(data, gamma, beta, axis=-1, eps=1e-5):
    """LayerNorm from one pass of statistics: mean and mean of squares
    in f32, ``var = E[x^2] - E[x]^2`` clamped at 0."""
    ax = normalize_axis(pint(axis, -1), data.dim())
    xf = data.float()
    mean = xf.mean(dim=ax, keepdim=True)
    meansq = (xf * xf).mean(dim=ax, keepdim=True)
    var = (meansq - mean * mean).clamp(min=0.0)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    out = ((xf - mean) * torch.rsqrt(var + pfloat(eps, 1e-5))).to(data.dtype)
    return out * gamma.reshape(shape) + beta.reshape(shape)


register("_contrib_layer_norm_fused", num_inputs=3)(
    lambda data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
    **kw: layer_norm_fast(data, gamma, beta, axis=axis, eps=eps))


@register("_contrib_norm_act", num_inputs=5, num_outputs=3,
          visible_outputs=1)
def norm_act(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
             momentum=0.9, fix_gamma=True, use_global_stats=False,
             axis=1, act_type="relu", **kw):
    """BatchNorm -> activation as one op, for the BatchNorm nodes the
    conv fusion cannot reach (a convolution output with two consumers):
    BatchNorm's train and predict semantics and ``(out, mean, var)``."""
    if pint(axis, 1) != 1:
        raise ValueError("only channel axis 1 is ported")
    return _bn_tail(data, moving_mean, moving_var, gamma, beta,
                    pfloat(eps, 1e-3), fix_gamma, use_global_stats, act_type)
