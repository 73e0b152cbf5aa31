"""Neural-net ops on torch tensors, registered in the op registry (parity:
mxnet_tpu/ops/nn.py — FullyConnected :30, Convolution :62, Pooling :129,
Activation :184, BatchNorm :237, LayerNorm :271, Embedding :474; and
log_softmax and pick of mxnet_tpu/ops/tensor.py).

cuDNN and cuBLAS carry these through ``torch.nn.functional``, as XLA
carried them on the TPU; none of them is a Pallas kernel there.

Under a dtype policy's scope, FullyConnected and Convolution compute in
their weight's dtype (``dtype_policy.harmonize``), and BatchNorm gives
the JAX op's dtypes when data and parameters differ: its output takes
the promoted dtype of the data, the statistics and gamma/beta (bf16 data
with f32 gamma gives f32), and the batch statistics take the data's.
LayerNorm is the plain formula of the JAX op (its fused one-pass kernel
runs only under a fusion plan, which nothing on the ported paths sets),
so it has the same dtype flow: bf16 data with f32 gamma gives f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dtype_policy import harmonize
from .registry import register
from .utils import pbool, pfloat, pint, paxis, normalize_axis

__all__ = ["fully_connected", "convolution", "pooling", "activation",
           "batch_norm", "layer_norm", "embedding", "log_softmax", "pick"]


@register("FullyConnected", num_inputs=-1)
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kw):
    data = harmonize(data, weight)
    if pbool(no_bias):
        bias = None
    if pbool(flatten, True) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


@register("Convolution", num_inputs=-1)
def convolution(data, weight, bias=None, kernel=None, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), num_filter=None, num_group=1,
                no_bias=False, layout="NCHW", **kw):
    if layout not in (None, "NCHW"):
        raise ValueError("only the NCHW layout is ported")
    data = harmonize(data, weight)
    if pbool(no_bias):
        bias = None
    # symmetric (p, p) padding, as lax.conv_general_dilated is given there
    return F.conv2d(data, weight, bias, stride=tuple(stride),
                    padding=tuple(pad), dilation=tuple(dilate),
                    groups=num_group)


@register("Pooling")
def pooling(data, kernel=(1, 1), pool_type="max", global_pool=False,
            stride=None, pad=(0, 0), pooling_convention="valid", **kw):
    """2-D max or average pooling with the reference's padding rules: the
    input is padded explicitly (-inf for max, 0 for avg, and the average
    counts the padding) and the window never sees more; the 'full'
    convention pads the high edge so every window fits, which is ceil mode
    without torch's rule of dropping a last window that starts in the
    padding."""
    nd = data.dim() - 2
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * nd
        pad = (0,) * nd
    kernel = tuple(kernel)
    stride = tuple(stride) if stride is not None else (1,) * nd
    pad = tuple(pad)
    extra = [0] * nd
    if pooling_convention == "full":
        for i in range(nd):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = 0 if rem == 0 else stride[i] - rem
    # F.pad takes (last-dim low, last-dim high, ...)
    widths = []
    for i in reversed(range(nd)):
        widths += [pad[i], pad[i] + extra[i]]
    if pool_type == "max":
        if any(widths):
            data = F.pad(data, widths, value=float("-inf"))
        return F.max_pool2d(data, kernel, stride)
    if pool_type == "avg":
        if any(widths):
            data = F.pad(data, widths)
        return F.avg_pool2d(data, kernel, stride)
    raise ValueError("pool_type %r is not ported" % pool_type)


_ACTIVATIONS = {"relu": F.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": lambda x: x / (1 + torch.abs(x))}


@register("Activation")
def activation(data, act_type="relu", **kw):
    if act_type not in _ACTIVATIONS:
        raise ValueError("act_type %r is not ported" % act_type)
    return _ACTIVATIONS[act_type](data)


@register("BatchNorm", num_inputs=5, num_outputs=3,
          visible_outputs=lambda attrs: 3 if pbool(
              attrs.get("output_mean_var")) else 1)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, training=False, **kw):
    """Returns ``(out, mean, var)``: the statistics used, detached.  In
    training they are the batch mean and the BIASED batch variance (as
    ``jnp.var``), in the data's dtype; torch's own running-stat update
    would use the unbiased one, so the caller updates the moving stats
    from these instead."""
    if pint(axis, 1) != 1:
        raise ValueError("only channel axis 1 is ported")
    g = torch.ones_like(gamma) if fix_gamma else gamma
    global_stats = use_global_stats or not training
    stat_dtype = moving_mean.dtype if global_stats else data.dtype
    out_dtype = torch.promote_types(
        torch.promote_types(data.dtype, stat_dtype),
        torch.promote_types(g.dtype, beta.dtype))
    # cuDNN and the CPU kernel take reduced-precision data with f32
    # parameters; any other mix runs with the parameters in the data's
    # dtype
    low = (torch.bfloat16, torch.float16)
    pdt = torch.float32 if data.dtype in low and \
        g.dtype == torch.float32 else data.dtype
    g, b = g.to(pdt), beta.to(pdt)
    if global_stats:
        out = F.batch_norm(data, moving_mean.to(pdt), moving_var.to(pdt),
                           g, b, training=False, eps=eps)
        return out.to(out_dtype), moving_mean, moving_var
    red = [i for i in range(data.dim()) if i != 1]
    with torch.no_grad():
        var, mean = torch.var_mean(data, dim=red, correction=0)
    out = F.batch_norm(data, None, None, g, b, training=True, eps=eps)
    return out.to(out_dtype), mean, var


@register("LayerNorm", num_inputs=3)
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
               **kw):
    ax = normalize_axis(pint(axis, -1), data.dim())
    eps = pfloat(eps, 1e-5)
    var, mean = torch.var_mean(data, dim=ax, keepdim=True, correction=0)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    out = (data - mean) * torch.rsqrt(var + eps)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("Embedding", num_inputs=2)
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False, **kw):
    return weight[data.to(torch.int64)]


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None, **kw):
    t = pfloat(temperature)
    if t and t != 1.0:
        data = data / t
    return F.log_softmax(data, dim=paxis(axis, -1))


@register("pick", num_inputs=2)
def pick(data, index, axis=-1, keepdims=False, mode="clip", **kw):
    """``data`` entries at integer positions ``index`` along ``axis``
    (indices clipped, the reference's default mode)."""
    axis = pint(axis, -1) % data.dim()
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if pbool(keepdims) else out.squeeze(axis)
