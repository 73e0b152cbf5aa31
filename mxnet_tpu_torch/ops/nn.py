"""Neural-net ops of the training slice on torch tensors (parity:
mxnet_tpu/ops/nn.py — FullyConnected :30, Convolution :62, Pooling :129,
Activation :184, BatchNorm :237).

cuDNN and cuBLAS carry these through ``torch.nn.functional``, as XLA
carried them on the TPU; none of them is a Pallas kernel there.

Under a dtype policy's scope, FullyConnected and Convolution compute in
their weight's dtype (``dtype_policy.harmonize``), and BatchNorm gives
the JAX op's dtypes when data and parameters differ: its output takes
the promoted dtype of the data, the statistics and gamma/beta (bf16 data
with f32 gamma gives f32), and the batch statistics take the data's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dtype_policy import harmonize

__all__ = ["fully_connected", "convolution", "pooling", "activation",
           "batch_norm", "log_softmax", "pick"]


def fully_connected(data, weight, bias=None, flatten=True):
    data = harmonize(data, weight)
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


def convolution(data, weight, bias=None, stride=(1, 1), pad=(0, 0),
                dilate=(1, 1), num_group=1):
    data = harmonize(data, weight)
    # symmetric (p, p) padding, as lax.conv_general_dilated is given there
    return F.conv2d(data, weight, bias, stride=tuple(stride),
                    padding=tuple(pad), dilation=tuple(dilate),
                    groups=num_group)


def pooling(data, kernel=(1, 1), pool_type="max", global_pool=False,
            stride=None, pad=(0, 0), pooling_convention="valid"):
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


def activation(data, act_type="relu"):
    if act_type == "relu":
        return F.relu(data)
    raise ValueError("act_type %r is not ported" % act_type)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               fix_gamma=True, use_global_stats=False, training=False):
    """Returns ``(out, mean, var)``: the statistics used, detached.  In
    training they are the batch mean and the BIASED batch variance (as
    ``jnp.var``), in the data's dtype; torch's own running-stat update
    would use the unbiased one, so the caller updates the moving stats
    from these instead."""
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


def log_softmax(data, axis=-1):
    return F.log_softmax(data, dim=axis)


def pick(data, index, axis=-1, keepdims=False):
    """``data`` entries at integer positions ``index`` along ``axis``
    (indices clipped, the reference's default mode)."""
    axis = axis % data.dim()
    idx = index.to(torch.int64).clamp(0, data.shape[axis] - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if keepdims else out.squeeze(axis)
