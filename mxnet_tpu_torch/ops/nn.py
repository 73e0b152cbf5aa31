"""Neural-net ops on torch tensors, registered in the op registry (parity:
mxnet_tpu/ops/nn.py — FullyConnected :30, Convolution :62, Deconvolution
:87, Pooling :129, Activation :184, LeakyReLU :200, BatchNorm :237,
LayerNorm :271, InstanceNorm :295, Dropout :341, Embedding :474,
CTCLoss :691; and log_softmax and pick of mxnet_tpu/ops/tensor.py).

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

import math

import torch
import torch.nn.functional as F

from .. import autograd
from .. import random as _random
from ..dtype_policy import harmonize
from .registry import register, alias
from .utils import pbool, pfloat, pint, ptuple, paxis, normalize_axis

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "activation", "leaky_relu", "batch_norm", "layer_norm",
           "instance_norm", "dropout", "ctc_loss", "embedding",
           "log_softmax", "pick"]


@register("FullyConnected", num_inputs=-1)
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True, **kw):
    data = harmonize(data, weight)
    if pbool(no_bias):
        bias = None
    if pbool(flatten, True) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, bias)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_LAYOUTS = (None, "NCW", "NCHW", "NCDHW")


def _window_attrs(kernel, stride, dilate, pad, nd):
    """Kernel, stride, dilation and padding as ``nd``-tuples (a single
    value is repeated, as ``ptuple(..., ndim=nd)`` does there)."""
    return (ptuple(kernel, ndim=nd), ptuple(stride, ndim=nd, default=(1,) * nd),
            ptuple(dilate, ndim=nd, default=(1,) * nd),
            ptuple(pad, ndim=nd, default=(0,) * nd))


@register("Convolution", num_inputs=-1)
def convolution(data, weight, bias=None, kernel=None, stride=None,
                dilate=None, pad=None, num_filter=None, num_group=1,
                no_bias=False, layout=None, **kw):
    """1-D, 2-D or 3-D convolution (channels first), symmetric (p, p)
    padding as lax.conv_general_dilated is given there."""
    if layout not in _LAYOUTS:
        raise ValueError("only the channels-first layouts are ported")
    data = harmonize(data, weight)
    if pbool(no_bias):
        bias = None
    nd = data.dim() - 2
    _, stride, dilate, pad = _window_attrs(kernel, stride, dilate, pad, nd)
    return _CONV[nd](data, weight, bias, stride=stride, padding=pad,
                     dilation=dilate, groups=pint(num_group, 1))


@register("Deconvolution", num_inputs=-1)
def deconvolution(data, weight, bias=None, kernel=None, stride=None,
                  dilate=None, pad=None, adj=None, num_filter=None,
                  num_group=1, no_bias=True, target_shape=None, layout=None,
                  **kw):
    """Transposed convolution, weight (in_c, out_c / groups, *k) as in the
    reference; output (in - 1) * stride + dilated kernel - 2 pad + adj.
    ``target_shape`` is accepted and, as in the JAX op, not used; no bias
    unless ``no_bias=False`` (the JAX op's default)."""
    if layout not in _LAYOUTS:
        raise ValueError("only the channels-first layouts are ported")
    nd = data.dim() - 2
    _, stride, dilate, pad = _window_attrs(kernel, stride, dilate, pad, nd)
    adj = ptuple(adj, ndim=nd, default=(0,) * nd)
    if pbool(no_bias, True):
        bias = None
    out = _DECONV[nd](data, weight, None, stride=stride, padding=pad,
                      output_padding=adj, groups=pint(num_group, 1),
                      dilation=dilate)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


def _sum_pool(data, kernel, stride):
    """Window sums over already padded data (avg_pool with divisor 1;
    1-D runs as 2-D with a unit height, avg_pool1d having no divisor)."""
    if len(kernel) == 1:
        return F.avg_pool2d(data.unsqueeze(2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(2)
    fn = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return fn(data, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling")
def pooling(data, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid",
            count_include_pad=True, p_value=None, layout=None, **kw):
    """1-D, 2-D or 3-D max, avg, sum or lp pooling with the reference's
    padding rules: the input is padded explicitly (-inf for max, 0
    otherwise) and the window never sees more; the 'full' convention pads
    the high edge so every window fits, which is ceil mode without
    torch's rule of dropping a last window that starts in the padding.
    avg divides by the kernel's size, or with ``count_include_pad=False``
    by the number of real elements in the window; lp is
    (sum |x|^p)^(1/p)."""
    nd = data.dim() - 2
    pool_type = pool_type or "max"
    if pbool(global_pool):
        if pool_type == "avg":
            return data.mean(dim=tuple(range(2, data.dim())), keepdim=True)
        kernel = tuple(data.shape[2:])
        stride = pad = None
    kernel = ptuple(kernel, ndim=nd, default=(1,) * nd)
    stride = ptuple(stride, ndim=nd, default=(1,) * nd)
    pad = ptuple(pad, ndim=nd, default=(0,) * nd)
    extra = [0] * nd
    if (pooling_convention or "valid") == "full":
        for i in range(nd):
            rem = (data.shape[2 + i] + 2 * pad[i] - kernel[i]) % stride[i]
            extra[i] = 0 if rem == 0 else stride[i] - rem
    # F.pad takes (last-dim low, last-dim high, ...)
    widths = []
    for i in reversed(range(nd)):
        widths += [pad[i], pad[i] + extra[i]]
    padded = any(widths)
    if pool_type == "max":
        if padded:
            data = F.pad(data, widths, value=float("-inf"))
        return _MAX_POOL[nd](data, kernel, stride)
    if pool_type not in ("avg", "sum", "lp"):
        raise ValueError("unknown pool_type %r" % pool_type)
    if pool_type == "lp":
        p = pfloat(p_value, 2.0)
        data = torch.abs(data) ** p
    if pool_type == "avg" and pbool(count_include_pad, True):
        if padded:
            data = F.pad(data, widths)
        return _AVG_POOL[nd](data, kernel, stride)
    if padded:
        ones = F.pad(torch.ones_like(data[:1, :1]), widths)
        data = F.pad(data, widths)
    s = _sum_pool(data, kernel, stride)
    if pool_type == "sum":
        return s
    if pool_type == "lp":
        return s ** (1.0 / p)
    if not padded:
        return s / float(math.prod(kernel))
    return s / _sum_pool(ones, kernel, stride)


_ACTIVATIONS = {"relu": F.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": lambda x: x / (1 + torch.abs(x))}


@register("Activation")
def activation(data, act_type="relu", **kw):
    if act_type not in _ACTIVATIONS:
        raise ValueError("act_type %r is not ported" % act_type)
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU", num_inputs=-1)
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, **kw):
    """The LeakyReLU family: leaky, elu (alpha = ``slope``), selu, gelu
    (exact erf), prelu (a learned ``gamma`` per channel) and rrelu at its
    eval-time mean slope, as the JAX op has them."""
    act = act_type or "leaky"
    if act == "leaky":
        return torch.where(data >= 0, data, pfloat(slope, 0.25) * data)
    if act == "elu":
        return F.elu(data, pfloat(slope, 0.25))
    if act == "selu":
        return F.selu(data)
    if act == "gelu":
        return F.gelu(data)
    if act == "prelu":
        g = gamma
        if g.dim() < data.dim() and data.dim() > 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data >= 0, data, g * data)
    if act == "rrelu":
        s = (pfloat(lower_bound, 0.125) + pfloat(upper_bound, 0.334)) / 2.0
        return torch.where(data >= 0, data, s * data)
    raise ValueError("unknown act_type %r" % act)


@register("BatchNorm", num_inputs=5, num_outputs=3,
          visible_outputs=lambda attrs: 3 if pbool(
              attrs.get("output_mean_var")) else 1)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, training=None, **kw):
    """Returns ``(out, mean, var)``: the statistics used, detached.  In
    training they are the batch mean and the BIASED batch variance (as
    ``jnp.var``), in the data's dtype; torch's own running-stat update
    would use the unbiased one, so the caller updates the moving stats
    from these instead.  ``training`` defaults to autograd's training
    flag, as the JAX op reads it (a symbol's BatchNorm then follows the
    executor's ``is_train``)."""
    if pint(axis, 1) != 1:
        raise ValueError("only channel axis 1 is ported")
    if training is None:
        training = autograd.is_training()
    eps = pfloat(eps, 1e-3)
    g = torch.ones_like(gamma) if pbool(fix_gamma, True) else gamma
    global_stats = pbool(use_global_stats) or not pbool(training)
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


@register("InstanceNorm", num_inputs=3)
def instance_norm(data, gamma, beta, eps=1e-3, **kw):
    """Normalize each (sample, channel) over its spatial axes (biased
    variance), then scale and shift per channel."""
    red = tuple(range(2, data.dim()))
    var, mean = torch.var_mean(data, dim=red, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + pfloat(eps, 1e-3)) \
        * gamma.reshape(shape) + beta.reshape(shape)


@register("Dropout", uses_rng=True)
def dropout(data, p=0.5, mode="training", axes=None, **kw):
    """Zero each element (or each slice along ``axes``, which share one
    draw) with probability ``p`` and scale the kept ones by 1 / (1 - p);
    the identity outside training unless ``mode='always'``.  The mask is
    drawn on the data's device from the framework generator there; in a
    compiled (hybridized) graph, from torch's default generator of the
    device, which ``mx.random.seed`` seeds too (``torch.compile`` cannot
    take an explicit generator)."""
    p = pfloat(p, 0.5)
    if p == 0.0 or (mode != "always" and not autograd.is_training()):
        return data
    axes = ptuple(axes)
    shape = data.shape
    if axes:
        shape = tuple(1 if i in axes else s for i, s in enumerate(shape))
    keep = 1.0 - p
    gen = None if torch.compiler.is_compiling() \
        else _random.next_key(data.device)
    u = torch.rand(shape, generator=gen, device=data.device)
    mask = (u < keep).to(data.dtype) / keep
    return data * mask


_CTC_NEG_INF = -1e30


@register("CTCLoss", num_inputs=-1,
          aliases=("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first", **kw):
    """CTC negative log-likelihood by the forward (alpha) recursion in log
    space, a loop over time.  data: (T, N, C) unnormalized; label: (N, L).
    blank_label 'first': blank id 0, labels 1-based, padded with 0;
    'last': blank id C - 1, padded with -1.  The JAX op's recursion,
    its -1e30 for an impossible state, and its start states."""
    T, N, C = data.shape
    logp = F.log_softmax(data, dim=-1)
    blank_first = (blank_label or "first") == "first"
    blank = 0 if blank_first else C - 1
    lab = label.to(torch.int64)
    if pbool(use_label_lengths):
        lab_len = label_lengths.to(torch.int64)
    else:
        lab_len = (lab != (0 if blank_first else -1)).sum(dim=1)
    if pbool(use_data_lengths):
        dat_len = data_lengths.to(torch.int64)
    else:
        dat_len = torch.full((N,), T, dtype=torch.int64, device=data.device)
    S = 2 * lab.shape[1] + 1
    ext = torch.full((N, S), blank, dtype=torch.int64, device=data.device)
    ext[:, 1::2] = lab
    # a padding label (-1 with blank 'last') indexes the last class, as
    # jnp's take_along_axis wraps it; those states are never reached
    ext_idx = ext % C
    ext_m2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                   device=data.device), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    rows = torch.arange(N, device=data.device)
    alpha = torch.full((N, S), _CTC_NEG_INF, dtype=logp.dtype,
                       device=data.device)
    first = logp[0, rows, ext_idx[:, 0]]
    second = logp[0, rows, ext_idx[:, 1]]
    alpha = torch.cat([first[:, None],
                       torch.where(lab_len > 0, second,
                                   alpha[:, 1])[:, None],
                       alpha[:, 2:]], dim=1)
    pad1 = torch.full((N, 1), _CTC_NEG_INF, dtype=logp.dtype,
                      device=data.device)
    for t in range(1, T):
        a_m1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_m2 = torch.cat([pad1, pad1, alpha[:, :-2]], dim=1)
        a = torch.logaddexp(alpha, a_m1)
        a = torch.where(can_skip, torch.logaddexp(a, a_m2), a)
        new = a + torch.gather(logp[t], 1, ext_idx)
        alpha = torch.where((t < dat_len)[:, None], new, alpha)
    end1 = torch.gather(alpha, 1, (2 * lab_len)[:, None])[:, 0]
    end2 = torch.gather(alpha, 1, (2 * lab_len - 1).clamp(min=0)[:, None])[:, 0]
    ll = torch.logaddexp(end1, torch.where(
        lab_len > 0, end2, torch.full_like(end2, _CTC_NEG_INF)))
    return -ll


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


# the reference's other names of these ops; SyncBatchNorm is BatchNorm on
# one card
for _name, _names in {
        "BatchNorm": ("BatchNorm_v1", "CuDNNBatchNorm", "SyncBatchNorm",
                      "_contrib_SyncBatchNorm"),
        "Convolution": ("Convolution_v1",),
        "Pooling": ("Pooling_v1",),
        "Embedding": ("_contrib_SparseEmbedding",),
        "pick": ("choose_element_0index",)}.items():
    for _a in _names:
        alias(_name, _a)


# ---------------------------------------------------------------------------
# Output (loss-head) ops (parity: mxnet_tpu/ops/nn.py:224, :370-470).  Each
# JAX ``custom_vjp`` is a ``torch.autograd.Function`` here: the forward is
# the prediction and the backward ignores the incoming gradient and seeds
# the loss gradient from the label, as the reference's output ops do.
# ---------------------------------------------------------------------------


def _one_hot(label, k, axis, dtype):
    """One-hot of ``label`` (truncated to integers) with ``k`` classes on
    ``axis``; an index outside [0, k) gives a row of zeros, as
    ``jax.nn.one_hot`` does."""
    idx = label.to(torch.int64).unsqueeze(axis)
    shape = [1] * idx.dim()
    shape[axis] = k
    classes = torch.arange(k, device=label.device).reshape(shape)
    return (idx == classes).to(dtype)


@register("softmax_cross_entropy", num_inputs=2)
def softmax_cross_entropy(data, label, **kw):
    logp = torch.log_softmax(data, dim=-1)
    onehot = _one_hot(label, data.shape[-1], -1, data.dtype)
    return -(onehot * logp).sum()


class _SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                multi_output, normalization, smooth_alpha):
        out = torch.softmax(data, dim=1 if multi_output else -1)
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, multi_output,
                     normalization, smooth_alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        (grad_scale, ignore_label, use_ignore, multi_output, normalization,
         smooth_alpha) = ctx.attrs
        axis = 1 if multi_output else -1
        k = out.shape[axis]
        onehot = _one_hot(label, k, axis, out.dtype)
        if smooth_alpha:
            onehot = onehot * (1.0 - smooth_alpha) + smooth_alpha / (k - 1)
        grad = out - onehot
        if use_ignore:
            mask = (label != ignore_label).to(out.dtype)
            grad = grad * mask.unsqueeze(axis)
        scale = grad_scale
        if normalization == "batch":
            scale = scale / out.shape[0]
        elif normalization == "valid":
            if use_ignore:
                valid = (label != ignore_label).sum().clamp_min(1) \
                    .to(out.dtype)
            else:
                valid = float(label.numel())
            scale = scale / valid
        grad = grad * scale
        glabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad, glabel, None, None, None, None, None, None


@register("SoftmaxOutput", num_inputs=2, aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0,
                   **kw):
    """Softmax over the last axis (axis 1 under ``multi_output``); its
    gradient is ``(softmax - onehot(label)) * scale`` whatever gradient
    arrives.  ``preserve_shape`` changes nothing, as in the JAX op (the
    softmax already keeps the shape)."""
    return _SoftmaxOutputFn.apply(
        data, label.to(data.dtype), pfloat(grad_scale, 1.0),
        pfloat(ignore_label, -1.0), pbool(use_ignore), pbool(multi_output),
        normalization or "null", pfloat(smooth_alpha, 0.0))


@register("SoftmaxActivation")
def softmax_activation(data, mode="instance", **kw):
    if (mode or "instance") == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1) \
        .reshape(data.shape)


class _RegressionFn(torch.autograd.Function):
    """Forward ``fwd(data)``; backward ``grad_fn(out, label) * grad_scale
    / (outputs per sample)``."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.attrs = (grad_scale, kind)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, kind = ctx.attrs
        num_out = out.numel() // out.shape[0] if out.dim() else 1
        diff = out - label.reshape(out.shape)
        if kind == "mae":
            diff = torch.sign(diff)
        grad = diff * grad_scale / num_out
        glabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return grad, glabel, None, None


@register("LinearRegressionOutput", num_inputs=2)
def linear_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionFn.apply(data, label.to(data.dtype),
                               pfloat(grad_scale, 1.0), "linear")


@register("MAERegressionOutput", num_inputs=2)
def mae_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionFn.apply(data, label.to(data.dtype),
                               pfloat(grad_scale, 1.0), "mae")


@register("LogisticRegressionOutput", num_inputs=2)
def logistic_regression_output(data, label, grad_scale=1.0, **kw):
    return _RegressionFn.apply(data, label.to(data.dtype),
                               pfloat(grad_scale, 1.0), "logistic")
