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
LayerNorm is the plain formula of the JAX op, so it has the same dtype
flow (bf16 data with f32 gamma gives f32); under a fusion plan whose
cost table (or an explicit ``fusion="layer_norm_fast"``) fires
``layer_norm_fast`` for the traced shape, it runs the one-pass kernel of
``ops/fused.py`` instead.  Also here: L2Normalization, LRN, UpSampling,
BilinearResize2D, the Sequence ops and the fused ``RNN`` op (cuDNN's
RNN a layer on the card; ``rnn_plain`` is its plain composition).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from .. import autograd
from .. import fusion_cost as _fc
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
    # under a fusion plan (hybridize, ShardedTrainer), the cost table
    # may pick the one-pass kernel for this traced shape: the decision
    # the Symbol path's rewrite makes at bind
    if _fc.runtime_decision("layer_norm_fast", data.shape, data.dtype,
                            axis=pint(axis, -1), site="LayerNorm"):
        from .fused import layer_norm_fast

        return layer_norm_fast(data, gamma, beta, axis=axis, eps=eps)
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


# ---------------------------------------------------------------------------
# L2Normalization, LRN, UpSampling, BilinearResize2D (parity:
# mxnet_tpu/ops/nn.py:306, :323, :486, :499)
# ---------------------------------------------------------------------------


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance", **kw):
    """``data / sqrt(sum(data^2) + eps)`` over every axis but the batch
    (instance), the channel axis (channel) or the spatial axes
    (spatial)."""
    mode = mode or "instance"
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    norm = torch.sqrt(data.square().sum(dim=red, keepdim=True)
                      + pfloat(eps, 1e-10))
    return data / norm


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    """Local response normalization across channels: each element over
    ``(knorm + alpha / nsize * sum of squares in its channel window) **
    beta``, the window zero-padded at the channel edges."""
    alpha, beta, knorm, nsize = (pfloat(alpha, 1e-4), pfloat(beta, 0.75),
                                 pfloat(knorm, 2.0), pint(nsize, 5))
    half = nsize // 2
    sq = F.pad(data.square(), (0, 0, 0, 0, half, half))
    c = data.shape[1]
    summed = sum(sq[:, i:i + c] for i in range(nsize))
    return data / torch.pow(knorm + alpha / nsize * summed, beta)


def _bilinear(x, height, width):
    """``jax.image.resize(method="bilinear")``: half-pixel centres, and
    a triangle filter widened by the scale when shrinking (antialias)."""
    shrink = height < x.shape[2] or width < x.shape[3]
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=shrink)


@register("UpSampling", num_inputs=-1)
def upsampling(*data, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=None, **kw):
    """Repeat each pixel ``scale`` times along H and W (nearest), or
    resize bilinearly; the first input only, as in the JAX op."""
    scale = pint(scale, 1)
    x = data[0]
    if sample_type == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                   dim=3)
    return _bilinear(x, x.shape[2] * scale, x.shape[3] * scale)


@register("_contrib_BilinearResize2D")
def bilinear_resize_2d(data, height=1, width=1, scale_height=None,
                       scale_width=None, mode="size", **kw):
    h, w = data.shape[2:]
    sh, sw = pfloat(scale_height), pfloat(scale_width)
    if sh:
        height, width = int(h * sh), int(w * (sw or sh))
    return _bilinear(data, pint(height, 1), pint(width, 1))


# ---------------------------------------------------------------------------
# Sequence ops (parity: mxnet_tpu/ops/nn.py:515-560)
# ---------------------------------------------------------------------------


def _time_mask(data, sequence_length, ax):
    """(T, N) or (N, T) booleans, true where the step lies within the
    row's length, with trailing unit axes for the data's feature axes."""
    steps = torch.arange(data.shape[ax], device=data.device)
    length = sequence_length.to(steps.dtype)
    mask = steps[:, None] < length[None, :] if ax == 0 \
        else steps[None, :] < length[:, None]
    return mask.reshape(mask.shape + (1,) * (data.dim() - 2))


@register("SequenceMask", num_inputs=-1)
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0, **kw):
    """Set the steps past each row's length to ``value`` (time axis 0 or
    1)."""
    if not pbool(use_sequence_length) or sequence_length is None:
        return data
    mask = _time_mask(data, sequence_length, pint(axis, 0))
    return torch.where(mask, data, torch.full_like(data, pfloat(value, 0.0)))


@register("SequenceLast", num_inputs=-1)
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0, **kw):
    """Each row's last valid step (the last step without lengths)."""
    ax = pint(axis, 0)
    if not pbool(use_sequence_length) or sequence_length is None:
        return data.select(ax, -1)
    last = sequence_length.to(torch.int64) - 1
    rows = torch.arange(data.shape[1 - ax], device=data.device)
    return data[last, rows] if ax == 0 else data[rows, last]


@register("SequenceReverse", num_inputs=-1)
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     **kw):
    """Reverse the time axis (0); with lengths, each row reverses its
    first ``length`` steps and leaves its padding in place."""
    if not pbool(use_sequence_length) or sequence_length is None:
        return torch.flip(data, dims=(0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    length = sequence_length.to(torch.int64)[None, :]
    src = torch.where(steps < length, length - 1 - steps, steps)
    rows = torch.arange(data.shape[1], device=data.device)[None, :]
    return data[src, rows]


# ---------------------------------------------------------------------------
# Fused RNN (parity: mxnet_tpu/ops/nn.py:563-693; the reference's
# src/operator/rnn-inl.h and its cuDNN-layout flat parameter vector)
# ---------------------------------------------------------------------------

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def _rnn_num_outputs(attrs):
    if pbool(attrs.get("state_outputs")):
        return 3 if attrs.get("mode") == "lstm" else 2
    return 1


def _unpack_rnn_params(params, mode, num_layers, input_size, state_size,
                       bidir):
    """Views into the flat parameter vector: all weights (layer-major,
    then direction: W_i2h then W_h2h), then all biases (b_i2h then
    b_h2h), the order of rnn-inl.h's GetRnnParamSize.  Returns
    ``[(wi, wh, bi, bh)]`` for each (layer, direction)."""
    gates = _GATES[mode]
    D = 2 if bidir else 1
    H = state_size
    ws, off = [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else H * D
        for _ in range(D):
            wi = params[off:off + gates * H * in_sz].view(gates * H, in_sz)
            off += gates * H * in_sz
            wh = params[off:off + gates * H * H].view(gates * H, H)
            off += gates * H * H
            ws.append((wi, wh))
    out = []
    for wi, wh in ws:
        bi = params[off:off + gates * H]
        bh = params[off + gates * H:off + 2 * gates * H]
        off += 2 * gates * H
        out.append((wi, wh, bi, bh))
    return out


def _rnn_cell_step(mode):
    """One step of the plain recurrence on the hoisted input projection
    ``gx`` (gate order LSTM ifgo, GRU rzn with ``n = tanh(x_n + r *
    (W_hn h + b_hn))``)."""
    if mode == "lstm":
        def step(carry, gx, wh, bh):
            h, c = carry
            i, f, g, o = (gx + F.linear(h, wh, bh)).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            return (h, c), h
    elif mode == "gru":
        def step(carry, gx, wh, bh):
            (h,) = carry
            xr, xz, xn = gx.chunk(3, dim=-1)
            hr, hz, hn = F.linear(h, wh, bh).chunk(3, dim=-1)
            r = torch.sigmoid(xr + hr)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + r * hn)
            h = (1 - z) * n + z * h
            return (h,), h
    else:
        act = torch.tanh if mode == "rnn_tanh" else torch.relu

        def step(carry, gx, wh, bh):
            h = act(gx + F.linear(carry[0], wh, bh))
            return (h,), h
    return step


def rnn_plain_layer(x, hx, cx, weights, mode, bidir):
    """One layer of the recurrence as a loop over time: the input
    projection over all T at once, then one cell step a time step, the
    reverse direction on the time-flipped input.  ``weights`` holds
    ``(wi, wh, bi, bh)`` per direction; returns ``(out, hn, cn)`` with
    ``cn`` None unless LSTM.  The plain version of the layer call and
    the tests' oracle."""
    step = _rnn_cell_step(mode)
    outs, hs, cs = [], [], []
    for d, (wi, wh, bi, bh) in enumerate(weights):
        seq = x if d == 0 else torch.flip(x, dims=(0,))
        gates_x = F.linear(seq, wi, bi)
        carry = (hx[d], cx[d]) if mode == "lstm" else (hx[d],)
        ys = []
        for t in range(seq.shape[0]):
            carry, y = step(carry, gates_x[t], wh, bh)
            ys.append(y)
        ys = torch.stack(ys)
        outs.append(ys if d == 0 else torch.flip(ys, dims=(0,)))
        hs.append(carry[0])
        if mode == "lstm":
            cs.append(carry[1])
    out = torch.cat(outs, dim=-1) if len(outs) == 2 else outs[0]
    return out, torch.stack(hs), torch.stack(cs) if cs else None


def _vf_layer(x, hx, cx, weights, mode, bidir):
    """One layer through ``torch._VF``, the call ``torch.nn.LSTM`` makes
    (cuDNN's fused RNN on the card, ATen's on the CPU)."""
    flat = [w for per_dir in weights for w in per_dir]
    fn = getattr(torch._VF, mode)   # the modes are _VF's names
    if mode == "lstm":
        return fn(x, (hx, cx), flat, True, 1, 0.0, True, bidir, False)
    out, hn = fn(x, hx, flat, True, 1, 0.0, True, bidir, False)
    return out, hn, None


# cuDNN's RNN modes (cudnnRNNMode_t), keyed by the op's mode names
_CUDNN_MODE = {"rnn_relu": 0, "rnn_tanh": 1, "lstm": 2, "gru": 3}


@torch.library.custom_op("mxnet_tpu_torch::rnn_layer", mutates_args=())
def _rnn_layer_op(x: torch.Tensor, hx: torch.Tensor,
                  cx: Optional[torch.Tensor], flat: List[torch.Tensor],
                  mode: str, bidir: bool, train: bool) -> List[torch.Tensor]:
    """One RNN layer as an op that dynamo and inductor keep whole (a
    compiled graph cannot trace ``torch._VF``'s RNNs).  On the card it
    is ``aten::_cudnn_rnn``; outputs ``[out, hn, cn, reserve, wbuf]``,
    cuDNN's reserve (filled only when ``train``) and packed weight
    buffer kept for the backward op.  On the CPU it runs ``_vf_layer``
    and the last two are empty.  ``cn`` is empty unless LSTM."""
    reserve = wbuf = None
    if x.is_cuda:
        out, hn, cn, reserve, wbuf = torch.ops.aten._cudnn_rnn(
            x.contiguous(), flat, 4, None, hx.contiguous(),
            None if cx is None else cx.contiguous(), _CUDNN_MODE[mode],
            hx.shape[-1], 0, 1, False, 0.0, train, bidir, [], None)
    else:
        out, hn, cn = _vf_layer(x, hx, cx, [tuple(flat[i:i + 4]) for i in
                                            range(0, len(flat), 4)], mode,
                                bidir)
    return [out, hn, hn.new_empty(0) if cn is None else cn,
            x.new_empty(0, dtype=torch.uint8) if reserve is None else reserve,
            x.new_empty(0) if wbuf is None else wbuf]


@_rnn_layer_op.register_fake
def _(x, hx, cx, flat, mode, bidir, train):
    D = 2 if bidir else 1
    ctx = torch.library.get_ctx()   # cuDNN sizes its two buffers itself
    return [x.new_empty(x.shape[0], x.shape[1], D * hx.shape[-1]),
            hx.new_empty(hx.shape),
            hx.new_empty(hx.shape if mode == "lstm" else (0,)),
            x.new_empty(ctx.new_dynamic_size(), dtype=torch.uint8),
            x.new_empty(ctx.new_dynamic_size())]


@torch.library.custom_op("mxnet_tpu_torch::rnn_layer_backward",
                         mutates_args=())
def _rnn_layer_backward_op(gout: torch.Tensor, ghn: torch.Tensor,
                           gcn: torch.Tensor, x: torch.Tensor,
                           hx: torch.Tensor, cx: Optional[torch.Tensor],
                           flat: List[torch.Tensor], out: torch.Tensor,
                           reserve: torch.Tensor, wbuf: torch.Tensor,
                           mode: str, bidir: bool) -> List[torch.Tensor]:
    """The layer's gradients of ``[x, hx, (cx,) *flat]``.  On the card
    ``aten::_cudnn_rnn_backward`` on the forward's reserve and weight
    buffer; on the CPU the vjp of ``rnn_plain_layer`` (the plain
    composition, run forward again)."""
    has_c = cx is not None
    if x.is_cuda:
        dx, dhx, dcx, dw = torch.ops.aten._cudnn_rnn_backward(
            x.contiguous(), flat, 4, wbuf, hx.contiguous(),
            cx.contiguous() if has_c else None, out, gout.contiguous(),
            ghn.contiguous(), gcn.contiguous() if has_c else None,
            _CUDNN_MODE[mode], hx.shape[-1], 0, 1, False, 0.0, True, bidir,
            [], None, reserve, [True, True, has_c, True])
        # the weights' gradients share one buffer (cuDNN's layout); a
        # custom op's outputs may not alias each other, so each is copied
        grads = [dx, dhx] + ([dcx] if has_c else []) + [
            g.clone() for g in dw]
    else:
        def layer(*ins):
            c = ins[2] if has_c else None
            w = ins[3 if has_c else 2:]
            o, h, c = rnn_plain_layer(ins[0], ins[1], c, [
                tuple(w[i:i + 4]) for i in range(0, len(w), 4)], mode, bidir)
            return (o, h) if c is None else (o, h, c)
        _, vjp = torch.func.vjp(layer, x, hx, *([cx] if has_c else []),
                                *flat)
        grads = [g.clone() for g in   # copies: views may share storage
                 vjp((gout, ghn, gcn) if has_c else (gout, ghn))]
    return grads


@_rnn_layer_backward_op.register_fake
def _(gout, ghn, gcn, x, hx, cx, flat, out, reserve, wbuf, mode, bidir):
    inputs = [x, hx] + ([cx] if cx is not None else []) + list(flat)
    return [torch.empty_like(t) for t in inputs]


def _rnn_layer_setup(ctx, inputs, output):
    x, hx, cx, flat, mode, bidir, train = inputs
    ctx.has_c = cx is not None
    ctx.mode, ctx.bidir = mode, bidir
    ctx.save_for_backward(x, hx, output[0], output[3], output[4],
                          *([cx] if cx is not None else []), *flat)


def _rnn_layer_backward(ctx, grads):
    gout, ghn, gcn = grads[:3]   # None for an output that took no gradient
    x, hx, out, reserve, wbuf = ctx.saved_tensors[:5]
    cx = ctx.saved_tensors[5] if ctx.has_c else None
    flat = list(ctx.saved_tensors[6 if ctx.has_c else 5:])
    if gout is None:
        gout = torch.zeros_like(out)
    if ghn is None:
        ghn = torch.zeros_like(hx)
    if not ctx.has_c:
        gcn = hx.new_empty(0)
    elif gcn is None:
        gcn = torch.zeros_like(hx)
    g = _rnn_layer_backward_op(gout, ghn, gcn, x, hx, cx, flat, out,
                               reserve, wbuf, ctx.mode, ctx.bidir)
    n = 3 if ctx.has_c else 2
    return (g[0], g[1], g[2] if ctx.has_c else None, list(g[n:]), None,
            None, None)


_rnn_layer_op.register_autograd(_rnn_layer_backward,
                                setup_context=_rnn_layer_setup)


def rnn_layer(x, hx, cx, weights, mode, bidir):
    """One layer (both directions when ``bidir``) of the fused RNN:
    ``torch._VF`` directly when eager, the ``rnn_layer`` custom op in a
    compiled graph (cuDNN's reserve kept only where a gradient will be
    taken).  Returns ``(out, hn, cn)``, ``cn`` None unless LSTM."""
    if not torch.compiler.is_compiling():
        return _vf_layer(x, hx, cx, weights, mode, bidir)
    flat = [w for per_dir in weights for w in per_dir]
    train = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in [x, hx, cx] + flat)
    out, hn, cn = _rnn_layer_op(x, hx, cx, flat, mode, bidir, train)[:3]
    return out, hn, cn if mode == "lstm" else None


def _rnn(layer_fn, data, parameters, state, state_cell, state_size,
         num_layers, bidirectional, mode, p, state_outputs):
    mode = mode or "lstm"
    H = pint(state_size)
    L = pint(num_layers, 1)
    bidir = pbool(bidirectional)
    D = 2 if bidir else 1
    weights = _unpack_rnn_params(parameters, mode, L, data.shape[2], H,
                                 bidir)
    drop_p = pfloat(p, 0.0)
    out, hs, cs = data, [], []
    for layer in range(L):
        sl = slice(layer * D, layer * D + D)
        out, hn, cn = layer_fn(
            out, state[sl], state_cell[sl] if mode == "lstm" else None,
            weights[sl], mode, bidir)
        hs.append(hn)
        cs.append(cn)
        if drop_p > 0.0 and layer < L - 1 and autograd.is_training():
            gen = None if torch.compiler.is_compiling() \
                else _random.next_key(out.device)
            keep = 1.0 - drop_p
            u = torch.rand(out.shape, generator=gen, device=out.device)
            out = out * ((u < keep).to(out.dtype) / keep)
    if not pbool(state_outputs):
        return out
    hN = torch.cat(hs)
    return (out, hN, torch.cat(cs)) if mode == "lstm" else (out, hN)


@register("RNN", num_inputs=-1, num_outputs=_rnn_num_outputs, uses_rng=True)
def rnn(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        state_outputs=False, projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False,
        use_sequence_length=False, sequence_length=None, **kw):
    """Fused multi-layer RNN over (T, N, C) input, the flat parameter
    vector in the reference's layout (``_unpack_rnn_params``).  Modes
    lstm, gru, rnn_tanh and rnn_relu, stacked and bidirectional.  Each
    layer runs as one ``rnn_layer`` call (cuDNN on the card); between
    layers, in training only, dropout ``p`` draws its mask from the
    framework generator (torch's default one in a compiled graph), as
    the Dropout op does.  ``projection_size`` and the ``lstm_state_clip``
    attributes are accepted and ignored, as in the JAX op."""
    return _rnn(rnn_layer, data, parameters, state, state_cell, state_size,
                num_layers, bidirectional, mode, p, state_outputs)


def rnn_plain(data, parameters, state, state_cell=None, state_size=None,
              num_layers=1, bidirectional=False, mode="lstm", p=0.0,
              state_outputs=False, **kw):
    """The ``RNN`` op with every layer through ``rnn_plain_layer``: the
    JAX op's composition (a hoisted input projection, then one cell step
    a time step), the plain version the card's route is held to."""
    return _rnn(rnn_plain_layer, data, parameters, state, state_cell,
                state_size, num_layers, bidirectional, mode, p,
                state_outputs)
