"""The int8 ops of contrib.quantization (parity: the registered ops of
mxnet_tpu/contrib/quantization.py; the reference's
src/operator/quantization/): quantize, quantize_v2, dequantize,
requantize, quantized_fully_connected, quantized_conv and
dequantize_int32.

Codes match the JAX package bit for bit: the scale ``127 / max(r, 1e-8)``
is an f32 division of tensors (never a Python double, and never a
division by a Python scalar, which CUDA computes as a multiplication by
its reciprocal), rounded half to even and clamped to [-127, 127].  The
ranges come back as 0-d f32 tensors, as the JAX ops return them.

``quantized_conv`` and ``quantized_fully_connected`` run through the
``mxnet_tpu_torch::int8_conv`` custom op: ``kernels/int8_conv.cu`` (int8
x int8 -> int32 on the tensor cores) for a CUDA tensor, ``int8_conv_plain``
(an f64 convolution rounded to int32, exact since |sum| <= 127^2 K <
2^53) for a CPU one.  The fully connected layer is a 1x1 convolution of
a 1x1 map; a 1-D convolution is a 2-D one of height 1, and a 3-D one
the int32 sum of one 2-D launch per kernel depth (``_int8_conv3d``).
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from .registry import register
from .utils import pbool, pfloat, pint, ptuple

__all__ = ["int8_conv_plain", "int8_conv", "quantize_codes"]


def _full(value, like):
    """An f32 0-d tensor of ``value`` on ``like``'s device."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _range(min_range, max_range):
    return torch.maximum(torch.abs(min_range), torch.abs(max_range))


def quantize_codes(data, r):
    """int8 codes of f32 ``data`` at range ``r`` (0-d f32)."""
    scale = _full(127.0, r) / torch.clamp(r, min=1e-8)
    return torch.clamp(torch.round(data * scale), -127, 127).to(torch.int8)


@register("_contrib_quantize", num_inputs=3, num_outputs=3,
          differentiable=False)
def _quantize_op(data, min_range, max_range, out_type="int8", **kw):
    r = _range(min_range, max_range)
    return quantize_codes(data, r), -r, r


@register("_contrib_quantize_v2", num_inputs=1, num_outputs=3,
          differentiable=False)
def _quantize_v2_op(data, out_type="int8", min_calib_range=None,
                    max_calib_range=None, **kw):
    mn = pfloat(min_calib_range)
    mx = pfloat(max_calib_range)
    if mn is None or mx is None:
        r = torch.amax(torch.abs(data)).to(torch.float32)
    else:
        r = _full(max(abs(mn), abs(mx)), data)
    return quantize_codes(data, r), -r, r


@register("_contrib_dequantize", num_inputs=3, differentiable=False)
def _dequantize_op(data, min_range, max_range, out_type="float32", **kw):
    r = _range(min_range, max_range)
    return data.to(torch.float32) * (r / _full(127.0, r))


@register("_contrib_requantize", num_inputs=3, num_outputs=3,
          differentiable=False)
def _requantize_op(data, min_range, max_range, min_calib_range=None,
                   max_calib_range=None, **kw):
    r = _range(min_range, max_range)
    f = data.to(torch.float32) * (r / _full(127.0 * 127.0, r))
    return _quantize_v2_op(f, min_calib_range=min_calib_range,
                           max_calib_range=max_calib_range)


# ---------------------------------------------------------------------------
# int8 x int8 -> int32 (reference: quantized_fully_connected.cc,
# quantized_conv.cc)
# ---------------------------------------------------------------------------


def int8_conv_plain(x, w, stride, pad, dilate, groups):
    """The plain version of ``kernels/int8_conv.cu`` and its oracle: an
    f64 convolution of the int8 values, exact, cast to int32."""
    out = F.conv2d(x.to(torch.float64), w.to(torch.float64), None,
                   stride=tuple(stride), padding=tuple(pad),
                   dilation=tuple(dilate), groups=groups)
    return out.to(torch.int32)


@torch.library.custom_op("mxnet_tpu_torch::int8_conv", mutates_args=())
def _int8_conv_op(x: torch.Tensor, w: torch.Tensor, stride: List[int],
                  pad: List[int], dilate: List[int],
                  groups: int) -> torch.Tensor:
    """int8 NCHW ``x`` convolved with int8 OIHW ``w`` into int32: one
    call of ``kernels/int8_conv.cu`` (its layout pass and convolution) on
    the card, ``int8_conv_plain`` on the CPU."""
    if x.is_cuda:
        from .. import kernels

        return kernels.int8_conv(x.contiguous(), w.contiguous(), stride,
                                 pad, dilate, groups)
    if x.device.type != "cpu":
        raise ValueError("int8_conv: no kernel for %s tensors" % x.device)
    return int8_conv_plain(x, w, stride, pad, dilate, groups)


@_int8_conv_op.register_fake
def _(x, w, stride, pad, dilate, groups):
    N, _, H, W = x.shape
    Fo, _, KH, KW = w.shape
    Ho = (H + 2 * pad[0] - (dilate[0] * (KH - 1) + 1)) // stride[0] + 1
    Wo = (W + 2 * pad[1] - (dilate[1] * (KW - 1) + 1)) // stride[1] + 1
    return x.new_empty((N, Fo, Ho, Wo), dtype=torch.int32)


def int8_conv(x, w, stride=(1, 1), pad=(0, 0), dilate=(1, 1), groups=1):
    """The ``int8_conv`` custom op on int8 tensors (anything else, as the
    zero tensors of shape inference, is cast to int8 first)."""
    return torch.ops.mxnet_tpu_torch.int8_conv(
        x.to(torch.int8), w.to(torch.int8), list(stride), list(pad),
        list(dilate), int(groups))


def _product_range(min_data, max_data, min_w, max_w):
    r_out = _range(min_data, max_data) * _range(min_w, max_w)
    return -r_out, r_out


@register("_contrib_quantized_fully_connected", num_inputs=6, num_outputs=3,
          differentiable=False)
def _quantized_fc(data, weight, min_data, max_data, min_w, max_w,
                  num_hidden=None, flatten=True, **kw):
    """int8 data x int8 weight^T -> int32, on the int8_conv kernel as a
    1x1 convolution of a 1x1 map."""
    if pbool(flatten, True) and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    lead = data.shape[:-1]
    x = data.reshape(-1, data.shape[-1], 1, 1)
    out = int8_conv(x, weight.reshape(weight.shape[0], -1, 1, 1))
    lo, hi = _product_range(min_data, max_data, min_w, max_w)
    return out.reshape(lead + (weight.shape[0],)), lo, hi


def _int8_conv3d(x, w, stride, pad, dilate, groups):
    """int8 NCDHW ``x`` convolved with int8 OIDHW ``w`` into int32 as KD
    2-D convolutions: the data zero-padded in depth, launch kd takes the
    depth slices ``kd * dilate_d + stride_d * od`` folded into the batch
    (N Do images), and the launches sum in int32 (exact, in any order)."""
    N, C, D, H, W = x.shape
    Fo, Cg, KD, KH, KW = w.shape
    sd, pd, dd = stride[0], pad[0], dilate[0]
    Do = (D + 2 * pd - (dd * (KD - 1) + 1)) // sd + 1
    xp = F.pad(x, (0, 0, 0, 0, pd, pd))
    out = None
    for kd in range(KD):
        start = kd * dd
        xs = xp[:, :, start:start + sd * (Do - 1) + 1:sd]
        xs = xs.permute(0, 2, 1, 3, 4).reshape(N * Do, C, H, W)
        part = int8_conv(xs, w[:, :, kd], stride[1:], pad[1:], dilate[1:],
                         groups)
        out = part if out is None else out + part
    return out.reshape((N, Do) + out.shape[1:]).permute(0, 2, 1, 3, 4) \
        .contiguous()


@register("_contrib_quantized_conv", num_inputs=6, num_outputs=3,
          differentiable=False)
def _quantized_conv(data, weight, min_data, max_data, min_w, max_w,
                    kernel=None, stride=None, dilate=None, pad=None,
                    num_filter=None, num_group=1, layout=None, **kw):
    """int8 x int8 -> int32 convolution of any rank, symmetric padding,
    NC(D)(H)W in and out: 2-D on the ``int8_conv`` op, 1-D as 2-D with a
    height of 1, 3-D as ``_int8_conv3d``'s sum of 2-D launches."""
    kernel = ptuple(kernel)
    nd = len(kernel)
    if nd not in (1, 2, 3):
        raise ValueError("quantized_conv: 1-, 2- or 3-D kernels, got %s"
                         % (kernel,))
    stride = ptuple(stride, ndim=nd, default=(1,) * nd)
    dilate = ptuple(dilate, ndim=nd, default=(1,) * nd)
    pad = ptuple(pad, ndim=nd, default=(0,) * nd)
    groups = pint(num_group, 1)
    if nd == 1:
        out = int8_conv(data.unsqueeze(2), weight.unsqueeze(2),
                        (1,) + stride, (0,) + pad, (1,) + dilate,
                        groups).squeeze(2)
    elif nd == 3:
        out = _int8_conv3d(data.to(torch.int8), weight.to(torch.int8),
                           stride, pad, dilate, groups)
    else:
        out = int8_conv(data, weight, stride, pad, dilate, groups)
    lo, hi = _product_range(min_data, max_data, min_w, max_w)
    return out, lo, hi


@register("_contrib_dequantize_int32", num_inputs=3, differentiable=False)
def _dequantize_i32(data, min_range, max_range, **kw):
    """int32 accumulator -> f32 at the propagated product range,
    ``r / (127 * 127)`` first as in the JAX op."""
    r = _range(min_range, max_range)
    return data.to(torch.float32) * (r / _full(127.0 * 127.0, r))
