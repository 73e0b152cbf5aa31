"""Deformable ConvNets ops (parity: mxnet_tpu/ops/deformable.py; the
reference's src/operator/contrib/deformable_convolution.cc and
psroi_pooling.cc).

DeformableConvolution samples each kernel tap at its learned fractional
offset with one bilinear gather (out-of-map taps read zero) and reduces
to one matmul a group over (Cin/g x KH x KW); PSROIPooling averages each
bin over its integer cells through a 2-D integral image (four gathers a
bin), centred on the channel mean first.  Gradients are torch
autograd's through the gathers.
"""
from __future__ import annotations

import torch

from .registry import register
from .utils import pbool, pfloat, pint, ptuple


def bilinear_mix(tap_gather, py, px, H, W):
    """Zero-padded bilinear combine: ``tap_gather(yc, xc)`` reads integer
    taps; out-of-map taps contribute zero."""
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = py - y0
    wx = px - x0

    def tap(yi, xi):
        inb = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        yc = torch.clamp(yi, 0, H - 1).to(torch.long)
        xc = torch.clamp(xi, 0, W - 1).to(torch.long)
        return tap_gather(yc, xc) * inb

    return (tap(y0, x0) * (1 - wy) * (1 - wx) +
            tap(y0 + 1, x0) * wy * (1 - wx) +
            tap(y0, x0 + 1) * (1 - wy) * wx +
            tap(y0 + 1, x0 + 1) * wy * wx)


def _bilinear_sample_nck(data, py, px):
    """Sample data (N, C, H, W) at fractional (py, px) of shape
    (N, C, K, Ho, Wo)."""
    N, C, H, W = data.shape
    flat = data.reshape(N, C, H * W)

    def gather(yc, xc):
        idx = (yc * W + xc).reshape(N, C, -1)
        return torch.gather(flat, 2, idx).reshape(yc.shape)

    return bilinear_mix(gather, py, px, H, W)


@register("_contrib_DeformableConvolution", num_inputs=-1)
def _deformable_convolution(data, offset, weight, bias=None, kernel=None,
                            stride=None, dilate=None, pad=None,
                            num_filter=None, num_group=1,
                            num_deformable_group=1, no_bias=False,
                            layout=None, workspace=None, **kw):
    """data (N, C, H, W) + offset (N, 2*G*KH*KW, Ho, Wo) -> (N, F, Ho, Wo);
    offset channel (g*K + tap)*2 + {0: y, 1: x}."""
    kh, kw_ = ptuple(kernel)
    sh, sw = ptuple(stride, ndim=2, default=(1, 1))
    dh, dw = ptuple(dilate, ndim=2, default=(1, 1))
    ph, pw = ptuple(pad, ndim=2, default=(0, 0))
    G = pint(num_deformable_group, 1)
    groups = pint(num_group, 1)
    N, C, H, W = data.shape
    K = kh * kw_
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw_ - 1) + 1)) // sw + 1
    dev = data.device
    ys = torch.arange(Ho, device=dev) * sh - ph
    xs = torch.arange(Wo, device=dev) * sw - pw
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dh,
                            torch.arange(kw_, device=dev) * dw,
                            indexing="ij")
    base_y = ys[None, :, None] + ky.reshape(K, 1, 1)     # (K, Ho, 1)
    base_x = xs[None, None, :] + kx.reshape(K, 1, 1)     # (K, 1, Wo)
    off = offset.reshape(N, G, K, 2, Ho, Wo)
    py = base_y[None, None] + off[:, :, :, 0]            # (N, G, K, Ho, Wo)
    px = base_x[None, None] + off[:, :, :, 1]
    rep = C // G
    py = torch.repeat_interleave(py, rep, dim=1)         # (N, C, K, Ho, Wo)
    px = torch.repeat_interleave(px, rep, dim=1)
    patches = _bilinear_sample_nck(data, py, px)         # (N, C, K, Ho, Wo)
    F = pint(num_filter)
    wmat = weight.reshape(F, -1)
    cpg, fpg = C // groups, F // groups
    outs = []
    for g in range(groups):
        pg = patches[:, g * cpg:(g + 1) * cpg].reshape(N, cpg * K, Ho * Wo)
        outs.append(torch.einsum("fk,nko->nfo",
                                 wmat[g * fpg:(g + 1) * fpg], pg))
    out = torch.cat(outs, dim=1).reshape(N, F, Ho, Wo)
    if not pbool(no_bias) and bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out.to(data.dtype)


def _integral(data):
    """Zero-padded 2-D integral image over the trailing axes."""
    s = torch.cumsum(torch.cumsum(data, dim=-1), dim=-2)
    return torch.nn.functional.pad(s, (1, 0, 1, 0))


@register("_contrib_PSROIPooling", num_inputs=2, aliases=("PSROIPooling",))
def _psroi_pooling(data, rois, spatial_scale=1.0, output_dim=None,
                   pooled_size=None, group_size=0, **kw):
    """Position-sensitive ROI pooling (R-FCN): channels laid out as
    (output_dim, group, group); bin (i, j) of each roi averages its own
    (i, j) channel group.  (R, output_dim, P, P)."""
    scale = pfloat(spatial_scale, 1.0)
    P = pint(pooled_size)
    gs = pint(group_size, 0) or P
    od = pint(output_dim)
    _N, C, H, W = data.shape
    dev = data.device
    ch_mean = torch.mean(data, dim=(2, 3), keepdim=True)
    integ = _integral(data - ch_mean)                    # (N, C, H+1, W+1)
    ar = torch.arange(P, device=dev)
    sel = torch.clamp(torch.div(ar * gs, P, rounding_mode="floor"),
                      max=gs - 1)
    ch_idx = ((torch.arange(od, device=dev)[:, None, None] * gs
               + sel[None, :, None]) * gs + sel[None, None, :])  # (od, P, P)
    b = rois[:, 0].to(torch.long)
    x1 = torch.round(rois[:, 1]) * scale
    y1 = torch.round(rois[:, 2]) * scale
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_h, bin_w = rh / P, rw / P
    fi = ar.to(data.dtype)
    ys0 = torch.clamp(torch.floor(y1[:, None] + fi * bin_h[:, None]), 0, H) \
        .to(torch.long)
    ys1 = torch.clamp(torch.ceil(y1[:, None] + (fi + 1) * bin_h[:, None]),
                      0, H).to(torch.long)
    xs0 = torch.clamp(torch.floor(x1[:, None] + fi * bin_w[:, None]), 0, W) \
        .to(torch.long)
    xs1 = torch.clamp(torch.ceil(x1[:, None] + (fi + 1) * bin_w[:, None]),
                      0, W).to(torch.long)
    R = rois.shape[0]
    W1 = W + 1
    # the integral image of each roi's image at its selected channels
    flat = integ.reshape(integ.shape[0], C, -1)[b][:, ch_idx.reshape(-1)] \
        .reshape(R, od, P, P, -1)                        # R, od, P, P, HW1

    def take(yy, xx):   # yy (R, P) rows by bin row, xx (R, P) by bin col
        idx = (yy[:, :, None] * W1 + xx[:, None, :])     # (R, P, P)
        return torch.gather(flat, 4, idx[:, None, :, :, None]
                            .expand(R, od, P, P, 1))[..., 0]

    total = (take(ys1, xs1) - take(ys0, xs1) - take(ys1, xs0)
             + take(ys0, xs0))
    count = torch.clamp((ys1 - ys0)[:, :, None] * (xs1 - xs0)[:, None, :],
                        min=1)[:, None]
    means = ch_mean.reshape(-1, C)[b][:, ch_idx.reshape(-1)] \
        .reshape(R, od, P, P)
    picked = total / count + means
    empty = ((ys1 <= ys0)[:, :, None] | (xs1 <= xs0)[:, None, :])[:, None]
    return torch.where(empty, torch.zeros_like(picked), picked) \
        .to(data.dtype)


@register("_contrib_DeformablePSROIPooling", num_inputs=-1)
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=1.0,
                              output_dim=None, group_size=0,
                              pooled_size=None, part_size=0,
                              sample_per_part=1, trans_std=0.0,
                              no_trans=False, **kw):
    """Deformable PSROIPooling, the no_trans path only: the integer-cell
    average of PSROIPooling (the JAX op's approximation of the
    reference's -0.5 shift and sub-samples); learned offsets raise."""
    if not pbool(no_trans) and trans is not None and \
            pfloat(trans_std, 0.0) != 0.0:
        raise NotImplementedError(
            "DeformablePSROIPooling with learned offsets (no_trans=False)"
            " is not implemented; use no_trans=True")
    return _psroi_pooling(data, rois, spatial_scale=spatial_scale,
                          output_dim=output_dim,
                          pooled_size=pooled_size, group_size=group_size)
