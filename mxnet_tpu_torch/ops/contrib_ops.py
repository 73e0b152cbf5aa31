"""Contrib ops of the detection stack and the utility contribs (parity:
mxnet_tpu/ops/contrib_ops.py; the reference's src/operator/contrib/).

Bounding boxes (``box_iou``, ``box_nms``, ``MultiBoxPrior``), the ROI
ops (``ROIPooling``, ``ROIAlign``, gradients through torch autograd) and
``quadratic``, ``allclose``, ``arange_like``, ``index_copy``, ``getnnz``,
``div_sqrt_dim`` and ``count_sketch``.  ``box_nms``'s greedy pass is the
``nms`` custom op of ``ops/ssd.py`` (a hand-written kernel on the card);
the sort around it is a stable torch sort, as ``jnp.argsort`` is stable.
"""
from __future__ import annotations

import math

import torch

from .registry import register
from .utils import pbool, pint, pfloat, ptuple, paxis

__all__ = ["box_iou", "box_to_corner"]


@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(data, **kw):
    return data / torch.sqrt(torch.tensor(data.shape[-1], dtype=data.dtype,
                                          device=data.device))


@register("_contrib_arange_like", differentiable=False)
def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None, **kw):
    ax = paxis(axis)
    n = data.numel() if ax is None else data.shape[ax]
    out = (torch.arange(n, device=data.device).to(data.dtype)
           * pfloat(step, 1.0) + pfloat(start, 0.0))
    return out.reshape(data.shape) if ax is None else out


@register("_contrib_index_copy", num_inputs=3, differentiable=False)
def _index_copy(old, index, new, **kw):
    out = old.clone()
    out[index.to(torch.long)] = new.to(old.dtype)
    return out


@register("_contrib_getnnz", differentiable=False)
def _getnnz(data, axis=None, **kw):
    ax = paxis(axis)
    nz = (data != 0).to(torch.int32)
    return nz.sum(dtype=torch.int32) if ax is None else \
        nz.sum(dim=ax, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Bounding-box ops (reference: src/operator/contrib/bounding_box.cc)
# ---------------------------------------------------------------------------


def box_to_corner(b, format="corner"):
    """(..., 4) boxes as corners: ``center`` (x, y, w, h) converted,
    ``corner`` unchanged."""
    if (format or "corner") == "center":
        x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2],
                           dim=-1)
    return b


def box_iou(lhs, rhs, format="corner"):
    """IoU of (..., N, 4) against (..., M, 4) -> (..., N, M), the union
    floored at 1e-12 (the JAX op's arithmetic, op for op)."""
    a = box_to_corner(lhs, format)[..., :, None, :]
    b = box_to_corner(rhs, format)[..., None, :, :]
    tl = torch.maximum(a[..., :2], b[..., :2])
    br = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(br - tl, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


@register("_contrib_box_iou", num_inputs=2, differentiable=False)
def _box_iou(lhs, rhs, format="corner", **kw):
    return box_iou(lhs, rhs, format)


@register("_contrib_box_nms", differentiable=False,
          aliases=("_contrib_nms", "_contrib_box_non_maximum_suppression"))
def _box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, background_id=-1,
             force_suppress=False, in_format="corner", out_format="corner",
             **kw):
    """Greedy NMS over the score-sorted candidates of each batch row;
    suppressed and invalid (score <= ``valid_thresh``) entries get every
    field -1.  As in the JAX op, ``topk``, ``background_id`` and
    ``out_format`` are accepted and not applied."""
    from .ssd import nms_keep

    ot = pfloat(overlap_thresh, 0.5)
    vt = pfloat(valid_thresh, 0.0)
    cs = pint(coord_start, 2)
    si = pint(score_index, 1)
    ii = pint(id_index, -1)
    force = pbool(force_suppress)
    batch_shape = data.shape[:-2]
    N, F = data.shape[-2], data.shape[-1]
    flat = data.reshape(-1, N, F)
    order = torch.sort(-flat[:, :, si], dim=1, stable=True).indices
    sortd = torch.gather(flat, 1, order[:, :, None].expand(-1, -1, F))
    boxes = box_to_corner(sortd[:, :, cs:cs + 4], in_format)
    valid = sortd[:, :, si] > vt
    class_aware = not (force or ii < 0)
    ids = sortd[:, :, ii] if class_aware else sortd[:, :, si]
    keep = nms_keep(boxes, ids, valid, ot, class_aware=class_aware,
                    inclusive=False, plus_one=False)
    out = torch.where(keep[:, :, None], sortd, torch.full_like(sortd, -1))
    return out.reshape(batch_shape + (N, F))


# ---------------------------------------------------------------------------
# SSD anchors (reference: src/operator/contrib/multibox_prior.cc)
# ---------------------------------------------------------------------------


def _plist(v, d):
    """A float tuple attr; a string is split by hand, as a compiled graph
    cannot run ``ast.literal_eval``."""
    if v is None:
        return d
    if isinstance(v, str):
        parts = [x for x in v.strip().strip("()[]").split(",") if x.strip()]
        return tuple(float(x) for x in parts) if parts else d
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


@register("_contrib_MultiBoxPrior", differentiable=False,
          aliases=("MultiBoxPrior",))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=None, offsets=(0.5, 0.5), **kw):
    """Anchors (1, H*W*A, 4) of the (N, C, H, W) feature map, in mxnet's
    order (s1,r1), (s2,r1), ..., (sn,r1), (s1,r2), (s1,r3), ..."""
    sizes = _plist(sizes, (1.0,))
    ratios = _plist(ratios, (1.0,))
    offs = _plist(offsets, (0.5, 0.5))
    h, w = data.shape[2], data.shape[3]
    step_y, step_x = 1.0 / h, 1.0 / w
    st = ptuple(steps) if steps is not None else None
    if st and st[0] > 0:
        step_y, step_x = st
    dev = data.device
    cy = (torch.arange(h, device=dev) + offs[0]) * step_y
    cx = (torch.arange(w, device=dev) + offs[1]) * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    anchors = []
    combos = [(s, ratios[0]) for s in sizes] + \
        [(sizes[0], r) for r in ratios[1:]]
    for s, r in combos:
        aw = s * math.sqrt(r) / 2     # Python floats: numpy here would
        ah = s / math.sqrt(r) / 2     # trace as CPU tensors
        anchors.append(torch.stack([cx - aw, cy - ah, cx + aw, cy + ah],
                                   dim=-1))
    out = torch.stack(anchors, dim=2).reshape(1, -1, 4)
    if pbool(clip):
        out = torch.clamp(out, 0.0, 1.0)
    return out.to(data.dtype)


@register("quadratic", aliases=("_contrib_quadratic",))
def _quadratic(data, a=0.0, b=0.0, c=0.0, **kw):
    return (pfloat(a, 0.0) * torch.square(data) + pfloat(b, 0.0) * data
            + pfloat(c, 0.0))


@register("_contrib_allclose", num_inputs=2, differentiable=False)
def _allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=True, **kw):
    return torch.isclose(a, b.to(a.dtype), rtol=pfloat(rtol, 1e-5),
                         atol=pfloat(atol, 1e-8),
                         equal_nan=pbool(equal_nan, True)).all() \
        .to(torch.float32)


# ---------------------------------------------------------------------------
# ROI ops (reference: roi_pooling.cc, contrib/roi_align.cc)
# ---------------------------------------------------------------------------


def _roi_images(data, rois):
    return data[rois[:, 0].to(torch.long)]


@register("ROIPooling", num_inputs=2)
def roi_pooling(data, rois, pooled_size=None, spatial_scale=1.0, **kw):
    """Max over each of the (ph, pw) integer cells of each roi; an empty
    cell is 0.  (R, C, ph, pw)."""
    ph, pw = ptuple(pooled_size)
    scale = pfloat(spatial_scale, 1.0)
    _N, _C, H, W = data.shape
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).to(torch.int32)
                      for i in range(1, 5))
    rh = torch.clamp(y2 - y1 + 1, min=1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    dev = data.device
    py = torch.arange(ph, device=dev, dtype=torch.int32)
    px = torch.arange(pw, device=dev, dtype=torch.int32)
    hstart = y1[:, None] + torch.div(py[None] * rh[:, None], ph,
                                     rounding_mode="floor")
    hend = y1[:, None] + torch.div((py[None] + 1) * rh[:, None] + ph - 1,
                                   ph, rounding_mode="floor")
    wstart = x1[:, None] + torch.div(px[None] * rw[:, None], pw,
                                     rounding_mode="floor")
    wend = x1[:, None] + torch.div((px[None] + 1) * rw[:, None] + pw - 1,
                                   pw, rounding_mode="floor")
    ys = torch.arange(H, device=dev)
    xs = torch.arange(W, device=dev)
    my = (ys[None, None] >= hstart[:, :, None]) & \
        (ys[None, None] < hend[:, :, None])                  # (R, ph, H)
    mx = (xs[None, None] >= wstart[:, :, None]) & \
        (xs[None, None] < wend[:, :, None])                  # (R, pw, W)
    mask = my[:, :, None, :, None] & mx[:, None, :, None, :]  # R,ph,pw,H,W
    img = _roi_images(data, rois)                            # (R, C, H, W)
    masked = torch.where(mask[:, None], img[:, :, None, None],
                         torch.full((), -float("inf"), dtype=data.dtype,
                                    device=dev))
    v = torch.amax(masked, dim=(4, 5))
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def _bilinear_clamped(img, y, x, H, W):
    """Bilinear samples of img (R, C, H, W) at (R, P) coordinates, each
    clamped into the map (ROIAlign's border rule) -> (R, C, P)."""
    y = torch.clamp(y, 0.0, H - 1.0)
    x = torch.clamp(x, 0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.long)
    x0 = torch.floor(x).to(torch.long)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (y - y0)[:, None]
    wx = (x - x0)[:, None]
    R, C = img.shape[:2]
    flat = img.reshape(R, C, H * W)

    def tap(yi, xi):
        return torch.gather(flat, 2, (yi * W + xi)[:, None].expand(-1, C,
                                                                    -1))

    return (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x1) * (1 - wy) * wx
            + tap(y1, x0) * wy * (1 - wx) + tap(y1, x1) * wy * wx)


@register("_contrib_ROIAlign", num_inputs=2)
def roi_align(data, rois, pooled_size=None, spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False,
              **kw):
    """The mean of sr x sr bilinear samples (sr 2 unless given) in each
    of the (ph, pw) bins of each roi.  (R, C, ph, pw)."""
    ph, pw = ptuple(pooled_size)
    scale = pfloat(spatial_scale, 1.0)
    _N, C, H, W = data.shape
    sr = pint(sample_ratio, -1)
    sr = sr if sr > 0 else 2
    off = 0.5 if pbool(aligned) else 0.0
    x1, y1, x2, y2 = (rois[:, i] * scale - off for i in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bh, bw = rh / ph, rw / pw
    # (py + (iy + 0.5) / sr) per (py, px, iy, ix), a double rounded once
    # to f32 as the JAX op's Python float is
    fy = torch.tensor([p + (i + 0.5) / sr for p in range(ph)
                       for _px in range(pw) for i in range(sr)
                       for _ix in range(sr)], dtype=torch.float32,
                      device=data.device)
    fx = torch.tensor([p + (i + 0.5) / sr for _py in range(ph)
                       for p in range(pw) for _iy in range(sr)
                       for i in range(sr)], dtype=torch.float32,
                      device=data.device)
    y = y1[:, None] + fy[None] * bh[:, None]
    x = x1[:, None] + fx[None] * bw[:, None]
    vals = _bilinear_clamped(_roi_images(data, rois), y, x, H, W)
    R = rois.shape[0]
    return vals.reshape(R, C, ph, pw, sr * sr).mean(dim=4)


@register("_contrib_count_sketch", num_inputs=3, differentiable=False)
def _count_sketch(data, h, s, out_dim=0, processing_batch_size=32, **kw):
    od = pint(out_dim)
    idx = (h[0] if h.dim() > 1 else h).to(torch.long)
    signed = data * s
    out = torch.zeros(data.shape[:-1] + (od,), dtype=data.dtype,
                      device=data.device)
    return out.index_add(data.dim() - 1, idx, signed)
