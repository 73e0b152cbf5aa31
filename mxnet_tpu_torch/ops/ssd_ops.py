"""The detection ops MultiBoxTarget, MultiBoxDetection and Proposal
(parity: mxnet_tpu/ops/ssd_ops.py; the reference's
src/operator/contrib/multibox_target.cc, multibox_detection.cc and
proposal.cc).  The compute is ``ops/ssd.py``; ``_contrib_MultiProposal``
is Proposal batched, as in the JAX package."""
from __future__ import annotations

import numpy as np
import torch

from . import ssd
from .registry import register
from .utils import pfloat, pint, pbool, pftuple

_VARIANCES = (0.1, 0.1, 0.2, 0.2)


@register("_contrib_MultiBoxTarget", num_inputs=3, num_outputs=3,
          differentiable=False, aliases=("MultiBoxTarget",))
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5,
                     minimum_negative_samples=0,
                     variances=_VARIANCES, **kw):
    return ssd.multibox_target(
        anchor, label, cls_pred, pfloat(overlap_threshold, 0.5),
        pfloat(ignore_label, -1.0), pfloat(negative_mining_ratio, -1.0),
        pfloat(negative_mining_thresh, 0.5),
        pint(minimum_negative_samples, 0),
        pftuple(variances, default=_VARIANCES))


@register("_contrib_MultiBoxDetection", num_inputs=3,
          differentiable=False, aliases=("MultiBoxDetection",))
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0,
                        nms_threshold=0.5, force_suppress=False,
                        variances=_VARIANCES, nms_topk=-1, **kw):
    return ssd.multibox_detection(
        cls_prob, loc_pred, anchor, pbool(clip, True),
        pfloat(threshold, 0.01), pint(background_id, 0),
        pfloat(nms_threshold, 0.5), pbool(force_suppress, False),
        pftuple(variances, default=_VARIANCES), pint(nms_topk, -1))


def _generate_anchors(stride, scales, ratios):
    """py_faster_rcnn-style base anchors (proposal.cc GenerateAnchors)."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w, h = base[2] - base[0] + 1, base[3] - base[1] + 1
    cx, cy = base[0] + 0.5 * (w - 1), base[1] + 0.5 * (h - 1)
    out = []
    for r in ratios:
        size = w * h
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            sw, sh = ws * s, hs * s
            out.append([cx - 0.5 * (sw - 1), cy - 0.5 * (sh - 1),
                        cx + 0.5 * (sw - 1), cy + 0.5 * (sh - 1)])
    return np.asarray(out, np.float32)


@torch.compiler.assume_constant_result
def _base_anchors(stride, scales, ratios):
    """``_generate_anchors`` as nested tuples of floats: a constant of a
    compiled graph (numpy there would trace as CPU tensors)."""
    return tuple(tuple(float(v) for v in row)
                 for row in _generate_anchors(stride, scales, ratios))


@register("_contrib_Proposal", num_inputs=3, differentiable=False,
          num_outputs=lambda attrs: 2 if pbool(attrs.get("output_score"))
          else 1, aliases=("Proposal", "_contrib_MultiProposal"))
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=False, iou_loss=False,
              **kw):
    if pbool(iou_loss, False):
        raise NotImplementedError(
            "Proposal(iou_loss=True): the IoU corner-offset transform is "
            "not implemented; use the default center/log-size decoding")
    stride = pint(feature_stride, 16)
    base = _base_anchors(stride, pftuple(scales, default=(4, 8, 16, 32)),
                         pftuple(ratios, default=(0.5, 1, 2)))
    rois, scores = ssd.proposal(
        cls_prob, bbox_pred, im_info, base, stride,
        pint(rpn_pre_nms_top_n, 6000), pint(rpn_post_nms_top_n, 300),
        pfloat(threshold, 0.7), pfloat(rpn_min_size, 16))
    return (rois, scores) if pbool(output_score, False) else rois
