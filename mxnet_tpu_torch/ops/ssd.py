"""MultiBox target encoding, detection decode and NMS, and RPN proposals
(parity: mxnet_tpu/ops/ssd_jax.py; the reference's
src/operator/contrib/multibox_target.cc, multibox_detection.cc and
proposal.cc).

Static-shape tensor code, batched over the images where the JAX package
vmaps one image: the bipartite match is M rounds of a first-index argmax
over (N, M), negative mining a rank-against-count mask from a stable
sort, and the box work plain torch ops, so a whole SSD graph compiles
with ``fullgraph=True``.  The one loop a compiled graph cannot hold, the
greedy suppression pass (``lax.fori_loop`` in the JAX package), is the
``mxnet_tpu_torch::nms`` custom op: ``kernels/nms.cu`` for a CUDA
tensor, ``nms_plain`` (its oracle) for a CPU one.  Sorting, decoding,
top-k and compaction stay torch ops; every sort is stable, as
``jnp.argsort`` is and as ``lax.top_k`` breaks ties toward the lower
index.
"""
from __future__ import annotations

import torch

from .contrib_ops import box_iou

__all__ = ["iou_plus_one", "nms_plain", "nms_keep", "multibox_target",
           "decode", "detection_candidates", "multibox_detection",
           "proposal_candidates", "proposal"]


def iou_plus_one(a, b):
    """IoU of corner boxes (..., N, 4) against (..., M, 4) with the +1
    pixel-box areas that proposal.cc's NMS uses, no floor."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt + 1, min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def nms_plain(boxes, ids, alive, thresh, class_aware, inclusive, plus_one):
    """The greedy pass one candidate at a time, on whole batch rows: the
    plain version of ``kernels/nms.cu`` and its test oracle.  For i in
    order, a kept i clears every later j of its class (when
    ``class_aware``) whose IoU with it is ``>= thresh`` (``inclusive``) or
    ``> thresh``."""
    B, N = alive.shape
    keep = alive.clone()
    later = torch.arange(N, device=boxes.device)
    for i in range(N):
        row = keep[:, i]
        if not bool(row.any()):
            continue
        bi = boxes[:, i:i + 1]
        iou = (iou_plus_one(bi, boxes) if plus_one
               else box_iou(bi, boxes))[:, 0]
        hit = iou >= thresh if inclusive else iou > thresh
        kill = row[:, None] & hit & (later > i)[None]
        if class_aware:
            kill = kill & (ids == ids[:, i:i + 1])
        keep = keep & ~kill
    return keep


@torch.library.custom_op("mxnet_tpu_torch::nms", mutates_args=())
def _nms_op(boxes: torch.Tensor, ids: torch.Tensor, alive: torch.Tensor,
            thresh: float, class_aware: bool, inclusive: bool,
            plus_one: bool) -> torch.Tensor:
    """The keep mask (B, N) of greedy suppression over sorted candidates
    (``nms_plain``'s arguments): one call of ``kernels/nms.cu`` (its mask
    and walk kernels) on the card, ``nms_plain`` on the CPU."""
    if boxes.is_cuda:
        from .. import kernels

        return kernels.nms(boxes, ids, alive, thresh, class_aware,
                           inclusive, plus_one)
    if boxes.device.type != "cpu":
        raise ValueError("nms: no kernel for %s tensors" % boxes.device)
    return nms_plain(boxes, ids, alive, thresh, class_aware, inclusive,
                     plus_one)


@_nms_op.register_fake
def _(boxes, ids, alive, thresh, class_aware, inclusive, plus_one):
    return torch.empty_like(alive)


def nms_keep(boxes, ids, alive, thresh, class_aware=False, inclusive=False,
             plus_one=False):
    """Greedy suppression over score-sorted (B, N) candidates through the
    ``nms`` custom op: f32 corner ``boxes`` (B, N, 4), class ``ids`` and
    the bool ``alive`` mask they start from -> the bool keep mask."""
    return torch.ops.mxnet_tpu_torch.nms(
        boxes.to(torch.float32).contiguous(),
        ids.to(torch.float32).contiguous(), alive.contiguous(),
        float(thresh), bool(class_aware), bool(inclusive), bool(plus_one))


def _encode(anchors, gts, variances):
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) * 0.5
    ay = (anchors[..., 1] + anchors[..., 3]) * 0.5
    gw = torch.clamp(gts[..., 2] - gts[..., 0], min=1e-12)
    gh = torch.clamp(gts[..., 3] - gts[..., 1], min=1e-12)
    gx = (gts[..., 0] + gts[..., 2]) * 0.5
    gy = (gts[..., 1] + gts[..., 3]) * 0.5
    vx, vy, vw, vh = variances
    aw, ah = torch.clamp(aw, min=1e-12), torch.clamp(ah, min=1e-12)
    return torch.stack([(gx - ax) / aw / vx, (gy - ay) / ah / vy,
                        torch.log(gw / aw) / vw, torch.log(gh / ah) / vh],
                       dim=-1)


def multibox_target(anchor, label, cls_pred, overlap_threshold,
                    ignore_label, negative_mining_ratio,
                    negative_mining_thresh, minimum_negative_samples,
                    variances):
    """anchor (1, N, 4), label (B, M, 5) rows [cls, x1, y1, x2, y2] (cls < 0
    pads), cls_pred (B, C, N) logits -> (loc_target (B, 4N), loc_mask
    (B, 4N), cls_target (B, N))."""
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    dev = anchors.device
    valid = label[:, :, 0] >= 0                          # (B, M)
    iou = box_iou(anchors[None], label[:, :, 1:5])       # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))

    # greedy bipartite: one (anchor, gt) pair per round, M rounds
    rows = torch.arange(N, device=dev)
    cols = torch.arange(M, device=dev)
    work = iou
    match_gt = torch.full((B, N), -1, dtype=torch.long, device=dev)
    match_iou = torch.full((B, N), -1.0, dtype=iou.dtype, device=dev)
    for _ in range(M):
        flat = work.reshape(B, N * M)
        at = torch.argmax(flat, dim=1)
        best = torch.gather(flat, 1, at[:, None])[:, 0]
        j, k = at // M, at % M
        good = best > 1e-12
        here = good[:, None] & (rows[None] == j[:, None])            # (B, N)
        match_gt = torch.where(here, k[:, None], match_gt)
        match_iou = torch.where(here, best[:, None], match_iou)
        cut = here[:, :, None] | (good[:, None] & (cols[None] == k[:, None])
                                  )[:, None, :]
        work = torch.where(cut, torch.full_like(work, -1.0), work)
    pos = match_gt >= 0

    # threshold matching for the rest: every anchor not matched above
    # carries its best IoU (the mining pool reads it, as in the reference)
    best = torch.argmax(iou, dim=2)
    best_iou = torch.gather(iou, 2, best[:, :, None])[:, :, 0]
    match_gt = torch.where(pos, match_gt, best)
    match_iou = torch.where(pos, match_iou, best_iou)
    if overlap_threshold > 0:
        pos = pos | (~pos & (best_iou > overlap_threshold))
    num_pos = pos.sum(dim=1)

    # hard-negative mining: rank candidates by background confidence
    if negative_mining_ratio > 0:
        num_neg = torch.minimum(
            (num_pos.to(torch.float32) * negative_mining_ratio)
            .to(torch.int64), N - num_pos)
        num_neg = torch.clamp(num_neg, min=int(minimum_negative_samples))
        cand = ~pos & (match_iou < negative_mining_thresh)
        logits = cls_pred - torch.logsumexp(cls_pred, dim=1, keepdim=True)
        prob_bg = torch.exp(logits[:, 0])                             # (B, N)
        score = torch.where(cand, prob_bg, torch.full_like(prob_bg,
                                                           float("inf")))
        order = torch.sort(score, dim=1, stable=True).indices
        rank = torch.empty_like(order).scatter_(
            1, order, rows[None].expand(B, N).contiguous())
        neg = cand & (rank < num_neg[:, None])
    else:
        neg = ~pos

    gt_rows = torch.gather(label, 1, torch.clamp(match_gt, min=0)[:, :, None]
                           .expand(B, N, label.shape[2]))
    enc = _encode(anchors[None], gt_rows[:, :, 1:5], variances)
    loc_target = torch.where(pos[:, :, None], enc, torch.zeros_like(enc))
    loc_mask = pos[:, :, None].to(anchors.dtype).expand(B, N, 4)
    cls_target = torch.full((B, N), float(ignore_label), dtype=torch.float32,
                            device=dev)
    cls_target = torch.where(neg, torch.zeros_like(cls_target), cls_target)
    cls_target = torch.where(pos, gt_rows[:, :, 0] + 1.0, cls_target)
    return (loc_target.reshape(B, -1), loc_mask.reshape(B, -1),
            cls_target)


def decode(anchors, loc, variances, clip):
    """Centre/log-size offsets ``loc`` (..., N, 4) on corner ``anchors``
    (N, 4) -> corner boxes, clipped to [0, 1] when ``clip``."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) * 0.5
    ay = (anchors[:, 1] + anchors[:, 3]) * 0.5
    vx, vy, vw, vh = variances
    ox = loc[..., 0] * vx * aw + ax
    oy = loc[..., 1] * vy * ah + ay
    ow = torch.exp(loc[..., 2] * vw) * aw / 2
    oh = torch.exp(loc[..., 3] * vh) * ah / 2
    out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


def detection_candidates(cls_prob, loc_pred, anchor, clip, threshold,
                         background_id, variances, run_nms):
    """MultiBoxDetection up to its NMS pass: each anchor's best class and
    score and its decoded box, sorted (score-descending when ``run_nms``,
    else anchor order; invalid rows last).  Returns (oid, score, boxes):
    oid the output id (-1 background / below ``threshold``)."""
    B, C, N = cls_prob.shape
    anchors = anchor.reshape(-1, 4)
    bid = background_id
    dev = cls_prob.device
    is_bg = (torch.arange(C, device=dev) == bid)[None, :, None]
    p = torch.where(is_bg, torch.full_like(cls_prob, -float("inf")),
                    cls_prob)
    score, cid = torch.max(p, dim=1)
    cid = torch.where(score < threshold, torch.full_like(cid, bid), cid)
    boxes = decode(anchors, loc_pred.reshape(B, N, 4), variances, clip)
    oid = torch.where(cid == bid, torch.full_like(score, -1.0),
                      (cid - (cid > bid).to(cid.dtype)).to(score.dtype))
    if run_nms:
        key = torch.where(oid >= 0, -score, torch.full_like(score,
                                                            float("inf")))
    else:
        idx = torch.arange(N, device=dev)
        key = torch.where(oid >= 0, idx[None], torch.full_like(idx, N + 1))
    order = torch.sort(key, dim=1, stable=True).indices
    return (torch.gather(oid, 1, order), torch.gather(score, 1, order),
            torch.gather(boxes, 1, order[:, :, None].expand(B, N, 4)))


def multibox_detection(cls_prob, loc_pred, anchor, clip, threshold,
                       background_id, nms_threshold, force_suppress,
                       variances, nms_topk):
    """Decode + per-class NMS -> (B, N, 6) rows [id, score, x1, y1, x2,
    y2].  Valid detections lead, score-sorted when NMS runs and in anchor
    order when it is off (nms_threshold outside (0, 1]); a suppressed row
    keeps its sorted slot with only its id set to -1; background and
    below-threshold rows at the back are all -1."""
    N = cls_prob.shape[2]
    run_nms = 0 < nms_threshold <= 1
    oid, score, boxes = detection_candidates(
        cls_prob, loc_pred, anchor, clip, threshold, background_id,
        variances, run_nms)
    alive = oid >= 0
    if run_nms:
        if nms_topk > 0:
            idx = torch.arange(N, device=alive.device)
            alive = alive & (idx < nms_topk)[None]
        # only the first `limit` rows can be alive or suppress
        limit = nms_topk if 0 < nms_topk < N else N
        kept = nms_keep(boxes[:, :limit], oid[:, :limit], alive[:, :limit],
                        nms_threshold, class_aware=not force_suppress,
                        inclusive=True)
        alive = torch.cat([kept, alive[:, limit:]], dim=1)
    rows = torch.cat([torch.where(alive, oid, torch.full_like(oid, -1.0))
                      [:, :, None], score[:, :, None], boxes], dim=2)
    valid = (oid >= 0)[:, :, None]
    return torch.where(valid, rows, torch.full_like(rows, -1.0))


def proposal_candidates(cls_prob, bbox_pred, im_info, base_anchors, stride,
                        pre_n, min_size):
    """Proposal up to its NMS pass: enumerate -> decode -> clip ->
    min-size filter -> the top ``pre_n`` by score.  ``base_anchors`` are
    A rows of 4 floats (``ssd_ops._base_anchors``).  Each image filters
    at its own ``im_info`` scale.  Returns (top_score (B, pre_n),
    top_boxes (B, pre_n, 4))."""
    B, _, H, W = cls_prob.shape
    A = len(base_anchors)
    N = H * W * A
    pre_n = min(pre_n, N)
    dev = cls_prob.device
    sx, sy = torch.meshgrid(torch.arange(W, device=dev) * stride,
                            torch.arange(H, device=dev) * stride,
                            indexing="xy")
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1), sx.reshape(-1),
                          sy.reshape(-1)], dim=1).to(torch.float32)
    base = torch.tensor(base_anchors, dtype=torch.float32, device=dev)
    anchors = (base[None] + shifts[:, None]).reshape(-1, 4)   # (HWA, 4)

    score = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(B, -1)
    d = bbox_pred.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    ih, iw, iscale = im_info[:, 0:1], im_info[:, 1:2], im_info[:, 2:3]
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    ax = anchors[:, 0] + 0.5 * (aw - 1)
    ay = anchors[:, 1] + 0.5 * (ah - 1)
    px = d[..., 0] * aw + ax
    py = d[..., 1] * ah + ay
    pw = torch.exp(torch.clamp(d[..., 2], max=10)) * aw
    ph = torch.exp(torch.clamp(d[..., 3], max=10)) * ah
    x0 = torch.minimum(torch.clamp(px - 0.5 * (pw - 1), min=0), iw - 1)
    y0 = torch.minimum(torch.clamp(py - 0.5 * (ph - 1), min=0), ih - 1)
    x1 = torch.minimum(torch.clamp(px + 0.5 * (pw - 1), min=0), iw - 1)
    y1 = torch.minimum(torch.clamp(py + 0.5 * (ph - 1), min=0), ih - 1)
    # reference FilterBox: an undersized box is grown by min_size/2 a side
    # and scored -1, never dropped
    ms = min_size * iscale
    small = (x1 - x0 + 1 < ms) | (y1 - y0 + 1 < ms)
    half = ms * 0.5
    boxes = torch.where(small[:, :, None],
                        torch.stack([x0 - half, y0 - half, x1 + half,
                                     y1 + half], dim=-1),
                        torch.stack([x0, y0, x1, y1], dim=-1))
    score = torch.where(small, torch.full_like(score, -1.0), score)
    srt = torch.sort(score, dim=1, descending=True, stable=True)
    top_score, top_idx = srt.values[:, :pre_n], srt.indices[:, :pre_n]
    top_boxes = torch.gather(boxes, 1, top_idx[:, :, None].expand(B, pre_n,
                                                                  4))
    return top_score, top_boxes


def proposal(cls_prob, bbox_pred, im_info, base_anchors, stride, pre_n,
             post_n, nms_thr, min_size):
    """RPN proposals: ``proposal_candidates`` -> NMS (+1 IoU, ``>``) ->
    survivors first, cyclic-padded to post_n.  Returns (rois
    (B*post_n, 5), scores (B*post_n, 1))."""
    B = cls_prob.shape[0]
    dev = cls_prob.device
    top_score, top_boxes = proposal_candidates(
        cls_prob, bbox_pred, im_info, base_anchors, stride, pre_n, min_size)
    pre_n = top_score.shape[1]
    alive = nms_keep(top_boxes, top_score,
                     torch.ones((B, pre_n), dtype=torch.bool, device=dev),
                     nms_thr, plus_one=True)
    # survivors to the front, then cyclic-padded to post_n
    idx = torch.arange(pre_n, device=dev)
    comp = torch.sort(torch.where(alive, idx[None],
                                  torch.full_like(idx, pre_n + 1)), dim=1,
                      stable=True).indices
    n_alive = torch.clamp(alive.sum(dim=1), min=1)
    sel = torch.gather(comp, 1, torch.remainder(
        torch.arange(post_n, device=dev)[None], n_alive[:, None]))
    out_boxes = torch.gather(top_boxes, 1, sel[:, :, None].expand(B, post_n,
                                                                  4))
    out_scores = torch.gather(top_score, 1, sel)
    batch_ids = torch.arange(B, device=dev, dtype=torch.float32) \
        .repeat_interleave(post_n)
    rois = torch.cat([batch_ids[:, None], out_boxes.reshape(B * post_n, 4)],
                     dim=1)
    return rois, out_scores.reshape(B * post_n, 1)
