"""The port's detection ops held against the JAX package's on the CPU:
the 15 cases of tests/test_ssd_ops.py replayed through both packages'
``mx.nd.contrib`` (and one bound symbol), each with its own assertions on
the port's result; then seeded random cases of MultiBoxTarget (B 3, 200
anchors, M 4 with padding rows, mining on and off), MultiBoxDetection
(NMS on, off and forced, nms_topk), box_nms and Proposal (per-image
scales).  Ids, class targets and keep masks exact; floats within 1e-5
(absolute, or relative to the coordinate for Proposal's pixel boxes)."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import ssd

TOL = 1e-5


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")


def _outs(res):
    return [o.asnumpy() for o in (res if isinstance(res, (list, tuple))
                                  else [res])]


def both(op, *ins, **attrs):
    """``op`` of mx.nd.contrib in both packages on the same numpy inputs:
    the port's outputs (numpy), after holding them to JAX's."""
    j = _outs(getattr(jmx.nd.contrib, op)(
        *[jmx.nd.array(np.asarray(x)) for x in ins], **attrs))
    t = _outs(getattr(tmx.nd.contrib, op)(
        *[tmx.nd.array(np.asarray(x), ctx=tmx.cpu()) for x in ins],
        **attrs))
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a.shape == b.shape and a.dtype == b.dtype, (op, a.shape,
                                                           b.shape)
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, err_msg=op)
    return t


# ---------------------------------------------------------------------------
# tests/test_ssd_ops.py, replayed
# ---------------------------------------------------------------------------


def test_multibox_target_basic():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]]],
                       np.float32)
    label = np.array([[[0.0, 0.1, 0.1, 0.5, 0.5]]], np.float32)
    loc_t, loc_mask, cls_t = both("MultiBoxTarget", anchors, label,
                                  np.zeros((1, 2, 2), np.float32))
    assert cls_t.shape == (1, 2)
    assert cls_t[0, 0] == 1.0 and cls_t[0, 1] == 0.0
    np.testing.assert_array_equal(loc_mask.reshape(2, 4)[0], 1)
    np.testing.assert_array_equal(loc_mask.reshape(2, 4)[1], 0)
    np.testing.assert_allclose(loc_t.reshape(2, 4)[0], np.zeros(4),
                               atol=1e-5)


def test_multibox_target_encoding():
    loc_t, _, cls_t = both(
        "MultiBoxTarget", np.array([[[0.0, 0.0, 0.4, 0.4]]], np.float32),
        np.array([[[2.0, 0.1, 0.1, 0.5, 0.5]]], np.float32),
        np.zeros((1, 3, 1), np.float32))
    assert cls_t[0, 0] == 3.0
    np.testing.assert_allclose(loc_t.reshape(4), [2.5, 2.5, 0.0, 0.0],
                               atol=1e-5)


def test_multibox_target_negative_mining():
    rng = np.random.RandomState(0)
    anchors = rng.rand(1, 20, 4).astype(np.float32) * 0.01
    anchors[0, 0] = [0.5, 0.5, 0.9, 0.9]
    label = np.array([[[0.0, 0.5, 0.5, 0.9, 0.9]]], np.float32)
    _, _, ct = both("MultiBoxTarget", anchors, label,
                    rng.randn(1, 3, 20).astype(np.float32),
                    negative_mining_ratio=2.0, negative_mining_thresh=0.5)
    assert (ct > 0).sum() == 1 and (ct == 0).sum() == 2 and \
        (ct == -1).sum() == 17


def test_multibox_detection_roundtrip():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.5, 0.5, 0.9, 0.9]]],
                       np.float32)
    cls_prob = np.array([[[0.1, 0.8], [0.9, 0.1], [0.0, 0.1]]], np.float32)
    res = both("MultiBoxDetection", cls_prob, np.zeros((1, 8), np.float32),
               anchors, threshold=0.2)[0][0]
    kept = res[res[:, 0] >= 0]
    assert len(kept) == 1
    np.testing.assert_allclose(kept[0, :2], [0.0, 0.9], atol=1e-6)
    np.testing.assert_allclose(kept[0, 2:], [0.1, 0.1, 0.5, 0.5], atol=1e-5)


def test_multibox_detection_nms():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.12, 0.12, 0.52, 0.52]]],
                       np.float32)
    cls_prob = np.array([[[0.1, 0.2], [0.9, 0.8]]], np.float32)
    res = both("MultiBoxDetection", cls_prob, np.zeros((1, 8), np.float32),
               anchors, nms_threshold=0.5)[0][0]
    kept = res[res[:, 0] >= 0]
    assert len(kept) == 1 and abs(kept[0, 1] - 0.9) < 1e-6


def test_proposal_shapes_and_validity():
    B, A, H, W = 1, 12, 8, 8
    rng = np.random.RandomState(0)
    cls_prob = rng.rand(B, 2 * A, H, W).astype(np.float32)
    bbox = ((rng.rand(B, 4 * A, H, W) - 0.5) * 0.1).astype(np.float32)
    info = np.array([[128, 128, 1.0]], np.float32)
    r = both("Proposal", cls_prob, bbox, info, rpn_pre_nms_top_n=200,
             rpn_post_nms_top_n=50)[0]
    assert r.shape == (50, 5) and (r[:, 0] == 0).all()
    assert (r[:, 1] <= r[:, 3]).all() and (r[:, 2] <= r[:, 4]).all()
    assert (r[:, 1:] >= 0).all() and (r[:, [1, 3]] <= 127).all()


def test_proposal_output_score():
    rng = np.random.RandomState(1)
    cls_prob = rng.rand(1, 2, 4, 4).astype(np.float32)
    rois, scores = both("Proposal", cls_prob,
                        np.zeros((1, 4, 4, 4), np.float32),
                        np.array([[64, 64, 1.0]], np.float32), scales=(8,),
                        ratios=(1.0,), rpn_post_nms_top_n=10,
                        output_score=True)
    assert rois.shape == (10, 5) and scores.shape == (10, 1)
    assert (np.diff(scores.ravel()[:3]) <= 1e-6).all()


def test_multibox_target_in_symbol():
    vals = {"a": np.array([[[0.1, 0.1, 0.5, 0.5]]], np.float32),
            "l": np.array([[[1.0, 0.1, 0.1, 0.5, 0.5]]], np.float32),
            "c": np.zeros((1, 3, 1), np.float32)}
    res = {}
    for pkg, ctx in ((jmx, None), (tmx, tmx.cpu())):
        outs = pkg.sym.contrib.MultiBoxTarget(pkg.sym.var("a"),
                                              pkg.sym.var("l"),
                                              pkg.sym.var("c"))
        args = {k: pkg.nd.array(v) if ctx is None else
                pkg.nd.array(v, ctx=ctx) for k, v in vals.items()}
        ex = outs.bind(args=args) if ctx is None else \
            outs.bind(ctx=ctx, args=args)
        res[pkg] = [o.asnumpy() for o in ex.forward()]
    for a, b in zip(res[jmx], res[tmx]):
        np.testing.assert_allclose(b, a, atol=TOL)
    assert res[tmx][2][0, 0] == 2.0


def test_multibox_detection_nms_disabled():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]]],
                       np.float32)
    cls_prob = np.array([[[0.1, 0.2], [0.9, 0.8]]], np.float32)
    out = both("MultiBoxDetection", cls_prob, np.zeros((1, 8), np.float32),
               anchors, nms_threshold=-1.0)[0][0]
    assert (out[:, 0] >= 0).sum() == 2


def test_proposal_min_size_filter_expands():
    rng = np.random.RandomState(3)
    rois, sc = both("Proposal", rng.rand(1, 18, 4, 4).astype(np.float32),
                    np.zeros((1, 36, 4, 4), np.float32),
                    np.array([[40.0, 40.0, 100.0]], np.float32),
                    rpn_pre_nms_top_n=20, rpn_post_nms_top_n=5,
                    scales=(4, 8, 16), rpn_min_size=16, output_score=True)
    assert np.all(sc == -1)
    assert not np.all(rois[:, 1:] == 0)


def test_multibox_target_inside_compiled_graph():
    """The JAX test runs the op under jax.jit; the port's runs it under
    torch.compile(fullgraph=True) (aot_eager here)."""
    rng = np.random.RandomState(4)
    anchors = rng.rand(1, 8, 4).astype(np.float32)
    label = np.array([[[0.0, 0.1, 0.1, 0.5, 0.5]]], np.float32)
    cls_pred = np.zeros((1, 2, 8), np.float32)
    args = (0.5, -1.0, -1.0, 0.5, 0, (0.1, 0.1, 0.2, 0.2))
    fn = torch.compile(lambda a, l, c: ssd.multibox_target(a, l, c, *args),
                       backend="aot_eager", fullgraph=True)
    got = fn(*(torch.from_numpy(x) for x in (anchors, label, cls_pred)))
    from mxnet_tpu.ops.ssd_jax import multibox_target_jax

    want = jax.jit(lambda a, l, c: multibox_target_jax(a, l, c, *args))(
        anchors, label, cls_pred)
    assert got[2].shape == (1, 8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_multibox_detection_nms_at_exact_threshold():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.1, 0.1, 0.5, 0.5]]],
                       np.float32)
    cls_prob = np.array([[[0.1, 0.1], [0.9, 0.8]]], np.float32)
    out = both("MultiBoxDetection", cls_prob, np.zeros((1, 8), np.float32),
               anchors, nms_threshold=1.0)[0][0]
    assert (out[:, 0] >= 0).sum() == 1


def test_multibox_detection_disabled_nms_keeps_anchor_order():
    anchors = np.array([[[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.9, 0.9]]],
                       np.float32)
    cls_prob = np.array([[[0.1, 0.1], [0.3, 0.8]]], np.float32)
    out = both("MultiBoxDetection", cls_prob, np.zeros((1, 8), np.float32),
               anchors, nms_threshold=-1.0)[0][0]
    assert abs(out[0, 1] - 0.3) < 1e-6 and abs(out[1, 1] - 0.8) < 1e-6


def test_multibox_detection_suppressed_rows_stay_in_slot():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.12, 0.12, 0.52, 0.52]]],
                       np.float32)
    cls_prob = np.array([[[0.1, 0.2], [0.9, 0.8]]], np.float32)
    out = both("MultiBoxDetection", cls_prob, np.zeros((1, 8), np.float32),
               anchors, nms_threshold=0.5)[0][0]
    assert out[0, 0] == 0 and abs(out[0, 1] - 0.9) < 1e-6
    assert out[1, 0] == -1 and abs(out[1, 1] - 0.8) < 1e-6
    np.testing.assert_allclose(out[1, 2:], [0.12, 0.12, 0.52, 0.52],
                               atol=1e-5)


def test_multibox_target_mining_excludes_high_iou_when_threshold_off():
    anchors = np.array([[[0.1, 0.1, 0.5, 0.5], [0.11, 0.11, 0.51, 0.51],
                         [0.6, 0.6, 0.9, 0.9]]], np.float32)
    label = np.array([[[0.0, 0.1, 0.1, 0.5, 0.5]]], np.float32)
    _, _, ct = both("MultiBoxTarget", anchors, label,
                    np.zeros((1, 2, 3), np.float32), overlap_threshold=0.0,
                    negative_mining_ratio=3.0, negative_mining_thresh=0.5)
    assert ct[0].tolist() == [1.0, -1.0, 0.0]


# ---------------------------------------------------------------------------
# seeded random cases
# ---------------------------------------------------------------------------


def _anchors(rng, n):
    xy = rng.rand(n, 2) * 0.8
    wh = rng.rand(n, 2) * 0.3 + 0.02
    return np.concatenate([xy, xy + wh], axis=1)[None].astype(np.float32)


def _labels(rng, B, M, C):
    lab = np.full((B, M, 5), -1, np.float32)
    for b in range(B):
        for m in range(M - b):          # image b has b padding rows
            xy = rng.rand(2) * 0.6
            wh = rng.rand(2) * 0.35 + 0.05
            lab[b, m] = [rng.randint(C), *xy, *(xy + wh)]
    return lab


@pytest.mark.parametrize("attrs", [
    {},
    {"negative_mining_ratio": 3.0},
    {"negative_mining_ratio": 2.0, "overlap_threshold": 0.0,
     "minimum_negative_samples": 5},
    {"overlap_threshold": 0.3, "ignore_label": -2.0,
     "variances": (0.2, 0.2, 0.1, 0.1)}])
def test_random_multibox_target_matches_jax(attrs):
    rng = np.random.RandomState(11)
    B, N, M, C = 3, 200, 4, 4
    loc_t, mask, cls_t = both("MultiBoxTarget", _anchors(rng, N),
                              _labels(rng, B, M, C),
                              rng.randn(B, C + 1, N).astype(np.float32),
                              **attrs)
    assert (cls_t > 0).any() and loc_t.shape == mask.shape == (B, 4 * N)


def _detection_inputs(seed, B=3, N=200, C=4):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, C + 1, N) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = rng.randn(B, 4 * N) * 0.3
    # duplicate anchors: exact IoU ties at the threshold
    anchors = _anchors(rng, N)
    anchors[0, 1::9] = anchors[0, 0::9][:anchors[0, 1::9].shape[0]]
    return prob.astype(np.float32), loc.astype(np.float32), anchors


@pytest.mark.parametrize("attrs", [
    {}, {"nms_threshold": -1.0}, {"nms_threshold": 1.0},
    {"force_suppress": True, "nms_topk": 50},
    {"nms_topk": 20, "threshold": 0.05, "clip": False},
    {"background_id": 2, "nms_threshold": 0.3}])
def test_random_multibox_detection_matches_jax(attrs):
    out = both("MultiBoxDetection", *_detection_inputs(12), **attrs)[0]
    assert out.shape == (3, 200, 6)


@pytest.mark.parametrize("attrs", [
    {}, {"id_index": 0}, {"id_index": 0, "force_suppress": True,
                          "valid_thresh": 0.3},
    {"in_format": "center", "overlap_thresh": 0.3},
    {"topk": 5, "background_id": 1, "out_format": "center"}])
def test_random_box_nms_matches_jax(attrs):
    """``topk``, ``background_id`` and ``out_format`` are not applied, in
    either package (ROADMAP Queue 3)."""
    rng = np.random.RandomState(13)
    B, N = 2, 60
    boxes = _anchors(rng, N)[0]
    data = np.concatenate([
        rng.randint(0, 3, (B, N, 1)), rng.rand(B, N, 1),
        np.repeat(boxes[None], B, 0)], axis=2).astype(np.float32)
    data[:, 5, 1] = data[:, 4, 1]                   # a score tie
    data[:, 1::5, 0] = data[:, 0::5, 0]             # duplicates: suppressed
    data[:, 1::5, 2:] = data[:, 0::5, 2:]
    out = both("box_nms", data, **attrs)[0]
    assert (out == -1).all(axis=2).any()


def test_box_nms_alias_names():
    rng = np.random.RandomState(14)
    data = np.concatenate([rng.rand(1, 20, 2),
                           _anchors(rng, 20)], axis=2).astype(np.float32)
    ref = both("box_nms", data)[0]
    for name in ("nms", "box_non_maximum_suppression"):
        np.testing.assert_array_equal(both(name, data)[0], ref)


@pytest.mark.parametrize("threshold", [0.7, 0.3])
def test_random_proposal_per_image_scale_matches_jax(threshold):
    """Two images with their own im_info scales: each filters at its own
    min_size * scale (the JAX package's deviation from proposal.cc,
    ROADMAP Queue 3)."""
    rng = np.random.RandomState(15)
    A, H, W = 12, 10, 12
    cls_prob = rng.rand(2, 2 * A, H, W).astype(np.float32)
    bbox = ((rng.rand(2, 4 * A, H, W) - 0.5) * 0.3).astype(np.float32)
    info = np.array([[160, 190, 1.0], [150, 170, 2.5]], np.float32)
    j = _outs(jmx.nd.contrib.Proposal(
        jmx.nd.array(cls_prob), jmx.nd.array(bbox), jmx.nd.array(info),
        rpn_pre_nms_top_n=300, rpn_post_nms_top_n=80, threshold=threshold,
        output_score=True))
    t = _outs(tmx.nd.contrib.MultiProposal(
        *(tmx.nd.array(x, ctx=tmx.cpu()) for x in (cls_prob, bbox, info)),
        rpn_pre_nms_top_n=300, rpn_post_nms_top_n=80, threshold=threshold,
        output_score=True))
    np.testing.assert_allclose(t[0], j[0], rtol=TOL, atol=TOL * 200)
    np.testing.assert_array_equal(t[1], j[1])
    assert t[0].shape == (160, 5) and (t[0][80:, 0] == 1).all()


def test_nms_plain_is_the_custom_op_on_the_cpu():
    """The custom op's CPU implementation is nms_plain, and on a CPU
    tensor no kernel launches."""
    from mxnet_tpu_torch import kernels

    rng = np.random.RandomState(16)
    boxes = torch.from_numpy(_anchors(rng, 50).repeat(2, 0))
    ids = torch.from_numpy(rng.randint(0, 2, (2, 50)).astype(np.float32))
    alive = torch.from_numpy(rng.rand(2, 50) < 0.8)
    before = dict(kernels.launch_counts)
    for opts in ((0.4, True, True, False), (0.4, False, False, True)):
        got = ssd.nms_keep(boxes, ids, alive, opts[0], *opts[1:])
        want = ssd.nms_plain(boxes, ids, alive, *opts)
        assert torch.equal(got, want)
    assert kernels.launch_counts == before
