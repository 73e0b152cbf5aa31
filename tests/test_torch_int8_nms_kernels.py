"""The layouts and the algorithms of ``kernels/int8_conv.cu`` and
``kernels/nms.cu``, modelled in torch on the CPU (the card runs the
kernels themselves: tests/test_torch_kernels.py and chip_smoke.py).

int8_conv: the wrapper's weight rows (``int8_conv_weight_rows``: (F, KH,
KW, Cg16), channels zero-padded to 16) and the layout pass's plain
version (``int8_conv_nhwc_plain``) gathered piece by piece as the kernel
walks its depth (16-byte runs of (ky, kx, 16 channels), 8 a stage, the
carry into kx and ky), as an int64 GEMM, equal to ``int8_conv_plain``:
conv1_1's 3 channels, groups whose width is not a multiple of 16,
stride, padding and dilation 2, a depth tail and a fully connected layer.

nms: the two-phase bitmask NMS (the IoU mask of 64-bit words, then the
walk over 64-box chunks, resolving each chunk's keep bits from its
diagonal words and OR-ing the kept rows into the later words, in passes
over row ranges at a small workspace cap), equal to ``nms_plain`` on
random boxes with duplicates, at ties on the threshold, class-aware and
with the +1 pixel IoU, and to the JAX package's ``box_nms``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import registry as jreg

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.ops import quantization as quant
from mxnet_tpu_torch.ops import ssd
from mxnet_tpu_torch.ops.contrib_ops import box_iou

PIECES = 8          # 16-byte pieces of one stage (128 bytes of depth)
WORD = 64           # boxes a mask word


# ---------------------------------------------------------------------------
# int8_conv
# ---------------------------------------------------------------------------

def _int8(shape, rng):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


def _pieces(KH, KW, cpk):
    """(ky, kx, cc) of every 16-byte piece q = stage * 8 + j, in the order
    the kernel reaches them: piece j's tap first, then 8 further a stage
    with the carry of cc into kx and ky."""
    kq = KH * KW * cpk
    out = {}
    for j in range(PIECES):
        ky, kx, cc = 0, 0, j
        while cc >= cpk and ky < KH:
            cc -= cpk
            kx += 1
            if kx == KW:
                kx, ky = 0, ky + 1
        q = j
        while q < kq:
            out[q] = (ky, kx, cc)
            q += PIECES
            cc += PIECES
            while cc >= cpk and ky < KH:
                cc -= cpk
                kx += 1
                if kx == KW:
                    kx, ky = 0, ky + 1
    return [out[q] for q in range(kq)]


def _kernel_order_gemm(x, w, stride, pad, dilate, groups):
    """int8_conv.cu's arithmetic: the NHWC data gathered a 16-byte piece at
    a time against the weight rows, per group, summed in int64."""
    N, C, H, W = x.shape
    F, Cg, KH, KW = w.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, pad, dilate
    Ho = (H + 2 * ph - (dh * (KH - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (KW - 1) + 1)) // sw + 1
    cg16 = -(-Cg // 16) * 16
    nhwc = kernels.int8_conv_nhwc_plain(x, groups).to(torch.int64)
    rows = kernels.int8_conv_weight_rows(w).to(torch.int64)
    assert nhwc.shape == (N, H, W, groups * cg16)
    assert rows.shape == (F, KH * KW * cg16)
    fg = F // groups
    oy = torch.arange(Ho).view(Ho, 1)
    ox = torch.arange(Wo).view(1, Wo)
    out = torch.zeros((N, F, Ho, Wo), dtype=torch.int64)
    for g in range(groups):
        a = []
        for q, (ky, kx, cc) in enumerate(_pieces(KH, KW, cg16 // 16)):
            iy = oy * sh - ph + ky * dh
            ix = ox * sw - pw + kx * dw
            inside = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            c0 = g * cg16 + cc * 16
            run = nhwc[:, iy.clamp(0, H - 1), ix.clamp(0, W - 1), c0:c0 + 16]
            a.append(run * inside[None, :, :, None])
        a = torch.cat(a, dim=3).reshape(N * Ho * Wo, -1)
        b = rows[g * fg:(g + 1) * fg]
        out[:, g * fg:(g + 1) * fg] = (a @ b.t()).reshape(N, Ho, Wo, fg) \
            .permute(0, 3, 1, 2)
    return out


INT8_LAYOUT_CASES = [      # (N, C, H, W, F, k, stride, pad, dilate, groups)
    (2, 3, 11, 9, 8, 3, 1, 1, 1, 1),        # conv1_1: 3 channels padded
    (2, 64, 7, 8, 70, 3, 1, 1, 1, 1),       # a depth tail (Kq 36)
    (2, 40, 9, 9, 6, 3, 2, 2, 2, 2),        # groups of 20, stride, dilation
    (1, 24, 6, 5, 9, 2, 1, 0, 1, 3),        # groups of 8, a 2x2 kernel
    (3, 40, 1, 1, 33, 1, 1, 0, 1, 1),       # a fully connected layer
    (2, 32, 5, 5, 4, 1, 1, 0, 1, 1),        # 1x1, already 16-aligned
]


@pytest.mark.parametrize("case", INT8_LAYOUT_CASES)
def test_int8_conv_kernel_order_gemm_equals_plain(case):
    N, C, H, W, F, k, s, p, d, g = case
    rng = np.random.RandomState(sum(case))
    x, w = _int8((N, C, H, W), rng), _int8((F, C // g, k, k), rng)
    args = ((s, s), (p, p), (d, d), g)
    got = _kernel_order_gemm(x, w, *args)
    want = quant.int8_conv_plain(x, w, *args)
    assert torch.equal(got, want.to(torch.int64))


def test_int8_conv_weight_rows_layout():
    """(F, KH, KW, Cg16) rows, zeros in the padded channels; a view of the
    weights for a 1x1 kernel of 16-aligned width."""
    w = _int8((5, 3, 2, 3), np.random.RandomState(0))
    rows = kernels.int8_conv_weight_rows(w).view(5, 2, 3, 16)
    assert torch.equal(rows[..., :3], w.permute(0, 2, 3, 1))
    assert not rows[..., 3:].any()
    w1 = _int8((7, 32, 1, 1), np.random.RandomState(1))
    assert kernels.int8_conv_weight_rows(w1).data_ptr() == w1.data_ptr()


def test_int8_conv_nhwc_plain_layout():
    x = _int8((2, 6, 3, 4), np.random.RandomState(2))
    y = kernels.int8_conv_nhwc_plain(x, 2)       # groups of 3 -> 16 each
    assert y.shape == (2, 3, 4, 32)
    assert torch.equal(y[..., 0:3], x[:, 0:3].permute(0, 2, 3, 1))
    assert torch.equal(y[..., 16:19], x[:, 3:6].permute(0, 2, 3, 1))
    assert not y[..., 3:16].any() and not y[..., 19:].any()


# ---------------------------------------------------------------------------
# nms
# ---------------------------------------------------------------------------

def _mask_words(boxes, ids, thresh, class_aware, inclusive, plus_one):
    """Phase 1: for each image, row i's words over the 64-box column
    blocks, bit j set where j > i, the class matches (class-aware) and the
    IoU (box i first, as the kernel and nms_plain take it) passes."""
    B, N = ids.shape
    iou = ssd.iou_plus_one(boxes, boxes) if plus_one else box_iou(boxes,
                                                                   boxes)
    hit = iou >= thresh if inclusive else iou > thresh
    idx = torch.arange(N)
    hit &= (idx[None, :] > idx[:, None])[None]
    if class_aware:
        hit &= ids[:, :, None] == ids[:, None, :]
    nb = -(-N // WORD)
    padded = torch.zeros((B, N, nb * WORD), dtype=torch.bool)
    padded[:, :, :N] = hit
    return [[[sum(1 << t for t in range(WORD) if bool(row[c * WORD + t]))
              for c in range(nb)] for row in img] for img in padded]


def bitmask_nms(boxes, ids, alive, thresh, class_aware, inclusive, plus_one):
    """The kernel's two phases: the mask, then for each row range of
    ``kernels.nms_rows_per_pass`` the walk over its 64-box chunks, the
    removed bits carried from one range to the next."""
    B, N = ids.shape
    nb = -(-N // WORD)
    full = (1 << WORD) - 1
    mask = _mask_words(boxes, ids, thresh, class_aware, inclusive, plus_one)
    removed = []
    for b in range(B):
        words = []
        for c in range(nb):
            dead = 0
            for t in range(WORD):
                i = c * WORD + t
                if i >= N or not bool(alive[b, i]):
                    dead |= 1 << t
            words.append(dead)
        removed.append(words)
    per_pass = kernels.nms_rows_per_pass(B, N)
    assert per_pass % WORD == 0
    for r0 in range(0, N, per_pass):
        r1 = min(N, r0 + per_pass)
        for b in range(B):
            for c in range(r0 // WORD, -(-r1 // WORD)):
                rem, kept = removed[b][c], 0
                todo = ~rem & full
                while todo:                      # only the kept boxes loop
                    t = (todo & -todo).bit_length() - 1
                    kept |= 1 << t
                    rem |= mask[b][c * WORD + t][c]
                    todo = ~rem & full & ~((2 << t) - 1)
                removed[b][c] = rem
                for w in range(c + 1, nb):
                    for t in range(WORD):
                        if kept >> t & 1:
                            removed[b][w] |= mask[b][c * WORD + t][w]
    return torch.tensor([[not (removed[b][i // WORD] >> (i % WORD) & 1)
                          for i in range(N)] for b in range(B)])


def _boxes(B, N, rng, scale=1.0):
    xy = rng.rand(B, N, 2) * 0.8
    wh = rng.rand(B, N, 2) * 0.3 + 0.02
    boxes = np.concatenate([xy, xy + wh], axis=2).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0::7][:, :boxes[:, 1::7].shape[1]]   # ties
    return torch.from_numpy(boxes * np.float32(scale))


@pytest.mark.parametrize("opts", [
    (0.5, True, True, False, None),         # MultiBoxDetection: >=, class
    (0.45, False, False, False, None),      # box_nms: >, any class
    (0.7, False, False, True, None),        # Proposal: >, +1 pixel IoU
    (0.5, True, True, False, 3 * 3 * 8 * 64),   # passes of 64 rows
    (0.3, False, False, False, 3 * 3 * 8 * 128),   # passes of 128 rows
])
def test_bitmask_walk_equals_plain(opts, monkeypatch):
    thresh, class_aware, inclusive, plus_one, cap = opts
    rng = np.random.RandomState(11)
    B, N = 3, 150
    boxes = _boxes(B, N, rng, 100.0 if plus_one else 1.0)
    ids = torch.from_numpy(rng.randint(0, 3, (B, N)).astype(np.float32))
    alive = torch.from_numpy(rng.rand(B, N) < 0.8)     # rows start part dead
    if cap is not None:
        monkeypatch.setattr(kernels, "NMS_WORKSPACE_BYTES", cap)
        assert kernels.nms_rows_per_pass(B, N) < N
    got = bitmask_nms(boxes, ids, alive, thresh, class_aware, inclusive,
                      plus_one)
    want = ssd.nms_plain(boxes, ids, alive, thresh, class_aware, inclusive,
                         plus_one)
    assert torch.equal(got, want)


@pytest.mark.parametrize("inclusive", [True, False])
def test_bitmask_walk_at_the_threshold(inclusive):
    """Identical boxes have an IoU of exactly 1.0: suppressed under >= 1.0,
    kept under > 1.0, across a chunk boundary too."""
    box = [0.1, 0.2, 0.5, 0.7]
    boxes = torch.tensor([[box] * 70])
    ids = torch.zeros((1, 70))
    alive = torch.ones((1, 70), dtype=torch.bool)
    got = bitmask_nms(boxes, ids, alive, 1.0, False, inclusive, False)
    want = ssd.nms_plain(boxes, ids, alive, 1.0, False, inclusive, False)
    assert torch.equal(got, want)
    assert int(got.sum()) == (1 if inclusive else 70)


def test_nms_rows_per_pass(monkeypatch):
    assert kernels.nms_rows_per_pass(1, 27976) == 438 * 64   # 98 MB, one
    monkeypatch.setattr(kernels, "NMS_WORKSPACE_BYTES", 16 << 20)
    assert kernels.nms_rows_per_pass(1, 27976) == 4736
    monkeypatch.setattr(kernels, "NMS_WORKSPACE_BYTES", 8)
    assert kernels.nms_rows_per_pass(2, 100) == 64            # at least 64


def test_bitmask_walk_equals_jax_box_nms():
    """The JAX package's box_nms on score-sorted rows (id, score, corners):
    its kept rows are the walk's keep mask over the rows above
    valid_thresh."""
    rng = np.random.RandomState(5)
    B, N = 2, 130
    boxes = _boxes(B, N, rng)
    scores = np.sort(rng.rand(B, N).astype(np.float32), axis=1)[:, ::-1]
    ids = rng.randint(0, 3, (B, N)).astype(np.float32)
    data = np.concatenate([ids[..., None], scores[..., None],
                           boxes.numpy()], axis=2)
    for force in (False, True):
        out = np.asarray(jreg.get_op("_contrib_box_nms").fn(
            jnp.asarray(data), overlap_thresh=0.4, valid_thresh=0.1,
            id_index=0, force_suppress=force))
        want = torch.from_numpy(out[:, :, 1] != -1)
        alive = torch.from_numpy(np.ascontiguousarray(scores > 0.1))
        got = bitmask_nms(boxes, torch.from_numpy(ids), alive, 0.4,
                          not force, False, False)
        assert torch.equal(got, want)
