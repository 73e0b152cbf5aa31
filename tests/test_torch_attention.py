"""Flash attention: the port (mxnet_tpu_torch.ops.attention, its plain
version on the CPU) against the JAX package's Pallas kernel
(mxnet_tpu.ops.attention_pallas, interpret mode on the CPU), from the same
numpy inputs.  The cases mirror tests/test_flash_attention.py; JAX is
pinned to float32 matmuls and torch to "highest", so both sides compute
in full f32 and the JAX suite's bounds apply unchanged: 5e-5 on f32
outputs and lse, 5e-4 on gradients, 3e-2 on bf16 outputs."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import attention_pallas as jattn
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.ops import attention as tattn
from mxnet_tpu_torch.parallel import local_attention


@pytest.fixture(autouse=True)
def _highest_precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _qkv(B=2, T=256, H=2, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))


def _jax(arrs, dtype=jnp.float32):
    return tuple(jnp.asarray(a).astype(dtype) for a in arrs)


def _torch(arrs, dtype=torch.float32, grad=False):
    return tuple(torch.tensor(a, dtype=dtype, requires_grad=grad)
                 for a in arrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
def test_flash_matches_jax_kernel(causal):
    arrs = _qkv()
    o_j, lse_j = jattn.flash_attention_with_lse(*_jax(arrs), causal=causal)
    o_t, lse_t = tattn.flash_attention_with_lse(*_torch(arrs), causal=causal)
    assert o_t.dtype == torch.float32 and lse_t.dtype == torch.float32
    assert o_t.shape == (2, 256, 2, 64) and lse_t.shape == (2, 256, 2)
    assert np.abs(_np(o_t) - _np(o_j)).max() < 5e-5
    assert np.abs(_np(lse_t) - _np(lse_j)).max() < 5e-5
    ref = local_attention(*_torch(arrs), causal=causal)
    assert (o_t - ref).abs().max().item() < 5e-5


def test_flash_uneven_blocks():
    arrs = _qkv()
    o_j = jattn.flash_attention(*_jax(arrs), blk_q=128, blk_k=64)
    o_t = tattn.flash_attention(*_torch(arrs), blk_q=128, blk_k=64)
    assert np.abs(_np(o_t) - _np(o_j)).max() < 5e-5


def test_flash_lse_matches_jax_logsumexp():
    arrs = _qkv(B=1, T=128, H=1, D=64)
    q, k, _ = _jax(arrs)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (64 ** -0.5)
    ref = jnp.swapaxes(jax.nn.logsumexp(s, axis=-1), 1, 2)
    _, lse_t = tattn.flash_attention_with_lse(*_torch(arrs))
    assert np.abs(_np(lse_t) - _np(ref)).max() < 5e-5


def test_flash_bf16_io():
    arrs = _qkv(B=1, T=128, H=1)
    o_j = jattn.flash_attention(*_jax(arrs, jnp.bfloat16))
    o_t = tattn.flash_attention(*_torch(arrs, torch.bfloat16))
    assert o_t.dtype == torch.bfloat16
    ref = local_attention(*(t.float() for t in _torch(arrs, torch.bfloat16)))
    assert (o_t.float() - ref).abs().max().item() < 3e-2
    assert np.abs(_np(o_t) - _np(o_j)).max() < 3e-2


def test_flash_rejects_ragged_seq():
    arrs = _qkv(T=192)
    with pytest.raises(ValueError, match="multiples"):
        jattn.flash_attention(*_jax(arrs), blk_q=128, blk_k=128)
    with pytest.raises(ValueError, match="multiples"):
        tattn.flash_attention(*_torch(arrs), blk_q=128, blk_k=128)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradients_match_jax(causal):
    """dq, dk, dv of a loss on both o and lse: the JAX custom_vjp against
    the port's autograd.Function."""
    arrs = _qkv(B=1, T=128, H=2, D=64, seed=3)
    rng = np.random.RandomState(4)
    w_o = rng.randn(1, 128, 2, 64).astype(np.float32)
    w_l = rng.randn(1, 128, 2).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jattn.flash_attention_with_lse(q, k, v, causal=causal)
        return (o * w_o).sum() + (lse * w_l).sum()

    grads_j = jax.grad(jloss, argnums=(0, 1, 2))(*_jax(arrs))
    q, k, v = _torch(arrs, grad=True)
    o, lse = tattn.flash_attention_with_lse(q, k, v, causal=causal)
    ((o * torch.from_numpy(w_o)).sum()
     + (lse * torch.from_numpy(w_l)).sum()).backward()
    for g_t, g_j in zip((q.grad, k.grad, v.grad), grads_j):
        assert np.abs(_np(g_t) - _np(g_j)).max() < 5e-4


def test_flash_cpu_path_launches_no_kernel():
    kernels.reset_launch_counts()
    arrs = _qkv(B=1, T=64, H=1, D=16)
    tattn.flash_attention(*_torch(arrs))
    tattn.flash_attention(*_torch(arrs, torch.bfloat16))
    assert kernels.launch_counts["flash_attention"] == 0
    assert kernels.launch_counts["flash_attention_bf16"] == 0


def _emulate_bf16_kernel(q, k, v, scale, causal, drop_tile=None,
                         scale_twice=False, tile=64):
    """The bf16 tensor-core kernel's arithmetic in plain torch on (B, T, H,
    D) bf16 q, k, v: f32 scores of the bf16 values, scaled after the
    product; per 64-key tile an online-softmax update with l summed from
    the f32 probabilities P and only the copy of P that feeds P.V rounded
    to bf16; o = acc / max(l, 1e-30) rounded to bf16, lse in f32.
    ``drop_tile`` and ``scale_twice`` break it on purpose."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    Tq, Tk = qf.shape[2], kf.shape[2]
    m = torch.full(qf.shape[:3] + (1,), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j, k0 in enumerate(range(0, Tk, tile)):
        if j == drop_tile:
            continue
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) * scale
        if scale_twice:
            s = s * scale
        if causal:
            keep = (torch.arange(Tq)[:, None]
                    >= torch.arange(k0, min(k0 + tile, Tk))[None, :])
            s = torch.where(keep, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    l_safe = l.clamp_min(1e-30)
    o = (acc / l_safe).bfloat16().transpose(1, 2)
    return o, (m + torch.log(l_safe))[..., 0].transpose(1, 2)


def _bf16_share(o, q, k, v, scale, causal):
    """Worst share of the bf16 kernel's elementwise bound, and |dlse|.

    The kernel rounds each P to bf16 before P.V (relative error at most
    2^-8) and sums l from the f32 P, so before its last rounding o is off
    by at most 2^-8 (P/l).|V| = 2^-8 obar, obar being the plain version
    run on |V|; rounding o to bf16 adds at most 2^-8 |o|.  Hence
    |o - o_plain| <= 2^-8 (|o_plain| + obar) + 5e-5, where 5e-5 (the f32
    bound) covers the f32 arithmetic and the second-order 2^-16 obar."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    ro, rlse = tattn._ref_attention_lse(qf, kf, torch.cat([vf, vf.abs()], -1),
                                        scale, causal)
    ro, obar = ro.transpose(1, 2).chunk(2, dim=-1)
    share = ((o.float() - ro).abs()
             / (2.0 ** -8 * (ro.abs() + obar) + 5e-5)).max().item()
    return share, rlse.transpose(1, 2)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_kernel_rounding_within_bound(causal):
    """The bf16 kernel's rounding, emulated on the CPU, holds to its bound
    of the f32 plain version (lse within 1e-4) and to the JAX suite's 3e-2
    of the JAX package's kernel (interpret mode) on the same bf16 values."""
    arrs = _qkv(B=2, T=256, H=2, D=64, seed=5)
    q, k, v = _torch(arrs, torch.bfloat16)
    o, lse = _emulate_bf16_kernel(q, k, v, 64 ** -0.5, causal)
    share, rlse = _bf16_share(o, q, k, v, 64 ** -0.5, causal)
    assert share <= 1.0, share
    assert (lse - rlse).abs().max().item() <= 1e-4
    o_j = jattn.flash_attention(*_jax(arrs, jnp.bfloat16), causal=causal)
    assert np.abs(_np(o) - _np(o_j)).max() < 3e-2


@pytest.mark.parametrize("fault", ["drop_tile", "scale_twice"])
def test_bf16_bound_catches_wrong_kernel(fault):
    """The bound has teeth: the same emulation with one K tile dropped, or
    with the scale applied twice, fails it."""
    q, k, v = _torch(_qkv(B=2, T=256, H=2, D=64, seed=5), torch.bfloat16)
    broken = {"drop_tile": {"drop_tile": 2},
              "scale_twice": {"scale_twice": True}}[fault]
    o, _ = _emulate_bf16_kernel(q, k, v, 64 ** -0.5, False, **broken)
    share, _ = _bf16_share(o, q, k, v, 64 ** -0.5, False)
    assert share > 1.0, share


@pytest.mark.parametrize("causal", [False, True])
def test_flash_wide_head_matches_jax_kernel(causal):
    """Head dims above 256 (which the CUDA side runs on the wide variant
    of the f32 kernel): the port against the JAX package's kernel."""
    arrs = _qkv(B=1, T=128, H=2, D=320, seed=6)
    o_j, lse_j = jattn.flash_attention_with_lse(*_jax(arrs), causal=causal)
    o_t, lse_t = tattn.flash_attention_with_lse(*_torch(arrs), causal=causal)
    assert o_t.shape == (1, 128, 2, 320) and lse_t.shape == (1, 128, 2)
    assert np.abs(_np(o_t) - _np(o_j)).max() < 5e-5
    assert np.abs(_np(lse_t) - _np(lse_j)).max() < 5e-5


def _f32_kernel_tiles(D):
    """flash_attention.cu's tiles at head dim D: (query rows, keys, Q/K
    head-dim chunk, o head-dim slice).  Up to D 256 one narrow template
    per DP (D rounded up to 16, 32, 64, 128 or 256), one chunk and one
    slice; above, the wide variant."""
    if D > 256:
        return 64, 32, 64, 256
    dp = next(p for p in (16, 32, 64, 128, 256) if D <= p)
    return {128: (64, 32), 256: (32, 32)}.get(dp, (128, 64)) + (dp, dp)


def _emulate_f32_kernel(q, k, v, scale, causal, drop_tile=None,
                        drop_slice=None):
    """flash_attention.cu's decomposition in plain torch on (B, T, H, D):
    per query tile and per slice of o's head dims, the key tiles in order
    (those wholly above the diagonal skipped under ``causal``); the scores
    over the full D, summed over head-dim chunks of q * scale and k;
    masked scores -1e30; the online-softmax update; o = acc / max(l,
    1e-30) on the slice's head dims and lse = m + log(max(l, 1e-30)) from
    slice 0 only.  ``drop_tile`` and ``drop_slice`` break it on purpose."""
    bq, bk, dc, dv = _f32_kernel_tiles(q.shape[-1])
    qs = q.float().transpose(1, 2) * scale
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))
    (B, H, Tq, D), Tk = qs.shape, kf.shape[2]
    o = torch.zeros(B, H, Tq, D)
    lse = torch.zeros(B, H, Tq)
    for q0 in range(0, Tq, bq):
        rows = torch.arange(q0, min(q0 + bq, Tq))
        n_live = -(-Tk // bk)
        if causal:
            n_live = min(n_live, int(rows[-1]) // bk + 1)
        for sl, d0 in enumerate(range(0, D, dv)):
            if sl == drop_slice:
                continue
            m = torch.full((B, H, len(rows), 1), -1e30)
            l = torch.zeros_like(m)
            acc = torch.zeros(B, H, len(rows), min(dv, D - d0))
            for j in range(n_live):
                if j == drop_tile:
                    continue
                keys = torch.arange(j * bk, min(j * bk + bk, Tk))
                s = sum(qs[:, :, rows, c0:c0 + dc]
                        @ kf[:, :, keys, c0:c0 + dc].transpose(-1, -2)
                        for c0 in range(0, D, dc))
                if causal:
                    s = torch.where(rows[:, None] >= keys[None, :], s, -1e30)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p @ vf[:, :, keys, d0:d0 + dv]
                m = m_new
            l_safe = l.clamp_min(1e-30)
            o[:, :, rows, d0:d0 + dv] = acc / l_safe
            if sl == 0:
                lse[:, :, rows] = (m + torch.log(l_safe))[..., 0]
    return o.transpose(1, 2), lse.transpose(1, 2)


@pytest.mark.parametrize("D,causal", [(64, False), (320, True)])
def test_f32_kernel_decomposition_matches_jax_kernel(D, causal):
    """The f32 kernel's tiles, head-dim chunks and slices, emulated on the
    CPU, hold to the JAX package's kernel (interpret mode) within 5e-5:
    the narrow template at D 64 (one chunk, one slice), the wide variant at
    D 320 (5 chunks of 64, slices of 256 and 64, lse from slice 0)."""
    arrs = _qkv(B=1, T=192, H=2, D=D, seed=7)
    o_j, lse_j = jattn.flash_attention_with_lse(*_jax(arrs), causal=causal,
                                                blk_q=64, blk_k=64)
    o, lse = _emulate_f32_kernel(*_torch(arrs), D ** -0.5, causal)
    assert np.abs(_np(o) - _np(o_j)).max() < 5e-5
    assert np.abs(_np(lse) - _np(lse_j)).max() < 5e-5


@pytest.mark.parametrize("fault", ["drop_tile", "drop_slice"])
def test_f32_decomposition_check_catches_wrong_kernel(fault):
    """The check has teeth: the same emulation at D 320 with one key tile
    or one head-dim slice left out is far outside 5e-5 of the plain
    version."""
    q, k, v = _torch(_qkv(B=1, T=192, H=2, D=320, seed=7))
    o, lse = _emulate_f32_kernel(q, k, v, 320 ** -0.5, False, **{fault: 1})
    ro = local_attention(q, k, v)
    assert (o - ro).abs().max().item() > 1e-2
