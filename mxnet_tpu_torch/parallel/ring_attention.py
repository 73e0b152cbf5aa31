"""Ring attention: sequence parallelism over a mesh axis (counterpart of
``mxnet_tpu/parallel/ring_attention.py``).

The sequence axis is sharded across the ranks of a mesh axis; K/V blocks
rotate around the ring with ``collectives.ppermute`` (one hop per step)
and a running max/denominator keeps the softmax exact (online-softmax
accumulation).  Memory per device is O(seq/devices).

Usage: ``ring_attention(q, k, v, axis_name='sp')`` inside
``parallel.shard_map`` over a mesh with an 'sp' axis, or
``ring_attention_sharded(mesh, q, k, v)``.
"""
from __future__ import annotations

import functools

import torch

from . import collectives
from .mesh import P, require_axes, shard_map

__all__ = ["ring_attention", "ring_attention_sharded", "local_attention"]


def _block_attn(q, k, v, scale, causal_mask=None):
    s = torch.einsum("...qhd,...khd->...hqk", q, k) * scale
    if causal_mask is not None:
        s = torch.where(causal_mask, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("...hqk,...khd->...qhd", p, v)
    return o, m, l


def ring_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                   use_flash=False, blk_q=128, blk_k=128):
    """Exact attention over a sequence sharded along `axis_name`.

    q, k, v: (batch, seq_local, heads, dim) per-rank blocks.  Must be
    called inside shard_map with `axis_name` bound.

    use_flash=True computes each local block with the flash-attention
    op (ops/attention.py: the CUDA kernel on the card) and merges blocks
    by logsumexp.  Non-causal only: block-level causality needs a static
    diagonal position, which the rotating ring does not give the kernel.
    """
    if use_flash:
        if causal:
            raise NotImplementedError(
                "ring_attention(use_flash=True) supports non-causal "
                "attention only")
        return _ring_attention_flash(q, k, v, axis_name, scale, blk_q, blk_k)

    n_dev = collectives.axis_size(axis_name)
    my_idx = collectives.axis_index(axis_name)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    seq_local = q.shape[1]

    def make_mask(kv_idx):
        if not causal:
            return None
        pos = torch.arange(seq_local, device=q.device)
        q_pos = my_idx * seq_local + pos
        k_pos = kv_idx * seq_local + pos
        # (1, h=1, q, k) broadcastable mask
        return (q_pos[:, None] >= k_pos[None, :])[None, None, :, :]

    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    m_acc = torch.full(q.shape[:1] + (q.shape[2], q.shape[1], 1), -1e30,
                       dtype=q.dtype, device=q.device)  # (b, h, q, 1)
    o_acc = torch.zeros_like(q)
    l_acc = torch.zeros_like(m_acc)
    k_blk, v_blk, kv_idx = k, v, my_idx
    for step in range(n_dev):
        o_blk, m_blk, l_blk = _block_attn(q, k_blk, v_blk, scale,
                                          make_mask(kv_idx))
        # online-softmax merge: rescale accumulators to the new max
        m_new = torch.maximum(m_acc, m_blk)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m_blk - m_new)
        # o_blk is unnormalized with max m_blk; o_acc with m_acc
        l_acc = l_acc * alpha + l_blk * beta
        o_acc = (o_acc * torch.movedim(alpha, -3, -2)
                 + o_blk * torch.movedim(beta, -3, -2))
        m_acc = m_new
        if step + 1 < n_dev:  # the last rotation's blocks are never read
            k_blk = collectives.ppermute(k_blk, axis_name, perm)
            v_blk = collectives.ppermute(v_blk, axis_name, perm)
        kv_idx = (kv_idx - 1) % n_dev
    return o_acc / torch.movedim(l_acc, -3, -2)


def _ring_attention_flash(q, k, v, axis_name, scale, blk_q, blk_k):
    """Ring body with the flash op as the per-block engine: each rank
    holds normalized (o, lse) and merges rotated blocks by logsumexp
    weights."""
    from ..ops.attention import flash_attention_with_lse

    n_dev = collectives.axis_size(axis_name)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    # accumulate in f32, as the JAX package does for bf16 inputs
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full(q.shape[:3], -float("inf"), dtype=torch.float32,
                         device=q.device)  # (b, t, h)
    k_blk, v_blk = k, v
    for step in range(n_dev):
        o_blk, lse_blk = flash_attention_with_lse(q, k_blk, v_blk,
                                                  scale=scale, blk_q=blk_q,
                                                  blk_k=blk_k)
        lse_new = torch.logaddexp(lse_acc, lse_blk)
        w_acc = torch.exp(lse_acc - lse_new)[..., None]
        w_blk = torch.exp(lse_blk - lse_new)[..., None]
        o_acc = o_acc * w_acc + o_blk.float() * w_blk
        lse_acc = lse_new
        if step + 1 < n_dev:
            k_blk = collectives.ppermute(k_blk, axis_name, perm)
            v_blk = collectives.ppermute(v_blk, axis_name, perm)
    return o_acc.to(q.dtype)


def local_attention(q, k, v, causal=False, scale=None):
    """Single-device reference attention (same layout) for testing."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    mask = None
    if causal:
        T = q.shape[1]
        mask = (torch.arange(T, device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :]
                )[None, None, :, :]
    o, m, l = _block_attn(q, k, v, scale, mask)
    return o / torch.movedim(l, -3, -2)


def ring_attention_sharded(mesh, q, k, v, axis_name="sp", causal=False,
                           batch_axis=None):
    """Convenience wrapper: shard_map ring_attention over `mesh` with the
    sequence dim of q/k/v sharded along `axis_name`; ``batch_axis='dp'``
    also shards the batch dim over the mesh's data axis."""
    axes = (axis_name,) if batch_axis is None else (axis_name, batch_axis)
    require_axes(mesh, axes, who="ring_attention_sharded")
    spec = P(batch_axis, axis_name, None, None)
    fn = shard_map(
        functools.partial(ring_attention, axis_name=axis_name, causal=causal),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
