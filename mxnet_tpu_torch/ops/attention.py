"""Flash attention: the port's counterpart of
``mxnet_tpu/ops/attention_pallas.py``.

The forward of a CUDA tensor is a hand-written kernel (blockwise online
softmax; the (T, T) score matrix is never stored): f32 at any head dim,
and bf16 with a head dim above 256, on ``kernels/flash_attention.cu`` (f32
arithmetic on the CUDA cores; launches count as ``"flash_attention"``);
bf16 up to head dim 256 on ``kernels/flash_attention_bf16.cu`` (tensor
cores, P rounded to bf16 before P.V; ``"flash_attention_bf16"``).  The
forward of a CPU tensor is the plain
version ``_ref_attention_lse``, and nothing else.  Returns the normalized
output and the per-row logsumexp, which ``parallel.ring_attention`` uses
to merge partial results exactly.

The backward recomputes ``_ref_attention_lse`` under autograd and takes
the vector-Jacobian product of both outputs, as the JAX package's
``custom_vjp`` does; the JAX package has no backward kernel, so neither
has the port.

Public functions keep the JAX layout: q, k, v and o are (B, T, H, D),
lse is (B, T, H).
"""
from __future__ import annotations

import torch

from .. import kernels

__all__ = ["flash_attention", "flash_attention_with_lse"]


def _ref_attention_lse(q, k, v, scale, causal):
    """Plain version (f32, unblocked) on (B, H, T, D) producing (o, lse):
    the CPU forward, the backward's recompute target, and the reference
    the kernel is held to on the card."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        mask = (torch.arange(Tq, device=q.device)[:, None]
                >= torch.arange(Tk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, v.float())
    return o, (m + torch.log(l))[..., 0]


class _FlashAttention(torch.autograd.Function):
    """(B, T, H, D) q, k, v -> (o (B, T, H, D) in q's type, lse (B, T, H)
    f32)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.causal = scale, causal
        if q.is_cuda:
            # the kernel reads any (B, T, H, D) strides with a dense head dim
            q, k, v = (t if t.stride(-1) == 1 else t.contiguous()
                       for t in (q, k, v))
            return kernels.flash_attention_fwd(q, k, v, scale, causal)
        o, lse = _ref_attention_lse(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), scale, causal)
        return (o.transpose(1, 2).to(q.dtype).contiguous(),
                lse.transpose(1, 2).contiguous())

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        with torch.enable_grad():
            o, lse = _ref_attention_lse(*(t.transpose(1, 2) for t in leaves),
                                        ctx.scale, ctx.causal)
            grads = torch.autograd.grad(
                (o, lse), leaves,
                (g_o.transpose(1, 2).float(), g_lse.transpose(1, 2).float()))
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v))) + (
            None, None)


def flash_attention_with_lse(q, k, v, causal=False, scale=None, blk_q=128,
                             blk_k=128):
    """(B, T, H, D) attention.

    Returns (out (B, T, H, D), lse (B, T, H)): lse is the per-row softmax
    log-normalizer, the quantity needed to merge partial attention blocks
    exactly (ring/sequence parallelism).  ``blk_q``/``blk_k`` keep the
    JAX package's shape contract (each sequence length a multiple of
    ``min(blk, T)``); the CUDA kernel's own tiles are its own."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    Tq, Tk = q.shape[1], k.shape[1]
    blk_q, blk_k = min(int(blk_q), Tq), min(int(blk_k), Tk)
    if Tq % blk_q or Tk % blk_k:
        raise ValueError("flash_attention: seq lengths (%d, %d) must be "
                         "multiples of the block sizes (%d, %d)"
                         % (Tq, Tk, blk_q, blk_k))
    return _FlashAttention.apply(q, k, v, scale, bool(causal))


def flash_attention(q, k, v, causal=False, scale=None, blk_q=128, blk_k=128):
    """(B, T, H, D) -> (B, T, H, D) fused attention output."""
    o, _lse = flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                       blk_q=blk_q, blk_k=blk_k)
    return o
