"""Ulysses-style all-to-all sequence parallelism (counterpart of
``mxnet_tpu/parallel/ulysses.py``).

Activations arrive sequence-sharded (batch, seq/P, heads, dim); one
all-to-all swaps the sharded axis so each rank holds the FULL sequence
for heads/P of the heads, runs local attention (dense, or the flash op),
and a second all-to-all restores sequence sharding.  Communication is 4
all-to-alls of activation size per layer (q, k, v in; output back).

Trade-off vs ring: Ulysses needs heads % P == 0 and moves activations
twice, but the local attention is one dense block; the ring keeps K/V
resident and suits sequences too long for any device to hold full K/V.
"""
from __future__ import annotations

import functools

from . import collectives
from .mesh import P, require_axes, shard_map

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(q, k, v, axis_name="sp", causal=False, scale=None,
                      use_flash=False, blk_q=128, blk_k=128):
    """Exact attention over a sequence sharded along `axis_name`.

    q, k, v: (batch, seq_local, heads, dim) per-rank blocks, with heads
    divisible by the axis size.  Must run inside shard_map with
    `axis_name` bound.  Returns (batch, seq_local, heads, dim).

    use_flash=True runs the local full-sequence attention with the flash
    op (ops/attention.py: the CUDA kernel on the card), non-causal only.
    """
    h, d = q.shape[2], q.shape[3]
    p = collectives.axis_size(axis_name)
    if h % p != 0:
        raise ValueError(
            "ulysses_attention: heads (%d) must be divisible by the "
            "'%s' axis size (%d); use ring_attention otherwise"
            % (h, axis_name, p))
    if use_flash and causal:
        raise NotImplementedError(
            "ulysses_attention(use_flash=True) supports non-causal "
            "attention only (same contract as ring_attention)")
    scale = scale if scale is not None else d ** -0.5

    def seq_to_heads(x):
        # (b, s/P, h, d) -> (b, s, h/P, d): chunks land in rank order,
        # reconstructing the global sequence
        return collectives.all_to_all(x, axis_name, split_axis=2,
                                      concat_axis=1)

    def heads_to_seq(x):
        # inverse: (b, s, h/P, d) -> (b, s/P, h, d)
        return collectives.all_to_all(x, axis_name, split_axis=1,
                                      concat_axis=2)

    qf, kf, vf = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if use_flash:
        from ..ops.attention import flash_attention_with_lse

        out, _ = flash_attention_with_lse(qf, kf, vf, scale=scale,
                                          blk_q=blk_q, blk_k=blk_k)
        out = out.to(q.dtype)
    else:
        from .ring_attention import local_attention

        out = local_attention(qf, kf, vf, causal=causal, scale=scale)
    return heads_to_seq(out)


def ulysses_attention_sharded(mesh, q, k, v, axis_name="sp", causal=False,
                              use_flash=False, batch_axis=None):
    """Convenience wrapper: shard (batch, seq, heads, dim) inputs along
    `axis_name` over `mesh` and run ulysses_attention under shard_map;
    ``batch_axis='dp'`` also shards the batch dim."""
    axes = (axis_name,) if batch_axis is None else (axis_name, batch_axis)
    require_axes(mesh, axes, who="ulysses_attention_sharded")
    spec = P(batch_axis, axis_name)
    fn = shard_map(
        functools.partial(ulysses_attention, axis_name=axis_name,
                          causal=causal, use_flash=use_flash),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    return fn(q, k, v)
