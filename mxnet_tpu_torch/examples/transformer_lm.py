"""Decoder-only transformer language model, the port's copy of
examples/transformer_lm.py.

Token + learned-position embeddings, pre-norm decoder blocks (LayerNorm
-> causal multi-head attention -> residual -> LayerNorm -> relu FFN ->
residual), a final LayerNorm and an untied head.  Attention is composed
from ``batch_dot`` and ``softmax`` as in the JAX package (no flash
kernel on this path).  Parameter names match the JAX LM's letter for
letter (``transformerlm0_h0_ln1_gamma``, ...), so its weights carry
across through ``convert.load_from_numpy``.

``prefill_forward`` / ``decode_forward`` are the cache-aware halves of
``hybrid_forward`` that ``generate.GenerationEngine`` drives, and
``chunk_forward`` the chunk protocol of ``generate.PagedGenerationEngine``
(chunked prefill, paged decode, speculative verify); where the JAX
package passes raw jax arrays, these take and return device tensors.
"""
from __future__ import annotations

import torch

from ..gluon import HybridBlock, nn, loss as gloss
from ..ndarray.ndarray import NDArray

__all__ = ["TransformerLM", "DecoderBlock", "lm_loss_fn"]


class DecoderBlock(HybridBlock):
    """Pre-norm decoder block: LN -> causal MHA -> residual -> LN ->
    FFN -> residual."""

    def __init__(self, d_model, n_heads, d_ff, **kwargs):
        super().__init__(**kwargs)
        if d_model % n_heads:
            raise ValueError("d_model (%d) must divide by n_heads (%d)"
                             % (d_model, n_heads))
        self._n_heads = n_heads
        self._d_head = d_model // n_heads
        with self.name_scope():
            self.ln1 = nn.LayerNorm(prefix="ln1_")
            self.proj_q = nn.Dense(d_model, flatten=False, use_bias=False,
                                   prefix="proj_q_")
            self.proj_k = nn.Dense(d_model, flatten=False, use_bias=False,
                                   prefix="proj_k_")
            self.proj_v = nn.Dense(d_model, flatten=False, use_bias=False,
                                   prefix="proj_v_")
            self.attn_out = nn.Dense(d_model, flatten=False,
                                     use_bias=False, prefix="attn_out_")
            self.ln2 = nn.LayerNorm(prefix="ln2_")
            self.ffn_up = nn.Dense(d_ff, flatten=False, activation="relu",
                                   prefix="ffn_up_")
            self.ffn_down = nn.Dense(d_model, flatten=False,
                                     prefix="ffn_down_")

    # The head split and merge work on the tensor: torch's reshape copies
    # only where the layout needs it (never at T == 1, a decode step),
    # where NDArray's transpose always copies (upstream's storage rule).
    def _split_heads(self, a):  # (B, T, D) -> (B*H, T, dh)
        B, T, _D = a.shape
        H, dh = self._n_heads, self._d_head
        return NDArray(a._data.reshape(B, T, H, dh).transpose(1, 2)
                       .reshape(B * H, T, dh))

    def _merge_heads(self, a, B, T):  # (B*H, T, dh) -> (B, T, D)
        H, dh = self._n_heads, self._d_head
        return NDArray(a._data.reshape(B, H, T, dh).transpose(1, 2)
                       .reshape(B, T, H * dh))

    def _attend_capture(self, F, x):
        """Causal MHA over the full sequence; also returns this layer's
        K/V heads as (B, H, T, dh), the cache that prefill seeds.  The op
        sequence is the train path's, so prefill logits equal the full
        forward's bit for bit."""
        B, T, D = x.shape
        H, dh = self._n_heads, self._d_head
        q = self._split_heads(self.proj_q(x))
        k = self._split_heads(self.proj_k(x))
        v = self._split_heads(self.proj_v(x))
        scores = F.batch_dot(q, k, transpose_b=True) * (dh ** -0.5)
        pos = F.arange(T, ctx=x.context)
        causal = F.broadcast_greater_equal(pos.reshape((T, 1)),
                                           pos.reshape((1, T)))
        scores = F.where(causal.reshape((1, T, T)), scores,
                         F.ones_like(scores) * -1e30)
        att = F.softmax(scores, axis=-1)
        out = F.batch_dot(att, v)  # (B*H, T, dh)
        out = self._merge_heads(out, B, T)
        kv_shape = (B, H, T, dh)
        return (self.attn_out(out), k.reshape(kv_shape),
                v.reshape(kv_shape))

    def hybrid_forward(self, F, x):
        out, _k, _v = self._attend_capture(F, self.ln1(x))
        x = x + out
        return x + self.ffn_down(self.ffn_up(self.ln2(x)))

    def forward_prefill(self, F, x):
        """One block's full-sequence forward that also hands back K/V
        for the cache: the math of ``hybrid_forward``."""
        a, k, v = self._attend_capture(F, self.ln1(x))
        x = x + a
        return x + self.ffn_down(self.ffn_up(self.ln2(x))), k, v

    def forward_decode(self, F, x, k_cache, v_cache, write_slot,
                       valid_mask):
        """One block's single-token decode against the ring KV cache.

        ``x`` is the (B, 1, D) input NDArray; ``k_cache``/``v_cache`` are
        (B, H, S, dh) tensors, written in place: sequence b's K/V for
        this token go to ring slot ``write_slot[b]`` and every other
        entry keeps its value bit for bit (no arithmetic on it).
        ``valid_mask`` (B*H, 1, S) marks the slots holding real entries.
        Returns the block's output NDArray."""
        B = x.shape[0]
        H, dh = self._n_heads, self._d_head
        S = k_cache.shape[2]
        h = self.ln1(x)
        q = self._split_heads(self.proj_q(h))          # (B*H, 1, dh)
        k_t = self._split_heads(self.proj_k(h))._data.reshape((B, H, dh))
        v_t = self._split_heads(self.proj_v(h))._data.reshape((B, H, dh))
        lanes = torch.arange(B, device=k_cache.device)
        k_cache[lanes, :, write_slot] = k_t.to(k_cache.dtype)
        v_cache[lanes, :, write_slot] = v_t.to(v_cache.dtype)
        kc = NDArray(k_cache.reshape((B * H, S, dh)))
        vc = NDArray(v_cache.reshape((B * H, S, dh)))
        scores = F.batch_dot(q, kc, transpose_b=True) * (dh ** -0.5)
        scores = F.where(NDArray(valid_mask), scores,
                         F.ones_like(scores) * -1e30)
        att = F.softmax(scores, axis=-1)
        out = F.batch_dot(att, vc)                     # (B*H, 1, dh)
        out = self._merge_heads(out, B, 1)
        x = x + self.attn_out(out)
        return x + self.ffn_down(self.ffn_up(self.ln2(x)))


    def forward_chunk(self, F, x, k_cache, v_cache, cache_mask,
                      causal_mask):
        """One block's C-position chunk forward against a linear KV cache
        view: the attention behind chunked prefill, paged decode (C=1)
        and the speculative verify step (C=K+1).

        ``x`` is the (B, C, D) chunk input NDArray; ``k_cache`` /
        ``v_cache`` are (B*H, S, dh) tensors holding the cached positions
        (this chunk's K/V is not in them); ``cache_mask`` (B*H, 1, S)
        marks the cache positions every chunk query may attend (s <
        its sequence's start); ``causal_mask`` (1, C, C) is the
        within-chunk causal triangle.  Returns ``(x_out, k_chunk,
        v_chunk)``, the chunk's K/V as (B*H, C, dh) tensors for the
        caller to write into its pool.  The projections, LayerNorms and
        FFN are the children ``hybrid_forward`` runs; the attention
        products are plain ``matmul``s, as in the JAX package."""
        B, C, _D = x.shape
        dh = self._d_head
        h = self.ln1(x)
        q = self._split_heads(self.proj_q(h))._data    # (B*H, C, dh)
        k_c = self._split_heads(self.proj_k(h))._data
        v_c = self._split_heads(self.proj_v(h))._data
        scale = dh ** -0.5
        s_cache = torch.matmul(q, k_cache.transpose(1, 2)) * scale
        s_chunk = torch.matmul(q, k_c.transpose(1, 2)) * scale
        s_cache = torch.where(cache_mask, s_cache, -1e30)
        s_chunk = torch.where(causal_mask, s_chunk, -1e30)
        att = torch.softmax(torch.cat([s_cache, s_chunk], dim=-1), dim=-1)
        out = torch.matmul(att, torch.cat([v_cache, v_c], dim=1))
        out = self._merge_heads(NDArray(out), B, C)     # (B, C, D)
        x = x + self.attn_out(out)
        return x + self.ffn_down(self.ffn_up(self.ln2(x))), k_c, v_c


class TransformerLM(HybridBlock):
    """Token + learned-position embeddings, ``n_layers`` decoder blocks,
    final LayerNorm, untied LM head.  Input (batch, seq) token ids ->
    (batch, seq, vocab) logits."""

    def __init__(self, vocab_size, d_model=256, n_heads=4, n_layers=2,
                 d_ff=None, max_len=512, **kwargs):
        super().__init__(**kwargs)
        d_ff = d_ff or 4 * d_model
        self._cfg = dict(vocab_size=vocab_size, d_model=d_model,
                         n_heads=n_heads, n_layers=n_layers, d_ff=d_ff,
                         max_len=max_len)
        with self.name_scope():
            self.embed = nn.Embedding(vocab_size, d_model,
                                      prefix="embed_")
            self.pos_embed = nn.Embedding(max_len, d_model,
                                          prefix="pos_embed_")
            self._blocks = []
            for i in range(n_layers):
                blk = DecoderBlock(d_model, n_heads, d_ff,
                                   prefix="h%d_" % i)
                self.register_child(blk, "h%d" % i)
                self._blocks.append(blk)
            self.ln_f = nn.LayerNorm(prefix="ln_f_")
            self.head = nn.Dense(vocab_size, flatten=False,
                                 use_bias=False, prefix="head_")

    @property
    def config(self):
        return dict(self._cfg)

    def flops_per_token(self, seq_len=None):
        """Train FLOPs/token: 6N dense plus, with ``seq_len``, the
        attention term ``12 * n_layers * d_model * seq_len``."""
        c = self._cfg
        n_params = (c["vocab_size"] * c["d_model"] * 2          # embed+head
                    + c["max_len"] * c["d_model"]
                    + c["n_layers"] * (4 * c["d_model"] ** 2
                                       + 2 * c["d_model"] * c["d_ff"]))
        flops = 6 * n_params
        if seq_len:
            flops += 12 * c["n_layers"] * c["d_model"] * int(seq_len)
        return flops

    def _embed(self, F, tokens):
        B, T = tokens.shape
        if T > self._cfg["max_len"]:
            raise ValueError("sequence length %d > max_len %d"
                             % (T, self._cfg["max_len"]))
        pos = F.arange(T, ctx=tokens.context)
        return F.broadcast_add(self.embed(tokens),
                               self.pos_embed(pos).reshape(
                                   (1, T, self._cfg["d_model"])))

    def hybrid_forward(self, F, tokens):
        x = self._embed(F, tokens)
        for blk in self._blocks:
            x = blk(x)
        return self.head(self.ln_f(x))

    def prefill_forward(self, tokens):
        """Full-sequence forward that also returns every layer's K/V.

        ``tokens`` is a (B, T) NDArray of token ids.  Returns ``(logits
        NDArray (B, T, V), caches)``, ``caches`` one ``(k, v)`` pair of
        (B, H, T, dh) tensors per layer: positions 0..T-1 of the decode
        ring.  The logits equal ``hybrid_forward``'s (same children, same
        op sequence)."""
        from .. import ndarray as F

        x = self._embed(F, tokens)
        caches = []
        for blk in self._blocks:
            x, k, v = blk.forward_prefill(F, x)
            caches.append((k._data, v._data))
        return self.head(self.ln_f(x)), caches

    def decode_forward(self, tokens, caches, pos):
        """One autoregressive step against the ring KV cache.

        ``tokens`` (B,) int tensor: the token at position ``pos`` ((B,)
        int tensor) of each sequence; ``caches`` one ``(k, v)`` pair of
        (B, H, S, dh) tensors per layer.  Writes each sequence's K/V into
        ring slot ``pos % S`` in place, attends over the ``min(pos+1,
        S)`` filled slots, and returns ``(logits NDArray (B, V),
        caches)``."""
        from .. import ndarray as F

        B = tokens.shape[0]
        H = self._cfg["n_heads"]
        D = self._cfg["d_model"]
        S = caches[0][0].shape[2]
        pos = pos.to(torch.int64)
        # the engine evicts at max_len; the clamp keeps a late step's
        # position row in bounds
        pos_clip = pos.clamp(0, self._cfg["max_len"] - 1)
        x = self.embed(NDArray(tokens.reshape((B, 1)))) + self.pos_embed(
            NDArray(pos_clip)).reshape((B, 1, D))
        slot_idx = torch.arange(S, device=pos.device)
        count = torch.clamp(pos + 1, max=S)
        valid = slot_idx[None, :] < count[:, None]          # (B, S)
        valid_bh = valid.reshape((B, 1, 1, S)).expand(B, H, 1, S) \
            .reshape((B * H, 1, S))
        write_slot = pos % S
        for blk, (kc, vc) in zip(self._blocks, caches):
            x = blk.forward_decode(F, x, kc, vc, write_slot, valid_bh)
        logits = self.head(self.ln_f(x))                    # (B, 1, V)
        return logits.reshape((B, self._cfg["vocab_size"])), caches

    def chunk_forward(self, tokens, caches, start):
        """C positions per sequence against a linear KV cache: chunked
        prefill (B=1, C=chunk), paged decode (C=1) and speculative verify
        (C=K+1).

        ``tokens`` (B, C) int tensor: the tokens at positions ``start_b
        .. start_b+C-1`` of each sequence; ``caches`` one ``(k, v)``
        pair of (B, H, S, dh) tensors per layer (a gathered page view in
        the paged engine) holding the cached positions; ``start`` (B,)
        int tensor.  Chunk position j attends
        cache positions ``s < start_b`` (entries at or past it, stale or
        not, are masked) plus chunk positions ``j' <= j``: the causal
        window the full forward gives it.  Returns ``(logits NDArray
        (B, C, V), chunk_caches)``, ``chunk_caches`` one ``(k, v)`` pair
        of (B, H, C, dh) tensors per layer for the caller to write back
        (positions past a sequence's real length give values the caller
        routes to its trash page)."""
        from .. import ndarray as F

        B, C = tokens.shape
        H = self._cfg["n_heads"]
        D = self._cfg["d_model"]
        dh = D // H
        S = caches[0][0].shape[2]
        start = start.to(torch.int64)
        c_idx = torch.arange(C, device=start.device)
        pos_ids = (start[:, None] + c_idx).clamp(0, self._cfg["max_len"] - 1)
        x = self.embed(NDArray(tokens)) + self.pos_embed(
            NDArray(pos_ids)).reshape((B, C, D))
        s_idx = torch.arange(S, device=start.device)
        cache_mask = (s_idx[None, :] < start[:, None]).reshape(
            (B, 1, 1, S)).expand(B, H, 1, S).reshape((B * H, 1, S))
        causal_mask = (c_idx[:, None] >= c_idx[None, :]).reshape((1, C, C))
        chunk_caches = []
        for blk, (kc, vc) in zip(self._blocks, caches):
            x, k_c, v_c = blk.forward_chunk(
                F, x, kc.reshape((B * H, S, dh)), vc.reshape((B * H, S, dh)),
                cache_mask, causal_mask)
            chunk_caches.append((k_c.reshape((B, H, C, dh)),
                                 v_c.reshape((B, H, C, dh))))
        return self.head(self.ln_f(x)), chunk_caches


def lm_loss_fn(vocab_size):
    """Next-token softmax-CE adapter for ShardedTrainer: flattens
    (B, T, V) logits against (B, T) label ids."""
    ce = gloss.SoftmaxCrossEntropyLoss()

    def loss(logits, labels):
        B, T, V = logits.shape
        return ce(logits.reshape((B * T, V)), labels.reshape((B * T,)))

    return loss
