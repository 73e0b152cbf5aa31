"""LM generation: the ring-KV-cache and the paged KV-cache engines and
continuous-batching token serving (parity: mxnet_tpu/generate.py
SamplingConfig :132, sample_logits :176, GenerationEngine :225-645,
PagedGenerationEngine :651-1376, GenerationResult / TokenServer
:1383-1959).

* **Ring KV cache on the device** — :class:`GenerationEngine`: one ring
  lane per decode slot, two tensors ``(layers, slots, heads, ring,
  d_head)`` in the dtype policy's compute dtype (bf16 under
  ``bf16_mixed``), updated in place.  Prefill runs the model's
  full-sequence forward at a bucketed length (``MXNET_DECODE_BUCKETS``);
  decode is one fixed-shape step over every slot.
* **Paged KV cache** — :class:`PagedGenerationEngine`: a page pool per
  K/V with host page tables, chunked prefill (``MXNET_DECODE_PREFILL_
  CHUNK``), copy-on-write prefix sharing of full prompt pages and n-gram
  self-speculative decoding (``MXNET_DECODE_SPEC_K``), all through one
  dispatch of the model's ``chunk_forward``.
* **Sampling** — greedy is ``argmax`` (the first maximum, as in JAX);
  otherwise :func:`mask_logits` applies temperature, top-k and top-p
  exactly as the JAX engine does.  The ring engine draws with
  ``torch.multinomial`` from the framework stream (``mx.random.next_key``);
  the paged engine's :func:`sample_positions` draws each position from
  a key of (the lane's seed, taken from that stream at admission,
  position), so speculation does not change what is sampled.  Both are
  reproducible under ``mx.random.seed``; the draws are not JAX's.
* **Token serving** — :class:`TokenServer` drives an engine from a
  bounded admission queue on a worker thread, with the typed errors of
  ``serving_async``: :class:`Overloaded` at admission,
  :class:`DeadlineExceeded` tagged ``prefill`` or ``decode``,
  :class:`Cancelled`, and a drained ``close()``.

Where the JAX engines compile their programs, these run them eagerly
under ``torch.inference_mode()`` on one device (by default the current
context, so the card), with the parameters committed and cast once at
construction.  Not ported yet: meshes and layouts, AOT and SLO shedding.

Observability is the JAX package's: the ``DECODE_*`` series of both
engines, ``TokenServer``'s ``decode.request`` spans and one
``token_request`` wide event a request, the ``decode`` ``/statusz``
subsystem and its readiness check (a server stops being ready when its
drained ``close()`` starts).

Model protocols: ``prefill_forward(tokens)`` / ``decode_forward(tokens,
caches, pos)`` (ring) and ``chunk_forward(tokens, caches, start)``
(paged), plus a ``config`` dict with ``vocab_size`` / ``d_model`` /
``n_heads`` / ``n_layers`` / ``max_len``
(``mxnet_tpu_torch/examples/transformer_lm.py``).
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import logging
import threading
import time
import weakref

import numpy as np
import torch

from . import config as _config
from . import dtype_policy as _dtp
from . import events as _events
from . import telemetry as _telemetry
from . import tracing as _tracing
from . import random as _random
from .base import MXNetError
from .context import Context, current_context
from .gluon import block as _block
from .ndarray.ndarray import NDArray
from .serving_async import (Cancelled, DeadlineExceeded, Overloaded,
                            ReplicaFailed, ServingError, ServingFuture)

__all__ = ["SamplingConfig", "GenerationEngine", "PagedGenerationEngine",
           "TokenServer", "GenerationResult", "sample_logits",
           "sample_positions", "mask_logits",
           "ServingError", "Overloaded", "DeadlineExceeded", "Cancelled"]

_logger = logging.getLogger("mxnet_tpu_torch.generate")

_UNSET = object()

# live TokenServers (weak), feeding the /statusz decode subsystem and the
# /healthz readiness contract — a decode process stops being ready the
# moment a drained close() starts
_live_servers = weakref.WeakSet()
_live_lock = threading.Lock()


def _live_snapshot():
    with _live_lock:
        return list(_live_servers)


def _decode_statusz():
    out = {"servers": []}
    for s in _live_snapshot():
        st = s.stats()
        st["occupancy"] = s._engine.occupancy()
        out["servers"].append(st)
    return out


def _decode_ready():
    servers = _live_snapshot()
    if not servers:
        return True
    return any(not s._closed and s._running for s in servers)


_telemetry.register_status_provider("decode", _decode_statusz)
_telemetry.register_readiness("decode", _decode_ready)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

class SamplingConfig:
    """Declared sampling recipe.

    ``greedy=True`` (default) takes the argmax and draws nothing from the
    random stream.  Otherwise sampling is categorical over the
    temperature-scaled logits, optionally restricted to the ``top_k``
    highest logits and/or the smallest set of tokens whose cumulative
    probability reaches ``top_p`` (nucleus).  ``eos_id`` is the token
    that finishes a sequence (eviction reason ``eos``); None means
    sequences only finish by length or deadline."""

    def __init__(self, greedy=True, temperature=1.0, top_k=None,
                 top_p=None, eos_id=None):
        self.greedy = bool(greedy)
        self.temperature = float(temperature)
        if self.temperature <= 0:
            raise MXNetError("temperature must be > 0, got %r"
                             % (temperature,))
        self.top_k = int(top_k) if top_k is not None else None
        if self.top_k is not None and self.top_k < 1:
            raise MXNetError("top_k must be >= 1, got %r" % (top_k,))
        self.top_p = float(top_p) if top_p is not None else None
        if self.top_p is not None and not 0 < self.top_p <= 1:
            raise MXNetError("top_p must be in (0, 1], got %r" % (top_p,))
        self.eos_id = int(eos_id) if eos_id is not None else None

    @property
    def tag(self):
        """Compact recipe tag."""
        if self.greedy:
            return "greedy"
        parts = ["sample"]
        if self.temperature != 1.0:
            parts.append("t%g" % self.temperature)
        if self.top_k:
            parts.append("k%d" % self.top_k)
        if self.top_p:
            parts.append("p%g" % self.top_p)
        return "_".join(parts)

    def __repr__(self):
        return "SamplingConfig(%s, eos_id=%r)" % (self.tag, self.eos_id)


def mask_logits(logits, cfg):
    """The (B, V) logits a non-greedy draw samples from: divided by the
    temperature, with every token outside ``top_k`` and outside the
    ``top_p`` nucleus set to -inf (the JAX engine's masks, :186-203).
    A token tied with the k-th logit stays; a token stays in the nucleus
    while the mass before it is under ``top_p``."""
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    neg = float("-inf")
    if cfg.top_k:
        k = min(cfg.top_k, logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg)
    if cfg.top_p is not None and cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        kept = (cum - probs) < cfg.top_p
        min_kept = torch.where(kept, sorted_logits,
                               torch.full_like(sorted_logits, float("inf"))
                               ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < min_kept, neg)
    return logits


def sample_logits(logits, key, cfg):
    """Token selection over (B, V) logits -> (B,) int64 ids.  Greedy
    takes the first maximum; otherwise one draw per row from the
    softmax of :func:`mask_logits` with ``key``, a ``torch.Generator``
    on the logits' device (None: the framework stream,
    ``mx.random.next_key``)."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    if key is None:
        key = _random.next_key(logits.device)
    probs = torch.softmax(mask_logits(logits.to(torch.float32), cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=key).reshape(-1)


def _parse_buckets(spec, cache_len):
    """``MXNET_DECODE_BUCKETS``/buckets= -> sorted unique lengths capped at
    ``cache_len`` (always containing cache_len, so every admissible prompt
    has a bucket)."""
    if spec is None:
        spec = _config.get("MXNET_DECODE_BUCKETS")
    if isinstance(spec, str):
        vals = [int(s) for s in spec.split(",") if s.strip()]
    else:
        vals = [int(v) for v in spec]
    return sorted({v for v in vals if 0 < v <= cache_len} | {cache_len})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _not_ported(engine, **kwargs):
    for name, value in kwargs.items():
        if value is not None:
            raise MXNetError("%s(%s=...) is not ported yet; leave it at "
                             "its default" % (engine, name))


class _Engine:
    """What both engines share: the model check, the parameters committed
    to the device and cast once, the dispatch scope, the prompt check and
    the lane state's introspection."""

    def _bind(self, net, protocol, methods, slots, sampling, device):
        """Check ``net`` against the decode or chunk protocol, finish its
        deferred parameter init and take the settings both engines have.
        Returns the model's config."""
        for attr in methods + ("config",):
            if not hasattr(net, attr):
                raise MXNetError(
                    "%s needs a model implementing the %s protocol (%s / "
                    "config — see examples/transformer_lm.py); %s lacks %r"
                    % (type(self).__name__, protocol, " / ".join(methods),
                       type(net).__name__, attr))
        cfg = dict(net.config)
        for k in ("vocab_size", "d_model", "n_heads", "n_layers",
                  "max_len"):
            if k not in cfg:
                raise MXNetError("model config lacks %r (decode protocol)"
                                 % k)
        self.model_config = cfg
        if slots is None:
            slots = _config.get("MXNET_DECODE_SLOTS")
        self._slots = int(slots)
        if self._slots < 1:
            raise MXNetError("slots must be >= 1, got %r" % (slots,))
        self.sampling = sampling if sampling is not None \
            else SamplingConfig()
        if device is None:
            device = current_context()
        self._device = device.torch_device if isinstance(device, Context) \
            else torch.device(device)
        # finish deferred parameter init: one probe forward where the
        # parameters live
        params = list(net.collect_params().values())
        probe = NDArray(torch.zeros(
            (1, min(8, cfg["max_len"])), dtype=torch.float32,
            device=params[0].list_ctx()[0].torch_device))
        _block._abstract_eval_forward(net, [probe])
        self._net = net
        self._gluon_params = params
        self._L, self._H = cfg["n_layers"], cfg["n_heads"]
        self._dh = cfg["d_model"] // self._H
        return cfg

    def _commit(self, dtype_policy):
        """Resolve the policy, then commit the parameters to the device
        once, cast once to the policy's per-parameter compute dtypes: the
        JAX engines cast inside every compiled call, which gives the same
        values."""
        policy = _dtp.resolve_policy(dtype_policy)
        _dtp.note_policy(policy, "generate")
        self._dtype_policy = policy
        self._cache_dtype = policy.compute_dtype if policy is not None \
            else torch.float32
        with torch.no_grad():
            committed = []
            for p in self._gluon_params:
                t = p.data()._data.detach().to(self._device, copy=True)
                if policy is not None:
                    t = policy.cast_compute(p.name, t)
                committed.append(t)
        self._params = tuple(committed)

    # -- introspection ---------------------------------------------------

    @property
    def slots(self):
        return self._slots

    @property
    def device(self):
        """The ``torch.device`` the engine runs on."""
        return self._device

    @property
    def dtype_policy_tag(self):
        return _dtp.policy_tag(self._dtype_policy)

    @property
    def cache_dtype(self):
        """The cache's ``torch.dtype`` (the policy's compute dtype)."""
        return self._cache_dtype

    def active_slots(self):
        return [int(i) for i in np.nonzero(self._active)[0]]

    def free_slots(self):
        return len(self._free)

    def position(self, slot):
        """Tokens resident for ``slot`` (prompt + generated so far)."""
        return int(self._pos[slot])

    def _check_tokens(self, token_ids):
        """Prompt ids as a 1-D int32 array and their prefill length
        (:meth:`bucket_for`), checked on the host: an id outside [0,
        vocab) would index past the embedding, which on the card is a
        device-side assert that ends the process's CUDA context (XLA
        clamps or fills instead)."""
        token_ids = np.asarray(token_ids).astype(np.int64).reshape(-1)
        if token_ids.size < 1:
            raise MXNetError("a prompt needs at least one token")
        vocab = self.model_config["vocab_size"]
        if token_ids.min() < 0 or token_ids.max() >= vocab:
            raise MXNetError("prompt token ids must lie in [0, %d), got "
                             "%d..%d" % (vocab, token_ids.min(),
                                         token_ids.max()))
        return token_ids.astype(np.int32), self.bucket_for(token_ids.size)

    # -- dispatch ----------------------------------------------------------

    @contextlib.contextmanager
    def _dispatch(self):
        """The model's forward with the committed parameters, under the
        policy's scope and without autograd."""
        with torch.inference_mode(), _dtp.scope(self._dtype_policy), \
                _block.swapped_params(self._gluon_params, self._params):
            yield

    def _cast_logits(self, logits):
        if self._dtype_policy is not None:
            return self._dtype_policy.cast_output(logits)
        return logits

    def prewarm(self):
        """Nothing to compile ahead here (no AOT store in the port):
        returns the JAX engine's answer without one."""
        return [{"label": "generate", "status": "disabled"}]


class GenerationEngine(_Engine):
    """Fixed-shape KV-cache generation over a decode-protocol model.

    ``slots`` decode lanes share one token step; each lane owns a
    ``cache_len``-position KV ring.  :meth:`admit` prefills a prompt into
    a free lane (bucketed lengths) and returns its first sampled token;
    :meth:`decode_step` advances every active lane one token;
    :meth:`evict` frees a lane.

    Single-consumer: one thread drives the engine (a TokenServer's
    worker, or a bench loop).  Admission control, deadlines and futures
    live in :class:`TokenServer`.
    """

    def __init__(self, net, slots=None, cache_len=None, buckets=None,
                 mesh=None, layout=None, dtype_policy=None, aot=None,
                 aot_spec=None, sampling=None, device=None):
        _not_ported("GenerationEngine", mesh=mesh, layout=layout, aot=aot,
                    aot_spec=aot_spec)
        cfg = self._bind(net, "decode", ("prefill_forward",
                                         "decode_forward"),
                         slots, sampling, device)
        if cache_len is None:
            cache_len = _config.get("MXNET_DECODE_CACHE_LEN")
        self._cache_len = int(min(cache_len, cfg["max_len"]))
        if self._cache_len < 1:
            raise MXNetError("cache_len must be >= 1, got %r"
                             % (cache_len,))
        self._buckets = _parse_buckets(buckets, self._cache_len)
        self._commit(dtype_policy)
        cache_shape = (self._L, self._slots, self._H, self._cache_len,
                       self._dh)
        self._cache_k = torch.zeros(cache_shape, dtype=self._cache_dtype,
                                    device=self._device)
        self._cache_v = torch.zeros_like(self._cache_k)

        # host-side lane state (the continuous-batching control plane)
        self._pos = np.zeros(self._slots, np.int64)
        self._active = np.zeros(self._slots, bool)
        self._cur_tok = np.zeros(self._slots, np.int64)
        self._free = collections.deque(range(self._slots))
        self._last_logits = None

    # -- introspection ---------------------------------------------------

    @property
    def cache_len(self):
        return self._cache_len

    @property
    def buckets(self):
        """Prefill length buckets (sorted)."""
        return list(self._buckets)

    @property
    def last_logits(self):
        """f32 logits of the most recent prefill ((1, V), the admitted
        sequence's last valid position) or decode step ((slots, V)), as
        numpy."""
        out = self._last_logits
        return None if out is None else out.to(torch.float32).cpu().numpy()

    def occupancy(self):
        """Cache occupancy: active lanes, resident tokens vs ring
        capacity."""
        active = int(self._active.sum())
        tokens = int(np.minimum(self._pos[self._active],
                                self._cache_len).sum()) if active else 0
        cap = self._slots * self._cache_len
        return {"active_slots": active, "slots": self._slots,
                "cache_tokens": tokens, "cache_capacity": cap,
                "occupancy": tokens / cap if cap else 0.0}

    def _note_occupancy(self):
        if not _telemetry.enabled():
            return
        occ = self.occupancy()
        _telemetry.DECODE_ACTIVE_SLOTS.set(occ["active_slots"])
        _telemetry.DECODE_CACHE_TOKENS.set(occ["cache_tokens"])

    def bucket_for(self, length):
        """Smallest prefill bucket >= ``length`` (raises when the prompt
        exceeds every bucket)."""
        for b in self._buckets:
            if length <= b:
                return b
        raise MXNetError(
            "prompt length %d exceeds the largest prefill bucket %d "
            "(cache_len=%d; shorten the prompt or build the engine with a "
            "longer cache)" % (length, self._buckets[-1], self._cache_len))

    # -- dispatch ----------------------------------------------------------

    def _sample(self, logits):
        logits = self._cast_logits(logits)
        key = None if self.sampling.greedy \
            else _random.next_key(logits.device)
        return logits, sample_logits(logits, key, self.sampling)

    # -- lifecycle of one sequence ---------------------------------------

    def admit(self, token_ids, slot=None):
        """Prefill ``token_ids`` into a free lane.  Returns ``(slot,
        first_token)``.  Raises :class:`Overloaded` (reason ``slots``)
        when no lane is free, ``MXNetError`` for an empty or too long
        prompt or an id outside the vocabulary."""
        token_ids, bucket = self._check_tokens(token_ids)
        n = token_ids.size
        if slot is None:
            if not self._free:
                raise Overloaded("slots", "all %d decode slots busy"
                                 % self._slots)
            slot = self._free.popleft()
        else:
            self._free.remove(slot)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = token_ids
        try:
            tok = self._prefill(padded, n, slot)
        except Exception:
            self._free.appendleft(slot)
            raise
        self._pos[slot] = n
        self._cur_tok[slot] = tok
        self._active[slot] = True
        self._note_occupancy()
        return slot, tok

    def _prefill(self, padded, n, slot):
        """Positions 0..Tb-1 of lane ``slot`` take the bucket's K/V and
        the rest of the lane is zeroed (JAX's ``kpad``, :391-402); the
        first token is sampled from position n-1's logits."""
        tb = padded.shape[1]
        tokens = torch.from_numpy(padded).to(self._device)
        with self._dispatch():
            logits_nd, caches = self._net.prefill_forward(NDArray(tokens))
            last, next_tok = self._sample(logits_nd._data[:, n - 1])
            for cache, part in ((self._cache_k, 0), (self._cache_v, 1)):
                cache[:, slot, :, :tb] = torch.stack(
                    [kv[part][0] for kv in caches])
                cache[:, slot, :, tb:] = 0
        self._last_logits = last
        return int(next_tok[0])

    def decode_step(self):
        """One token for every active lane.  Returns ``{slot: token}``
        (empty when nothing is active).  Inactive lanes compute alongside
        (fixed shape) and their output is dropped.  The tokens come back
        to the host once per step."""
        if not self._active.any():
            return {}
        t0 = time.perf_counter()
        host = torch.from_numpy(np.stack([self._cur_tok, self._pos]))
        tok_pos = host.to(self._device)
        with self._dispatch():
            caches = [(self._cache_k[li], self._cache_v[li])
                      for li in range(self._L)]
            logits_nd, _caches = self._net.decode_forward(
                tok_pos[0], caches, tok_pos[1])
            logits, next_tok = self._sample(logits_nd._data)
        self._last_logits = logits
        toks = next_tok.cpu().numpy()
        _telemetry.DECODE_STEP_SECONDS.observe(time.perf_counter() - t0)
        out = {}
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            tok = int(toks[slot])
            out[slot] = tok
            self._cur_tok[slot] = tok
            self._pos[slot] += 1
        _telemetry.DECODE_TOKENS.inc(len(out))
        _telemetry.DECODE_BATCH_TOKENS.observe(len(out))
        self._note_occupancy()
        return out

    def evict(self, slot, reason):
        """Free lane ``slot`` (reason: ``eos`` / ``deadline`` /
        ``length`` / ``cancelled`` / ``drain``).  The next admit
        overwrites the lane; no device work."""
        if not self._active[slot]:
            return
        self._active[slot] = False
        self._pos[slot] = 0
        # LIFO reuse: the same request sequence lands on the same lanes
        # run after run, which keeps sampled generation reproducible
        # under mx.random.seed
        self._free.appendleft(int(slot))
        _telemetry.DECODE_EVICTIONS.inc(reason=reason)
        self._note_occupancy()

    def at_capacity(self, slot):
        """True when ``slot`` exhausted the model's positions (the
        ``length`` eviction the server applies): the ring slides past
        ``cache_len``, but learned positions end at ``max_len``."""
        return self._pos[slot] >= self.model_config["max_len"]


# ---------------------------------------------------------------------------
# paged engine
# ---------------------------------------------------------------------------

def _ngram_draft(history, ngram, k):
    """Draft up to ``k`` continuation tokens by suffix match: find the
    most recent earlier occurrence of the last ``ngram`` tokens of
    ``history`` and propose the tokens that followed it.  Host work,
    O(len * ngram) at worst; [] when the sequence never repeated its
    suffix (the verify step then is a plain one-token decode)."""
    n = len(history)
    if k <= 0 or ngram <= 0 or n < ngram + 1:
        return []
    pat = history[-ngram:]
    for e in range(n - 2, ngram - 2, -1):
        if history[e - ngram + 1: e + 1] == pat:
            return list(history[e + 1: e + 1 + k])
    return []


def _prefix_page_hashes(token_ids, page_size, limit):
    """Chained content hashes of the first ``limit`` full prompt pages:
    ``h_i = sha1(h_{i-1} || int32 bytes of page i's tokens)``.  The chain
    makes a page's identity depend on everything before it, so two
    prompts share page i only when they agree on pages 0..i.  The bytes
    are int32, as in the JAX engine, so both give the same hashes."""
    token_ids = np.asarray(token_ids, np.int32)
    hashes = []
    prev = b""
    for i in range(limit):
        block = token_ids[i * page_size:(i + 1) * page_size]
        h = hashlib.sha1(prev + block.tobytes()).hexdigest()
        hashes.append(h)
        prev = h.encode()
    return hashes


_MASK32 = 0xFFFFFFFF


def _mul32(x, c):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) (numpy or
    torch), in halves so that no product leaves int64."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) \
        & _MASK32


def _mix32(x):
    """A bijection on 32-bit integers held in int64 (numpy or torch; the
    "lowbias32" finalizer): integer operations only, so the card and the
    CPU give the same bits."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _position_keys(seeds, start, width):
    """(B, width) int64 keys of positions ``start_b + j`` of each lane,
    a function of (the lane's 32-bit seed, position) only."""
    pos = np.asarray(start, np.int64)[:, None] + np.arange(width)
    return _mix32(_mix32(pos & _MASK32)
                  ^ np.asarray(seeds, np.int64)[:, None])


def sample_positions(logits, keys, cfg):
    """Token selection over (B, C, V) logits -> (B, C) int64 ids, every
    position its own draw.  Greedy takes the first maximum.  Otherwise
    Gumbel-max over :func:`mask_logits`, the uniforms from
    :func:`_uniforms` of position (b, c)'s key (``keys`` (B, C) int64,
    from :func:`_position_keys`), so a draw depends on (lane seed,
    position) alone and not on how many draws came before (speculative
    and plain decoding sample alike).  The bits are the same on the card
    and the CPU; the draws are not JAX's."""
    if cfg.greedy:
        return torch.argmax(logits, dim=-1)
    B, C, V = logits.shape
    masked = mask_logits(logits.to(torch.float32).reshape(B * C, V), cfg)
    gumbel = -torch.log(-torch.log(_uniforms(keys.reshape(B * C, 1), V)))
    return torch.argmax(masked + gumbel, dim=-1).reshape(B, C)


def _uniforms(keys, V):
    """(N, V) f32 uniforms strictly inside (0, 1) for (N, 1) int64
    ``keys``: 23 bits of ``_mix32(key ^ _mix32(v + 1))`` plus a half,
    exact in f32.  The index is mixed before it meets the key, so no
    key's row is a shifted window of another's."""
    vocab = _mix32(torch.arange(1, V + 1, device=keys.device))
    bits = _mix32(keys ^ vocab)
    return ((bits >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


class PagedGenerationEngine(_Engine):
    """Paged KV-cache generation over a chunk-protocol model (parity:
    mxnet_tpu/generate.py:686-1376).

    Device state is one page pool per K/V, ``(layers, pages, heads,
    page_size, d_head)`` in the policy's compute dtype, written in place;
    each slot maps its positions onto pool pages through a host page
    table (page 0 is the trash page that padded and inactive rows write
    to).  One dispatch, :meth:`_chunk_dispatch`, serves three shapes:

    * **prefill chunk** ``(1, prefill_chunk)``: prompts stream in
      fixed-size chunks (:meth:`prefill_step`, one chunk a call), so a
      long admission interleaves with decode steps;
    * **decode** ``(slots, 1)``: every active slot advances one token;
    * **verify** ``(slots, spec_k + 1)``: with n-gram speculation on,
      each step carries the current token plus up to ``spec_k`` drafts
      and verifies them at once.  Acceptance is exact match against the
      position-keyed sampler (:func:`sample_positions`), so the output
      is the one non-speculative sampling gives.

    **Prefix sharing** is page-aligned copy-on-write: full prompt pages
    are content-hashed (chained) and registered after prefill; a later
    admission attaches to matching pages refcounted and prefills only the
    tail.  Shared pages are never written again, so sharing needs no
    device copy; pages whose refcount drops to 0 stay cached (LRU) until
    the pool runs dry.

    Greedy decode gives the ring :class:`GenerationEngine`'s tokens.
    Eager under ``torch.inference_mode()`` on one device (by default the
    current context, so the card), parameters committed and cast once;
    not ported yet: meshes and layouts, AOT.  Single-consumer, like the
    ring engine.
    """

    # TokenServer admits incrementally (admit, then one prefill chunk a
    # loop tick) when it sees this flag
    incremental = True

    def __init__(self, net, slots=None, cache_len=None, page_size=None,
                 num_pages=None, prefill_chunk=None, spec_k=None,
                 spec_ngram=None, prefix_share=None, mesh=None,
                 layout=None, dtype_policy=None, aot=None, aot_spec=None,
                 sampling=None, device=None):
        _not_ported("PagedGenerationEngine", mesh=mesh, layout=layout,
                    aot=aot, aot_spec=aot_spec)
        cfg = self._bind(net, "chunk", ("chunk_forward",), slots, sampling,
                         device)
        if cache_len is None:
            cache_len = _config.get("MXNET_DECODE_CACHE_LEN")
        cache_len = int(min(cache_len, cfg["max_len"]))
        if page_size is None:
            page_size = _config.get("MXNET_DECODE_PAGE_SIZE")
        self._page_size = int(page_size)
        if self._page_size < 1:
            raise MXNetError("page_size must be >= 1, got %r"
                             % (page_size,))
        self._pages_per_slot = -(-cache_len // self._page_size)
        self._capacity = self._pages_per_slot * self._page_size
        if num_pages is None:
            num_pages = _config.get("MXNET_DECODE_PAGES")
        if not num_pages:
            # the floor at which every slot can back its full capacity
            # (+1 trash page): decode-time allocation cannot starve
            num_pages = self._slots * self._pages_per_slot + 1
        self._num_pages = int(num_pages)
        if self._num_pages < self._pages_per_slot + 1:
            raise MXNetError(
                "num_pages=%d cannot back even one slot (%d pages per "
                "slot + the trash page)" % (self._num_pages,
                                            self._pages_per_slot))
        if prefill_chunk is None:
            prefill_chunk = _config.get("MXNET_DECODE_PREFILL_CHUNK")
        self._chunk = max(1, int(prefill_chunk))
        if spec_k is None:
            spec_k = _config.get("MXNET_DECODE_SPEC_K")
        self._spec_k = max(0, int(spec_k))
        if spec_ngram is None:
            spec_ngram = _config.get("MXNET_DECODE_SPEC_NGRAM")
        self._spec_ngram = max(1, int(spec_ngram))
        if prefix_share is None:
            prefix_share = _config.get("MXNET_DECODE_PREFIX_SHARE")
        self._prefix_share = bool(prefix_share)
        self._commit(dtype_policy)
        L, H, dh = self._L, self._H, self._dh
        pool_shape = (L, self._num_pages, H, self._page_size, dh)
        self._pool_k = torch.zeros(pool_shape, dtype=self._cache_dtype,
                                   device=self._device)
        self._pool_v = torch.zeros_like(self._pool_k)
        # index constants of the gather and the scatter
        self._layer_idx = torch.arange(L, device=self._device)
        self._head_idx = torch.arange(H, device=self._device)
        self._offset_idx = torch.arange(self._capacity,
                                        device=self._device) \
            % self._page_size

        # host control plane: page tables, slot state, the prefix map
        P = self._pages_per_slot
        self._page_table = np.zeros((self._slots, P), np.int64)
        self._pos = np.zeros(self._slots, np.int64)
        self._active = np.zeros(self._slots, bool)
        self._cur_tok = np.zeros(self._slots, np.int64)
        self._free = collections.deque(range(self._slots))
        self._lane_seeds = np.zeros(self._slots, np.int64)
        self._free_pages = collections.deque(range(1, self._num_pages))
        self._page_ref = np.zeros(self._num_pages, np.int64)
        self._prefix_map = {}                 # chain hash -> page id
        self._page_hash = {}                  # page id -> chain hash
        self._reclaim = collections.OrderedDict()  # refcount-0 LRU
        self._pending = collections.OrderedDict()  # slot -> prefill state
        self._history = {}                    # slot -> prompt + emitted
        self._last_logits = None
        self.last_prefix_hit_tokens = 0
        self._prefix_hit_tokens = 0
        self._prefix_lookup_tokens = 0
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_steps = 0
        self._chunks_run = 0

    # -- introspection ---------------------------------------------------

    @property
    def cache_len(self):
        """Positions one slot can hold (pages_per_slot x page_size)."""
        return self._capacity

    @property
    def page_size(self):
        return self._page_size

    @property
    def num_pages(self):
        """Pool pages including the reserved trash page 0."""
        return self._num_pages

    @property
    def pages_per_slot(self):
        return self._pages_per_slot

    @property
    def prefill_chunk(self):
        return self._chunk

    @property
    def spec_k(self):
        return self._spec_k

    def pending_prefill(self):
        """Slots admitted but still streaming prefill chunks."""
        return len(self._pending)

    @property
    def last_logits(self):
        """f32 logits (B, C, V) of the most recent dispatch, as numpy:
        (1, prefill_chunk, V) after a prefill chunk, (slots, 1 or
        spec_k + 1, V) after a decode step."""
        out = self._last_logits
        return None if out is None else out.to(torch.float32).cpu().numpy()

    def pages_in_use(self):
        """Distinct pool pages referenced by live slots (the trash page
        and retained-but-unreferenced prefix pages excluded)."""
        live = np.unique(self._page_table)
        return int((live != 0).sum())

    def prefix_hit_rate(self):
        """Fraction of shareable prompt tokens served from the prefix
        cache (None before any lookup)."""
        if not self._prefix_lookup_tokens:
            return None
        return self._prefix_hit_tokens / self._prefix_lookup_tokens

    def spec_accept_rate(self):
        """Fraction of drafted tokens accepted by verify steps (None
        before any draft)."""
        if not self._spec_drafted:
            return None
        return self._spec_accepted / self._spec_drafted

    def spec_accepted_per_step(self):
        """Mean drafted-and-accepted tokens per verify step that carried
        at least one draft (each such step emits 1 + this)."""
        if not self._spec_steps:
            return None
        return self._spec_accepted / self._spec_steps

    def occupancy(self):
        active = int(self._active.sum()) + len(self._pending)
        tokens = int(np.minimum(self._pos[self._active],
                                self._capacity).sum()) \
            if self._active.any() else 0
        cap = self._slots * self._capacity
        out = {"active_slots": active, "slots": self._slots,
               "cache_tokens": tokens, "cache_capacity": cap,
               "occupancy": tokens / cap if cap else 0.0,
               "pages_in_use": self.pages_in_use(),
               "pages_total": self._num_pages - 1,
               "page_size": self._page_size,
               "prefix_cached_pages": len(self._prefix_map),
               "pending_prefill": len(self._pending)}
        hr = self.prefix_hit_rate()
        if hr is not None:
            out["prefix_hit_rate"] = round(hr, 4)
        ar = self.spec_accept_rate()
        if ar is not None:
            out["spec_accept_rate"] = round(ar, 4)
            out["spec_accepted_per_step"] = round(
                self.spec_accepted_per_step(), 4)
        return out

    def _note_occupancy(self):
        if not _telemetry.enabled():
            return
        occ = self.occupancy()
        _telemetry.DECODE_ACTIVE_SLOTS.set(occ["active_slots"])
        _telemetry.DECODE_CACHE_TOKENS.set(occ["cache_tokens"])
        _telemetry.DECODE_PAGES_IN_USE.set(occ["pages_in_use"])

    def bucket_for(self, length):
        """Admissibility check of the ring engine's API: raises when
        ``length`` exceeds a slot's capacity, else returns the
        chunk-padded prefill length (advisory; a prefix hit shortens the
        work)."""
        limit = min(self._capacity, self.model_config["max_len"])
        if length > limit:
            raise MXNetError(
                "prompt length %d exceeds the paged cache capacity %d "
                "(%d pages x %d positions; shorten the prompt or build "
                "the engine with a longer cache)"
                % (length, limit, self._pages_per_slot, self._page_size))
        return self._chunk * (-(-length // self._chunk))

    def at_capacity(self, slot):
        return self._pos[slot] >= min(self._capacity,
                                      self.model_config["max_len"])

    # -- the one dispatch ------------------------------------------------

    def _chunk_dispatch(self, page_table, tokens, start, wpage, woff,
                        seeds):
        """Gather each row's pages into a linear (B, H, S, dh) view, run
        the model's ``chunk_forward``, sample every chunk position with
        its position-keyed draw, and write the chunk's K/V into the pools
        at (``wpage``, ``woff``) in place.  ``page_table`` (B, P),
        ``tokens`` (B, C), ``start`` (B,), ``wpage``/``woff`` (B, C),
        ``seeds`` (B,): host arrays, sent to the device in one copy.
        Returns the sampled (B, C) ids on the host.

        The gather takes all layers at once, one index op per pool, as
        JAX does: the step is bound by the host's time per op (fewer ops
        beat a smaller peak), and the view costs 2 x L x B x H x S x dh
        elements."""
        B, C = tokens.shape
        L, H, S = self._L, self._H, self._capacity
        parts = [tokens.reshape(-1), start,
                 np.repeat(page_table, self._page_size, axis=1).reshape(-1),
                 wpage.reshape(-1), woff.reshape(-1)]
        sizes = [B * C, B, B * S, B * C, B * C]
        if not self.sampling.greedy:
            parts.append(_position_keys(seeds, start, C).reshape(-1))
            sizes.append(B * C)
        host = torch.from_numpy(np.concatenate(parts).astype(np.int64))
        tok, st, page_of, wp, wo, *keys = torch.split(
            host.to(self._device), sizes)
        gather = (page_of.reshape(B, 1, S), self._head_idx.reshape(H, 1),
                  self._offset_idx)
        scatter = (self._layer_idx.reshape(L, 1, 1, 1),
                   wp.reshape(1, B, 1, C), self._head_idx.reshape(1, 1, H, 1),
                   wo.reshape(1, B, 1, C))
        with self._dispatch():
            gk = self._pool_k[(slice(None),) + gather]   # (L, B, H, S, dh)
            gv = self._pool_v[(slice(None),) + gather]
            logits_nd, chunk_caches = self._net.chunk_forward(
                tok.reshape(B, C), [(gk[li], gv[li]) for li in range(L)],
                st)
            del gk, gv
            logits = self._cast_logits(logits_nd._data)
            sampled = sample_positions(
                logits, keys[0].reshape(B, C) if keys else None,
                self.sampling)
            # (L, B, H, C, dh) values at broadcast (L, B, H, C) indices;
            # padded and inactive rows all land on (page 0, offset 0)
            for pool, part in ((self._pool_k, 0), (self._pool_v, 1)):
                pool.index_put_(scatter, torch.stack(
                    [kv[part] for kv in chunk_caches]).to(pool.dtype))
        self._last_logits = logits
        self._chunks_run += 1
        return sampled.cpu().numpy()

    @staticmethod
    def _check_writes(wpage, live):
        """Only the trash page may take duplicate writes (which of them
        lands is undefined on the card): no live position maps to it."""
        if (wpage[live] == 0).any():
            raise MXNetError("a live position maps to the trash page 0 "
                             "(page table corrupt)")

    # -- page bookkeeping ------------------------------------------------

    def _take_page(self):
        """A free page, reclaiming the LRU retained prefix page when the
        free list is dry (reclaim unregisters it)."""
        if self._free_pages:
            return self._free_pages.popleft()
        if self._reclaim:
            pg, h = self._reclaim.popitem(last=False)
            del self._prefix_map[h]
            del self._page_hash[pg]
            return int(pg)
        return None

    def _release_slot_pages(self, slot):
        row = self._page_table[slot]
        for pg in row.tolist():
            if pg == 0:
                continue
            self._page_ref[pg] -= 1
            if self._page_ref[pg] <= 0:
                h = self._page_hash.get(pg)
                if h is not None:
                    # a registered prefix page stays (LRU) until pool
                    # pressure reclaims it: a follow-up request with the
                    # same prompt still hits
                    self._reclaim[pg] = h
                    self._reclaim.move_to_end(pg)
                else:
                    self._free_pages.appendleft(pg)
        row[:] = 0

    def _register_prefix(self, slot, token_ids, n):
        """After a prompt fully prefilled: register its full pages below
        position n-1 in the prefix map (first writer wins; an attached
        page is registered under the same chain hash already)."""
        limit = min((n - 1) // self._page_size, self._pages_per_slot)
        if limit <= 0:
            return
        row = self._page_table[slot]
        for i, h in enumerate(_prefix_page_hashes(
                token_ids, self._page_size, limit)):
            if h in self._prefix_map:
                continue
            pg = int(row[i])
            self._prefix_map[h] = pg
            self._page_hash[pg] = h

    # -- lifecycle of one sequence ---------------------------------------

    def admit_incremental(self, token_ids):
        """Claim a slot for ``token_ids``: attach any shared prefix pages,
        allocate the rest of the slot's pages up front (so decode never
        starves mid-flight), and queue the unshared prompt tail for
        chunked prefill.  Returns the slot; the first token comes from
        the :meth:`prefill_step` that completes the prompt.  Raises
        :class:`Overloaded` (``slots`` / ``pages``)."""
        token_ids, _ = self._check_tokens(token_ids)
        n = token_ids.size
        if not self._free:
            raise Overloaded("slots", "all %d decode slots busy"
                             % self._slots)
        # prefix attach: the longest chain of registered full prompt
        # pages, never the page holding token n-1 (the tail must prefill
        # so that the first token's logits exist)
        attached = []
        if self._prefix_share:
            limit = min((n - 1) // self._page_size, self._pages_per_slot)
            for h in _prefix_page_hashes(token_ids, self._page_size, limit):
                pg = self._prefix_map.get(h)
                if pg is None:
                    break
                attached.append(pg)
            self._prefix_lookup_tokens += limit * self._page_size
            self._prefix_hit_tokens += len(attached) * self._page_size
            _telemetry.DECODE_PREFIX_LOOKUP_TOKENS.inc(
                limit * self._page_size)
            _telemetry.DECODE_PREFIX_HIT_TOKENS.inc(
                len(attached) * self._page_size)
        self.last_prefix_hit_tokens = len(attached) * self._page_size
        # count before taking: an attached page parked in the reclaim LRU
        # is not free, and _take_page must never hand it out again (the
        # JAX engine takes fresh pages first and can, mxnet_tpu/
        # generate.py:1182-1196: the row then holds that page twice)
        need = self._pages_per_slot - len(attached)
        parked = sum(1 for pg in attached if pg in self._reclaim)
        if need > len(self._free_pages) + len(self._reclaim) - parked:
            raise Overloaded(
                "pages", "page pool exhausted (%d/%d in use)"
                % (self.pages_in_use(), self._num_pages - 1))
        for pg in attached:
            self._reclaim.pop(pg, None)
            self._page_ref[pg] += 1
        fresh = [self._take_page() for _ in range(need)]
        for pg in fresh:
            self._page_ref[pg] += 1
        slot = self._free.popleft()
        self._page_table[slot, :] = attached + fresh
        start = len(attached) * self._page_size
        self._pending[slot] = {"tokens": token_ids, "filled": start, "n": n}
        self._history[slot] = token_ids.tolist()
        # the lane's seed: one draw from the framework stream (host side)
        self._lane_seeds[slot] = 0 if self.sampling.greedy else int(
            torch.randint(0, 2 ** 32, (1,),
                          generator=_random.next_key(torch.device("cpu"))))
        return slot

    def prefill_step(self, slot=None):
        """Run one prefill chunk (round-robin over the pending slots, or
        the given ``slot``).  Returns ``(slot, first_token)`` when that
        chunk completed its prompt, else None.  The TokenServer calls
        this once a loop tick, interleaving long prefills with decode
        steps; the round-robin keeps a short prompt's time to first
        token from hiding behind a long prompt admitted just before."""
        if not self._pending:
            return None
        if slot is None:
            slot = next(iter(self._pending))
            self._pending.move_to_end(slot)
        st = self._pending[slot]
        toks, filled, n = st["tokens"], st["filled"], st["n"]
        count = min(self._chunk, n - filled)
        chunk = np.zeros((1, self._chunk), np.int64)
        chunk[0, :count] = toks[filled:filled + count]
        p = filled + np.arange(count)
        wpage = np.zeros((1, self._chunk), np.int64)
        woff = np.zeros((1, self._chunk), np.int64)
        wpage[0, :count] = self._page_table[slot, p // self._page_size]
        woff[0, :count] = p % self._page_size
        self._check_writes(wpage[0], slice(0, count))
        sampled = self._chunk_dispatch(
            self._page_table[slot:slot + 1], chunk,
            np.asarray([filled], np.int64), wpage, woff,
            self._lane_seeds[slot:slot + 1])
        _telemetry.DECODE_PREFILL_CHUNKS.inc()
        if filled + count < n:
            st["filled"] = filled + count
            return None
        tok = int(sampled[0, count - 1])
        del self._pending[slot]
        self._pos[slot] = n
        self._cur_tok[slot] = tok
        self._active[slot] = True
        self._history[slot].append(tok)
        if self._prefix_share:
            self._register_prefix(slot, toks, n)
        self._note_occupancy()
        return slot, tok

    def admit(self, token_ids, slot=None):
        """Synchronous admission (the ring engine's drop-in; ``slot`` is
        taken for its signature and ignored, as in the JAX engine): claim
        a slot and run every prefill chunk back to back.  Returns
        ``(slot, first_token)``."""
        sl = self.admit_incremental(token_ids)
        while True:
            res = self.prefill_step(slot=sl)
            if res is not None:
                return res

    def decode_step(self):
        """One fixed-shape step for every active slot.  Returns ``{slot:
        [tokens...]}``: one token a slot without speculation, up to
        ``spec_k + 1`` with it (the drafts that verified, plus the one
        token sampling always yields).  Rejected drafts leave K/V at
        positions >= the new ``pos``; ``chunk_forward``'s cache mask
        hides them and decode overwrites them as it advances."""
        if not self._active.any():
            return {}
        B, K = self._slots, self._spec_k
        cap = min(self._capacity, self.model_config["max_len"])
        active = [int(b) for b in np.nonzero(self._active)[0]]
        C = K + 1 if K > 0 else 1
        tokens = np.zeros((B, C), np.int64)
        width = np.zeros(B, np.int64)          # positions written a row
        drafts = {}
        for b in active:
            tokens[b, 0] = self._cur_tok[b]
            d = []
            if K > 0:
                room = cap - 1 - int(self._pos[b])
                if room > 0:
                    d = _ngram_draft(self._history[b], self._spec_ngram,
                                     min(K, room))
                tokens[b, 1:1 + len(d)] = d
            drafts[b] = d
            width[b] = len(d) + 1
        pos = self._pos[:, None] + np.arange(C)
        live = np.arange(C)[None, :] < width[:, None]
        if (pos[live] >= self._capacity).any():
            raise MXNetError("a slot is at its capacity of %d positions; "
                             "evict it before the next decode step"
                             % self._capacity)
        page = np.where(live, pos // self._page_size, 0)
        wpage = np.where(live, np.take_along_axis(self._page_table, page,
                                                  axis=1), 0)
        woff = np.where(live, pos % self._page_size, 0)
        self._check_writes(wpage, live)
        t0 = time.perf_counter()
        sampled = self._chunk_dispatch(self._page_table, tokens, self._pos,
                                       wpage, woff, self._lane_seeds)
        _telemetry.DECODE_STEP_SECONDS.observe(time.perf_counter() - t0)
        out = {}
        emitted_total = 0
        for b in active:
            d = drafts[b]
            acc = 0
            while acc < len(d) and d[acc] == sampled[b, acc]:
                acc += 1
            emitted = [int(t) for t in sampled[b, :acc + 1]]
            if d:
                self._spec_drafted += len(d)
                self._spec_accepted += acc
                self._spec_steps += 1
                _telemetry.DECODE_SPEC_DRAFTED.inc(len(d))
                _telemetry.DECODE_SPEC_ACCEPTED.inc(acc)
            out[b] = emitted
            emitted_total += len(emitted)
            self._cur_tok[b] = emitted[-1]
            self._pos[b] += len(emitted)
            self._history[b].extend(emitted)
        _telemetry.DECODE_TOKENS.inc(emitted_total)
        _telemetry.DECODE_BATCH_TOKENS.observe(len(out))
        self._note_occupancy()
        return out

    def evict(self, slot, reason):
        """Free ``slot`` (mid-prefill pendings included): drop its
        refcounts, return private pages to the free list, park refcount-0
        prefix pages in the retained LRU."""
        if slot not in self._pending and not self._active[slot]:
            return
        self._pending.pop(slot, None)
        self._history.pop(slot, None)
        self._active[slot] = False
        self._pos[slot] = 0
        self._release_slot_pages(slot)
        # LIFO slot reuse, for the ring engine's reproducibility reason
        self._free.appendleft(int(slot))
        _telemetry.DECODE_EVICTIONS.inc(reason=reason)
        self._note_occupancy()


# ---------------------------------------------------------------------------
# continuous-batching token serving
# ---------------------------------------------------------------------------

class GenerationResult(dict):
    """Resolution payload of one generation request: ``tokens`` (ids,
    prompt excluded), ``finish_reason`` (``eos`` / ``length``),
    ``ttft_s`` (submit -> first token)."""

    @property
    def tokens(self):
        return self["tokens"]

    @property
    def finish_reason(self):
        return self["finish_reason"]

    @property
    def ttft_s(self):
        return self["ttft_s"]


class _GenRequest:
    __slots__ = ("tokens", "future", "deadline", "t_submit", "max_new",
                 "out", "slot", "ttft", "span", "t_pickup", "prefix_hit",
                 "on_token")

    def __init__(self, tokens, deadline, max_new, span=None,
                 on_token=None):
        self.tokens = tokens
        self.future = None
        self.deadline = deadline
        self.t_submit = time.monotonic()
        self.max_new = max_new
        self.out = []
        self.slot = None
        self.ttft = None
        self.span = span           # detached root span (tracing on)
        self.t_pickup = None       # queue -> prefill pickup time
        self.prefix_hit = None     # prompt tokens served by prefix pages
        self.on_token = on_token   # streaming observer


class TokenServer:
    """Continuous-batching token front end over one
    :class:`GenerationEngine` or :class:`PagedGenerationEngine`.

    ``submit`` admits a prompt through a bounded queue and returns a
    :class:`ServingFuture` resolving to a :class:`GenerationResult`.  A
    worker thread (pinned to the engine's device) admits queued prompts
    into free slots (prefill), steps every active slot one token per
    tick, and evicts on EOS, deadline, length cap or cancellation.  Over
    a paged engine admission only claims a slot and its pages; the loop
    then streams one prefill chunk a tick between decode steps, and a
    step's several verified tokens are delivered one at a time:

    * admission: :class:`Overloaded` — ``queue`` (queue full),
      ``shutdown``; cooperative backpressure via ``block=True``.
    * deadlines: :class:`DeadlineExceeded` with ``stage="prefill"``
      (expired waiting or during prefill) or ``stage="decode"`` (expired
      mid-generation; the partial tokens are dropped and the slot
      evicted with reason ``deadline``).
    * shutdown: ``close(drain=True)`` stops admission, lets active
      sequences finish (bounded), and fails the rest :class:`Cancelled`.
    """

    def __init__(self, engine, queue_depth=None, deadline_ms=None,
                 max_new_tokens=None, slo_ms=None, shed_error_budget=0.1,
                 shed_burn_threshold=2.0, shed_window_s=30.0,
                 shed_hist=None):
        if slo_ms or shed_hist is not None:
            raise MXNetError("TokenServer(slo_ms=...) shedding needs "
                             "serving_async.BurnRateShedder, which is not "
                             "ported yet")
        self._engine = engine
        # paged engines admit incrementally: the loop streams one prefill
        # chunk a tick between decode steps instead of running the whole
        # prompt inside admission
        self._incremental = bool(getattr(engine, "incremental", False))
        if queue_depth is None:
            queue_depth = _config.get("MXNET_DECODE_QUEUE")
        self._depth = int(queue_depth)
        if self._depth < 1:
            raise MXNetError("queue_depth must be >= 1, got %r"
                             % (queue_depth,))
        if deadline_ms is None:
            deadline_ms = _config.get("MXNET_DECODE_DEADLINE_MS")
        self._deadline_s = float(deadline_ms) / 1e3 if deadline_ms \
            else None
        if max_new_tokens is None:
            max_new_tokens = _config.get("MXNET_DECODE_MAX_NEW")
        self._max_new = int(max_new_tokens)
        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._by_slot = {}
        self._running = True
        self._closed = False
        self._worker = threading.Thread(target=self._loop,
                                        name="decode-server", daemon=True)
        self._worker.start()
        with _live_lock:
            _live_servers.add(self)

    # -- admission -------------------------------------------------------

    def _admission_error_locked(self, deadline, now):
        if self._closed or not self._running:
            return Overloaded("shutdown")
        if deadline is not None and now >= deadline:
            return DeadlineExceeded("prefill", "expired before admission")
        if len(self._queue) >= self._depth:
            return Overloaded("queue", "depth %d" % self._depth)
        return None

    def submit(self, token_ids, deadline_ms=_UNSET, max_new_tokens=None,
               block=False, timeout=None, on_token=None):
        """Admit one prompt; returns its :class:`ServingFuture`.

        Non-blocking by default (typed :class:`Overloaded` on a full
        queue); ``block=True`` waits up to ``timeout`` seconds for queue
        space (``shutdown`` still raises at once).  ``deadline_ms``
        overrides the server default; None/0 = no deadline.
        ``max_new_tokens`` caps generation for this request
        (finish_reason ``length``).  ``on_token`` is called from the
        decode loop with each generated token id; a raising observer is
        detached."""
        token_ids, _ = self._engine._check_tokens(token_ids)  # fail fast
        now = time.monotonic()
        if deadline_ms is _UNSET:
            deadline_s = self._deadline_s
        else:
            deadline_s = float(deadline_ms) / 1e3 if deadline_ms else None
        deadline = now + deadline_s if deadline_s is not None else None
        max_new = int(max_new_tokens) if max_new_tokens else self._max_new
        wait_until = now + timeout if timeout is not None else None
        span = _tracing.begin("decode.request", activate=False,
                              args={"prompt_tokens": int(token_ids.size)}) \
            if _tracing.enabled() else None

        def _rejected(err):
            """Typed admission failure: count it, close the span, and
            file the request's one wide event."""
            if isinstance(err, Overloaded):
                _telemetry.SERVING_SHED.inc(reason=err.reason)
                outcome = {"outcome": "shed", "reason": err.reason}
            else:
                _telemetry.SERVING_DEADLINE_EXCEEDED.inc(stage="prefill")
                outcome = {"outcome": "deadline", "stage": "prefill"}
            if span is not None:
                span.set(error=type(err).__name__).end(error=True)
            if _events.enabled():
                _events.emit("token_request",
                             span_id=span.span_id if span is not None
                             else None,
                             prompt_tokens=int(token_ids.size), **outcome)

        with self._cond:
            while True:
                err = self._admission_error_locked(deadline,
                                                   time.monotonic())
                if err is None:
                    break
                blockable = isinstance(err, Overloaded) and \
                    err.reason == "queue"
                if not block or not blockable:
                    _rejected(err)
                    raise err
                remaining = None
                if wait_until is not None:
                    remaining = wait_until - time.monotonic()
                    if remaining <= 0:
                        _rejected(err)
                        raise err
                self._cond.wait(remaining if remaining is not None
                                else 0.1)
            req = _GenRequest(token_ids, deadline, max_new, span=span,
                              on_token=on_token)
            req.future = ServingFuture(owner=self, req=req)
            self._queue.append(req)
            _telemetry.DECODE_QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()
        return req.future

    def generate(self, token_ids, timeout=None, **kwargs):
        """Blocking convenience: ``submit`` (backpressure-admitting) +
        ``result``."""
        t_end = time.monotonic() + timeout if timeout is not None \
            else None
        fut = self.submit(token_ids, block=True, timeout=timeout, **kwargs)
        remaining = None
        if t_end is not None:
            remaining = max(0.0, t_end - time.monotonic())
        return fut.result(remaining)

    def _cancel(self, req):
        """ServingFuture.cancel hook: dequeue a waiting request, or flag
        an active one for eviction at the next loop tick."""
        with self._cond:
            resolved = req.future._resolve(
                exc=Cancelled("request cancelled"))
            if resolved:
                self._emit_event(req, outcome="evicted",
                                 reason="cancelled",
                                 evicted=req.slot is not None)
            if resolved and req.slot is None and req in self._queue:
                self._queue.remove(req)
                _telemetry.DECODE_QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()
            return resolved

    # -- the decode loop -------------------------------------------------

    def _emit_event(self, req, evicted=False, **kw):
        """The request's one wide event, filed at resolution (callers
        guard on the future's first-writer-wins _resolve, so a deadline
        racing a finish files exactly one).  Stage split: ``queue``
        (submit -> prefill pickup), ``prefill`` (pickup -> first token),
        ``decode`` (first token -> resolution)."""
        if req.span is not None:
            err = kw.get("outcome", "ok") != "ok"
            req.span.set(tokens=len(req.out), **{k: v
                         for k, v in kw.items() if v is not None})
            req.span.end(error=err)
        if not _events.enabled():
            return
        now = time.monotonic()
        stages = {}
        if req.t_pickup is not None:
            stages["queue"] = req.t_pickup - req.t_submit
            if req.ttft is not None:
                stages["prefill"] = \
                    (req.t_submit + req.ttft) - req.t_pickup
                stages["decode"] = now - (req.t_submit + req.ttft)
            else:
                # picked up but no first token: the time went into the
                # failed or expired prefill
                stages["prefill"] = now - req.t_pickup
        else:
            stages["queue"] = now - req.t_submit
        _events.emit(
            "token_request", dur_s=now - req.t_submit, stages_s=stages,
            tokens=len(req.out), prompt_tokens=int(req.tokens.size),
            ttft_s=req.ttft, slot=req.slot,
            prefix_hit_tokens=req.prefix_hit,
            evicted=True if evicted else None,
            span_id=req.span.span_id if req.span is not None else None,
            **kw)

    def _finish(self, req, reason):
        _telemetry.DECODE_REQUESTS_FINISHED.inc(reason=reason)
        if req.future._resolve(result=GenerationResult(
                tokens=list(req.out), finish_reason=reason,
                ttft_s=req.ttft)):
            self._emit_event(req, outcome="ok", reason=reason)

    def _fail(self, req, exc):
        if isinstance(exc, DeadlineExceeded):
            _telemetry.SERVING_DEADLINE_EXCEEDED.inc(stage=exc.stage)
        if not req.future._resolve(exc=exc):
            return
        if isinstance(exc, DeadlineExceeded):
            self._emit_event(req, outcome="deadline", stage=exc.stage,
                             evicted=req.slot is not None)
        elif isinstance(exc, Overloaded):
            self._emit_event(req, outcome="shed", reason=exc.reason)
        elif isinstance(exc, Cancelled):
            self._emit_event(req, outcome="evicted", reason="cancelled",
                             evicted=req.slot is not None)
        else:
            self._emit_event(req, outcome="error",
                             error_kind=type(exc).__name__)

    def _admit_locked_pop(self):
        """Pop the next admissible queued request (failing expired ones,
        typed) — the caller holds the lock."""
        now = time.monotonic()
        while self._queue:
            req = self._queue.popleft()
            _telemetry.DECODE_QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()    # queue space freed: wake any
                                       # block=True submitter
            if req.future.done():      # cancelled while queued
                continue
            if req.deadline is not None and now >= req.deadline:
                self._fail(req, DeadlineExceeded(
                    "prefill", "expired waiting for a decode slot"))
                continue
            return req
        return None

    def _sweep_queue(self):
        """Expire queued deadlines even while every slot is busy — a
        request must not discover its deadline only when a slot frees."""
        now = time.monotonic()
        with self._cond:
            expired = [r for r in self._queue
                       if r.deadline is not None and now >= r.deadline
                       and not r.future.done()]
            if not expired and not any(r.future.done()
                                       for r in self._queue):
                return
            self._queue = collections.deque(
                r for r in self._queue
                if r not in expired and not r.future.done())
            _telemetry.DECODE_QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()
        for req in expired:
            self._fail(req, DeadlineExceeded(
                "prefill", "expired waiting for a decode slot"))

    def _admissions(self):
        eng = self._engine
        while eng.free_slots() > 0:
            with self._cond:
                req = self._admit_locked_pop()
            if req is None:
                return
            t_pick = time.monotonic()
            req.t_pickup = t_pick
            ex = {"trace_id": _tracing.TRACE_ID,
                  "span_id": req.span.span_id} \
                if req.span is not None else None
            _telemetry.DECODE_QUEUE_WAIT_SECONDS.observe(
                t_pick - req.t_submit, exemplar=ex)
            if self._incremental:
                # claim the slot and pages only; the time to first token
                # runs on until the chunk that completes the prompt
                try:
                    slot = eng.admit_incremental(req.tokens)
                except ServingError as e:
                    self._fail(req, e)
                    continue
                except Exception as e:
                    self._fail(req, ReplicaFailed(
                        "prefill admission failed: %s" % (e,), cause=e))
                    continue
                req.slot = slot
                req.prefix_hit = eng.last_prefix_hit_tokens or None
                with self._cond:
                    self._by_slot[slot] = req
                continue
            try:
                slot, tok = eng.admit(req.tokens)
            except ServingError as e:
                self._fail(req, e)
                continue
            except Exception as e:
                self._fail(req, ReplicaFailed(
                    "prefill dispatch failed: %s" % (e,), cause=e))
                continue
            req.slot = slot
            req.ttft = time.monotonic() - req.t_submit
            _telemetry.DECODE_TTFT_SECONDS.observe(req.ttft, exemplar=ex)
            with self._cond:
                self._by_slot[slot] = req
            self._deliver(req, slot, tok)

    def _deliver(self, req, slot, tok):
        """Append one generated token and apply the finish/evict rules.
        Returns False when the request left its slot."""
        eng = self._engine
        if req.future.done():                      # cancelled mid-run
            self._release(slot)
            eng.evict(slot, "cancelled")
            return False
        if req.deadline is not None and time.monotonic() >= req.deadline:
            stage = "decode" if req.out else "prefill"
            self._fail(req, DeadlineExceeded(
                stage, "deadline hit after %d token(s)" % len(req.out)))
            self._release(slot)
            eng.evict(slot, "deadline")
            return False
        req.out.append(tok)
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:
                _logger.exception("on_token observer failed; detaching")
                req.on_token = None
        eos = eng.sampling.eos_id
        if eos is not None and tok == eos:
            self._finish(req, "eos")
            self._release(slot)
            eng.evict(slot, "eos")
            return False
        if len(req.out) >= req.max_new or eng.at_capacity(slot):
            self._finish(req, "length")
            self._release(slot)
            eng.evict(slot, "length")
            return False
        return True

    def _release(self, slot):
        with self._cond:
            self._by_slot.pop(slot, None)
            self._cond.notify_all()

    def _prefill_tick(self):
        """One chunked-prefill step (incremental engines): evict
        cancelled or expired mid-prefill requests first, then run one
        chunk; when it completes a prompt, its sampled first token starts
        the request's delivery (time to first token taken here)."""
        eng = self._engine
        now = time.monotonic()
        with self._cond:
            stale = [(s, r) for s, r in self._by_slot.items()
                     if r.ttft is None and
                     (r.future.done() or
                      (r.deadline is not None and now >= r.deadline))]
        for slot, req in stale:
            if req.future.done():          # cancelled while prefilling
                reason = "cancelled"
            else:
                reason = "deadline"
                self._fail(req, DeadlineExceeded(
                    "prefill", "deadline hit mid-prefill"))
            self._release(slot)
            eng.evict(slot, reason)
        res = eng.prefill_step()
        if res is None:
            return
        slot, tok = res
        with self._cond:
            req = self._by_slot.get(slot)
        if req is None:
            eng.evict(slot, "cancelled")
            return
        req.ttft = time.monotonic() - req.t_submit
        ex = {"trace_id": _tracing.TRACE_ID,
              "span_id": req.span.span_id} \
            if req.span is not None else None
        _telemetry.DECODE_TTFT_SECONDS.observe(req.ttft, exemplar=ex)
        self._deliver(req, slot, tok)

    def _loop(self):
        if self._engine.device.type == "cuda":
            torch.cuda.set_device(self._engine.device)
        while True:
            with self._cond:
                while self._running and not self._queue \
                        and not self._by_slot:
                    self._cond.wait(0.02)
                if not self._running:
                    return
            try:
                self._sweep_queue()
                self._admissions()
                if self._incremental:
                    self._prefill_tick()
                toks = self._engine.decode_step()
                for slot, tok in toks.items():
                    with self._cond:
                        req = self._by_slot.get(slot)
                    if req is None:
                        self._engine.evict(slot, "cancelled")
                        continue
                    # a paged step may emit several verified tokens; the
                    # finish rules apply token by token, so speculative
                    # overshoot past eos or max_new is cut off here
                    for t in (tok if isinstance(tok, list) else [tok]):
                        if not self._deliver(req, slot, t):
                            break
            except Exception as e:
                # a failed dispatch can leave the engine half-updated:
                # fail everything typed and stop
                _logger.exception("decode loop failed; shutting down")
                with self._cond:
                    self._closed = True
                    self._running = False
                    victims = list(self._by_slot.values()) \
                        + list(self._queue)
                    self._by_slot.clear()
                    self._queue.clear()
                    _telemetry.DECODE_QUEUE_DEPTH.set(0)
                for req in victims:
                    self._fail(req, ReplicaFailed(
                        "decode loop failed: %s" % (e,), cause=e))
                return

    # -- lifecycle -------------------------------------------------------

    def close(self, drain=True, timeout=None):
        """Stop admission; with ``drain`` (default) let active sequences
        finish (bounded by ``timeout`` seconds, else a 30 s no-progress
        guard), then fail the remainder :class:`Cancelled`.
        Idempotent."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if drain:
            last_busy = None
            last_progress = time.monotonic()
            while True:
                with self._cond:
                    busy = len(self._queue) + len(self._by_slot)
                    if not busy or not self._running:
                        break
                now = time.monotonic()
                if last_busy is None or busy < last_busy:
                    last_busy, last_progress = busy, now
                elif now - last_progress > 30.0:
                    _logger.warning(
                        "close(): no drain progress in 30s with %d "
                        "request(s) live; cancelling the remainder", busy)
                    break
                if deadline is not None and now >= deadline:
                    break
                time.sleep(0.005)
        with self._cond:
            self._running = False
            self._cond.notify_all()
        # join before touching engine state: the worker may be
        # mid-iteration, and the engine is single-consumer
        self._worker.join(timeout=5.0)
        worker_gone = not self._worker.is_alive()
        with self._cond:
            victims = list(self._by_slot.values()) + list(self._queue)
            self._by_slot.clear()
            self._queue.clear()
            _telemetry.DECODE_QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        for req in victims:
            if not req.future.done():
                if req.future._resolve(exc=Cancelled(
                        "token server shut down before completion")):
                    self._emit_event(req, outcome="evicted",
                                     reason="drain",
                                     evicted=req.slot is not None)
            if req.slot is not None and worker_gone:
                # a worker stuck in a device call could still race the
                # lane; leave it active then rather than double-free it
                self._engine.evict(req.slot, "drain")
        # readiness: not ready while close() drains, then this server
        # stops counting
        with _live_lock:
            _live_servers.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self):
        with self._cond:
            return {
                "queue_depth": len(self._queue),
                "active": len(self._by_slot),
                "free_slots": self._engine.free_slots(),
                "shedding": False,
                "closed": self._closed,
            }
