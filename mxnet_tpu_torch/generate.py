"""LM generation: the ring-KV-cache engine with a prefill/decode split and
continuous-batching token serving (parity: mxnet_tpu/generate.py
SamplingConfig :132, sample_logits :176, GenerationEngine :225-645,
GenerationResult / TokenServer :1383-1959).

* **KV cache on the device** — one ring lane per decode slot, two
  tensors ``(layers, slots, heads, ring, d_head)`` in the dtype policy's
  compute dtype (bf16 under ``bf16_mixed``), updated in place.
* **Prefill/decode split** — prefill runs the model's full-sequence
  forward at a bucketed length (``MXNET_DECODE_BUCKETS``), seeds the
  admitted sequence's lane and samples its first token.  Decode is one
  fixed-shape step over every slot; admission and eviction change
  host-side lane state only.
* **Sampling** — greedy is ``argmax`` (the first maximum, as in JAX);
  otherwise :func:`mask_logits` applies temperature, top-k and top-p
  exactly as the JAX engine does and ``torch.multinomial`` draws from
  the framework stream (``mx.random.next_key``), so ``mx.random.seed``
  makes sampled generation reproducible (the draws are not JAX's).
* **Token serving** — :class:`TokenServer` drives an engine from a
  bounded admission queue on a worker thread, with the typed errors of
  ``serving_async``: :class:`Overloaded` at admission,
  :class:`DeadlineExceeded` tagged ``prefill`` or ``decode``,
  :class:`Cancelled`, and a drained ``close()``.

Where the JAX engine compiles its prefill and decode programs, this one
runs them eagerly under ``torch.inference_mode()`` on one device (by
default the current context, so the card), with the parameters committed
and cast once at construction.  Not ported yet: meshes and layouts, AOT,
the paged engine, speculative decoding, prefix sharing, SLO shedding and
the telemetry, tracing and event hooks.

Model protocol: ``prefill_forward(tokens)`` / ``decode_forward(tokens,
caches, pos)`` plus a ``config`` dict with ``vocab_size`` / ``d_model`` /
``n_heads`` / ``n_layers`` / ``max_len``
(``mxnet_tpu_torch/examples/transformer_lm.py``).
"""
from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time

import numpy as np
import torch

from . import config as _config
from . import dtype_policy as _dtp
from . import random as _random
from .base import MXNetError
from .context import Context, current_context
from .gluon import block as _block
from .ndarray.ndarray import NDArray
from .serving_async import (Cancelled, DeadlineExceeded, Overloaded,
                            ReplicaFailed, ServingError, ServingFuture)

__all__ = ["SamplingConfig", "GenerationEngine", "TokenServer",
           "GenerationResult", "sample_logits", "mask_logits",
           "ServingError", "Overloaded", "DeadlineExceeded", "Cancelled"]

_logger = logging.getLogger("mxnet_tpu_torch.generate")

_UNSET = object()


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

class GenerationEngine:
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
        for name, value in (("mesh", mesh), ("layout", layout),
                            ("aot", aot), ("aot_spec", aot_spec)):
            if value is not None:
                raise MXNetError("GenerationEngine(%s=...) is not ported "
                                 "yet; leave it at its default" % name)
        for attr in ("prefill_forward", "decode_forward", "config"):
            if not hasattr(net, attr):
                raise MXNetError(
                    "GenerationEngine needs a model implementing the "
                    "decode protocol (prefill_forward / decode_forward / "
                    "config — see examples/transformer_lm.py); %s lacks "
                    "%r" % (type(net).__name__, attr))
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
        if cache_len is None:
            cache_len = _config.get("MXNET_DECODE_CACHE_LEN")
        self._cache_len = int(min(cache_len, cfg["max_len"]))
        if self._cache_len < 1:
            raise MXNetError("cache_len must be >= 1, got %r"
                             % (cache_len,))
        self._buckets = _parse_buckets(buckets, self._cache_len)
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
        policy = _dtp.resolve_policy(dtype_policy)
        self._dtype_policy = policy
        self._cache_dtype = policy.compute_dtype if policy is not None \
            else torch.float32
        # the parameters are committed to the device once, and cast
        # once to the policy's per-parameter compute dtypes: the JAX
        # engine casts inside every compiled call (:339-343), which gives
        # the same values
        with torch.no_grad():
            committed = []
            for p in params:
                t = p.data()._data.detach().to(self._device, copy=True)
                if policy is not None:
                    t = policy.cast_compute(p.name, t)
                committed.append(t)
        self._params = tuple(committed)
        L, H = cfg["n_layers"], cfg["n_heads"]
        dh = cfg["d_model"] // H
        cache_shape = (L, self._slots, H, self._cache_len, dh)
        self._cache_k = torch.zeros(cache_shape, dtype=self._cache_dtype,
                                    device=self._device)
        self._cache_v = torch.zeros_like(self._cache_k)
        self._L = L

        # host-side lane state (the continuous-batching control plane)
        self._pos = np.zeros(self._slots, np.int64)
        self._active = np.zeros(self._slots, bool)
        self._cur_tok = np.zeros(self._slots, np.int64)
        self._free = collections.deque(range(self._slots))
        self._last_logits = None

    # -- introspection ---------------------------------------------------

    @property
    def slots(self):
        return self._slots

    @property
    def cache_len(self):
        return self._cache_len

    @property
    def buckets(self):
        """Prefill length buckets (sorted)."""
        return list(self._buckets)

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

    def _check_tokens(self, token_ids):
        """Prompt ids as a 1-D int64 array and their prefill bucket,
        checked on the host: an id outside [0, vocab) would index past
        the embedding, which on the card is a device-side assert that
        ends the process's CUDA context (XLA clamps or fills instead)."""
        token_ids = np.asarray(token_ids).astype(np.int64).reshape(-1)
        if token_ids.size < 1:
            raise MXNetError("a prompt needs at least one token")
        vocab = self.model_config["vocab_size"]
        if token_ids.min() < 0 or token_ids.max() >= vocab:
            raise MXNetError("prompt token ids must lie in [0, %d), got "
                             "%d..%d" % (vocab, token_ids.min(),
                                         token_ids.max()))
        return token_ids, self.bucket_for(token_ids.size)

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

    @contextlib.contextmanager
    def _dispatch(self):
        """The model's forward with the committed parameters, under the
        policy's scope and without autograd."""
        with torch.inference_mode(), _dtp.scope(self._dtype_policy), \
                _block.swapped_params(self._gluon_params, self._params):
            yield

    def _sample(self, logits):
        if self._dtype_policy is not None:
            logits = self._dtype_policy.cast_output(logits)
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
        out = {}
        for slot in np.nonzero(self._active)[0]:
            slot = int(slot)
            tok = int(toks[slot])
            out[slot] = tok
            self._cur_tok[slot] = tok
            self._pos[slot] += 1
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

    def at_capacity(self, slot):
        """True when ``slot`` exhausted the model's positions (the
        ``length`` eviction the server applies): the ring slides past
        ``cache_len``, but learned positions end at ``max_len``."""
        return self._pos[slot] >= self.model_config["max_len"]

    def prewarm(self):
        """Nothing to compile ahead here (no AOT store in the port):
        returns the JAX engine's answer without one."""
        return [{"label": "generate", "status": "disabled"}]


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
                 "out", "slot", "ttft", "on_token")

    def __init__(self, tokens, deadline, max_new, on_token=None):
        self.tokens = tokens
        self.future = None
        self.deadline = deadline
        self.t_submit = time.monotonic()
        self.max_new = max_new
        self.out = []
        self.slot = None
        self.ttft = None
        self.on_token = on_token   # streaming observer


class TokenServer:
    """Continuous-batching token front end over one
    :class:`GenerationEngine`.

    ``submit`` admits a prompt through a bounded queue and returns a
    :class:`ServingFuture` resolving to a :class:`GenerationResult`.  A
    worker thread (pinned to the engine's device) admits queued prompts
    into free slots (prefill), steps every active slot one token per
    tick, and evicts on EOS, deadline, length cap or cancellation:

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
            raise MXNetError("TokenServer(slo_ms=...) shedding needs the "
                             "TTFT histogram, which is not ported yet")
        self._engine = engine
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
        with self._cond:
            while True:
                err = self._admission_error_locked(deadline,
                                                   time.monotonic())
                if err is None:
                    break
                blockable = isinstance(err, Overloaded) and \
                    err.reason == "queue"
                if not block or not blockable:
                    raise err
                remaining = None
                if wait_until is not None:
                    remaining = wait_until - time.monotonic()
                    if remaining <= 0:
                        raise err
                self._cond.wait(remaining if remaining is not None
                                else 0.1)
            req = _GenRequest(token_ids, deadline, max_new,
                              on_token=on_token)
            req.future = ServingFuture(owner=self, req=req)
            self._queue.append(req)
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
            if resolved and req.slot is None and req in self._queue:
                self._queue.remove(req)
            self._cond.notify_all()
            return resolved

    # -- the decode loop -------------------------------------------------

    def _finish(self, req, reason):
        req.future._resolve(result=GenerationResult(
            tokens=list(req.out), finish_reason=reason, ttft_s=req.ttft))

    def _fail(self, req, exc):
        req.future._resolve(exc=exc)

    def _admit_locked_pop(self):
        """Pop the next admissible queued request (failing expired ones,
        typed) — the caller holds the lock."""
        now = time.monotonic()
        while self._queue:
            req = self._queue.popleft()
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
                toks = self._engine.decode_step()
                for slot, tok in toks.items():
                    with self._cond:
                        req = self._by_slot.get(slot)
                    if req is None:
                        self._engine.evict(slot, "cancelled")
                        continue
                    self._deliver(req, slot, tok)
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
            self._cond.notify_all()
        for req in victims:
            if not req.future.done():
                req.future._resolve(exc=Cancelled(
                    "token server shut down before completion"))
            if req.slot is not None and worker_gone:
                # a worker stuck in a device call could still race the
                # lane; leave it active then rather than double-free it
                self._engine.evict(req.slot, "drain")

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
