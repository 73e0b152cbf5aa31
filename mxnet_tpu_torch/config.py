"""Environment knobs of the port (parity: mxnet_tpu/config.py).

Only the knobs the ported modules read are here, with the JAX package's
names, defaults and parsing; the rest arrive with their users.
"""
from __future__ import annotations

import os
import warnings

__all__ = ["get", "FLAGS"]


def _pint(v):
    return int(v)


def _pbool(v):
    return str(v).lower() in ("1", "true", "yes", "on")


def _pfloat(v):
    return float(v)


# name -> (default, parser, note)
FLAGS = {
    "MXNET_DTYPE_POLICY": (
        "", str,
        "default mixed-precision dtype policy of ShardedTrainer: '' or "
        "'f32' = f32, 'bf16_mixed', 'bf16_pure', or a "
        "dtype_policy.register_policy addition"),
    "MXNET_LOSS_SCALE": (
        "65536", _pfloat,
        "initial dynamic loss scale of loss-scaling policies (bf16_mixed)"),
    "MXNET_LOSS_SCALE_GROWTH_INTERVAL": (
        "2000", _pint,
        "consecutive finite steps before the loss scale doubles"),
    "MXNET_LOSS_SCALE_BACKOFF": (
        "0.5", _pfloat,
        "multiplier of the loss scale on an overflowed (skipped) step"),
    "MXNET_LOSS_SCALE_MAX": (
        "16777216", _pfloat, "upper bound of the loss scale (2^24)"),
    "MXNET_ASYNC_METRICS": (
        "0", _pbool,
        "non-blocking train-step metrics: step() never reads the loss on "
        "the host; a background thread fetches the accumulator"),
    "MXNET_STEPS_PER_CALL": (
        "1", _pint, "steps per ShardedTrainer.step_many call"),
    "MXNET_NONFINITE_POLICY": (
        "warn", str,
        "step guard for NaN/Inf losses: off|warn|skip|raise"),
    "MXNET_DECODE_SLOTS": (
        "8", _pint,
        "generate.GenerationEngine default decode slots: the fixed batch "
        "width of the decode step (one KV-cache lane per slot)"),
    "MXNET_DECODE_CACHE_LEN": (
        "256", _pint,
        "default KV-cache ring length per slot (capped at the model's "
        "max_len); generation past the ring attends over a sliding "
        "window"),
    "MXNET_DECODE_BUCKETS": (
        "32,64,128,256", str,
        "comma list of prefill length buckets: a prompt pads up to the "
        "smallest bucket >= its length"),
    "MXNET_DECODE_QUEUE": (
        "64", _pint,
        "generate.TokenServer admission-queue depth: a full queue rejects "
        "with the typed Overloaded('queue') error"),
    "MXNET_DECODE_DEADLINE_MS": (
        "0", _pfloat,
        "default per-request decode deadline (0 = none): an expired "
        "request fails with DeadlineExceeded(stage='prefill'|'decode') "
        "and its cache slot is evicted (reason 'deadline')"),
    "MXNET_DECODE_MAX_NEW": (
        "128", _pint,
        "default cap on generated tokens per request (finish_reason "
        "'length'); submit's max_new_tokens= overrides"),
}

_warned = set()


def get(name):
    """Parsed value of a registered flag (env overrides default)."""
    default, parser, _note = FLAGS[name]
    raw = os.environ.get(name, default)
    try:
        return parser(raw)
    except (TypeError, ValueError):
        if name not in _warned:
            _warned.add(name)
            warnings.warn("invalid value %r for %s; using default %r"
                          % (raw, name, default))
        return parser(default)
