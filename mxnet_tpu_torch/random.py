"""Framework random stream (parity: mxnet_tpu/random.py, mx.random.seed
and the samplers of :110-159).

One explicit ``torch.Generator`` per device, all reseeded by ``seed``
(or one of them, given ``ctx``).  Samplers in the port (``uniform``,
``normal``, ... below, the initializers, token sampling) draw from the
generator of the device they write to, never from torch's global default
generator.  The samplers return NDArrays on ``ctx`` (default: the
current context, ``gpu(0)``).  ``host_rng`` is a numpy ``RandomState``
seeded by ``seed`` too, for the host-side samplers (the DGL graph ops).

``get_key_data`` / ``set_key_data`` (parity: mxnet_tpu/random.py:84-105)
snapshot and restore the whole stream as one uint8 numpy array: every
device generator ``generator`` made, the host ``RandomState`` and torch's
default generators (which a compiled graph draws from).  A checkpoint
carries it as the trainer's ``"rng"`` array, so a resumed run draws the
same numbers as one that was never stopped.  JAX's key (two uint32
words) is a different thing and is refused here.
"""
from __future__ import annotations

import json
import threading
import warnings

import numpy as np
import torch

__all__ = ["seed", "generator", "next_key", "host_rng", "get_key_data",
           "set_key_data", "uniform", "normal",
           "randint", "randn", "exponential", "gamma", "poisson",
           "negative_binomial", "generalized_negative_binomial", "shuffle",
           "multinomial"]

_state = threading.local()


def _st():
    if not hasattr(_state, "seed"):
        _state.seed = 0
        _state.gens = {}
    return _state


def _key(device):
    device = torch.device(device)
    return device, (device.type, device.index or 0)


def seed(seed_state, ctx="all"):
    """Reseed every device's generator, or only ``ctx``'s (parity:
    mx.random.seed)."""
    st = _st()
    st.np_seed = int(seed_state)
    st.np_rng = None
    if ctx == "all":
        st.seed = int(seed_state)
        st.gens = {}
        # a compiled graph draws from torch's default generators
        torch.manual_seed(int(seed_state))
        return
    device, key = _key(ctx.torch_device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_state))
    st.gens[key] = gen


def generator(device):
    """The generator for ``device`` (a torch.device), made on first use."""
    st = _st()
    device, key = _key(device)
    gen = st.gens.get(key)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(st.seed)
        st.gens[key] = gen
    return gen


def host_rng():
    """A numpy ``RandomState`` seeded by the last ``seed`` (0 before any;
    parity: mxnet_tpu/random.py:40), made anew by each ``seed``."""
    st = _st()
    if getattr(st, "np_rng", None) is None:
        st.np_rng = np.random.RandomState(getattr(st, "np_seed", 0))
    return st.np_rng


def next_key(device):
    """The framework stream for a draw on ``device`` (parity:
    mxnet_tpu/random.py ``next_key``).  JAX splits a fresh key off its
    global key per draw; a ``torch.Generator`` advances its own state as
    it draws, so the stream's next key is the device's generator itself.
    Draws are reproducible under ``seed``, not equal to JAX's."""
    return generator(device)


# ---- checkpointable snapshot of the stream ------------------------------

_KEY_MAGIC = b"MXTRNG01"


def _device_name(key):
    kind, index = key
    return kind if kind == "cpu" else "%s:%d" % (kind, index)


def _default_states():
    """torch's default generators: the CPU's, and each CUDA device's
    once CUDA is initialized (reading them initializes nothing)."""
    out = [("cpu", torch.random.default_generator.get_state())]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            out.append(("cuda:%d" % i, torch.cuda.get_rng_state(i)))
    return out


def get_key_data():
    """The framework's random stream as one uint8 numpy array (parity:
    mxnet_tpu/random.py ``get_key_data``): the seed, every device
    generator made so far, the host ``RandomState`` and torch's default
    generators.  :func:`set_key_data` of it resumes every draw sequence
    exactly."""
    st = _st()
    head = {"seed": int(st.seed),
            "np_seed": int(getattr(st, "np_seed", 0)),
            "gens": [], "default": [], "host": None}
    parts = []

    def add(state):
        raw = state.cpu().numpy().tobytes()
        parts.append(raw)
        return len(raw)

    for key, gen in sorted(st.gens.items()):
        head["gens"].append({"device": _device_name(key),
                             "n": add(gen.get_state())})
    for dev, state in _default_states():
        head["default"].append({"device": dev, "n": add(state)})
    rng = getattr(st, "np_rng", None)
    if rng is not None:
        name, keys, pos, has_gauss, cached = rng.get_state()
        raw = np.ascontiguousarray(keys, dtype=np.uint32).tobytes()
        parts.append(raw)
        head["host"] = {"name": name, "n": len(raw), "pos": int(pos),
                        "has_gauss": int(has_gauss),
                        "cached": float(cached)}
    hb = json.dumps(head, sort_keys=True).encode()
    blob = _KEY_MAGIC + len(hb).to_bytes(4, "little") + hb + b"".join(parts)
    return np.frombuffer(blob, np.uint8).copy()


def _unpack(data):
    data = np.asarray(data)
    if data.dtype != np.uint8 or data.ndim != 1 or \
            data[:len(_KEY_MAGIC)].tobytes() != _KEY_MAGIC:
        raise ValueError(
            "not a mxnet_tpu_torch random-stream snapshot (dtype %s, shape "
            "%s); a JAX PRNG key cannot seed torch generators"
            % (data.dtype, data.shape))
    raw = data.tobytes()
    at = len(_KEY_MAGIC)
    n = int.from_bytes(raw[at:at + 4], "little")
    head = json.loads(raw[at + 4:at + 4 + n].decode())
    return head, raw, at + 4 + n


def set_key_data(data):
    """Restore the stream from :func:`get_key_data`'s array (parity:
    mxnet_tpu/random.py ``set_key_data``).  A generator of a device this
    process cannot reach is skipped with a warning."""
    head, raw, at = _unpack(data)
    chunks = []
    for entry in head["gens"] + head["default"]:
        chunks.append(torch.frombuffer(bytearray(raw[at:at + entry["n"]]),
                                       dtype=torch.uint8))
        at += entry["n"]
    host = head.get("host")
    host_keys = None
    if host is not None:
        host_keys = np.frombuffer(raw[at:at + host["n"]], np.uint32).copy()
    st = _st()
    st.seed = int(head["seed"])
    st.np_seed = int(head["np_seed"])
    gens = {}
    it = iter(chunks)
    for entry in head["gens"]:
        state = next(it)
        device = torch.device(entry["device"])
        if device.type == "cuda" and not torch.cuda.is_available():
            warnings.warn("random stream: the snapshot's generator of %s is "
                          "not restored (no such device here)"
                          % entry["device"], stacklevel=2)
            continue
        gen = torch.Generator(device=device)
        gen.set_state(state)
        gens[_key(device)[1]] = gen
    st.gens = gens
    for entry in head["default"]:
        state = next(it)
        if entry["device"] == "cpu":
            torch.random.default_generator.set_state(state)
        elif torch.cuda.is_available() and \
                torch.device(entry["device"]).index < \
                torch.cuda.device_count():
            torch.cuda.set_rng_state(state, entry["device"])
    if host is None:
        st.np_rng = None     # made from np_seed at its first use
    else:
        rng = np.random.RandomState()
        rng.set_state((host["name"], host_keys, host["pos"],
                       host["has_gauss"], host["cached"]))
        st.np_rng = rng


# ---- samplers returning NDArrays (parity: mxnet_tpu/random.py:110-159) ----

def _sample(op_name, ctx, out, **attrs):
    from .ndarray.ndarray import _invoke_nd

    return _invoke_nd(op_name, [], dict(attrs, ctx=ctx), out=out)


def uniform(low=0, high=1, shape=(1,), dtype="float32", ctx=None, out=None):
    return _sample("_random_uniform", ctx, out, low=low, high=high,
                   shape=shape, dtype=dtype)


def normal(loc=0, scale=1, shape=(1,), dtype="float32", ctx=None, out=None):
    return _sample("_random_normal", ctx, out, loc=loc, scale=scale,
                   shape=shape, dtype=dtype)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None):
    return _sample("_random_randint", ctx, out, low=low, high=high,
                   shape=shape, dtype=dtype)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None):
    return normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                  ctx=ctx)


def exponential(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    return _sample("_random_exponential", ctx, out, lam=lam, shape=shape,
                   dtype=dtype)


def gamma(alpha=1.0, beta=1.0, shape=(1,), dtype="float32", ctx=None,
          out=None):
    return _sample("_random_gamma", ctx, out, alpha=alpha, beta=beta,
                   shape=shape, dtype=dtype)


def poisson(lam=1.0, shape=(1,), dtype="float32", ctx=None, out=None):
    return _sample("_random_poisson", ctx, out, lam=lam, shape=shape,
                   dtype=dtype)


def negative_binomial(k=1, p=1.0, shape=(1,), dtype="float32", ctx=None,
                      out=None):
    return _sample("_random_negative_binomial", ctx, out, k=k, p=p,
                   shape=shape, dtype=dtype)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(1,),
                                  dtype="float32", ctx=None, out=None):
    return _sample("_random_generalized_negative_binomial", ctx, out, mu=mu,
                   alpha=alpha, shape=shape, dtype=dtype)


def shuffle(data, out=None):
    """The rows of ``data`` in a random order, on its device."""
    from .ndarray.ndarray import _invoke_nd

    return _invoke_nd("_shuffle", [data], {}, out=out)


def multinomial(data, shape=(), get_prob=False, out=None, dtype="int32"):
    """Category draws from the probabilities of ``data``'s last axis."""
    from .ndarray.ndarray import _invoke_nd

    return _invoke_nd("_sample_multinomial", [data],
                      {"shape": shape, "get_prob": get_prob, "dtype": dtype},
                      out=out)
