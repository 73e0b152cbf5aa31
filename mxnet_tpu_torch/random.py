"""Framework random stream (parity: mxnet_tpu/random.py, mx.random.seed
and the samplers of :110-159).

One explicit ``torch.Generator`` per device, all reseeded by ``seed``
(or one of them, given ``ctx``).  Samplers in the port (``uniform``,
``normal``, ... below, the initializers, token sampling) draw from the
generator of the device they write to, never from torch's global default
generator.  The samplers return NDArrays on ``ctx`` (default: the
current context, ``gpu(0)``).  ``host_rng`` is a numpy ``RandomState``
seeded by ``seed`` too, for the host-side samplers (the DGL graph ops).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

__all__ = ["seed", "generator", "next_key", "host_rng", "uniform", "normal",
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
