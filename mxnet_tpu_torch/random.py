"""Framework random stream (parity: mxnet_tpu/random.py, mx.random.seed).

One explicit ``torch.Generator`` per device, all reseeded by ``seed``.
Samplers in the port (the initializers, token sampling) draw from the
generator of the device they write to, never from torch's global default
generator.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "next_key"]

_state = threading.local()


def _st():
    if not hasattr(_state, "seed"):
        _state.seed = 0
        _state.gens = {}
    return _state


def seed(seed_state, ctx="all"):
    """Reseed every device's generator (parity: mx.random.seed)."""
    st = _st()
    st.seed = int(seed_state)
    st.gens = {}


def generator(device):
    """The generator for ``device`` (a torch.device), made on first use."""
    st = _st()
    device = torch.device(device)
    key = (device.type, device.index or 0)
    gen = st.gens.get(key)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(st.seed)
        st.gens[key] = gen
    return gen


def next_key(device):
    """The framework stream for a draw on ``device`` (parity:
    mxnet_tpu/random.py ``next_key``).  JAX splits a fresh key off its
    global key per draw; a ``torch.Generator`` advances its own state as
    it draws, so the stream's next key is the device's generator itself.
    Draws are reproducible under ``seed``, not equal to JAX's."""
    return generator(device)
