"""Random sampling ops (parity: mxnet_tpu/ops/random_ops.py; reference
src/operator/random/sample_op.cc, multisample_op.cc, shuffle_op.cc).

Each draws from the generator of the device it writes to
(``random.generator``), never from torch's global one, so
``mx.random.seed`` makes a run repeat.  In a compiled (hybridized)
graph, which cannot take an explicit generator, they draw from torch's
default generator of the device, which ``mx.random.seed`` seeds too (as
Dropout does, ``ops/nn.py``).  Draws are held to their
distributions, not to the JAX package's bits.  The negative binomials
are gamma-Poisson mixtures, as there.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register
from .utils import pint, pfloat, ptuple, pdtype
from .. import random as _random


def _shape(shape):
    return ptuple(shape, default=(1,)) or (1,)


def _gen(device):
    # a compiled graph draws from torch's default generator; a meta
    # tensor (a symbol's shape inference) draws nothing
    if torch.compiler.is_compiling() or (
            device is not None and torch.device(device).type == "meta"):
        return None
    return _random.generator(device)


def _gamma(alpha, shape, device, gen):
    """Gamma(alpha, 1) draws; ``alpha`` a number or a tensor of
    ``shape``."""
    conc = alpha if isinstance(alpha, torch.Tensor) \
        else torch.full(shape, float(alpha), device=device)
    return torch._standard_gamma(conc, generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam, generator=gen)


@register("_random_uniform", uses_rng=True, num_inputs=0,
          differentiable=False, aliases=("uniform", "random_uniform"))
def _uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
             **kw):
    out = torch.empty(_shape(shape), dtype=pdtype(dtype), device=ctx)
    return out.uniform_(pfloat(low, 0.0), pfloat(high, 1.0),
                        generator=_gen(ctx))


@register("_random_normal", uses_rng=True, num_inputs=0,
          differentiable=False, aliases=("normal", "random_normal"))
def _normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
            **kw):
    out = torch.empty(_shape(shape), dtype=pdtype(dtype), device=ctx)
    return out.normal_(pfloat(loc, 0.0), pfloat(scale, 1.0),
                       generator=_gen(ctx))


@register("_random_randint", uses_rng=True, num_inputs=0,
          differentiable=False, aliases=("random_randint",))
def _randint(low=0, high=1, shape=None, dtype="int32", ctx=None, **kw):
    return torch.randint(pint(low, 0), pint(high, 1), _shape(shape),
                         generator=_gen(ctx), dtype=pdtype(dtype),
                         device=ctx)


@register("_random_exponential", uses_rng=True, num_inputs=0,
          differentiable=False,
          aliases=("random_exponential", "exponential"))
def _exponential(lam=1.0, shape=None, dtype="float32", ctx=None, **kw):
    out = torch.empty(_shape(shape), dtype=pdtype(dtype), device=ctx)
    return out.exponential_(pfloat(lam, 1.0), generator=_gen(ctx))


@register("_random_gamma", uses_rng=True, num_inputs=0,
          differentiable=False, aliases=("random_gamma",))
def _gamma_op(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
              **kw):
    g = _gamma(pfloat(alpha, 1.0), _shape(shape), ctx, _gen(ctx))
    return (g * pfloat(beta, 1.0)).to(pdtype(dtype))


@register("_random_poisson", uses_rng=True, num_inputs=0,
          differentiable=False, aliases=("random_poisson", "poisson"))
def _poisson_op(lam=1.0, shape=None, dtype="float32", ctx=None, **kw):
    lam = torch.full(_shape(shape), pfloat(lam, 1.0), device=ctx)
    return _poisson(lam, _gen(ctx)).to(pdtype(dtype))


@register("_random_negative_binomial", uses_rng=True, num_inputs=0,
          differentiable=False,
          aliases=("random_negative_binomial", "negative_binomial"))
def _neg_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None, **kw):
    """Failures before the k-th success at success rate p: Poisson of a
    Gamma(k, (1 - p) / p) rate."""
    gen, p = _gen(ctx), pfloat(p, 1.0)
    lam = _gamma(pint(k, 1), _shape(shape), ctx, gen) * (1.0 - p) / p
    return _poisson(lam, gen).to(pdtype(dtype))


@register("_random_generalized_negative_binomial", uses_rng=True,
          num_inputs=0, differentiable=False,
          aliases=("random_generalized_negative_binomial",
                   "generalized_negative_binomial"))
def _gen_neg_binomial(mu=1.0, alpha=1.0, shape=None, dtype="float32",
                      ctx=None, **kw):
    """Mean mu, variance mu + alpha mu^2: Poisson of a
    Gamma(1 / alpha, mu alpha) rate."""
    gen = _gen(ctx)
    mu, alpha = pfloat(mu, 1.0), pfloat(alpha, 1.0)
    lam = _gamma(1.0 / alpha, _shape(shape), ctx, gen) * (mu * alpha)
    return _poisson(lam, gen).to(pdtype(dtype))


@register("_sample_multinomial", uses_rng=True, num_inputs=1,
          differentiable=False, aliases=("sample_multinomial",))
def _multinomial(data, shape=None, get_prob=False, dtype="int32", **kw):
    """Category indices drawn from the (unnormalized) probabilities of
    ``data``'s last axis: ``shape`` draws per row (one, squeezed, when
    ``shape`` is empty)."""
    s = ptuple(shape, default=()) or ()
    n = int(np.prod(s)) if s else 1
    probs = torch.clamp(data, min=1e-30).reshape(-1, data.shape[-1])
    out = torch.multinomial(probs, n, replacement=True,
                            generator=_gen(data.device))
    out = out.reshape(tuple(data.shape[:-1]) + s)
    return out.to(pdtype(dtype))


@register("_shuffle", uses_rng=True, num_inputs=1, differentiable=False,
          aliases=("shuffle",))
def _shuffle(data, **kw):
    """The rows of ``data`` in a random order."""
    perm = torch.randperm(data.shape[0], generator=_gen(data.device),
                          device=data.device)
    return data[perm]


def _rowwise(param, s):
    """``param`` with ``s``'s axes appended, to broadcast over draws."""
    return param.reshape(tuple(param.shape) + (1,) * len(s)) if s else param


@register("_sample_uniform", uses_rng=True, num_inputs=2,
          differentiable=False)
def _sample_uniform(low, high, shape=None, dtype="float32", **kw):
    """One uniform draw (``shape`` draws) per element of ``low``/``high``."""
    s = ptuple(shape, default=()) or ()
    u = torch.empty(tuple(low.shape) + s, dtype=pdtype(dtype),
                    device=low.device).uniform_(generator=_gen(low.device))
    lo = _rowwise(low, s)
    return lo + u * (_rowwise(high, s) - lo)


@register("_sample_normal", uses_rng=True, num_inputs=2,
          differentiable=False)
def _sample_normal(mu, sigma, shape=None, dtype="float32", **kw):
    """One normal draw (``shape`` draws) per element of ``mu``/``sigma``."""
    s = ptuple(shape, default=()) or ()
    z = torch.empty(tuple(mu.shape) + s, dtype=pdtype(dtype),
                    device=mu.device).normal_(generator=_gen(mu.device))
    return _rowwise(mu, s) + z * _rowwise(sigma, s)


@register("_sample_unique_zipfian", uses_rng=True, num_inputs=0,
          num_outputs=2, differentiable=False)
def _sample_unique_zipfian(range_max=None, shape=None, ctx=None, **kw):
    """(samples (B, N), tries (B,)), int32: N distinct classes a row drawn
    without replacement from P(k) = (log(k+2) - log(k+1)) / log(range_max
    + 1), and the draws each row took.  The loop's trip count depends on
    the draws, so it runs on the host from a seed drawn on the device's
    generator, as the JAX op does."""
    s = ptuple(shape)
    if s is None or len(s) != 2:
        raise ValueError("_sample_unique_zipfian needs a 2-D shape, got %r"
                         % (s,))
    b, n = s
    rmax = pint(range_max, 0)
    if n > rmax:
        raise ValueError("cannot draw %d unique samples from %d classes"
                         % (n, rmax))
    seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=_gen(ctx),
                             device=ctx).item())
    rng = np.random.RandomState(seed)
    log_rm1 = np.log(rmax + 1.0)
    samples = np.empty((b, n), np.int32)
    tries = np.empty((b,), np.int32)
    for i in range(b):
        seen = set()
        t = 0
        while len(seen) < n:
            v = (int(np.exp(rng.random_sample() * log_rm1)) - 1) % rmax
            t += 1
            if v not in seen:
                samples[i, len(seen)] = v
                seen.add(v)
        tries[i] = t
    return (torch.as_tensor(samples, device=ctx),
            torch.as_tensor(tries, device=ctx))
