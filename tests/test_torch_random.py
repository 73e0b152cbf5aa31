"""``mx.random`` and the random registry ops of the port, on the CPU.

The port's draws come from each device's own ``torch.Generator``, so
they are held to their distributions and to reseed reproducibility, not
to the JAX package's bits: 2^16 draws a sampler, the sample mean and
variance within 6 standard errors of the analytic ones (the variance's
standard error from the sample's fourth moment); a reseed repeats the
draws bit for bit; torch's global generator plays no part.  Each of the
29 names of ops/random_ops.py is its own case, giving the JAX op's shape
and dtype.  A hybridized block that samples compiles and runs (upstream
MXNet runs it; the JAX package cannot trace its key), drawing from
torch's default generator, which ``mx.random.seed`` seeds.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg

N = 1 << 16
SE = 6.0
CPU = tmx.cpu()


def _moments_ok(x, mean, var):
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    m = x.mean()
    assert abs(m - mean) <= SE * math.sqrt(var / n), (m, mean)
    dev2 = (x - m) ** 2
    se_var = dev2.std() / math.sqrt(n)
    assert abs(dev2.mean() - var) <= SE * se_var, (dev2.mean(), var)


SAMPLERS = [
    ("uniform", lambda s: tmx.random.uniform(-1.0, 3.0, shape=s, ctx=CPU),
     1.0, 16.0 / 12),
    ("normal", lambda s: tmx.random.normal(0.5, 2.0, shape=s, ctx=CPU),
     0.5, 4.0),
    ("randint", lambda s: tmx.random.randint(-3, 7, shape=s, ctx=CPU),
     1.5, (10 ** 2 - 1) / 12.0),
    ("randn", lambda s: tmx.random.randn(*s, loc=1.0, scale=0.5, ctx=CPU),
     1.0, 0.25),
    ("exponential", lambda s: tmx.random.exponential(2.0, shape=s, ctx=CPU),
     0.5, 0.25),
    ("gamma", lambda s: tmx.random.gamma(2.5, 1.5, shape=s, ctx=CPU),
     2.5 * 1.5, 2.5 * 1.5 ** 2),
    ("gamma_small", lambda s: tmx.random.gamma(0.4, 1.0, shape=s, ctx=CPU),
     0.4, 0.4),
    ("poisson", lambda s: tmx.random.poisson(3.5, shape=s, ctx=CPU),
     3.5, 3.5),
    ("negative_binomial",
     lambda s: tmx.random.negative_binomial(3, 0.4, shape=s, ctx=CPU),
     3 * 0.6 / 0.4, 3 * 0.6 / 0.4 ** 2),
    ("generalized_negative_binomial",
     lambda s: tmx.random.generalized_negative_binomial(
         2.0, 0.5, shape=s, ctx=CPU), 2.0, 2.0 + 0.5 * 4.0),
]


@pytest.mark.parametrize("name,draw,mean,var", SAMPLERS,
                         ids=[s[0] for s in SAMPLERS])
def test_sampler_moments_and_reseed(name, draw, mean, var):
    tmx.random.seed(11)
    x = draw((N,))
    assert x.shape == (N,) and x.context == CPU
    _moments_ok(x.asnumpy(), mean, var)
    tmx.random.seed(11)
    torch.manual_seed(123)      # the global generator plays no part
    np.testing.assert_array_equal(draw((N,)).asnumpy(), x.asnumpy())
    assert not np.array_equal(draw((N,)).asnumpy(), x.asnumpy())


def test_randint_range_and_dtype():
    tmx.random.seed(0)
    x = tmx.random.randint(2, 5, shape=(4096,), ctx=CPU)
    assert x.dtype == np.int32
    assert set(np.unique(x.asnumpy())) == {2, 3, 4}


def test_seed_one_device_leaves_the_others():
    tmx.random.seed(5)
    a = tmx.random.uniform(shape=(8,), ctx=CPU).asnumpy()
    tmx.random.seed(5, ctx=CPU)
    np.testing.assert_array_equal(
        tmx.random.uniform(shape=(8,), ctx=CPU).asnumpy(), a)


def test_shuffle_permutes_rows():
    tmx.random.seed(3)
    data = tmx.nd.array(np.arange(40, dtype=np.float32).reshape(20, 2),
                        ctx=CPU)
    out = tmx.random.shuffle(data).asnumpy()
    assert not np.array_equal(out, data.asnumpy())
    np.testing.assert_array_equal(out[np.argsort(out[:, 0])],
                                  data.asnumpy())
    tmx.random.seed(3)
    np.testing.assert_array_equal(tmx.random.shuffle(data).asnumpy(), out)


def test_multinomial_frequencies():
    p = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    tmx.random.seed(2)
    out = tmx.random.multinomial(tmx.nd.array(p, ctx=CPU),
                                 shape=(N // 4,)).asnumpy()
    assert out.shape == (2, N // 4) and out.dtype == np.int32
    for row, probs in zip(out, p):
        freq = np.bincount(row, minlength=3) / row.size
        se = np.sqrt(probs * (1 - probs) / row.size)
        assert np.all(np.abs(freq - probs) <= SE * se), (freq, probs)
    one = tmx.random.multinomial(tmx.nd.array(p[0], ctx=CPU))
    assert one.shape == () and 0 <= int(one.asscalar()) < 3


def test_sample_rowwise_ops():
    lo = tmx.nd.array(np.array([0.0, 10.0], np.float32), ctx=CPU)
    hi = tmx.nd.array(np.array([1.0, 14.0], np.float32), ctx=CPU)
    tmx.random.seed(4)
    u = tmx.nd._sample_uniform(lo, hi, shape=(N // 2,)).asnumpy()
    assert u.shape == (2, N // 2)
    _moments_ok(u[0], 0.5, 1 / 12.0)
    _moments_ok(u[1], 12.0, 16 / 12.0)
    z = tmx.nd._sample_normal(lo, hi, shape=(N // 2,)).asnumpy()
    _moments_ok(z[0], 0.0, 1.0)
    _moments_ok(z[1], 10.0, 196.0)


def test_unique_zipfian():
    tmx.random.seed(6)
    samples, tries = tmx.nd._sample_unique_zipfian(range_max=50,
                                                   shape=(4, 10), ctx=CPU)
    s = samples.asnumpy()
    assert s.shape == (4, 10) and tries.shape == (4,)
    assert all(len(set(row)) == 10 for row in s)
    assert s.min() >= 0 and s.max() < 50
    assert np.all(tries.asnumpy() >= 10)


RANDOM_NAMES = sorted(n for n in jreg.list_ops()
                      if getattr(jreg.get_op(n).fn, "__module__", "")
                      == "mxnet_tpu.ops.random_ops")
_ARGS = {
    "_random_uniform": {"low": 0.0, "high": 2.0},
    "_random_normal": {"loc": 1.0, "scale": 2.0},
    "_random_randint": {"low": 0, "high": 9},
    "_random_exponential": {"lam": 2.0},
    "_random_gamma": {"alpha": 2.0, "beta": 1.0},
    "_random_poisson": {"lam": 3.0},
    "_random_negative_binomial": {"k": 2, "p": 0.5},
    "_random_generalized_negative_binomial": {"mu": 2.0, "alpha": 0.5},
}


def test_all_random_names_registered():
    assert len(RANDOM_NAMES) == 29
    assert set(RANDOM_NAMES) <= set(treg.list_ops())


@pytest.mark.parametrize("name", RANDOM_NAMES)
def test_random_op_shape_and_dtype_match_jax(name):
    canonical = treg.get_op(name).name
    assert jreg.get_op(name).name == canonical
    if canonical in _ARGS:
        attrs = dict(_ARGS[canonical], shape=(3, 5))
        tout = getattr(tmx.nd, name)(ctx=CPU, **attrs)
        jout = getattr(jmx.nd, name)(**attrs)
    elif canonical == "_sample_multinomial":
        p = np.array([[0.2, 0.8], [0.6, 0.4]], np.float32)
        tout = getattr(tmx.nd, name)(tmx.nd.array(p, ctx=CPU), shape=(3,))
        jout = getattr(jmx.nd, name)(jmx.nd.array(p), shape=(3,))
    elif canonical == "_shuffle":
        d = np.arange(12, dtype=np.float32).reshape(6, 2)
        tout = getattr(tmx.nd, name)(tmx.nd.array(d, ctx=CPU))
        jout = getattr(jmx.nd, name)(jmx.nd.array(d))
        np.testing.assert_array_equal(np.sort(tout.asnumpy(), 0), d)
    elif canonical in ("_sample_uniform", "_sample_normal"):
        a, b = np.zeros(2, np.float32), np.ones(2, np.float32)
        tout = getattr(tmx.nd, name)(tmx.nd.array(a, ctx=CPU),
                                     tmx.nd.array(b, ctx=CPU), shape=(4,))
        jout = getattr(jmx.nd, name)(jmx.nd.array(a), jmx.nd.array(b),
                                     shape=(4,))
    else:
        assert canonical == "_sample_unique_zipfian"
        tout = getattr(tmx.nd, name)(range_max=20, shape=(2, 5), ctx=CPU)
        jout = getattr(jmx.nd, name)(range_max=20, shape=(2, 5))
    touts = tout if isinstance(tout, list) else [tout]
    jouts = jout if isinstance(jout, list) else [jout]
    assert [(o.shape, o.dtype) for o in touts] == \
        [(o.shape, o.dtype) for o in jouts]


def test_hybridized_block_samples(monkeypatch):
    """F.random_uniform inside hybrid_forward: the compiled call runs and
    gives the eager call's shape and dtype; mx.random.seed makes the eager
    draws repeat and reseeds the compiled graph's generator too.  No bits
    are held to the JAX package, whose generator differs and which cannot
    compile the block."""
    from mxnet_tpu_torch.gluon import HybridBlock

    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")

    class Noisy(HybridBlock):
        def hybrid_forward(self, F, x):
            return x + F.random_uniform(low=-1.0, high=1.0, shape=(2, 3))

    with CPU:
        net = Noisy()
        net.initialize()
        x = tmx.nd.zeros((2, 3))
        tmx.random.seed(7)
        eager = net(x).asnumpy()
        tmx.random.seed(7)
        assert np.array_equal(net(x).asnumpy(), eager)
        net.hybridize()
        tmx.random.seed(7)
        first = net(x)
        tmx.random.seed(7)
        again = net(x).asnumpy()
    got = first.asnumpy()
    assert got.shape == eager.shape == (2, 3) and got.dtype == eager.dtype
    assert np.isfinite(got).all() and (np.abs(got) <= 1.0).all()
    assert np.array_equal(got, again)
