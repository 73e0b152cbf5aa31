"""The port's DCGAN example (mxnet_tpu_torch/examples/dcgan.py) against
examples/dcgan.py on the CPU: from the same numpy weights (the JAX
example's ``Normal(0.02)`` swapped for ``init.Load`` of them) and the
same data stream, the first 3 steps' D and G losses agree within 1e-4
relative (two Adam Trainers, training-mode BatchNorm and the
``detach()`` of the fake batch, in f32).  Each epoch runs one step, so
the examples' per-epoch means are the per-step losses."""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.examples import dcgan as tdcgan

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import dcgan as jdcgan  # noqa: E402

STEPS, BATCH, REL = 3, 8, 1e-4


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _weights():
    """Normal(0.02) weights for every conv of both networks, by the names
    the examples give them in a fresh name scope."""
    with tmx.name.NameManager():
        gen, disc = tdcgan.build_generator(), tdcgan.build_discriminator()
    gen.initialize(tmx.init.Zero(), ctx=tmx.cpu())
    disc.initialize(tmx.init.Zero(), ctx=tmx.cpu())
    gen(tmx.nd.zeros((1, 16, 1, 1), ctx=tmx.cpu()))
    disc(tmx.nd.zeros((1, 1, 16, 16), ctx=tmx.cpu()))
    rng = np.random.RandomState(3)
    params = list(gen.collect_params().items()) \
        + list(disc.collect_params().items())
    return {n: (rng.randn(*p.shape) * 0.02).astype(np.float32)
            for n, p in params if n.endswith("_weight")}


def test_dcgan_losses_match_the_jax_example(monkeypatch):
    weights = _weights()
    assert len(weights) == 6
    normal = jmx.init.Normal
    monkeypatch.setattr(jmx.init, "Normal", lambda sigma=0.01: jmx.init.Load(
        weights, default_init=normal(sigma)))
    with jmx.name.NameManager():
        _, _, want = jdcgan.train(epochs=STEPS, batch_size=BATCH,
                                  steps_per_epoch=1, verbose=False)
    with tmx.name.NameManager():
        gen, disc, got = tdcgan.train(epochs=STEPS, batch_size=BATCH,
                                      steps_per_epoch=1, verbose=False,
                                      ctx=tmx.cpu(), arg_params=weights)
    for key in ("d", "g"):
        np.testing.assert_allclose(got[key], want[key], rtol=REL)
        np.testing.assert_allclose(got[key + "_steps"], got[key])
    assert all(p.data().context == tmx.cpu()
               for p in gen.collect_params().values())


def test_dcgan_discriminator_learns():
    with tmx.name.NameManager():
        _, _, hist = tdcgan.train(epochs=1, batch_size=BATCH,
                                  steps_per_epoch=12, verbose=False,
                                  ctx=tmx.cpu())
    d = hist["d_steps"]
    assert len(d) == 12 and np.isfinite(d + hist["g_steps"]).all()
    assert np.mean(d[-3:]) < np.mean(d[:3])
