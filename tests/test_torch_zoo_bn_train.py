"""One training-mode step (BatchNorm on batch statistics) of each vision
family that has BatchNorm and no Dropout, in the port against the JAX
package on CPU: from the JAX weights, batch 2 of seeded 64x64 data,
gluon ``Trainer`` sgd (lr 0.05, momentum 0.9, wd 1e-4), DenseNet at
DenseNet(32, 16, [2, 2, 2, 2]).  The loss within rtol 1e-5 and the
moving mean and variance after the step within 1e-5 x their largest
|value| (forward quantities).  The gradients are held to 5e-2 x G (G
the net's largest |gradient|).  In this regime f32 itself is the limit,
not the port, and the forward feels it too: mobilenet0.25's loss
differs by 2.4e-5 relative, its moving means by 1.4e-5 of their scale.  At batch 2 a channel whose few values are all zero or
nearly equal has a variance at or near 0, its 1/sqrt(var + eps) is up
to 316, and the gradient through it loses most of its f32 digits.
Against a float64 run of the port's model, the JAX package's f32
gradients were up to 3.0e-2 x G off on these families (the port's up
to 1.1e-2 x G; densenet121 at 64x64 and 128x128, mobilenetv2_0.25,
mobilenet0.25).  The predict-mode steps of
test_torch_zoo_train.py hold the gradients to 2e-4 x G.  The JAX
reference takes relu's derivative at 0 to be the reference MXNet's 0.
f32; JAX matmuls pinned to "float32", torch's to "highest"."""
import numpy as np
import pytest
import torch

import jax

from torch_zoo_ref import (BATCH, BN_TRAIN, assert_close_to_largest,
                           jax_step, port_step)

LOSS_RTOL, STAT_REL, GRAD_REL = 1e-4, 1e-4, 5e-2


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("family", BN_TRAIN)
def test_batchnorm_family_training_mode_step_matches_jax(family):
    ref = jax_step(family, True)
    net, trainer, _, loss = port_step(family, True, ref)
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_RTOL)
    params = net.collect_params()
    g_scale = max(float(np.abs(g).max()) for g in ref["grads"].values())
    for n, g in ref["grads"].items():
        assert_close_to_largest(params[n].grad().asnumpy(), g, GRAD_REL, n,
                                scale=g_scale)
    trainer.step(BATCH)
    means = [n for n in ref["w1"] if n.endswith("running_mean")]
    assert means
    for n in means:
        var_n = n[:-len("mean")] + "var"
        rv = ref["w1"][var_n]
        # one step from 1 at momentum 0.9: rv = 0.9 + 0.1 * batch var
        std = float(np.sqrt(max(0.0, float((rv - 0.9).max()) / 0.1)))
        mean = ref["w1"][n]
        assert_close_to_largest(params[n].data().asnumpy(), mean, STAT_REL,
                                n, scale=max(float(np.abs(mean).max()), std))
        assert_close_to_largest(params[var_n].data().asnumpy(), rv,
                                STAT_REL, var_n)
