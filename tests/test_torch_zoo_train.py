"""One network per vision family in the port against the JAX package on
CPU, from the JAX weights (``convert.load_from_numpy``), batch 2 of
seeded data at the smallest input the architecture takes, under
``autograd.record(train_mode=False)`` (BatchNorm on its moving stats,
Dropout off), then one gluon ``Trainer`` sgd step (lr 0.05, momentum
0.9, wd 1e-4; the port's takes the fused update).  The forward is the
predict-mode logits: within 1e-5 x max|ref|.  The loss within rtol
1e-5; every gradient within 2e-4 x G, G the net's largest |gradient|
(a relu input within f32 noise of 0 may take either side in the two
packages; AlexNet's conv2d2 has one, 8.9e-5 x G); the weights after
the step within 1e-5 x their largest |value| + lr x 2e-4 x G.  The JAX
reference takes relu's derivative at 0 to be the reference MXNet's 0
(tests/torch_zoo_ref.py says why).  f32; JAX matmuls pinned to
"float32", torch's to "highest".  The three families whose JAX compile
is longest (DenseNet, Inception, MobileNet v2) run these checks in
test_torch_zoo_train_deep.py, to keep each file within a minute."""
import numpy as np
import pytest
import torch

import jax

from torch_zoo_ref import (BATCH, SGD, assert_close_to_largest, jax_step,
                           port_step)

LOGIT_REL, GRAD_REL, WEIGHT_REL = 1e-5, 2e-4, 1e-5
FAMILIES = ["alexnet", "mobilenet", "resnet_v1", "resnet_v2", "squeezenet",
            "vgg"]


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def logits_match_jax(family):
    ref = jax_step(family, False)
    _, _, logits, _ = port_step(family, False, ref)
    assert logits.shape == (BATCH, 10)
    assert_close_to_largest(logits, ref["logits"], LOGIT_REL, family)


def training_step_matches_jax(family):
    ref = jax_step(family, False)
    net, trainer, _, loss = port_step(family, False, ref)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    params = net.collect_params()
    assert sorted(n for n, p in params.items() if p.grad_req != "null") \
        == sorted(ref["grads"])
    g_scale = max(float(np.abs(g).max()) for g in ref["grads"].values())
    for n, g in ref["grads"].items():
        assert_close_to_largest(params[n].grad().asnumpy(), g, GRAD_REL, n,
                                scale=g_scale)
    trainer.step(BATCH)
    assert trainer._fused_updates == 1
    lr_part = SGD["learning_rate"] * GRAD_REL * g_scale
    for n, w in ref["w1"].items():
        got = params[n].data().asnumpy()
        err = float(np.abs(got - w).max())
        assert err <= WEIGHT_REL * float(np.abs(w).max()) + lr_part, n


@pytest.mark.parametrize("family", FAMILIES)
def test_family_logits_match_jax(family):
    logits_match_jax(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_training_step_matches_jax(family):
    training_step_matches_jax(family)
