"""test_torch_zoo_train.py's logits and predict-mode training step for
the three families whose JAX compile is longest: DenseNet (densenet121),
Inception (inceptionv3, 299x299) and MobileNet v2 (mobilenetv2_0.25).
The checks and tolerances are that file's."""
import pytest
import torch

import jax

from test_torch_zoo_train import logits_match_jax, training_step_matches_jax

FAMILIES = ["densenet", "inception", "mobilenet_v2"]


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_logits_match_jax(family):
    logits_match_jax(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_training_step_matches_jax(family):
    training_step_matches_jax(family)
