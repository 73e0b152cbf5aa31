"""The port's output (loss-head) ops held against the JAX package's on the
CPU: forward values and the gradients of data and label under
``autograd.record``, for softmax_cross_entropy, SoftmaxOutput (every
attribute: grad_scale, ignore_label/use_ignore, normalization
null/batch/valid, multi_output, preserve_shape, smooth_alpha) and its
alias Softmax, SoftmaxActivation, the three regression outputs, MakeLoss
and SVMOutput.  The head gradient is a seeded random array (the loss
heads ignore it; MakeLoss scales it).  Tolerance rtol 1e-5, atol 1e-6."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _run(pkg, op, data, label, attrs, head):
    nd = pkg.nd
    ctx = {"ctx": tmx.cpu()} if pkg is tmx else {}
    x = nd.array(data, **ctx)
    x.attach_grad()
    args = [x]
    if label is not None:
        y = nd.array(label, **ctx)
        y.attach_grad()
        args.append(y)
    with pkg.autograd.record():
        out = getattr(nd, op)(*args, **attrs)
    out.backward(nd.array(head, **ctx))
    grads = [a.grad.asnumpy() for a in args]
    return [out.asnumpy()] + grads


def _check(op, data, label, attrs, seed=0):
    rng = np.random.RandomState(seed + 100)
    head = rng.randn(*data.shape).astype(np.float32) \
        if op != "softmax_cross_entropy" else np.float32(1.3)
    want = _run(jmx, op, data, label, attrs, head)
    got = _run(tmx, op, data, label, attrs, head)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _logits(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _labels(shape, k, seed=1, low=0):
    return np.random.RandomState(seed).randint(low, k, shape) \
        .astype(np.float32)


SOFTMAX_CASES = {
    "default": {},
    "grad_scale": {"grad_scale": 2.5},
    "ignore": {"use_ignore": True, "ignore_label": 2},
    "ignore_default_label": {"use_ignore": True},
    "batch": {"normalization": "batch"},
    "valid": {"normalization": "valid"},
    "valid_ignore": {"normalization": "valid", "use_ignore": True,
                     "ignore_label": 1, "grad_scale": 0.5},
    "smooth": {"smooth_alpha": 0.1},
    "smooth_ignore_batch": {"smooth_alpha": 0.2, "use_ignore": True,
                            "ignore_label": 0, "normalization": "batch"},
    "preserve_shape": {"preserve_shape": True},
}


@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_softmax_output_matches_jax(case):
    # labels include -1 (outside every class: a zero one-hot row)
    label = _labels((6,), 5, low=-1)
    _check("SoftmaxOutput", _logits((6, 5)), label, SOFTMAX_CASES[case])


@pytest.mark.parametrize("case", ["default", "valid_ignore", "smooth"])
def test_softmax_output_multi_output_matches_jax(case):
    attrs = dict(SOFTMAX_CASES[case], multi_output=True)
    _check("SoftmaxOutput", _logits((3, 4, 5)), _labels((3, 5), 4), attrs)


def test_softmax_output_preserve_shape_3d_matches_jax():
    _check("SoftmaxOutput", _logits((2, 3, 4)), _labels((2, 3), 4),
           {"preserve_shape": True, "normalization": "valid"})


def test_softmax_alias_and_registry():
    assert treg.get_op("Softmax") is treg.get_op("SoftmaxOutput")
    _check("Softmax", _logits((4, 3)), _labels((4,), 3), {"grad_scale": 3.0})
    names = ("softmax_cross_entropy", "SoftmaxOutput", "Softmax",
             "SoftmaxActivation", "LinearRegressionOutput",
             "MAERegressionOutput", "LogisticRegressionOutput", "MakeLoss",
             "SVMOutput")
    assert set(names) <= set(treg.list_ops())
    assert len(treg.list_ops()) == 451


def test_softmax_cross_entropy_matches_jax():
    _check("softmax_cross_entropy", _logits((5, 7)), _labels((5,), 7), {})


@pytest.mark.parametrize("mode", ["instance", "channel"])
def test_softmax_activation_matches_jax(mode):
    _check("SoftmaxActivation", _logits((2, 3, 4)), None, {"mode": mode})


@pytest.mark.parametrize("op", ["LinearRegressionOutput",
                                "MAERegressionOutput",
                                "LogisticRegressionOutput"])
@pytest.mark.parametrize("grad_scale", [1.0, 0.25])
def test_regression_outputs_match_jax(op, grad_scale):
    label = np.random.RandomState(5).rand(4, 3).astype(np.float32)
    _check(op, _logits((4, 3)), label, {"grad_scale": grad_scale})
    # a (N,) label against (N, 1) data is reshaped to the output
    _check(op, _logits((4, 1), seed=2), label[:, 0],
           {"grad_scale": grad_scale})


@pytest.mark.parametrize("grad_scale", [1.0, 3.0])
def test_make_loss_matches_jax(grad_scale):
    _check("MakeLoss", _logits((3, 4)), None,
           {"grad_scale": grad_scale, "normalization": "batch"})


@pytest.mark.parametrize("use_linear", [False, True])
@pytest.mark.parametrize("margin,reg", [(1.0, 1.0), (0.5, 2.0)])
def test_svm_output_matches_jax(use_linear, margin, reg):
    _check("SVMOutput", _logits((5, 4)), _labels((5,), 4),
           {"margin": margin, "regularization_coefficient": reg,
            "use_linear": use_linear})
