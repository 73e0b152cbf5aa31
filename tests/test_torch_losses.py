"""The port's gluon losses against the JAX package's on CPU: all 13, each
with and without ``sample_weight`` where it takes one.  The same seeded
numpy inputs go through both; the loss values and the gradient of their
sum with respect to the prediction agree at rtol 1e-5 / atol 1e-6
(f32).  CTCLoss also runs with its length inputs, and its NTC/NT and
TNC/TN layouts."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
N, K = 4, 5


def _r(seed):
    return np.random.RandomState(seed)


def _logits(seed=0, shape=(N, K)):
    return _r(seed).randn(*shape).astype(np.float32)


def _probs(seed=0, shape=(N, K)):
    return (_r(seed).rand(*shape) * 0.9 + 0.05).astype(np.float32)


def _signed(seed=1, shape=(N, K)):
    return np.where(_r(seed).rand(*shape) > 0.5, 1.0, -1.0) \
        .astype(np.float32)


def _binary(seed=1, shape=(N, K)):
    return (_r(seed).rand(*shape) > 0.5).astype(np.float32)


def _classes(seed=1):
    return _r(seed).randint(0, K, N).astype(np.float32)


def _dense_labels(seed=1):
    p = _r(seed).rand(N, K).astype(np.float32)
    return p / p.sum(axis=1, keepdims=True)


def _ctc_inputs(layout):
    T, C, L = 7, 5, 3
    pred = _r(2).randn(N, T, C).astype(np.float32)
    # labels 0..C-2 (blank 'last' is C-1), padded with -1
    label = np.array([[1, 2, 3], [0, 0, -1], [3, -1, -1], [2, 1, 0]],
                     np.float32)
    if layout == "TNC":
        pred = pred.transpose(1, 0, 2).copy()
        label = label.T.copy()
    return pred, label


# name -> (factory(gluon.loss), inputs(), sample_weight shape or None)
CASES = {
    "L2Loss": (lambda L: L.L2Loss(), lambda: [_logits(), _logits(1)],
               (N, 1)),
    "L2Loss_weight": (lambda L: L.L2Loss(weight=0.5),
                      lambda: [_logits(), _logits(1)], (N, K)),
    "L1Loss": (lambda L: L.L1Loss(), lambda: [_logits(), _logits(1)],
               (N, 1)),
    "SigmoidBCE_logits": (lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                          lambda: [_logits(), _binary()], (N, 1)),
    "SigmoidBCE_probs": (lambda L: L.SigmoidBCELoss(from_sigmoid=True),
                         lambda: [_probs(), _binary()], (N, 1)),
    "SoftmaxCE_sparse": (lambda L: L.SoftmaxCrossEntropyLoss(),
                         lambda: [_logits(), _classes()], (N, 1)),
    "SoftmaxCE_dense": (lambda L: L.SoftmaxCELoss(sparse_label=False),
                        lambda: [_logits(), _dense_labels()], (N, 1)),
    "SoftmaxCE_from_logits": (
        lambda L: L.SoftmaxCELoss(from_logits=True, weight=2.0),
        lambda: [np.log(_probs()), _classes()], (N, 1)),
    "KLDiv_logprob": (lambda L: L.KLDivLoss(),
                      lambda: [np.log(_probs()), _dense_labels()], (N, 1)),
    "KLDiv_logits": (lambda L: L.KLDivLoss(from_logits=False),
                     lambda: [_logits(), _dense_labels()], (N, 1)),
    "CTC_NTC": (lambda L: L.CTCLoss(), lambda: list(_ctc_inputs("NTC")),
                (N,)),
    "CTC_TNC": (lambda L: L.CTCLoss(layout="TNC", label_layout="TN"),
                lambda: list(_ctc_inputs("TNC")), (N,)),
    "Huber": (lambda L: L.HuberLoss(rho=0.7),
              lambda: [_logits(), _logits(1)], (N, 1)),
    "Hinge": (lambda L: L.HingeLoss(), lambda: [_logits(), _signed()],
              (N, 1)),
    "SquaredHinge": (lambda L: L.SquaredHingeLoss(margin=0.5),
                     lambda: [_logits(), _signed()], (N, 1)),
    "Logistic_signed": (lambda L: L.LogisticLoss(),
                        lambda: [_logits(), _signed()], (N, 1)),
    "Logistic_binary": (lambda L: L.LogisticLoss(label_format="binary"),
                        lambda: [_logits(), _binary()], (N, 1)),
    "Triplet": (lambda L: L.TripletLoss(margin=0.5),
                lambda: [_logits(), _logits(1), _logits(2)], None),
    "PoissonNLL_logits": (lambda L: L.PoissonNLLLoss(),
                          lambda: [_logits() * 0.3,
                                   _r(3).poisson(2, (N, K))
                                   .astype(np.float32)], (N, 1)),
    "PoissonNLL_full": (lambda L: L.PoissonNLLLoss(from_logits=False,
                                                   compute_full=True),
                        lambda: [_probs() * 3,
                                 _r(3).poisson(2, (N, K))
                                 .astype(np.float32) + 1], (N, 1)),
    "CosineEmbedding": (lambda L: L.CosineEmbeddingLoss(margin=0.1),
                        lambda: [_logits(), _logits(1),
                                 _signed(4, (N,))], (N, 1)),
}


def _run(pkg, make, inputs, sw, wrap):
    loss = make(pkg.gluon.loss)
    arrs = [wrap(a) for a in inputs]
    arrs[0].attach_grad()
    extra = [] if sw is None else [wrap(sw)]
    with pkg.autograd.record():
        out = loss(*arrs, *extra)
    out.backward()
    return out.asnumpy(), arrs[0].grad.asnumpy()


def _compare(make, inputs, sw):
    t = _run(tmx, make, inputs, sw,
             lambda v: tmx.nd.array(v, ctx=tmx.cpu()))
    j = _run(jmx, make, inputs, sw, jmx.nd.array)
    assert t[0].shape == j[0].shape
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[1], j[1], rtol=RTOL, atol=ATOL)
    return t[0]


# every loss plain, and with a sample_weight where it takes one
RUNS = [(name, False) for name in sorted(CASES)] + \
    [(name, True) for name in sorted(CASES) if CASES[name][2] is not None]


@pytest.mark.parametrize("name, with_weight", RUNS,
                         ids=["%s-%s" % (n, "sample_weight" if w else "plain")
                              for n, w in RUNS])
def test_loss_matches_jax(name, with_weight):
    make, inputs, sw_shape = CASES[name]
    sw = (_r(9).rand(*sw_shape) + 0.5).astype(np.float32) \
        if with_weight else None
    out = _compare(make, inputs(), sw)
    assert np.isfinite(out).all()


def test_every_loss_class_of_the_jax_module_is_ported():
    for name in jmx.gluon.loss.__all__:
        assert hasattr(tmx.gluon.loss, name), name


def test_sigmoid_bce_pos_weight_matches_jax():
    pred, label = _logits(), _binary()
    pw = (_r(5).rand(1, K) + 0.5).astype(np.float32)
    outs = []
    for pkg, wrap in ((tmx, lambda v: tmx.nd.array(v, ctx=tmx.cpu())),
                      (jmx, jmx.nd.array)):
        for from_sigmoid in (False, True):
            loss = pkg.gluon.loss.SigmoidBCELoss(from_sigmoid=from_sigmoid)
            p = _probs() if from_sigmoid else pred
            outs.append(loss(wrap(p), wrap(label), None, wrap(pw))
                        .asnumpy())
    np.testing.assert_allclose(outs[0], outs[2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[1], outs[3], rtol=RTOL, atol=ATOL)


def test_ctc_loss_with_lengths_matches_jax():
    pred, label = _ctc_inputs("NTC")
    plen = np.array([7, 6, 5, 7], np.float32)
    llen = np.array([3, 2, 1, 3], np.float32)
    outs = []
    for pkg, wrap in ((tmx, lambda v: tmx.nd.array(v, ctx=tmx.cpu())),
                      (jmx, jmx.nd.array)):
        a = wrap(pred)
        a.attach_grad()
        with pkg.autograd.record():
            out = pkg.gluon.loss.CTCLoss()(a, wrap(label), wrap(plen),
                                           wrap(llen))
        out.backward()
        outs.append((out.asnumpy(), a.grad.asnumpy()))
    for t, j in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_op_matches_jax(blank):
    data = _r(6).randn(6, 3, 4).astype(np.float32)
    if blank == "first":
        label = np.array([[1, 2, 0], [3, 3, 1], [2, 0, 0]], np.float32)
    else:
        label = np.array([[0, 1, -1], [2, 2, 0], [1, -1, -1]], np.float32)
    t = tmx.nd.CTCLoss(tmx.nd.array(data, ctx=tmx.cpu()),
                       tmx.nd.array(label, ctx=tmx.cpu()),
                       blank_label=blank).asnumpy()
    j = jmx.nd.CTCLoss(jmx.nd.array(data), jmx.nd.array(label),
                       blank_label=blank).asnumpy()
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
