"""The port's ``RNN`` op and the seven other ops of ``ops/nn.py`` that
came with it (``SequenceMask``, ``SequenceLast``, ``SequenceReverse``,
``L2Normalization``, ``LRN``, ``UpSampling``, ``_contrib_BilinearResize2D``)
held against the JAX package's ops on the CPU.

``RNN`` runs in its four modes, with one and two layers, one and two
directions, forward (outputs and final states) and gradients of data,
the flat parameter vector and the initial states through a weighted sum
of every output (torch autograd against ``jax.vjp``), at rtol 1e-5 and
atol 1e-6 (gradients: atol 1e-6 x the set's largest gradient).  It is
also held to ``rnn_plain`` (the per-step composition, the card's
oracle) and, compiled with ``fullgraph=True`` on the ``aot_eager``
backend (the ``rnn_layer`` custom op and its backward), to itself
eager.  Inputs come from a numpy seed; JAX matmuls at
``default_matmul_precision("float32")``, torch at ``"highest"``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6
GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _n_params(mode, layers, C, H, D):
    g = GATES[mode]
    n = 0
    for layer in range(layers):
        n += D * g * H * ((C if layer == 0 else H * D) + H)
    return n + layers * D * 2 * g * H


def _rnn_inputs(mode, layers, bidir, T=5, N=3, C=4, H=6, seed=0):
    D = 2 if bidir else 1
    rng = np.random.RandomState(seed)
    f = np.float32
    ins = [rng.randn(T, N, C).astype(f),
           (rng.randn(_n_params(mode, layers, C, H, D)) * 0.4).astype(f),
           rng.randn(layers * D, N, H).astype(f) * 0.5]
    if mode == "lstm":
        ins.append(rng.randn(layers * D, N, H).astype(f) * 0.5)
    attrs = dict(state_size=H, num_layers=layers, bidirectional=bidir,
                 mode=mode, state_outputs=True)
    return ins, attrs


def _cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*o.shape).astype(np.float32) for o in outs]


def _jax_run(ins, attrs):
    fn = jreg.get_op("RNN").fn

    def f(*a):
        return tuple(fn(*a, **attrs))

    outs, vjp = jax.vjp(f, *[jnp.asarray(x) for x in ins])
    outs = [np.asarray(o) for o in outs]
    cots = _cotangents(outs)
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return outs, [np.asarray(g) for g in grads], cots


def _torch_run(fn, ins, attrs, cots):
    leaves = [torch.tensor(x, requires_grad=True) for x in ins]
    outs = fn(*leaves, **attrs)
    grads = torch.autograd.grad(list(outs), leaves,
                                [torch.tensor(c) for c in cots])
    return ([o.detach().numpy() for o in outs],
            [g.numpy() for g in grads])


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _close_grads(got, want):
    """Gradients: rtol 1e-5 and atol 1e-6 x the largest gradient of the
    set (a parameter's gradient sums over T x N products, whose f32
    order differs between the packages)."""
    scale = max(1.0, max(float(np.abs(w).max()) for w in want))
    _close(got, want, atol=ATOL * scale)


CASES = [(mode, layers, bidir) for mode in ("lstm", "gru", "rnn_tanh",
                                             "rnn_relu")
         for layers in (1, 2) for bidir in (False, True)]


@pytest.mark.parametrize("mode,layers,bidir", CASES)
def test_rnn_against_jax(mode, layers, bidir):
    ins, attrs = _rnn_inputs(mode, layers, bidir)
    want, want_g, cots = _jax_run(ins, attrs)
    got, got_g = _torch_run(treg.get_op("RNN").fn, ins, attrs, cots)
    _close(got, want)
    _close_grads(got_g, want_g)


@pytest.mark.parametrize("mode,layers,bidir", CASES[::3])
def test_rnn_against_plain_composition(mode, layers, bidir):
    ins, attrs = _rnn_inputs(mode, layers, bidir, seed=3)
    _, _, cots = _jax_run(ins, attrs)
    got, got_g = _torch_run(treg.get_op("RNN").fn, ins, attrs, cots)
    want, want_g = _torch_run(tnn.rnn_plain, ins, attrs, cots)
    _close(got, want)
    _close_grads(got_g, want_g)


@pytest.mark.parametrize("mode,bidir", [("lstm", True), ("gru", False),
                                        ("rnn_relu", True)])
def test_rnn_compiled_custom_op(mode, bidir):
    """The compiled route (``rnn_layer`` custom op with its backward op)
    against the eager one, under ``fullgraph=True``."""
    ins, attrs = _rnn_inputs(mode, 2, bidir, seed=5)
    _, _, cots = _jax_run(ins, attrs)
    fn = treg.get_op("RNN").fn
    compiled = torch.compile(lambda *a: fn(*a, **attrs), backend="aot_eager",
                             fullgraph=True)
    got, got_g = _torch_run(lambda *a, **k: compiled(*a), ins, attrs, cots)
    want, want_g = _torch_run(fn, ins, attrs, cots)
    _close(got, want)
    _close_grads(got_g, want_g)


def test_rnn_single_output_and_dropout_modes():
    ins, attrs = _rnn_inputs("lstm", 2, False)
    attrs = dict(attrs, state_outputs=False, p=0.5)
    t = [torch.tensor(x) for x in ins]
    fn = treg.get_op("RNN").fn
    assert treg.get_op("RNN").n_outputs(attrs) == 1
    # outside training the dropout between layers is the identity
    plain = fn(*t, **dict(attrs, p=0.0))
    np.testing.assert_array_equal(fn(*t, **attrs).numpy(), plain.numpy())
    with tmx.autograd.train_mode():
        tmx.random.seed(3)
        a = fn(*t, **attrs).numpy()
        tmx.random.seed(3)
        b = fn(*t, **attrs).numpy()
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - plain.numpy()).max() > 1e-3
    # projection_size and the clip attributes are accepted and ignored
    np.testing.assert_array_equal(
        fn(*t, **dict(attrs, p=0.0, projection_size=3,
                      lstm_state_clip_min=-0.1,
                      lstm_state_clip_max=0.1)).numpy(), plain.numpy())


def test_rnn_through_nd_and_symbol_shapes():
    ins, attrs = _rnn_inputs("gru", 2, True)
    out = tmx.nd.RNN(*[tmx.nd.array(x, ctx=tmx.cpu()) for x in ins], **attrs)
    assert [o.shape for o in out] == [(5, 3, 12), (4, 3, 6)]
    data = tmx.sym.var("data")
    s = tmx.sym.RNN(data, state_size=6, num_layers=2, bidirectional=True,
                    mode="gru", name="rnn")
    arg_shapes, out_shapes, _ = s.infer_shape(data=(5, 3, 4))
    assert dict(zip(s.list_arguments(), arg_shapes))["rnn_parameters"] == \
        (_n_params("gru", 2, 4, 6, 2),)
    assert out_shapes == [(5, 3, 12)]


# ---------------------------------------------------------------------------
# the other seven ops: forward and input gradients against JAX
# ---------------------------------------------------------------------------


def _op_pair(name, ins, attrs, grad=True):
    jfn, tfn = jreg.get_op(name).fn, treg.get_op(name).fn
    jins = [jnp.asarray(x) for x in ins]
    want = np.asarray(jfn(*jins, **attrs))
    leaves = [torch.tensor(x, requires_grad=grad and x.dtype == np.float32)
              for x in ins]
    got = tfn(*leaves, **attrs)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    if not grad:
        return
    cot = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jfn(x, *jins[1:], **attrs), jins[0])
    (jg,) = vjp(jnp.asarray(cot))
    (tg,) = torch.autograd.grad(got, leaves[0], torch.tensor(cot))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-5)


def _lengths():
    return np.array([3, 1, 4], np.float32)


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_mask(axis):
    x = np.random.RandomState(0).randn(*((4, 3, 2) if axis == 0
                                         else (3, 4, 2))).astype(np.float32)
    _op_pair("SequenceMask", [x, _lengths()],
             dict(use_sequence_length=True, value=-2.0, axis=axis))
    _op_pair("SequenceMask", [x], {})


@pytest.mark.parametrize("axis", [0, 1])
def test_sequence_last(axis):
    x = np.random.RandomState(1).randn(*((4, 3, 2) if axis == 0
                                         else (3, 4, 2))).astype(np.float32)
    _op_pair("SequenceLast", [x, _lengths()],
             dict(use_sequence_length=True, axis=axis))
    _op_pair("SequenceLast", [x], dict(axis=axis))


def test_sequence_reverse():
    x = np.random.RandomState(2).randn(4, 3, 2).astype(np.float32)
    _op_pair("SequenceReverse", [x, _lengths()],
             dict(use_sequence_length=True))
    _op_pair("SequenceReverse", [x], {})


@pytest.mark.parametrize("mode", ["instance", "channel", "spatial"])
def test_l2_normalization(mode):
    x = np.random.RandomState(3).randn(2, 3, 4, 5).astype(np.float32)
    _op_pair("L2Normalization", [x], dict(mode=mode))


def test_lrn():
    x = np.random.RandomState(4).randn(2, 7, 4, 5).astype(np.float32)
    _op_pair("LRN", [x], dict(alpha=1e-3, beta=0.75, knorm=2.0, nsize=5))
    _op_pair("LRN", [x], dict(nsize=3))


@pytest.mark.parametrize("sample_type", ["nearest", "bilinear"])
def test_upsampling(sample_type):
    x = np.random.RandomState(5).randn(2, 3, 4, 5).astype(np.float32)
    _op_pair("UpSampling", [x], dict(scale=2, sample_type=sample_type))


@pytest.mark.parametrize("attrs", [dict(height=9, width=7),
                                   dict(height=3, width=2),
                                   dict(scale_height=1.5, scale_width=2.0)])
def test_bilinear_resize_2d(attrs):
    x = np.random.RandomState(6).randn(2, 3, 6, 5).astype(np.float32)
    _op_pair("_contrib_BilinearResize2D", [x], attrs)
