"""The port's new ops and gluon layers against the JAX package on CPU:
the LeakyReLU family and its blocks, Conv1D-3D and their transposes
(Deconvolution with adj), the pooling layers, InstanceNorm,
ReflectionPad2D and the Pad and norm ops, Sequential and Lambda, and
Dropout.

Each layer is built in both packages under a fresh NameManager, the JAX
one's weights go across by name (``convert.load_from_numpy``), and the
same seeded numpy input runs through both under ``autograd.record()``
with the head sum(out * r) (r seeded): outputs, input gradients and
parameter gradients at rtol 1e-5 / atol 1e-5 (f32; JAX matmuls pinned
to "float32", torch's to "highest").  Dropout draws differ by design
(torch.Generator and the JAX PRNG never draw the same bits), so it is
held to its definition: equal in predict mode; in training the kept
share within 4 sigma of 1 - p, kept values x 1/(1 - p), the backward
through the forward's mask."""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-5


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(pkg, layer, x, r, wrap, train):
    a = wrap(x)
    a.attach_grad()
    with pkg.autograd.record(train_mode=train):
        out = layer(a)
        head = (out * wrap(r)).sum()
    head.backward()
    grads = {n: p.grad().asnumpy() for n, p in
             layer.collect_params().items() if p.grad_req != "null"}
    return out.asnumpy(), a.grad.asnumpy(), grads


def check_layer(make, x, seed=0, train=True, tol=TOL):
    """Build ``make(pkg)`` in both packages, carry the JAX weights across,
    and compare forward, input gradient and parameter gradients."""
    with tmx.name.NameManager():
        tl = make(tmx)
    with jmx.name.NameManager():
        jl = make(jmx)
    tl.initialize(ctx=tmx.cpu())
    jl.initialize(jmx.init.Xavier())
    tw = lambda v: tmx.nd.array(v, ctx=tmx.cpu())  # noqa: E731
    jw = jmx.nd.array
    with jmx.autograd.pause():
        probe = jl(jw(x)).asnumpy()
    tl(tw(x))
    tmx.convert.load_from_numpy(tl, {n: p.data().asnumpy() for n, p in
                                     jl.collect_params().items()})
    r = np.random.RandomState(seed + 100).randn(*probe.shape) \
        .astype(np.float32)
    t_out, t_dx, t_g = _run(tmx, tl, x, r, tw, train)
    j_out, j_dx, j_g = _run(jmx, jl, x, r, jw, train)
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out, j_out, rtol=tol, atol=tol)
    np.testing.assert_allclose(t_dx, j_dx, rtol=tol, atol=tol)
    assert sorted(t_g) == sorted(j_g)
    for n in j_g:
        np.testing.assert_allclose(t_g[n], j_g[n], rtol=tol, atol=tol,
                                   err_msg=n)
    return t_out


ACTIVATIONS = [
    ("leaky", lambda nn: nn.LeakyReLU(0.1)),
    ("elu", lambda nn: nn.ELU()),
    ("elu_alpha", lambda nn: nn.ELU(alpha=0.5)),
    ("selu", lambda nn: nn.SELU()),
    ("gelu", lambda nn: nn.GELU()),
    ("prelu", lambda nn: nn.PReLU()),
    ("swish", lambda nn: nn.Swish(beta=1.5)),
    ("activation_softrelu", lambda nn: nn.Activation("softrelu")),
]


@pytest.mark.parametrize("name, make", ACTIVATIONS,
                         ids=[a for a, _ in ACTIVATIONS])
def test_activation_blocks_match_jax(name, make):
    check_layer(lambda pkg: make(pkg.gluon.nn), _rand((2, 3, 4, 5), 1))


@pytest.mark.parametrize("attrs", [
    {"act_type": "leaky", "slope": 0.3},
    {"act_type": "elu"},  # alpha = slope's default 0.25, as in JAX
    {"act_type": "selu"},
    {"act_type": "gelu"},
    {"act_type": "rrelu", "lower_bound": 0.1, "upper_bound": 0.3},
], ids=lambda a: a["act_type"])
def test_leaky_relu_op_matches_jax(attrs):
    x = _rand((3, 4, 5), 2)
    outs = []
    for pkg, wrap in ((tmx, lambda v: tmx.nd.array(v, ctx=tmx.cpu())),
                      (jmx, jmx.nd.array)):
        a = wrap(x)
        a.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.LeakyReLU(a, **attrs)
            (out * out).sum().backward()
        outs.append((out.asnumpy(), a.grad.asnumpy()))
    for t, j in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


def test_prelu_op_with_a_channel_gamma_matches_jax():
    x, g = _rand((2, 3, 4), 3), np.array([0.1, 0.2, 0.3], np.float32)
    t = tmx.nd.LeakyReLU(tmx.nd.array(x, ctx=tmx.cpu()),
                         tmx.nd.array(g, ctx=tmx.cpu()), act_type="prelu")
    j = jmx.nd.LeakyReLU(jmx.nd.array(x), jmx.nd.array(g),
                         act_type="prelu")
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=TOL)


CONVS = [
    ("conv1d", (2, 4, 11), lambda nn: nn.Conv1D(6, 3, strides=2,
                                                padding=1, dilation=2)),
    ("conv1d_groups", (2, 4, 11), lambda nn: nn.Conv1D(
        6, 3, groups=2, use_bias=False, activation="relu")),
    ("conv2d", (2, 3, 9, 8), lambda nn: nn.Conv2D(5, (3, 2), strides=(2, 1),
                                                  padding=(1, 0))),
    ("conv2d_depthwise", (2, 4, 9, 8), lambda nn: nn.Conv2D(
        4, 3, padding=1, groups=4, use_bias=False)),
    ("conv2d_dilated", (1, 3, 12, 12), lambda nn: nn.Conv2D(
        4, 3, dilation=2, padding=2)),
    ("conv3d", (1, 2, 5, 6, 7), lambda nn: nn.Conv3D(3, (3, 2, 3),
                                                     strides=2, padding=1)),
    ("conv1d_transpose", (2, 4, 7), lambda nn: nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1)),
    ("conv2d_transpose", (2, 4, 5, 6), lambda nn: nn.Conv2DTranspose(
        3, (3, 4), strides=(2, 3), padding=(1, 1), output_padding=(1, 2))),
    ("conv2d_transpose_groups", (2, 4, 5, 5), lambda nn: nn.Conv2DTranspose(
        6, 3, strides=2, groups=2, use_bias=False)),
    ("conv2d_transpose_dilated", (1, 3, 5, 5), lambda nn: nn.Conv2DTranspose(
        2, 3, strides=1, padding=1, dilation=2)),
    ("conv3d_transpose", (1, 2, 3, 4, 3), lambda nn: nn.Conv3DTranspose(
        2, 2, strides=2, output_padding=(1, 0, 1))),
]


@pytest.mark.parametrize("name, shape, make", CONVS,
                         ids=[c[0] for c in CONVS])
def test_convolution_layers_match_jax(name, shape, make):
    check_layer(lambda pkg: make(pkg.gluon.nn), _rand(shape, 4))


def test_deconvolution_op_adj_and_bias_match_jax():
    x, w, b = _rand((2, 3, 4, 5), 5), _rand((3, 2, 3, 3), 6), _rand((2,), 7)
    attrs = dict(kernel=(3, 3), stride=(2, 2), pad=(1, 0), adj=(1, 1),
                 num_filter=2, no_bias=False)
    t = tmx.nd.Deconvolution(*[tmx.nd.array(v, ctx=tmx.cpu())
                               for v in (x, w, b)], **attrs).asnumpy()
    j = jmx.nd.Deconvolution(*[jmx.nd.array(v) for v in (x, w, b)],
                             **attrs).asnumpy()
    assert t.shape == j.shape == (2, 2, 8, 12)
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)


POOLS = [
    ("max1d", (2, 3, 9), lambda nn: nn.MaxPool1D(3, 2, 1)),
    ("max2d_ceil", (2, 3, 7, 7), lambda nn: nn.MaxPool2D(3, 2,
                                                         ceil_mode=True)),
    ("max3d", (1, 2, 5, 6, 5), lambda nn: nn.MaxPool3D(2)),
    ("avg1d", (2, 3, 9), lambda nn: nn.AvgPool1D(3, 2, 1)),
    ("avg2d_no_pad_count", (2, 3, 7, 7), lambda nn: nn.AvgPool2D(
        3, 2, 1, count_include_pad=False)),
    ("avg2d_ceil", (2, 3, 7, 6), lambda nn: nn.AvgPool2D(
        2, 2, ceil_mode=True)),
    ("avg3d", (1, 2, 5, 6, 5), lambda nn: nn.AvgPool3D(
        3, 2, 1, count_include_pad=False)),
    ("global_max1d", (2, 3, 9), lambda nn: nn.GlobalMaxPool1D()),
    ("global_max2d", (2, 3, 5, 4), lambda nn: nn.GlobalMaxPool2D()),
    ("global_max3d", (1, 2, 3, 4, 5), lambda nn: nn.GlobalMaxPool3D()),
    ("global_avg1d", (2, 3, 9), lambda nn: nn.GlobalAvgPool1D()),
    ("global_avg2d", (2, 3, 5, 4), lambda nn: nn.GlobalAvgPool2D()),
    ("global_avg3d", (1, 2, 3, 4, 5), lambda nn: nn.GlobalAvgPool3D()),
]


@pytest.mark.parametrize("name, shape, make", POOLS,
                         ids=[p[0] for p in POOLS])
def test_pooling_layers_match_jax(name, shape, make):
    check_layer(lambda pkg: make(pkg.gluon.nn), _rand(shape, 8))


@pytest.mark.parametrize("kwargs", [{}, {"scale": True},
                                    {"center": False, "epsilon": 1e-3},
                                    {"axis": 2, "scale": True}],
                         ids=["default", "scale", "no_center", "axis2"])
def test_instance_norm_matches_jax(kwargs):
    shape = (2, 4, 4, 5) if kwargs.get("axis") != 2 else (2, 4, 4, 5)
    check_layer(lambda pkg: pkg.gluon.nn.InstanceNorm(**kwargs),
                _rand(shape, 9))


@pytest.mark.parametrize("padding", [1, 2])
def test_reflection_pad2d_matches_jax(padding):
    out = check_layer(lambda pkg: pkg.gluon.nn.ReflectionPad2D(padding),
                      _rand((2, 3, 5, 6), 10))
    assert out.shape == (2, 3, 5 + 2 * padding, 6 + 2 * padding)


@pytest.mark.parametrize("mode, width", [
    ("constant", (0, 0, 1, 2, 2, 1)), ("edge", (0, 0, 0, 0, 1, 2, 2, 0)),
    ("reflect", (0, 0, 0, 0, 2, 1, 1, 2)), ("reflect", (0, 0, 1, 2))])
def test_pad_op_matches_jax(mode, width):
    x = _rand((2, 3, 5, 6)[:len(width) // 2], 11)
    t = tmx.nd.Pad(tmx.nd.array(x, ctx=tmx.cpu()), mode=mode,
                   pad_width=width, constant_value=0.5).asnumpy()
    j = jmx.nd.Pad(jmx.nd.array(x), mode=mode, pad_width=width,
                   constant_value=0.5).asnumpy()
    np.testing.assert_allclose(t, j, rtol=TOL)


@pytest.mark.parametrize("attrs", [{}, {"ord": 1}, {"axis": 1},
                                   {"axis": (0, 2), "keepdims": True},
                                   {"ord": 1, "axis": -1}])
def test_norm_op_matches_jax(attrs):
    x = _rand((3, 4, 5), 12)
    t = tmx.nd.norm(tmx.nd.array(x, ctx=tmx.cpu()), **attrs).asnumpy()
    j = jmx.nd.norm(jmx.nd.array(x), **attrs).asnumpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=TOL)


def test_sequential_and_lambda_match_jax():
    def make(pkg):
        nn = pkg.gluon.nn
        net = nn.Sequential()
        with net.name_scope():
            net.add(nn.Dense(6, activation="tanh"), nn.Lambda("relu"),
                    nn.Dense(3), nn.Lambda(lambda x: x * 2.0))
        return net

    check_layer(make, _rand((4, 5), 13))
    with tmx.name.NameManager():
        seq = make(tmx)
    assert len(seq) == 4 and isinstance(seq[1:3], tmx.gluon.nn.Sequential)


def test_dropout_predict_mode_is_the_identity_as_in_jax():
    x = _rand((4, 8), 14)
    for pkg, wrap in ((tmx, lambda v: tmx.nd.array(v, ctx=tmx.cpu())),
                      (jmx, jmx.nd.array)):
        layer = pkg.gluon.nn.Dropout(0.5)
        with pkg.autograd.record(train_mode=False):
            out = layer(wrap(x))
        np.testing.assert_array_equal(out.asnumpy(), x)
        np.testing.assert_array_equal(
            pkg.nd.Dropout(wrap(x), p=0.5).asnumpy(), x)


@pytest.mark.parametrize("p, axes", [(0.5, ()), (0.2, ()), (0.3, (1,))])
def test_dropout_training_keeps_its_share_scales_and_backprops_the_mask(
        p, axes):
    tmx.random.seed(3)
    x = np.abs(_rand((64, 32, 8), 15)) + 0.5
    a = tmx.nd.array(x, ctx=tmx.cpu())
    a.attach_grad()
    with tmx.autograd.record():
        out = tmx.gluon.nn.Dropout(p, axes=axes)(a)
    out.backward()
    o, g = out.asnumpy(), a.grad.asnumpy()
    kept = o != 0
    if axes:  # one draw per (sample, position), shared along axis 1
        assert (kept == kept[:, :1, :]).all()
        n = x.shape[0] * x.shape[2]
    else:
        n = x.size
    share = kept.mean()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(share - (1 - p)) < 4 * sigma, (share, sigma)
    np.testing.assert_allclose(o[kept], x[kept] / (1 - p), rtol=1e-6)
    np.testing.assert_array_equal(g != 0, kept)
    np.testing.assert_allclose(g[kept], 1 / (1 - p), rtol=1e-6)


def test_dropout_mode_always_draws_outside_training():
    tmx.random.seed(4)
    x = np.ones((50, 40), np.float32)
    out = tmx.nd.Dropout(tmx.nd.array(x, ctx=tmx.cpu()), p=0.5,
                         mode="always").asnumpy()
    assert 0.4 < (out == 0).mean() < 0.6
    assert set(np.unique(out)) <= {0.0, 2.0}


def test_dropout_at_rate_zero_copies():
    x = _rand((3, 4), 16)
    a = tmx.nd.array(x, ctx=tmx.cpu())
    with tmx.autograd.record():
        out = tmx.gluon.nn.Dropout(0.0)(a)
    assert out._data is not a._data
    np.testing.assert_array_equal(out.asnumpy(), x)
