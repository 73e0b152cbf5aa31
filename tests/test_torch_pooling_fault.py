"""The port's ``Pooling`` against the JAX op on the cases its first version
got wrong or refused: ``count_include_pad=False`` (it always counted the
padding, silently), ``pool_type`` 'sum' and 'lp', and 1-D and 3-D data
(it called the 2-D torch functions only).  Same numpy inputs (seeded)
through both packages' ``mx.nd.Pooling``; values at rtol 1e-5 / atol
1e-6 and input gradients at rtol 1e-5 / atol 1e-5 (f32)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL, GRAD_ATOL = 1e-5, 1e-6, 1e-5


def _pool(pkg, x, attrs, wrap):
    a = wrap(x)
    a.attach_grad()
    with pkg.autograd.record():
        out = pkg.nd.Pooling(a, **attrs)
        head = (out * out).sum()
    head.backward()
    return out.asnumpy(), a.grad.asnumpy()


def _both(x, attrs):
    t = _pool(tmx, x, attrs, lambda v: tmx.nd.array(v, ctx=tmx.cpu()))
    j = _pool(jmx, x, attrs, jmx.nd.array)
    assert t[0].shape == j[0].shape
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[1], j[1], rtol=RTOL, atol=GRAD_ATOL)
    return t[0], j[0]


def test_count_include_pad_false_corner_of_a_4x4_input():
    """The reported case: avg, kernel 3, stride 1, pad 1 on a 4x4 rand
    input.  The corner window holds 4 real elements of its 9; the JAX op
    divides by 4 (the first port divided by 9)."""
    x = np.random.RandomState(0).rand(1, 1, 4, 4).astype(np.float32)
    t, _ = _both(x, dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                         pool_type="avg", count_include_pad=False))
    np.testing.assert_allclose(t[0, 0, 0, 0], x[0, 0, :2, :2].mean(),
                               rtol=1e-6)


CASES = [
    # (shape, kernel, stride, pad, convention, pool_type, extra attrs)
    ((2, 3, 7, 6), (3, 3), (2, 2), (1, 1), "valid", "avg",
     {"count_include_pad": False}),
    ((2, 3, 7, 6), (3, 2), (2, 2), (1, 1), "full", "avg",
     {"count_include_pad": False}),
    ((2, 3, 7, 6), (3, 3), (2, 2), (1, 1), "valid", "sum", {}),
    ((2, 3, 7, 6), (2, 2), (2, 2), (0, 0), "full", "sum", {}),
    ((2, 3, 7, 6), (3, 3), (2, 2), (1, 1), "valid", "lp", {"p_value": 2}),
    ((2, 3, 7, 6), (2, 3), (1, 2), (0, 1), "valid", "lp", {"p_value": 3}),
    ((2, 3, 9), (3,), (2,), (1,), "valid", "max", {}),
    ((2, 3, 9), (3,), (2,), (1,), "full", "avg", {}),
    ((2, 3, 9), (3,), (2,), (1,), "valid", "avg",
     {"count_include_pad": False}),
    ((2, 3, 9), (2,), (2,), (0,), "valid", "sum", {}),
    ((2, 3, 9), (3,), (1,), (1,), "valid", "lp", {"p_value": 2}),
    ((1, 2, 5, 6, 7), (3, 3, 3), (2, 2, 2), (1, 1, 1), "valid", "max", {}),
    ((1, 2, 5, 6, 7), (2, 3, 2), (2, 2, 2), (0, 1, 1), "full", "avg", {}),
    ((1, 2, 5, 6, 7), (3, 3, 3), (2, 2, 2), (1, 1, 1), "valid", "avg",
     {"count_include_pad": False}),
    ((1, 2, 5, 6, 7), (2, 2, 2), (2, 2, 2), (0, 0, 0), "valid", "sum", {}),
    ((1, 2, 5, 6, 7), (2, 2, 2), (1, 2, 1), (0, 0, 0), "valid", "lp",
     {"p_value": 2}),
]


@pytest.mark.parametrize("shape, kernel, stride, pad, conv, ptype, extra",
                         CASES)
def test_pooling_case_matches_jax(shape, kernel, stride, pad, conv, ptype,
                                  extra):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    _both(x, dict(kernel=kernel, stride=stride, pad=pad,
                  pooling_convention=conv, pool_type=ptype, **extra))


@pytest.mark.parametrize("shape, ptype", [
    ((2, 3, 9), "max"), ((2, 3, 9), "avg"),
    ((1, 2, 5, 6, 7), "max"), ((1, 2, 5, 6, 7), "avg"),
    ((2, 3, 5, 4), "sum")])
def test_global_pooling_over_1_to_3_dims_matches_jax(shape, ptype):
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    _both(x, dict(kernel=(1,) * (len(shape) - 2), global_pool=True,
                  pool_type=ptype))


def test_gluon_avgpool2d_count_include_pad_false_matches_jax():
    x = np.random.RandomState(4).rand(2, 3, 6, 6).astype(np.float32)
    outs = []
    for pkg, ctx in ((tmx, tmx.cpu()), (jmx, None)):
        layer = pkg.gluon.nn.AvgPool2D(pool_size=3, strides=2, padding=1,
                                       count_include_pad=False)
        arr = pkg.nd.array(x, ctx=ctx) if ctx else pkg.nd.array(x)
        outs.append(layer(arr).asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=RTOL, atol=ATOL)
