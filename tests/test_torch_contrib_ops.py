"""The port's contrib ops held against the JAX package's on the CPU: the
16 registry names of mxnet_tpu/ops/contrib_ops.py (box_iou, box_nms and
its two aliases, MultiBoxPrior and its alias, ROIPooling, ROIAlign,
quadratic and its alias, allclose, arange_like, index_copy, getnnz,
div_sqrt_dim, count_sketch) and the 4 of ops/deformable.py
(DeformableConvolution, PSROIPooling and its alias,
DeformablePSROIPooling), on the same seeded numpy inputs.  Forward
within 1e-5; the gradients of ROIPooling, ROIAlign and the deformable
ops (torch autograd) within 1e-4 of ``jax.vjp``'s for the same
cotangent."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu  # noqa: F401 (registers the JAX ops)
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch  # noqa: F401 (registers the port's ops)
from mxnet_tpu_torch.ops import registry as treg

TOL, GRAD_TOL = 1e-5, 1e-4

CONTRIB_NAMES = ("_contrib_box_iou", "_contrib_box_nms", "_contrib_nms",
                 "_contrib_box_non_maximum_suppression",
                 "_contrib_MultiBoxPrior", "MultiBoxPrior", "ROIPooling",
                 "_contrib_ROIAlign", "quadratic", "_contrib_quadratic",
                 "_contrib_allclose", "_contrib_arange_like",
                 "_contrib_index_copy", "_contrib_getnnz",
                 "_contrib_div_sqrt_dim", "_contrib_count_sketch")
DEFORMABLE_NAMES = ("_contrib_DeformableConvolution", "_contrib_PSROIPooling",
                    "PSROIPooling", "_contrib_DeformablePSROIPooling")


@pytest.fixture(autouse=True)
def _precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _tuple(x):
    return x if isinstance(x, (tuple, list)) else (x,)


def _jit(fn, on):
    return jax.jit(fn) if on else fn


def run_both(name, ins, attrs, tol=TOL, jit=True):
    """The op's outputs in both packages (numpy), held together; JAX's
    under jax.jit unless ``jit`` is False (op by op, its eager dispatch
    dominates the file; ROIAlign's unrolled bins compile slower than they
    dispatch)."""
    j = _tuple(_jit(lambda *a: jreg.get_op(name).fn(*a, **attrs), jit)(
        *[jnp.asarray(x) for x in ins]))
    t = _tuple(treg.get_op(name).fn(*[torch.from_numpy(np.asarray(x))
                                      for x in ins], **attrs))
    assert len(j) == len(t)
    out = []
    for a, b in zip(j, t):
        a, b = np.asarray(a), b.detach().numpy()
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=name)
        out.append(b)
    return out


def grads_both(name, ins, attrs, wrt, seed=0, jit=True):
    """The gradients of the op's first output for the inputs ``wrt``
    (indices), jax.vjp against torch autograd, one seeded cotangent."""
    jins = [jnp.asarray(x) for x in ins]

    def jfn(*diff):
        full = list(jins)
        for i, d in zip(wrt, diff):
            full[i] = d
        return _tuple(jreg.get_op(name).fn(*full, **attrs))[0]

    out = jax.eval_shape(jfn, *[jins[i] for i in wrt])
    cot = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    jg = _jit(lambda c, *d: jax.vjp(jfn, *d)[1](c), jit)(
        jnp.asarray(cot), *[jins[i] for i in wrt])
    tins = [torch.from_numpy(np.asarray(x)) for x in ins]
    for i in wrt:
        tins[i].requires_grad_(True)
    tout = _tuple(treg.get_op(name).fn(*tins, **attrs))[0]
    tg = torch.autograd.grad(tout, [tins[i] for i in wrt],
                             torch.from_numpy(cot))
    for i, a, b in zip(wrt, jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=GRAD_TOL,
                                   atol=GRAD_TOL,
                                   err_msg="%s d/d input %d" % (name, i))


def test_the_names_are_registered_in_both():
    for name in CONTRIB_NAMES + DEFORMABLE_NAMES:
        t, j = treg.get_op(name), jreg.get_op(name)
        assert (t.num_inputs, t.differentiable) == (j.num_inputs,
                                                    j.differentiable)


def _boxes(rng, n, scale=1.0):
    xy = rng.rand(n, 2) * 0.7
    wh = rng.rand(n, 2) * 0.3 + 0.01
    return (np.concatenate([xy, xy + wh], axis=1) * scale).astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rng = np.random.RandomState(1)
    a = _boxes(rng, 7)[None].repeat(2, 0)
    b = _boxes(rng, 5)[None].repeat(2, 0)
    b[0, 0] = a[0, 0]
    run_both("_contrib_box_iou", [a, b], {"format": fmt})


@pytest.mark.parametrize("name", ["_contrib_box_nms", "_contrib_nms",
                                  "_contrib_box_non_maximum_suppression"])
def test_box_nms_names(name):
    rng = np.random.RandomState(2)
    data = np.concatenate([rng.randint(0, 2, (2, 16, 1)), rng.rand(2, 16, 1),
                           _boxes(rng, 16)[None].repeat(2, 0)], axis=2)
    data[:, 1::4, 2:] = data[:, 0::4, 2:]
    out = run_both(name, [data.astype(np.float32)],
                   {"overlap_thresh": 0.4, "id_index": 0})[0]
    assert (out == -1).all(axis=2).any()


@pytest.mark.parametrize("name", ["_contrib_MultiBoxPrior", "MultiBoxPrior"])
@pytest.mark.parametrize("attrs", [
    {"sizes": (0.2, 0.35), "ratios": (1.0, 2.0, 0.5)},
    {"sizes": "(0.5, 0.75)", "ratios": "[1, 3]", "clip": True},
    {"sizes": (0.3,), "steps": (0.1, 0.125), "offsets": (0.2, 0.4)}])
def test_multibox_prior(name, attrs):
    out = run_both(name, [np.zeros((2, 4, 5, 6), np.float32)], attrs)[0]
    assert out.shape[0] == 1 and out.shape[2] == 4


def _rois(rng, R, N, side):
    b = _boxes(rng, R, side * 0.9)
    return np.concatenate([rng.randint(0, N, (R, 1)), b],
                          axis=1).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_roi_pooling_and_gradient(scale):
    rng = np.random.RandomState(3)
    data = rng.randn(2, 3, 9, 11).astype(np.float32)
    rois = _rois(rng, 5, 2, 10 / scale)
    rois[0, 1:] = [-3, -3, 0.2, 0.2]          # a roi off the map's corner
    attrs = {"pooled_size": (3, 2), "spatial_scale": scale}
    run_both("ROIPooling", [data, rois], attrs)
    grads_both("ROIPooling", [data, rois], attrs, wrt=(0,))


@pytest.mark.parametrize("attrs", [
    {"pooled_size": (2, 3), "spatial_scale": 1.0},
    {"pooled_size": (2, 2), "spatial_scale": 0.5, "sample_ratio": 3,
     "aligned": True}])
def test_roi_align_and_gradient(attrs):
    rng = np.random.RandomState(4)
    data = rng.randn(2, 3, 10, 12).astype(np.float32)
    rois = _rois(rng, 3, 2, 10 / attrs["spatial_scale"])
    run_both("_contrib_ROIAlign", [data, rois], attrs, jit=False)
    grads_both("_contrib_ROIAlign", [data, rois], attrs, wrt=(0, 1),
               jit=False)


@pytest.mark.parametrize("name", ["quadratic", "_contrib_quadratic"])
def test_quadratic(name):
    x = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    run_both(name, [x], {"a": 0.5, "b": -2.0, "c": 0.25})
    grads_both(name, [x], {"a": 0.5, "b": -2.0, "c": 0.25}, wrt=(0,))


def test_allclose():
    rng = np.random.RandomState(6)
    a = rng.randn(4, 5).astype(np.float32)
    assert run_both("_contrib_allclose", [a, a + 1e-7], {})[0] == 1.0
    assert run_both("_contrib_allclose", [a, a + 1e-2],
                    {"rtol": 1e-5, "atol": 1e-8})[0] == 0.0
    n = a.copy()
    n[0, 0] = np.nan
    assert run_both("_contrib_allclose", [n, n], {})[0] == 1.0
    assert run_both("_contrib_allclose", [n, n], {"equal_nan": False})[0] \
        == 0.0


@pytest.mark.parametrize("attrs", [{}, {"start": 2.0, "step": 0.5},
                                   {"axis": 1, "step": 3.0}])
def test_arange_like(attrs):
    run_both("_contrib_arange_like", [np.zeros((2, 3, 4), np.float32)],
             attrs)


def test_index_copy():
    rng = np.random.RandomState(7)
    old = rng.randn(6, 3).astype(np.float32)
    new = rng.randn(2, 3).astype(np.float32)
    run_both("_contrib_index_copy",
             [old, np.array([4, 1], np.int32), new], {})


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_getnnz(axis):
    x = np.random.RandomState(8).randn(4, 5).astype(np.float32)
    x[x < 0.3] = 0
    out = run_both("_contrib_getnnz", [x], {"axis": axis})[0]
    assert out.dtype == np.int32


def test_div_sqrt_dim():
    x = np.random.RandomState(9).randn(2, 3, 8).astype(np.float32)
    run_both("_contrib_div_sqrt_dim", [x], {})
    grads_both("_contrib_div_sqrt_dim", [x], {}, wrt=(0,))


@pytest.mark.parametrize("two_d", [False, True])
def test_count_sketch(two_d):
    rng = np.random.RandomState(10)
    data = rng.randn(3, 7).astype(np.float32)
    h = rng.randint(0, 4, 7).astype(np.float32)
    s = rng.choice([-1.0, 1.0], 7).astype(np.float32)
    if two_d:
        h, s = h[None], s[None]
    run_both("_contrib_count_sketch", [data, h, s], {"out_dim": 4})


# ---------------------------------------------------------------------------
# the deformable family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", [
    dict(C=4, F=6, k=3, stride=1, pad=1, dilate=1, groups=1, dg=1,
         bias=True),
    dict(C=4, F=4, k=3, stride=2, pad=0, dilate=2, groups=2, dg=2,
         bias=False),
    dict(C=6, F=3, k=2, stride=1, pad=1, dilate=1, groups=1, dg=3,
         bias=True)])
def test_deformable_convolution_and_gradients(cfg):
    rng = np.random.RandomState(11)
    N, H, W, k = 2, 7, 8, cfg["k"]
    Ho = (H + 2 * cfg["pad"] - (cfg["dilate"] * (k - 1) + 1)) \
        // cfg["stride"] + 1
    Wo = (W + 2 * cfg["pad"] - (cfg["dilate"] * (k - 1) + 1)) \
        // cfg["stride"] + 1
    data = rng.randn(N, cfg["C"], H, W).astype(np.float32)
    offset = (rng.randn(N, 2 * cfg["dg"] * k * k, Ho, Wo) * 1.5) \
        .astype(np.float32)
    weight = rng.randn(cfg["F"], cfg["C"] // cfg["groups"], k,
                       k).astype(np.float32)
    ins = [data, offset, weight]
    attrs = {"kernel": (k, k), "stride": (cfg["stride"],) * 2,
             "pad": (cfg["pad"],) * 2, "dilate": (cfg["dilate"],) * 2,
             "num_filter": cfg["F"], "num_group": cfg["groups"],
             "num_deformable_group": cfg["dg"],
             "no_bias": not cfg["bias"]}
    if cfg["bias"]:
        ins.append(rng.randn(cfg["F"]).astype(np.float32))
    run_both("_contrib_DeformableConvolution", ins, attrs, tol=1e-4)
    grads_both("_contrib_DeformableConvolution", ins, attrs,
               wrt=tuple(range(len(ins))))


@pytest.mark.parametrize("name", ["_contrib_PSROIPooling", "PSROIPooling",
                                  "_contrib_DeformablePSROIPooling"])
def test_psroi_pooling_and_gradient(name):
    rng = np.random.RandomState(12)
    P, od = 2, 2
    data = rng.randn(2, od * P * P, 12, 10).astype(np.float32)
    rois = _rois(rng, 4, 2, 16)
    attrs = {"spatial_scale": 0.625, "output_dim": od, "pooled_size": P}
    if name == "_contrib_DeformablePSROIPooling":
        attrs.update(no_trans=True, group_size=P)
    run_both(name, [data, rois], attrs)
    grads_both(name, [data, rois], attrs, wrt=(0,))


def test_deformable_psroi_learned_offsets_raise():
    data = np.zeros((1, 9, 4, 4), np.float32)
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    trans = np.zeros((1, 2, 3, 3), np.float32)
    for reg, arr in ((treg, torch.from_numpy), (jreg, jnp.asarray)):
        with pytest.raises(NotImplementedError):
            reg.get_op("_contrib_DeformablePSROIPooling").fn(
                arr(data), arr(rois), arr(trans), output_dim=1,
                pooled_size=3, trans_std=0.1)
