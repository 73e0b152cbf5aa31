"""The 56 registry names of mxnet_tpu/ops/extended.py new to the port, held
against the JAX package's ops on the CPU: each deterministic name at the
JAX suite's shapes (tests/test_extended_ops.py, test_op_parity2.py) is a
case of one parametrised test through both packages' ``mx.nd``, on the
same seeded numpy inputs.

A case compares every output and every input after the call (the update
ops write their weights and states in place) at rtol 1e-5 / atol 1e-6
with the same shape and dtype; the differentiable ones also compare the
input gradients of sum(output * cotangent) through
``autograd.record()`` at the same bounds.  ``_image_resize``'s bilinear
route is held to atol 1e-4 on [0, 255] values (4e-7 of the range:
torch's antialiased bilinear and ``jax.image.resize`` sum their taps in
another order; 3.1e-5 at most seen).  The samplers are held to the JAX
op's shape and dtype and to their distribution's mean and variance
within 5 standard errors over 10^5 draws.  Matmul precision is pinned:
JAX to "float32", torch to "highest".
"""
import math

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL = 1e-5, 1e-6
RESIZE_ATOL = 1e-4
DRAWS, SE = 10 ** 5, 5.0


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _r(seed):
    return np.random.RandomState(seed)


def _f(*shape, seed=0):
    return np.asarray(_r(seed).randn(*shape), np.float32)


def _pos(*shape, seed=0):
    return (_r(seed).rand(*shape) + 0.5).astype(np.float32)


def _img(*shape, seed=0):
    return _r(seed).randint(0, 256, shape).astype(np.uint8)


def _grid(n, h, w, seed=0):
    return (_r(seed).rand(n, 2, h, w) * 2.2 - 1.1).astype(np.float32)


def _theta(n, seed=0):
    eye = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), (n, 1))
    return eye + 0.1 * _f(n, 6, seed=seed)


def _multi(n_w, per, seed=0, mp=False):
    """Interleaved update inputs: per weight (w, g) + states."""
    arrays = []
    for i in range(n_w):
        shape = (4,) if i == 0 else (3, 2)
        w32 = _f(*shape, seed=seed + 3 * i)
        w = w32.astype(np.float16) if mp else w32
        g = _f(*shape, seed=seed + 3 * i + 1)
        if mp:
            g = g.astype(np.float16)
        states = [0.1 * _f(*shape, seed=seed + 3 * i + 2)] \
            if per in (3, 4) else []
        if mp:
            states.append(w32.copy())
        arrays += [w, g] + states
    return arrays


LR2 = {"num_weights": 2, "lrs": (0.1, 0.2), "wds": (0.01, 0.0),
       "rescale_grad": 0.5, "clip_gradient": 0.3}

# (name, inputs, attrs, differentiable)
CASES = [
    ("add_n", [_f(2, 3), _f(2, 3, seed=1), _f(2, 3, seed=2)], {}, True),
    ("ElementWiseSum", [_f(2, 3), _f(2, 3, seed=1)], {}, True),
    ("round", [np.array([1.4, 2.6, -0.5, 2.5, -1.5, 0.49], np.float32)],
     {}, True),
    ("round", [_f(3, 4) * 3], {}, True),
    ("reshape_like", [_f(2, 3), _f(3, 2, seed=1)], {}, True),
    ("_identity_with_attr_like_rhs", [_f(2, 3), _f(3, 2, seed=1)], {},
     True),
    ("_zeros_without_dtype", [], {"shape": (2, 3)}, False),
    ("_zeros_without_dtype", [], {"shape": (4,), "dtype": "int32"}, False),
    ("_histogram", [np.array([0.1, 0.4, 0.6, 0.9], np.float32)],
     {"bin_cnt": 2, "range": (0.0, 1.0)}, False),
    ("_histogram", [_f(50)], {"bin_cnt": 5}, False),
    ("_histogram", [np.full(6, 2.0, np.float32)], {"bin_cnt": 3}, False),
    ("_histogram", [_f(40), np.array([-1.0, 0.0, 0.5, 2.0], np.float32)],
     {}, False),
    ("_ravel_multi_index", [np.array([[0, 1, 2], [2, 0, 3]], np.float32)],
     {"shape": (3, 4)}, False),
    ("ravel_multi_index", [np.array([[1, 0], [2, 3], [0, 4]], np.float32)],
     {"shape": (2, 4, 5)}, False),
    ("_unravel_index", [np.array([2, 4, 11], np.float32)],
     {"shape": (3, 4)}, False),
    ("unravel_index", [np.array([0, 17, 39], np.float32)],
     {"shape": (2, 4, 5)}, False),
    ("_square_sum", [_f(3, 4)], {"axis": 1, "keepdims": True}, True),
    ("_square_sum", [_f(3, 4)], {}, True),
    ("_split_v2", [_f(3, 4)], {"indices": (1, 2), "axis": 0}, True),
    ("_split_v2", [_f(4, 2)], {"sections": 2, "axis": 1,
                               "squeeze_axis": True}, True),
    ("_split_v2", [_f(5, 2)], {"indices": (0, 2)}, True),
    ("_slice_assign", [_f(4, 5), _f(2, 2, seed=1)],
     {"begin": (0, 1), "end": (2, 3)}, True),
    ("_crop_assign", [_f(4, 5), _f(2, 3, seed=1)],
     {"begin": (3, 4), "end": (0, 1), "step": (-2, -1)}, True),
    ("_slice_assign_scalar", [_f(3, 4)],
     {"scalar": -1.0, "begin": (0, 0), "end": (2, 2)}, True),
    ("_crop_assign_scalar", [_f(4, 5)],
     {"scalar": 2.5, "begin": (1, 0), "end": (4, 5), "step": (2, 2)}, True),
    ("cast_storage", [_f(2, 3)], {"stype": "default"}, False),
    ("_contrib_gradientmultiplier", [_f(2, 3)], {"scalar": -2.0}, True),
    ("IdentityAttachKLSparseReg", [_f(2, 3)], {"penalty": 0.01}, True),
    ("BilinearSampler", [_f(2, 3, 5, 6), _grid(2, 4, 3)], {}, True),
    ("BilinearSampler", [np.arange(16, dtype=np.float32)
                         .reshape(1, 1, 4, 4),
                         np.stack(np.meshgrid(np.linspace(-1, 1, 4),
                                              np.linspace(-1, 1, 4))[::-1]
                                  [::-1])[None].astype(np.float32)],
     {}, False),
    ("GridGenerator", [_theta(2)], {"transform_type": "affine",
                                    "target_shape": (3, 4)}, True),
    ("GridGenerator", [_f(2, 2, 3, 4)], {"transform_type": "warp"}, True),
    ("SpatialTransformer", [_f(2, 3, 5, 5), _theta(2, seed=1)],
     {"target_shape": (4, 4), "transform_type": "affine",
      "sampler_type": "bilinear"}, True),
    ("Crop", [_f(1, 2, 6, 6)], {"h_w": (3, 4), "offset": (1, 2)}, True),
    ("Crop", [_f(1, 2, 7, 6)], {"h_w": (3, 4), "center_crop": True}, True),
    ("Crop", [_f(1, 2, 6, 6), _f(1, 2, 2, 3, seed=1)],
     {"num_args": 2, "offset": (2, 1)}, False),
    ("_contrib_AdaptiveAvgPooling2D", [_f(1, 2, 7, 5)],
     {"output_size": (3, 2)}, True),
    ("_contrib_AdaptiveAvgPooling2D", [_f(2, 3, 4, 4)],
     {"output_size": (1,)}, True),
    ("_contrib_AdaptiveAvgPooling2D", [_f(1, 1, 4, 4)],
     {"output_size": (2, 2)}, True),
    ("_contrib_fft", [_f(2, 8)], {}, False),
    ("_contrib_fft", [_f(3, 2, 5)], {}, False),
    ("_contrib_ifft", [_f(2, 16)], {}, False),
    ("_contrib_boolean_mask", [_f(4, 3), np.array([1, 0, 1, 0],
                                                   np.float32)], {}, True),
    ("boolean_mask", [_f(2, 3), np.array([0, 1, 1], np.float32)],
     {"axis": 1}, True),
    ("_contrib_bipartite_matching",
     [np.array([[[0.9, 0.1], [0.2, 0.8]]], np.float32)],
     {"threshold": 0.5}, False),
    ("_contrib_bipartite_matching",
     [np.array([[0.5, 0.1], [0.2, 0.3]], np.float32)],
     {"threshold": 0.5}, False),
    ("_contrib_bipartite_matching", [_r(3).rand(2, 4, 3).astype(np.float32)],
     {"threshold": 0.3}, False),
    ("_contrib_bipartite_matching", [_r(4).rand(3, 5).astype(np.float32)],
     {"threshold": 0.6, "is_ascend": True, "topk": 2}, False),
    ("_image_to_tensor", [_img(6, 8, 3)], {}, False),
    ("_image_to_tensor", [_img(2, 6, 8, 3)], {}, False),
    ("_image_normalize", [_r(5).rand(3, 6, 8).astype(np.float32)],
     {"mean": (0.5, 0.4, 0.3), "std": (0.2, 0.3, 0.4)}, True),
    ("_image_normalize", [_r(5).rand(2, 3, 4, 5).astype(np.float32)],
     {"mean": (0.5, 0.4, 0.3), "std": (0.2, 0.3, 0.4)}, True),
    ("_image_resize", [_img(6, 8, 3)], {"size": (4, 3)}, False),
    ("_image_resize", [_img(6, 8, 3)], {"size": (12, 10)}, False),
    ("_image_resize", [_img(2, 6, 8, 3)], {"size": (5,)}, False),
    ("_image_resize", [_img(6, 8, 3)], {"size": (5, 9), "interp": 0},
     False),
    ("_image_resize", [_img(2, 6, 8, 3)], {"size": (16, 3), "interp": 0},
     False),
    ("_image_crop", [_img(6, 8, 3)], {"x": 1, "y": 2, "width": 4,
                                      "height": 3}, False),
    ("_image_crop", [_img(2, 6, 8, 3)], {"x": 0, "y": 1, "width": 5,
                                         "height": 4}, False),
    ("multi_sgd_update", _multi(2, 2), LR2, False),
    ("multi_sgd_mom_update", _multi(2, 3), dict(LR2, momentum=0.9), False),
    ("multi_mp_sgd_update", _multi(2, 2, mp=True), LR2, False),
    ("multi_mp_sgd_mom_update", _multi(2, 3, mp=True),
     dict(LR2, momentum=0.9), False),
    ("_mp_adamw_update", [_f(3).astype(np.float16),
                          (0.1 * _f(3, seed=1)).astype(np.float16),
                          0.01 * _f(3, seed=2), 0.01 * _pos(3, seed=3),
                          _f(3)],
     {"lr": 0.1, "wd": 0.01, "eta": 0.5, "clip_gradient": 0.05,
      "rescale_grad": 2.0}, False),
    ("_contrib_group_adagrad_update", [_f(4, 3), _f(4, 3, seed=1),
                                       _pos(4, 1, seed=2)],
     {"lr": 0.1, "rescale_grad": 0.5, "clip_gradient": 0.4}, False),
    ("_scatter_set_nd", [np.zeros((3, 4), np.float32),
                         np.array([[0, 2], [1, 3]], np.float32),
                         np.array([5.0, 7.0], np.float32)],
     {"shape": (3, 4)}, False),
    ("Correlation", [_r(4).rand(2, 3, 7, 7).astype(np.float32),
                     _r(5).rand(2, 3, 7, 7).astype(np.float32)],
     {"kernel_size": 1, "max_displacement": 1, "stride1": 1, "stride2": 1,
      "pad_size": 1, "is_multiply": True}, True),
    ("Correlation", [_r(4).rand(2, 3, 7, 7).astype(np.float32),
                     _r(5).rand(2, 3, 7, 7).astype(np.float32)],
     {"kernel_size": 3, "max_displacement": 2, "stride1": 2, "stride2": 1,
      "pad_size": 2, "is_multiply": True}, True),
    ("Correlation", [_r(4).rand(2, 3, 7, 7).astype(np.float32),
                     _r(5).rand(2, 3, 7, 7).astype(np.float32)],
     {"kernel_size": 1, "max_displacement": 2, "stride1": 1, "stride2": 2,
      "pad_size": 2, "is_multiply": False}, True),
    ("_sparse_retain", [_f(5, 3), np.array([0, 3], np.float32)], {}, True),
    ("_sparse_adagrad_update", [_f(4, 3), _f(4, 3, seed=1),
                                _pos(4, 3, seed=2)],
     {"lr": 0.1, "wd": 0.01, "epsilon": 1e-7, "clip_gradient": 0.5}, False),
]

SAMPLERS = [
    # (name, parameter arrays, attrs, mean, variance)
    ("_sample_exponential", [np.array([2.0], np.float32)], {}, 0.5, 0.25),
    ("_sample_gamma", [np.array([2.5], np.float32),
                       np.array([1.5], np.float32)], {}, 3.75, 5.625),
    ("_sample_poisson", [np.array([3.5], np.float32)], {}, 3.5, 3.5),
    ("_sample_negative_binomial", [np.array([3.0], np.float32),
                                   np.array([0.4], np.float32)], {},
     4.5, 11.25),
    ("_sample_generalized_negative_binomial",
     [np.array([2.0], np.float32), np.array([0.5], np.float32)], {},
     2.0, 4.0),
    ("_random_uniform_like", [np.zeros((DRAWS,), np.float32)],
     {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
    ("_random_normal_like", [np.zeros((DRAWS,), np.float32)],
     {"loc": 0.5, "scale": 2.0}, 0.5, 4.0),
    ("_random_exponential_like", [np.zeros((DRAWS,), np.float32)],
     {"lam": 2.0}, 0.5, 0.25),
    ("_random_gamma_like", [np.zeros((DRAWS,), np.float32)],
     {"alpha": 2.5, "beta": 1.5}, 3.75, 5.625),
    ("_random_poisson_like", [np.zeros((DRAWS,), np.float32)],
     {"lam": 3.5}, 3.5, 3.5),
    ("_random_negative_binomial_like", [np.zeros((DRAWS,), np.float32)],
     {"k": 3, "p": 0.4}, 4.5, 11.25),
    ("_random_generalized_negative_binomial_like",
     [np.zeros((DRAWS,), np.float32)], {"mu": 2.0, "alpha": 0.5}, 2.0, 4.0),
]

EXTENDED = {c[0] for c in CASES} | {s[0] for s in SAMPLERS}


def _wrap(pkg, a):
    if pkg is tmx:
        return tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype)
    return jmx.nd.array(a, dtype=a.dtype)


def _run(pkg, name, inputs, attrs, grad):
    ins = [_wrap(pkg, a) for a in inputs]
    kw = dict(attrs)
    if pkg is tmx and not inputs:
        kw["ctx"] = tmx.cpu()
    leaves = [x for x, a in zip(ins, inputs) if grad
              and a.dtype == np.float32]
    for x in leaves:
        x.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, name)(*ins, **kw)
        outs = out if isinstance(out, list) else [out]
        if leaves:
            loss = None
            for i, o in enumerate(outs):
                cot = _wrap(pkg, _f(*o.shape, seed=50 + i))
                term = (o * cot).sum()
                loss = term if loss is None else loss + term
    if leaves:
        loss.backward()
    return ([o.asnumpy() for o in outs], [x.asnumpy() for x in ins],
            [x.grad.asnumpy() for x in leaves])


def _same(got, want, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=RTOL,
                                   atol=atol)


@pytest.mark.parametrize(
    "case", CASES, ids=["%s-%d" % (c[0], i) for i, c in enumerate(CASES)])
def test_extended_op_matches_jax(case):
    name, inputs, attrs, grad = case
    got = _run(tmx, name, inputs, attrs, grad)
    want = _run(jmx, name, inputs, attrs, grad)
    atol = RESIZE_ATOL if name == "_image_resize" else ATOL
    for g, w in zip(got, want):
        _same(g, w, atol)


def test_every_new_name_has_a_case():
    new = {"_csr_matmul", "Custom"}
    missing = set(jreg.list_ops()) - set(treg.list_ops())
    assert missing == set()
    assert len(treg.list_ops()) == 451
    assert "_csr_matmul" in new and "_csr_matmul" in treg.list_ops()
    ext = {n for n in jreg.list_ops()
           if jreg.get_op(n).fn.__module__ == "mxnet_tpu.ops.extended"
           and treg.get_op(n).fn.__module__ == "mxnet_tpu_torch.ops.extended"
           and n not in ("MakeLoss", "SVMOutput")
           and not n.startswith("_contrib_quantized")
           and n != "_quantized_concat"}
    assert len(ext) == 56
    assert ext <= EXTENDED


def test_histogram_range_is_read_as_floats():
    """The port reads ``range`` as floats, as upstream does; the JAX op
    parses it with ``ptuple`` and truncates (0.25, 0.75) to (0, 0),
    whose bins are then widened to (-0.5, 0.5)."""
    x = np.array([0.1, 0.3, 0.5, 0.6, 0.7, 0.9], np.float32)
    counts, edges = tmx.nd._histogram(_wrap(tmx, x), bin_cnt=2,
                                      range=(0.25, 0.75))
    np.testing.assert_array_equal(counts.asnumpy(), [1, 3])
    np.testing.assert_allclose(edges.asnumpy(), [0.25, 0.5, 0.75])
    _, jedges = jmx.nd._histogram(_wrap(jmx, x), bin_cnt=2,
                                  range=(0.25, 0.75))
    np.testing.assert_allclose(jedges.asnumpy(), [-0.5, 0.0, 0.5])


def test_split_v2_sections_must_divide():
    with pytest.raises(tmx.base.MXNetError):
        tmx.nd._split_v2(_wrap(tmx, _f(5, 2)), sections=2)


@pytest.mark.parametrize("case", SAMPLERS, ids=[s[0] for s in SAMPLERS])
def test_sampler_shape_dtype_and_moments(case):
    name, params, attrs, mean, var = case
    kw = dict(attrs)
    if name.startswith("_sample_"):
        kw["shape"] = (DRAWS,)
    tmx.random.seed(7)
    got = getattr(tmx.nd, name)(*[_wrap(tmx, p) for p in params], **kw)
    want = getattr(jmx.nd, name)(*[_wrap(jmx, p) for p in params], **kw)
    assert got.shape == want.shape and got.dtype == want.dtype
    v = got.asnumpy().astype(np.float64).ravel()
    m = v.mean()
    dev2 = (v - m) ** 2
    zm = abs(m - mean) / math.sqrt(var / v.size)
    zv = abs(dev2.mean() - var) / (dev2.std() / math.sqrt(v.size))
    assert zm <= SE and zv <= SE, (m, mean, dev2.mean(), var)
    tmx.random.seed(7)
    again = getattr(tmx.nd, name)(*[_wrap(tmx, p) for p in params], **kw)
    np.testing.assert_array_equal(again.asnumpy(), got.asnumpy())


def test_row_wise_samplers_draw_per_parameter():
    lam = _wrap(tmx, np.array([1.0, 100.0], np.float32))
    s = tmx.nd._sample_poisson(lam, shape=(2000,))
    assert s.shape == (2, 2000)
    means = s.asnumpy().mean(axis=1)
    assert abs(means[0] - 1.0) < 0.2 and abs(means[1] - 100.0) < 2.0
    g = tmx.nd._sample_gamma(_wrap(tmx, np.array([[2.0], [5.0]],
                                                 np.float32)),
                             _wrap(tmx, np.array([[3.0], [1.0]],
                                                 np.float32)),
                             shape=(4000,))
    assert g.shape == (2, 1, 4000)
    np.testing.assert_allclose(g.asnumpy().mean(axis=-1).ravel(),
                               [6.0, 5.0], rtol=0.1)
