"""The registry ops of this slice held against the JAX package's on the
CPU: the rest of ops/tensor.py (cbrt to the ``linalg_*`` ops, ordering,
slicing, scatter, init ops) and the 68 aliases of ported ops, each name
its own case, through both packages' ``mx.nd`` on the same seeded numpy
inputs.

Values agree at rtol 1e-5 / atol 1e-6 with the same dtype; the
differentiable ops also give the same input gradients through
``autograd.record()`` + ``backward`` at rtol/atol 1e-5.  Bounds stated per
op: the ``linalg_*`` factorizations and inverses (potrf, potri, trsm) at
rtol/atol 1e-4 on well-conditioned matrices; gelqf and syevd by
reconstruction and up to each row's sign, since LAPACK and cuSOLVER pick
signs freely.  Ordering ops run on distinct values (ties order
differently).  Matmul precision is pinned: JAX to "float32", torch to
"highest".
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL, GRAD_TOL, LINALG_TOL = 1e-5, 1e-6, 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


def _r(seed=0):
    return np.random.RandomState(seed)


def _any(shape, seed=0):
    return _r(seed).randn(*shape).astype(np.float32)


def _pos(shape, seed=0):
    return (_r(seed).rand(*shape) * 0.8 + 0.1).astype(np.float32)


def _away(shape, seed=0):
    """Values of either sign at least 0.2 from 0."""
    x = _any(shape, seed)
    return (np.sign(x) * (np.abs(x) + 0.2)).astype(np.float32)


def _distinct(shape, seed=0):
    n = int(np.prod(shape))
    return (_r(seed).permutation(n).astype(np.float32) / n - 0.5)\
        .reshape(shape)


def _ints(shape, hi=4, seed=0):
    return _r(seed).randint(0, hi, shape).astype(np.float32)


def _spd(n, batch=(), seed=0):
    a = _any(batch + (n, n), seed)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _lower(n, seed=0):
    a = np.tril(_any((n, n), seed))
    return (a + np.diag(np.where(np.diag(a) >= 0, 2.0, -2.0)))\
        .astype(np.float32)


def _t(a):
    return tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype)


def _j(a):
    return jmx.nd.array(a, dtype=a.dtype)


def _run(pkg, name, inputs, attrs, wrap):
    kw = dict(attrs)
    if pkg is tmx and not inputs:
        kw["ctx"] = tmx.cpu()
    out = getattr(pkg.nd, name)(*[wrap(x) for x in inputs], **kw)
    outs = out if isinstance(out, list) else [out]
    return [o.asnumpy() for o in outs]


def _same(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


X = _any((3, 4))
NAN = np.array([[1.5, np.nan, 2.0], [np.nan, np.nan, 0.5]], np.float32)
CASES = [
    ("cbrt", [_away((3, 4))], {}),
    ("rcbrt", [_away((3, 4))], {}),
    ("nansum", [NAN], {}),
    ("nansum", [NAN], {"axis": 1}),
    ("nanprod", [NAN], {"axis": 0, "keepdims": True}),
    ("nanprod", [NAN], {}),
    ("hard_sigmoid", [X * 4], {}),
    ("hard_sigmoid", [X * 4], {"alpha": 0.3, "beta": 0.4}),
    ("moveaxis", [_any((2, 3, 4))], {"source": 0, "destination": -1}),
    ("slice", [_any((4, 5))], {"begin": (1, 0), "end": (3, 4)}),
    ("slice", [_any((4, 5))], {"begin": (0, 4), "end": (4, None),
                               "step": (2, -2)}),
    ("crop", [_any((4, 5))], {"begin": (1,), "end": (3,)}),
    ("slice_like", [_any((4, 5)), _any((2, 3), 1)], {}),
    ("slice_like", [_any((4, 5)), _any((2, 3), 1)], {"axes": (1,)}),
    ("SliceChannel", [_any((2, 6))], {"num_outputs": 3}),
    ("split", [_any((4, 3))], {"num_outputs": 2, "axis": 0,
                               "squeeze_axis": False}),
    ("split", [_any((2, 3))], {"num_outputs": 3, "axis": 1,
                               "squeeze_axis": True}),
    ("tile", [X], {"reps": (2, 1)}),
    ("tile", [X], {"reps": (2, 1, 3)}),
    ("repeat", [X], {"repeats": 2, "axis": 0}),
    ("repeat", [X], {"repeats": 3}),
    ("reverse", [_any((2, 3, 4))], {"axis": 1}),
    ("flip", [_any((2, 3, 4))], {"axis": (0, 2)}),
    ("depth_to_space", [_any((1, 8, 2, 3))], {"block_size": 2}),
    ("space_to_depth", [_any((1, 2, 4, 6))], {"block_size": 2}),
    ("diag", [_any((4,))], {}),
    ("diag", [_any((4,))], {"k": -1}),
    ("diag", [X], {"k": 1}),
    ("diag", [_any((2, 3, 4))], {"axis1": 1, "axis2": 2}),
    ("shape_array", [_any((2, 3, 4))], {}),
    ("size_array", [_any((2, 3, 4))], {}),
    ("batch_take", [X, np.array([0, 3, 1], np.float32)], {}),
    ("one_hot", [np.array([0, 2, 1, 5], np.float32)], {"depth": 4}),
    ("one_hot", [np.array([[1, 0], [3, 2]], np.float32)],
     {"depth": 4, "on_value": 2.0, "off_value": -1.0}),
    ("gather_nd", [X, np.array([[0, 2], [1, 3]], np.float32)], {}),
    ("gather_nd", [_any((2, 3, 4)), np.array([[1, 0]], np.float32)], {}),
    ("scatter_nd", [np.array([1.5, -2.0], np.float32),
                    np.array([[0, 2], [1, 3]], np.float32)],
     {"shape": (3, 4)}),
    ("_linspace", [], {"start": -1.0, "stop": 2.0, "num": 7}),
    ("_linspace", [], {"start": 0.0, "stop": 1.0, "num": 5,
                       "endpoint": False}),
    ("_eye", [], {"N": 3}),
    ("_eye", [], {"N": 3, "M": 5, "k": 1}),
    ("_eye", [], {"N": 4, "M": 2, "k": -1, "dtype": "int32"}),
    ("sort", [_distinct((3, 5))], {}),
    ("sort", [_distinct((3, 5))], {"axis": 0, "is_ascend": False}),
    ("sort", [_distinct((3, 5))], {"axis": None}),
    ("argsort", [_distinct((3, 5))], {}),
    ("argsort", [_distinct((3, 5))], {"axis": 0, "is_ascend": False,
                                      "dtype": "int32"}),
    ("topk", [_distinct((3, 5))], {"k": 2}),
    ("topk", [_distinct((3, 5))], {"k": 2, "axis": 0,
                                   "ret_typ": "value"}),
    ("topk", [_distinct((3, 5))], {"k": 3, "ret_typ": "both",
                                   "is_ascend": True}),
    ("topk", [_distinct((3, 5))], {"k": 2, "ret_typ": "mask"}),
    ("topk", [_distinct((3, 5))], {"k": 4, "axis": None}),
    ("smooth_l1", [X * 2], {}),
    ("smooth_l1", [X * 2], {"scalar": 2.0}),
    ("softmin", [X], {}),
    ("softmin", [X], {"axis": 0}),
    ("khatri_rao", [_any((2, 3)), _any((4, 3), 1)], {}),
    ("khatri_rao", [_any((2, 3)), _any((2, 3), 1), _any((3, 3), 2)], {}),
    ("_scatter_elemwise_div", [X, _pos((3, 4), 1)], {}),
    ("_scatter_plus_scalar", [X], {"scalar": 1.5}),
    ("_scatter_minus_scalar", [X], {"scalar": 1.5}),
]
for _p in ("_", ""):
    CASES += [
        (_p + "linalg_gemm", [_any((3, 4)), _any((4, 2), 1),
                              _any((3, 2), 2)],
         {"alpha": 1.5, "beta": 0.5}),
        (_p + "linalg_gemm", [_any((2, 4, 3)), _any((2, 2, 4), 1),
                              _any((2, 3, 2), 2)],
         {"transpose_a": True, "transpose_b": True}),
        (_p + "linalg_gemm2", [_any((3, 4)), _any((4, 2), 1)],
         {"alpha": 2.0}),
        (_p + "linalg_gemm2", [_any((2, 3, 4)), _any((2, 3, 5), 1)],
         {"transpose_a": True}),
        (_p + "linalg_potrf", [_spd(4)], {}),
        (_p + "linalg_potri", [np.linalg.cholesky(_spd(4))
                               .astype(np.float32)], {}),
        (_p + "linalg_potri", [np.linalg.cholesky(_spd(4)).T
                               .astype(np.float32)], {"lower": False}),
        (_p + "linalg_trmm", [_lower(3), _any((3, 2), 1)], {"alpha": 2.0}),
        (_p + "linalg_trmm", [_lower(3), _any((2, 3), 1)],
         {"rightside": True, "transpose": True}),
        (_p + "linalg_trmm", [_lower(3).T.copy(), _any((3, 2), 1)],
         {"lower": False}),
        (_p + "linalg_trsm", [_lower(3), _any((3, 2), 1)], {"alpha": 0.5}),
        (_p + "linalg_trsm", [_lower(3), _any((3, 2), 1)],
         {"transpose": True}),
        (_p + "linalg_trsm", [_lower(3), _any((2, 3), 1)],
         {"rightside": True}),
        (_p + "linalg_trsm", [_lower(3).T.copy(), _any((2, 3), 1)],
         {"rightside": True, "lower": False, "transpose": True}),
        (_p + "linalg_syrk", [_any((3, 4))], {}),
        (_p + "linalg_syrk", [_any((2, 3, 4))], {"transpose": True,
                                                 "alpha": 0.5}),
        (_p + "linalg_sumlogdiag", [_spd(4, (2,))], {}),
        (_p + "linalg_extractdiag", [_any((2, 4, 4))], {}),
        (_p + "linalg_extractdiag", [_any((4, 4))], {"offset": -1}),
    ]
LINALG_LOOSE = ("linalg_potrf", "linalg_potri", "linalg_trsm")


def _case_id(case):
    name, inputs, attrs = case
    shape = "x".join(str(s) for s in inputs[0].shape) if inputs else "none"
    return "%s-%s-%s" % (name, shape, "-".join(
        "%s=%s" % kv for kv in sorted(attrs.items())) or "default")


def _tol(name):
    return (LINALG_TOL, LINALG_TOL) if name.lstrip("_") in LINALG_LOOSE \
        else (RTOL, ATOL)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_op_matches_jax(case):
    name, inputs, attrs = case
    rtol, atol = _tol(name)
    _same(_run(tmx, name, inputs, attrs, _t),
          _run(jmx, name, inputs, attrs, _j), rtol, atol)


NO_GRAD = ("one_hot", "shape_array", "size_array", "sort", "argsort",
           "topk", "scatter_nd", "_linspace", "_eye", "SliceChannel",
           "split")
INDEX_INPUT = {"batch_take": 1, "gather_nd": 1, "slice_like": 1}
GRAD_CASES = [c for c in CASES
              if c[0] not in NO_GRAD and treg.get_op(c[0]).differentiable
              and not (c[0].startswith("nan") and np.isnan(c[1][0]).any())]


def _grads(pkg, name, inputs, attrs, wrap, seed=5):
    arrays = [wrap(x) for x in inputs]
    diff = [i for i in range(len(inputs)) if INDEX_INPUT.get(name) != i]
    for i in diff:
        arrays[i].attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, name)(*arrays, **attrs)
    head = np.asarray(_r(seed).randn(*out.shape), np.float32)
    out.backward(wrap(head))
    return [arrays[i].grad.asnumpy() for i in diff]


def _sym(g):
    return (g + np.swapaxes(g, -1, -2)) / 2


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[_case_id(c) for c in GRAD_CASES])
def test_op_gradient_matches_jax(case):
    name, inputs, attrs = case
    got = _grads(tmx, name, inputs, attrs, _t)
    want = _grads(jmx, name, inputs, attrs, _j)
    if name.lstrip("_") == "linalg_potrf":
        # defined on symmetric matrices only: the two packages spread
        # the gradient over A's two triangles differently, so compare its
        # symmetric part (the gradient along symmetric directions)
        got, want = [_sym(g) for g in got], [_sym(g) for g in want]
    tol = LINALG_TOL if name.lstrip("_") in LINALG_LOOSE else GRAD_TOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _row_signs(a, b):
    """Signs that turn b's rows into a's."""
    return np.sign(np.sum(a * b, axis=-1, keepdims=True))


@pytest.mark.parametrize("prefix", ["_", ""])
@pytest.mark.parametrize("shape", [(3, 5), (2, 3, 4)])
def test_gelqf_by_reconstruction_and_sign(prefix, shape):
    a = _any(shape, 3)
    (tq, tl), (jq, jl) = (_run(pkg, prefix + "linalg_gelqf", [a], {}, w)
                          for pkg, w in ((tmx, _t), (jmx, _j)))
    for q, low in ((tq, tl), (jq, jl)):
        np.testing.assert_allclose(low @ q, a, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(q @ np.swapaxes(q, -1, -2),
                                   np.broadcast_to(np.eye(shape[-2]),
                                                   q.shape[:-1]
                                                   + (shape[-2],)),
                                   atol=1e-5)
    s = _row_signs(jq, tq)
    np.testing.assert_allclose(tq * s, jq, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl * np.swapaxes(s, -1, -2), jl, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("prefix", ["_", ""])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_syevd_by_reconstruction_and_sign(prefix, batch):
    a = _spd(4, batch, 4)
    (tu, tl), (ju, jl) = (_run(pkg, prefix + "linalg_syevd", [a], {}, w)
                          for pkg, w in ((tmx, _t), (jmx, _j)))
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    for u, lam in ((tu, tl), (ju, jl)):
        recon = np.swapaxes(u, -1, -2) @ (lam[..., :, None] * u)
        np.testing.assert_allclose(recon, a, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tu * _row_signs(ju, tu), ju, rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the 68 aliases of ported ops
# ---------------------------------------------------------------------------

def _alias_inputs(canonical):
    y = _pos((3, 4), 1) + 0.5
    if canonical.startswith("elemwise_"):
        return [X, y], {}
    if canonical.startswith("broadcast_logical") or canonical in (
            "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
            "broadcast_greater_equal", "broadcast_lesser",
            "broadcast_lesser_equal"):
        return [_ints((3, 4)), _ints((1, 4), 3, 1)], {}
    if canonical == "broadcast_power":
        return [_pos((3, 4)) + 0.5, _any((1, 4), 1)], {}
    if canonical.startswith("broadcast_"):
        return [X, _pos((1, 4), 1) + 0.5], {}
    if canonical.endswith("_scalar"):
        base = _ints((3, 4), 3) if "logical" in canonical or any(
            c in canonical for c in ("equal", "greater", "lesser")) \
            else _pos((3, 4)) + 0.5
        return [base], {"scalar": 2.0 if "logical" in canonical
                        or base.max() >= 1.5 else 1.5}
    if canonical == "BatchNorm":
        return [_any((2, 3, 4, 4)), _pos((3,), 1), _any((3,), 2),
                _any((3,), 3), _pos((3,), 4)], {"fix_gamma": False}
    if canonical == "Convolution":
        return [_any((1, 2, 5, 5)), _any((3, 2, 3, 3), 1), _any((3,), 2)], \
            {"kernel": (3, 3), "num_filter": 3, "pad": (1, 1)}
    if canonical == "Pooling":
        return [_any((1, 2, 4, 4))], {"kernel": (2, 2), "stride": (2, 2),
                                      "pool_type": "max"}
    if canonical == "Embedding":
        return [np.array([[0, 3], [2, 2]], np.float32), _any((4, 5), 1)], \
            {"input_dim": 4, "output_dim": 5}
    if canonical == "pick":
        return [X, np.array([0, 3, 1], np.float32)], {}
    if canonical == "Concat":
        return [X, _any((2, 4), 1)], {"dim": 0}
    raise KeyError(canonical)


# canonical ops whose aliases this slice registered
_ALIAS_CANONICAL = (
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "broadcast_add", "broadcast_sub", "broadcast_mod", "broadcast_power",
    "broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
    "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
    "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal",
    "broadcast_logical_and", "broadcast_logical_or", "broadcast_logical_xor",
    "_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
    "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
    "_power_scalar", "_rpower_scalar", "_maximum_scalar", "_minimum_scalar",
    "_hypot_scalar", "_equal_scalar", "_not_equal_scalar", "_greater_scalar",
    "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar",
    "_logical_and_scalar", "_logical_or_scalar", "_logical_xor_scalar",
    "Concat", "BatchNorm", "Convolution", "Pooling", "Embedding", "pick")
# the aliases that were in the port before this slice (tests elsewhere)
_EARLIER = ("_add", "_sub", "_mul", "_div", "concat", "cast", "reshape",
            "flatten", "SwapAxis", "broadcast_axes", "sum_axis", "max_axis",
            "min_axis", "stop_gradient", "pad")
ALIASES = sorted(n for n in jreg.list_ops()
                 if jreg.get_op(n).name != n and n not in _EARLIER
                 and jreg.get_op(n).name in _ALIAS_CANONICAL)


def test_alias_count():
    assert len(ALIASES) == 68
    assert len(treg.list_ops()) >= 329


@pytest.mark.parametrize("name", ALIASES)
def test_alias_matches_jax(name):
    canonical = treg.get_op(name).name
    assert jreg.get_op(name).name == canonical
    inputs, attrs = _alias_inputs(canonical)
    _same(_run(tmx, name, inputs, attrs, _t),
          _run(jmx, name, inputs, attrs, _j))
