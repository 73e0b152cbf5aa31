"""The port's op registry and the ``mx.nd`` generated from it, held against
the JAX package's on CPU.

Each op ported here runs through both packages' ``mx.nd`` on the same
numpy inputs (shapes after tests/test_operator_sweep.py: (3, 4) and small
batches) and agrees at rtol 1e-5 / atol 1e-6 with the same dtype; the
differentiable ones also give the same input gradients through
``autograd.record()`` + ``backward`` (torch autograd against the JAX
package's tape) at rtol 1e-5 / atol 1e-5.  NDArray's operators (scalars,
arrays with broadcasting, reflected forms, comparisons, indexing) are
held to the JAX NDArray's.  Matmul precision is pinned: JAX to
"float32", torch to "highest".
"""
import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import fusion_cost as jfusion_cost
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as treg

RTOL, ATOL, GRAD_TOL = 1e-5, 1e-6, 1e-5


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


def _unit(shape, seed=0):
    return np.clip(_r(seed).randn(*shape), -0.9, 0.9).astype(np.float32)


def _ints(shape, hi=4, seed=0):
    return _r(seed).randint(0, hi, shape).astype(np.float32)


def _t(a):
    return tmx.nd.array(a, ctx=tmx.cpu(), dtype=a.dtype)


def _j(a):
    return jmx.nd.array(a, dtype=a.dtype)


def _run(pkg, name, inputs, attrs, wrap):
    out = getattr(pkg.nd, name)(*[wrap(x) for x in inputs], **attrs)
    outs = out if isinstance(out, list) else [out]
    return [o.asnumpy() for o in outs]


def _same(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


UNARY_DOMAIN = {
    "log": _pos, "log10": _pos, "log2": _pos, "log1p": _pos, "sqrt": _pos,
    "rsqrt": _pos, "reciprocal": _pos, "gammaln": _pos, "gamma": _pos,
    "arcsin": _unit, "arccos": _unit, "arctanh": _unit, "erfinv": _unit,
    "tan": _unit, "exp": _unit, "expm1": _unit, "sinh": _unit,
    "cosh": _unit, "arccosh": lambda s: _pos(s) + 1.5,
}
UNARY = ["abs", "sign", "rint", "ceil", "floor", "trunc", "fix", "square",
         "sqrt", "rsqrt", "exp", "log", "log10", "log2", "log1p", "expm1",
         "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh", "cosh",
         "tanh", "arcsinh", "arccosh", "arctanh", "degrees", "radians",
         "reciprocal", "negative", "erf", "erfinv", "gamma", "gammaln",
         "relu", "sigmoid", "softsign"]
BINARY = ["add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
          "hypot"]
COMPARE = ["equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal", "logical_and", "logical_or", "logical_xor"]
SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_power_scalar", "_rpower_scalar",
          "_mod_scalar", "_rmod_scalar", "_maximum_scalar",
          "_minimum_scalar", "_hypot_scalar"]
SCALAR_CMP = ["_equal_scalar", "_not_equal_scalar", "_greater_scalar",
              "_greater_equal_scalar", "_lesser_scalar",
              "_lesser_equal_scalar", "_logical_and_scalar",
              "_logical_or_scalar", "_logical_xor_scalar"]


def _cases():
    x, y = _any((3, 4)), _any((3, 4), seed=1)
    c = []
    for name in UNARY:
        c.append((name, [UNARY_DOMAIN.get(name, _any)((3, 4))], {}))
    for name in BINARY:
        a, b = (_pos((3, 4)) + 0.5, _any((1, 4), 1)) if name == "power" \
            else (x, _pos((1, 4), 1) + 0.5) if name == "mod" \
            else (x, _any((1, 4), 1))
        c.append(("broadcast_" + name, [a, b], {}))
    for name in ("add", "sub", "mul", "div"):
        c.append(("elemwise_" + name, [x, _pos((3, 4), 1) + 0.5], {}))
        c.append(("_" + name, [x, y], {}))
    for name in COMPARE:
        c.append(("broadcast_" + name, [_ints((3, 4)), _ints((1, 4), 3, 1)],
                  {}))
    for name in SCALAR:
        base = _pos((3, 4)) + 0.5
        c.append((name, [base], {"scalar": 1.5}))
        c.append((name, [(base * 4).astype(np.int32) + 1], {"scalar": 2}))
    for name in SCALAR_CMP:
        c.append((name, [_ints((3, 4))], {"scalar": 2}))
    for name in ("isnan", "isinf", "isfinite", "logical_not"):
        c.append((name, [np.array([[0.0, np.nan, np.inf, -1.0]],
                                  np.float32)], {}))
    for name in ("_copy", "identity", "BlockGrad", "stop_gradient",
                 "make_loss", "zeros_like", "ones_like", "relu"):
        c.append((name, [x], {}))
    c += [
        ("clip", [x * 2], {"a_min": -0.5, "a_max": 0.5}),
        ("Cast", [x * 4], {"dtype": "int32"}),
        ("cast", [x], {"dtype": "float16"}),
        ("argmax", [_ints((3, 4))], {"axis": 1}),
        ("argmax", [_ints((3, 4))], {}),
        ("argmax", [x], {"axis": 0, "keepdims": True}),
        ("argmin", [_ints((3, 4))], {"axis": 1}),
        ("argmax_channel", [x], {}),
        ("broadcast_to", [_any((1, 4))], {"shape": (3, 0)}),
        ("broadcast_axis", [_any((3, 1))], {"axis": 1, "size": 5}),
        ("broadcast_like", [_any((1, 4)), x], {}),
        ("dot", [x, _any((4, 5), 2)], {}),
        ("dot", [x, _any((3, 5), 2)], {"transpose_a": True}),
        ("dot", [x, _any((5, 4), 2)], {"transpose_b": True}),
        ("dot", [_any((4,)), _any((4,), 2)], {}),
        ("dot", [_any((2, 3, 4)), _any((4, 5), 2)], {}),
        ("batch_dot", [_any((2, 3, 4)), _any((2, 4, 5), 2)], {}),
        ("batch_dot", [_any((2, 4, 3)), _any((2, 4, 5), 2)],
         {"transpose_a": True}),
        ("batch_dot", [_any((2, 3, 4)), _any((2, 5, 4), 2)],
         {"transpose_b": True}),
        ("Reshape", [_any((2, 3, 4))], {"shape": (0, -1)}),
        ("reshape", [_any((2, 3, 4))], {"shape": (-3, 4)}),
        ("reshape", [_any((2, 3, 4))], {"shape": (2, -4, 3, 1, -2)}),
        ("reshape", [_any((2, 3, 4))], {"shape": (-1, 0), "reverse": True}),
        ("Flatten", [_any((2, 3, 4))], {}),
        ("transpose", [_any((2, 3, 4))], {}),
        ("transpose", [_any((2, 3, 4))], {"axes": (1, 0, 2)}),
        ("expand_dims", [x], {"axis": -1}),
        ("squeeze", [_any((3, 1, 4))], {"axis": 1}),
        ("swapaxes", [_any((2, 3, 4))], {"dim1": 0, "dim2": 2}),
        ("slice_axis", [x], {"axis": 1, "begin": 1, "end": 3}),
        ("Concat", [x, y], {"dim": 0}),
        ("stack", [x, y], {"axis": 1}),
        ("take", [_any((5, 3)), np.array([[0, 4], [7, -2]], np.float32)],
         {}),
        ("take", [_any((5, 3)), np.array([1, 6, -1], np.float32)],
         {"mode": "wrap"}),
        ("take", [_any((5, 3)), np.array([2, 0], np.float32)],
         {"axis": 1}),
        ("where", [_ints((3, 4), 2), x, y], {}),
        ("where", [np.array([1, 0, 1], np.float32), x, y], {}),
        ("softmax", [x], {}),
        ("softmax", [x], {"axis": 0, "temperature": 2.0}),
        ("log_softmax", [x], {"axis": -1}),
        ("log_softmax", [x], {"temperature": 0.5}),
        ("FullyConnected", [_any((2, 3, 4)), _any((5, 12), 1),
                            _any((5,), 2)], {"num_hidden": 5}),
        ("FullyConnected", [_any((2, 3, 4)), _any((5, 4), 1)],
         {"num_hidden": 5, "no_bias": True, "flatten": False}),
        ("Activation", [x], {"act_type": "relu"}),
        ("Activation", [x], {"act_type": "sigmoid"}),
        ("Activation", [x], {"act_type": "tanh"}),
        ("Activation", [x], {"act_type": "softrelu"}),
        ("Activation", [x], {"act_type": "softsign"}),
        ("LayerNorm", [_any((2, 3, 4)), _pos((4,), 1), _any((4,), 2)], {}),
        ("LayerNorm", [_any((2, 3, 4)), _pos((3,), 1), _any((3,), 2)],
         {"axis": 1, "eps": 1e-3}),
        ("Embedding", [np.array([[0, 3], [2, 2]], np.float32),
                       _any((4, 5), 1)], {"input_dim": 4, "output_dim": 5}),
        ("pick", [x, np.array([0, 3, 1], np.float32)], {"axis": -1}),
        ("pick", [x, np.array([0, 2, 1, 1], np.float32)],
         {"axis": 0, "keepdims": True}),
    ]
    for name in ("sum", "mean", "prod", "max", "min"):
        base = _pos((3, 4)) + 0.5 if name == "prod" else x
        c.append((name, [base], {}))
        c.append((name, [base], {"axis": 1}))
        c.append((name, [base], {"axis": (0, 1), "keepdims": True}))
        c.append((name, [base], {"axis": 0, "exclude": True}))
    for name in ("sum_axis", "max_axis", "min_axis"):
        c.append((name, [x], {"axis": 0}))
    return c


CASES = _cases()


def _case_id(case):
    name, inputs, attrs = case
    return "%s-%s-%s" % (name, "x".join(str(s) for s in inputs[0].shape),
                         "-".join("%s=%s" % kv for kv in sorted(
                             attrs.items())) or "default")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_op_matches_jax(case):
    name, inputs, attrs = case
    _same(_run(tmx, name, inputs, attrs, _t),
          _run(jmx, name, inputs, attrs, _j))


def _grad_cases():
    out = []
    for name, inputs, attrs in CASES:
        info = treg.get_op(name)
        if not info.differentiable or name in ("BlockGrad", "stop_gradient"):
            continue
        if name in ("Cast", "cast", "sign", "rint", "ceil", "floor",
                    "trunc", "fix", "_copy"):
            continue    # integer-valued or type-changing: no gradient
        if any(x.dtype != np.float32 for x in inputs):
            continue
        out.append((name, inputs, attrs))
    return out


GRAD_CASES = _grad_cases()


def _grads(pkg, name, inputs, attrs, wrap, seed=5):
    arrays = [wrap(x) for x in inputs]
    diff = [i for i, x in enumerate(inputs)
            if not (name in ("take", "Embedding", "pick") and i == 1)
            and not (name == "where" and i == 0)]
    for i in diff:
        arrays[i].attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, name)(*arrays, **attrs)
    head = np.asarray(_r(seed).randn(*out.shape), np.float32)
    out.backward(wrap(head))
    return [arrays[i].grad.asnumpy() for i in diff]


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[_case_id(c) for c in GRAD_CASES])
def test_op_gradient_matches_jax(case):
    name, inputs, attrs = case
    got = _grads(tmx, name, inputs, attrs, _t)
    want = _grads(jmx, name, inputs, attrs, _j)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL, atol=GRAD_TOL)


def test_arange_matches_jax():
    for args in ((5,), (2, 11, 3), (0.5, 3.0, 0.5)):
        _same([tmx.nd.arange(*args, ctx=tmx.cpu()).asnumpy()],
              [jmx.nd.arange(*args).asnumpy()])
    _same([tmx.nd.arange(0, 3, repeat=2, ctx=tmx.cpu()).asnumpy()],
          [jmx.nd.arange(0, 3, repeat=2).asnumpy()])


def test_take_raise_mode_raises_in_both():
    for pkg, wrap in ((tmx, _t), (jmx, _j)):
        with pytest.raises(Exception, match="out of bounds"):
            pkg.nd.take(wrap(_any((5, 3))),
                        wrap(np.array([5], np.float32)), mode="raise")
    _same(_run(tmx, "take", [_any((5, 3)), np.array([-1, 4], np.float32)],
               {"mode": "raise"}, _t),
          _run(jmx, "take", [_any((5, 3)), np.array([-1, 4], np.float32)],
               {"mode": "raise"}, _j))


def test_host_inputs_arrive_as_32_bit_like_jax():
    x = _any((3, 4))
    for other in (np.ones(4), np.arange(4), 2.5):
        _same([tmx.nd.broadcast_add(_t(x), other).asnumpy()],
              [jmx.nd.broadcast_add(_j(x), other).asnumpy()])
    _same([tmx.nd.broadcast_add(_t(np.arange(4, dtype=np.int32)),
                                np.arange(4)).asnumpy()],
          [jmx.nd.broadcast_add(_j(np.arange(4, dtype=np.int32)),
                                np.arange(4)).asnumpy()])


def test_maximum_minimum_dispatch_like_jax():
    x, y = _any((3, 4)), _any((3, 4), 1)
    for fn in ("maximum", "minimum", "hypot"):
        _same([getattr(tmx.nd, fn)(_t(x), _t(y)).asnumpy(),
               getattr(tmx.nd, fn)(_t(x), 0.25).asnumpy(),
               getattr(tmx.nd, fn)(0.25, _t(x)).asnumpy()],
              [getattr(jmx.nd, fn)(_j(x), _j(y)).asnumpy(),
               getattr(jmx.nd, fn)(_j(x), 0.25).asnumpy(),
               getattr(jmx.nd, fn)(0.25, _j(x)).asnumpy()])


# ---------------------------------------------------------------------------
# NDArray operators
# ---------------------------------------------------------------------------

def _operator_results(wrap):
    a = wrap(_pos((3, 4)) + 0.5)
    b = wrap(_pos((1, 4), 1) + 0.5)
    i = wrap(np.arange(12, dtype=np.int32).reshape(3, 4))
    outs = [a * 2.5, 2.5 * a, a * b, b * a, a / 4.0, 4.0 / a, a / b, b / a,
            a + 1.0, 1.0 + a, a + b, a - 1.0, 1.0 - a, a - b, b - a,
            a ** 2.0, 2.0 ** a, a ** b, a % 0.3, 3.0 % a, a % b, -a,
            abs(-a), a == b, a != b, a > b, a >= 1.0, a < b, a <= 1.0,
            i * 2, i + 3, i / 2, i > 5, i == 4]
    return [o.asnumpy() for o in outs]


def test_ndarray_operators_match_jax():
    _same(_operator_results(_t), _operator_results(_j))


def _method_results(wrap):
    x = wrap(_any((2, 3, 4)))
    outs = [x.astype("int32"), x.astype("float16"),
            x.reshape((6, 4)), x.reshape(-1, 0), x.reshape(shape=(4, -1)),
            x.transpose(), x.transpose((0, 2, 1)), x.transpose(2, 0, 1),
            x[1], x[0, 1:], x[:, ::2, 1], x[..., -1], x[None, 0],
            x[[1, 0]], x[wrap(np.array([1, 1, 0], np.int32))],
            x[1, [0, 2]],
            x.mean(), x.mean(axis=1)]
    return [o.asnumpy() for o in outs]


def test_ndarray_methods_match_jax():
    _same(_method_results(_t), _method_results(_j))


def _indexed_grad(pkg, wrap):
    x = wrap(_any((3, 4)))
    x.attach_grad()
    with pkg.autograd.record():
        y = (x[1:, 2] * 3.0 + x[0] .sum() * x[2, 1]) / 2.0
    y.backward()
    return x.grad.asnumpy()


def test_indexing_and_arithmetic_gradient_matches_jax():
    np.testing.assert_allclose(_indexed_grad(tmx, _t), _indexed_grad(jmx, _j),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_comparison_returns_lhs_dtype_and_equality_is_elementwise():
    a = _t(np.array([1.0, 2.0, 3.0], np.float32))
    assert (a == 2.0).dtype == np.float32
    np.testing.assert_array_equal((a == 2.0).asnumpy(), [0, 1, 0])
    assert (a == None) is False  # noqa: E711 - the reference's rule
    assert len({a, a}) == 1      # hashable by identity
    with pytest.raises(MXNetError, match="ambiguous"):
        bool(a > 1.0)
    assert bool(a[1] == 2.0)


# ---------------------------------------------------------------------------
# the registry and the generated namespace
# ---------------------------------------------------------------------------

# the hand-written mx.nd of the port before it was generated
OLD_ND_NAMES = ["NDArray", "array", "zeros", "ones", "FullyConnected",
                "Convolution", "Pooling", "Activation", "BatchNorm",
                "Flatten", "relu", "log_softmax", "pick", "mean"]


def test_generated_namespace_covers_old_list_and_registry():
    for name in OLD_ND_NAMES:
        assert name in tmx.nd.__all__ and callable(getattr(tmx.nd, name))
    for name in treg.list_ops():
        fn = getattr(tmx.nd, name)
        assert fn.__name__ == name
    assert {"arange", "maximum", "minimum", "hypot"} <= set(tmx.nd.__all__)
    # every op the port registers is a JAX registry op of the same name
    assert set(treg.list_ops()) <= set(jreg.list_ops())


def _arity(info, attrs):
    """(outputs, visible outputs) for ``attrs``, or the KeyError an op
    whose count needs an attribute (the control-flow ops') raises."""
    try:
        return info.n_outputs(attrs), info.n_visible_outputs(attrs)
    except KeyError as e:
        return "KeyError", str(e)


def test_registry_entries_match_jax():
    assert treg.OpInfo.__slots__ == jreg.OpInfo.__slots__
    given = {"_n_out": 2, "_n_state": 1, "state_outputs": True,
             "mode": "lstm", "output_mean_var": True}
    for name in treg.list_ops():
        t, j = treg.get_op(name), jreg.get_op(name)
        assert t.differentiable == j.differentiable, name
        assert t.num_inputs == j.num_inputs, name
        assert t.mutate_inputs == j.mutate_inputs, name
        assert _arity(t, {}) == _arity(j, {}), name
        assert _arity(t, given) == _arity(j, given), name
        assert set(t.aliases) <= set(j.aliases), name


def test_registry_api():
    with pytest.raises(MXNetError, match="not registered"):
        treg.get_op("no_such_op")
    with pytest.raises(MXNetError, match="already registered"):
        treg.register("broadcast_add")(lambda a, b: a)
    assert treg.get_op("stop_gradient") is treg.get_op("BlockGrad")
    with pytest.raises(MXNetError, match="error in operator dot"):
        tmx.nd.dot(_t(_any((2, 3))), _t(_any((2, 3))))


def test_out_argument_and_mutated_inputs(monkeypatch):
    x = _any((3, 4))
    out = _t(np.zeros((3, 4), np.float32))
    assert tmx.nd.relu(_t(x), out=out) is out
    jout = _j(np.zeros((3, 4), np.float32))
    jmx.nd.relu(_j(x), out=jout)
    _same([out.asnumpy()], [jout.asnumpy()])
    # an op that updates its first input in place (as the optimizer ops
    # do) rebinds that handle and returns it
    info = treg.OpInfo("_test_scale_inplace", lambda w, g, **kw: w - g,
                       num_inputs=2, mutate_inputs=(0,))
    monkeypatch.setitem(treg._OP_REGISTRY, info.name, info)
    w, g = _t(x), _t(np.ones((3, 4), np.float32))
    from mxnet_tpu_torch.ndarray.ndarray import _invoke_nd
    assert _invoke_nd(info.name, [w, g], {}) is w
    np.testing.assert_array_equal(w.asnumpy(), x - 1)


def test_positional_attributes_and_none_bias():
    x, w = _any((2, 3, 4)), _any((5, 4), 1)
    # a None bias arrives positionally, as Dense passes it
    got = tmx.nd.FullyConnected(_t(x), _t(w), None, no_bias=True,
                                flatten=False).asnumpy()
    want = jmx.nd.FullyConnected(_j(x), _j(w), None, no_bias=True,
                                 flatten=False).asnumpy()
    _same([got], [want])
    _same([tmx.nd.clip(_t(x), -0.2, 0.3).asnumpy()],
          [jmx.nd.clip(_j(x), -0.2, 0.3).asnumpy()])


def test_layer_norm_plain_formula_is_the_jax_default():
    """The JAX op switches to its one-pass kernel only under a fusion plan;
    with none active (every path ported) it runs the plain formula the
    port has."""
    for shape in ((2, 3, 32), (16, 1, 512)):
        assert jfusion_cost.runtime_decision(
            "layer_norm_fast", shape, np.float32, axis=-1,
            site="LayerNorm") is False
