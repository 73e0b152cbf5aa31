"""The port's symbolic front end (mxnet_tpu_torch.symbol) held against the
JAX package's on the CPU: argument, output and aux lists, infer_shape
(full and partial) and infer_type, the JSON (equal after json.loads),
JSON written by either package loaded and evaluated by the other, and
AttrScope.  Values come from numpy with a seed; JAX runs with
``default_matmul_precision("float32")``, torch at ``"highest"``;
outputs agree within rtol 1e-5 and an atol of 1e-5 x the output's
largest magnitude (the conv net's outputs reach ~75 with randn weights,
and an output near 0 there is a cancellation whose f32 rounding differs
with the summation order of the two packages' convolutions)."""
import json

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _precision():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _mlp(pkg):
    s = pkg.sym
    net = s.Flatten(s.var("data"))
    net = s.FullyConnected(net, num_hidden=16, name="fc1")
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(net, s.var("softmax_label"), name="softmax")


def _conv_bn(pkg):
    s = pkg.sym
    net = s.Convolution(s.var("data"), kernel=(3, 3), num_filter=4,
                        pad=(1, 1), name="conv")
    net = s.BatchNorm(net, fix_gamma=False, name="bn")
    net = s.Activation(net, act_type="relu")
    net = s.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = s.FullyConnected(s.Flatten(net), num_hidden=3, name="fc")
    return net


def _group(pkg):
    s = pkg.sym
    x = s.var("data")
    a = s.FullyConnected(x, num_hidden=5, name="a")
    b = s.exp(a) * 2.0 + a
    c = s.sum(s.maximum(a, 0.5) - 1.0 / (1.0 + s.abs(b)), axis=1)
    return s.Group([a, b, c])


NETS = {"mlp": (_mlp, {"data": (4, 1, 6, 6), "softmax_label": (4,)}),
        "conv_bn": (_conv_bn, {"data": (2, 3, 8, 8)}),
        "group": (_group, {"data": (3, 7)})}


def _build(pkg, name):
    with pkg.name.NameManager():
        return NETS[name][0](pkg)


@pytest.mark.parametrize("name", sorted(NETS))
def test_lists_and_inference_match_jax(name):
    t, j = _build(tmx, name), _build(jmx, name)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_inputs() == j.list_inputs()
    shapes = NETS[name][1]
    assert t.infer_shape(**shapes) == j.infer_shape(**shapes)
    # partial: the data's shape alone leaves nothing unknown but the
    # label, which SoftmaxOutput's rule deduces; with no shapes at all
    # every entry stays unknown
    data = {"data": shapes["data"]}
    assert t.infer_shape_partial(**data) == j.infer_shape_partial(**data)
    assert t.infer_shape_partial() == j.infer_shape_partial()
    assert t.infer_type(data="float32") == j.infer_type(data="float32")


def test_infer_shape_incomplete_raises():
    s = tmx.sym
    net = s.FullyConnected(s.var("data"), s.var("w"), num_hidden=3,
                           no_bias=True) + s.var("free")
    with pytest.raises(MXNetError, match="incomplete"):
        net.infer_shape(data=(2, 4))


@pytest.mark.parametrize("name", sorted(NETS))
def test_tojson_equals_jax(name):
    t, j = _build(tmx, name), _build(jmx, name)
    assert json.loads(t.tojson()) == json.loads(j.tojson())


def _args(sym, shapes, seed):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    vals = {}
    for n, shp in zip(sym.list_arguments(), arg_shapes):
        vals[n] = (rng.randint(0, 10, shp) if n.endswith("label")
                   else rng.randn(*shp)).astype(np.float32)
    for n, shp in zip(sym.list_auxiliary_states(), aux_shapes):
        vals[n] = (rng.rand(*shp) + 0.5 if n.endswith("var")
                   else rng.randn(*shp)).astype(np.float32)
    return vals


def _eval(pkg, sym, vals):
    if pkg is tmx:
        arrs = {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in vals.items()}
        return [o.asnumpy() for o in sym.eval(ctx=tmx.cpu(), **arrs)]
    arrs = {k: jmx.nd.array(v) for k, v in vals.items()}
    return [o.asnumpy() for o in sym.eval(**arrs)]


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_json_loads_in_the_other_package(name, direction, tmp_path):
    src, dst = (tmx, jmx) if direction == "torch_to_jax" else (jmx, tmx)
    sym = _build(src, name)
    path = str(tmp_path / "net-symbol.json")
    sym.save(path)
    loaded = dst.sym.load(path)
    assert loaded.list_arguments() == sym.list_arguments()
    assert loaded.list_auxiliary_states() == sym.list_auxiliary_states()
    vals = _args(sym, NETS[name][1], seed=3)
    want = _eval(src, sym, vals)
    got = _eval(dst, loaded, vals)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max())


def test_attr_scope_matches_jax():
    dicts = []
    for pkg in (tmx, jmx):
        with pkg.name.NameManager():
            with pkg.AttrScope(group="a", lr_mult="2"):
                x = pkg.sym.var("x", lr_mult=0.5, shape=(3, 4))
                with pkg.AttrScope(group="b"):
                    y = pkg.sym.FullyConnected(x, num_hidden=2, name="fc")
            z = pkg.sym.relu(y, name="out")
        assert x.attr("group") == "a" and x.attr("__lr_mult__") == "0.5"
        assert y.attr("group") == "b" and y.attr("lr_mult") == "2"
        assert z.attr("group") is None and z.attr("name") == "out"
        dicts.append(z.attr_dict())
    assert dicts[0] == dicts[1]


def test_internals_children_and_operators():
    t, j = _build(tmx, "group"), _build(jmx, "group")
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    a = t[0]
    assert a.get_children().list_outputs() == \
        j[0].get_children().list_outputs()
    assert t["a_output"].name == "a"
    assert len(t) == 3 and [s.name for s in t] == [s.name for s in j]
    ops = [(lambda s: 2.0 - s), (lambda s: s / 3.0), (lambda s: s ** 2.0),
           (lambda s: -s), (lambda s: s > 0.0), (lambda s: 1.0 / s)]
    for op in ops:
        got = []
        for pkg, sym in ((tmx, t), (jmx, j)):
            with pkg.name.NameManager():
                got.append(json.loads(op(sym[0]).tojson()))
        assert got[0] == got[1]
