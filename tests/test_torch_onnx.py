"""The port's ONNX codec (mxnet_tpu_torch.contrib.onnx: _proto, export_model,
import_model, get_model_metadata) held against the JAX package's on the
CPU, case by case of tests/test_onnx.py, tests/test_onnx_breadth.py and
tests/test_onnx_golden.py.

Each export case builds the same symbol in both packages (a fresh
NameManager each) with the same numpy parameters and exports it with
both: the two files decode to the same ModelProto, and where the two
symbols' JSON are equal (every case here) the bytes are equal.  The port
then imports its own file, binds it on the CPU and runs it; its outputs
are held against the JAX package's forward of the original symbol on
the same inputs.  The port's Executor runs with ``aot_eager``
(``jit._BACKEND``).  JAX at ``default_matmul_precision("float32")``,
torch at ``"highest"``; tolerance rtol 1e-5, atol 1e-5 (the JAX suite's
own round-trip bound; the outputs are O(1)), except where a case says
otherwise: the zoo models 1e-4 as in the JAX suite (f32 rounding through
up to 94 layers), LRN and InstanceNorm their JAX cases' atol."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.contrib import onnx as jonnx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import onnx as tonnx
from mxnet_tpu_torch.contrib.onnx import _proto as P
from mxnet_tpu_torch.contrib.onnx.mx2onnx import _attr, _tensor, _vinfo
from mxnet_tpu_torch.contrib.onnx.onnx2mx import _tensor_to_np

RTOL, ATOL = 1e-5, 1e-5
FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"), tmx.cpu():
        yield
    torch.set_float32_matmul_precision(prev)


def _bind_forward(mx, sym, params, inputs):
    """tests/test_onnx_breadth.py's _bind_forward for ``mx``."""
    vals = {k: mx.nd.array(v) for k, v in inputs.items()}
    for k, v in params.items():
        vals[k] = v if isinstance(v, mx.nd.NDArray) else mx.nd.array(
            np.asarray(v))
    args = {n: vals[n] for n in sym.list_arguments() if n in vals}
    aux = {n: vals[n] for n in sym.list_auxiliary_states() if n in vals}
    exe = sym.bind(mx.cpu(), args=args, aux_states=aux or None)
    return [o.asnumpy() for o in exe.forward(is_train=False)]


def _np(params):
    return {k: v if isinstance(v, np.ndarray) else v.asnumpy()
            for k, v in params.items()}


def _export_both(mk, params, shape_arg, tmp_path):
    """Export ``mk(pkg)``'s symbol from both packages: (JAX symbol, port
    symbol, port file), after checking the two files agree."""
    syms = {}
    paths = {}
    for tag, mx, onnx in (("jax", jmx, jonnx), ("torch", tmx, tonnx)):
        with mx.name.NameManager():
            syms[tag] = mk(mx)
        paths[tag] = str(tmp_path / ("%s.onnx" % tag))
        onnx.export_model(syms[tag],
                          {k: mx.nd.array(v) for k, v in params.items()},
                          shape_arg, onnx_file_path=paths[tag])
    raw = {t: open(p, "rb").read() for t, p in paths.items()}
    assert P.decode(raw["torch"], "ModelProto") == \
        P.decode(raw["jax"], "ModelProto")
    same_json = json.loads(syms["jax"].tojson()) == \
        json.loads(syms["torch"].tojson())
    assert same_json
    assert raw["torch"] == raw["jax"]
    return syms["jax"], syms["torch"], paths["torch"]


def _roundtrip(mk, params, inputs, tmp_path, atol=ATOL, rtol=RTOL):
    params = _np(params)
    shapes = [tuple(v.shape) for v in inputs.values()]
    jsym, _, path = _export_both(
        mk, params, shapes if len(shapes) > 1 else shapes[0], tmp_path)
    sym2, arg2, aux2 = tonnx.import_model(path)
    got = _bind_forward(tmx, sym2, {**arg2, **aux2}, inputs)
    want = _bind_forward(jmx, jsym, params, inputs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)
    return got


# ---------------------------------------------------------------------------
# tests/test_onnx.py
# ---------------------------------------------------------------------------


def _mlp(mx):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    return mx.sym.FullyConnected(h, num_hidden=4, name="fc2")


def _mlp_params():
    rng = np.random.RandomState(0)
    return {"fc1_weight": rng.randn(16, 8).astype(np.float32),
            "fc1_bias": rng.randn(16).astype(np.float32),
            "fc2_weight": rng.randn(4, 16).astype(np.float32),
            "fc2_bias": rng.randn(4).astype(np.float32)}


def _convnet(mx):
    data = mx.sym.var("data")
    h = mx.sym.Convolution(data, num_filter=6, kernel=(3, 3), pad=(1, 1),
                           name="c1")
    h = mx.sym.Activation(h, act_type="relu", name="r1")
    h = mx.sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name="p1")
    h = mx.sym.Flatten(h, name="fl")
    return mx.sym.FullyConnected(h, num_hidden=3, name="fc")


def test_mlp_roundtrip(tmp_path):
    x = np.random.RandomState(2).randn(5, 8).astype(np.float32)
    _roundtrip(_mlp, _mlp_params(), {"data": x}, tmp_path)


def test_convnet_roundtrip(tmp_path):
    rng = np.random.RandomState(1)
    params = {"c1_weight": rng.randn(6, 2, 3, 3).astype(np.float32) * 0.2,
              "c1_bias": np.zeros(6, np.float32),
              "fc_weight": rng.randn(3, 6 * 4 * 4).astype(np.float32) * 0.1,
              "fc_bias": np.zeros(3, np.float32)}
    x = np.random.RandomState(3).randn(2, 2, 8, 8).astype(np.float32)
    _roundtrip(_convnet, params, {"data": x}, tmp_path)


def test_metadata(tmp_path):
    _, _, path = _export_both(_mlp, _mlp_params(), (5, 8), tmp_path)
    meta = tonnx.get_model_metadata(path)
    assert meta == jonnx.get_model_metadata(path)
    assert meta["input_tensor_data"] == [("data", (5, 8))]
    assert len(meta["output_tensor_data"]) == 1


def _conv_bn(mx):
    data = mx.sym.var("data")
    h = mx.sym.Convolution(data, num_filter=4, kernel=(3, 3), no_bias=True,
                           name="c")
    h = mx.sym.BatchNorm(h, fix_gamma=False, name="bn")
    h = mx.sym.Pooling(h, kernel=(1, 1), global_pool=True,
                       pool_type="avg", name="gap")
    return mx.sym.Flatten(h, name="flat")


def test_batchnorm_and_global_pool_roundtrip(tmp_path):
    rng = np.random.RandomState(4)
    params = {"c_weight": rng.randn(4, 3, 3, 3).astype(np.float32) * 0.3,
              "bn_gamma": np.abs(rng.randn(4)).astype(np.float32) + 0.5,
              "bn_beta": rng.randn(4).astype(np.float32),
              "bn_moving_mean": rng.randn(4).astype(np.float32) * 0.1,
              "bn_moving_var": np.abs(rng.randn(4)).astype(np.float32)
              + 1.0}
    x = rng.randn(2, 3, 6, 6).astype(np.float32)
    _, _, path = _export_both(_conv_bn, params, (2, 3, 6, 6), tmp_path)
    sym2, args2, aux2 = tonnx.import_model(path)
    assert "bn_moving_mean" in aux2 and "bn_moving_var" in aux2
    assert all(a.context == tmx.cpu() for a in list(args2.values())
               + list(aux2.values()))
    got = _bind_forward(tmx, sym2, {**args2, **aux2}, {"data": x})[0]
    with jmx.name.NameManager():
        jsym = _conv_bn(jmx)
    want = _bind_forward(jmx, jsym, params, {"data": x})[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_wire_format_parses_with_real_onnx_if_available(tmp_path):
    onnx = pytest.importorskip("onnx")
    _, _, path = _export_both(_mlp, _mlp_params(), (5, 8), tmp_path)
    onnx.checker.check_model(onnx.load(path))


def test_batchnorm_output_mean_var_visible():
    for mx in (tmx, jmx):
        bn = mx.sym.BatchNorm(mx.sym.var("data"), output_mean_var=True,
                              name="bnv")
        assert len(bn) == 3
        bn1 = mx.sym.BatchNorm(mx.sym.var("data"), name="bnv2")
        assert len(bn1) == 1
        assert bn1.list_outputs() == ["bnv2_output"]


# ---------------------------------------------------------------------------
# tests/test_onnx_breadth.py
# ---------------------------------------------------------------------------

_RNG = np.random.RandomState(7)
_X = _RNG.rand(2, 3, 8, 8).astype(np.float32) + 0.1
_V = _RNG.rand(3, 4).astype(np.float32) + 0.1


def test_logistic_regression_output_roundtrip(tmp_path):
    def mk(mx):
        return mx.sym.LogisticRegressionOutput(mx.sym.var("data"),
                                               name="lro")

    _, _, path = _export_both(mk, {}, _V.shape, tmp_path)
    meta = tonnx.get_model_metadata(path)
    assert [n for n, _ in meta["input_tensor_data"]] == ["data"]
    sym2, arg2, aux2 = tonnx.import_model(path)
    got = _bind_forward(tmx, sym2, {}, {"data": _V})[0]
    np.testing.assert_allclose(got, 1.0 / (1.0 + np.exp(-_V)), atol=1e-6)


UNARY_OPS = [
    ("exp", {}), ("log", {}), ("sqrt", {}), ("abs", {}),
    ("negative", {}), ("ceil", {}), ("floor", {}),
    ("reciprocal", {}), ("square", {}), ("sigmoid", {}),
    ("tanh", {}), ("relu", {}), ("sin", {}), ("cos", {}),
    ("tan", {}), ("arcsin", {}), ("arccos", {}), ("arctan", {}),
    ("logical_not", {}),
    ("hard_sigmoid", {"alpha": 0.3, "beta": 0.4}),
    ("transpose", {"axes": (1, 0)}),
    ("Flatten", {}),
    ("shape_array", {}),
    ("sum", {"axis": (1,), "keepdims": True}),
    ("mean", {"axis": (0,)}),
    ("min", {"axis": (1,)}),
    ("max", {}),
    ("prod", {"axis": (1,), "keepdims": True}),
    ("norm", {"ord": 2, "axis": (1,)}),
    ("argmax", {"axis": 1, "keepdims": True}),
    ("argmin", {"axis": 0}),
    ("clip", {"a_min": 0.2, "a_max": 0.8}),
    ("expand_dims", {"axis": 1}),
    ("tile", {"reps": (2, 3)}),
    ("broadcast_to", {"shape": (5, 3, 4)}),
    ("slice_axis", {"axis": 1, "begin": 1, "end": 3}),
    ("Cast", {"dtype": "int32"}),
    ("depth_to_space", {"block_size": 2}),
    ("space_to_depth", {"block_size": 2}),
    ("BlockGrad", {}),
    ("log_softmax", {"axis": -1}),
    ("softmax", {"axis": 1}),
]


@pytest.mark.parametrize("op,attrs", UNARY_OPS,
                         ids=[o for o, _ in UNARY_OPS])
def test_unary_family_roundtrip(op, attrs, tmp_path):
    x = _V
    if op in ("arcsin", "arccos", "arctan"):
        x = (_V - 0.5).clip(-0.9, 0.9)
    if op == "depth_to_space":
        x = np.random.RandomState(11).rand(1, 4, 3, 3).astype(np.float32)
    if op == "space_to_depth":
        x = np.random.RandomState(12).rand(1, 2, 4, 4).astype(np.float32)
    if op == "broadcast_to":
        x = _V[None]
    _roundtrip(lambda mx: getattr(mx.sym, op)(mx.sym.var("data"), **attrs),
               {}, {"data": x}, tmp_path)


SCALAR_OPS = [("_plus_scalar", "__add__"), ("_minus_scalar", "__sub__"),
              ("_mul_scalar", "__mul__"), ("_div_scalar", "__truediv__"),
              ("_rminus_scalar", "__rsub__"),
              ("_rdiv_scalar", "__rtruediv__"),
              ("_power_scalar", "__pow__")]


@pytest.mark.parametrize("op,dunder", SCALAR_OPS,
                         ids=[o for o, _ in SCALAR_OPS])
def test_scalar_family_roundtrip(op, dunder, tmp_path):
    _roundtrip(lambda mx: getattr(mx.sym.var("data"), dunder)(1.7), {},
               {"data": _V}, tmp_path)


BINARY_OPS = ["broadcast_add", "broadcast_sub", "broadcast_mul",
              "broadcast_div", "broadcast_power", "broadcast_maximum",
              "broadcast_minimum", "broadcast_lesser",
              "broadcast_greater", "broadcast_equal",
              "broadcast_logical_and", "broadcast_logical_or",
              "broadcast_logical_xor", "elemwise_add", "elemwise_sub",
              "elemwise_mul", "elemwise_div"]


@pytest.mark.parametrize("op", BINARY_OPS)
def test_binary_family_roundtrip(op, tmp_path):
    bv = np.random.RandomState(13).rand(3, 4).astype(np.float32) + 0.2
    av = _V
    if "logical" in op:
        av = (_V > 0.5).astype(np.float32)
        bv = (bv > 0.6).astype(np.float32)
    _roundtrip(lambda mx: getattr(mx.sym, op)(mx.sym.var("a"),
                                              mx.sym.var("b")),
               {}, {"a": av, "b": bv}, tmp_path)


def test_dot_and_gemm2_roundtrip(tmp_path):
    rng = np.random.RandomState(14)
    _roundtrip(lambda mx: mx.sym.dot(mx.sym.var("a"), mx.sym.var("b")),
               {}, {"a": rng.rand(3, 4).astype(np.float32),
                    "b": rng.rand(4, 5).astype(np.float32)},
               tmp_path)
    _roundtrip(lambda mx: mx.sym.linalg_gemm2(
        mx.sym.var("a"), mx.sym.var("b"), transpose_b=True, alpha=0.5),
        {}, {"a": rng.rand(2, 3, 4).astype(np.float32),
             "b": rng.rand(2, 5, 4).astype(np.float32)}, tmp_path)


def test_addn_split_concat_squeeze_roundtrip(tmp_path):
    _roundtrip(lambda mx: mx.sym.add_n(mx.sym.var("a"), mx.sym.var("b"),
                                       mx.sym.var("c")),
               {}, {"a": _V, "b": _V * 2, "c": _V * 3}, tmp_path)

    def split_cat(mx):
        parts = mx.sym.SliceChannel(mx.sym.var("data"), num_outputs=2,
                                    axis=1, name="split")
        return mx.sym.Concat(parts[0] * 2.0, parts[1], dim=1, name="cat")

    x4 = np.random.RandomState(15).rand(2, 4, 8, 8).astype(np.float32)
    _roundtrip(split_cat, {}, {"data": x4}, tmp_path)
    _roundtrip(lambda mx: mx.sym.squeeze(
        mx.sym.expand_dims(mx.sym.var("data"), axis=0), axis=(0,)),
        {}, {"data": _V}, tmp_path)


def test_pad_crop_lrn_l2norm_instancenorm_roundtrip(tmp_path):
    def d(mx):
        return mx.sym.var("data")

    _roundtrip(lambda mx: mx.sym.Pad(d(mx), mode="constant",
                                     pad_width=(0, 0, 0, 0, 1, 1, 2, 2),
                                     constant_value=1.5),
               {}, {"data": _X}, tmp_path)
    _roundtrip(lambda mx: mx.sym.Pad(d(mx), mode="edge",
                                     pad_width=(0, 0, 0, 0, 1, 1, 1, 1)),
               {}, {"data": _X}, tmp_path)
    _roundtrip(lambda mx: mx.sym.Crop(d(mx), offset=(1, 2), h_w=(4, 5)),
               {}, {"data": _X}, tmp_path)
    _roundtrip(lambda mx: mx.sym.LRN(d(mx), nsize=3, alpha=2e-4, beta=0.7,
                                     knorm=1.5),
               {}, {"data": _X}, tmp_path, atol=1e-5)
    _roundtrip(lambda mx: mx.sym.L2Normalization(d(mx), mode="channel"),
               {}, {"data": _X}, tmp_path)
    rng = np.random.RandomState(16)
    g = np.abs(rng.rand(3).astype(np.float32)) + 0.5
    bt = rng.rand(3).astype(np.float32)
    _roundtrip(lambda mx: mx.sym.InstanceNorm(d(mx), mx.sym.var("g"),
                                              mx.sym.var("bt"), eps=1e-4),
               {"g": g, "bt": bt}, {"data": _X}, tmp_path, atol=1e-4)


def test_deconv_prelu_pool_roundtrip(tmp_path):
    rng = np.random.RandomState(17)
    w = rng.rand(3, 5, 2, 2).astype(np.float32) * 0.3
    _roundtrip(lambda mx: mx.sym.Deconvolution(
        mx.sym.var("data"), mx.sym.var("w"), num_filter=5, kernel=(2, 2),
        stride=(2, 2), no_bias=True, name="dc"),
        {"w": w}, {"data": _X}, tmp_path)
    gamma = np.full((3,), 0.2, np.float32)
    _roundtrip(lambda mx: mx.sym.LeakyReLU(
        mx.sym.var("data"), mx.sym.var("gamma"), act_type="prelu"),
        {"gamma": gamma}, {"data": _X - 0.5}, tmp_path)
    _roundtrip(lambda mx: mx.sym.Pooling(
        mx.sym.var("data"), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
        pool_type="avg", count_include_pad=False),
        {}, {"data": _X}, tmp_path)


def test_random_ops_export_import_structurally(tmp_path):
    """Random ops cannot round-trip numerically: the translator pair
    keeps the distribution's parameters and shape."""
    def mk(mx):
        return mx.symbol.symbol._invoke_sym(
            "_random_uniform", [], {"low": 2.0, "high": 3.0,
                                    "shape": (4, 5)}) + mx.sym.var("data")

    _, _, path = _export_both(mk, {}, (4, 5), tmp_path)
    sym2, arg2, aux2 = tonnx.import_model(path)
    out = _bind_forward(tmx, sym2, {}, {"data": np.zeros((4, 5),
                                                         np.float32)})[0]
    assert out.shape == (4, 5)
    assert out.min() >= 2.0 and out.max() <= 3.0


ZOO = [("resnet18_v1", (1, 3, 32, 32)),
       ("mobilenet0.25", (1, 3, 32, 32)),
       ("inceptionv3", (1, 3, 299, 299))]


@pytest.mark.parametrize("net_name,ishape", ZOO, ids=[z[0] for z in ZOO])
def test_model_zoo_roundtrip(net_name, ishape, tmp_path):
    """A zoo model exported by the JAX package (Xavier weights), loaded by
    both packages, exported to ONNX by both (the same bytes), imported by
    the port: its logits against the JAX package's gluon forward within
    the JAX suite's 1e-4."""
    from mxnet_tpu.gluon.model_zoo import vision

    net = vision.get_model(net_name, classes=10)
    net.initialize(jmx.init.Xavier())
    x = np.random.RandomState(18).rand(*ishape).astype(np.float32)
    net(jmx.nd.array(x))
    prefix = str(tmp_path / net_name)
    net.export(prefix)
    want = net(jmx.nd.array(x)).asnumpy()
    files = {}
    for tag, mx, onnx in (("jax", jmx, jonnx), ("torch", tmx, tonnx)):
        sym = mx.sym.load(prefix + "-symbol.json")
        params = mx.nd.load(prefix + "-0000.params")
        files[tag] = str(tmp_path / ("%s.onnx" % tag))
        onnx.export_model(sym, params, ishape, onnx_file_path=files[tag])
    raw = {t: open(p, "rb").read() for t, p in files.items()}
    assert raw["torch"] == raw["jax"]
    sym2, arg2, aux2 = tonnx.import_model(files["torch"])
    got = _bind_forward(tmx, sym2, {**arg2, **aux2}, {"data": x})[0]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_dot_transpose_and_flat_argmax_roundtrip(tmp_path):
    rng = np.random.RandomState(19)
    _roundtrip(lambda mx: mx.sym.dot(mx.sym.var("a"), mx.sym.var("b"),
                                     transpose_a=True, transpose_b=True),
               {}, {"a": rng.rand(4, 3).astype(np.float32),
                    "b": rng.rand(5, 4).astype(np.float32)}, tmp_path)
    _roundtrip(lambda mx: mx.sym.argmax(mx.sym.var("data")), {},
               {"data": _V}, tmp_path)
    _roundtrip(lambda mx: mx.sym.argmin(mx.sym.var("data")), {},
               {"data": _V}, tmp_path)


def test_export_rejects_training_only_output_consumers(tmp_path):
    """A node consuming Dropout's mask fails export loudly in both
    packages (the JAX case skips where the mask is not visible)."""
    for mx, onnx in ((tmx, tonnx), (jmx, jonnx)):
        drop = mx.sym.Dropout(mx.sym.var("data"), p=0.5, name="drop")
        if len(drop) < 2:
            continue
        with pytest.raises(mx.base.MXNetError, match="training-internal"):
            onnx.export_model(drop[0] * drop[1], {}, _V.shape,
                              onnx_file_path=str(tmp_path / "x.onnx"))
    bad = tmx.sym.BatchNorm(tmx.sym.var("data"), output_mean_var=True,
                            name="bn")
    with pytest.raises(tmx.base.MXNetError, match="training-internal"):
        tonnx.export_model(bad[0] + bad[1], {}, (2, 3, 4, 4),
                           onnx_file_path=str(tmp_path / "y.onnx"))


def _write_model(path, nodes, inits, inputs, outputs):
    model = {"ir_version": 7, "producer_name": "test",
             "opset_import": [{"domain": "", "version": 13}],
             "graph": {"name": "g", "node": nodes, "initializer": inits,
                       "input": inputs, "output": outputs}}
    with open(path, "wb") as f:
        f.write(P.encode(model, "ModelProto"))


def _import_both_and_run(path, feeds, module):
    """Import ``path`` with both packages and run each on ``feeds``, in a
    Module or through ``bind`` as the JAX case does: the port's outputs
    and parameters (after checking them against the JAX package's)."""
    outs = {}
    for tag, mx, onnx in (("jax", jmx, jonnx), ("torch", tmx, tonnx)):
        sym, arg_params, aux_params = onnx.import_model(path)
        if module:
            mod = mx.mod.Module(sym, data_names=list(feeds),
                                label_names=None, context=mx.cpu())
            mod.bind(data_shapes=[(k, v.shape) for k, v in feeds.items()],
                     for_training=False)
            mod.set_params(arg_params, aux_params)
            mod.forward(mx.io.DataBatch(data=[mx.nd.array(v)
                                              for v in feeds.values()]),
                        is_train=False)
            got = [o.asnumpy() for o in mod.get_outputs()]
        else:
            args = dict(arg_params)
            args.update({k: mx.nd.array(v) for k, v in feeds.items()})
            exe = sym.bind(ctx=mx.cpu(), args=args, grad_req="null")
            got = [o.asnumpy() for o in exe.forward(is_train=False)]
        outs[tag] = (got, {k: v.asnumpy() for k, v in arg_params.items()})
    for g, w in zip(outs["torch"][0], outs["jax"][0]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert sorted(outs["torch"][1]) == sorted(outs["jax"][1])
    return outs["torch"]


def test_gemm_shared_weight_transposed_once(tmp_path):
    rng = np.random.RandomState(20)
    w = rng.rand(4, 3).astype(np.float32)
    x = rng.rand(2, 4).astype(np.float32)
    nodes = [{"op_type": "Gemm", "input": ["x", "w"], "output": ["h"],
              "name": "g1", "attribute": []},
             {"op_type": "Relu", "input": ["h"], "output": ["hr"],
              "name": "r", "attribute": []},
             {"op_type": "Gemm", "input": ["x", "w"], "output": ["y2"],
              "name": "g2", "attribute": []}]
    path = str(tmp_path / "shared_gemm.onnx")
    _write_model(path, nodes, [_tensor("w", w)], [_vinfo("x", x.shape)],
                 [_vinfo("hr", (2, 3)), _vinfo("y2", (2, 3))])
    outs, _ = _import_both_and_run(path, {"x": x}, module=True)
    np.testing.assert_allclose(outs[0], np.maximum(x @ w, 0.0), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(outs[1], x @ w, rtol=RTOL, atol=ATOL)


def test_gemm_weight_shared_with_matmul_not_corrupted(tmp_path):
    rng = np.random.RandomState(21)
    w = rng.rand(4, 3).astype(np.float32)
    x = rng.rand(2, 4).astype(np.float32)
    nodes = [{"op_type": "Gemm", "input": ["x", "w"], "output": ["y0"],
              "name": "g0", "attribute": []},
             {"op_type": "MatMul", "input": ["x", "w"], "output": ["y1"],
              "name": "m0", "attribute": []}]
    path = str(tmp_path / "gemm_matmul_share.onnx")
    _write_model(path, nodes, [_tensor("w", w)], [_vinfo("x", x.shape)],
                 [_vinfo("y0", (2, 3)), _vinfo("y1", (2, 3))])
    outs, params = _import_both_and_run(path, {"x": x}, module=False)
    np.testing.assert_array_equal(params["w"], w)
    for o in outs:
        np.testing.assert_allclose(o, x @ w, rtol=RTOL, atol=ATOL)


def test_gemm_weight_shared_with_add_not_corrupted(tmp_path):
    rng = np.random.RandomState(22)
    w = rng.rand(4, 3).astype(np.float32)
    x = rng.rand(2, 4).astype(np.float32)
    z = rng.rand(4, 3).astype(np.float32)
    nodes = [{"op_type": "Gemm", "input": ["x", "w"], "output": ["y0"],
              "name": "g0", "attribute": []},
             {"op_type": "Add", "input": ["z", "w"], "output": ["y1"],
              "name": "a0", "attribute": []}]
    path = str(tmp_path / "gemm_add_share.onnx")
    _write_model(path, nodes, [_tensor("w", w)],
                 [_vinfo("x", x.shape), _vinfo("z", z.shape)],
                 [_vinfo("y0", (2, 3)), _vinfo("y1", (4, 3))])
    outs, params = _import_both_and_run(path, {"x": x, "z": z},
                                        module=False)
    np.testing.assert_array_equal(params["w"], w)
    np.testing.assert_allclose(outs[0], x @ w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[1], z + w, rtol=RTOL, atol=ATOL)


def test_gemm_shared_weight_mixed_transb(tmp_path):
    rng = np.random.RandomState(23)
    w = rng.rand(4, 3).astype(np.float32)
    x = rng.rand(2, 4).astype(np.float32)
    z = rng.rand(2, 3).astype(np.float32)
    nodes = [{"op_type": "Gemm", "input": ["x", "w"], "output": ["y0"],
              "name": "g0", "attribute": []},
             {"op_type": "Gemm", "input": ["z", "w"], "output": ["y1"],
              "name": "g1", "attribute": [_attr("transB", 1)]}]
    path = str(tmp_path / "mixed_gemm.onnx")
    _write_model(path, nodes, [_tensor("w", w)],
                 [_vinfo("x", x.shape), _vinfo("z", z.shape)],
                 [_vinfo("y0", (2, 3)), _vinfo("y1", (2, 4))])
    outs, _ = _import_both_and_run(path, {"x": x, "z": z}, module=True)
    np.testing.assert_allclose(outs[0], x @ w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(outs[1], z @ w.T, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# tests/test_onnx_golden.py: the committed fixtures, bytes no codec here
# produced
# ---------------------------------------------------------------------------


def _golden(name, feeds):
    """The fixture imported by both packages and run on ``feeds``: the
    port's outputs and parameters (after checking them against the JAX
    package's)."""
    path = os.path.join(FIX, "%s.onnx" % name)
    outs = {}
    for tag, mx, onnx in (("jax", jmx, jonnx), ("torch", tmx, tonnx)):
        sym, args, aux = onnx.import_model(path)
        outs[tag] = (_bind_forward(mx, sym, {**args, **aux}, feeds),
                     {k: v.asnumpy() for k, v in args.items()})
    for g, w in zip(outs["torch"][0], outs["jax"][0]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    return outs["torch"]


def test_golden_conv_relu_parses_and_matches_oracle():
    w = np.load(os.path.join(FIX, "golden_conv_relu_w.npy"))
    x = np.random.RandomState(0).randn(1, 1, 5, 5).astype(np.float32)
    (got,), _ = _golden("golden_conv_relu", {"x": x})
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    want = np.zeros((1, 2, 5, 5), np.float32)
    for o in range(2):
        for i in range(5):
            for j in range(5):
                want[0, o, i, j] = np.sum(xp[0, 0, i:i + 3, j:j + 3]
                                          * w[o, 0])
    np.testing.assert_allclose(got, np.maximum(want, 0), rtol=1e-4,
                               atol=1e-4)


def test_golden_gemm_mlp_parses_and_matches_oracle():
    ld = {n: np.load(os.path.join(FIX, "golden_gemm_mlp_%s.npy" % n))
          for n in ("w1", "b1", "w2", "b2")}
    x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
    (got,), _ = _golden("golden_gemm_mlp", {"x": x})
    h = np.maximum(x @ ld["w1"].T + ld["b1"], 0)
    np.testing.assert_allclose(got, h @ ld["w2"].T + ld["b2"], rtol=1e-5,
                               atol=1e-5)


def test_golden_add_mul_both_tensor_encodings():
    a = np.load(os.path.join(FIX, "golden_add_mul_a.npy"))
    b = np.load(os.path.join(FIX, "golden_add_mul_b.npy"))
    x = np.random.RandomState(2).randn(2, 3).astype(np.float32)
    (got,), args = _golden("golden_add_mul", {"x": x})
    np.testing.assert_allclose(args["a"], a, rtol=1e-6)
    np.testing.assert_allclose(args["b"], b, rtol=1e-6)
    np.testing.assert_allclose(got, (x + a) * b, rtol=1e-5, atol=1e-6)


def test_golden_reshape_int64_shape_initializer():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    (got,), _ = _golden("golden_reshape_int64", {"x": x})
    np.testing.assert_array_equal(got, x.reshape(2, 12))


def _sem_model(m):
    """tests/test_onnx_golden.py's field-order-insensitive projection."""
    def sem(v):
        if isinstance(v, dict):
            return {k: sem(x) for k, x in v.items()
                    if x not in ("", b"", [])}
        if isinstance(v, list):
            return [sem(x) for x in v]
        return v

    g = m["graph"]
    return {
        "ir_version": m.get("ir_version"),
        "opsets": sorted((o.get("domain", ""), o["version"])
                         for o in m.get("opset_import", [])),
        "nodes": [sem({k: n.get(k) for k in
                       ("op_type", "input", "output", "attribute")})
                  for n in g.get("node", [])],
        "inits": {t["name"]: _tensor_to_np(t).tolist()
                  for t in g.get("initializer", [])},
        "inputs": [v["name"] for v in g.get("input", [])],
        "outputs": [v["name"] for v in g.get("output", [])],
    }


GOLDEN = ["golden_conv_relu", "golden_gemm_mlp", "golden_add_mul",
          "golden_reshape_int64"]


@pytest.mark.parametrize("name", GOLDEN)
def test_codec_roundtrip_is_semantically_stable(name):
    from mxnet_tpu.contrib.onnx import _proto as JP

    with open(os.path.join(FIX, "%s.onnx" % name), "rb") as f:
        raw = f.read()
    m1 = P.decode(raw, "ModelProto")
    assert m1 == JP.decode(raw, "ModelProto")
    re_encoded = P.encode(m1, "ModelProto")
    assert re_encoded == JP.encode(m1, "ModelProto")
    assert _sem_model(P.decode(re_encoded, "ModelProto")) == _sem_model(m1)


def test_port_codec_matches_committed_bytes_semantically():
    """The port's encoder re-expresses every committed fixture without
    drift, and its decoder reads the initializers as the .npy oracles
    hold them (the counterpart of the generator test, which holds the
    fixtures to their generator)."""
    oracles = {"golden_conv_relu": ["w"],
               "golden_gemm_mlp": ["w1", "b1", "w2", "b2"],
               "golden_add_mul": ["a", "b"]}
    for name in GOLDEN:
        with open(os.path.join(FIX, "%s.onnx" % name), "rb") as f:
            m = P.decode(f.read(), "ModelProto")
        inits = {t["name"]: _tensor_to_np(t)
                 for t in m["graph"].get("initializer", [])}
        for key in oracles.get(name, []):
            oracle = np.load(os.path.join(FIX, "%s_%s.npy" % (name, key)))
            match = [v for v in inits.values()
                     if v.shape == oracle.shape and np.allclose(v, oracle)]
            assert match, (name, key)
