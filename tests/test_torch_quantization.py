"""The port's contrib.quantization held against the JAX package's on the
CPU, on the same seeded numpy inputs: the quantize ops (quantize,
quantize_v2 with and without a calibrated range, dequantize, requantize)
bit for bit; quantized_conv and quantized_fully_connected int32 bit for
bit (groups, stride, pad, dilation, 1-D and 3-D kernels, a flattened
and an unflattened FC,
and the int32 accumulator case of tests/test_quantization.py:52); the 5
pass-through ops; quantize_model's rewritten symbol (tojson) and int8
params equal to JAX's, with and without excluded_sym_names;
calib_thresholds_kl and its three typed errors; LayerOutputCollector;
and a gated artifact saved, loaded and checked.  The cases of
tests/test_quantization.py run on the port too."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.ops import registry as treg


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")


def _tuple(x):
    return x if isinstance(x, (tuple, list)) else (x,)


def exact_both(name, ins, attrs):
    """The op in both packages: outputs equal bit for bit, with the same
    shapes and dtypes (the ranges 0-d f32)."""
    j = _tuple(jreg.get_op(name).fn(*[jnp.asarray(x) for x in ins], **attrs))
    t = _tuple(treg.get_op(name).fn(*[torch.from_numpy(np.asarray(x))
                                      for x in ins], **attrs))
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a, b = np.asarray(a), b.numpy()
        assert (a.shape, a.dtype) == (b.shape, b.dtype), (name, a.shape,
                                                          b.shape, a.dtype,
                                                          b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=name)
    return [b.numpy() for b in t]


def _f32(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


def _i8(*shape, seed=0):
    return np.random.RandomState(seed).randint(-127, 128, shape) \
        .astype(np.int8)


R = np.array(1.7, np.float32)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0])
def test_quantize_ops_bit_equal(scale):
    x = _f32(5, 7, seed=1, scale=scale)
    x[0, :3] = [0.5 / 127 * scale, -1.5 / 127 * scale, 0.0]   # near ties
    exact_both("_contrib_quantize", [x, -R * scale, R * scale * 0.9], {})
    q = exact_both("_contrib_quantize_v2", [x], {})[0]
    assert q.dtype == np.int8 and np.abs(q).max() == 127
    exact_both("_contrib_quantize_v2", [x], {"min_calib_range": -0.7 * scale,
                                             "max_calib_range": 0.4 * scale})
    exact_both("_contrib_dequantize", [q, -R, R], {})
    acc = np.random.RandomState(2).randint(-40000, 40000, (4, 6)) \
        .astype(np.int32)
    exact_both("_contrib_requantize", [acc, -R, R], {})
    exact_both("_contrib_requantize", [acc, -R, R],
               {"min_calib_range": -0.01, "max_calib_range": 0.02})
    exact_both("_contrib_dequantize_int32", [acc, -R, R], {})


@pytest.mark.parametrize("case", [
    dict(shape=(2, 3, 9, 9), F=4, k=3),
    dict(shape=(2, 6, 9, 8), F=4, k=3, stride=(2, 2), pad=(1, 1),
         dilate=(2, 2), num_group=2),
    dict(shape=(1, 32, 5, 5), F=8, k=1),
    dict(shape=(3, 64, 7, 7), F=5, k=3, pad=(1, 1), stride=(1, 2))])
def test_quantized_conv_bit_equal(case):
    N, C, H, W = case["shape"]
    g = case.get("num_group", 1)
    k = case["k"]
    attrs = {"kernel": (k, k), "num_filter": case["F"], "num_group": g}
    for key in ("stride", "pad", "dilate"):
        if key in case:
            attrs[key] = case[key]
    out = exact_both("_contrib_quantized_conv",
                     [_i8(N, C, H, W, seed=3), _i8(case["F"], C // g, k, k,
                                                    seed=4),
                      -R, R, -R * 0.5, R * 0.5], attrs)[0]
    assert out.dtype == np.int32


@pytest.mark.parametrize("case", [
    dict(shape=(2, 4, 11), F=6, k=(3,)),
    dict(shape=(2, 4, 11), F=6, k=(3,), stride=(2,), pad=(2,), dilate=(2,),
         num_group=2),
    dict(shape=(2, 4, 7, 6, 9), F=6, k=(3, 2, 3)),
    dict(shape=(2, 4, 7, 6, 9), F=6, k=(3, 2, 3), stride=(2, 1, 2),
         pad=(2, 1, 2), dilate=(2, 2, 1), num_group=2),
    dict(shape=(1, 32, 5, 5, 5), F=8, k=(1, 1, 1))])
def test_quantized_conv_any_rank_bit_equal(case):
    """1-D (a 2-D convolution of height 1) and 3-D (one 2-D convolution a
    kernel depth, summed in int32) against the JAX op's any-rank
    lax.conv_general_dilated."""
    k = case["k"]
    g = case.get("num_group", 1)
    attrs = {"kernel": k, "num_filter": case["F"], "num_group": g}
    for key in ("stride", "pad", "dilate"):
        if key in case:
            attrs[key] = case[key]
    C = case["shape"][1]
    out = exact_both("_contrib_quantized_conv",
                     [_i8(*case["shape"], seed=8),
                      _i8(case["F"], C // g, *k, seed=9),
                      -R, R, -R * 0.5, R * 0.5], attrs)[0]
    assert out.dtype == np.int32 and out.ndim == len(case["shape"])


@pytest.mark.parametrize("flatten", [True, False])
def test_quantized_fully_connected_bit_equal(flatten):
    data = _i8(3, 4, 5, seed=5)
    w = _i8(6, 20 if flatten else 5, seed=6)
    exact_both("_contrib_quantized_fully_connected", [data, w, -R, R, -R, R],
               {"num_hidden": 6, "flatten": flatten})


def test_quantized_int32_accumulator():
    """tests/test_quantization.py:52: 4 x 100 x 100 = 40000 needs int32."""
    d = np.full((2, 4), 100, np.int8)
    w = np.full((3, 4), 100, np.int8)
    one = np.array(1.0, np.float32)
    out = exact_both("_contrib_quantized_fully_connected",
                     [d, w, -one, one, -one, one], {"num_hidden": 3})[0]
    assert out.dtype == np.int32 and (out == 40000).all()
    # a depth where an f32 sum would round: 127^2 x 2304 > 2^24
    x = np.full((1, 256, 3, 3), 127, np.int8)
    k = np.full((1, 256, 3, 3), 127, np.int8)
    conv = exact_both("_contrib_quantized_conv", [x, k, -one, one, -one, one],
                      {"kernel": (3, 3), "num_filter": 1, "pad": (1, 1)})[0]
    assert conv[0, 0, 1, 1] == 127 * 127 * 2304


def test_pass_through_ops():
    q = _i8(2, 3, 4, 4, seed=7)
    lo, hi = np.array(-2.0, np.float32), np.array(3.0, np.float32)
    exact_both("_contrib_quantized_act", [q, lo, hi], {"act_type": "relu"})
    exact_both("_contrib_quantized_flatten", [q, lo, hi], {})
    # the JAX op cannot pool int8 (reduce_window's int32 init value;
    # ROADMAP Queue 3): it runs on the codes held as f32, and the port's
    # int8 result must equal that, cast back
    for attrs in ({"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
                  {"kernel": (3, 3), "pad": (1, 1), "pool_type": "max"}):
        want = jreg.get_op("_contrib_quantized_pooling").fn(
            jnp.asarray(q.astype(np.float32)), jnp.asarray(lo),
            jnp.asarray(hi), **attrs)
        got = treg.get_op("_contrib_quantized_pooling").fn(
            torch.from_numpy(q), torch.from_numpy(lo), torch.from_numpy(hi),
            **attrs)
        assert got[0].dtype == torch.int8
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(want[0]).astype(np.int8))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    b = _i8(2, 5, 4, 4, seed=8)
    lo2, hi2 = np.array(-5.0, np.float32), np.array(1.0, np.float32)
    for name in ("_contrib_quantized_concat", "_quantized_concat"):
        out = exact_both(name, [q, b, lo, hi, lo2, hi2],
                         {"num_args": 2, "dim": 1})
        assert out[0].shape == (2, 8, 4, 4) and out[1] == -5.0


# ---------------------------------------------------------------------------
# quantize_model: the graph rewrite and the int8 params
# ---------------------------------------------------------------------------


def _mlp_conv(pkg):
    S = pkg.sym
    with pkg.name.NameManager():
        x = S.var("data")
        h = S.Convolution(x, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          name="conv1")
        h = S.Activation(h, act_type="relu")
        h = S.Convolution(h, kernel=(1, 1), num_filter=3, no_bias=True,
                          name="conv2")
        h = S.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
        h = S.FullyConnected(S.Flatten(h), num_hidden=5, name="fc1")
        return S.FullyConnected(S.Activation(h, act_type="relu"),
                                num_hidden=3, name="fc2")


def _values(sym, shape):
    arg_shapes, _, _ = sym.infer_shape(data=shape)
    rng = np.random.RandomState(9)
    return {n: (rng.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n != "data"}


def _quantized(pkg, excluded):
    sym = _mlp_conv(pkg)
    vals = _values(sym, (2, 3, 6, 6))
    if pkg is tmx:
        args = {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in vals.items()}
    else:
        args = {k: jmx.nd.array(v) for k, v in vals.items()}
    with pkg.name.NameManager():
        mod = tq if pkg is tmx else jq
        qsym, qargs, qaux = mod.quantize_model(sym, args, {},
                                               excluded_sym_names=excluded)
    return sym, qsym, {k: v.asnumpy() for k, v in qargs.items()}, qaux


@pytest.mark.parametrize("excluded", [None, ["conv2"], ["fc1", "fc2"]])
def test_quantize_model_matches_jax(excluded):
    _, jsym, jargs, _ = _quantized(jmx, excluded)
    _, tsym, targs, taux = _quantized(tmx, excluded)
    assert json.loads(tsym.tojson()) == json.loads(jsym.tojson())
    assert sorted(targs) == sorted(jargs) and taux == {}
    for k in jargs:
        assert targs[k].dtype == jargs[k].dtype, k
        np.testing.assert_array_equal(targs[k], jargs[k], err_msg=k)
    n_q = sum(k.endswith("_weight_quantized") for k in targs)
    assert n_q == 4 - len(excluded or [])


def test_quantized_graph_forward_matches_jax():
    """The rewritten graph bound in both packages on the same int8 params
    and data: outputs within 1e-5 (the int8 layers are exact; the f32
    layer left out, fc2, sums in another order)."""
    x = _f32(2, 3, 6, 6, seed=10)
    out = {}
    for pkg in (jmx, tmx):
        _, qsym, qargs, _ = _quantized(pkg, ["fc2"])
        if pkg is tmx:
            args = tmx.convert.params_from_numpy(dict(qargs, data=x),
                                                 ctx=tmx.cpu())
            ex = qsym.bind(ctx=tmx.cpu(), args=args)
        else:
            ex = qsym.bind(args={k: jmx.nd.array(v, dtype=v.dtype)
                                 for k, v in dict(qargs, data=x).items()})
        out[pkg] = ex.forward()[0].asnumpy()
    np.testing.assert_allclose(out[tmx], out[jmx], rtol=1e-5, atol=1e-5)


def test_params_from_numpy_keeps_dtypes():
    arrays = {"w_q": _i8(3, 4), "w_min": np.array(-1.5, np.float32),
              "acc": np.arange(4, dtype=np.int32)}
    got = tmx.convert.params_from_numpy(arrays, ctx=tmx.cpu())
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k].asnumpy(), v)


# ---------------------------------------------------------------------------
# tests/test_quantization.py on the port
# ---------------------------------------------------------------------------


def _cpu(a):
    return tmx.nd.array(a, ctx=tmx.cpu())


def test_port_quantized_fc_int8_compute():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 8).astype(np.float32)
    w = rng.randn(16, 8).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    out = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=16,
                                 name="fc")
    qsym, qargs, _ = tq.quantize_model(
        out, {"fc_weight": _cpu(w), "fc_bias": _cpu(b)}, {},
        calib_mode="none")
    assert "fc_weight_quantized" in qargs and "fc_weight" not in qargs
    assert qargs["fc_weight_quantized"].asnumpy().dtype == np.int8
    got = qsym.bind(ctx=tmx.cpu(), args=dict(qargs, data=_cpu(x))) \
        .forward()[0].asnumpy()
    expect = x @ w.T + b
    assert np.abs(got - expect).max() / np.abs(expect).max() < 0.02


def test_port_quantized_conv_int8_compute():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    w = rng.randn(4, 3, 3, 3).astype(np.float32)
    out = tmx.sym.Convolution(tmx.sym.var("data"), num_filter=4,
                              kernel=(3, 3), no_bias=True, name="conv")
    qsym, qargs, _ = tq.quantize_model(out, {"conv_weight": _cpu(w)}, {},
                                       calib_mode="none")
    got = qsym.bind(ctx=tmx.cpu(), args=dict(qargs, data=_cpu(x))) \
        .forward()[0].asnumpy()
    expect = out.bind(ctx=tmx.cpu(), args={"conv_weight": _cpu(w),
                                           "data": _cpu(x)}) \
        .forward()[0].asnumpy()
    assert np.abs(got - expect).max() / np.abs(expect).max() < 0.03


def test_port_excluded_layer_stays_fp32():
    S = tmx.sym
    out = S.FullyConnected(S.FullyConnected(S.var("data"), num_hidden=4,
                                            name="fc1"),
                           num_hidden=2, name="fc2")
    rng = np.random.RandomState(2)
    args = {"fc1_weight": rng.randn(4, 3), "fc1_bias": np.zeros(4),
            "fc2_weight": rng.randn(2, 4), "fc2_bias": np.zeros(2)}
    args = {k: _cpu(v.astype(np.float32)) for k, v in args.items()}
    qsym, qargs, _ = tq.quantize_model(out, args, {},
                                       excluded_sym_names=["fc2"])
    assert "fc1_weight_quantized" in qargs
    assert "fc2_weight" in qargs and "fc2_weight_quantized" not in qargs
    ex = qsym.bind(ctx=tmx.cpu(), args=dict(qargs, data=_cpu(
        rng.randn(5, 3).astype(np.float32))))
    assert ex.forward()[0].shape == (5, 2)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dist", ["normal", "laplace"])
def test_calib_thresholds_kl_matches_jax(dist):
    rng = np.random.RandomState(11)
    data = rng.randn(4000) if dist == "normal" else rng.laplace(size=4000)
    kw = {"num_bins": 401, "num_quantized_bins": 63}
    assert tq.calib_thresholds_kl(data, **kw) == \
        jq.calib_thresholds_kl(data, **kw)


@pytest.mark.parametrize("data,match", [
    (np.zeros(0), "empty"), (np.array([1.0, np.nan]), "non-finite"),
    (np.zeros(10), "constant-zero")])
def test_calib_thresholds_kl_errors(data, match):
    with pytest.raises(tmx.MXNetError, match=match) as e:
        tq.calib_thresholds_kl(data, layer="conv1")
    assert "conv1" in str(e.value)
    with pytest.raises(jmx.base.MXNetError, match=match):
        jq.calib_thresholds_kl(data, layer="conv1")


def test_layer_output_collector_matches_jax():
    rng = np.random.RandomState(12)
    outs = [("conv1_output", rng.randn(3, 40)), ("fc_output", rng.randn(2, 9)),
            ("conv1_output", rng.randn(3, 40) * 2), ("skip_me", rng.randn(4))]
    cols = {}
    for pkg, mod in ((tmx, tq), (jmx, jq)):
        col = mod.LayerOutputCollector(
            include_layer=lambda n: not n.startswith("skip"))
        for name, arr in outs:
            col.collect(name, pkg.nd.array(arr.astype(np.float32),
                                           ctx=pkg.cpu()))
        cols[pkg] = col
    t, j = cols[tmx], cols[jmx]
    assert t.min_max == j.min_max and sorted(t.samples) == sorted(j.samples)
    kw = {"num_bins": 201, "num_quantized_bins": 31}
    assert t.thresholds_kl(**kw) == j.thresholds_kl(**kw)
    with pytest.raises(tmx.MXNetError, match="no layer outputs"):
        tq.LayerOutputCollector().thresholds_kl()


# ---------------------------------------------------------------------------
# the gated serving artifact
# ---------------------------------------------------------------------------


def test_artifact_round_trip(tmp_path):
    sym = _mlp_conv(tmx)
    vals = _values(sym, (4, 3, 6, 6))
    args = {k: _cpu(v) for k, v in vals.items()}
    calib = _f32(8, 3, 6, 6, seed=13)
    qsym, qargs, qaux, report = tq.quantize_serving_artifact(
        sym, args, {}, calib, topk=2, max_delta=1.0)
    assert report["quantized_layers"] == 4 and report["dtype_policy"] == "int8"
    out = str(tmp_path / "art")
    tq.save_artifact(out, qsym, qargs, qaux, report)
    assert tq.check_artifact(out) == []
    lsym, largs, _, meta = tq.load_artifact(out)
    assert meta["quantized_layers"] == 4 and meta["topk"] == 2
    assert json.loads(lsym.tojson()) == json.loads(qsym.tojson())
    for k, v in qargs.items():
        assert largs[k].dtype == v.dtype
        np.testing.assert_array_equal(largs[k].asnumpy(), v.asnumpy())
    # meta.json is the commit point
    (tmp_path / "art" / tq.ARTIFACT_META).unlink()
    assert "never committed" in tq.check_artifact(out)[0]
    with pytest.raises(tq.QuantizationGateError, match="poisoned"):
        tq.quantize_serving_artifact(sym, args, {},
                                     np.full((2, 3, 6, 6), np.nan,
                                             np.float32))
    with pytest.raises(tq.QuantizationGateError, match="no eligible"):
        tq.quantize_serving_artifact(
            sym, args, {}, calib,
            excluded_sym_names=["conv1", "conv2", "fc1", "fc2"])
