"""The port's serving.Predictor on the CPU: tests/test_serving.py's cases
on the port, then parity with the JAX Predictor on the same numpy
weights (a small Conv2D/BatchNorm/Dense HybridBlock fed uint8 batches
through uint8_normalizer, with a top-k postprocess and without: f32
outputs within rtol 1e-5 / atol 1e-6, top-k indices equal), and an MLP
int8 artifact written by the JAX quantize_model CLI and served by the
port's Predictor.from_symbol, and the reverse, each against the other
package's serving of the same artifact within 1e-5."""
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.serving import Predictor as JPredictor
from mxnet_tpu.serving import uint8_normalizer as j_uint8_normalizer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch import tracing as ttracing
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.serving import Predictor, uint8_normalizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()


@pytest.fixture(autouse=True)
def _precision(monkeypatch):
    monkeypatch.setattr(tmx.jit, "_BACKEND", "aot_eager")
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(prev)


def _net():
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    net.initialize(ctx=CPU)
    return net


def _nd(x):
    return tmx.nd.array(x, ctx=CPU)


def _rand(*shape):
    return np.random.rand(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# tests/test_serving.py on the port
# ---------------------------------------------------------------------------

def test_predictor_matches_eager_in_order():
    net = _net()
    pred, _ = Predictor.from_block(net, _nd(_rand(8, 12)), chain=4,
                                   device=CPU)
    batches = [_rand(8, 12) for _ in range(11)]       # non-multiple of chain
    outs = list(pred.predict(batches))
    assert len(outs) == 11
    for i in (0, 3, 6, 10):
        ref = net(_nd(batches[i])).asnumpy()
        np.testing.assert_allclose(outs[i], ref, rtol=1e-5, atol=1e-5)


def test_predictor_chain_one_and_empty():
    net = _net()
    pred, _ = Predictor.from_block(net, _nd(_rand(4, 12)), chain=1,
                                   device=CPU)
    outs = list(pred.predict([_rand(4, 12) for _ in range(3)]))
    assert len(outs) == 3
    assert list(pred.predict([])) == []


def _counting(pred):
    """Wrap the replica's chain dispatch: the list of batch counts of
    each call."""
    calls = []
    inner = pred._jit_chain

    def wrapped(xs, params):
        calls.append(len(xs))
        return inner(xs, params)

    pred._jit_chain = wrapped
    return calls


def test_predictor_ragged_final_batch():
    """A smaller final batch is padded to the batch shape and its output
    sliced; a larger one or another trailing shape raises."""
    net = _net()
    pred, _ = Predictor.from_block(net, _nd(_rand(8, 12)), chain=2,
                                   device=CPU)
    calls = _counting(pred)
    batches = [_rand(8, 12) for _ in range(3)]
    tail = _rand(3, 12)
    outs = list(pred.predict(batches + [tail]))
    assert len(outs) == 4
    assert outs[3].shape == (3, 4)
    ref = net(_nd(tail)).asnumpy()
    np.testing.assert_allclose(outs[3], ref, rtol=1e-5, atol=1e-5)
    # one dispatch a chunk; the tail chunk runs its own batches only
    assert calls == [2, 2]
    with pytest.raises(ValueError):
        list(pred.predict([_rand(9, 12)]))
    with pytest.raises(ValueError):
        list(pred.predict([_rand(8, 13)]))


def test_predictor_ragged_first_batch_and_dtype_guard():
    net = _net()
    pred, _ = Predictor.from_block(net, _nd(_rand(8, 12)), chain=2,
                                   device=CPU)
    small, full = _rand(3, 12), _rand(8, 12)
    outs = list(pred.predict([small, full]))
    assert outs[0].shape == (3, 4) and outs[1].shape == (8, 4)
    ref = net(_nd(full)).asnumpy()
    np.testing.assert_allclose(outs[1], ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        list(pred.predict([full.astype(np.float64)]))


def test_predictor_uint8_preprocess_on_device():
    """Raw uint8 batches + device-side normalize match normalizing on the
    host first."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1), nn.GlobalAvgPool2D(), nn.Dense(3))
    net.initialize(ctx=CPU)
    prep = uint8_normalizer(mean=(10.0, 20.0, 30.0), std=(2.0, 3.0, 4.0),
                            dtype="float32")
    raw = np.random.randint(0, 255, (4, 3, 8, 8), np.uint8)
    pred, _ = Predictor.from_block(net, raw, chain=2, preprocess=prep,
                                   device=CPU)
    outs = list(pred.predict([raw, raw, raw]))
    host_norm = (raw.astype(np.float32)
                 - np.array([10., 20., 30.]).reshape(1, 3, 1, 1)) \
        / np.array([2., 3., 4.]).reshape(1, 3, 1, 1)
    ref = net(_nd(host_norm.astype(np.float32))).asnumpy()
    np.testing.assert_allclose(outs[0], ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(outs[2], ref, rtol=1e-4, atol=1e-4)


def test_predictor_device_resident_input():
    """Batches already on the predictor's device pass the upload through
    (no host round trip)."""
    net = _net()
    pred, _ = Predictor.from_block(net, _nd(_rand(4, 12)), chain=2,
                                   device=CPU)
    host = _rand(4, 12)
    dev_b = torch.from_numpy(host)
    put = []
    orig = tserving._device_put
    tserving._device_put = lambda *a: put.append(1) or orig(*a)
    try:
        outs = list(pred.predict([dev_b, dev_b[:3]]))
    finally:
        tserving._device_put = orig
    assert put == [] and len(outs) == 2 and outs[1].shape == (3, 4)
    ref = net(_nd(host)).asnumpy()
    np.testing.assert_allclose(outs[0], ref, rtol=1e-5, atol=1e-5)


def test_predictor_single_dispatch_for_tail():
    """The tail chunk is one more dispatch of the same chain callable."""
    net = _net()
    pred, _ = Predictor.from_block(net, _nd(_rand(2, 12)), chain=4,
                                   device=CPU)
    calls = _counting(pred)
    outs = list(pred.predict([_rand(2, 12) for _ in range(6)]))
    assert len(outs) == 6
    assert calls == [4, 2]


def test_predictor_accepts_ndarray_batches():
    net = _net()
    pred, _ = Predictor.from_block(net, _nd(_rand(4, 12)), chain=2,
                                   device=CPU)
    b = _rand(4, 12)
    outs = list(pred.predict([_nd(b), _nd(b)]))
    ref = net(_nd(b)).asnumpy()
    np.testing.assert_allclose(outs[0], ref, rtol=1e-5, atol=1e-5)


def test_predictor_batch_shape_without_dtype_defaults_on_first_batch():
    pred = Predictor(lambda x, params: x * 2.0, [], batch_shape=(4, 3),
                     device=CPU)
    b = np.ones((4, 3), np.float32)
    out = list(pred.predict([b]))
    np.testing.assert_allclose(out[0], b * 2.0)


def test_predictor_implicit_contract_warns_only_when_dtype_unpinned():
    b = np.ones((4, 3), np.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pred = Predictor(lambda x, params: x + 1.0, [],
                         batch_dtype=np.float32, device=CPU)
        list(pred.predict([b]))
    assert not [x for x in w if "batch contract" in str(x.message)], w
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pred = Predictor(lambda x, params: x + 1.0, [], device=CPU)
        list(pred.predict([b]))
    assert [x for x in w if "batch contract" in str(x.message)]


def test_abandoned_stream_mid_drain_leaves_clean_state():
    """A consumer that breaks mid-drain must not strand the unconsumed
    requests' in-flight gauge entries or leave their spans open."""
    pred = Predictor(lambda x, params: x * 2.0, [], chain=4,
                     batch_shape=(4, 3), batch_dtype=np.float32,
                     device=CPU)
    batches = [np.full((4, 3), float(i), np.float32) for i in range(8)]
    ttel.enable()
    ttel.reset()
    ttracing.enable()
    ttracing.reset()
    try:
        gen = pred.predict(batches)
        first = next(gen)
        np.testing.assert_allclose(first, batches[0] * 2.0)
        gen.close()                       # client goes away mid-chunk
        assert ttel.SERVING_IN_FLIGHT.value() == 0
        assert not ttracing._active, "request spans left open"
        evs = [e for e in ttracing.chrome_trace_payload(
            include_profiler=False)["traceEvents"]
            if e.get("name") == "serving.request"]
        assert len(evs) == 8, "every admitted request span must close"
        abandoned = [e for e in evs if e.get("args", {}).get("abandoned")]
        assert len(abandoned) == 3, abandoned
    finally:
        ttracing.reset()
        ttracing.disable()
        ttel.reset()
        ttel.disable()


# ---------------------------------------------------------------------------
# port-only: the guards, the hybridized route, the error series
# ---------------------------------------------------------------------------

def test_aot_is_not_ported(monkeypatch):
    with pytest.raises(MXNetError, match="not ported yet"):
        Predictor(lambda x, p: x, [], aot="/tmp/store", device=CPU)
    with pytest.raises(MXNetError, match="not ported yet"):
        Predictor(lambda x, p: x, [], aot_spec="spec", device=CPU)
    monkeypatch.setenv("MXNET_AOT", "1")
    with pytest.raises(MXNetError, match="not ported yet"):
        Predictor(lambda x, p: x, [], device=CPU)


def test_prewarm_reports_disabled_and_needs_a_contract():
    pred = Predictor(lambda x, p: x, [], batch_shape=(2, 3),
                     batch_dtype=np.float32, device=CPU)
    assert pred.prewarm() == [{"label": "predictor", "status": "disabled"}]
    with pytest.raises(MXNetError, match="pinned batch contract"):
        Predictor(lambda x, p: x, [], device=CPU).prewarm()


def test_hybridized_block_serves_through_its_cached_op():
    net = _net()
    x = _rand(4, 12)
    ref = net(_nd(x)).asnumpy()
    net.hybridize()
    pred, _ = Predictor.from_block(net, _nd(x), chain=2, device=CPU)
    outs = list(pred.predict([x, x[:2]]))
    np.testing.assert_allclose(outs[0], ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[1], ref[:2], rtol=1e-5, atol=1e-6)
    assert net._cached_op is not None and net._cached_op._meta


def test_contract_errors_are_counted_with_a_request_id():
    pred = Predictor(lambda x, p: x, [], batch_shape=(2, 3),
                     batch_dtype=np.float32, device=CPU)
    ttel.enable()
    ttel.reset()
    try:
        with pytest.raises(TypeError):
            list(pred.predict([np.zeros((2, 3), np.int32)]))
        assert ttel.SERVING_ERRORS.value(kind="contract") == 1
        assert ttel.SERVING_IN_FLIGHT.value() == 0
    finally:
        ttel.reset()
        ttel.disable()


def test_transient_upload_failure_is_retried():
    from mxnet_tpu_torch.testing import faults

    pred = Predictor(lambda x, p: x * 3.0, [], batch_shape=(2, 3),
                     batch_dtype=np.float32, device=CPU)
    b = np.ones((2, 3), np.float32)
    with faults.transient_device_put_failures(2) as wrapper:
        out = list(pred.predict([b]))
    assert wrapper.calls == 3
    np.testing.assert_allclose(out[0], b * 3.0)
    with faults.transient_device_put_failures(3):
        with pytest.raises(RuntimeError, match="injected"):
            list(pred.predict([b]))


def test_bf16_policy_casts_params_once_and_outputs_back():
    net = _net()
    x = _rand(4, 12)
    pred, _ = Predictor.from_block(net, _nd(x), chain=2, device=CPU,
                                   dtype_policy="bf16_mixed")
    assert all(p.dtype == torch.bfloat16 for p in pred._params)
    out = list(pred.predict([x]))[0]
    assert out.dtype == np.float32
    ref = net(_nd(x)).asnumpy()
    np.testing.assert_allclose(out, ref, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("deferred", [True, False])
def test_bf16_preprocess_under_bf16_mixed(deferred):
    """The serving configuration of record: uint8 batches normalized to
    bf16, a bf16_mixed policy and a top-k postprocess.  Deferred
    parameters finish their init on a probe under the policy; the top-3
    equals the top-3 of the same predictor's logits."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(), nn.Activation("relu"),
            nn.GlobalAvgPool2D(), nn.Dense(6))
    net.initialize(ctx=CPU)
    raw = np.random.RandomState(0).randint(0, 256, (4, 3, 8, 8)) \
        .astype(np.uint8)
    if not deferred:
        net(_nd(raw.astype(np.float32)))
    prep = uint8_normalizer()
    top, _ = Predictor.from_block(
        net, raw, chain=2, preprocess=prep, device=CPU,
        postprocess=lambda o: torch.topk(o, 3).indices,
        dtype_policy="bf16_mixed")
    logits, _ = Predictor.from_block(net, raw, chain=2, preprocess=prep,
                                     device=CPU, dtype_policy="bf16_mixed")
    idx = list(top.predict([raw, raw[:3]]))
    lg = list(logits.predict([raw, raw[:3]]))
    assert [i.shape for i in idx] == [(4, 3), (3, 3)]
    assert all(x.dtype == np.float32 for x in lg)
    for i, x in zip(idx, lg):
        np.testing.assert_array_equal(np.take_along_axis(x, i, 1),
                                      -np.sort(-x, axis=1)[:, :3])


# ---------------------------------------------------------------------------
# parity with the JAX Predictor
# ---------------------------------------------------------------------------

def _conv_net(pkg, ctx=None):
    with pkg.name.NameManager():
        net = pkg.gluon.nn.HybridSequential()
        net.add(pkg.gluon.nn.Conv2D(8, 3, padding=1),
                pkg.gluon.nn.BatchNorm(),
                pkg.gluon.nn.Activation("relu"),
                pkg.gluon.nn.Conv2D(8, 3, strides=2, padding=1),
                pkg.gluon.nn.GlobalAvgPool2D(),
                pkg.gluon.nn.Dense(10))
    if ctx is None:
        net.initialize()
    else:
        net.initialize(ctx=ctx)
    return net


def _pair():
    """The small conv net in both packages on the same numpy weights
    (BatchNorm's running stats moved off their init, so the predict-mode
    normalization is exercised)."""
    raw = np.random.RandomState(0).randint(0, 256, (4, 3, 8, 8)) \
        .astype(np.uint8)
    jnet = _conv_net(jmx)
    tnet = _conv_net(tmx, CPU)
    probe = np.zeros((1, 3, 8, 8), np.float32)
    jnet(jmx.nd.array(probe))
    tnet(_nd(probe))
    rng = np.random.RandomState(1)
    arrays = {}
    for n, p in jnet.collect_params().items():
        shape = p.data().shape
        if n.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, shape)
        elif n.endswith("running_mean") or n.endswith("beta"):
            v = rng.randn(*shape) * 0.1
        elif n.endswith("gamma"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.randn(*shape) * 0.2
        arrays[n] = v.astype(np.float32)
        p.set_data(jmx.nd.array(arrays[n]))
    tmx.convert.load_from_numpy(tnet, arrays)
    return raw, jnet, tnet


@pytest.mark.parametrize("topk", [None, 3])
def test_predictor_matches_jax_predictor(topk):
    raw, jnet, tnet = _pair()
    mean, std = (120.0, 110.0, 100.0), (60.0, 55.0, 50.0)
    jpost = None if topk is None else \
        (lambda logits: jax.lax.top_k(logits, topk)[1])
    tpost = None if topk is None else \
        (lambda logits: torch.topk(logits, topk).indices)
    jpred, _ = JPredictor.from_block(
        jnet, raw, chain=2,
        preprocess=j_uint8_normalizer(mean, std, dtype="float32"),
        postprocess=jpost)
    tpred, _ = Predictor.from_block(
        tnet, raw, chain=2,
        preprocess=uint8_normalizer(mean, std, dtype="float32"),
        postprocess=tpost, device=CPU)
    rng = np.random.RandomState(2)
    batches = [rng.randint(0, 256, (4, 3, 8, 8)).astype(np.uint8)
               for _ in range(3)] + [raw[:3]]
    jouts = [np.asarray(o) for o in jpred.predict(batches)]
    touts = list(tpred.predict(batches))
    assert len(touts) == len(jouts) == 4
    for t, j in zip(touts, jouts):
        assert t.shape == j.shape
        if topk is None:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(t, j)
    if topk is not None:
        # the logits' own top-k agree too: no near-ties decide it
        jlog = [np.asarray(o) for o in JPredictor.from_block(
            jnet, raw, chain=2,
            preprocess=j_uint8_normalizer(mean, std, dtype="float32"))[0]
            .predict(batches)]
        for t, lg in zip(touts, jlog):
            np.testing.assert_array_equal(
                t, np.argsort(-lg, axis=-1, kind="stable")[:, :topk])


# ---------------------------------------------------------------------------
# int8 artifacts across the packages
# ---------------------------------------------------------------------------

def _jax_qm():
    tools = os.path.join(REPO, "tools")
    sys.path.insert(0, tools)
    try:
        import quantize_model as jqm
    finally:
        sys.path.remove(tools)
    return jqm


def _serve_port(art, batch):
    from mxnet_tpu_torch.contrib import quantization as tq

    qsym, qargs, qaux, meta = tq.load_artifact(art)
    pred = Predictor.from_symbol(
        qsym, qargs, qaux, data_name=meta["data_name"], chain=2,
        batch_shape=tuple(meta["data_shape"]),
        batch_dtype=meta["data_dtype"], device=CPU, aot_policy_tag="int8")
    return list(pred.predict([batch]))[0]


def _serve_jax(art, batch):
    from mxnet_tpu.contrib import quantization as jq

    qsym, qargs, qaux, meta = jq.load_artifact(art)
    pred = JPredictor.from_symbol(
        qsym, qargs, qaux, data_name=meta["data_name"], chain=2,
        batch_shape=tuple(meta["data_shape"]),
        batch_dtype=meta["data_dtype"], aot_policy_tag="int8")
    return np.asarray(list(pred.predict([batch]))[0])


def test_jax_artifact_served_by_the_port(tmp_path):
    from mxnet_tpu_torch.tools import quantize_model as tqm

    art = str(tmp_path / "jart")
    assert _jax_qm().main(["--model", "mlp", "--out", art,
                           "--seed", "1"]) == 0
    assert tqm.main(["--check", art]) == 0
    batch = np.random.RandomState(3).rand(8, 16).astype(np.float32)
    got = _serve_port(art, batch)
    want = _serve_jax(art, batch)
    assert got.shape == want.shape == (8, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_port_artifact_served_by_jax(tmp_path):
    from mxnet_tpu_torch.tools import quantize_model as tqm

    art = str(tmp_path / "tart")
    assert tqm.main(["--model", "mlp", "--out", art, "--seed", "1",
                     "--device", "cpu"]) == 0
    assert _jax_qm().main(["--check", art]) == 0
    batch = np.random.RandomState(4).rand(8, 16).astype(np.float32)
    got = _serve_jax(art, batch)
    want = _serve_port(art, batch)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
