"""The port's LM serving path (mxnet_tpu_torch/generate.py) held against
the JAX package's mxnet_tpu/generate.py on CPU.

One LM at tests/test_generate.py:44's size (weights carried from the JAX
LM by name) under both packages' GenerationEngine (3 slots, cache 24,
buckets 8 and 24, greedy): the same tokens with several slots live and
admits between decode steps, the same occupancy, slot exhaustion as
``Overloaded("slots")`` with LIFO reuse, a too-long prompt rejected, and
the ``MXNET_DECODE_*`` knobs parsed alike.  Sampling: the top-k / top-p /
temperature masks equal the logits JAX's ``sample_logits`` hands to
``jax.random.categorical``; draws reproducible under ``mx.random.seed``.
TokenServer: the JAX server's tokens, finishes by ``eos`` and
``length``, ``Overloaded`` for a full queue and after shutdown, both
deadline stages, cancel and a drained close (tests/test_generate.py:
312-423), with a sleeping wrapper around ``decode_step`` where the JAX
suite injects latency.  Matmul precision is pinned: JAX to "float32",
torch to "highest".
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu import config as jconfig
from mxnet_tpu import generate as jgen
from mxnet_tpu import serving_async as jserving

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import generate as tgen
from mxnet_tpu_torch import serving_async as tserving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.examples import transformer_lm as tlm
from mxnet_tpu_torch.name import NameManager as TNameManager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import transformer_lm as jlm  # noqa: E402

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN = 48, 32, 2, 2, 24
CFG = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=N_HEADS,
           n_layers=N_LAYERS, max_len=MAX_LEN)
ENGINE = dict(slots=3, cache_len=MAX_LEN, buckets=[8, MAX_LEN])


@pytest.fixture(autouse=True)
def _precision():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    with jax.default_matmul_precision("float32"):
        yield
    torch.set_float32_matmul_precision(before)


@pytest.fixture(scope="module")
def nets():
    with jax.default_matmul_precision("float32"):
        jmx.random.seed(0)
        with jmx.name.NameManager():
            jnet = jlm.TransformerLM(**CFG)
        jnet.initialize(jmx.init.Xavier())
        jnet(jmx.nd.array(np.zeros((1, 4), np.float32)))
    weights = {n: p.data().asnumpy()
               for n, p in jnet.collect_params().items()}
    with TNameManager():
        tnet = tlm.TransformerLM(**CFG)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.convert.load_from_numpy(tnet, weights)
    return jnet, tnet


@pytest.fixture(scope="module")
def engines(nets):
    jnet, tnet = nets
    greedy = dict(ENGINE)
    with jax.default_matmul_precision("float32"):
        jeng = jgen.GenerationEngine(
            jnet, sampling=jgen.SamplingConfig(greedy=True), **greedy)
    teng = tgen.GenerationEngine(
        tnet, sampling=tgen.SamplingConfig(greedy=True), device=tmx.cpu(),
        **greedy)
    return jeng, teng


@pytest.fixture
def teng(engines):
    eng = engines[1]
    yield eng
    for s in eng.active_slots():
        eng.evict(s, "length")
    assert eng.free_slots() == eng.slots


def _prompt(n=5, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, n).astype(np.int32)


def _script(eng):
    """Admits between decode steps, several slots live; every output."""
    out = []
    out.append(eng.admit(_prompt(5, 1)))
    out += [eng.decode_step() for _ in range(2)]
    out.append(eng.admit(_prompt(7, 2)))
    out.append(eng.occupancy())
    out += [eng.decode_step() for _ in range(3)]
    out.append(eng.admit(_prompt(12, 3)))      # the 24 bucket
    out += [eng.decode_step() for _ in range(2)]
    out.append(eng.occupancy())
    out.append([eng.position(s) for s in range(eng.slots)])
    eng.evict(1, "eos")
    out.append(eng.decode_step())
    out.append(eng.admit(_prompt(3, 4)))       # the freed lane, LIFO
    out.append(eng.decode_step())
    for s in eng.active_slots():
        eng.evict(s, "length")
    out.append(eng.occupancy())
    return out


def test_greedy_tokens_and_occupancy_match_jax(engines):
    jeng, teng = engines
    with jax.default_matmul_precision("float32"):
        want = _script(jeng)
    assert _script(teng) == want


def test_engine_decode_matches_full_forward(nets, teng):
    _jnet, tnet = nets
    prompt = _prompt(5, seed=3)
    slot, tok = teng.admit(prompt)
    toks = [tok]
    for _ in range(6):
        toks.append(teng.decode_step()[slot])
    seq, ref = list(prompt), []
    for _ in range(7):
        logits = tnet(tmx.nd.array(np.asarray(seq, np.float32)[None],
                                   ctx=tmx.cpu())).asnumpy()
        ref.append(int(logits[0, -1].argmax()))
        seq.append(ref[-1])
    assert toks == ref


def test_slot_exhaustion_and_lifo_reuse(teng):
    slots = [teng.admit(_prompt(4, seed=i))[0] for i in range(teng.slots)]
    assert sorted(slots) == [0, 1, 2]
    with pytest.raises(tgen.Overloaded) as ei:
        teng.admit(_prompt(4))
    assert ei.value.reason == "slots"
    teng.evict(slots[1], "eos")
    teng.evict(slots[0], "eos")
    assert teng.admit(_prompt(4, seed=9))[0] == slots[0]
    assert teng.admit(_prompt(4, seed=8))[0] == slots[1]


def test_prompt_too_long_raises(teng):
    with pytest.raises(MXNetError, match="prefill bucket"):
        teng.admit(np.zeros(MAX_LEN + 1, np.int32))
    with pytest.raises(MXNetError, match="at least one"):
        teng.admit([])
    for bad in ([3, VOCAB], [-1, 2]):
        with pytest.raises(MXNetError, match="must lie in"):
            teng.admit(bad)
    assert teng.free_slots() == teng.slots


def test_ring_wraparound_runs_to_capacity(nets):
    eng = tgen.GenerationEngine(nets[1], slots=1, cache_len=8, buckets=[8],
                                device=tmx.cpu())
    slot, tok = eng.admit(_prompt(6, seed=6))
    produced = [tok]
    while not eng.at_capacity(slot):
        produced.append(eng.decode_step()[slot])
    assert len(produced) == MAX_LEN - 6 + 1
    assert all(0 <= t < VOCAB for t in produced)


def test_bf16_mixed_engine_tracks_policy_prefill(nets):
    e = tgen.GenerationEngine(nets[1], slots=2, cache_len=16, buckets=[16],
                              dtype_policy="bf16_mixed", device=tmx.cpu())
    assert e.cache_dtype == torch.bfloat16
    assert e.dtype_policy_tag == "bf16_mixed"
    prompt = _prompt(5, seed=4)
    slot, tok = e.admit(prompt)
    seq = list(prompt) + [tok]
    for _ in range(4):
        step = e.decode_step()
        got = e.last_logits[slot]
        ref_slot, _rt = e.admit(np.asarray(seq, np.int32)[:16])
        ref = e.last_logits[0]
        e.evict(ref_slot, "length")
        np.testing.assert_allclose(got, ref, atol=0.12, rtol=0.05)
        assert int(got.argmax()) == int(ref.argmax())
        seq.append(step[slot])


def test_engine_surface(nets, teng):
    assert teng.buckets == [8, MAX_LEN] and teng.cache_len == MAX_LEN
    assert teng.prewarm() == [{"label": "generate", "status": "disabled"}]
    assert teng.bucket_for(9) == MAX_LEN
    assert teng.dtype_policy_tag == "f32" and \
        teng.cache_dtype == torch.float32
    for kw in ({"mesh": "dp=2"}, {"layout": "fsdp_tp"}, {"aot": "/x"},
               {"aot_spec": "lm"}):
        with pytest.raises(MXNetError, match="not ported yet"):
            tgen.GenerationEngine(nets[1], device=tmx.cpu(), **kw)
    with pytest.raises(MXNetError, match="decode protocol"):
        tgen.GenerationEngine(tmx.gluon.nn.Dense(2), device=tmx.cpu())


@pytest.mark.parametrize("name,raw", [
    ("MXNET_DECODE_SLOTS", None), ("MXNET_DECODE_SLOTS", "12"),
    ("MXNET_DECODE_CACHE_LEN", "bad"), ("MXNET_DECODE_BUCKETS", None),
    ("MXNET_DECODE_BUCKETS", "16,48"), ("MXNET_DECODE_QUEUE", "3"),
    ("MXNET_DECODE_DEADLINE_MS", "250.5"), ("MXNET_DECODE_MAX_NEW", None),
    ("MXNET_DECODE_PAGE_SIZE", None), ("MXNET_DECODE_PAGE_SIZE", "bad"),
    ("MXNET_DECODE_PAGES", None), ("MXNET_DECODE_PAGES", "129"),
    ("MXNET_DECODE_PREFILL_CHUNK", None),
    ("MXNET_DECODE_PREFILL_CHUNK", "16"), ("MXNET_DECODE_SPEC_K", None),
    ("MXNET_DECODE_SPEC_K", "4"), ("MXNET_DECODE_SPEC_NGRAM", None),
    ("MXNET_DECODE_SPEC_NGRAM", "3"), ("MXNET_DECODE_PREFIX_SHARE", None),
    ("MXNET_DECODE_PREFIX_SHARE", "0")])
def test_decode_knobs_parse_like_jax(monkeypatch, name, raw):
    if raw is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, raw)
    with pytest.warns(UserWarning) if raw == "bad" else _no_warning():
        got = tconfig.get(name)
    with pytest.warns(UserWarning) if raw == "bad" else _no_warning():
        assert got == jconfig.get(name)
    assert tgen._parse_buckets(None, 40) == jgen._parse_buckets(None, 40)


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _logits():
    rng = np.random.RandomState(11)
    logits = rng.randn(4, 16).astype(np.float32) * 2
    logits[1, 3] = logits[1, 7] = logits[1].max() + 1.0    # a tie at the top
    logits[2, :] = 0.5                                     # all equal
    return logits


def _jax_masked(monkeypatch, logits, cfg):
    """The logits JAX's sample_logits passes to jax.random.categorical."""
    seen = {}

    def capture(key, lg, *a, **kw):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), cfg)
    monkeypatch.undo()
    return seen["logits"]


@pytest.mark.parametrize("kw", [
    dict(top_k=1), dict(top_k=3), dict(top_k=40), dict(top_p=0.5),
    dict(top_p=0.9, temperature=0.7), dict(top_k=5, top_p=0.6),
    dict(temperature=2.0), dict(top_p=1.0, top_k=2)])
def test_masks_equal_jax(monkeypatch, kw):
    logits = _logits()
    want = _jax_masked(monkeypatch, logits,
                       jgen.SamplingConfig(greedy=False, **kw))
    got = tgen.mask_logits(torch.from_numpy(logits),
                           tgen.SamplingConfig(greedy=False, **kw)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)],
                               want[np.isfinite(want)], rtol=1e-6)


def test_greedy_takes_the_first_maximum_like_jax():
    logits = _logits()
    cfg = tgen.SamplingConfig()
    got = tgen.sample_logits(torch.from_numpy(logits), None, cfg).tolist()
    want = np.asarray(jgen.sample_logits(
        jnp.asarray(logits), jax.random.PRNGKey(0),
        jgen.SamplingConfig())).tolist()
    assert got == want and got[1] == 3 and got[2] == 0


def test_sampling_config_validation_like_jax():
    for kw in (dict(temperature=0), dict(top_k=0), dict(top_p=1.5)):
        with pytest.raises(MXNetError):
            tgen.SamplingConfig(**kw)
        with pytest.raises(jmx.base.MXNetError):
            jgen.SamplingConfig(**kw)
    for kw in (dict(), dict(greedy=False, top_k=8, temperature=0.9),
               dict(greedy=False, top_p=0.5)):
        assert tgen.SamplingConfig(**kw).tag == jgen.SamplingConfig(**kw).tag


def test_sampling_reproducible_under_seed(nets):
    e = tgen.GenerationEngine(
        nets[1], slots=2, cache_len=16, buckets=[8], device=tmx.cpu(),
        sampling=tgen.SamplingConfig(greedy=False, top_k=8,
                                     temperature=0.9))

    def run():
        slot, tok = e.admit(_prompt(4, seed=5))
        out = [tok]
        for _ in range(5):
            out.append(e.decode_step()[slot])
        e.evict(slot, "length")
        return out

    tmx.random.seed(7)
    a = run()
    tmx.random.seed(7)
    b = run()
    assert a == b and all(0 <= t < VOCAB for t in a)
    # the draws come from the framework stream, top-k respected
    logits = torch.from_numpy(_logits())
    cfg = tgen.SamplingConfig(greedy=False, top_k=2)
    tmx.random.seed(3)
    draws = torch.stack([tgen.sample_logits(logits, None, cfg)
                         for _ in range(50)])
    kth = torch.topk(logits, 2, dim=-1).values[:, -1:]
    for row in range(4):
        # ties with the 2nd logit stay (row 2 is all ties)
        allowed = torch.nonzero(logits[row] >= kth[row]).reshape(-1)
        assert set(draws[:, row].tolist()) <= set(allowed.tolist())


# ---------------------------------------------------------------------------
# TokenServer
# ---------------------------------------------------------------------------

def _slow(eng, monkeypatch, delay):
    """A decode step that sleeps first (the JAX suite's LatencySpike)."""
    orig = eng.decode_step

    def slow():
        time.sleep(delay)
        return orig()

    monkeypatch.setattr(eng, "decode_step", slow)


def test_server_tokens_match_jax_server(engines):
    jeng, teng = engines
    with jax.default_matmul_precision("float32"):
        jsrv = jgen.TokenServer(jeng, queue_depth=8, max_new_tokens=6)
        try:
            want = [jsrv.generate(_prompt(5, s), timeout=120)
                    for s in range(3)]
        finally:
            jsrv.close()
    tsrv = tgen.TokenServer(teng, queue_depth=8, max_new_tokens=6)
    try:
        got = [tsrv.generate(_prompt(5, s), timeout=60) for s in range(3)]
    finally:
        tsrv.close()
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == ["length"] * 3
    assert teng.free_slots() == teng.slots


def test_server_finishes_by_length_and_eos(teng):
    srv = tgen.TokenServer(teng, queue_depth=8, max_new_tokens=4)
    try:
        r = srv.generate(_prompt(5), timeout=60)
        assert r.finish_reason == "length" and len(r.tokens) == 4
        assert r.ttft_s is not None and r.ttft_s >= 0
        teng.sampling.eos_id = r.tokens[1]
        try:
            r2 = srv.generate(_prompt(5), max_new_tokens=10, timeout=60)
        finally:
            teng.sampling.eos_id = None
        assert r2.finish_reason == "eos" and r2.tokens == r.tokens[:2]
        streamed = []
        r3 = srv.generate(_prompt(5), timeout=60, on_token=streamed.append)
        assert streamed == r3.tokens == r.tokens
    finally:
        srv.close()


def test_server_overload_queue_and_shutdown(teng, monkeypatch):
    srv = tgen.TokenServer(teng, queue_depth=1, max_new_tokens=8)
    _slow(teng, monkeypatch, 0.05)
    try:
        futs = [srv.submit(_prompt(4, seed=i), block=True, timeout=30)
                for i in range(teng.slots)]
        deadline = time.monotonic() + 10
        while teng.free_slots() > 0:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        fq = srv.submit(_prompt(4, seed=90))      # fills the queue
        with pytest.raises(tgen.Overloaded) as ei:
            srv.submit(_prompt(4, seed=91))
        assert ei.value.reason == "queue"
        assert srv.stats()["queue_depth"] == 1
        for f in futs + [fq]:
            assert f.result(timeout=60).finish_reason == "length"
    finally:
        srv.close()
    with pytest.raises(tgen.Overloaded) as ei:
        srv.submit(_prompt(4))
    assert ei.value.reason == "shutdown"
    assert srv.stats()["closed"]


def test_server_deadline_stages_prefill_vs_decode(teng, monkeypatch):
    srv = tgen.TokenServer(teng, queue_depth=8, max_new_tokens=64)
    _slow(teng, monkeypatch, 0.05)
    try:
        fut = srv.submit(_prompt(4), deadline_ms=200)
        with pytest.raises(tgen.DeadlineExceeded) as ei:
            fut.result(timeout=60)
        assert ei.value.stage == "decode"
        longs = [srv.submit(_prompt(4, seed=i), max_new_tokens=30)
                 for i in range(teng.slots)]
        time.sleep(0.1)
        fut2 = srv.submit(_prompt(4, seed=50), deadline_ms=60)
        with pytest.raises(tgen.DeadlineExceeded) as ei:
            fut2.result(timeout=60)
        assert ei.value.stage == "prefill"
        for f in longs:
            f.cancel()
    finally:
        srv.close()


def test_server_cancel_and_drain(teng, monkeypatch):
    srv = tgen.TokenServer(teng, queue_depth=8, max_new_tokens=50)
    _slow(teng, monkeypatch, 0.02)
    fut = srv.submit(_prompt(4))
    time.sleep(0.08)          # active in a slot by now
    assert fut.cancel()
    assert fut.cancelled()
    with pytest.raises(tgen.Cancelled):
        fut.result(timeout=60)
    deadline = time.monotonic() + 30
    while teng.free_slots() != teng.slots:
        assert time.monotonic() < deadline, "cancelled slot leaked"
        time.sleep(0.01)
    fut2 = srv.submit(_prompt(4), max_new_tokens=2)
    monkeypatch.undo()
    srv.close(drain=True, timeout=30)
    assert fut2.result(timeout=1).finish_reason == "length"
    assert not srv._worker.is_alive()


def test_server_rejects_what_is_not_ported(teng):
    # slo_ms is ported now: on a burning TTFT histogram the server sheds
    # at admission with Overloaded("slo")
    from mxnet_tpu_torch import telemetry as ttel

    hist = ttel.Histogram("mxnet_tpu_ttft_shed_test_seconds", "t",
                          buckets=(0.01, 0.1, 1.0))
    was_on = ttel.enabled()
    ttel.enable()
    slo = tgen.TokenServer(teng, slo_ms=50, shed_hist=hist)
    try:
        for _ in range(10):
            hist.observe(0.5)
        assert slo._shedder.update() is True
        with pytest.raises(tgen.Overloaded) as ei:
            slo.submit(_prompt(4))
        assert ei.value.reason == "slo"
        assert slo.stats()["shedding"] is True
    finally:
        slo.close()
        if not was_on:
            ttel.disable()
    srv = tgen.TokenServer(teng)
    try:
        with pytest.raises(MXNetError, match="prefill bucket"):
            srv.submit(np.zeros(MAX_LEN + 1, np.int32))
        with pytest.raises(MXNetError, match="must lie in"):
            srv.submit([VOCAB + 5])
        assert srv.stats() == {"queue_depth": 0, "active": 0,
                               "free_slots": teng.slots, "shedding": False,
                               "closed": False}
    finally:
        srv.close()


def test_serving_errors_like_jax():
    for t, j in ((tserving.Overloaded("queue", "depth 1"),
                  jserving.Overloaded("queue", "depth 1")),
                 (tserving.DeadlineExceeded("decode", "late"),
                  jserving.DeadlineExceeded("decode", "late")),
                 (tserving.Cancelled("gone"), jserving.Cancelled("gone")),
                 (tserving.ReplicaFailed("boom"),
                  jserving.ReplicaFailed("boom"))):
        assert str(t) == str(j)
        assert isinstance(t, tserving.ServingError)
        assert type(t).__name__ == type(j).__name__
    assert tserving.Overloaded("slots").reason == "slots"
    assert tserving.DeadlineExceeded("prefill").stage == "prefill"
    f = tserving.ServingFuture()
    assert f._resolve(result=1) and not f._resolve(result=2)
    assert f.result(0) == 1 and f.done() and not f.cancelled()
    with pytest.raises(TimeoutError):
        tserving.ServingFuture().result(0.01)
