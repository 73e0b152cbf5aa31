"""The observability layer of the port (mxnet_tpu_torch.telemetry,
tracing, profiler, perf_ledger, events) against the JAX package's, fed
the same inputs, and its producers on the port's training and serving
paths.

* catalog: every metric's name, kind, label names, buckets and help
  text are the JAX package's;
* scrape: one scripted sequence of inc/set/observe gives byte-equal
  Prometheus text and OpenMetrics text;
* tracing: one span tree gives the same names, parents, status and args
  in ``chrome_trace_payload`` (ids and times left out);
* profiler: ``dumps()``'s statistics table agrees after the same
  ``record_op_time`` calls (the device-memory section names each
  package's own devices and is left out);
* perf_ledger: ``make_record``, ``validate_record`` and
  ``parse_bench_lines`` agree, provenance aside, and
  ``StepBreakdown.from_telemetry`` agrees over the same registry values
  (floats within 1e-12 relative);
* events: ``emit``'s kept and sampled-out records agree under one seed;
* the slice: a 2-layer MLP through both packages' ShardedTrainer for 3
  steps with telemetry and tracing on moves the same series; the port's
  ``step_breakdown()`` buckets sum to span + gap; the tiny LM's
  TokenServer files the same wide events and DECODE_TOKENS as the JAX
  one on the same greedy prompts; with the layer off nothing moves.

Registries, ring buffers and flags are process-wide, so each test
resets both packages' state before and after it.
"""
import json
import math
import os
import random
import sys

import numpy as np
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu import events as jev
from mxnet_tpu import generate as jgen
from mxnet_tpu import parallel as jparallel
from mxnet_tpu import perf_ledger as jpl
from mxnet_tpu import profiler as jprof
from mxnet_tpu import telemetry as jtel
from mxnet_tpu import tracing as jtr
from mxnet_tpu.name import NameManager as JNameManager

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import events as tev
from mxnet_tpu_torch import generate as tgen
from mxnet_tpu_torch import parallel as tparallel
from mxnet_tpu_torch import perf_ledger as tpl
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch import tracing as ttr
from mxnet_tpu_torch.examples import transformer_lm as tlm
from mxnet_tpu_torch.name import NameManager as TNameManager

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import transformer_lm as jlm  # noqa: E402

FLOAT_RTOL = 1e-12
BOTH_TEL = (jtel, ttel)
BOTH_TR = (jtr, ttr)
BOTH_EV = (jev, tev)


def _quiet_all():
    for t in BOTH_TEL:
        t.reset()
        t.disable()
    for t in BOTH_TR:
        t.disable()
        t.reset()
    for e in BOTH_EV:
        e.disable()
        e.reset()


@pytest.fixture(autouse=True)
def _isolated():
    _quiet_all()
    yield
    _quiet_all()


# ---------------------------------------------------------------------------
# telemetry: the catalog and the exposition
# ---------------------------------------------------------------------------

def _catalog(tel):
    out = {}
    for m in tel.REGISTRY.metrics():
        out[m.name] = (m.kind, tuple(m.label_names), m.help,
                       tuple(getattr(m, "buckets", ()) or ()))
    return out


def test_catalog_equal():
    want, got = _catalog(jtel), _catalog(ttel)
    assert sorted(got) == sorted(want)
    assert got == want
    assert len(got) > 90


def _script(tel):
    """One scripted sequence over counters, gauges and histograms, the
    labeled and the unlabeled."""
    tel.TRAIN_STEPS.inc(3, loop="sharded")
    tel.TRAIN_STEPS.inc(loop="module")
    tel.TRAIN_STEP_SECONDS.observe(0.0123, loop="sharded")
    tel.TRAIN_STEP_SECONDS.observe(0.2, loop="sharded")
    tel.TRAIN_STEP_SECONDS.observe(7.0, loop="module")
    tel.HOST_GAP_SECONDS.observe(0.0004, loop="sharded")
    tel.TRAIN_LOSS.set(2.302585)
    tel.TRAIN_SAMPLES_PER_SEC.set(1234.5)
    tel.LOSS_SCALE.set(65536.0)
    tel.COLLECTIVE_BYTES.inc(4096, axis="sp", op="ppermute")
    tel.COLLECTIVE_BYTES.inc(1 << 20, axis="sp", op="all_to_all")
    tel.DECODE_TOKENS.inc(48)
    tel.DECODE_BATCH_TOKENS.observe(16)
    tel.DECODE_TTFT_SECONDS.observe(0.031)
    tel.DECODE_EVICTIONS.inc(reason="length")
    tel.SERVING_SHED.inc(reason='odd "quote"\nline')
    tel.DEVICE_MEMORY_BYTES_IN_USE.set(1 << 30, device="dev0")
    tel.FUSION_REWRITES.inc(pattern="conv_bn_relu")
    tel.PREFETCH_WAIT_SECONDS.observe(200.0)      # past the last bucket
    tel.TRAIN_MFU.set(float("nan"))


@pytest.mark.parametrize("openmetrics", [False, True])
def test_scrape_byte_equal(openmetrics):
    texts = []
    for tel in BOTH_TEL:
        tel.enable()
        _script(tel)
        texts.append(tel.scrape(openmetrics=openmetrics))
    assert texts[1] == texts[0]
    assert "mxnet_tpu_train_steps_total{loop=\"sharded\"} 3" in texts[1]


def test_collect_and_dump_equal(tmp_path):
    snaps = []
    for i, tel in enumerate(BOTH_TEL):
        tel.enable()
        _script(tel)
        path = tmp_path / ("dump%d.json" % i)
        tel.dump(path)
        with open(path) as f:
            snaps.append((tel.collect(), json.load(f)["metrics"]))
    assert snaps[1][0] == snaps[0][0]
    assert snaps[1][1] == snaps[0][1]


def test_disabled_mutators_record_nothing():
    before = ttel.collect()
    _script(ttel)
    assert ttel.collect() == before


def test_merge_collected_delegates_to_fleet():
    snaps = []
    for tel in BOTH_TEL:
        tel.enable()
        _script(tel)
        a = tel.collect()
        tel.TRAIN_STEPS.inc(5, loop="sharded")
        snaps.append(tel.merge_collected([a, tel.collect()]))
    assert snaps[1] == snaps[0]


def test_peak_flops_reads_no_probe(monkeypatch):
    monkeypatch.delenv("MXNET_PEAK_TFLOPS", raising=False)
    ttel.set_peak_flops(None)
    assert ttel.peak_flops() is None        # no docs/mfu_probe.json read
    monkeypatch.setenv("MXNET_PEAK_TFLOPS", "989.4")
    ttel.set_peak_flops(None)
    assert ttel.peak_flops() == pytest.approx(989.4e12)
    ttel.set_peak_flops(1e15)
    assert ttel.peak_flops() == 1e15
    ttel.set_peak_flops(None)


def test_statusz_schema_and_scrape_endpoint():
    import urllib.request

    ttel.enable()
    st = ttel.statusz()
    assert {"process", "aot", "fusion", "serving", "decode", "checkpoint",
            "gateway", "events", "fleet", "goodput"} <= set(st["subsystems"])
    assert set(st["subsystems"]) == set(jtel.statusz()["subsystems"])
    srv = ttel.serve_scrape(port=0, host="127.0.0.1")
    try:
        base = "http://127.0.0.1:%d" % srv.port
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert b"mxnet_tpu_train_steps_total" in r.read()
        with urllib.request.urlopen(base + "/statusz", timeout=10) as r:
            assert json.loads(r.read())["ready"] is True
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert r.status == 200
    finally:
        ttel.stop_scrape()


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def _span_tree(tr):
    """One span tree: nesting through contextvars, a detached root, an
    instant, an error and a still-open span."""
    with tr.span("root", phase="a"):
        outer = tr.begin("outer", args={"step": 1, "x": 1.5})
        tr.instant("tick", args={"n": 3})
        inner = tr.begin("inner")
        inner.set(tokens=7)
        inner.end(error=True)
        outer.end()
        det = tr.begin("detached", activate=False, args={"k": "v"})
        det.end()
    try:
        with tr.span("boom"):
            raise ValueError("x")
    except ValueError:
        pass
    return tr.begin("open", args={"still": True})


def _tree(payload):
    evs = [e for e in payload["traceEvents"] if e.get("cat") == "span"]
    names = {e["args"]["span_id"]: e["name"] for e in evs}
    out = []
    for e in sorted(evs, key=lambda e: (e["ts"], e["name"])):
        args = {k: v for k, v in e["args"].items()
                if k not in ("trace_id", "span_id", "parent_id")}
        out.append((e["name"], e["ph"], names.get(e["args"]["parent_id"]),
                    args))
    return out


def test_chrome_trace_same_tree():
    trees = []
    for tr in BOTH_TR:
        tr.enable()
        left_open = _span_tree(tr)
        trees.append(_tree(tr.chrome_trace_payload(include_profiler=False)))
        left_open.end()
    assert trees[1] == trees[0]
    assert [t[0] for t in trees[1]] == ["root", "outer", "tick", "inner",
                                        "detached", "boom", "open"]
    assert trees[1][-1][3]["incomplete"] is True


def test_tracing_off_is_a_noop():
    with ttr.span("nothing"):
        pass
    ttr.instant("nothing")
    payload = ttr.chrome_trace_payload(include_profiler=False)
    assert [e for e in payload["traceEvents"] if e.get("cat") == "span"] \
        == []


def test_flight_recorder_bundle(tmp_path):
    ttr.enable()
    ttr.enable_flight_recorder(str(tmp_path))
    try:
        ttr.rearm_flight_recorder()
        path = ttr.record_crash("exception-step", ValueError("boom"),
                                extra={"layer": "test"})
    finally:
        ttr.disable_flight_recorder()
    assert path is not None
    names = sorted(os.listdir(path))
    assert {"trace.json", "telemetry.json", "stacks.txt",
            "info.json"} <= set(names)
    with open(os.path.join(path, "info.json")) as f:
        info = json.load(f)
    assert info["torch"]["version"] == torch.__version__
    assert info["exception"]["type"] == "ValueError"
    assert "jax" not in info


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------

def _table(text):
    return text.split("\nDevice memory:")[0]


def test_profiler_dumps_agree():
    texts = []
    for prof in (jprof, tprof):
        prof.dumps(reset=True)
        for name, dur in (("conv", 0.004), ("conv", 0.002), ("fc", 0.0005),
                          ("step", 0.25), ("fc", 0.0015)):
            prof.record_op_time(name, dur, start_s=1.0)
        texts.append(prof.dumps(reset=True))
    assert _table(texts[1]) == _table(texts[0])
    assert "conv" in texts[1] and "Calls" in texts[1]


def test_profiler_memory_schema_and_torch_trace(tmp_path):
    mem = tprof.device_memory_stats()
    assert mem
    for entry in mem.values():
        assert {"bytes_in_use", "peak_bytes_in_use"} <= set(entry)
    if not torch.cuda.is_available():
        assert "unavailable" in mem["cpu"]
    tprof.set_config(filename=str(tmp_path / "profile.json"),
                     aggregate_stats=False)
    ttr.enable()
    try:
        tprof.start()
        assert tprof.last_error() is None
        with ttr.span("ShardedTrainer.step"):
            with tprof.Task(tprof.Domain("d"), "annotated"):
                torch.ones(8).sum()
        tprof.stop()
        path = tprof.dump()
    finally:
        tprof.set_config(filename="profile.json")
    with open(path) as f:
        payload = json.load(f)
    assert any(e.get("name") == "ShardedTrainer.step"
               for e in payload["traceEvents"])
    dev = tprof.device_trace_path()
    assert dev.startswith(str(tmp_path / "profile_trace"))
    with open(dev) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "annotated" in names


# ---------------------------------------------------------------------------
# perf_ledger
# ---------------------------------------------------------------------------

PROV = {"git_sha": "abc", "jax_version": "unknown",
        "jaxlib_version": "unknown", "backend": "cpu", "device_kind": "cpu",
        "device_count": 1, "mesh_shape": {"dp": 1}, "layout": None,
        "dtype_policy": "bf16_mixed", "fusion_table_sha": None,
        "aot": "off", "steps_per_call": 4}


def _strip(rec):
    return {k: v for k, v in rec.items()
            if k not in ("run_id", "time", "provenance")}


def test_make_and_validate_records_agree():
    recs = []
    for pl in (jpl, tpl):
        recs.append(pl.make_record(
            "resnet50_train_images_per_sec_per_chip", 1491.25, "img/s",
            run_id="r1", prov=dict(PROV), warmup_seconds=3.5,
            attribution={"loop": "sharded", "buckets_ms_per_step": {
                "device_compute": 170.25, "host_other": 1.5}}))
    assert _strip(recs[1]) == _strip(recs[0])
    assert recs[1]["provenance"] == recs[0]["provenance"] == PROV
    bad = [dict(recs[0]), {"metric": "x"}, "nope",
           dict(recs[0], value="fast"), dict(recs[0], schema_version=99)]
    del bad[0]["unit"]
    for rec in bad + [recs[0], recs[1]]:
        assert tpl.validate_record(rec) == jpl.validate_record(rec)
    assert tpl.validate_record(recs[1]) == []
    # the port's own provenance passes the JAX schema check
    own = tpl.make_record("m", 1.0, "u")
    assert jpl.validate_record(own) == []
    assert own["provenance"]["jax_version"] == "unknown"
    assert own["provenance"]["backend"] in ("cuda", "cpu")
    assert set(own["provenance"]) == set(jpl.PROVENANCE_KEYS)


def test_parse_bench_lines_agree():
    text = "\n".join([
        "warmup 1/3", 'BENCH {"metric": "a", "value": 1}',
        '{"metric": "legacy", "value": 2}', "{not json}",
        'BENCH {"value": 3}', '  BENCH {"metric": "b", "value": 4}  ',
        '{"other": 1}'])
    for legacy in (True, False):
        assert tpl.parse_bench_lines(text, legacy=legacy) == \
            jpl.parse_bench_lines(text, legacy=legacy)
    assert [r["metric"] for r in tpl.parse_bench_lines(text)] == \
        ["a", "legacy", "b"]


def _close(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=FLOAT_RTOL, abs_tol=0.0)
    return a == b


def test_step_breakdown_from_same_values():
    out = []
    for tel, pl in ((jtel, jpl), (ttel, tpl)):
        tel.enable()
        for i in range(6):
            tel.TRAIN_STEP_SECONDS.observe(0.1 + 0.01 * i, loop="sharded")
            tel.HOST_GAP_SECONDS.observe(0.002 * i, loop="sharded")
        tel.TRAIN_STEPS.inc(6, loop="sharded")
        tel.PREFETCH_WAIT_SECONDS.observe(0.003)
        tel.COMPILE_SECONDS.observe(0.05)
        tel.COLLECTIVE_BYTES.inc(6 * 1024, axis="sp", op="ppermute")
        bd = pl.StepBreakdown.from_telemetry(loop="sharded")
        out.append((bd.as_dict(), bd.buckets(), bd.wall_s))
    assert out[1][0] == out[0][0]
    assert _close(out[1][1], out[0][1])
    assert math.isclose(sum(out[1][1].values()), out[1][2],
                        rel_tol=FLOAT_RTOL)


def test_ledger_append_and_read(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    rec = tpl.make_record("m", 2.0, "u", prov=dict(PROV))
    tpl.append(rec, path=path)
    with open(path, "a") as f:
        f.write("{torn\n")
    for pl in (jpl, tpl):
        recs, problems = pl.read_ledger(path)
        assert [r["value"] for r in recs] == [2.0]
        assert [p[0] for p in problems] == [2]


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------

def _event_script(ev, seed):
    random.seed(seed)
    kept = []
    for i in range(200):
        outcome = "ok" if i % 9 else ("shed" if i % 2 else "deadline")
        r = ev.emit("token_request", outcome=outcome, dur_s=0.01 * (i % 7),
                    span_id="s%d" % i, trace_id="t",
                    reason="queue" if outcome == "shed" else None,
                    tokens=i)
        kept.append(None if r is None else
                    {k: v for k, v in r.items()
                     if k not in ("time", "provenance")})
    for i in range(80):        # a slow tail for the tail keeper
        r = ev.emit("train_step", dur_s=1.0 if i == 79 else 0.1,
                    span_id="t%d" % i, trace_id="t", steps=4)
        kept.append(None if r is None else r["span_id"])
    return kept, ev.stats()


def test_events_sampling_agrees_under_one_seed():
    out = []
    for ev in BOTH_EV:
        ev.enable(path="", sample=0.3)
        out.append(_event_script(ev, seed=1234))
        ev.enable(path="", sample=1.0)
    assert out[1][0] == out[0][0]
    assert out[1][1] == out[0][1]
    kept = [k for k in out[1][0] if k is not None]
    assert 0 < len(kept) < 280
    assert "t79" in kept                    # the slow tail is kept


def test_events_writer_and_provenance(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    tev.enable(path=path, sample=1.0)
    try:
        tev.emit("train_step", dur_s=0.1, steps=1)
        tev.flush()
    finally:
        tev.enable(path="", sample=1.0)
    recs = tev.read_events(path)
    events = recs[0] if isinstance(recs, tuple) else recs
    assert [e["kind"] for e in events] == ["train_step"]
    prov = events[0]["provenance"]
    assert jpl.validate_record(dict(
        jpl.make_record("m", 1.0, "u"), provenance=prov)) == []


# ---------------------------------------------------------------------------
# the slice: ShardedTrainer and TokenServer with the layer on
# ---------------------------------------------------------------------------

MLP_IN, MLP_HID, MLP_OUT, MLP_BATCH, MLP_STEPS = 8, 16, 4, 4, 3
SGD = {"learning_rate": 0.05, "momentum": 0.9}
# series the JAX trainer alone moves: its jit compiles the step (the
# jax.monitoring bridge and the persistent cache) where the port's
# trainer runs eagerly
JAX_ONLY = {"mxnet_tpu_compiles_total", "mxnet_tpu_compile_seconds",
            "mxnet_tpu_compile_cache_hits_total",
            "mxnet_tpu_compile_cache_misses_total"}
# series whose label value is a device name: each package names its own
DEVICE_LABELED = {"mxnet_tpu_train_state_bytes",
                  "mxnet_tpu_device_memory_bytes_in_use",
                  "mxnet_tpu_device_memory_peak_bytes"}


def _mlp(mx, nm):
    with nm():
        net = mx.gluon.nn.HybridSequential()
        net.add(mx.gluon.nn.Dense(MLP_HID, activation="relu",
                                  in_units=MLP_IN))
        net.add(mx.gluon.nn.Dense(MLP_OUT, in_units=MLP_HID))
    return net


def _mlp_data():
    rng = np.random.RandomState(0)
    xs = [rng.randn(MLP_BATCH, MLP_IN).astype(np.float32)
          for _ in range(MLP_STEPS)]
    ys = [rng.randint(0, MLP_OUT, MLP_BATCH).astype(np.float32)
          for _ in range(MLP_STEPS)]
    return xs, ys


def _trainers():
    jnet = _mlp(jmx, JNameManager)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(np.zeros((1, MLP_IN), np.float32)))
    weights = {n: p.data().asnumpy() for n, p in
               jnet.collect_params().items()}
    tnet = _mlp(tmx, TNameManager)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.convert.load_from_numpy(tnet, weights)
    out = []
    for mx, net, par in ((jmx, jnet, jparallel), (tmx, tnet, tparallel)):
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        out.append(par.ShardedTrainer(net, lambda o, l, f=loss: f(o, l),
                                      optimizer="sgd",
                                      optimizer_params=dict(SGD)))
    return out


def _moved(before, after):
    """{(name, label names, label values)} of every series whose value,
    count or sum changed (or that appeared)."""
    def series(snap):
        out = {}
        for name, m in snap.items():
            for s in m.get("series", []):
                labels = tuple(sorted(s.get("labels", {}).items()))
                out[name, labels] = {k: v for k, v in s.items()
                                     if k != "labels"}
        return out
    a, b = series(before), series(after)
    return {k for k in b if b[k] != a.get(k)}


def _normalize(moved):
    out = set()
    for name, labels in moved:
        if name in JAX_ONLY:
            continue
        if name in DEVICE_LABELED:
            labels = tuple((k, "<device>") for k, _ in labels)
        out.add((name, labels))
    return out


def test_trainer_moves_the_same_series():
    jtr_, ttr_ = _trainers()
    xs, ys = _mlp_data()
    moved, steps, losses = [], [], []
    for tel, tr, mx, pack in ((jtel, jtr_, jmx, jtr), (ttel, ttr_, tmx, ttr)):
        tel.enable()
        pack.enable()
        tel.reset()
        # the JAX package would otherwise take a TPU's peak from
        # docs/mfu_probe.json, which the port never reads
        tel.set_peak_flops(1e12)
        before = tel.collect()
        ctx = {} if mx is jmx else {"ctx": tmx.cpu()}
        losses.append([float(tr.step([mx.nd.array(x, **ctx)],
                                     mx.nd.array(y, **ctx)))
                       for x, y in zip(xs, ys)])
        tr.drain()
        moved.append(_normalize(_moved(before, tel.collect())))
        steps.append(tel.TRAIN_STEPS.value(loop="sharded"))
        payload = pack.chrome_trace_payload(include_profiler=False)
        names = {e["name"] for e in payload["traceEvents"]
                 if e.get("cat") == "span"}
        assert {"ShardedTrainer.step", "step:dispatch",
                "step:fetch"} <= names
        tel.set_peak_flops(None)
    assert moved[1] == moved[0]
    assert steps[1] == steps[0] == MLP_STEPS
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    assert ttel.TRAIN_LOSS.value() == pytest.approx(losses[1][-1],
                                                    rel=1e-6)
    bd = ttr_.step_breakdown()
    assert bd.steps == MLP_STEPS
    assert math.isclose(sum(bd.buckets().values()), bd.span_s + bd.gap_s,
                        rel_tol=1e-9)
    assert ttel.TRAIN_STEP_FLOPS.value() > 0   # the one FLOP count


def test_trainer_mfu_needs_a_peak(monkeypatch):
    monkeypatch.delenv("MXNET_PEAK_TFLOPS", raising=False)
    _, tr = _trainers()
    xs, ys = _mlp_data()
    ttel.enable()
    ttel.set_peak_flops(None)
    tr.step([tmx.nd.array(xs[0], ctx=tmx.cpu())],
            tmx.nd.array(ys[0], ctx=tmx.cpu()))
    assert ttel.TRAIN_MFU.value() == 0.0
    ttel.set_peak_flops(1e12)
    try:
        tr.step([tmx.nd.array(xs[1], ctx=tmx.cpu())],
                tmx.nd.array(ys[1], ctx=tmx.cpu()))
        assert ttel.TRAIN_MFU.value() > 0.0
    finally:
        ttel.set_peak_flops(None)


def test_trainer_step_many_and_goodput(tmp_path, monkeypatch):
    from mxnet_tpu_torch import goodput as tgp

    monkeypatch.setenv("MXNET_GOODPUT_DIR", str(tmp_path / "gp"))
    _, tr = _trainers()
    tr.configure_overlap(async_metrics=True, steps_per_call=3)
    xs, ys = _mlp_data()
    ttel.enable()
    tev.enable(path="", sample=1.0)
    try:
        # the recorder begins where the JAX trainer's does, at attach
        assert tr.attach_checkpoint_manager(
            tmx.CheckpointManager(tmp_path / "ckpt", async_save=False),
            install_signal_handler=False) == 0
        tr.step_many([([tmx.nd.array(x, ctx=tmx.cpu())],
                       tmx.nd.array(y, ctx=tmx.cpu()))
                      for x, y in zip(xs, ys)])
        tr.close()
        assert ttel.TRAIN_STEPS.value(loop="sharded") == 3
        assert [e["kind"] for e in tev.recent()] == ["train_step"]
        assert tev.recent()[0]["steps"] == 3
        assert tgp.active()
        tgp.note_exit("clean", step=tr.global_step)
        rep = tgp.goodputz(dir=str(tmp_path / "gp"))
        assert rep["active"]
        assert rep["buckets_s"]["goodput"] > 0
    finally:
        rec = tgp._recorder
        if rec is not None:
            rec.end("clean")
        tgp.set_dir(None)


def test_trainer_crash_writes_one_bundle(tmp_path):
    _, tr = _trainers()
    ttr.enable_flight_recorder(str(tmp_path))
    ttr.rearm_flight_recorder()
    try:
        with pytest.raises(Exception):
            tr.step([tmx.nd.array(np.zeros((2, 3), np.float32),
                                  ctx=tmx.cpu())],
                    tmx.nd.array(np.zeros(2, np.float32), ctx=tmx.cpu()))
    finally:
        ttr.disable_flight_recorder()
    bundles = [d for d in os.listdir(tmp_path) if d.startswith("flight-")]
    assert len(bundles) == 1 and "exception-step" in bundles[0]


def test_layer_off_moves_nothing():
    _, tr = _trainers()
    xs, ys = _mlp_data()
    before = ttel.collect()
    tr.step([tmx.nd.array(xs[0], ctx=tmx.cpu())],
            tmx.nd.array(ys[0], ctx=tmx.cpu()))
    tr.close()
    assert ttel.collect() == before
    assert tev.recent() == []
    assert [e for e in ttr.chrome_trace_payload(
        include_profiler=False)["traceEvents"] if e.get("cat") == "span"] \
        == []


VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN = 48, 32, 2, 2, 24
LM_CFG = dict(vocab_size=VOCAB, d_model=D_MODEL, n_heads=N_HEADS,
              n_layers=N_LAYERS, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def lm_engines():
    with jax.default_matmul_precision("float32"):
        jmx.random.seed(0)
        with jmx.name.NameManager():
            jnet = jlm.TransformerLM(**LM_CFG)
        jnet.initialize(jmx.init.Xavier())
        jnet(jmx.nd.array(np.zeros((1, 4), np.float32)))
        jeng = jgen.GenerationEngine(
            jnet, sampling=jgen.SamplingConfig(greedy=True), slots=3,
            cache_len=MAX_LEN, buckets=[8, MAX_LEN])
    weights = {n: p.data().asnumpy()
               for n, p in jnet.collect_params().items()}
    with TNameManager():
        tnet = tlm.TransformerLM(**LM_CFG)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.convert.load_from_numpy(tnet, weights)
    teng = tgen.GenerationEngine(
        tnet, sampling=tgen.SamplingConfig(greedy=True), device=tmx.cpu(),
        slots=3, cache_len=MAX_LEN, buckets=[8, MAX_LEN])
    return jeng, teng


def _prompts():
    return [np.random.RandomState(s).randint(0, VOCAB, 5).astype(np.int32)
            for s in range(4)]


def _serve(gen, eng, tel, ev, tr):
    tel.enable()
    ev.enable(path="", sample=1.0)
    tr.enable()
    srv = gen.TokenServer(eng, queue_depth=8, max_new_tokens=6)
    try:
        toks = [srv.generate(p, timeout=120).tokens for p in _prompts()]
    finally:
        srv.close()
    events = [(e["kind"], e["outcome"], e.get("reason"), e["tokens"],
               sorted(e["stages_s"])) for e in ev.recent()]
    spans = [e for e in tr.chrome_trace_payload(
        include_profiler=False)["traceEvents"]
        if e.get("name") == "decode.request"]
    return (toks, sorted(events), tel.DECODE_TOKENS.value(),
            tel.DECODE_REQUESTS_FINISHED.value(reason="length"), len(spans))


def test_token_server_events_and_tokens_match_jax(lm_engines):
    jeng, teng = lm_engines
    with jax.default_matmul_precision("float32"):
        want = _serve(jgen, jeng, jtel, jev, jtr)
    torch.set_float32_matmul_precision("highest")
    got = _serve(tgen, teng, ttel, tev, ttr)
    assert got == want
    assert got[2] == 4 * 6 - 4      # first tokens come from the prefill
    assert [e[1] for e in got[1]] == ["ok"] * 4
    assert got[4] == 4
    st = ttel.statusz()["subsystems"]["decode"]
    assert st["tokens_total"] == got[2]
