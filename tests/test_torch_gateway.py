"""The port's HTTP serving gateway on the CPU (stdlib HTTP client only).

tests/test_gateway.py's cases on the port (the wire contract and its
parity with the docs/lm_serving.md table, predict and SSE round trips,
deadline and trace-id headers, wire hygiene, quotas and weighted fair
queueing, deploy/rollback/canary over a stand-in AOT manifest, drain-
first close, readiness deregistration, SIGTERM, /statusz, the heartbeat
line, events_query --by tenant) and tests/test_gateway_chaos.py's on a
real TokenServer over a tiny port LM with the port's testing.faults
wire injectors; then the same fake backends behind the JAX gateway and
the port's give equal status codes, Retry-After headers, JSON bodies and
SSE frames, and wire_code is equal over the whole error taxonomy.
Waits are on events or polled conditions with a timeout; the server
fixtures take their port from a listener already bound (port 0).
"""
import http.client
import json
import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu.events as jevents
import mxnet_tpu.gateway as jgateway
import mxnet_tpu.serving_async as jserving_async
import mxnet_tpu.telemetry as jtel
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import events
from mxnet_tpu_torch import gateway as gwmod
from mxnet_tpu_torch import generate
from mxnet_tpu_torch import serving_async as tserving_async
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.examples.transformer_lm import TransformerLM
from mxnet_tpu_torch.gateway import (CONTRACT, FairQueue, Gateway,
                                     TokenBucket, wire_code)
from mxnet_tpu_torch.serving_async import (Cancelled, DeadlineExceeded,
                                           Overloaded)
from mxnet_tpu_torch.testing import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


@pytest.fixture
def registry():
    tel.enable()
    tel.reset()
    events.enable(path="", sample=1.0)
    events.reset()
    yield tel
    events.reset()
    events.disable()
    tel.reset()
    tel.disable()


# ---------------------------------------------------------------------------
# fake backends (serving submit protocol, no device work)
# ---------------------------------------------------------------------------

class _Fut:
    """Minimal ServingFuture stand-in: threadsafe, first-writer-wins."""

    def __init__(self):
        self._ev = threading.Event()
        self._res = None
        self._exc = None
        self.cancelled_flag = False

    def _set(self, res=None, exc=None):
        if self._ev.is_set():
            return False
        self._res, self._exc = res, exc
        self._ev.set()
        return True

    def done(self):
        return self._ev.is_set()

    def cancel(self):
        self.cancelled_flag = True
        return self._set(exc=Cancelled("cancelled"))

    def result(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError("unresolved")
        if self._exc is not None:
            raise self._exc
        return self._res


class FakePredict:
    """AsyncPredictor stand-in: doubles the batch.  ``hold`` (an Event)
    delays resolution until set; ``admit_exc`` raises at submit;
    ``submitted`` is set once a request reached it."""

    def __init__(self, scale=2.0, hold=None, admit_exc=None,
                 canary_ok=True, tag=None):
        self.scale = scale
        self.hold = hold
        self.admit_exc = admit_exc
        self.canary_ok = canary_ok
        self.tag = tag
        self.submits = 0
        self.submitted = threading.Event()

    def submit(self, batch, deadline_ms=None):
        self.submits += 1
        self.submitted.set()
        if self.admit_exc is not None:
            raise self.admit_exc
        fut = _Fut()
        out = (np.asarray(batch) * self.scale)

        def run():
            if self.hold is not None:
                self.hold.wait(10)
            fut._set(res=out)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def canary(self):
        return self.canary_ok


class FakeTokenServer:
    """TokenServer stand-in: streams ``tokens`` through on_token then
    resolves.  ``admit_exc`` fails submit typed; ``final_exc`` resolves
    the future with a typed failure after streaming; ``hold`` stalls
    resolution (the stuck-backend scenario)."""

    def __init__(self, tokens=(7, 8, 9), delay=0.0, admit_exc=None,
                 final_exc=None, hold=None):
        self.tokens = list(tokens)
        self.delay = delay
        self.admit_exc = admit_exc
        self.final_exc = final_exc
        self.hold = hold
        self.cancelled = threading.Event()

    def submit(self, token_ids, deadline_ms=None, max_new_tokens=None,
               on_token=None):
        if self.admit_exc is not None:
            raise self.admit_exc
        fut = _Fut()

        def run():
            for t in self.tokens:
                if self.delay:
                    time.sleep(self.delay)
                if fut.done():          # cancelled mid-stream
                    self.cancelled.set()
                    return
                if on_token is not None:
                    on_token(t)
            if self.hold is not None:
                if not self.hold.wait(10):
                    return
            if self.final_exc is not None:
                fut._set(exc=self.final_exc)
            else:
                fut._set(res={"tokens": list(self.tokens),
                              "finish_reason": "length",
                              "ttft_s": 0.001})

        threading.Thread(target=run, daemon=True).start()
        return fut


# ---------------------------------------------------------------------------
# HTTP helpers (stdlib only)
# ---------------------------------------------------------------------------

def _post(port, path, body, headers=None, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    payload = json.dumps(body) if isinstance(body, dict) else body
    hdrs = {"Content-Type": "application/json",
            "Content-Length": str(len(payload))}
    hdrs.update(headers or {})
    conn.request("POST", path, body=payload, headers=hdrs)
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, dict(resp.getheaders()), data)
    conn.close()
    return out


def _get(port, path, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    out = (resp.status, data)
    conn.close()
    return out


def _wait(pred, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError("timed out waiting for %s" % msg)


def _sse_frames(raw):
    """data: payloads of an SSE byte stream, parsed."""
    return [json.loads(part[len(b"data: "):])
            for part in raw.split(b"\n\n")
            if part.startswith(b"data: ")]


def _gw_events(n=None):
    """The gateway's wide events.  A handler files its request's event
    in do_POST's finally, after the answer is on the wire, so under load
    a client can read the answer before the event exists: with ``n``,
    wait (bounded) until ``n`` events are there."""
    def evs():
        return [e for e in events.recent()
                if e["kind"] == "gateway_request"]

    if n is not None:
        _wait(lambda: len(evs()) >= n, msg="%d gateway wide events" % n)
    return evs()


# ---------------------------------------------------------------------------
# the wire contract
# ---------------------------------------------------------------------------

def test_contract_parity_with_docs():
    """The docs/lm_serving.md HTTP table IS the gateway map — parsed
    row-for-row, asserted both directions (the drift guard the issue
    names)."""
    path = os.path.join(REPO, "docs", "lm_serving.md")
    with open(path) as f:
        text = f.read()
    rows = re.findall(
        r"^\|[^|]+\| `(Overloaded|DeadlineExceeded|Cancelled)"
        r"(?:\((reason|stage)=([^)]*)\))?` \| (\d{3}) \|",
        text, re.M)
    assert rows, "HTTP contract table not found in docs/lm_serving.md"
    doc_map = {}
    for typ, _, qual, code in rows:
        quals = [q.strip().strip('"') for q in qual.split("/")] \
            if qual else [None]
        for q in quals:
            doc_map[(typ, q)] = int(code)
    assert doc_map == CONTRACT


def test_wire_code_covers_the_whole_taxonomy():
    assert wire_code(Overloaded("queue", "x")) == 429
    assert wire_code(Overloaded("slots", "x")) == 429
    assert wire_code(Overloaded("slo", "x")) == 429
    assert wire_code(Overloaded("shutdown", "x")) == 503
    # degraded fallbacks for taxonomy members off the table
    assert wire_code(Overloaded("inflight", "x")) == 429
    assert wire_code(DeadlineExceeded("prefill", "x")) == 504
    assert wire_code(DeadlineExceeded("decode", "x")) == 504
    assert wire_code(DeadlineExceeded("pickup", "x")) == 504
    assert wire_code(Cancelled("x")) == 499
    assert wire_code(ValueError("x")) == 500


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

def test_predict_roundtrip(registry):
    with Gateway(port=0) as gw:
        gw.add_route("m", FakePredict(scale=3.0), version=None,
                     kind="predict")
        status, headers, body = _post(gw.port, "/v1/predict/m",
                                      {"rows": [[1.0, 2.0]]})
        assert status == 200
        out = json.loads(body)
        assert out["outputs"] == [[3.0, 6.0]]
    # exactly one wide event, outcome ok, wire code carried
    evs = _gw_events(1)
    assert len(evs) == 1
    assert evs[0]["outcome"] == "ok" and evs[0]["http_status"] == 200
    assert evs[0]["model"] == "m" and evs[0]["op"] == "predict"


def test_generate_sse_stream(registry):
    with Gateway(port=0) as gw:
        gw.add_route("lm", FakeTokenServer(tokens=(4, 5, 6)))
        status, headers, body = _post(gw.port, "/v1/generate/lm",
                                      {"tokens": [1, 2]})
        assert status == 200
        assert headers.get("Content-Type") == "text/event-stream"
        frames = _sse_frames(body)
        assert [f["token"] for f in frames[:-1]] == [4, 5, 6]
        assert frames[-1]["done"] is True
        assert frames[-1]["finish_reason"] == "length"
    evs = _gw_events(1)
    assert len(evs) == 1 and evs[0]["tokens"] == 3
    assert tel.GATEWAY_STREAM_TOKENS.value() == 3


def test_trace_id_and_tenant_ride_the_event(registry):
    with Gateway(port=0) as gw:
        gw.add_route("m", FakePredict(), kind="predict")
        _post(gw.port, "/v1/predict/m", {"rows": [[1.0]]},
              headers={"X-Trace-Id": "trace-abc", "X-Tenant": "acme"})
    (ev,) = _gw_events(1)
    assert ev["trace_id"] == "trace-abc"
    assert ev["tenant"] == "acme"


def test_typed_backend_errors_map_to_wire(registry):
    with Gateway(port=0) as gw:
        gw.add_route("full", FakeTokenServer(
            admit_exc=Overloaded("queue", "full")))
        gw.add_route("closed", FakeTokenServer(
            admit_exc=Overloaded("shutdown", "closing")))
        gw.add_route("late", FakeTokenServer(
            tokens=(), final_exc=DeadlineExceeded("prefill", "late")))
        status, headers, _ = _post(gw.port, "/v1/generate/full",
                                   {"tokens": [1]})
        assert status == 429 and "Retry-After" in headers
        status, headers, _ = _post(gw.port, "/v1/generate/closed",
                                   {"tokens": [1]})
        assert status == 503
        status, _, _ = _post(gw.port, "/v1/generate/late",
                             {"tokens": [1]})
        assert status == 504
    codes = {e["http_status"] for e in _gw_events(3)}
    assert codes == {429, 503, 504}


def test_midstream_failure_carries_code_in_sse_frame(registry):
    """After the 200 is on the wire, a typed failure arrives as a final
    SSE error frame with the contracted code (and the event carries
    it)."""
    with Gateway(port=0) as gw:
        gw.add_route("lm", FakeTokenServer(
            tokens=(1, 2), final_exc=DeadlineExceeded("decode", "mid")))
        status, _, body = _post(gw.port, "/v1/generate/lm",
                                {"tokens": [1]})
        assert status == 200               # already streaming
        frames = _sse_frames(body)
        assert frames[-1]["error"]["code"] == 504
    (ev,) = _gw_events(1)
    assert ev["http_status"] == 504 and ev["outcome"] == "deadline"


def test_deadline_header_threads_into_admission(registry):
    """X-Deadline-Ms reaches the backend's own clock: a backend holding
    past the deadline is cancelled and answered 504."""
    with Gateway(port=0) as gw:
        hold = threading.Event()           # never set: stalled backend
        gw.add_route("slow", FakeTokenServer(tokens=(), hold=hold))
        t0 = time.monotonic()
        status, _, _ = _post(gw.port, "/v1/generate/slow",
                             {"tokens": [1]},
                             headers={"X-Deadline-Ms": "150"})
        assert status == 504
        assert time.monotonic() - t0 < 5.0
        hold.set()
    (ev,) = _gw_events(1)
    assert ev["outcome"] == "deadline" and ev["http_status"] == 504


def test_wire_hygiene_404_400_413(registry):
    with Gateway(port=0, max_body=256) as gw:
        gw.add_route("m", FakePredict(), kind="predict")
        assert _post(gw.port, "/v1/predict/ghost",
                     {"rows": [[1.0]]})[0] == 404
        assert _post(gw.port, "/nope", {"x": 1})[0] == 404
        assert _post(gw.port, "/v1/predict/m", "{not json")[0] == 400
        assert _post(gw.port, "/v1/predict/m", {"rows": [[1.0]]},
                     headers={"X-Deadline-Ms": "soon"})[0] == 400
        big = json.dumps({"rows": [[0.0] * 500]})
        assert _post(gw.port, "/v1/predict/m", big)[0] == 413
        assert tel.GATEWAY_BAD_REQUESTS.value(kind="oversized") == 1
    # one event per request, even the refused ones
    assert len(_gw_events(5)) == 5


def test_contract_rows_serve_a_uint8_predictor(registry):
    """The predict route parses rows as f32: a uint8-contract
    AsyncPredictor answers through ContractRows with the direct
    predictor's result, and a row that does not fit uint8 fails."""
    from mxnet_tpu_torch.serving import Predictor
    from mxnet_tpu_torch.serving_async import AsyncPredictor, ContractRows

    pred = Predictor(lambda x, p: x.to(torch.float32) * 2.0, [], chain=2,
                     batch_shape=(4, 3), batch_dtype=np.uint8,
                     device=tmx.cpu())
    batch = np.array([[0, 7, 255], [1, 2, 3]], np.uint8)
    want = list(pred.predict([batch]))[0]
    ap = AsyncPredictor([pred], batch_window_ms=5.0, sweep_interval_s=10.0)
    try:
        with Gateway(port=0) as gw:
            gw.add_route("raw", ap, kind="predict")
            gw.add_route("img", ContractRows(ap), kind="predict")
            rows = batch.tolist()
            assert _post(gw.port, "/v1/predict/raw", {"rows": rows})[0] \
                == 500
            status, _h, body = _post(gw.port, "/v1/predict/img",
                                     {"rows": rows})
            assert status == 200
            assert np.array_equal(np.asarray(json.loads(body)["outputs"]),
                                  want)
            for bad in ([[0, 1, 256]], [[0, 1, 1.5]], [[-1, 0, 0]]):
                assert _post(gw.port, "/v1/predict/img",
                             {"rows": bad})[0] == 500
        assert ContractRows(ap).canary() is True
    finally:
        ap.close()
    # a bf16 contract (numpy has no bf16): the rows go as a tensor
    pred16 = Predictor(lambda x, p: x.to(torch.float32) * 2.0, [], chain=1,
                       batch_shape=(4, 3), batch_dtype=torch.bfloat16,
                       device=tmx.cpu())
    ap16 = AsyncPredictor([pred16], batch_window_ms=5.0,
                          sweep_interval_s=10.0)
    try:
        got = ContractRows(ap16).submit([[1.5, 2.0, 3.0]]).result(10)
        assert np.array_equal(got, [[3.0, 4.0, 6.0]])
    finally:
        ap16.close()


# ---------------------------------------------------------------------------
# tenancy: quotas + weighted fair queueing
# ---------------------------------------------------------------------------

def test_token_bucket_refill_math():
    b = TokenBucket(rate=10.0, burst=2)
    assert b.take() == (True, 0.0)
    assert b.take()[0] is True
    ok, retry = b.take()
    assert ok is False and 0.0 < retry <= 0.11
    with b._lock:
        b._t -= 0.12                       # 0.12 s of refill, no sleep
    assert b.take()[0] is True             # refilled ~1 token


def test_quota_429_with_retry_after(registry):
    with Gateway(port=0, quota_qps=0.5, quota_burst=1) as gw:
        gw.add_route("m", FakePredict(), kind="predict")
        assert _post(gw.port, "/v1/predict/m",
                     {"rows": [[1.0]]})[0] == 200
        status, headers, _ = _post(gw.port, "/v1/predict/m",
                                   {"rows": [[1.0]]})
        assert status == 429
        assert int(headers["Retry-After"]) >= 1
        # another tenant has its own bucket
        assert _post(gw.port, "/v1/predict/m", {"rows": [[1.0]]},
                     headers={"X-Tenant": "other"})[0] == 200
    assert tel.GATEWAY_QUOTA_SHED.value(tenant="default") == 1


def test_fair_queue_weighted_grant_order():
    """With the single permit held, tenant A (weight 4) and tenant B
    (weight 1) each queue 3 waiters: virtual finish times are A
    .25/.5/.75 vs B 1/2/3, so every release grants all of A first —
    weighted max-min, deterministic."""
    fq = FairQueue(permits=1, depth=8, weights={"a": 4.0, "b": 1.0})
    fq.acquire("holder")                   # pin the permit
    order = []

    def waiter(tenant):
        fq.acquire(tenant)
        order.append(tenant)
        fq.release()

    threads = []
    for i, tenant in enumerate(["a", "a", "a", "b", "b", "b"]):
        t = threading.Thread(target=waiter, args=(tenant,), daemon=True)
        t.start()
        threads.append(t)
        # deterministic enqueue order: each waiter queued before the next
        _wait(lambda: sum(fq.depths().values()) == i + 1,
              msg="waiter %d to queue" % i)
    assert fq.depths() == {"a": 3, "b": 3}
    fq.release()                           # the chain self-propagates
    for t in threads:
        t.join(5)
    assert order == ["a", "a", "a", "b", "b", "b"]


def test_fair_queue_typed_rejections():
    fq = FairQueue(permits=1, depth=1)
    fq.acquire("t")

    def quiet_acquire():
        try:
            fq.acquire("t")
        except Overloaded:
            pass                           # the close() below frees it

    threading.Thread(target=quiet_acquire, daemon=True).start()
    _wait(lambda: fq.depths() == {"t": 1}, msg="one waiter queued")
    with pytest.raises(Overloaded) as ei:
        fq.acquire("t")
    assert ei.value.reason == "queue"
    with pytest.raises(DeadlineExceeded) as ei:
        fq.acquire("u", deadline=time.monotonic() + 0.05)
    assert ei.value.stage == "queue"
    fq.close()
    with pytest.raises(Overloaded) as ei:
        fq.acquire("v")
    assert ei.value.reason == "shutdown"


def test_hot_tenant_sheds_429_over_http(registry):
    """concurrency 1 + tenant depth 1: the third concurrent request
    from one tenant sheds Overloaded('queue') -> 429 while the first
    two complete."""
    hold = threading.Event()
    with Gateway(port=0, concurrency=1, queue_depth=1) as gw:
        gw.add_route("m", FakePredict(hold=hold), kind="predict")
        results = []

        def fire():
            results.append(_post(gw.port, "/v1/predict/m",
                                 {"rows": [[1.0]]})[0])

        backend = gw._routes["m"].backend
        threads = [threading.Thread(target=fire, daemon=True)
                   for _ in range(3)]
        threads[0].start()                 # occupies the one permit
        assert backend.submitted.wait(10)
        threads[1].start()                 # queues behind it
        _wait(lambda: gw._wfq.depths() == {"default": 1}, msg="queued")
        threads[2].start()                 # over the tenant's depth
        _wait(lambda: len(results) == 1, msg="the shed answer")
        hold.set()
        for t in threads:
            t.join(10)
        assert sorted(results) == [200, 200, 429]
    assert len(_gw_events(3)) == 3


# ---------------------------------------------------------------------------
# deploy / rollback / canary over the AOT manifest
# ---------------------------------------------------------------------------

class ManifestStore:
    """Stand-in for the AOT store (not ported yet): the gateway reads a
    store only through ``manifest_entries()`` -> (entries, torn)."""

    def __init__(self, entries):
        self._entries = list(entries)

    def manifest_entries(self):
        return list(self._entries), 0


@pytest.fixture
def store():
    return ManifestStore([{"key": "v1", "spec": "tiny@1"},
                          {"key": "v2", "spec": "tiny@2"}])


def test_deploy_rollback_canary_end_to_end(registry, store):
    """The full deploy story: two manifest versions, canary-probed
    flip, deterministic canary split, rollback — and an in-flight
    request survives the flip on its original backend."""
    a = FakePredict(scale=1.0, tag="a")
    b = FakePredict(scale=10.0, tag="b")
    hold = threading.Event()
    slow_a = FakePredict(scale=1.0, hold=hold)
    with Gateway(port=0, store=store) as gw:
        # a route version must exist in the manifest
        with pytest.raises(ValueError):
            gw.add_route("m", a, version="ghost", kind="predict")
        gw.add_route("m", slow_a, version="v1", kind="predict")

        # launch an in-flight request against v1, then flip mid-flight
        inflight = {}

        def fire():
            inflight["resp"] = _post(gw.port, "/v1/predict/m",
                                     {"rows": [[2.0]]})

        t = threading.Thread(target=fire, daemon=True)
        t.start()
        assert slow_a.submitted.wait(10)

        # deploy validates the version and canary-probes the backend
        with pytest.raises(ValueError):
            gw.deploy("m", b, version="v3")
        with pytest.raises(RuntimeError):
            gw.deploy("m", FakePredict(canary_ok=False), version="v2")
        assert gw.routes()["m"]["version"] == "v1"   # untouched
        gw.deploy("m", b, version="v2")
        assert gw.routes()["m"]["version"] == "v2"

        # the in-flight request finishes on the old backend: no drop
        hold.set()
        t.join(10)
        status, _, body = inflight["resp"]
        assert status == 200
        assert json.loads(body) == {"outputs": [[2.0]], "version": "v1"}

        # new traffic rides v2
        _, _, body = _post(gw.port, "/v1/predict/m", {"rows": [[1.0]]})
        assert json.loads(body) == {"outputs": [[10.0]], "version": "v2"}

        # canary: deterministic 50% split alternates versions
        gw.set_canary("m", a, version="v1", weight=0.5)
        seen = []
        for _ in range(4):
            _, _, body = _post(gw.port, "/v1/predict/m",
                               {"rows": [[1.0]]})
            seen.append(json.loads(body)["version"])
        assert sorted(seen) == ["v1", "v1", "v2", "v2"]
        gw.clear_canary("m")

        # rollback flips back atomically
        gw.rollback("m")
        assert gw.routes()["m"]["version"] == "v1"
        _, _, body = _post(gw.port, "/v1/predict/m", {"rows": [[4.0]]})
        assert json.loads(body)["version"] == "v1"

        assert tel.GATEWAY_ROUTE_FLIPS.value(op="deploy") == 1
        assert tel.GATEWAY_ROUTE_FLIPS.value(op="rollback") == 1
        assert tel.GATEWAY_ROUTE_FLIPS.value(op="canary") == 1


# ---------------------------------------------------------------------------
# lifecycle: drain-first close, readiness deregistration, SIGTERM
# ---------------------------------------------------------------------------

def test_healthz_flips_503_before_listener_stops(registry):
    hold = threading.Event()
    gw = Gateway(port=0, concurrency=2)
    backend = FakePredict(hold=hold)
    gw.add_route("m", backend, kind="predict")
    inflight = {}

    def fire():
        inflight["resp"] = _post(gw.port, "/v1/predict/m",
                                 {"rows": [[1.0]]})

    t = threading.Thread(target=fire, daemon=True)
    t.start()
    assert backend.submitted.wait(10)
    closer = threading.Thread(target=gw.close,
                              kwargs={"drain": True, "timeout": 10},
                              daemon=True)
    closer.start()
    _wait(lambda: not gw.is_ready(), msg="the drain to start")
    # draining: probes see 503 and new work sheds typed, but the
    # listener still answers (connection-refused-free)
    status, body = _get(gw.port, "/healthz")
    assert status == 503
    assert "gateway" in json.loads(body)["failing"]
    assert _post(gw.port, "/v1/predict/m", {"rows": [[1.0]]})[0] == 503
    # the open stream finishes; close completes
    hold.set()
    t.join(10)
    closer.join(10)
    assert inflight["resp"][0] == 200
    # deregistered: readiness is clean again for a successor
    ready, _ = tel.readiness()
    assert ready


def test_closed_mid_request_deregisters_readiness(registry):
    """The regression the issue names: a gateway torn down with a
    request still open must deregister its readiness check like a
    closed AsyncPredictor — no stale 503 for the next process."""
    hold = threading.Event()
    gw = Gateway(port=0)
    backend = FakePredict(hold=hold)
    gw.add_route("m", backend, kind="predict")
    threading.Thread(
        target=lambda: _post(gw.port, "/v1/predict/m",
                             {"rows": [[1.0]]}),
        daemon=True).start()
    assert backend.submitted.wait(10)
    with gw._open_cond:
        assert gw._open_streams == 1
    # close with a drain budget too small for the stuck stream
    gw.close(drain=True, timeout=0.2)
    assert gw._closed
    ready, checks = tel.readiness()
    assert ready, "stale gateway readiness check survived close(): %r" \
        % (checks,)
    # a successor gateway starts clean and serves
    with Gateway(port=0) as gw2:
        gw2.add_route("m", FakePredict(), kind="predict")
        assert _post(gw2.port, "/v1/predict/m",
                     {"rows": [[1.0]]})[0] == 200
        assert _get(gw2.port, "/healthz")[0] == 200
    hold.set()


def test_sigterm_drains(registry):
    import signal

    gw = Gateway(port=0)
    gw.add_route("m", FakePredict(), kind="predict")
    prev = gw.install_signal_handler()
    try:
        assert _get(gw.port, "/healthz")[0] == 200
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 10
        ready = False
        while time.monotonic() < deadline:
            ready = gw._closed and tel.readiness()[0]
            if ready:
                break
            time.sleep(0.02)
        assert gw._closed
        assert ready, "gateway still holding readiness after SIGTERM"
    finally:
        signal.signal(signal.SIGTERM, prev)


# ---------------------------------------------------------------------------
# observability: statusz subsystem, heartbeat, scrape routes
# ---------------------------------------------------------------------------

def test_statusz_gateway_subsystem_and_scrape_routes(registry):
    with Gateway(port=0) as gw:
        gw.add_route("m", FakePredict(), version=None, kind="predict")
        _post(gw.port, "/v1/predict/m", {"rows": [[1.0]]},
              headers={"X-Tenant": "acme"})
        status, body = _get(gw.port, "/statusz")
        assert status == 200
        sub = json.loads(body)["subsystems"]["gateway"]
        assert sub["responses"].get("200") == 1
        assert sub["requests"].get("acme") == 1
        assert sub["open_streams"] == 0
        (gview,) = sub["gateways"]
        assert gview["routes"]["m"]["kind"] == "predict"
        # the same listener serves the scrape surface
        status, body = _get(gw.port, "/metrics")
        assert status == 200
        assert b"mxnet_tpu_gateway_responses_total" in body
        assert _get(gw.port, "/varz")[0] == 200
        status, body = _get(gw.port, "/requestz")
        assert status == 200
        assert json.loads(body)["stats"]["emitted"] >= 1


def test_heartbeat_line_gains_gateway_section(registry):
    from mxnet_tpu_torch.monitor import TelemetryHeartbeat

    line = TelemetryHeartbeat().line()
    assert "gw_streams" not in line        # silent before traffic
    with Gateway(port=0) as gw:
        gw.add_route("m", FakePredict(), kind="predict")
        _post(gw.port, "/v1/predict/m", {"rows": [[1.0]]})
        _post(gw.port, "/v1/predict/ghost", {"rows": [[1.0]]})
    tel.GATEWAY_RESPONSES.inc(code="429")  # one shed for the rate
    line = TelemetryHeartbeat().line()
    assert "gw_streams 0" in line
    assert "gw_shed 33%" in line


# ---------------------------------------------------------------------------
# satellite: the repo's events_query --by tenant over the port's events
# ---------------------------------------------------------------------------

def test_events_query_by_tenant(registry, tmp_path, capsys):
    path = str(tmp_path / "events.jsonl")
    events.enable(path=path, sample=1.0)
    with Gateway(port=0) as gw:
        gw.add_route("m", FakePredict(), kind="predict")
        for tenant in ("acme", "acme", "globex"):
            _post(gw.port, "/v1/predict/m", {"rows": [[1.0]]},
                  headers={"X-Tenant": tenant})
    events.flush()
    sys.path.insert(0, TOOLS)
    try:
        import importlib

        import events_query

        importlib.reload(events_query)
        rc = events_query.main([path, "--kind", "gateway_request",
                                "--by", "tenant"])
    finally:
        sys.path.remove(TOOLS)
    assert rc == 0
    out = capsys.readouterr().out
    assert "acme" in out and "globex" in out

# ---------------------------------------------------------------------------
# review regressions: permit hygiene, SSE wire integrity, tenant bounds
# ---------------------------------------------------------------------------

class _BuggyBackend:
    """Backend whose submit raises an UNTYPED error — the handler-bug
    path (500) that historically leaked the WFQ dispatch permit."""

    def submit(self, batch, deadline_ms=None, **kwargs):
        raise RuntimeError("backend bug")


def test_wfq_permit_survives_handler_exceptions(registry):
    """A permit acquired before an exception escaping the handler must
    be released on every exit — with concurrency 2, more-than-2 buggy
    requests would otherwise deadlock dispatch for all tenants."""
    with Gateway(port=0, concurrency=2, queue_depth=4) as gw:
        gw.add_route("bad", _BuggyBackend(), kind="predict")
        hdrs = {"X-Deadline-Ms": "2000"}   # bound a regression's hang
        for _ in range(5):                 # > 2x the permit pool
            status, _, _ = _post(gw.port, "/v1/predict/bad",
                                 {"rows": [[1.0]]}, headers=hdrs)
            assert status == 500
        gw.add_route("ok", FakePredict(scale=2.0), kind="predict")
        status, _, body = _post(gw.port, "/v1/predict/ok",
                                {"rows": [[2.0]]}, headers=hdrs)
        assert status == 200               # permits all came back
        assert json.loads(body)["outputs"] == [[4.0]]
        # the last release lands in the handler's finally, just after
        # the response hits the wire — poll briefly
        deadline = time.monotonic() + 2.0
        while gw._wfq._free != gw._wfq.permits and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert gw._wfq._free == gw._wfq.permits


def test_bad_max_new_tokens_is_400_and_leaks_nothing(registry):
    """A junk max_new_tokens is the client's 400 (not an uncaught 500)
    and the dispatch permit it held is returned."""
    with Gateway(port=0, concurrency=1) as gw:
        gw.add_route("m", FakeTokenServer())
        status, _, body = _post(gw.port, "/v1/generate/m",
                                {"tokens": [1],
                                 "max_new_tokens": "abc"})
        assert status == 400
        assert json.loads(body)["error"]["code"] == 400
        status, _, raw = _post(gw.port, "/v1/generate/m",
                               {"tokens": [1], "max_new_tokens": 3})
        assert status == 200               # the single permit came back
        assert _sse_frames(raw)[-1]["done"] is True
    evs = _gw_events(2)
    assert [e["http_status"] for e in evs] == [400, 200]


def test_stalled_backend_midstream_504_is_an_sse_frame(registry):
    """The stalled-backend 504 after tokens have streamed must ride a
    final SSE error frame — a second status line written into the open
    event stream would corrupt the wire."""
    hold = threading.Event()               # never set: backend stalls
    with Gateway(port=0) as gw:
        gw.add_route("m", FakeTokenServer(tokens=(7,), hold=hold))
        status, _, raw = _post(gw.port, "/v1/generate/m",
                               {"tokens": [1]},
                               headers={"X-Deadline-Ms": "200"})
    hold.set()
    assert status == 200                   # headers went out with tok 7
    assert raw.count(b"HTTP/1.1") == 0     # no status line mid-stream
    frames = _sse_frames(raw)
    assert frames[0] == {"token": 7}
    assert frames[-1]["error"]["code"] == 504
    (ev,) = _gw_events(1)
    assert ev["http_status"] == 504 and ev["outcome"] == "deadline"


def test_tenant_state_is_bounded_by_max_tenants(registry):
    """Unique attacker-minted X-Tenant values past the cap collapse
    onto the shared overflow key and idle fair-queue entries are
    pruned — per-tenant state cannot grow without bound."""
    with Gateway(port=0, quota_qps=1000, quota_burst=1000,
                 max_tenants=4) as gw:
        gw.add_route("m", FakePredict(), kind="predict")
        for i in range(12):
            status, _, _ = _post(gw.port, "/v1/predict/m",
                                 {"rows": [[1.0]]},
                                 headers={"X-Tenant": "mint-%d" % i})
            assert status == 200
        stats = gw.stats()
        assert stats["tenants"]["known"] == 4
        assert len(gw._buckets) <= 5       # 4 tracked + "~overflow"
        assert gwmod.OVERFLOW_TENANT in gw._buckets
        assert gw._wfq._queues == {}       # idle queues pruned
        assert gw._wfq._vfinish == {}      # idle clocks pruned
    # overflow tenants share ONE metric label, not one per header
    evs = _gw_events(12)
    tenants = {e["tenant"] for e in evs}
    assert len(tenants) == 5
    assert gwmod.OVERFLOW_TENANT in tenants


def test_fair_queue_prunes_idle_tenants():
    fq = FairQueue(permits=2, depth=4)
    fq.acquire("a")
    fq.acquire("b")
    fq.release()
    fq.release()
    assert fq._queues == {} and fq._vfinish == {}


# ---------------------------------------------------------------------------
# the chaos matrix fixtures: a real TokenServer over a tiny port LM
# ---------------------------------------------------------------------------

VOCAB, D_MODEL, N_HEADS, N_LAYERS, MAX_LEN = 48, 32, 2, 2, 24


@pytest.fixture(scope="module")
def lm():
    tmx.random.seed(0)
    net = TransformerLM(vocab_size=VOCAB, d_model=D_MODEL,
                        n_heads=N_HEADS, n_layers=N_LAYERS,
                        max_len=MAX_LEN)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    net(tmx.nd.array(np.zeros((1, 4), np.float32), ctx=tmx.cpu()))
    return net


@pytest.fixture(scope="module")
def eng(lm):
    return generate.GenerationEngine(
        lm, slots=3, cache_len=MAX_LEN, buckets=[8, MAX_LEN],
        sampling=generate.SamplingConfig(greedy=True), device=tmx.cpu())


@pytest.fixture(scope="module")
def server(eng):
    srv = generate.TokenServer(eng, queue_depth=8)
    srv.generate(np.array([1, 2, 3], np.int32), timeout=120,
                 max_new_tokens=2)
    yield srv
    srv.close(drain=False, timeout=5)


def _assert_no_leaks(baseline_threads, server):
    """The matrix's shared postcondition: handler threads unwound,
    zero open gateway streams, zero occupied decode slots."""
    _wait(lambda: threading.active_count() <= baseline_threads,
          msg="handler threads to unwind (baseline %d, now %d)"
          % (baseline_threads, threading.active_count()))
    _wait(lambda: tel.GATEWAY_OPEN_STREAMS.value() == 0,
          msg="gateway open_streams -> 0")
    _wait(lambda: server.stats()["active"] == 0
          and server.stats()["free_slots"] == 3,
          msg="decode slots to free")
    sub = tel.statusz()["subsystems"]
    assert sub["gateway"]["open_streams"] == 0
    assert sub["decode"]["active_slots"] == 0


# ---------------------------------------------------------------------------
# tests/test_gateway_chaos.py's matrix on a real port TokenServer
# ---------------------------------------------------------------------------

def test_slow_loris_body_cut_408(registry, server):
    baseline = threading.active_count()
    with Gateway(port=0, read_timeout_s=0.4) as gw:
        gw.add_route("lm", server)
        body = json.dumps({"tokens": [1, 2, 3]})
        t0 = time.monotonic()
        status, raw = faults.slow_loris_post(
            "127.0.0.1", gw.port, "/v1/generate/lm", body,
            trickle_delay_s=0.15, bytes_per_trickle=1)
        took = time.monotonic() - t0
        assert status == 408, raw[:200]
        assert took < 8.0, "slow-loris held a handler %.1fs" % took
        assert tel.GATEWAY_BAD_REQUESTS.value(kind="slow_body") == 1
        evs = _gw_events(1)
        assert len(evs) == 1
        assert evs[0]["http_status"] == 408
        assert evs[0]["error_kind"] == "slow_body"
        _assert_no_leaks(baseline + 1, server)   # gateway thread lives
    _assert_no_leaks(baseline, server)


def test_malformed_truncated_oversized(registry, server):
    baseline = threading.active_count()
    with Gateway(port=0, max_body=4096, read_timeout_s=0.5) as gw:
        gw.add_route("lm", server)
        # broken JSON -> 400
        status, _ = faults.malformed_post(
            "127.0.0.1", gw.port, "/v1/generate/lm",
            raw_body=b'{"tokens": [1, 2')
        assert status == 400
        # lying Content-Length (body shorter than declared) -> the
        # read times out waiting for bytes that never come: 408, not a
        # pinned thread
        status, _ = faults.malformed_post(
            "127.0.0.1", gw.port, "/v1/generate/lm",
            raw_body=b'{"tokens": [1]}', content_length=400)
        assert status == 408
        # memory-bomb Content-Length -> refused 413 without reading
        status, _ = faults.oversized_post(
            "127.0.0.1", gw.port, "/v1/generate/lm",
            claim_bytes=50 * 1024 * 1024)
        assert status == 413
        assert tel.GATEWAY_BAD_REQUESTS.value(kind="malformed") == 1
        assert tel.GATEWAY_BAD_REQUESTS.value(kind="oversized") == 1
        evs = _gw_events(3)
        assert len(evs) == 3
        assert sorted(e["http_status"] for e in evs) == [400, 408, 413]
        assert all(e["outcome"] == "error" for e in evs)
        _assert_no_leaks(baseline + 1, server)
    _assert_no_leaks(baseline, server)


def test_midstream_disconnect_evicts_slot(registry, server, eng):
    """The leaked-lane scenario: the client reads the first SSE token
    then vanishes with a TCP RST.  The gateway's next write fails ->
    cancel -> the decode loop evicts the slot (reason cancelled); no
    stream, thread, or lane survives the client."""
    baseline = threading.active_count()
    # slow each decode step so the disconnect deterministically lands
    # mid-generation (~19 tokens to the cache cap, 60 ms each)
    real_step = eng.decode_step
    eng.decode_step = faults.LatencySpike(real_step, delay=0.06)
    try:
        with Gateway(port=0) as gw:
            gw.add_route("lm", server)
            body = json.dumps({"tokens": [1, 2, 3]})
            status, nread = faults.disconnecting_stream_post(
                "127.0.0.1", gw.port, "/v1/generate/lm", body,
                read_bytes=1, rst=True)
            assert status == 200          # the stream was live (TTFT)
            assert nread >= 1
            # cancel propagated: slot evicted, not run to completion
            _wait(lambda: tel.GATEWAY_CLIENT_DISCONNECTS.value() == 1,
                  msg="disconnect to be detected")
            _wait(lambda: tel.DECODE_EVICTIONS.value(
                reason="cancelled") == 1, msg="slot eviction")
            evs = _gw_events(1)
            assert len(evs) == 1
            assert evs[0]["http_status"] == 499
            assert evs[0]["outcome"] == "evicted"
            _assert_no_leaks(baseline + 1, server)
        _assert_no_leaks(baseline, server)
    finally:
        eng.decode_step = real_step


def test_stalled_handler_answers_504(registry, server):
    """A backend that admits and then never resolves (the hung-device
    stall, via faults.StallingCallable) cannot pin the request past
    its deadline: the gateway retracts it and answers the contract's
    504."""
    stall = faults.StallingCallable(lambda: None)

    class StalledBackend:
        def submit(self, tokens, deadline_ms=None, max_new_tokens=None,
                   on_token=None):
            fut = _ChaosFut()
            threading.Thread(target=lambda: (stall(), fut.set_done()),
                             daemon=True).start()
            return fut

    class _ChaosFut:
        def __init__(self):
            self._ev = threading.Event()
            self.cancelled = False

        def set_done(self):
            self._ev.set()

        def done(self):
            return self._ev.is_set()

        def cancel(self):
            self.cancelled = True
            self._ev.set()
            return True

        def result(self, timeout=None):
            raise Cancelled("retracted")

    baseline = threading.active_count()
    try:
        with Gateway(port=0) as gw:
            gw.add_route("stuck", StalledBackend())
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                              timeout=30)
            payload = json.dumps({"tokens": [1]})
            t0 = time.monotonic()
            conn.request("POST", "/v1/generate/stuck", body=payload,
                         headers={"Content-Length": str(len(payload)),
                                  "X-Deadline-Ms": "300"})
            resp = conn.getresponse()
            resp.read()
            conn.close()
            assert resp.status == 504
            assert time.monotonic() - t0 < 10.0
            evs = _gw_events(1)
            assert len(evs) == 1
            assert evs[0]["outcome"] == "deadline"
            assert evs[0]["http_status"] == 504
            # the backend's thread may start after the deadline fired
            assert stall.stalled.wait(10.0)  # it really was stalled
    finally:
        stall.release()
    _wait(lambda: threading.active_count() <= baseline,
          msg="stalled-backend threads to unwind")
    _assert_no_leaks(baseline, server)


def test_sigterm_drains_inflight_stream(registry, server, eng):
    """SIGTERM mid-stream: /healthz flips 503 and new work sheds 503
    while the open SSE stream runs to completion — then the listener
    stops and the gateway deregisters.  No dropped in-flight request,
    no connection refused during the drain."""
    import signal

    baseline = threading.active_count()
    real_step = eng.decode_step
    eng.decode_step = faults.LatencySpike(real_step, delay=0.06)
    gw = Gateway(port=0, drain_s=30.0)
    gw.add_route("lm", server)
    prev = gw.install_signal_handler()
    inflight = {}

    def fire():
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                          timeout=60)
        payload = json.dumps({"tokens": [1, 2, 3]})
        conn.request("POST", "/v1/generate/lm", body=payload,
                     headers={"Content-Length": str(len(payload))})
        resp = conn.getresponse()
        inflight["status"] = resp.status
        inflight["body"] = resp.read()
        conn.close()

    try:
        t = threading.Thread(target=fire, daemon=True)
        t.start()
        _wait(lambda: tel.GATEWAY_OPEN_STREAMS.value() == 1,
              msg="stream to open")
        faults.send_preemption(sig=signal.SIGTERM)
        _wait(lambda: not gw.is_ready(), msg="drain to start")
        # mid-drain: probes and new work shed typed, listener up
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                          timeout=10)
        conn.request("GET", "/healthz")
        assert conn.getresponse().status == 503
        conn.close()
        payload = json.dumps({"tokens": [1]})
        conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                          timeout=10)
        conn.request("POST", "/v1/generate/lm", body=payload,
                     headers={"Content-Length": str(len(payload))})
        assert conn.getresponse().status == 503
        conn.close()
        # the in-flight stream finishes whole
        t.join(30)
        assert inflight["status"] == 200
        frames = [json.loads(p[len(b"data: "):])
                  for p in inflight["body"].split(b"\n\n")
                  if p.startswith(b"data: ")]
        assert frames[-1].get("done") is True
        _wait(lambda: gw._closed, msg="gateway to close")
        _wait(lambda: tel.readiness()[0], msg="readiness to clear")
        # one event per request: the drained stream + the shed one
        evs = _gw_events(2)
        assert len(evs) == 2
        assert sorted(e["http_status"] for e in evs) == [200, 503]
    finally:
        signal.signal(signal.SIGTERM, prev)
        eng.decode_step = real_step
        gw.close(drain=False)
    _assert_no_leaks(baseline, server)


# ---------------------------------------------------------------------------
# the JAX gateway and the port's on the same fake backends
# ---------------------------------------------------------------------------

class _Pkg:
    """One package's gateway, telemetry, events and error types."""

    def __init__(self, gw, telm, ev, errs):
        self.Gateway, self.tel, self.events, self.errs = gw, telm, ev, errs


JAX = _Pkg(jgateway.Gateway, jtel, jevents, jserving_async)
PORT = _Pkg(Gateway, tel, events, tserving_async)


def _backends(pkg):
    """The scenario routes, each package's own error types."""
    e = pkg.errs
    hold = threading.Event()             # never set: a stalled backend
    return {
        "ok": ("predict", FakePredict(scale=3.0)),
        "full": ("predict", FakePredict(admit_exc=e.Overloaded(
            "queue", "full"))),
        "inflight": ("predict", FakePredict(admit_exc=e.Overloaded(
            "inflight", "cap"))),
        "closed": ("predict", FakePredict(admit_exc=e.Overloaded(
            "shutdown", "closing"))),
        "buggy": ("predict", _BuggyBackend()),
        "lm": ("generate", FakeTokenServer(tokens=(4, 5, 6))),
        "slo": ("generate", FakeTokenServer(admit_exc=e.Overloaded(
            "slo", "burn"))),
        "slots": ("generate", FakeTokenServer(admit_exc=e.Overloaded(
            "slots", "busy"))),
        "late": ("generate", FakeTokenServer(
            tokens=(), final_exc=e.DeadlineExceeded("prefill", "late"))),
        "mid": ("generate", FakeTokenServer(
            tokens=(1, 2), final_exc=e.DeadlineExceeded("decode", "mid"))),
        "gone": ("generate", FakeTokenServer(
            tokens=(3,), final_exc=e.Cancelled("retracted"))),
        "stuck": ("generate", FakeTokenServer(tokens=(7,), hold=hold)),
    }, hold


WIRE_CASES = [
    ("/v1/predict/ok", {"rows": [[1.0, 2.0], [3.0, 4.0]]}, {}),
    ("/v1/predict/ok", {"rows": [[1.5]]}, {"X-Tenant": "acme"}),
    ("/v1/predict/full", {"rows": [[1.0]]}, {}),
    ("/v1/predict/inflight", {"rows": [[1.0]]}, {}),
    ("/v1/predict/closed", {"rows": [[1.0]]}, {}),
    ("/v1/predict/buggy", {"rows": [[1.0]]}, {}),
    ("/v1/predict/ok", {"nope": 1}, {}),
    ("/v1/predict/ok", {"rows": [["x", {}]]}, {}),
    ("/v1/predict/ok", "{not json", {}),
    ("/v1/predict/ok", {"rows": [[1.0]]}, {"X-Deadline-Ms": "soon"}),
    ("/v1/predict/ghost", {"rows": [[1.0]]}, {}),
    ("/nope", {"x": 1}, {}),
    ("/v1/predict/ok", json.dumps({"rows": [[0.0] * 600]}), {}),
    ("/v1/generate/lm", {"tokens": [1, 2]}, {}),
    ("/v1/generate/lm", {"tokens": [1], "max_new_tokens": "abc"}, {}),
    ("/v1/generate/lm", {"tokens": []}, {}),
    ("/v1/generate/slo", {"tokens": [1]}, {}),
    ("/v1/generate/slots", {"tokens": [1]}, {}),
    ("/v1/generate/late", {"tokens": [1]}, {}),
    ("/v1/generate/mid", {"tokens": [1]}, {}),
    ("/v1/generate/gone", {"tokens": [1]}, {}),
    ("/v1/generate/stuck", {"tokens": [1]}, {"X-Deadline-Ms": "200"}),
]

_MASKED = ("ttft_s", "trace_id", "span_id", "request_id")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in _MASKED else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _wire(status, headers, body):
    """What the contract fixes of one answer: the status, Retry-After,
    Content-Type and the body (JSON, or the SSE frames), ids and
    timestamps masked."""
    kept = {k: headers.get(k) for k in ("Retry-After", "Content-Type")}
    if body.startswith(b"data: "):
        parsed = ["sse"] + _mask(_sse_frames(body))
    else:
        try:
            parsed = _mask(json.loads(body))
        except ValueError:
            parsed = body.decode("utf-8", "replace")
    return status, kept, parsed


def _run_wire_cases(pkg):
    pkg.tel.enable()
    pkg.tel.reset()
    pkg.events.enable(path="", sample=1.0)
    pkg.events.reset()
    routes, hold = _backends(pkg)
    try:
        with pkg.Gateway(port=0, max_body=2048) as gw:
            for name, (kind, backend) in routes.items():
                gw.add_route(name, backend, kind=kind)
            out = [_wire(*_post(gw.port, path, body, headers=hdrs))
                   for path, body, hdrs in WIRE_CASES]
        # a tenant over its quota: 429 with the refill wait
        with pkg.Gateway(port=0, quota_qps=0.5, quota_burst=1) as gw:
            gw.add_route("ok", routes["ok"][1], kind="predict")
            quota = [_wire(*_post(gw.port, "/v1/predict/ok",
                                  {"rows": [[1.0]]},
                                  headers={"X-Tenant": "tight"}))
                     for _ in range(2)]
        evs = [e for e in pkg.events.recent()
               if e["kind"] == "gateway_request"]
        hold.set()
        fields = [(e["http_status"], e["outcome"], e.get("model"),
                   e.get("op"), e.get("tenant"), e.get("reason"),
                   e.get("stage"), e.get("error_kind"), e.get("tokens"))
                  for e in evs]
        return out, quota, sorted(fields, key=repr)
    finally:
        hold.set()
        pkg.events.reset()
        pkg.events.disable()
        pkg.tel.reset()
        pkg.tel.disable()


def test_wire_behaviour_equals_the_jax_gateway():
    jout, jquota, jev = _run_wire_cases(JAX)
    tout, tquota, tev = _run_wire_cases(PORT)
    for case, j, t in zip(WIRE_CASES, jout, tout):
        assert t == j, case
    assert {s for s, _h, _b in tout} >= {200, 400, 404, 413, 429, 500,
                                         503, 504}
    assert tquota == jquota
    assert [s for s, _h, _b in tquota] == [200, 429]
    assert tev == jev and len(tev) == len(WIRE_CASES) + 2


def test_wire_code_equals_jax_over_the_taxonomy():
    cases = [("Overloaded", r) for r in
             ("queue", "inflight", "wait", "slo", "unhealthy", "shutdown",
              "slots", "pages", "other")] + \
        [("DeadlineExceeded", s) for s in
         ("queue", "pickup", "dispatch", "completion", "prefill", "decode",
          "other")] + [("Cancelled", None), ("ReplicaFailed", None),
                       ("ServingError", None)]
    for typ, arg in cases:
        args = (arg, "detail") if arg is not None else ("detail",)
        t = getattr(tserving_async, typ)(*args)
        j = getattr(jserving_async, typ)(*args)
        assert wire_code(t) == jgateway.wire_code(j), (typ, arg)
        assert gwmod._outcome_of(t) == jgateway._outcome_of(j), (typ, arg)
    for exc in (ValueError("x"), RuntimeError("y"), KeyError("z")):
        assert wire_code(exc) == jgateway.wire_code(exc) == 500
    assert CONTRACT == jgateway.CONTRACT
