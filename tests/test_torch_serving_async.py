"""The port's async serving tier (serving_async.AsyncPredictor) on the
CPU: tests/test_serving_async.py's 33 cases driven with the port's
testing.faults (overload -> typed rejection, deadline -> typed timeout
+ metric while the queue keeps serving, replica failure/stall ->
ejection + reroute, warm pool and heal probe, shutdown -> drain), and
BurnRateShedder's open and close decisions equal to the JAX one's on
the same histogram observations.  Replicas serve a trivial forward
(x * 2) on the CPU; one test goes through gluon from_block for the
multi-replica path.  Waits are on events or polled conditions with a
timeout; a deadline is expired by handing sweep() a later clock."""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu.telemetry as jtel
import mxnet_tpu.serving_async as jserving_async
import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.telemetry as tel
import mxnet_tpu_torch.tracing as tracing
from mxnet_tpu_torch.serving import Predictor
from mxnet_tpu_torch.serving_async import (AsyncPredictor, BurnRateShedder,
                                           Cancelled, DeadlineExceeded,
                                           Overloaded, ReplicaFailed)
from mxnet_tpu_torch.testing import faults

CPU = tmx.cpu()

B = 4           # compiled batch rows
CHAIN = 2


@pytest.fixture
def telemetry_on():
    tel.enable()
    tel.reset()
    yield
    tel.reset()
    tel.disable()


def make_replica(device=CPU, chain=CHAIN):
    return Predictor(lambda x, p: x * 2.0, [], chain=chain,
                     batch_shape=(B, 3), batch_dtype=np.float32,
                     device=device)


def make_ap(n=1, **kw):
    kw.setdefault("batch_window_ms", 20.0)
    kw.setdefault("sweep_interval_s", 10.0)   # manual sweep() in tests
    return AsyncPredictor([make_replica() for _ in range(n)], **kw)


def rows(*vals):
    """One request batch: len(vals) rows of [v, v, v]."""
    return np.array([[v, v, v] for v in vals], np.float32)


def stall(rep, exc=None, exc_on_release=None):
    """Replace a replica's compiled chain fn with a fault wrapper."""
    wrapper = faults.StallingCallable(rep._jit_chain, exc=exc,
                                      exc_on_release=exc_on_release)
    rep._jit_chain = wrapper
    return wrapper


# ---------------------------------------------------------------------------
# happy path: continuous batching
# ---------------------------------------------------------------------------

def test_results_match_and_requests_pack_into_one_dispatch(telemetry_on):
    ap = make_ap(batch_window_ms=150.0)
    try:
        futs = [ap.submit(rows(float(i))) for i in range(4)]
        for i, f in enumerate(futs):
            out = f.result(timeout=5)
            assert out.shape == (1, 3)
            np.testing.assert_allclose(out, rows(float(i)) * 2.0)
        # all four 1-row requests were packed by the batch former into
        # a single device dispatch (4 rows < the 8-row capacity, so it
        # fired on the linger window, not on size)
        assert tel.SERVING_DISPATCH_ROWS.count() == 1
        assert tel.SERVING_DISPATCH_ROWS.sum() == 4
        assert tel.SERVING_ASYNC_REQUESTS.value() == 4
    finally:
        ap.close()
    s = ap.stats()
    assert s["inflight"] == 0 and s["queue_depth"] == 0


def test_ragged_rows_pack_and_slice_correctly():
    ap = make_ap(batch_window_ms=100.0)
    try:
        fa = ap.submit(rows(1.0, 2.0))
        fb = ap.submit(rows(3.0))
        fc = ap.submit(rows(4.0, 5.0, 6.0))   # splits to a second batch
        np.testing.assert_allclose(fa.result(5), rows(1.0, 2.0) * 2)
        np.testing.assert_allclose(fb.result(5), rows(3.0) * 2)
        np.testing.assert_allclose(fc.result(5), rows(4.0, 5.0, 6.0) * 2)
    finally:
        ap.close()


def test_ragged_claim_never_fragments_past_chain_batches(telemetry_on):
    # the claim loop must mirror _form_batches' first-fit: a raw
    # rows<=chain*B cap would claim 3+3+2 rows (8 = cap) as one chunk,
    # but whole-request packing needs THREE 4-row batches for it —
    # one more than chain=2 — silently doubling the device dispatch
    ap = make_ap(batch_window_ms=100.0)
    try:
        with ap._cond:          # workers can't claim until we release
            fa = ap.submit(rows(1.0, 2.0, 3.0))
            fb = ap.submit(rows(4.0, 5.0, 6.0))
            fc = ap.submit(rows(7.0, 8.0))
        for f, v in ((fa, rows(1.0, 2.0, 3.0)), (fb, rows(4.0, 5.0, 6.0)),
                     (fc, rows(7.0, 8.0))):
            np.testing.assert_allclose(f.result(5), v * 2.0)
        assert tel.SERVING_DISPATCH_ROWS.count() == 2    # 6 rows + 2 rows
        assert tel.SERVING_DISPATCH_ROWS.sum() == 8
    finally:
        ap.close()


def test_contract_violations_fail_the_submit_not_the_batch():
    ap = make_ap()
    try:
        with pytest.raises(TypeError):
            ap.submit(np.ones((2, 3), np.float64))
        with pytest.raises(ValueError):
            ap.submit(np.ones((2, 5), np.float32))
        with pytest.raises(ValueError):
            ap.submit(np.ones((B + 1, 3), np.float32))   # rows > B
    finally:
        ap.close()
    # replicas without a pinned contract are rejected at construction
    with pytest.raises(ValueError):
        AsyncPredictor(Predictor(lambda x, p: x, [], device=CPU))


def test_sync_predict_convenience_and_context_manager():
    with make_ap() as ap:
        np.testing.assert_allclose(ap.predict(rows(7.0), timeout=5),
                                   rows(7.0) * 2)


# ---------------------------------------------------------------------------
# overload -> typed rejection, backpressure
# ---------------------------------------------------------------------------

def test_full_queue_rejects_typed_then_recovers(telemetry_on):
    ap = make_ap(queue_depth=2, batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        first = ap.submit(rows(1.0))          # claimed, blocks in dispatch
        assert st.stalled.wait(5)
        q1 = ap.submit(rows(2.0))
        q2 = ap.submit(rows(3.0))             # queue now full
        with pytest.raises(Overloaded) as ei:
            ap.submit(rows(4.0))
        assert ei.value.reason == "queue"
        # blocking submit with a timeout sheds AFTER the wait, typed
        t0 = time.monotonic()
        with pytest.raises(Overloaded):
            ap.submit(rows(4.0), block=True, timeout=0.05)
        assert time.monotonic() - t0 < 2.0
        assert tel.SERVING_SHED.value(reason="queue") == 2
        st.release()
        for f in (first, q1, q2):
            f.result(timeout=5)
        # capacity freed: admission works again
        np.testing.assert_allclose(ap.predict(rows(5.0), timeout=5),
                                   rows(5.0) * 2)
    finally:
        st.release()
        ap.close()


def test_backpressure_blocks_until_capacity_frees():
    ap = make_ap(queue_depth=1, batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        ap.submit(rows(1.0))
        assert st.stalled.wait(5)
        ap.submit(rows(2.0))                  # fills the queue
        got = {}

        def blocked_submit():
            got["fut"] = ap.submit(rows(3.0), block=True, timeout=5)

        t = threading.Thread(target=blocked_submit)
        t.start()
        t.join(timeout=0.05)
        assert t.is_alive() and "fut" not in got   # waiting for space
        st.release()
        t.join(timeout=5)
        assert not t.is_alive()
        np.testing.assert_allclose(got["fut"].result(5), rows(3.0) * 2)
    finally:
        st.release()
        ap.close()


def test_inflight_cap_rejects_typed(telemetry_on):
    ap = make_ap(queue_depth=16, max_inflight=2, batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        ap.submit(rows(1.0))
        assert st.stalled.wait(5)
        ap.submit(rows(2.0))                  # inflight now 2 (cap)
        with pytest.raises(Overloaded) as ei:
            ap.submit(rows(3.0))
        assert ei.value.reason == "inflight"
        assert tel.SERVING_SHED.value(reason="inflight") == 1
    finally:
        st.release()
        ap.close()


def test_estimated_wait_admission_sheds_unmeetable_requests(telemetry_on):
    ap = make_ap(queue_depth=16, slo_ms=100.0, batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        ap._ewma_chunk_s = 10.0               # "measured": 10 s/dispatch
        ap.submit(rows(1.0))
        assert st.stalled.wait(5)
        ap.submit(rows(2.0))                  # 1 queued row pending
        with pytest.raises(Overloaded) as ei:
            ap.submit(rows(3.0))
        assert ei.value.reason == "wait"
        assert tel.SERVING_SHED.value(reason="wait") == 1
    finally:
        st.release()
        ap.close()


# ---------------------------------------------------------------------------
# deadlines: queue sweep, completion, and the queue keeps serving
# ---------------------------------------------------------------------------

def test_queue_deadline_swept_typed_and_queue_keeps_serving(telemetry_on):
    ap = make_ap(queue_depth=8, batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        blocker = ap.submit(rows(1.0))
        assert st.stalled.wait(5)
        doomed = ap.submit(rows(2.0), deadline_ms=5.0)
        ap.sweep(now=time.monotonic() + 1.0)  # past its deadline
        with pytest.raises(DeadlineExceeded) as ei:
            doomed.result(timeout=1)
        assert ei.value.stage == "queue"
        assert tel.SERVING_DEADLINE_EXCEEDED.value(stage="queue") == 1
        # the expired request freed its slot; everyone else still serves
        survivor = ap.submit(rows(3.0))
        st.release()
        blocker.result(timeout=5)
        np.testing.assert_allclose(survivor.result(5), rows(3.0) * 2)
    finally:
        st.release()
        ap.close()


def test_completion_deadline_fails_late_result_typed(telemetry_on):
    ap = make_ap(batch_window_ms=1.0)
    rep = ap._replicas[0].pred
    rep._jit_chain = faults.LatencySpike(rep._jit_chain, delay=0.15,
                                         count=1)
    try:
        late = ap.submit(rows(1.0), deadline_ms=30.0)
        with pytest.raises(DeadlineExceeded) as ei:
            late.result(timeout=5)
        assert ei.value.stage == "completion"
        assert tel.SERVING_DEADLINE_EXCEEDED.value(
            stage="completion") == 1
        # spike was one-shot: the tier is healthy again
        np.testing.assert_allclose(ap.predict(rows(2.0), timeout=5),
                                   rows(2.0) * 2)
    finally:
        ap.close()


def test_mid_dispatch_deadline_unblocks_caller_via_sweep(telemetry_on):
    ap = make_ap(batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        stuck = ap.submit(rows(1.0), deadline_ms=10.0)
        assert st.stalled.wait(5)
        ap.sweep(now=time.monotonic() + 1.0)  # claimed + expired
        with pytest.raises(DeadlineExceeded) as ei:
            stuck.result(timeout=1)           # caller NOT held hostage
        assert ei.value.stage == "dispatch"
    finally:
        st.release()
        ap.close()


# ---------------------------------------------------------------------------
# replica failure / stall -> ejection + reroute
# ---------------------------------------------------------------------------

def test_failed_replica_ejected_and_requests_rerouted(telemetry_on):
    ap = AsyncPredictor([make_replica(), make_replica()],
                        batch_window_ms=1.0, sweep_interval_s=10.0)
    good = stall(ap._replicas[0].pred)            # healthy but blockable
    stall(ap._replicas[1].pred,
          exc=RuntimeError("injected replica fault"))
    try:
        first = ap.submit(rows(1.0))
        assert good.stalled.wait(5)               # replica 0 busy
        rerouted = ap.submit(rows(2.0))           # only replica 1 free
        deadline = time.monotonic() + 5
        while ap.stats()["healthy_replicas"] > 1:
            if time.monotonic() > deadline:
                raise AssertionError("replica 1 never ejected")
            time.sleep(0.005)
        assert tel.SERVING_REPLICA_EJECTIONS.value(reason="error") == 1
        assert tel.SERVING_REQUEST_RETRIES.value() >= 1
        good.release()                            # replica 0 drains both
        np.testing.assert_allclose(first.result(5), rows(1.0) * 2)
        np.testing.assert_allclose(rerouted.result(5), rows(2.0) * 2)
        assert ap.stats()["healthy_replicas"] == 1
    finally:
        good.release()
        ap.close()


def test_all_replicas_failed_requests_fail_typed_and_heal_recovers():
    ap = make_ap(max_retries=1, batch_window_ms=1.0)
    rep = ap._replicas[0].pred
    orig = rep._jit_chain
    broken = faults.StallingCallable(
        orig, exc=RuntimeError("injected replica fault"))
    rep._jit_chain = broken
    try:
        doomed = ap.submit(rows(1.0))
        with pytest.raises(ReplicaFailed):
            doomed.result(timeout=5)
        # no healthy replica left: admission sheds typed
        with pytest.raises(Overloaded) as ei:
            ap.submit(rows(2.0))
        assert ei.value.reason == "unhealthy"
        # operator heals the replica -> service resumes
        rep._jit_chain = orig
        ap.heal()
        np.testing.assert_allclose(ap.predict(rows(3.0), timeout=5),
                                   rows(3.0) * 2)
    finally:
        ap.close()


def test_stall_watchdog_ejects_and_reroutes(telemetry_on):
    ap = AsyncPredictor([make_replica(), make_replica()],
                        batch_window_ms=1.0, sweep_interval_s=10.0,
                        stall_timeout_s=0.03, max_retries=2)
    hung = stall(ap._replicas[0].pred)
    with ap._cond:                                # pre-eject replica 1 so
        ap._eject_locked(ap._replicas[1], "test")  # the hung one must claim
    try:
        victim = ap.submit(rows(1.0))
        assert hung.stalled.wait(5)
        ap.heal(1)                                # healthy reroute target
        ap.sweep(now=time.monotonic() + 1.0)      # exceed stall_timeout
        assert ap._replicas[0].healthy is False
        assert tel.SERVING_REPLICA_EJECTIONS.value(reason="stall") == 1
        np.testing.assert_allclose(victim.result(5), rows(1.0) * 2)
    finally:
        hung.release()
        ap.close()


def _sweep_with_rep0_over_budget(ap):
    """One sweep at a clock where replica 0's dispatch is past the
    0.2 s stall budget and replica 1's is 0.1 s old: its start is moved
    1 s before replica 1's, so no wall-clock sleep decides the order."""
    with ap._cond:
        bs1 = ap._replicas[1].busy_since
        ap._replicas[0].busy_since = bs1 - 1.0
    ap.sweep(now=bs1 + 0.1)


def test_failed_dispatch_skips_requests_the_watchdog_already_requeued():
    # the stall watchdog requeues a hung replica's requests; when the
    # hang later ends in a device ERROR, the except path must not
    # requeue the same request objects a second time (duplicate queue
    # entry + permanent _queued_rows leak that poisons estimated-wait
    # admission)
    ap = AsyncPredictor([make_replica(), make_replica()],
                        batch_window_ms=1.0, sweep_interval_s=10.0,
                        stall_timeout_s=0.2, max_retries=2)
    h0 = stall(ap._replicas[0].pred,
               exc_on_release=RuntimeError("device error after stall"))
    with ap._cond:                                 # force rep0 to claim
        ap._eject_locked(ap._replicas[1], "test")
    h1 = stall(ap._replicas[1].pred)
    try:
        a = ap.submit(rows(1.0))
        assert h0.stalled.wait(5)
        ap.heal(1)
        b = ap.submit(rows(2.0))                   # keeps rep1 busy
        assert h1.stalled.wait(5)
        _sweep_with_rep0_over_budget(ap)           # rep1 fresh: requeue A
        assert ap._replicas[0].healthy is False
        assert ap._replicas[1].healthy is True
        assert ap.stats()["queued_rows"] == 1
        h0.release()                               # hang -> device error
        for _ in range(200):                       # except path done when
            if ap._replicas[0].thread is None:     # rep0's worker exits
                break
            time.sleep(0.01)
        assert ap._replicas[0].thread is None
        assert ap.stats()["queued_rows"] == 1      # no duplicate requeue
        h1.release()                               # rep1 serves B then A
        np.testing.assert_allclose(b.result(5), rows(2.0) * 2)
        np.testing.assert_allclose(a.result(5), rows(1.0) * 2)
        assert ap.stats()["queued_rows"] == 0
        assert len(ap._queue) == 0
    finally:
        h0.release()
        h1.release()
        ap.close()


def test_late_success_of_requeued_request_compacts_the_queue():
    # the stall watchdog requeues a hung replica's request; when the
    # hang later ends in a SUCCESS, the late result resolves the
    # request (first-writer-wins) but its requeued entry is now dead —
    # it must be compacted out, not left occupying an admission slot
    ap = AsyncPredictor([make_replica(), make_replica()],
                        batch_window_ms=1.0, sweep_interval_s=10.0,
                        stall_timeout_s=0.2, max_retries=2)
    h0 = stall(ap._replicas[0].pred)
    with ap._cond:                                 # force rep0 to claim
        ap._eject_locked(ap._replicas[1], "test")
    h1 = stall(ap._replicas[1].pred)
    try:
        a = ap.submit(rows(1.0))
        assert h0.stalled.wait(5)
        ap.heal(1)
        b = ap.submit(rows(2.0))                   # keeps rep1 busy
        assert h1.stalled.wait(5)
        _sweep_with_rep0_over_budget(ap)           # eject rep0, requeue A
        assert ap.stats()["queued_rows"] == 1
        h0.release()                               # hang -> late SUCCESS
        np.testing.assert_allclose(a.result(5), rows(1.0) * 2.0)
        with ap._cond:                             # dispatch block done
            assert len(ap._queue) == 0, "dead requeued entry left"
        assert ap.stats()["queued_rows"] == 0
        h1.release()
        np.testing.assert_allclose(b.result(5), rows(2.0) * 2.0)
    finally:
        h0.release()
        h1.release()
        ap.close()


def test_request_induced_dispatch_failure_keeps_replica(telemetry_on):
    # a dispatch error whose replica still answers a canary batch is
    # payload-induced: the chunk fails typed, the replica stays in
    # rotation, and the service keeps serving (no cascade ejection)
    ap = make_ap()
    rep = ap._replicas[0]
    rep.pred._jit_chain = faults.FlakyCallable(
        1, fn=rep.pred._jit_chain,
        exc=RuntimeError("poisoned request payload"))
    try:
        victim = ap.submit(rows(1.0))
        with pytest.raises(ReplicaFailed, match="canary"):
            victim.result(5)
        assert rep.healthy is True
        assert tel.SERVING_REPLICA_EJECTIONS.value(reason="error") == 0
        np.testing.assert_allclose(
            np.asarray(ap.predict(rows(2.0), timeout=5)), rows(2.0) * 2)
    finally:
        ap.close()


def test_transient_device_put_failure_is_retried():
    rep = make_replica()
    ap = AsyncPredictor(rep, batch_window_ms=1.0, sweep_interval_s=10.0)
    try:
        with faults.transient_device_put_failures(1) as wrapper:
            np.testing.assert_allclose(ap.predict(rows(1.0), timeout=5),
                                       rows(1.0) * 2)
        assert wrapper.calls >= 2                 # failed once, retried
        assert ap.stats()["healthy_replicas"] == 1   # never ejected
    finally:
        ap.close()


# ---------------------------------------------------------------------------
# cancellation, SLO shedding, drain
# ---------------------------------------------------------------------------

def test_cancel_queued_request():
    ap = make_ap(batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        blocker = ap.submit(rows(1.0))
        assert st.stalled.wait(5)
        victim = ap.submit(rows(2.0))
        assert victim.cancel() is True
        assert victim.cancelled()
        with pytest.raises(Cancelled):
            victim.result(timeout=1)
        st.release()
        blocker.result(timeout=5)
        assert victim.cancel() is False           # already resolved
        assert ap.stats()["inflight"] == 0
    finally:
        st.release()
        ap.close()


def test_cancel_frees_queue_slot_while_workers_stalled():
    # a cancelled queued entry must be compacted out immediately —
    # with the sole replica stalled, nothing else pops the queue, and
    # a dead entry left in place would keep admission rejecting
    ap = make_ap(queue_depth=1, batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        blocker = ap.submit(rows(1.0))
        assert st.stalled.wait(5)
        victim = ap.submit(rows(2.0))             # fills the queue
        with pytest.raises(Overloaded):
            ap.submit(rows(3.0))
        assert victim.cancel() is True
        assert len(ap._queue) == 0                # slot freed eagerly
        replacement = ap.submit(rows(4.0))        # admission recovered
        st.release()
        blocker.result(timeout=5)
        np.testing.assert_allclose(
            np.asarray(replacement.result(timeout=5)), rows(4.0) * 2.0)
    finally:
        st.release()
        ap.close()


def test_slo_burn_rate_shedding_opens_and_closes(telemetry_on):
    ap = make_ap(slo_ms=50.0, shed_error_budget=0.1,
                 shed_burn_threshold=2.0)
    try:
        for _ in range(10):                       # every request over SLO
            tel.SERVING_REQUEST_SECONDS.observe(0.5)
        ap._shedder.update()
        assert ap._shedder.shedding
        with pytest.raises(Overloaded) as ei:
            ap.submit(rows(1.0))
        assert ei.value.reason == "slo"
        assert tel.SERVING_SHED.value(reason="slo") == 1
        # latency recovers -> burn drops below 1x -> admission reopens
        for _ in range(200):
            tel.SERVING_REQUEST_SECONDS.observe(0.001)
        ap._shedder.update()
        assert not ap._shedder.shedding
        np.testing.assert_allclose(ap.predict(rows(2.0), timeout=5),
                                   rows(2.0) * 2)
    finally:
        ap.close()


def test_burn_rate_shedder_math_on_private_histogram():
    h = tel.Histogram("mxnet_tpu_shed_test_seconds", "t",
                      buckets=(0.01, 0.1, 1.0))
    shed = BurnRateShedder(slo_seconds=0.1, error_budget=0.1,
                           burn_threshold=2.0, window_s=60.0, hist=h)
    tel.enable()
    try:
        assert shed.update(now=0.0) is False      # no traffic
        for _ in range(99):
            h.observe(0.001)
        h.observe(0.5)                            # 1% over SLO -> 0.1x
        assert shed.update(now=1.0) is False
        for _ in range(100):
            h.observe(0.5)                        # burn >> threshold
        assert shed.update(now=2.0) is True
        for _ in range(2000):
            h.observe(0.001)                      # dilute under 1x
        assert shed.update(now=3.0) is False
    finally:
        tel.disable()


def test_close_drains_inflight_then_rejects(telemetry_on):
    ap = make_ap(queue_depth=16, batch_window_ms=1.0)
    try:
        futs = [ap.submit(rows(float(i))) for i in range(6)]
        ap.close(drain=True, timeout=10)
        for i, f in enumerate(futs):
            assert f.done()
            np.testing.assert_allclose(f.result(0), rows(float(i)) * 2)
        with pytest.raises(Overloaded) as ei:
            ap.submit(rows(9.0))
        assert ei.value.reason == "shutdown"
        assert tel.SERVING_IN_FLIGHT.value() == 0
    finally:
        ap.close()


def test_close_without_drain_cancels_queued():
    ap = make_ap(queue_depth=8, batch_window_ms=1.0)
    st = stall(ap._replicas[0].pred)
    try:
        ap.submit(rows(1.0))
        assert st.stalled.wait(5)
        queued = ap.submit(rows(2.0))
        st.release()
        ap.close(drain=False)
        assert isinstance(queued.exception(timeout=1),
                          (Cancelled, type(None))) or queued.done()
    finally:
        st.release()
        ap.close()


def test_request_spans_open_and_close(telemetry_on):
    tracing.enable()
    tracing.reset()
    try:
        with make_ap(batch_window_ms=1.0) as ap:
            ap.predict(rows(1.0), timeout=5)
        recs = [r for r in tracing.chrome_trace_payload(
            include_profiler=False)["traceEvents"]
            if r.get("name") == "serving.async.request"]
        assert recs, "request span missing from trace"
        assert not tracing._active, "request span left open"
    finally:
        tracing.reset()
        tracing.disable()


def test_from_block_multi_replica_devices():
    """Two replicas of one block placed round-robin over the current
    context's devices (both on the one CPU here, as two replicas share
    one card), each with its own committed parameters."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential()
    net.add(nn.Dense(8, activation="relu"), nn.Dense(3))
    net.initialize(ctx=CPU)
    example = np.random.rand(4, 6).astype(np.float32)
    with CPU:
        ap = AsyncPredictor.from_block(net, example, replicas=2, chain=2,
                                       batch_window_ms=1.0,
                                       sweep_interval_s=10.0)
    try:
        preds = [r.pred for r in ap._replicas]
        assert [p.device.type for p in preds] == ["cpu", "cpu"]
        assert preds[0]._params[0].data_ptr() != \
            preds[1]._params[0].data_ptr()
        b = np.random.rand(2, 6).astype(np.float32)
        out = ap.predict(b, timeout=10)
        ref = net(nd.array(b, ctx=CPU)).asnumpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    finally:
        ap.close()


# ---------------------------------------------------------------------------
# warm pool + auto-heal probes (PR 8)
# ---------------------------------------------------------------------------

def _wait_for(cond, timeout=10.0, tick=None):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if cond():
            return True
        if tick is not None:
            tick()
        time.sleep(0.02)
    return False


def test_warm_pool_replaces_ejected_replica(telemetry_on):
    # chaos: the replica's compiled chain raises AND its canary fails
    # (device-level fault) -> ejection -> the pre-built spare is
    # canary-verified and installed without any operator heal()
    ap = make_ap(warm_pool=1, spare_factory=make_replica)
    try:
        assert ap.stats()["spares"] == 1
        rep = ap._replicas[0]
        rep.pred._jit_chain = faults.StallingCallable(
            rep.pred._jit_chain, exc=RuntimeError("device died"))
        with pytest.raises(ReplicaFailed):
            ap.submit(rows(1.0)).result(timeout=5)
        assert _wait_for(lambda: ap.stats()["healthy_replicas"] == 1)
        # the replacement serves; the pool refilled itself
        out = ap.submit(rows(2.0)).result(timeout=10)
        np.testing.assert_allclose(out, rows(2.0) * 2.0)
        assert _wait_for(lambda: ap.stats()["spares"] == 1)
        assert tel.SERVING_AUTOHEALS.value(mode="warm_pool") == 1
    finally:
        ap.close()


def test_warm_pool_drops_a_spare_that_fails_its_canary(telemetry_on):
    # a sick spare must never be installed (or re-pooled): the replica
    # stays ejected and the service reports unhealthy rather than
    # routing requests into a black hole
    def sick_replica():
        pred = make_replica()
        pred._jit_chain = faults.StallingCallable(
            pred._jit_chain, exc=RuntimeError("spare DOA"))
        return pred

    ap = make_ap(warm_pool=1, spare_factory=sick_replica)
    try:
        rep = ap._replicas[0]
        rep.pred._jit_chain = faults.StallingCallable(
            rep.pred._jit_chain, exc=RuntimeError("device died"))
        with pytest.raises(ReplicaFailed):
            ap.submit(rows(1.0)).result(timeout=5)
        assert _wait_for(lambda: not ap._replicas[0].probing)
        assert ap.stats()["healthy_replicas"] == 0
        assert tel.SERVING_AUTOHEALS.value(mode="warm_pool") == 0
        with pytest.raises(Overloaded):
            ap.submit(rows(1.0))
    finally:
        ap.close()


def test_heal_probe_readmits_after_transient_fault(telemetry_on):
    # chaos: replica fails (canary too), gets ejected, then the device
    # recovers (release) — the periodic canary probe re-admits it with
    # no warm pool and no operator intervention
    ap = make_ap(heal_probe_s=0.01)
    try:
        rep = ap._replicas[0]
        wrapper = faults.StallingCallable(rep.pred._jit_chain,
                                          exc=RuntimeError("flaky"))
        rep.pred._jit_chain = wrapper
        with pytest.raises(ReplicaFailed):
            ap.submit(rows(1.0)).result(timeout=5)
        assert ap.stats()["healthy_replicas"] == 0
        # still sick: a probe fires and fails, replica stays out
        ap.sweep()
        assert _wait_for(lambda: not ap._replicas[0].probing)
        assert ap.stats()["healthy_replicas"] == 0
        wrapper.release()          # device recovers
        assert _wait_for(lambda: ap.stats()["healthy_replicas"] == 1,
                         tick=ap.sweep)
        assert tel.SERVING_AUTOHEALS.value(mode="probe") == 1
        out = ap.submit(rows(3.0)).result(timeout=10)
        np.testing.assert_allclose(out, rows(3.0) * 2.0)
    finally:
        ap.close()


def test_warm_pool_requires_factory():
    with pytest.raises(ValueError, match="spare_factory"):
        AsyncPredictor([make_replica()], warm_pool=1)


def test_warm_pool_spare_contract_mismatch_fails_fast():
    def wrong():
        return Predictor(lambda x, p: x * 2.0, [], chain=CHAIN,
                         batch_shape=(B + 1, 3), batch_dtype=np.float32,
                         device=CPU)

    with pytest.raises(ValueError, match="contract"):
        AsyncPredictor([make_replica()], warm_pool=1, spare_factory=wrong)


def test_healed_replica_serves_while_old_worker_still_stalled(telemetry_on):
    # the stall watchdog ejects a replica whose worker thread is
    # BLOCKED inside the device call; the warm-pool healer installs a
    # spare — a fresh worker must start immediately (the stuck thread
    # cannot consume), and when the stall finally releases, the
    # superseded thread must exit instead of double-serving
    ap = make_ap(warm_pool=1, spare_factory=make_replica,
                 stall_timeout_s=0.05)
    try:
        rep = ap._replicas[0]
        wrapper = stall(rep.pred)
        f1 = ap.submit(rows(1.0))
        assert wrapper.stalled.wait(5)         # worker is now stuck
        stuck_thread = rep.thread
        # watchdog fires after stall_timeout_s -> ejection (counted: the
        # healer may install the spare before a poll sees 0 healthy)
        assert _wait_for(lambda: tel.SERVING_REPLICA_EJECTIONS.value(
            reason="stall") >= 1, tick=ap.sweep)
        # ...then the warm-pool healer installs the spare
        assert _wait_for(lambda: ap.stats()["healthy_replicas"] == 1
                         and tel.SERVING_AUTOHEALS.value(
                             mode="warm_pool") == 1)
        # the stuck worker's start time no longer counts against the
        # installed spare: one ejection, not a re-ejection storm
        for _ in range(3):
            ap.sweep()
        assert tel.SERVING_REPLICA_EJECTIONS.value(reason="stall") == 1
        assert ap.stats()["healthy_replicas"] == 1
        # the healed slot has a NEW worker even though the old thread
        # is still alive inside the stalled call
        assert rep.thread is not stuck_thread
        assert stuck_thread.is_alive()
        # the stalled request itself failed typed at ejection (no
        # healthy retry target existed in that instant) — the warm
        # pool heals the REPLICA, not an already-failed request
        with pytest.raises(ReplicaFailed):
            f1.result(10)
        out = ap.submit(rows(5.0)).result(timeout=10)
        np.testing.assert_allclose(out, rows(5.0) * 2.0)
        wrapper.release()                      # old device call returns
        stuck_thread.join(timeout=5)
        assert not stuck_thread.is_alive()     # superseded -> exited
        out = ap.submit(rows(6.0)).result(timeout=10)
        np.testing.assert_allclose(out, rows(6.0) * 2.0)
    finally:
        ap.close()


# ---------------------------------------------------------------------------
# BurnRateShedder against the JAX package's
# ---------------------------------------------------------------------------

def test_burn_rate_shedder_decisions_match_jax():
    """The same observations into a port and a JAX histogram of the same
    buckets: every update's decision and burn rate equal, across the
    opening threshold, the hysteresis band, a window that slides past
    old snapshots, and an idle window."""
    buckets = (0.005, 0.05, 0.1, 0.25, 1.0)
    th = tel.Histogram("mxnet_tpu_shed_parity_seconds", "t",
                       buckets=buckets)
    jh = jtel.Histogram("mxnet_tpu_shed_parity_seconds", "t",
                        buckets=buckets)
    kw = dict(slo_seconds=0.08, error_budget=0.05, burn_threshold=3.0,
              window_s=5.0)
    tel.enable()
    jtel.enable()
    try:
        tshed = BurnRateShedder(hist=th, **kw)
        jshed = jserving_async.BurnRateShedder(hist=jh, **kw)
        t0 = time.monotonic()
        rng = np.random.RandomState(5)
        script = [(1.0, [0.001] * 50), (2.0, [0.3] * 2),
                  (3.0, [0.3] * 12), (4.0, [0.01] * 40),
                  (5.0, [0.07, 0.09, 0.1, 0.11]), (6.5, [0.02] * 30),
                  (12.0, []), (13.0, list(rng.exponential(0.05, 80))),
                  (14.0, [0.5] * 30), (15.0, [0.004] * 400),
                  (40.0, [])]
        decisions = []
        for dt, obs in script:
            for v in obs:
                th.observe(v)
                jh.observe(v)
            t = tshed.update(now=t0 + dt)
            j = jshed.update(now=t0 + dt)
            assert t == j, (dt, tshed.burn, jshed.burn)
            assert tshed.burn == pytest.approx(jshed.burn, rel=1e-12,
                                               abs=0.0), dt
            decisions.append(t)
        assert True in decisions and decisions[-1] is False
        assert decisions.index(True) > 0
    finally:
        tel.disable()
        jtel.disable()


def test_tensor_requests_pack_on_their_device():
    """Requests already on the replica's device pack into one batch
    there (torch.cat), as numpy ones pack on the host."""
    import torch

    ap = make_ap(batch_window_ms=100.0)
    try:
        with ap._cond:          # both queued before a worker claims
            fa = ap.submit(torch.from_numpy(rows(1.0, 2.0)))
            fb = ap.submit(torch.from_numpy(rows(3.0)))
        np.testing.assert_allclose(fa.result(5), rows(1.0, 2.0) * 2)
        np.testing.assert_allclose(fb.result(5), rows(3.0) * 2)
    finally:
        ap.close()
