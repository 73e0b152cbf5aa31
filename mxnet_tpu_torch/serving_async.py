"""Overload-safe async serving tier (parity: mxnet_tpu/serving_async.py):
continuous batching over :class:`serving.Predictor` replicas with
admission control, deadlines, and chaos-tested degradation.

* **Bounded request queue** (``MXNET_SERVING_QUEUE``): a full queue
  rejects with a typed :class:`Overloaded` error instead of growing
  latency without bound.  In-process callers that prefer waiting pass
  ``block=True`` (cooperative backpressure).
* **Continuous batch forming**: requests carry 1..B rows; the batch
  former packs whole requests into B-row batches and up to ``chain``
  batches into one dispatch, firing on *size-or-deadline* — a full
  chunk dispatches immediately, a partial one after ``batch_window_ms``
  or sooner when a member's deadline is close.
* **Per-request deadlines with cancellation**
  (``MXNET_SERVING_DEADLINE_MS`` or per-submit): an expired request
  fails with :class:`DeadlineExceeded` — swept in the queue, dropped at
  pickup, failed mid-dispatch by the sweeper, or rejected on late
  completion — and the queue keeps serving everyone else.
  :meth:`ServingFuture.cancel` retracts a request the same way.
* **Replica health**: one worker thread per replica (replicas may share
  one card; each has its own upload stream).  A dispatch that raises
  ejects the replica and requeues its requests onto healthy replicas,
  unless the replica still answers a known-good canary batch (then the
  request was at fault and fails typed); an optional watchdog
  (``stall_timeout_s``) does the same for a dispatch that hangs.  A
  warm pool (``warm_pool``, ``spare_factory``) installs a
  canary-verified spare into an ejected slot, a heal probe
  (``heal_probe_s``) re-admits a replica whose fault passed, and
  :meth:`AsyncPredictor.heal` returns a replica to rotation.
* **SLO burn-rate shedding**: :class:`BurnRateShedder` watches the
  ``SERVING_REQUEST_SECONDS`` histogram (telemetry must be on) and sheds
  at admission while the over-SLO fraction burns the error budget
  faster than ``burn_threshold``x.  ``generate.TokenServer`` sheds with
  it over the time-to-first-token histogram.
* **Drain on shutdown**: :meth:`AsyncPredictor.close` stops admission,
  drains in-flight requests, then joins the workers; anything left
  (timeout, no healthy replicas) fails with a typed :class:`Cancelled`.
* **Gateway rows**: the gateway's predict route parses ``rows`` as f32;
  :class:`ContractRows` casts them to an AsyncPredictor's batch dtype
  (a uint8 image contract, say) before ``submit``.

Every degradation path increments its telemetry series
(``SERVING_SHED{reason}``, ``SERVING_DEADLINE_EXCEEDED{stage}``,
``SERVING_REPLICA_EJECTIONS``, queue depth and wait), emits one
``serving_request`` wide event a request, and feeds the ``serving``
``/statusz`` subsystem and ``/healthz`` readiness.  The worker, sweeper,
healer and probe threads are host code over ``Predictor.predict``; the
device work is the predictor's.
"""
from __future__ import annotations

import collections
import logging
import threading
import time
import weakref

import numpy as np
import torch

from . import config as _config
from . import events as _events
from . import telemetry as _telemetry
from . import tracing as _tracing
from .serving import Predictor, _np_dtype

__all__ = ["AsyncPredictor", "ContractRows", "ServingFuture",
           "BurnRateShedder", "ServingError", "Overloaded", "DeadlineExceeded", "Cancelled",
           "ReplicaFailed"]

_logger = logging.getLogger("mxnet_tpu_torch.serving_async")

_UNSET = object()

# live AsyncPredictors (weak: a dropped predictor leaves the snapshot)
# feeding the /statusz serving subsystem and the /healthz readiness
# contract: a process with a serving tier is ready only while at least
# one predictor is open with a healthy replica — readiness flips to
# 503 during drained shutdown and stays 200 for non-serving processes.
# The lock serializes explicit add/discard/iterate across threads (a
# probe hitting the scrape thread mid-construction must not read a
# spurious 503 from 'set changed size during iteration'; GC removals
# are already iteration-safe via WeakSet's own deferral).
_live_predictors = weakref.WeakSet()
_live_lock = threading.Lock()


def _live_snapshot():
    with _live_lock:
        return list(_live_predictors)


def _serving_statusz():
    return {"predictors": [p.stats() for p in _live_snapshot()]}


def _serving_ready():
    preds = _live_snapshot()
    if not preds:
        return True
    return any(p.is_ready() for p in preds)


_telemetry.register_status_provider("serving", _serving_statusz)
_telemetry.register_readiness("serving", _serving_ready)


# ---------------------------------------------------------------------------
# typed errors — the contract callers degrade through
# ---------------------------------------------------------------------------

class ServingError(RuntimeError):
    """Base of every typed async-serving failure."""


class Overloaded(ServingError):
    """Request rejected at admission.  ``reason`` is one of ``queue``
    (queue full), ``inflight`` (in-flight cap), ``wait`` (estimated
    wait exceeds the SLO/deadline budget), ``slo`` (burn-rate
    shedding), ``unhealthy`` (no healthy replica), ``shutdown``
    (predictor closed), or — from the decode tier
    (``generate.TokenServer``) — ``slots`` (every KV-cache lane busy).
    Retryable by the client after backoff (HTTP mapping: 429)."""

    def __init__(self, reason, detail=""):
        super().__init__("overloaded (%s)%s"
                         % (reason, ": " + detail if detail else ""))
        self.reason = reason


class DeadlineExceeded(ServingError):
    """Request failed by its deadline.  ``stage`` says where: ``queue``
    (swept while waiting), ``pickup`` (expired when the batch former
    reached it), ``dispatch`` (expired while a replica computed),
    ``completion`` (result arrived too late to honor).  The decode
    tier (``generate.TokenServer``) tags ``prefill`` (expired waiting
    for, or during, prompt prefill) vs ``decode`` (expired
    mid-generation; the slot is evicted) so the HTTP front end maps
    both predict and per-token failures to 504 uniformly."""

    def __init__(self, stage, detail=""):
        super().__init__("deadline exceeded (%s)%s"
                         % (stage, ": " + detail if detail else ""))
        self.stage = stage


class Cancelled(ServingError):
    """Request retracted — by :meth:`ServingFuture.cancel` or by a
    non-drained shutdown."""


class ReplicaFailed(ServingError):
    """Every retry landed on a failing replica (or none were left)."""

    def __init__(self, msg, cause=None):
        super().__init__(msg)
        self.cause = cause


# ---------------------------------------------------------------------------
# future
# ---------------------------------------------------------------------------

class ServingFuture:
    """Resolution handle for one submitted request.

    Thread-safe, first-writer-wins: the worker, the deadline sweeper,
    and :meth:`cancel` may race to resolve; exactly one outcome sticks.
    """

    __slots__ = ("_ev", "_lock", "_result", "_exc", "_owner", "_req",
                 "resolved_at")

    def __init__(self, owner=None, req=None):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._exc = None
        self._owner = owner
        self._req = req
        self.resolved_at = None     # monotonic resolution time: load
                                    # harnesses read latency after the
                                    # fact without a waiter per request

    def _resolve(self, result=None, exc=None):
        """First writer wins; returns whether this call resolved it."""
        with self._lock:
            if self._ev.is_set():
                return False
            self._result = result
            self._exc = exc
            self.resolved_at = time.monotonic()
            self._ev.set()
            # drop the request ref: a caller holding futures to join
            # later (e.g. a load harness) must not retain every
            # submitted payload (future -> req -> batch) after
            # resolution.  In-flight dispatch is unaffected — workers
            # hold the request directly, not through the future.
            self._owner = None
            self._req = None
            return True

    def done(self):
        return self._ev.is_set()

    def cancelled(self):
        return self._ev.is_set() and isinstance(self._exc, Cancelled)

    def cancel(self):
        """Retract the request: dequeued if still waiting, result
        dropped if already dispatched (device work is not interrupted).
        Returns False when the request already resolved."""
        owner, req = self._owner, self._req
        if owner is None or req is None:
            return self._resolve(exc=Cancelled("request cancelled"))
        return owner._cancel(req)

    def result(self, timeout=None):
        """Block for the outcome; raises the typed serving error on
        failure, ``TimeoutError`` if ``timeout`` elapses first."""
        if not self._ev.wait(timeout):
            raise TimeoutError("request not resolved within %r s"
                               % (timeout,))
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self, timeout=None):
        if not self._ev.wait(timeout):
            raise TimeoutError("request not resolved within %r s"
                               % (timeout,))
        return self._exc


class _Request:
    __slots__ = ("batch", "rows", "future", "t_submit", "deadline",
                 "span", "retries", "state", "replica", "t_pickup")

    def __init__(self, batch, rows, deadline, span):
        self.batch = batch
        self.rows = rows
        self.future = None
        self.t_submit = time.monotonic()
        self.deadline = deadline
        self.span = span
        self.retries = 0
        self.state = "queued"      # queued -> claimed -> done
        self.replica = None
        self.t_pickup = None       # batch-former claim time (the
                                   # queue/dispatch stage split of the
                                   # request's wide event)


class _Replica:
    __slots__ = ("pred", "idx", "healthy", "busy_since", "thread",
                 "reason", "ejected_at", "probing", "last_probe")

    def __init__(self, pred, idx):
        self.pred = pred
        self.idx = idx
        self.healthy = True
        self.busy_since = None     # monotonic start of current dispatch
        self.thread = None
        self.reason = None
        self.ejected_at = None     # monotonic time of last ejection
        self.probing = False       # a heal probe/replacement in flight
        self.last_probe = None     # monotonic time of last heal probe


def _concat(parts):
    """Rows of several requests as one batch: on their device when every
    part is a tensor there, else on the host."""
    import torch

    from .ndarray.ndarray import NDArray

    parts = [p._data if isinstance(p, NDArray) else p for p in parts]
    if all(isinstance(p, torch.Tensor) for p in parts) and \
            len({p.device for p in parts}) == 1:
        return torch.cat(parts, 0)
    return np.concatenate(
        [p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
         for p in parts], axis=0)


# ---------------------------------------------------------------------------
# SLO burn-rate shedder
# ---------------------------------------------------------------------------

class BurnRateShedder:
    """Load shedding driven off the ``SERVING_REQUEST_SECONDS``
    histogram.

    Over a sliding ``window_s`` it tracks the fraction of completed
    requests slower than ``slo_seconds`` (bucket-quantized: a request
    counts as within SLO when it landed in a bucket whose upper bound
    is <= the smallest bucket >= the SLO).  Burn rate = that fraction
    divided by ``error_budget``.  Shedding starts at
    ``burn_threshold``x and stops only when the burn drops below 1x
    (hysteresis, so admission does not flap at the threshold).

    Requires telemetry to be enabled — with collection off the
    histogram never moves and the shedder never fires.

    The default histogram is process-global: every Predictor in the
    process observes into it, so in a multi-model process one slow
    model's latency would shed an unrelated healthy one.  Such
    deployments should give each AsyncPredictor its own series via
    ``shed_hist=`` (a private ``telemetry.Histogram``) and have their
    request path observe into it.
    """

    def __init__(self, slo_seconds, error_budget=0.1, burn_threshold=2.0,
                 window_s=30.0, hist=None):
        if slo_seconds <= 0:
            raise ValueError("slo_seconds must be > 0, got %r"
                             % (slo_seconds,))
        if not 0 < error_budget <= 1:
            raise ValueError("error_budget must be in (0, 1], got %r"
                             % (error_budget,))
        self._hist = hist if hist is not None \
            else _telemetry.SERVING_REQUEST_SECONDS
        self._slo = float(slo_seconds)
        self._budget = float(error_budget)
        self._threshold = float(burn_threshold)
        self._window = float(window_s)
        self._snaps = collections.deque()   # (t, total, over)
        self.shedding = False
        self.burn = 0.0
        # baseline snapshot: the first real update() must measure the
        # burn since construction, not compare a snapshot to itself
        total, over = self._counts()
        self._snaps.append((time.monotonic(), total, over))

    def _counts(self):
        cum = self._hist.cumulative()
        total = cum[-1][1]
        within = 0
        for ub, c in cum:
            if ub >= self._slo:
                within = c
                break
        return total, total - within

    def update(self, now=None):
        """Take a snapshot and recompute the shed decision; called by
        the sweeper each tick (and directly by tests)."""
        now = time.monotonic() if now is None else now
        total, over = self._counts()
        self._snaps.append((now, total, over))
        while len(self._snaps) > 1 and \
                now - self._snaps[0][0] > self._window:
            self._snaps.popleft()
        _t0, total0, over0 = self._snaps[0]
        d_total = total - total0
        d_over = over - over0
        if d_total <= 0:
            self.burn = 0.0
            self.shedding = False
            return self.shedding
        self.burn = (d_over / d_total) / self._budget
        if self.shedding:
            self.shedding = self.burn >= 1.0
        else:
            self.shedding = self.burn >= self._threshold
        return self.shedding


# ---------------------------------------------------------------------------
# the async predictor
# ---------------------------------------------------------------------------

class AsyncPredictor:
    """Continuous-batching async front end over Predictor replicas.

    ``replicas`` is one :class:`serving.Predictor` or a list of them
    (:meth:`from_block` builds them).  Every replica
    must carry the same pinned batch contract (``batch_shape`` /
    ``batch_dtype``) — the batch former packs rows from many requests
    into one device batch, so an unpinned contract would let one
    garbage request poison a whole formed batch.

    ``submit`` returns a :class:`ServingFuture`; ``predict`` is the
    blocking convenience.  See the module docstring for the degradation
    contract.
    """

    def __init__(self, replicas, queue_depth=None, deadline_ms=None,
                 max_inflight=None, batch_window_ms=2.0, max_retries=1,
                 slo_ms=None, shed_error_budget=0.1, shed_burn_threshold=2.0,
                 shed_window_s=30.0, shed_hist=None, stall_timeout_s=None,
                 sweep_interval_s=0.01, warm_pool=None, spare_factory=None,
                 heal_probe_s=None):
        preds = list(replicas) if isinstance(replicas, (list, tuple)) \
            else [replicas]
        if not preds:
            raise ValueError("AsyncPredictor needs at least one replica")
        shapes = {tuple(p.batch_shape) if p.batch_shape else None
                  for p in preds}
        dtypes = {_np_dtype(p.batch_dtype) if p.batch_dtype is not None
                  else None for p in preds}
        if None in shapes or len(shapes) != 1 or len(dtypes) != 1:
            raise ValueError(
                "every replica must pin the SAME batch contract "
                "(batch_shape=/batch_dtype= or from_block); got shapes "
                "%r dtypes %r — continuous batching packs rows from "
                "many requests into one compiled batch" % (shapes, dtypes))
        self._replicas = [_Replica(p, i) for i, p in enumerate(preds)]
        self._contract_shape = next(iter(shapes))
        self._contract_dtype = next(iter(dtypes))
        self._rows = self._contract_shape[0]

        if queue_depth is None:
            queue_depth = _config.get("MXNET_SERVING_QUEUE")
        self._depth = int(queue_depth)
        if self._depth < 1:
            raise ValueError("queue_depth must be >= 1, got %r"
                             % (queue_depth,))
        if deadline_ms is None:
            deadline_ms = _config.get("MXNET_SERVING_DEADLINE_MS")
        self._deadline_s = float(deadline_ms) / 1e3 if deadline_ms else None
        if max_inflight is None:
            max_inflight = _config.get("MXNET_SERVING_MAX_INFLIGHT")
        if not max_inflight:
            # auto: the queue plus two full dispatch pipelines per
            # replica — binds when dispatches are stuck (stalls), not
            # before the queue knob gets a say.  Pipeline capacity is
            # counted in REQUESTS: one dispatch claims up to chain
            # B-row batches, each packing up to B single-row requests.
            max_inflight = self._depth + 2 * self._rows * sum(
                r.pred.chain for r in self._replicas)
        self._max_inflight = int(max_inflight)
        self._window = max(0.0, float(batch_window_ms) / 1e3)
        self._max_retries = int(max_retries)
        self._slo_s = float(slo_ms) / 1e3 if slo_ms else None
        self._stall_timeout = float(stall_timeout_s) \
            if stall_timeout_s else None
        self._shedder = None
        if self._slo_s is not None:
            self._shedder = BurnRateShedder(
                self._slo_s, error_budget=shed_error_budget,
                burn_threshold=shed_burn_threshold,
                window_s=shed_window_s, hist=shed_hist)

        self._cond = threading.Condition()
        self._queue = collections.deque()
        self._claimed = set()
        self._queued_rows = 0
        self._inflight = 0
        self._running = True
        self._closed = False
        self._ewma_chunk_s = None     # measured seconds per dispatch

        # warm pool: N spare replicas pre-built (through the AOT store
        # when the factory enables it) so an ejection installs a
        # canary-verified spare instead of waiting for operator heal();
        # a periodic heal probe (heal_probe_s) re-admits ejected
        # replicas whose fault was transient.
        if warm_pool is None:
            warm_pool = _config.get("MXNET_SERVING_WARM_POOL")
        warm_pool = int(warm_pool)
        if warm_pool > 0 and spare_factory is None:
            raise ValueError(
                "warm_pool=%d needs spare_factory= (a callable "
                "returning a contract-matching serving.Predictor); "
                "from_block builds one automatically" % warm_pool)
        self._spare_factory = spare_factory
        self._spares = []
        for _ in range(warm_pool):
            self._spares.append(self._build_spare())
        _telemetry.SERVING_WARM_POOL_SPARES.set(len(self._spares))
        if heal_probe_s is None:
            heal_probe_s = _config.get("MXNET_SERVING_HEAL_PROBE")
        self._heal_probe_s = float(heal_probe_s) if heal_probe_s else None

        _telemetry.SERVING_REPLICAS_HEALTHY.set(len(self._replicas))
        for rep in self._replicas:
            self._start_worker(rep)
        self._sweep_stop = threading.Event()
        self._sweep_interval = float(sweep_interval_s)
        self._sweeper = threading.Thread(
            target=self._sweep_loop, name="serving-sweeper", daemon=True)
        self._sweeper.start()
        with _live_lock:
            _live_predictors.add(self)

    # -- construction ----------------------------------------------------

    @classmethod
    def from_block(cls, net, example_input, replicas=1, chain=8,
                   preprocess=None, postprocess=None, aot=None,
                   aot_spec=None, dtype_policy=None, **kwargs):
        """Build ``replicas`` Predictor replicas from a gluon block,
        placed round-robin over the cards when the current context is a
        card (several replicas may share one), else on the current
        context's device, and wrap them.  The same builder becomes the
        warm pool's ``spare_factory`` (spares continue the round-robin
        placement), so ``warm_pool=N`` works out of the box.
        ``kwargs`` go to :class:`AsyncPredictor`."""
        import torch

        from .context import current_context

        dev = current_context().torch_device
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())] \
            if dev.type == "cuda" else [dev]
        counter = [0]

        def build():
            i = counter[0]
            counter[0] += 1
            pred, _ = Predictor.from_block(
                net, example_input, chain=chain, preprocess=preprocess,
                postprocess=postprocess, device=devs[i % len(devs)],
                aot=aot, aot_spec=aot_spec, dtype_policy=dtype_policy)
            return pred

        preds = [build() for _ in range(int(replicas))]
        kwargs.setdefault("spare_factory", build)
        return cls(preds, **kwargs)

    def _build_spare(self):
        """One warm-pool spare: built by the factory, contract-checked,
        and pre-warmed through the AOT store when available (best
        effort — a spare that could not pre-compile still works, it
        just pays the compile at install)."""
        pred = self._spare_factory()
        if tuple(pred.batch_shape or ()) != self._contract_shape or \
                _np_dtype(pred.batch_dtype) != self._contract_dtype:
            raise ValueError(
                "spare_factory built a replica with contract %r/%r, "
                "pool contract is %r/%r"
                % (pred.batch_shape, pred.batch_dtype,
                   self._contract_shape, self._contract_dtype))
        try:
            pred.prewarm()
        except Exception:
            pass  # AOT off or unpinnable: the spare compiles on install
        return pred

    # -- admission -------------------------------------------------------

    def _validate(self, batch):
        """Contract checks at the door: a bad request must fail its own
        submit, never poison a formed batch and eject a healthy
        replica.  Returns (batch, rows)."""
        if not hasattr(batch, "shape") or not hasattr(batch, "dtype"):
            batch = np.asarray(batch)
        if _np_dtype(batch) != self._contract_dtype:
            raise TypeError("batch dtype %s != compiled dtype %s"
                            % (_np_dtype(batch), self._contract_dtype))
        shape = tuple(batch.shape)
        if len(shape) != len(self._contract_shape) or \
                shape[1:] != self._contract_shape[1:]:
            raise ValueError(
                "batch shape %s incompatible with compiled shape %s: "
                "only the leading (batch) dim may vary"
                % (shape, self._contract_shape))
        rows = shape[0]
        if not 1 <= rows <= self._rows:
            raise ValueError(
                "request rows must be in [1, %d], got %d"
                % (self._rows, rows))
        return batch, rows

    def _healthy_count_locked(self):
        return sum(1 for r in self._replicas if r.healthy)

    def _est_wait_locked(self):
        """Expected queue service time: queued rows over aggregate
        dispatch bandwidth (EWMA-measured; 0 until first dispatch)."""
        if self._ewma_chunk_s is None or not self._queued_rows:
            return 0.0
        healthy = self._healthy_count_locked()
        if not healthy:
            return float("inf")
        rows_per_dispatch = sum(
            r.pred.chain for r in self._replicas if r.healthy) \
            * self._rows / healthy
        chunks = self._queued_rows / rows_per_dispatch
        return chunks * self._ewma_chunk_s / healthy

    def _admission_error_locked(self, deadline, now):
        if self._closed or not self._running:
            return Overloaded("shutdown")
        if not self._healthy_count_locked():
            return Overloaded("unhealthy", "all replicas ejected")
        if self._shedder is not None and self._shedder.shedding:
            return Overloaded(
                "slo", "burn rate %.2fx" % self._shedder.burn)
        budget = self._slo_s
        if deadline is not None:
            remaining = deadline - now
            budget = remaining if budget is None \
                else min(budget, remaining)
        if budget is not None:
            est = self._est_wait_locked()
            if est > budget:
                return Overloaded(
                    "wait", "estimated wait %.3fs > budget %.3fs"
                    % (est, budget))
        if len(self._queue) >= self._depth:
            return Overloaded("queue", "depth %d" % self._depth)
        if self._inflight >= self._max_inflight:
            return Overloaded("inflight", "cap %d" % self._max_inflight)
        return None

    def submit(self, batch, deadline_ms=_UNSET, block=False,
               timeout=None):
        """Admit one request (1..B rows matching the contract's
        trailing dims/dtype) and return its :class:`ServingFuture`.

        Non-blocking by default: admission failure raises a typed
        :class:`Overloaded` immediately.  ``block=True`` turns
        queue/inflight rejection into cooperative backpressure — wait
        up to ``timeout`` seconds for space (shed reasons ``slo``,
        ``wait``, ``unhealthy``, ``shutdown`` still raise immediately:
        waiting cannot help them).  ``deadline_ms`` overrides the
        predictor-level default; pass ``None``/0 for no deadline.
        """
        batch, rows = self._validate(batch)
        now = time.monotonic()
        if deadline_ms is _UNSET:
            deadline_s = self._deadline_s
        else:
            deadline_s = float(deadline_ms) / 1e3 if deadline_ms else None
        deadline = now + deadline_s if deadline_s is not None else None

        span = _tracing.begin("serving.async.request", activate=False,
                              args={"rows": rows}) \
            if _tracing.enabled() else None
        wait_until = now + timeout if timeout is not None else None
        with self._cond:
            while True:
                err = self._admission_error_locked(deadline,
                                                   time.monotonic())
                if err is None:
                    break
                blockable = err.reason in ("queue", "inflight")
                if not block or not blockable:
                    self._shed(err, span)
                    raise err
                remaining = None
                if wait_until is not None:
                    remaining = wait_until - time.monotonic()
                    if remaining <= 0:
                        self._shed(err, span)
                        raise err
                # backpressure: sleep until a worker frees capacity
                self._cond.wait(remaining if remaining is not None
                                else 0.1)
            req = _Request(batch, rows, deadline, span)
            req.future = ServingFuture(owner=self, req=req)
            self._queue.append(req)
            self._queued_rows += rows
            self._inflight += 1
            _telemetry.SERVING_ASYNC_REQUESTS.inc()
            _telemetry.SERVING_QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()
        return req.future

    def _shed(self, err, span):
        _telemetry.SERVING_SHED.inc(reason=err.reason)
        if span is not None:
            span.set(shed=err.reason).end(error=True)
        if _events.enabled():
            _events.emit("serving_request", outcome="shed",
                         reason=err.reason,
                         span_id=span.span_id if span is not None
                         else None)

    def predict(self, batch, deadline_ms=_UNSET, timeout=None):
        """Blocking convenience: backpressure-admitting ``submit`` +
        ``result``.  ``timeout`` is one overall budget covering both
        the admission wait and the result wait.  Raises the typed
        serving errors."""
        t_end = time.monotonic() + timeout if timeout is not None \
            else None
        fut = self.submit(batch, deadline_ms=deadline_ms, block=True,
                          timeout=timeout)
        remaining = None
        if t_end is not None:
            remaining = max(0.0, t_end - time.monotonic())
        return fut.result(remaining)

    # -- resolution (all under self._cond) -------------------------------

    def _finish_locked(self, req, result=None, exc=None):
        """Resolve a request exactly once; returns False when someone
        (worker / sweeper / cancel) already did."""
        if req.state == "done":
            return False
        if req.state == "queued":
            self._queued_rows -= req.rows
        req.state = "done"
        self._inflight -= 1
        # account BEFORE resolving: result() wakes the client the
        # instant _resolve runs, and the client may read the counters
        # without taking self._cond
        if isinstance(exc, DeadlineExceeded):
            _telemetry.SERVING_DEADLINE_EXCEEDED.inc(stage=exc.stage)
        if _events.enabled():
            self._emit_event(req, exc)
        req.future._resolve(result=result, exc=exc)
        if req.span is not None:
            if exc is not None:
                req.span.set(error=type(exc).__name__)
            req.span.end(error=exc is not None)
        if exc is not None and not isinstance(exc, Cancelled):
            _logger.warning("serving request %s failed: %s",
                            req.span.span_id if req.span else "-", exc)
        self._cond.notify_all()
        return True

    def _emit_event(self, req, exc):
        """One wide event per resolved request (exactly once:
        _finish_locked's state guard already ran).  Outcome taxonomy:
        ok / deadline{stage} / evicted{reason=cancelled} /
        error{kind}; sheds emit at admission in :meth:`_shed`."""
        now = time.monotonic()
        stages = {"queue": (req.t_pickup - req.t_submit)
                  if req.t_pickup is not None else now - req.t_submit}
        if req.t_pickup is not None:
            stages["dispatch"] = now - req.t_pickup
        kw = {"outcome": "ok"}
        if isinstance(exc, DeadlineExceeded):
            kw = {"outcome": "deadline", "stage": exc.stage}
        elif isinstance(exc, Cancelled):
            kw = {"outcome": "evicted", "reason": "cancelled"}
        elif exc is not None:
            kw = {"outcome": "error",
                  "error_kind": type(exc).__name__}
        _events.emit(
            "serving_request", dur_s=now - req.t_submit,
            stages_s=stages, rows=req.rows,
            retries=req.retries or None, replica=req.replica,
            span_id=req.span.span_id if req.span is not None else None,
            **kw)

    def _cancel(self, req):
        with self._cond:
            if req.state == "done":
                return False
            was_queued = req.state == "queued"
            ok = self._finish_locked(
                req, exc=Cancelled("request cancelled"))
            if was_queued:
                # compact eagerly: with all workers stalled nothing
                # else pops the queue, and a dead entry left in place
                # keeps occupying an admission slot + the depth gauge
                self._compact_queue_locked()
            # claimed device work cannot be recalled
            return ok

    def _compact_queue_locked(self):
        """Drop resolved (cancelled/expired) entries so the depth gauge
        and admission see live requests only."""
        if any(r.state == "done" for r in self._queue):
            self._queue = collections.deque(
                r for r in self._queue if r.state != "done")
        _telemetry.SERVING_QUEUE_DEPTH.set(len(self._queue))

    # -- batch forming / dispatch ----------------------------------------

    def _take_chunk(self, rep):
        """Claim whole queued requests for ``rep`` up to chain formed
        batches of B rows; fires on size-or-deadline.  None = worker
        must exit."""
        chain = rep.pred.chain
        with self._cond:
            # phase 1: block until there is live work (or exit)
            while True:
                if not self._running or not rep.healthy:
                    return None
                if rep.thread is not threading.current_thread():
                    # superseded: a heal installed a fresh worker while
                    # this one was stuck in a stalled device call — two
                    # consumers must not race on one replica
                    return None
                if any(r.state == "queued" for r in self._queue):
                    break
                self._cond.wait(0.05)
            taken = []
            # mirror _form_batches' first-fit while claiming: a raw
            # rows<=chain*B cap would let ragged requests fragment into
            # more than chain batches and silently double the dispatch
            n_batches, cur_fill = 0, 0
            linger_until = time.monotonic() + self._window
            # phase 2: claim + linger until full or window/deadline
            while True:
                now = time.monotonic()
                head_blocked = False
                while self._queue:
                    req = self._queue[0]
                    if req.state != "queued":        # cancelled/swept
                        self._queue.popleft()
                        continue
                    if req.deadline is not None and now >= req.deadline:
                        self._queue.popleft()
                        self._finish_locked(
                            req, exc=DeadlineExceeded("pickup"))
                        continue
                    if n_batches and cur_fill + req.rows <= self._rows:
                        fit = (n_batches, cur_fill + req.rows)
                    else:
                        fit = (n_batches + 1, req.rows)
                    if fit[0] > chain:
                        # FIFO: later arrivals only join the tail, so
                        # once the head doesn't fit nothing ever will —
                        # lingering further is pure dead latency
                        head_blocked = True
                        break
                    n_batches, cur_fill = fit
                    self._queue.popleft()
                    self._queued_rows -= req.rows
                    req.state = "claimed"
                    req.replica = rep.idx
                    req.t_pickup = now
                    self._claimed.add(req)
                    taken.append(req)
                    _telemetry.SERVING_QUEUE_WAIT_SECONDS.observe(
                        now - req.t_submit,
                        exemplar={"trace_id": _tracing.TRACE_ID,
                                  "span_id": req.span.span_id}
                        if req.span is not None else None)
                full = n_batches >= chain and cur_fill >= self._rows
                if full or head_blocked or not self._running:
                    break
                # fire early when a taken request's deadline is nearer
                # than the linger window — holding it for more batching
                # would spend its budget in OUR queue
                fire_at = linger_until
                for r in taken:
                    if r.deadline is not None:
                        fire_at = min(fire_at, r.deadline)
                remaining = fire_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
            _telemetry.SERVING_QUEUE_DEPTH.set(len(self._queue))
        return taken

    def _form_batches(self, reqs):
        """First-fit pack whole requests into <= chain device batches of
        <= B rows; returns (groups, batches)."""
        groups, cur, cur_rows = [], [], 0
        for req in reqs:
            if cur_rows + req.rows > self._rows:
                groups.append(cur)
                cur, cur_rows = [], 0
            cur.append(req)
            cur_rows += req.rows
        if cur:
            groups.append(cur)
        batches = []
        for g in groups:
            if len(g) == 1:
                # single-request batch passes through untouched —
                # device-resident inputs stay on device
                batches.append(g[0].batch)
            else:
                batches.append(_concat([r.batch for r in g]))
        return groups, batches

    def _dispatch(self, rep, reqs):
        with self._cond:
            # drop requests resolved (cancel / deadline sweep) during
            # the linger window: computing their rows would spend
            # device time exactly when the service is overloaded
            live = []
            for req in reqs:
                if req.state == "claimed":
                    live.append(req)
                else:
                    self._claimed.discard(req)
        if not live:
            return
        reqs = live
        total_rows = sum(r.rows for r in reqs)
        rep.busy_since = time.monotonic()
        t0 = time.perf_counter()
        try:
            # _form_batches is inside the guard: a poisoned request
            # payload (e.g. a deleted device buffer) raises here, and
            # an unguarded raise would kill the worker with the whole
            # chunk stranded in state='claimed' forever
            groups, batches = self._form_batches(reqs)
            outs = list(rep.pred.predict(batches))
        except Exception as e:
            rep.busy_since = None
            if self._canary_passes(rep):
                # the device answers a known-good batch, so the failure
                # was induced by this chunk's payload (_validate's
                # invariant: a bad request must never eject a healthy
                # replica).  Fail the chunk typed and keep the replica
                # — requeueing poison would cascade it through every
                # replica and DoS the whole service.
                with self._cond:
                    for req in reqs:
                        if req.replica != rep.idx:
                            continue
                        self._claimed.discard(req)
                        if req.state == "claimed":
                            self._finish_locked(req, exc=ReplicaFailed(
                                "dispatch failed but the replica "
                                "passes a canary batch (request-"
                                "induced failure): %s" % (e,), cause=e))
                    self._cond.notify_all()
            else:
                with self._cond:
                    self._eject_locked(rep, "error", e)
                    self._requeue_or_fail_locked(reqs, e, rep.idx)
            return
        rep.busy_since = None
        dt = time.perf_counter() - t0
        _telemetry.SERVING_DISPATCH_ROWS.observe(total_rows)
        now = time.monotonic()
        try:
            with self._cond:
                # EWMA dispatch time feeds the estimated-wait admission
                # check.  Discard the sample when the stall watchdog
                # ejected this replica mid-dispatch: dt then measures
                # the stall, not the service time, and one such sample
                # would poison admission into mass-shedding a healthy
                # service.
                if rep.healthy:
                    self._ewma_chunk_s = dt \
                        if self._ewma_chunk_s is None \
                        else 0.7 * self._ewma_chunk_s + 0.3 * dt
                requeued = False
                for g, out in zip(groups, outs):
                    ofs = 0
                    for req in g:
                        res = out if len(g) == 1 \
                            else out[ofs:ofs + req.rows]
                        ofs += req.rows
                        self._claimed.discard(req)
                        # the stall watchdog may have requeued this
                        # request mid-dispatch (state back to 'queued',
                        # sitting in self._queue); the late success is
                        # still a valid first-writer resolution, but
                        # the now-dead queue entry must be compacted
                        # out or it occupies an admission slot forever
                        requeued = requeued or req.state == "queued"
                        if req.deadline is not None \
                                and now > req.deadline:
                            self._finish_locked(
                                req, exc=DeadlineExceeded("completion"))
                        else:
                            self._finish_locked(req, result=res)
                if requeued:
                    self._compact_queue_locked()
        except Exception as e:
            # a raise mid-resolution (e.g. slicing a bad output) must
            # not strand the chunk's unresolved requests
            with self._cond:
                self._requeue_or_fail_locked(reqs, e, rep.idx)

    def _canary_passes(self, rep):
        """Distinguish a sick replica from a poisoned request: dispatch
        one known-good (all-zeros) contract batch.  True = the device
        still answers, so the failed chunk's payload was at fault."""
        return self._canary_pred(rep.pred)

    def _canary_pred(self, pred):
        try:
            canary = np.zeros(self._contract_shape, self._contract_dtype)
            list(pred.predict([canary]))
            return True
        except Exception:
            return False

    def canary(self):
        """One known-good contract batch through a healthy replica:
        True when the predictor answers end to end.  The deploy-probe
        entry point (the gateway calls this before flipping a route to
        a new model version); False when no replica is healthy."""
        with self._cond:
            reps = [r for r in self._replicas if r.healthy]
        return any(self._canary_pred(r.pred) for r in reps)

    def _start_worker(self, rep):
        rep.thread = threading.Thread(
            target=self._worker, args=(rep,),
            name="serving-worker-%d" % rep.idx, daemon=True)
        rep.thread.start()

    def _worker(self, rep):
        try:
            while True:
                chunk = self._take_chunk(rep)
                if chunk is None:
                    return
                if chunk:
                    self._dispatch(rep, chunk)
        finally:
            # close the heal() race: heal may have marked the replica
            # healthy after this thread decided to exit but before it
            # unwound — heal's is_alive() check then saw a live thread
            # and skipped the restart.  The exiting worker is the only
            # one who knows it is truly gone, so it either hands the
            # replica a fresh worker or clears its slot (under the
            # lock, and only if heal hasn't already replaced it).
            with self._cond:
                if rep.thread is threading.current_thread():
                    if self._running and rep.healthy:
                        self._start_worker(rep)
                    else:
                        rep.thread = None

    # -- replica health --------------------------------------------------

    def _eject_locked(self, rep, reason, exc=None):
        if not rep.healthy:
            return
        rep.healthy = False
        rep.reason = reason
        rep.ejected_at = time.monotonic()
        rep.last_probe = None
        _telemetry.SERVING_REPLICA_EJECTIONS.inc(reason=reason)
        _telemetry.SERVING_REPLICAS_HEALTHY.set(
            self._healthy_count_locked())
        _logger.error("ejecting replica %d (%s): %s", rep.idx, reason,
                      exc)
        # warm pool: hand the slot a pre-built spare (canary-verified
        # off-lock in a healer thread) instead of waiting for an
        # operator heal() — replica ejection then self-heals
        if self._spares and self._running and not rep.probing:
            rep.probing = True
            threading.Thread(
                target=self._replace_replica, args=(rep,),
                name="serving-healer-%d" % rep.idx, daemon=True).start()
        self._cond.notify_all()

    def _replace_replica(self, rep):
        """Warm-pool healer: canary a spare and install it into the
        ejected slot.  The canary dispatch runs OFF the lock (it is a
        real device call); install/readmit happens under it."""
        with self._cond:
            spare = self._spares.pop() if self._spares else None
            _telemetry.SERVING_WARM_POOL_SPARES.set(len(self._spares))
        consumed = False   # spare installed or dropped -> pool owes one
        try:
            ok = spare is not None and self._canary_pred(spare)
            with self._cond:
                rep.probing = False
                rep.last_probe = time.monotonic()
                if not self._running or spare is None:
                    if spare is not None:
                        self._spares.append(spare)
                        _telemetry.SERVING_WARM_POOL_SPARES.set(
                            len(self._spares))
                    return
                if not ok:
                    # the spare itself fails the canary (device-level
                    # fault): drop it — re-pooling a sick spare would
                    # make every later ejection unhealable.  The pool
                    # still refills below: a transient blip must not
                    # permanently drain it while the factory is healthy.
                    consumed = True
                    _logger.error(
                        "warm-pool spare failed its canary; replica %d "
                        "stays ejected", rep.idx)
                    return
                if rep.healthy:
                    # operator heal() won the race: keep the spare
                    self._spares.append(spare)
                    _telemetry.SERVING_WARM_POOL_SPARES.set(
                        len(self._spares))
                    return
                consumed = True
                rep.pred = spare
                rep.healthy = True
                # the superseded worker may still be blocked in the
                # stalled call: its start time must not make the
                # watchdog eject the fresh worker's replica again
                rep.busy_since = None
                rep.reason = None
                _telemetry.SERVING_AUTOHEALS.inc(mode="warm_pool")
                _telemetry.SERVING_REPLICAS_HEALTHY.set(
                    self._healthy_count_locked())
                _logger.warning(
                    "replica %d re-admitted from the warm pool after a "
                    "successful canary dispatch", rep.idx)
                # unconditional: the old worker may still be alive, blocked
                # inside the stalled device call — it exits via the
                # supersession check in _take_chunk, and a healthy replica
                # must have a live consumer NOW, not when that call returns
                self._start_worker(rep)
                self._cond.notify_all()
        except Exception:
            with self._cond:
                rep.probing = False
            _logger.exception("warm-pool replacement for replica %d "
                              "failed", rep.idx)
            return
        finally:
            # replenish the pool off-lock whenever a spare was consumed
            # (installed OR dropped) — best effort: a failing factory
            # leaves the pool smaller, it never breaks serving
            if consumed and self._spare_factory is not None:
                try:
                    new_spare = self._build_spare()
                except Exception:
                    new_spare = None
                    _logger.exception("warm-pool refill failed")
                if new_spare is not None:
                    with self._cond:
                        if self._running:
                            self._spares.append(new_spare)
                            _telemetry.SERVING_WARM_POOL_SPARES.set(
                                len(self._spares))

    def _probe_replica(self, rep):
        """Auto-heal probe: canary the *ejected* replica itself (off
        the lock) and re-admit it on success — heals transient faults
        (a released stall, a recovered device) without spending a
        spare."""
        ok = self._canary_passes(rep)
        with self._cond:
            rep.probing = False
            rep.last_probe = time.monotonic()
            if not ok or not self._running or rep.healthy:
                return
            rep.healthy = True
            rep.reason = None
            rep.busy_since = None
            _telemetry.SERVING_AUTOHEALS.inc(mode="probe")
            _telemetry.SERVING_REPLICAS_HEALTHY.set(
                self._healthy_count_locked())
            _logger.warning(
                "replica %d re-admitted after a successful heal-probe "
                "canary dispatch", rep.idx)
            # unconditional: the old worker may still be alive, blocked
            # inside the stalled device call — it exits via the
            # supersession check in _take_chunk, and a healthy replica
            # must have a live consumer NOW, not when that call returns
            self._start_worker(rep)
            self._cond.notify_all()

    def _requeue_or_fail_locked(self, reqs, cause, rep_idx):
        """Route a failed/stalled dispatch's requests to healthy
        replicas (bounded by max_retries), else fail them typed.
        Only requests still owned by replica ``rep_idx`` are touched:
        one the stall watchdog already requeued (replica=None) — and
        that another replica may have re-claimed since — is no longer
        this dispatch's to route, and double-routing would duplicate
        the queue entry, leak _queued_rows, and untrack the other
        replica's claim."""
        healthy = self._healthy_count_locked() > 0
        for req in reversed(reqs):    # appendleft keeps FIFO order
            if req.replica != rep_idx:
                continue
            self._claimed.discard(req)
            if req.state != "claimed":
                # resolved by sweep/cancel mid-dispatch
                continue
            if healthy and req.retries < self._max_retries:
                req.retries += 1
                req.state = "queued"
                req.replica = None
                # restart the queue-wait clock: the next pickup must
                # observe time spent waiting again, not the failed
                # dispatch's compute time — during an ejection storm
                # that would read as queue congestion that never was
                req.t_submit = time.monotonic()
                self._queue.appendleft(req)
                self._queued_rows += req.rows
                _telemetry.SERVING_REQUEST_RETRIES.inc()
            else:
                self._finish_locked(req, exc=ReplicaFailed(
                    "replica dispatch failed and no healthy retry "
                    "target remained: %s" % (cause,), cause=cause))
        _telemetry.SERVING_QUEUE_DEPTH.set(len(self._queue))
        self._cond.notify_all()

    def heal(self, idx=None):
        """Return replica ``idx`` (default: all ejected) to rotation
        and restart its worker thread."""
        with self._cond:
            reps = self._replicas if idx is None \
                else [self._replicas[idx]]
            for rep in reps:
                if rep.healthy or not self._running:
                    continue
                rep.healthy = True
                rep.reason = None
                rep.busy_since = None
                # unconditional: the old worker may still be alive, blocked
                # inside the stalled device call — it exits via the
                # supersession check in _take_chunk, and a healthy replica
                # must have a live consumer NOW, not when that call returns
                self._start_worker(rep)
            _telemetry.SERVING_REPLICAS_HEALTHY.set(
                self._healthy_count_locked())
            self._cond.notify_all()

    # -- sweeper ---------------------------------------------------------

    def _sweep_loop(self):
        while not self._sweep_stop.wait(self._sweep_interval):
            try:
                self.sweep()
            except Exception:
                _logger.exception("serving sweep failed")

    def sweep(self, now=None):
        """One maintenance tick: expire deadlines (queued and
        mid-dispatch), run the stall watchdog, refresh the shedder.
        The background sweeper calls this every ``sweep_interval_s``;
        tests call it directly for determinism."""
        now = time.monotonic() if now is None else now
        with self._cond:
            expired = False
            for req in self._queue:
                if req.state == "queued" and req.deadline is not None \
                        and now >= req.deadline:
                    if self._finish_locked(
                            req, exc=DeadlineExceeded("queue")):
                        expired = True
            if expired:
                self._compact_queue_locked()
            if self._stall_timeout is not None:
                for rep in self._replicas:
                    bs = rep.busy_since
                    if rep.healthy and bs is not None and \
                            now - bs > self._stall_timeout:
                        self._eject_locked(
                            rep, "stall",
                            "dispatch exceeded %.3fs"
                            % self._stall_timeout)
                        stalled = [r for r in self._claimed
                                   if r.replica == rep.idx
                                   and r.state == "claimed"]
                        self._requeue_or_fail_locked(
                            stalled, "replica %d stalled" % rep.idx,
                            rep.idx)
            for req in list(self._claimed):
                if req.state == "claimed" and req.deadline is not None \
                        and now >= req.deadline:
                    self._claimed.discard(req)
                    self._finish_locked(
                        req, exc=DeadlineExceeded("dispatch"))
            if self._heal_probe_s is not None and self._running:
                for rep in self._replicas:
                    if rep.healthy or rep.probing:
                        continue
                    since = rep.last_probe if rep.last_probe is not None \
                        else rep.ejected_at
                    if since is None or now - since < self._heal_probe_s:
                        continue
                    # one probe in flight per replica; the canary is a
                    # device call, so it runs off the sweeper thread
                    rep.probing = True
                    threading.Thread(
                        target=self._probe_replica, args=(rep,),
                        name="serving-heal-probe-%d" % rep.idx,
                        daemon=True).start()
        if self._shedder is not None:
            self._shedder.update(now)

    # -- lifecycle -------------------------------------------------------

    def close(self, drain=True, timeout=None):
        """Stop admission, optionally drain in-flight work, stop the
        workers.  ``drain=True`` (default) waits until every admitted
        request resolved (bounded by ``timeout`` seconds); whatever is
        left — drain timeout, ``drain=False``, or no healthy replicas —
        fails with :class:`Cancelled`.  With ``timeout=None`` the drain
        is still bounded by a no-progress guard (``stall_timeout_s`` or
        30 s without a single request resolving): a hung device call
        must not turn shutdown into an unbounded hang.  Idempotent."""
        deadline = time.monotonic() + timeout if timeout is not None \
            else None
        stall_guard = self._stall_timeout if self._stall_timeout \
            is not None else 30.0
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if drain:
            with self._cond:
                last_inflight = self._inflight
                last_progress = time.monotonic()
                while self._inflight > 0 and \
                        self._healthy_count_locked() > 0:
                    now = time.monotonic()
                    if self._inflight < last_inflight:
                        last_inflight = self._inflight
                        last_progress = now
                    elif now - last_progress > stall_guard:
                        _logger.warning(
                            "close(): no drain progress in %.1fs with "
                            "%d in flight; cancelling the remainder",
                            stall_guard, self._inflight)
                        break
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - now
                        if remaining <= 0:
                            break
                    self._cond.wait(min(0.05, remaining)
                                    if remaining is not None else 0.05)
        with self._cond:
            self._running = False
            for req in list(self._queue) + list(self._claimed):
                if req.state != "done":
                    self._finish_locked(req, exc=Cancelled(
                        "predictor shut down before completion"))
            self._queue.clear()
            self._claimed.clear()
            self._queued_rows = 0
            _telemetry.SERVING_QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        self._sweep_stop.set()
        for rep in self._replicas:
            # snapshot: an exiting worker clears rep.thread under the
            # lock between our None-check and the join
            t = rep.thread
            if t is not None:
                # a stalled replica's daemon thread may never return;
                # bound the join so close() cannot hang on it
                t.join(timeout=1.0)
        self._sweeper.join(timeout=1.0)
        # readiness: /healthz reads 503 WHILE close() drains (closed
        # was set above); once shutdown completes this predictor stops
        # counting, like one that never existed — a process that
        # closes a serving phase and lives on must not pin the probe
        # at 503 for as long as it holds the reference
        with _live_lock:
            _live_predictors.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- introspection ---------------------------------------------------

    def is_ready(self):
        """Readiness contract for ``/healthz``: open for admission
        with at least one healthy replica.  False from the moment a
        drained shutdown starts (close() sets ``_closed`` before
        draining), so the probe flips to 503 while in-flight work
        finishes."""
        with self._cond:
            return self._running and not self._closed and \
                self._healthy_count_locked() > 0

    def stats(self):
        """Point-in-time control-state snapshot (debugging/tests)."""
        with self._cond:
            return {
                "queue_depth": sum(1 for r in self._queue
                                   if r.state == "queued"),
                "queued_rows": self._queued_rows,
                "inflight": self._inflight,
                "claimed": len(self._claimed),
                "healthy_replicas": self._healthy_count_locked(),
                "replicas": len(self._replicas),
                "spares": len(self._spares),
                "ewma_dispatch_s": self._ewma_chunk_s,
                "shedding": (self._shedder.shedding
                             if self._shedder else False),
                "closed": self._closed,
            }


class ContractRows:
    """A gateway predict backend over an :class:`AsyncPredictor` whose
    batch contract is not f32: the gateway parses a request's ``rows``
    as f32, and ``submit`` casts them to the predictor's contract dtype
    (``gw.add_route("resnet50", ContractRows(ap), kind="predict")`` for
    a uint8 image contract).  An integer contract takes whole values in
    its range only (f32 holds them exactly up to 2**24); any other value
    raises ``ValueError`` rather than wrap or truncate."""

    def __init__(self, backend):
        self.backend = backend

    def submit(self, batch, deadline_ms=None):
        dt = self.backend._contract_dtype
        a = np.asarray(batch)
        if isinstance(dt, torch.dtype):    # bfloat16: numpy has none
            cast = torch.from_numpy(np.asarray(a, np.float32)).to(dt)
        else:
            if dt.kind in "iu":
                info = np.iinfo(dt)
                if a.size and not (np.all(np.isfinite(a))
                                   and np.all(a == np.round(a))
                                   and a.min() >= info.min
                                   and a.max() <= info.max):
                    raise ValueError("rows do not fit the %s contract"
                                     % dt)
            cast = a.astype(dt)
        return self.backend.submit(cast, deadline_ms=deadline_ms)

    def canary(self):
        return self.backend.canary()
