"""Overload-safe HTTP serving gateway: the wire front end of the fleet
(parity: mxnet_tpu/gateway.py, the same stdlib code on the port's
``config``, ``events``, ``telemetry`` and ``serving_async``).

Every serving brick so far is in-process — typed admission
(``serving_async.AsyncPredictor``), the continuous-batching decode tier
(``generate.TokenServer``), readiness-true ``/healthz`` + ``/statusz``
(``telemetry``) — but nothing speaks the network.  This module is the
stdlib-only (``http.server``, threaded, no new deps) HTTP gateway that
turns the typed error taxonomy into the wire contract written in
``docs/lm_serving.md`` and survives hostile traffic by construction:

* **Taxonomy -> wire codes** (:data:`CONTRACT` / :func:`wire_code`):
  ``Overloaded(queue/slots/slo)`` -> 429 with ``Retry-After``,
  ``Overloaded(shutdown)`` -> 503, ``DeadlineExceeded(stage)`` -> 504,
  ``Cancelled`` (client disconnect / non-drained shutdown) -> 499.  A
  tier-1 guard parses the docs table and asserts this map row-for-row.
* **Per-request deadlines from the wire**: an ``X-Deadline-Ms`` header
  threads straight into the existing admission clocks (backend
  ``submit(deadline_ms=)``), covers the gateway's own queue wait, and
  bounds a stalled backend (unresolved future past the deadline is
  cancelled and answered 504).
* **SSE token streaming**: ``POST /v1/generate/<model>`` streams
  TokenServer tokens as ``text/event-stream`` chunks the moment they
  are sampled (TTFT is user-visible); a client disconnect mid-stream is
  treated as cancel -> decode-slot eviction, never a leaked lane.
* **Multi-model routing over the AOT store**: routes are
  ``model -> (backend, version)`` where ``version`` must name a row of
  the store's ``manifest.jsonl`` (the store is used only through its
  ``manifest_entries()``) — deploy is :meth:`Gateway.deploy`
  (canary-probed atomic flip), rollback is :meth:`Gateway.rollback`, and
  :meth:`Gateway.set_canary` splits a deterministic traffic fraction to
  a candidate (the canary dispatch of ``AsyncPredictor.canary``).
  Route flips never touch in-flight
  requests: a request keeps the backend it resolved at dispatch.
* **Per-tenant quotas + weighted fair queueing**: an ``X-Tenant``
  header keys a token bucket (``MXNET_GATEWAY_QUOTA_QPS`` /
  ``_BURST``) and a WFQ dispatch queue
  (:class:`FairQueue`) in front of backend admission, so one hot
  tenant cannot starve the rest — it gets 429s while others keep their
  weighted share of the ``MXNET_GATEWAY_CONCURRENCY`` permits.  At
  most ``MXNET_GATEWAY_MAX_TENANTS`` distinct tenants are tracked;
  the rest collapse onto one shared :data:`OVERFLOW_TENANT` key, so
  minting unique headers cannot grow per-tenant state without bound.
* **Drain-first shutdown**: :meth:`Gateway.close` (and the SIGTERM
  handler from :meth:`Gateway.install_signal_handler`) flips
  ``/healthz`` to 503 *first*, sheds new work typed
  (``Overloaded(shutdown)`` -> 503), lets open streams finish bounded
  by ``MXNET_GATEWAY_DRAIN_S``, then stops the listener —
  connection-refused-free rollouts.
* **Wire hygiene**: bodies above ``MXNET_GATEWAY_MAX_BODY`` are
  refused 413 without reading; a body trickling slower than
  ``MXNET_GATEWAY_READ_TIMEOUT_S`` (slow-loris) is cut 408; malformed
  JSON is 400.  Every request — success or any of the above — emits
  exactly ONE ``gateway_request`` wide event (``events.py``) carrying
  the wire code, tenant, model/version, and the inbound ``X-Trace-Id``
  when present.

The gateway mounts on the scrape server's lifecycle: its port also
answers the introspection routes (``/metrics`` ``/healthz`` ``/statusz``
``/varz`` ``/requestz``) from the same ``telemetry`` functions, and it
registers readiness + a ``gateway`` /statusz subsystem exactly like
AsyncPredictor/TokenServer — a closed gateway deregisters (WeakSet
discard in a ``finally``), so a gateway torn down mid-request can never
leave a stale 503 behind.  Chaos coverage lives in
``tests/test_torch_gateway.py``, driven by the wire-level injectors in
``mxnet_tpu_torch.testing.faults``.  See ``docs/serving_gateway.md``.
"""
from __future__ import annotations

import collections
import json
import logging
import socket
import threading
import time
import weakref

from . import config as _config
from . import events as _events
from . import telemetry as _telemetry
from .serving_async import (Cancelled, DeadlineExceeded, Overloaded,
                            ServingError)

__all__ = ["Gateway", "FairQueue", "TokenBucket", "CONTRACT",
           "OVERFLOW_TENANT", "wire_code", "serve_gateway",
           "stop_gateway", "gateway"]

_logger = logging.getLogger("mxnet_tpu_torch.gateway")

# ---------------------------------------------------------------------------
# the wire contract (docs/lm_serving.md "Token serving, typed" table) —
# a tier-1 guard parses that table and asserts equality with this map,
# so docs and wire behavior cannot drift
# ---------------------------------------------------------------------------

CONTRACT = {
    ("Overloaded", "queue"): 429,
    ("Overloaded", "slots"): 429,
    ("Overloaded", "slo"): 429,
    ("Overloaded", "shutdown"): 503,
    ("DeadlineExceeded", "prefill"): 504,
    ("DeadlineExceeded", "decode"): 504,
    ("Cancelled", None): 499,
}


def wire_code(exc):
    """HTTP status for a typed serving error.  Contract rows are exact;
    taxonomy members outside the table degrade to their family's code
    (any other ``Overloaded`` reason is retryable -> 429, any other
    ``DeadlineExceeded`` stage -> 504, anything untyped -> 500)."""
    if isinstance(exc, Overloaded):
        return CONTRACT.get(("Overloaded", exc.reason),
                            503 if exc.reason == "shutdown" else 429)
    if isinstance(exc, DeadlineExceeded):
        return CONTRACT.get(("DeadlineExceeded", exc.stage), 504)
    if isinstance(exc, Cancelled):
        return CONTRACT[("Cancelled", None)]
    return 500


def _outcome_of(exc):
    """events.py outcome vocabulary for a typed failure (the wire code
    itself rides in the event's ``http_status`` field — ``emit``
    restricts ``outcome`` to the taxonomy)."""
    if isinstance(exc, Overloaded):
        return "shed", {"reason": exc.reason}
    if isinstance(exc, DeadlineExceeded):
        return "deadline", {"stage": exc.stage}
    if isinstance(exc, Cancelled):
        return "evicted", {"reason": "cancelled"}
    return "error", {"error_kind": type(exc).__name__}


# ---------------------------------------------------------------------------
# readiness / statusz lifecycle (the AsyncPredictor WeakSet pattern)
# ---------------------------------------------------------------------------

_live_gateways = weakref.WeakSet()
_live_lock = threading.Lock()


def _live_snapshot():
    with _live_lock:
        return list(_live_gateways)


def _gateway_statusz():
    return {"gateways": [g.stats() for g in _live_snapshot()]}


def _gateway_ready():
    gws = _live_snapshot()
    if not gws:
        return True
    return any(g.is_ready() for g in gws)


_telemetry.register_status_provider("gateway", _gateway_statusz)
_telemetry.register_readiness("gateway", _gateway_ready)


# ---------------------------------------------------------------------------
# per-tenant admission: token-bucket quota + weighted fair queueing
# ---------------------------------------------------------------------------

#: shared key that all tenants past ``MXNET_GATEWAY_MAX_TENANTS``
#: collapse onto — per-tenant state is keyed by the attacker-controlled
#: ``X-Tenant`` header, so without a cap a client minting a unique
#: tenant per request would grow queues/buckets/metric labels without
#: bound in an "overload-safe by construction" gateway
OVERFLOW_TENANT = "~overflow"


class TokenBucket:
    """Per-tenant request quota: ``burst`` capacity refilled at ``rate``
    per second.  ``take()`` returns ``(admitted, retry_after_s)`` — the
    wait until a token exists feeds the 429's ``Retry-After`` header."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def take(self, n=1):
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            if self.rate <= 0:
                return False, float("inf")
            return False, (n - self._tokens) / self.rate


class FairQueue:
    """Weighted fair queueing over a fixed pool of dispatch permits.

    Each tenant owns a bounded FIFO; a freed permit goes to the queued
    head with the smallest *virtual finish time* (start-time fair
    queueing: ``vf = max(vtime, tenant_last_vf) + 1/weight``), so a
    tenant flooding its queue advances its own virtual clock and other
    tenants' heads win the next grants — weighted max-min fairness
    without per-tenant threads.  Typed rejections: a full tenant queue
    raises :class:`Overloaded('queue')`, an expired wait
    :class:`DeadlineExceeded('queue')`, a closed pool
    :class:`Overloaded('shutdown')`.
    """

    def __init__(self, permits, depth, weights=None):
        self._cond = threading.Condition()
        self._free = max(1, int(permits))
        self.permits = self._free
        self._depth = max(1, int(depth))
        self._weights = dict(weights or {})
        self._queues = {}            # tenant -> deque of waiter tokens
        self._vtime = 0.0
        self._vfinish = {}           # tenant -> last assigned vf
        self._closed = False

    def _prune_locked(self, tenant):
        """Drop a tenant's empty queue (and its virtual-finish clock
        once the global clock has passed it — at that point
        ``max(vtime, vf)`` is ``vtime`` anyway, so the prune cannot
        change any future grant order).  Keyed per attacker-controlled
        header, un-pruned entries would grow without bound."""
        q = self._queues.get(tenant)
        if q is not None and not q:
            del self._queues[tenant]
        if tenant not in self._queues and \
                self._vfinish.get(tenant, 0.0) <= self._vtime:
            self._vfinish.pop(tenant, None)

    def _grant_locked(self):
        while self._free > 0:
            best_t, best_q = None, None
            for t, q in self._queues.items():
                if q and (best_q is None or q[0]["vf"] < best_q[0]["vf"]):
                    best_t, best_q = t, q
            if best_q is None:
                return
            tok = best_q.popleft()
            tok["granted"] = True
            self._free -= 1
            self._vtime = max(self._vtime, tok["vf"])
            self._prune_locked(best_t)
            self._cond.notify_all()

    def acquire(self, tenant, deadline=None):
        """Block until this tenant's turn for a permit (typed raise
        otherwise).  Pair with :meth:`release`."""
        with self._cond:
            if self._closed:
                raise Overloaded("shutdown", "gateway draining")
            q = self._queues.setdefault(tenant, collections.deque())
            if len(q) >= self._depth:
                raise Overloaded("queue", "tenant %r queue depth %d"
                                 % (tenant, self._depth))
            w = float(self._weights.get(tenant, 1.0)) or 1.0
            vf = max(self._vtime, self._vfinish.get(tenant, 0.0)) + 1.0 / w
            self._vfinish[tenant] = vf
            tok = {"vf": vf, "granted": False}
            q.append(tok)
            self._grant_locked()
            while not tok["granted"]:
                if self._closed:
                    if tok in q:
                        q.remove(tok)
                    self._prune_locked(tenant)
                    raise Overloaded("shutdown", "gateway draining")
                if deadline is not None and \
                        time.monotonic() >= deadline:
                    if tok in q:
                        q.remove(tok)
                    self._prune_locked(tenant)
                    raise DeadlineExceeded(
                        "queue", "expired waiting for a dispatch permit")
                self._cond.wait(0.02)

    def release(self):
        with self._cond:
            self._free += 1
            self._grant_locked()

    def depths(self):
        """{tenant: queued} over tenants currently waiting."""
        with self._cond:
            return {t: len(q) for t, q in self._queues.items() if q}

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()


# ---------------------------------------------------------------------------
# routing over the AOT store manifest
# ---------------------------------------------------------------------------

class _Route:
    """One model's routing state: the stable (backend, version), the
    previous pair (rollback target), and an optional canary split."""

    __slots__ = ("model", "kind", "backend", "version", "prev_backend",
                 "prev_version", "canary", "canary_version",
                 "canary_weight", "_count", "_lock")

    def __init__(self, model, backend, version=None, kind="generate"):
        self.model = model
        self.kind = kind
        self.backend = backend
        self.version = version
        self.prev_backend = None
        self.prev_version = None
        self.canary = None
        self.canary_version = None
        self.canary_weight = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def pick(self):
        """(backend, version, is_canary) for the next request —
        deterministic counter-based split (every round(1/weight)-th
        request canaries), so tests and rollouts are reproducible."""
        with self._lock:
            self._count += 1
            n = self._count
            if self.canary is not None and self.canary_weight > 0:
                period = max(1, int(round(1.0 / self.canary_weight)))
                if n % period == 0:
                    return self.canary, self.canary_version, True
            return self.backend, self.version, False

    def view(self):
        return {"kind": self.kind, "version": self.version,
                "previous_version": self.prev_version,
                "canary_version": self.canary_version
                if self.canary is not None else None,
                "canary_weight": self.canary_weight
                if self.canary is not None else 0.0,
                "requests": self._count}


class _RequestCtx:
    """Book-keeping for one inference request: everything the single
    wide event + response counters need, whatever exit path fires."""

    __slots__ = ("t0", "tenant", "model", "version", "op", "trace_id",
                 "status", "outcome", "fields", "stages", "tokens",
                 "emitted", "permit")

    def __init__(self, tenant, trace_id):
        self.t0 = time.monotonic()
        self.tenant = tenant
        self.model = None
        self.version = None
        self.op = None
        self.trace_id = trace_id
        self.status = 500
        self.outcome = "error"
        self.fields = {}
        self.stages = {}
        self.tokens = 0
        self.emitted = False
        self.permit = False            # WFQ permit held (do_POST releases)


class Gateway:
    """Threaded stdlib HTTP front end over registered serving backends.

    Routes (POST bodies are JSON):

    * ``POST /v1/generate/<model>`` — body
      ``{"tokens": [...], "max_new_tokens": n?}``; streams Server-Sent
      Events: one ``data: {"token": t}`` frame per sampled token, then
      ``data: {"done": true, "finish_reason": ..., "ttft_s": ...,
      "version": ...}``.  A failure before the first token answers the
      mapped wire code; mid-stream failures arrive as a final
      ``data: {"error": {"code": ...}}`` frame (the status line is
      already on the wire).
    * ``POST /v1/predict/<model>`` — body ``{"rows": [[...], ...]}``;
      answers ``{"outputs": ..., "version": ...}``.
    * ``GET /healthz /statusz /metrics /varz /requestz`` — the scrape
      server's introspection routes, served from the same telemetry
      functions (the gateway mounts on that lifecycle).

    Request headers: ``X-Tenant`` (quota/WFQ key, default
    ``"default"``), ``X-Deadline-Ms`` (per-request deadline threaded
    into backend admission), ``X-Trace-Id`` (propagated into the
    request's wide event).
    """

    def __init__(self, port=None, host="127.0.0.1", store=None,
                 quota_qps=None, quota_burst=None, queue_depth=None,
                 concurrency=None, tenant_weights=None,
                 read_timeout_s=None, max_body=None, drain_s=None,
                 max_tenants=None):
        if port is None:
            port = _config.get("MXNET_GATEWAY_PORT")
        if quota_qps is None:
            quota_qps = _config.get("MXNET_GATEWAY_QUOTA_QPS")
        if quota_burst is None:
            quota_burst = _config.get("MXNET_GATEWAY_QUOTA_BURST")
        if queue_depth is None:
            queue_depth = _config.get("MXNET_GATEWAY_QUEUE")
        if concurrency is None:
            concurrency = _config.get("MXNET_GATEWAY_CONCURRENCY")
        if read_timeout_s is None:
            read_timeout_s = _config.get("MXNET_GATEWAY_READ_TIMEOUT_S")
        if max_body is None:
            max_body = _config.get("MXNET_GATEWAY_MAX_BODY")
        if drain_s is None:
            drain_s = _config.get("MXNET_GATEWAY_DRAIN_S")
        if max_tenants is None:
            max_tenants = _config.get("MXNET_GATEWAY_MAX_TENANTS")
        self._store = store
        self._quota_qps = float(quota_qps)
        self._quota_burst = float(quota_burst)
        self._read_timeout = float(read_timeout_s)
        self._max_body = int(max_body)
        self._drain_s = float(drain_s)
        self._routes = {}
        self._routes_lock = threading.Lock()
        self._buckets = {}
        self._buckets_lock = threading.Lock()
        self._max_tenants = max(1, int(max_tenants))
        self._tenants = set(tenant_weights or ())
        self._tenants_lock = threading.Lock()
        self._wfq = FairQueue(concurrency, queue_depth,
                              weights=tenant_weights)
        self._open_streams = 0
        self._open_cond = threading.Condition()
        self._draining = False
        self._closed = False
        self._tenant_shed = collections.Counter()
        self._shed_lock = threading.Lock()
        self._prev_sigterm = None

        from http.server import ThreadingHTTPServer

        class _Server(ThreadingHTTPServer):
            daemon_threads = True

            def handle_error(self, request, client_address):
                # a vanished client surfacing in socketserver's
                # request teardown is already accounted typed (499);
                # anything else is a real bug worth the traceback
                import sys as _sys

                exc = _sys.exc_info()[1]
                if isinstance(exc, (ConnectionError, BrokenPipeError,
                                    OSError)):
                    return
                ThreadingHTTPServer.handle_error(self, request,
                                                 client_address)

        self._httpd = _Server((host, int(port)), _make_handler(self))
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="gateway-http", daemon=True)
        self._thread.start()
        with _live_lock:
            _live_gateways.add(self)

    # -- routing ---------------------------------------------------------

    def _check_version(self, version):
        """A route version must name a manifest row of the AOT store
        (when the gateway was built over one) — deploys of unwarmed
        versions fail at the flip, not at first traffic."""
        if version is None or self._store is None:
            return
        entries, _ = self._store.manifest_entries()
        known = set()
        for e in entries:
            known.add(e.get("key"))
            if e.get("spec"):
                known.add(e["spec"])
            if e.get("version"):
                known.add(e["version"])
        if version not in known:
            raise ValueError(
                "version %r not in the AOT store manifest (%d entries); "
                "prewarm it first"
                % (version, len(entries)))

    def add_route(self, model, backend, version=None, kind="generate"):
        """Register (or replace) the stable backend for ``model``.
        ``backend`` is anything with the serving ``submit`` protocol
        (TokenServer for ``kind='generate'``, AsyncPredictor for
        ``kind='predict'``)."""
        self._check_version(version)
        with self._routes_lock:
            self._routes[str(model)] = _Route(str(model), backend,
                                              version=version, kind=kind)

    def deploy(self, model, backend, version=None, probe=None):
        """Atomically flip ``model`` to a new (backend, version).

        ``version`` is validated against the AOT manifest; ``probe``
        (default: the backend's own ``canary`` method when it has one —
        the canary dispatch) must return truthy before
        the flip, else :class:`RuntimeError` and the route is
        untouched.  The previous pair is kept for :meth:`rollback`;
        in-flight requests finish on whichever backend they picked.
        Returns ``(previous_backend, previous_version)``.
        """
        self._check_version(version)
        if probe is None:
            probe = getattr(backend, "canary", None)
        if probe is not None:
            try:
                ok = probe()
            except Exception as e:
                raise RuntimeError(
                    "canary probe for %s version %r raised: %s"
                    % (model, version, e)) from e
            if not ok:
                raise RuntimeError(
                    "canary probe for %s version %r failed; route "
                    "unchanged" % (model, version))
        with self._routes_lock:
            route = self._routes.get(str(model))
            if route is None:
                self._routes[str(model)] = route = _Route(
                    str(model), backend, version=version)
                prev = (None, None)
            else:
                prev = (route.backend, route.version)
                route.prev_backend, route.prev_version = prev
                route.backend, route.version = backend, version
                if route.canary is backend:
                    route.canary = None      # promoted: stop splitting
                    route.canary_version = None
        _telemetry.GATEWAY_ROUTE_FLIPS.inc(op="deploy")
        _logger.info("gateway: deployed %s version %r (was %r)",
                     model, version, prev[1])
        return prev

    def rollback(self, model):
        """Flip ``model`` back to its pre-deploy (backend, version).
        Raises :class:`KeyError`/:class:`RuntimeError` when there is
        nothing to roll back to."""
        with self._routes_lock:
            route = self._routes[str(model)]
            if route.prev_backend is None:
                raise RuntimeError("no previous version recorded for %r"
                                   % (model,))
            route.backend, route.prev_backend = \
                route.prev_backend, route.backend
            route.version, route.prev_version = \
                route.prev_version, route.version
        _telemetry.GATEWAY_ROUTE_FLIPS.inc(op="rollback")
        _logger.info("gateway: rolled back %s to version %r",
                     model, route.version)

    def set_canary(self, model, backend, version=None, weight=0.1):
        """Split a deterministic ``weight`` fraction of ``model``'s
        traffic to a candidate backend (``clear_canary`` ends the
        experiment; ``deploy`` the same backend promotes it)."""
        self._check_version(version)
        with self._routes_lock:
            route = self._routes[str(model)]
            route.canary = backend
            route.canary_version = version
            route.canary_weight = max(0.0, min(1.0, float(weight)))
        _telemetry.GATEWAY_ROUTE_FLIPS.inc(op="canary")

    def clear_canary(self, model):
        with self._routes_lock:
            route = self._routes[str(model)]
            route.canary = None
            route.canary_version = None
            route.canary_weight = 0.0

    def routes(self):
        with self._routes_lock:
            return {m: r.view() for m, r in self._routes.items()}

    # -- lifecycle -------------------------------------------------------

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def is_ready(self):
        return not self._draining and not self._closed

    def stats(self):
        with self._open_cond:
            open_streams = self._open_streams
        with self._shed_lock:
            shed = dict(self._tenant_shed)
        with self._tenants_lock:
            known = len(self._tenants)
        return {"port": self.port, "draining": self._draining,
                "closed": self._closed, "open_streams": open_streams,
                "routes": self.routes(),
                "tenants": {
                    "known": known,
                    "queued": self._wfq.depths(),
                    "shed": shed,
                }}

    def install_signal_handler(self, sig=None):
        """Route SIGTERM to a drain-first close: the handler flips
        readiness immediately (``/healthz`` 503 on the next probe) and
        runs ``close(drain=True)`` on a background thread so the
        signal context returns at once.  Returns the previous handler
        (tests restore it)."""
        import signal as _signal

        sig = _signal.SIGTERM if sig is None else sig

        def _on_term(signum, frame):
            self._draining = True
            threading.Thread(target=self.close,
                             kwargs={"drain": True,
                                     "timeout": self._drain_s},
                             name="gateway-drain", daemon=True).start()

        self._prev_sigterm = _signal.signal(sig, _on_term)
        return self._prev_sigterm

    def close(self, drain=True, timeout=None):
        """Drain-first shutdown.  Flips readiness (503) before
        anything else, stops admitting (new requests shed
        ``Overloaded('shutdown')`` -> 503 while the listener is still
        accepting — never connection-refused), waits up to ``timeout``
        (default ``MXNET_GATEWAY_DRAIN_S``) for open streams, then
        stops the listener.  Idempotent; the gateway deregisters from
        readiness/statusz in a ``finally`` even when streams are still
        open at the deadline — a gateway closed mid-request must not
        leave a stale 503 for its successor (the AsyncPredictor
        lifecycle contract)."""
        if self._closed:
            return
        self._draining = True
        if timeout is None:
            timeout = self._drain_s
        try:
            if drain:
                deadline = time.monotonic() + float(timeout)
                with self._open_cond:
                    while self._open_streams > 0 and \
                            time.monotonic() < deadline:
                        self._open_cond.wait(0.02)
                    leftover = self._open_streams
                if leftover:
                    _logger.warning(
                        "gateway close(): %d stream(s) still open at "
                        "the drain deadline; closing anyway", leftover)
            self._wfq.close()
            self._closed = True
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._httpd.server_close()
        finally:
            self._closed = True
            with _live_lock:
                _live_gateways.discard(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- request plumbing (called from the handler) ----------------------

    def _tenant_key(self, tenant):
        """Canonical key for per-tenant state: the raw ``X-Tenant``
        value for the first ``MXNET_GATEWAY_MAX_TENANTS`` distinct
        tenants (weighted tenants are pre-seeded), the shared
        :data:`OVERFLOW_TENANT` after — so minting unique headers
        cannot grow queues/buckets/shed counters/metric labels without
        bound.  Overflow tenants share one bucket and one WFQ lane."""
        tenant = str(tenant)
        with self._tenants_lock:
            if tenant in self._tenants:
                return tenant
            if len(self._tenants) < self._max_tenants:
                self._tenants.add(tenant)
                return tenant
        return OVERFLOW_TENANT

    def _bucket(self, tenant):
        if self._quota_qps <= 0:
            return None
        with self._buckets_lock:
            b = self._buckets.get(tenant)
            if b is None:
                b = self._buckets[tenant] = TokenBucket(
                    self._quota_qps, self._quota_burst)
            return b

    def _finish_request(self, ctx):
        """Response accounting + the request's ONE wide event (every
        exit path funnels here exactly once; ``emitted`` guards the
        disconnect-mid-stream path where the error reply also fails)."""
        if ctx.emitted:
            return
        ctx.emitted = True
        dur = time.monotonic() - ctx.t0
        _telemetry.GATEWAY_RESPONSES.inc(code=str(ctx.status))
        _telemetry.GATEWAY_REQUEST_SECONDS.observe(dur)
        if ctx.status in (429, 503):
            with self._shed_lock:
                self._tenant_shed[ctx.tenant] += 1
        if _events.enabled():
            _events.emit("gateway_request", outcome=ctx.outcome,
                         dur_s=dur, stages_s=ctx.stages or None,
                         trace_id=ctx.trace_id,
                         http_status=ctx.status, tenant=ctx.tenant,
                         model=ctx.model, version=ctx.version,
                         op=ctx.op,
                         tokens=ctx.tokens if ctx.tokens else None,
                         **ctx.fields)


# ---------------------------------------------------------------------------
# the HTTP handler
# ---------------------------------------------------------------------------

def _json_bytes(obj):
    return (json.dumps(obj, sort_keys=True) + "\n").encode("utf-8")


def _make_handler(gw):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        gateway = gw

        def log_message(self, fmt, *args):
            pass                       # request accounting is typed

        # -- introspection (the scrape server's routes, same sources) --

        def do_GET(self):  # noqa: N802 (http.server API)
            path, _, query = self.path.partition("?")
            status, ctype = 200, "application/json; charset=utf-8"
            if path == "/healthz":
                ready, checks = _telemetry.readiness()
                if ready and gw.is_ready():
                    body, ctype = b"ok\n", "text/plain; charset=utf-8"
                else:
                    status = 503
                    failing = sorted(k for k, v in checks.items()
                                     if not v)
                    if not gw.is_ready() and "gateway" not in failing:
                        failing.append("gateway")
                    body = _json_bytes({"ready": False,
                                        "failing": failing,
                                        "checks": checks})
            elif path == "/statusz":
                body = _json_bytes(_telemetry.statusz())
            elif path == "/varz":
                body = _json_bytes(_telemetry.varz())
            elif path == "/metrics":
                om = "application/openmetrics-text" in \
                    self.headers.get("Accept", "")
                body = _telemetry.scrape(openmetrics=om).encode("utf-8")
                ctype = ("application/openmetrics-text; version=1.0.0; "
                         "charset=utf-8") if om else \
                    "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/requestz":
                n = 64
                for part in query.split("&"):
                    if part.startswith("n="):
                        try:
                            n = max(1, int(part[2:]))
                        except ValueError:
                            pass
                body = _json_bytes({"stats": _events.stats(),
                                    "events": _events.recent(n)})
            else:
                self.send_error(404, "unknown path %r" % path)
                return
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except OSError:
                pass

        # -- inference -------------------------------------------------

        def do_POST(self):  # noqa: N802
            tenant = gw._tenant_key(
                self.headers.get("X-Tenant") or "default")
            ctx = _RequestCtx(tenant,
                              self.headers.get("X-Trace-Id") or None)
            _telemetry.GATEWAY_REQUESTS.inc(tenant=tenant)
            self.close_connection = True
            try:
                self._serve_inference(ctx)
            except (BrokenPipeError, ConnectionError, socket.timeout,
                    OSError):
                # client vanished while we answered: record what we
                # know; nothing more can reach the wire
                if ctx.status == 500:
                    ctx.status, ctx.outcome = 499, "evicted"
                    ctx.fields.setdefault("reason", "disconnect")
            except Exception as e:   # a handler bug must answer 500
                _logger.exception("gateway handler failed")
                ctx.fields.setdefault("error_kind", type(e).__name__)
                self._reply_error(ctx, 500, "error",
                                  message=str(e))
            finally:
                # ctx.permit (not a local) so an exception escaping
                # _serve_inference after the WFQ acquire can never
                # leak a dispatch permit and deadlock all tenants
                if ctx.permit:
                    gw._wfq.release()
                gw._finish_request(ctx)

        def _reply_error(self, ctx, status, outcome, message="",
                         retry_after=None, **fields):
            ctx.status = status
            ctx.outcome = outcome
            for k, v in fields.items():
                ctx.fields.setdefault(k, v)
            body = _json_bytes({"error": {
                "code": status, "message": message,
                **{k: v for k, v in fields.items() if v is not None}}})
            try:
                self.send_response(status)
                if retry_after is not None:
                    self.send_header("Retry-After",
                                     str(max(1, int(retry_after + 0.5))))
                self.send_header("Content-Type",
                                 "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(body)
            except OSError:
                pass                   # client already gone

        def _reply_typed(self, ctx, exc):
            outcome, fields = _outcome_of(exc)
            code = wire_code(exc)
            retry = None
            if code == 429:
                retry = fields.pop("retry_after", 1)
            elif code == 503:
                retry = gw._drain_s
            self._reply_error(ctx, code, outcome, message=str(exc),
                              retry_after=retry, **fields)

        def _read_body(self, ctx):
            """Bounded, slow-loris-guarded body read.  Returns the
            parsed JSON dict or None after an error reply."""
            t0 = time.monotonic()
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                _telemetry.GATEWAY_BAD_REQUESTS.inc(kind="malformed")
                self._reply_error(ctx, 400, "error",
                                  message="Content-Length required",
                                  error_kind="malformed")
                return None
            if length > gw._max_body:
                # refused before reading a byte: an oversized body
                # cannot hold a handler thread or its memory
                _telemetry.GATEWAY_BAD_REQUESTS.inc(kind="oversized")
                self._reply_error(
                    ctx, 413, "error",
                    message="body %d > cap %d" % (length, gw._max_body),
                    error_kind="oversized")
                return None
            # Total-body budget: a per-recv timeout alone never fires
            # against a slow-loris that trickles bytes just under it,
            # so the deadline covers the WHOLE body read.
            t_end = t0 + gw._read_timeout
            data = b""
            try:
                while len(data) < length:
                    remaining = t_end - time.monotonic()
                    if remaining <= 0:
                        raise socket.timeout("body budget exhausted")
                    self.connection.settimeout(remaining)
                    # read1: at most ONE underlying recv, so control
                    # returns here per trickle and the shrinking
                    # budget is re-checked (plain read(n) loops recv
                    # internally until n bytes and never comes back)
                    chunk = self.rfile.read1(
                        min(65536, length - len(data)))
                    if not chunk:
                        _telemetry.GATEWAY_BAD_REQUESTS.inc(
                            kind="truncated")
                        self._reply_error(ctx, 400, "error",
                                          message="truncated body",
                                          error_kind="truncated")
                        return None
                    data += chunk
            except socket.timeout:
                # slow-loris: a body trickling below the read timeout
                # is cut typed instead of pinning a handler thread
                _telemetry.GATEWAY_BAD_REQUESTS.inc(kind="slow_body")
                self._reply_error(ctx, 408, "error",
                                  message="body read timed out "
                                  "(%.1fs)" % gw._read_timeout,
                                  error_kind="slow_body")
                return None
            ctx.stages["read"] = time.monotonic() - t0
            try:
                body = json.loads(data.decode("utf-8"))
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                _telemetry.GATEWAY_BAD_REQUESTS.inc(kind="malformed")
                self._reply_error(ctx, 400, "error",
                                  message="malformed JSON body: %s" % e,
                                  error_kind="malformed")
                return None
            return body

        def _serve_inference(self, ctx):
            """The whole request path.  A WFQ acquire sets
            ``ctx.permit``; do_POST's ``finally`` releases it on EVERY
            exit — including exceptions escaping this method — so no
            path can leak a dispatch permit."""
            parts = self.path.split("?")[0].strip("/").split("/")
            if len(parts) != 3 or parts[0] != "v1" or \
                    parts[1] not in ("generate", "predict"):
                self._reply_error(ctx, 404, "error",
                                  message="unknown path %r" % self.path,
                                  error_kind="no_route")
                return
            ctx.op, ctx.model = parts[1], parts[2]

            # deadline from the wire, threaded through every clock below
            deadline = None
            hdr = self.headers.get("X-Deadline-Ms")
            if hdr:
                try:
                    dl_ms = float(hdr)
                    if dl_ms < 0:
                        raise ValueError(hdr)
                except ValueError:
                    _telemetry.GATEWAY_BAD_REQUESTS.inc(
                        kind="bad_deadline")
                    self._reply_error(ctx, 400, "error",
                                      message="bad X-Deadline-Ms %r"
                                      % hdr,
                                      error_kind="bad_deadline")
                    return
                if dl_ms:
                    deadline = ctx.t0 + dl_ms / 1e3

            if not gw.is_ready():
                self._reply_typed(ctx, Overloaded("shutdown",
                                                  "gateway draining"))
                return
            with gw._routes_lock:
                route = gw._routes.get(ctx.model)
            if route is None:
                self._reply_error(ctx, 404, "error",
                                  message="no route for model %r"
                                  % ctx.model,
                                  error_kind="no_route")
                return

            body = self._read_body(ctx)
            if body is None:
                return

            # per-tenant token-bucket quota, before any queue or
            # backend touch — a hot tenant burns its own budget only
            bucket = gw._bucket(ctx.tenant)
            if bucket is not None:
                ok, retry = bucket.take()
                if not ok:
                    _telemetry.GATEWAY_QUOTA_SHED.inc(tenant=ctx.tenant)
                    err = Overloaded("queue",
                                     "tenant %r over quota" % ctx.tenant)
                    outcome, fields = _outcome_of(err)
                    fields["reason"] = "quota"
                    self._reply_error(ctx, 429, outcome,
                                      message=str(err),
                                      retry_after=retry, **fields)
                    return

            # weighted-fair queueing for a dispatch permit
            t_q = time.monotonic()
            try:
                gw._wfq.acquire(ctx.tenant, deadline=deadline)
            except ServingError as e:
                self._reply_typed(ctx, e)
                return
            ctx.permit = True
            ctx.stages["queue"] = time.monotonic() - t_q
            _telemetry.GATEWAY_QUEUE_WAIT_SECONDS.observe(
                ctx.stages["queue"])

            backend, version, is_canary = route.pick()
            ctx.version = version
            if is_canary:
                ctx.fields["canary"] = True
            with gw._open_cond:
                gw._open_streams += 1
                n_open = gw._open_streams
            _telemetry.GATEWAY_OPEN_STREAMS.set(n_open)
            try:
                remaining_ms = None
                if deadline is not None:
                    remaining_ms = max(
                        1.0, (deadline - time.monotonic()) * 1e3)
                if ctx.op == "generate":
                    self._serve_generate(ctx, backend, version, body,
                                         deadline, remaining_ms)
                else:
                    self._serve_predict(ctx, backend, version, body,
                                        deadline, remaining_ms)
            finally:
                with gw._open_cond:
                    gw._open_streams -= 1
                    n_open = gw._open_streams
                    gw._open_cond.notify_all()
                _telemetry.GATEWAY_OPEN_STREAMS.set(n_open)

        # -- predict: JSON in, JSON out --------------------------------

        def _serve_predict(self, ctx, backend, version, body, deadline,
                           remaining_ms):
            import numpy as np

            rows = body.get("rows")
            if rows is None:
                self._reply_error(ctx, 400, "error",
                                  message="body needs 'rows'",
                                  error_kind="malformed")
                return
            try:
                batch = np.asarray(rows, dtype=np.float32)
            except (TypeError, ValueError) as e:
                self._reply_error(ctx, 400, "error",
                                  message="bad rows: %s" % e,
                                  error_kind="malformed")
                return
            t_d = time.monotonic()
            try:
                fut = backend.submit(batch, deadline_ms=remaining_ms)
            except ServingError as e:
                self._reply_typed(ctx, e)
                return
            timeout = (deadline - time.monotonic()) if deadline \
                else gw._read_timeout * 4
            try:
                result = fut.result(max(0.01, timeout))
            except ServingError as e:
                self._reply_typed(ctx, e)
                return
            except TimeoutError:
                # stalled backend with no typed resolution: retract the
                # request and answer the deadline contract
                fut.cancel()
                self._reply_typed(ctx, DeadlineExceeded(
                    "dispatch", "backend unresolved past the deadline"))
                return
            ctx.stages["dispatch"] = time.monotonic() - t_d
            out = result.tolist() if hasattr(result, "tolist") \
                else result
            payload = _json_bytes({"outputs": out, "version": version})
            ctx.status, ctx.outcome = 200, "ok"
            try:
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(payload)
            except OSError:
                # client vanished while we answered — account typed,
                # never let the raise skip do_POST's permit release
                _telemetry.GATEWAY_CLIENT_DISCONNECTS.inc()
                ctx.status, ctx.outcome = 499, "evicted"
                ctx.fields["reason"] = "disconnect"

        # -- generate: SSE token stream --------------------------------

        def _sse(self, obj):
            self.wfile.write(b"data: " + json.dumps(
                obj, sort_keys=True).encode("utf-8") + b"\n\n")
            self.wfile.flush()

        def _fail_generate(self, ctx, exc, streaming):
            """Answer a typed generate failure with the contract code:
            a real status line while headers are unsent, else a final
            SSE ``error`` frame — writing a second status line into an
            open event stream would corrupt the wire."""
            if not streaming:
                self._reply_typed(ctx, exc)
                return
            outcome, fields = _outcome_of(exc)
            ctx.status, ctx.outcome = wire_code(exc), outcome
            ctx.fields.update(fields)
            try:
                self._sse({"error": {"code": ctx.status,
                                     "message": str(exc), **fields}})
            except OSError:
                pass               # client already gone; event has it

        def _serve_generate(self, ctx, backend, version, body, deadline,
                            remaining_ms):
            tokens = body.get("tokens")
            if not tokens or not isinstance(tokens, list):
                self._reply_error(ctx, 400, "error",
                                  message="body needs non-empty "
                                  "'tokens'",
                                  error_kind="malformed")
                return
            import queue as _queue

            toks = _queue.Queue()
            kwargs = {}
            if body.get("max_new_tokens"):
                try:
                    kwargs["max_new_tokens"] = int(
                        body["max_new_tokens"])
                except (TypeError, ValueError):
                    # validated while no resource is held and before
                    # the backend: a junk value is the client's 400,
                    # not an uncaught 500
                    self._reply_error(
                        ctx, 400, "error",
                        message="bad max_new_tokens %r"
                        % (body["max_new_tokens"],),
                        error_kind="malformed")
                    return
            t_d = time.monotonic()
            try:
                fut = backend.submit(tokens, deadline_ms=remaining_ms,
                                     on_token=toks.put, **kwargs)
            except ServingError as e:
                self._reply_typed(ctx, e)
                return
            except (TypeError, ValueError) as e:
                self._reply_error(ctx, 400, "error",
                                  message="bad prompt: %s" % e,
                                  error_kind="malformed")
                fut = None
                return

            # headers are NOT sent yet: a failure before the first
            # token still gets a real status line.  TTFT stays
            # user-visible — the 200 + first SSE frame go out the
            # moment the first token arrives.
            streaming = False
            try:
                while True:
                    try:
                        tok = toks.get(timeout=0.02)
                    except _queue.Empty:
                        if fut.done() and toks.empty():
                            break
                        if deadline is not None and \
                                time.monotonic() > deadline + 1.0 \
                                and not fut.done():
                            # stalled handler guard: the backend is a
                            # grace past the deadline with no typed
                            # resolution — retract and answer 504
                            # (as an SSE error frame once streaming)
                            fut.cancel()
                            self._fail_generate(ctx, DeadlineExceeded(
                                "decode", "backend stalled past the "
                                "deadline"), streaming)
                            return
                        continue
                    if not streaming:
                        streaming = True
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "text/event-stream")
                        self.send_header("Cache-Control", "no-cache")
                        self.send_header("Connection", "close")
                        self.end_headers()
                    self._sse({"token": int(tok)})
                    ctx.tokens += 1
                    _telemetry.GATEWAY_STREAM_TOKENS.inc()
            except OSError:
                # client disconnect mid-stream: cancel -> the decode
                # slot is evicted by the TokenServer loop; the contract
                # code for the cancel row (499) goes in the event
                fut.cancel()
                _telemetry.GATEWAY_CLIENT_DISCONNECTS.inc()
                ctx.status, ctx.outcome = 499, "evicted"
                ctx.fields["reason"] = "disconnect"
                ctx.stages["dispatch"] = time.monotonic() - t_d
                return
            ctx.stages["dispatch"] = time.monotonic() - t_d
            try:
                result = fut.result(0.0)
            except ServingError as e:
                self._fail_generate(ctx, e, streaming)
                return
            except TimeoutError:
                fut.cancel()
                self._fail_generate(ctx, DeadlineExceeded(
                    "decode", "backend unresolved after final token"),
                    streaming)
                return
            done = {"done": True, "version": version,
                    "finish_reason": result.get("finish_reason")
                    if hasattr(result, "get") else None,
                    "ttft_s": result.get("ttft_s")
                    if hasattr(result, "get") else None,
                    "tokens": ctx.tokens}
            ctx.status, ctx.outcome = 200, "ok"
            if not streaming:      # zero-token generation: still 200
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
            try:
                self._sse(done)
            except OSError:
                _telemetry.GATEWAY_CLIENT_DISCONNECTS.inc()
                ctx.status, ctx.outcome = 499, "evicted"
                ctx.fields["reason"] = "disconnect"

    return Handler


# ---------------------------------------------------------------------------
# process-wide singleton (the serve_scrape lifecycle pattern)
# ---------------------------------------------------------------------------

_gateway = None
_gateway_lock = threading.Lock()


def serve_gateway(port=None, host="127.0.0.1", **kwargs):
    """Start (or return the already-running) process gateway.  ``port``
    defaults to ``MXNET_GATEWAY_PORT`` (0 = ephemeral; the chosen port
    is on ``.port``).  One per process — a second call returns the
    live one."""
    global _gateway
    with _gateway_lock:
        if _gateway is not None and not _gateway._closed:
            return _gateway
        _gateway = Gateway(port=port, host=host, **kwargs)
        return _gateway


def stop_gateway(drain=True, timeout=None):
    """Drain and stop the process gateway (no-op when none runs)."""
    global _gateway
    with _gateway_lock:
        g, _gateway = _gateway, None
    if g is not None:
        g.close(drain=drain, timeout=timeout)


def gateway():
    """The live process :class:`Gateway`, or None."""
    return _gateway
