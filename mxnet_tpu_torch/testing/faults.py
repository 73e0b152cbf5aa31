"""Fault injection for the serving tier's tests (parity: the serving and
HTTP helpers of mxnet_tpu/testing/faults.py).  Nothing here is imported
by production code paths.

* :func:`poison_batch` — inject NaN/Inf into a batch (the bad-record
  data poisoning that trips the non-finite step guard and the
  quantization gate).
* :func:`send_preemption` — deliver SIGTERM (or any signal) to a
  process after an optional delay, from a daemon thread — the drain
  drill of the gateway's signal handler.
* :class:`FlakyCallable` — fails the first N calls then succeeds.
* :class:`LatencySpike` — wraps a callable with an injected delay on a
  chosen call window (a slow card, a garbage-collection pause).
* :class:`StallingCallable` — wraps a callable so chosen calls block on
  an event until :meth:`~StallingCallable.release` (or raise) — the
  stuck-replica scenario the serving watchdog must survive; wrap a
  replica's ``Predictor._jit_chain`` with it.
* :func:`transient_device_put_failures` — context manager making the
  first N calls of the serving upload (``serving._device_put``, the
  host-to-card copy) raise, driving the upload retry path.

Wire-level injectors — hostile raw-socket HTTP clients the gateway
chaos tests drive:

* :func:`slow_loris_post` — declare a full Content-Length, trickle the
  body a byte at a time (a correct gateway cuts it 408).
* :func:`disconnecting_stream_post` — start an SSE stream, read a few
  bytes, vanish with a TCP RST (SO_LINGER=0) so the server's next
  write fails immediately (cancel -> slot eviction path).
* :func:`malformed_post` / :func:`oversized_post` — broken JSON,
  lying Content-Length (truncated body), and the memory-bomb header a
  server must refuse (413) without reading.
"""
from __future__ import annotations

import contextlib
import os
import signal as _signal
import threading
import time

__all__ = ["poison_batch", "send_preemption", "FlakyCallable",
           "LatencySpike", "StallingCallable",
           "transient_device_put_failures", "slow_loris_post",
           "disconnecting_stream_post", "malformed_post",
           "oversized_post"]


def poison_batch(arr, value=float("nan"), fraction=1.0):
    """A float copy of ``arr`` with the first ``fraction`` of entries
    replaced by ``value`` (NaN by default) — one poisoned record is all
    the non-finite step guard needs to trip."""
    import numpy as np

    out = np.array(arr, copy=True)
    if not np.issubdtype(out.dtype, np.floating):
        out = out.astype(np.float32)
    flat = out.reshape(-1)
    n = max(1, int(round(float(fraction) * flat.size)))
    flat[:n] = value
    return out


def send_preemption(pid=None, sig=_signal.SIGTERM, delay=0.0):
    """Deliver ``sig`` (default SIGTERM — the preemption notice) to
    ``pid`` (default: this process) after ``delay`` seconds.

    With a delay the signal is sent from a daemon thread and the thread
    object is returned (join it for determinism); ``delay=0`` sends
    inline.
    """
    pid = os.getpid() if pid is None else int(pid)
    if delay <= 0:
        os.kill(pid, sig)
        return None

    def _fire():
        time.sleep(delay)
        os.kill(pid, sig)

    t = threading.Thread(target=_fire, name="preemption-sender",
                         daemon=True)
    t.start()
    return t


class LatencySpike:
    """Callable wrapper that sleeps ``delay`` seconds before delegating,
    for calls ``start <= i < start + count`` (0-indexed; ``count=None``
    = every call from ``start`` on) — a deterministic slow-device /
    GC-pause injection for deadline and SLO tests."""

    def __init__(self, fn, delay, start=0, count=None):
        self._fn = fn
        self.delay = float(delay)
        self._start = int(start)
        self._count = count if count is None else int(count)
        self.calls = 0
        self.spiked = 0

    def __call__(self, *args, **kwargs):
        i = self.calls
        self.calls += 1
        if i >= self._start and (self._count is None
                                 or i < self._start + self._count):
            self.spiked += 1
            time.sleep(self.delay)
        return self._fn(*args, **kwargs)


class StallingCallable:
    """Callable wrapper whose calls from number ``stall_after`` on
    either block until :meth:`release` (``exc=None`` — the
    hung-device stall a watchdog must detect) or raise ``exc`` (the
    fail-fast replica fault).

    ``stalled`` is set while a caller is blocked (wait on it for
    deterministic test ordering); ``release()`` unblocks every current
    and future call.  ``exc_on_release`` makes a blocked call raise
    when unblocked instead of returning — the hang that ends in a
    device error rather than a late result.
    """

    def __init__(self, fn, stall_after=0, exc=None, exc_on_release=None):
        self._fn = fn
        self._after = int(stall_after)
        self._exc = exc
        self._exc_on_release = exc_on_release
        self.calls = 0
        self.stalled = threading.Event()
        self._released = threading.Event()

    def release(self):
        """Unblock all blocked and future calls (heal the device)."""
        self._released.set()

    def __call__(self, *args, **kwargs):
        i = self.calls
        self.calls += 1
        if i >= self._after and not self._released.is_set():
            if self._exc is not None:
                raise self._exc
            self.stalled.set()
            self._released.wait()
            self.stalled.clear()
            if self._exc_on_release is not None:
                raise self._exc_on_release
        return self._fn(*args, **kwargs)


@contextlib.contextmanager
def transient_device_put_failures(failures, exc=None):
    """Patch the serving upload's host-to-card copy
    (``serving._device_put``) so its first ``failures`` calls raise
    ``exc`` (default ``RuntimeError`` — the retryable transfer class),
    then behave normally — the transient-transfer fault the upload retry
    absorbs.  Yields the counting wrapper."""
    from .. import serving

    exc = exc if exc is not None else RuntimeError(
        "injected transient device_put failure")
    orig = serving._device_put
    wrapper = FlakyCallable(failures, fn=orig, exc=exc)
    serving._device_put = wrapper
    try:
        yield wrapper
    finally:
        serving._device_put = orig


class FlakyCallable:
    """Callable that raises ``exc`` for the first ``failures`` calls,
    then delegates to ``fn`` (default: return ``value``)."""

    def __init__(self, failures, fn=None, value=None,
                 exc=OSError("injected transient failure")):
        self.failures = int(failures)
        self.calls = 0
        self._fn = fn
        self._value = value
        self._exc = exc

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls <= self.failures:
            raise self._exc
        if self._fn is not None:
            return self._fn(*args, **kwargs)
        return self._value


# ---------------------------------------------------------------------------
# wire-level injectors — hostile HTTP clients the
# chaos matrix drives against a live Gateway, raw sockets only so every
# malformation is byte-exact and deterministic
# ---------------------------------------------------------------------------

def _connect(host, port, timeout=10.0):
    import socket

    s = socket.create_connection((host, int(port)), timeout=timeout)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return s


def _recv_response(sock, timeout=10.0):
    """Read until the peer closes (the gateway sends
    ``Connection: close``); returns ``(status_code, raw_bytes)``."""
    import socket

    sock.settimeout(timeout)
    data = b""
    try:
        while True:
            chunk = sock.recv(65536)
            if not chunk:
                break
            data += chunk
    except socket.timeout:
        pass
    status = 0
    head = data.split(b"\r\n", 1)[0].split()
    if len(head) >= 2 and head[0].startswith(b"HTTP/"):
        try:
            status = int(head[1])
        except ValueError:
            pass
    return status, data


def slow_loris_post(host, port, path, body, headers=None,
                    trickle_delay_s=0.2, bytes_per_trickle=1,
                    give_up_s=30.0):
    """The slow-loris body: declare the full Content-Length, then
    trickle ``bytes_per_trickle`` of the body every ``trickle_delay_s``
    — slower than any sane read timeout.  Returns ``(status, raw)``
    once the server (correctly) cuts the request (408 from the
    gateway)."""
    import socket

    if isinstance(body, str):
        body = body.encode("utf-8")
    s = _connect(host, port, timeout=give_up_s)
    try:
        head = ["POST %s HTTP/1.1" % path,
                "Host: %s:%d" % (host, int(port)),
                "Content-Type: application/json",
                "Content-Length: %d" % len(body)]
        for k, v in (headers or {}).items():
            head.append("%s: %s" % (k, v))
        s.sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))
        sent = 0
        t_end = time.monotonic() + give_up_s
        while sent < len(body) and time.monotonic() < t_end:
            # the server may answer (and close) mid-trickle: that IS
            # the pass condition, surface it instead of ECONNRESET
            s.settimeout(trickle_delay_s)
            try:
                peek = s.recv(1, socket.MSG_PEEK)
                if peek:
                    return _recv_response(s, timeout=give_up_s)
                break                      # orderly close, no bytes
            except socket.timeout:
                pass                       # no answer yet: keep dripping
            try:
                s.sendall(body[sent:sent + bytes_per_trickle])
            except OSError:
                break                      # server cut us mid-send
            sent += bytes_per_trickle
        return _recv_response(s, timeout=give_up_s)
    finally:
        s.close()


def disconnecting_stream_post(host, port, path, body, headers=None,
                              read_bytes=1, rst=True, timeout=30.0):
    """Open a streaming request, read ``read_bytes`` of the response
    body (so the stream is live), then vanish — with ``rst`` the close
    carries SO_LINGER=0 (TCP RST), so the server's next write fails
    immediately instead of buffering into a dead socket.  Returns
    ``(status, bytes_read_before_disconnect)``."""
    import socket

    if isinstance(body, str):
        body = body.encode("utf-8")
    s = _connect(host, port, timeout=timeout)
    try:
        head = ["POST %s HTTP/1.1" % path,
                "Host: %s:%d" % (host, int(port)),
                "Content-Type: application/json",
                "Content-Length: %d" % len(body)]
        for k, v in (headers or {}).items():
            head.append("%s: %s" % (k, v))
        s.sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                  + body)
        s.settimeout(timeout)
        data = b""
        # read past the header block, then ``read_bytes`` of body
        while b"\r\n\r\n" not in data:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
        header, _, bodypart = data.partition(b"\r\n\r\n")
        while len(bodypart) < read_bytes:
            chunk = s.recv(4096)
            if not chunk:
                break
            bodypart += chunk
        status = 0
        first = header.split(b"\r\n", 1)[0].split()
        if len(first) >= 2:
            try:
                status = int(first[1])
            except ValueError:
                pass
        if rst:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct_pack_linger())
        return status, len(bodypart)
    finally:
        s.close()


def struct_pack_linger():
    """SO_LINGER {on, 0s}: close() sends RST instead of FIN, so the
    peer's next write hits ECONNRESET/EPIPE at once — the
    deterministic mid-stream disconnect."""
    import struct

    return struct.pack("ii", 1, 0)


def malformed_post(host, port, path, raw_body=b"{not json",
                   headers=None, content_length=None, timeout=10.0):
    """A syntactically-valid HTTP request carrying a broken payload
    (bad JSON by default; pass ``content_length`` to lie about the
    size — larger than sent = truncated body).  Returns
    ``(status, raw)``."""
    s = _connect(host, port, timeout=timeout)
    try:
        if isinstance(raw_body, str):
            raw_body = raw_body.encode("utf-8")
        n = len(raw_body) if content_length is None else content_length
        head = ["POST %s HTTP/1.1" % path,
                "Host: %s:%d" % (host, int(port)),
                "Content-Type: application/json",
                "Content-Length: %d" % n]
        for k, v in (headers or {}).items():
            head.append("%s: %s" % (k, v))
        s.sendall(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                  + raw_body)
        return _recv_response(s, timeout=timeout)
    finally:
        s.close()


def oversized_post(host, port, path, claim_bytes, headers=None,
                   timeout=10.0):
    """Claim a ``claim_bytes`` Content-Length (send nothing): a
    correct server refuses by the header alone (413) without reading —
    the memory-bomb probe.  Returns ``(status, raw)``."""
    return malformed_post(host, port, path, raw_body=b"",
                          headers=headers, content_length=claim_bytes,
                          timeout=timeout)
