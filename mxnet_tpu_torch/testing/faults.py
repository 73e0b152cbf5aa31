"""Fault injection for the checkpoint, fault-tolerance and serving tests
(parity: mxnet_tpu/testing/faults.py).  Nothing here is imported by
production code paths.

* :class:`FailingWriter` / :func:`failing_open` — a file object (or an
  ``open`` patch) that raises ``OSError`` after N bytes, simulating a
  crash/disk-full mid-write.
* :func:`truncate_file` — chop a file's tail (a torn write that *did*
  reach the final path).
* :func:`flip_bit` / :func:`corrupt_file` — silent bit-rot.

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

Sharded-checkpoint faults:

* :func:`kill_on_atomic_write` — hard-kill (``os._exit``) the process
  mid-atomic-write on a matching path: the true kill-mid-save (no
  except/finally cleanup runs, a partial ``.tmp`` stays behind).
* :func:`corrupt_shard` / :func:`drop_shard` — damage or remove one
  process's shard of a committed sharded checkpoint.
* :func:`orphan_shard_dir` / :func:`stale_manifest` — fabricate the two
  halves of an interrupted commit: a shard dir with no manifest, and a
  manifest with no shard payload.
* :class:`FakeShardedArray` — a duck-typed array sharded over processes
  (``sharding.devices_indices_map`` + ``addressable_shards``), so the
  per-process ownership/barrier protocol is testable in one process.
* :class:`WorkerFleet` — spawn N real OS processes with the
  ``MXNET_DIST_NUM_PROCS``/``MXNET_DIST_PROC_ID`` env of a localhost
  job; kill one mid-run; collect per-rank output.

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

__all__ = ["FailingWriter", "failing_open", "truncate_file", "flip_bit",
           "corrupt_file", "poison_batch", "send_preemption",
           "FlakyCallable", "LatencySpike", "StallingCallable",
           "transient_device_put_failures",
           "kill_on_atomic_write", "corrupt_shard", "drop_shard",
           "orphan_shard_dir", "stale_manifest", "FakeShardedArray",
           "WorkerFleet",
           "slow_loris_post", "disconnecting_stream_post",
           "malformed_post", "oversized_post"]


class FailingWriter:
    """File-like wrapper that raises ``OSError`` once ``fail_after``
    bytes have been written — a crash mid-write."""

    def __init__(self, f, fail_after):
        self._f = f
        self._budget = int(fail_after)

    def write(self, data):
        if len(data) > self._budget:
            part = data[:self._budget]
            if part:
                self._f.write(part)
            self._f.flush()
            raise OSError("injected write failure (budget exhausted)")
        self._budget -= len(data)
        return self._f.write(data)

    def __getattr__(self, name):
        return getattr(self._f, name)


def failing_open(fail_after, only_suffix=None, _open=open):
    """An ``open()`` replacement whose writable handles fail after
    ``fail_after`` bytes.  ``only_suffix`` limits injection to matching
    paths (e.g. ``".npz"``); other opens pass through untouched."""
    def opener(path, mode="r", *args, **kwargs):
        f = _open(path, mode, *args, **kwargs)
        if "w" in mode or "a" in mode or "+" in mode:
            if only_suffix is None or str(path).endswith(only_suffix):
                return FailingWriter(f, fail_after)
        return f

    return opener


def truncate_file(path, keep_bytes=None, drop_bytes=None):
    """Truncate ``path``: keep the first ``keep_bytes``, or drop the
    last ``drop_bytes`` (default: drop half)."""
    size = os.path.getsize(path)
    if keep_bytes is None:
        keep_bytes = size - (drop_bytes if drop_bytes is not None
                             else size // 2)
    keep_bytes = max(0, int(keep_bytes))
    with open(path, "rb+") as f:
        f.truncate(keep_bytes)
    return keep_bytes


def flip_bit(path, offset=None, bit=0):
    """Flip one bit in ``path`` (default: middle of the file) — silent
    bit-rot that only a digest can catch."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError("cannot corrupt empty file %r" % (path,))
    if offset is None:
        offset = size // 2
    offset = int(offset) % size
    with open(path, "rb+") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ (1 << (bit % 8))]))
    return offset


def corrupt_file(path, payload=b"\x00garbage\x00"):
    """Overwrite the head of ``path`` with garbage (structural damage —
    the file no longer parses at all)."""
    with open(path, "rb+") as f:
        f.write(payload)


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


def kill_on_atomic_write(match, write_bytes=64, exit_code=137):
    """Patch ``mxnet_tpu_torch.checkpoint.atomic_writer`` so the next write to
    a path containing ``match`` hard-kills the process (``os._exit``)
    after ``write_bytes`` bytes of real payload reached the temp file.

    Unlike :class:`FailingWriter` (an exception the writer's cleanup
    still catches), this is the genuine kill-mid-save: no except/finally
    runs, no atexit, and a partial ``<target>.*.tmp`` stays behind in
    the target directory while the final path never appears.  Returns an
    undo callable (for the rare caller that survives).
    """
    import tempfile

    from .. import checkpoint as _ck

    real = _ck.atomic_writer

    @contextlib.contextmanager
    def patched(path, mode="wb"):
        if match not in os.fspath(path):
            with real(path, mode=mode) as f:
                yield f
            return
        dirname = os.path.dirname(os.path.abspath(path))
        fd, _tmp = tempfile.mkstemp(
            dir=dirname, prefix=os.path.basename(path) + ".",
            suffix=".tmp")
        f = os.fdopen(fd, mode)

        class _Doomed:
            def __init__(self):
                self._left = int(write_bytes)

            def write(self, data):
                d = data[:self._left] if len(data) > self._left else data
                if d:
                    f.write(d)
                self._left -= len(d)
                if self._left <= 0:
                    f.flush()
                    os.fsync(f.fileno())
                    os._exit(exit_code)
                return len(d)

            def __getattr__(self, name):
                return getattr(f, name)

        yield _Doomed()
        os._exit(exit_code)  # payload smaller than budget: die anyway

    _ck.atomic_writer = patched

    def undo():
        _ck.atomic_writer = real

    return undo


def _ckpt_paths(directory, prefix):
    """A path-helper manager over an existing checkpoint directory."""
    from ..checkpoint import CheckpointManager

    return CheckpointManager(directory, prefix=prefix, async_save=False,
                             sharded=True)


def corrupt_shard(directory, step, host=0, prefix="ckpt", mode="flip"):
    """Damage one host's shard payload of a COMMITTED sharded step:
    ``"flip"`` = one-bit rot in the container (the zip CRC catches it
    as an unreadable shard), ``"tamper"`` = rewrite one chunk's bytes
    inside a structurally VALID npz — invisible to the container, only
    the per-chunk SHA-256 digest catches it — ``"truncate"`` = torn
    tail, anything else = structural garbage.  Returns the shard path.
    """
    import numpy as np

    m = _ckpt_paths(directory, prefix)
    p = m.shard_data_path(step, host)
    if mode == "flip":
        flip_bit(p)
    elif mode == "tamper":
        with np.load(p, allow_pickle=False) as z:
            data = {k: np.array(z[k]) for k in z.files}
        k = sorted(data)[0]
        raw = bytearray(data[k].tobytes())
        raw[0] ^= 0x01
        data[k] = np.frombuffer(bytes(raw), data[k].dtype) \
            .reshape(data[k].shape)
        np.savez(p, **data)
    elif mode == "truncate":
        truncate_file(p)
    else:
        corrupt_file(p)
    return p


def drop_shard(directory, step, host, prefix="ckpt"):
    """Remove one host's shard data + digest sidecar from a committed
    step — the shrunk-host-set / lost-volume scenario; a restore must
    detect the coverage gap and fall back.  Returns removed paths."""
    m = _ckpt_paths(directory, prefix)
    removed = []
    for p in (m.shard_data_path(step, host),
              m.shard_sidecar_path(step, host)):
        try:
            os.unlink(p)
            removed.append(p)
        except OSError:
            pass
    return removed


def orphan_shard_dir(directory, step, prefix="ckpt", n_shards=1):
    """Fabricate an UNCOMMITTED shard dir (payload, no manifest) — the
    debris a kill-mid-save leaves.  Loaders must never see it as a
    checkpoint and the retention/attach sweeps must clear it.  Returns
    the dir path."""
    m = _ckpt_paths(directory, prefix)
    d = m.shard_dir(step)
    os.makedirs(d, exist_ok=True)
    for r in range(int(n_shards)):
        with open(m.shard_data_path(step, r), "wb") as f:
            f.write(b"\x00partial-shard-debris")
    return d


def stale_manifest(directory, step, prefix="ckpt", n_processes=2):
    """Write a committed-LOOKING sharded manifest whose shard payload is
    missing — the orphaned commit mark (e.g. shard dir lost to a bad
    volume).  A load of this step must raise corruption, not garbage.
    Returns the manifest path."""
    import json as _json

    from ..checkpoint import MANIFEST_FORMAT

    m = _ckpt_paths(directory, prefix)
    doc = {
        "format_version": MANIFEST_FORMAT,
        "sharded": True,
        "prefix": prefix,
        "step": int(step),
        "time": 0.0,
        "n_processes": int(n_processes),
        "shard_dir": os.path.basename(m.shard_dir(step)),
        # same shape as a real commit: sidecar filename -> sidecar doc,
        # each naming a data file that does not exist
        "shards": {"shard-%05d.json" % r: {
            "shard_format": 1, "step": int(step), "process_index": r,
            "n_processes": int(n_processes),
            "data_file": "shard-%05d.npz" % r, "data_size": 128,
            "chunks": [{"key": "chunk:00000", "array": "param:0000",
                        "bounds": [[0, 2], [0, 2]], "shape": [2, 2],
                        "dtype": "float32", "sha256": "0" * 64}],
        } for r in range(int(n_processes))},
        "arrays": {"param:0000": {"shape": [2, 2], "dtype": "float32"}},
        "meta": {},
    }
    path = m.manifest_path(step)
    with open(path, "w") as f:
        _json.dump(doc, f)
    return path


class _FakeDevice:
    def __init__(self, process_index, did):
        self.process_index = int(process_index)
        self.id = int(did)

    def __repr__(self):
        return "FakeDevice(p%d,d%d)" % (self.process_index, self.id)


class _FakeShard:
    def __init__(self, index, data):
        self.index = index
        self.data = data


class FakeShardedArray:
    """Duck-typed stand-in for an array sharded over processes.

    Splits a global numpy array into ``n_procs`` equal blocks along
    ``axis``; each fake process addresses exactly one block.  Exposes
    just the surface the sharded checkpoint writer consumes —
    ``shape``/``dtype``, ``sharding.devices_indices_map`` (with
    ``device.process_index``) and ``addressable_shards`` (with
    ``.index``/``.data``) — so the per-host ownership + barrier + commit
    protocol runs for real in one OS process (e.g. two managers on two
    threads), no process group needed.
    """

    def __init__(self, global_np, n_procs, process_index, axis=0):
        import numpy as np

        self._global = np.asarray(global_np)
        self.shape = self._global.shape
        self.dtype = self._global.dtype
        if self.shape[axis] % int(n_procs):
            raise ValueError("axis %d (%d) not divisible by %d"
                             % (axis, self.shape[axis], n_procs))
        self._n = int(n_procs)
        self._me = int(process_index)
        self._axis = int(axis)

    def _index_for(self, rank):
        blk = self.shape[self._axis] // self._n
        idx = [slice(None)] * len(self.shape)
        idx[self._axis] = slice(rank * blk, (rank + 1) * blk)
        return tuple(idx)

    @property
    def sharding(self):
        outer = self

        class _Sharding:
            def devices_indices_map(self, shape):
                return {_FakeDevice(r, r): outer._index_for(r)
                        for r in range(outer._n)}

        return _Sharding()

    @property
    def addressable_shards(self):
        idx = self._index_for(self._me)
        return [_FakeShard(idx, self._global[idx])]


class WorkerFleet:
    """N real OS processes of one localhost job.

    Each rank runs ``[sys.executable] + argv`` (list entries support
    ``{rank}`` substitution) with ``MXNET_DIST_NUM_PROCS/PROC_ID`` set.
    The JAX package's fleet also sets ``MXNET_DIST_COORDINATOR``, the
    address its distributed bootstrap dials; the port has no such
    bootstrap yet, so no rank gets one.  ``dev_per_proc`` is kept for
    the JAX package's signature, where it is the count of virtual CPU
    devices each rank gets; a torch process sees the devices it has, so
    here it changes nothing.
    ``kill(rank)`` delivers a mid-run fault; :meth:`wait` collects
    ``(returncode, output)`` per rank.
    """

    def __init__(self, n_procs, argv, dev_per_proc=1, env=None,
                 cwd=None):
        import subprocess
        import sys

        self.n_procs = int(n_procs)
        self.procs = []
        for r in range(self.n_procs):
            e = dict(os.environ)
            e.update(env or {})
            e["MXNET_DIST_NUM_PROCS"] = str(self.n_procs)
            e["MXNET_DIST_PROC_ID"] = str(r)
            cmd = [sys.executable] + [str(a).format(rank=r) for a in argv]
            self.procs.append(subprocess.Popen(
                cmd, env=e, cwd=cwd, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))

    def kill(self, rank, sig=_signal.SIGKILL):
        """Hard-kill one rank (default SIGKILL — the host that just
        vanished; pass SIGTERM for the polite preemption notice)."""
        self.procs[rank].send_signal(sig)

    def alive(self, rank):
        return self.procs[rank].poll() is None

    def wait(self, timeout=300):
        """Collect every rank: list of ``(returncode, output)`` in rank
        order (a rank that outlives ``timeout`` is killed and reported
        with output suffix ``\\nFLEET_TIMEOUT``)."""
        out = []
        for p in self.procs:
            try:
                o, _ = p.communicate(timeout=timeout)
            except Exception:
                p.kill()
                try:
                    o, _ = p.communicate(timeout=10)
                except Exception:
                    o = ""
                o = (o or "") + "\nFLEET_TIMEOUT"
            out.append((p.returncode, o or ""))
        return out


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
