"""TCP parameter server, the port's copy of mxnet_tpu/kvstore_server.py
(reference: 3rdparty/ps-lite's server/worker roles from DMLC_* variables,
src/kvstore/kvstore_dist_server.h: DataHandleEx :325, the sync round of
ApplyUpdates :346 over ps::NumWorkers() pushes, the pickled optimizer;
python/mxnet/kvstore_server.py).

One server process listens on DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT; each
worker keeps one socket to it.  Messages are 8-byte little-endian lengths
followed by pickles (protocol 4), values are numpy arrays: the JAX
package's wire format.  Sync mode: a push returns once all NumWorkers
pushes of its key are summed and applied.  Async mode (``MXTPU_PS_ASYNC``
or a push's own ``async`` flag): each push applies at once.

Applying a sum: with an optimizer set (``set_optimizer``, the worker's
pickled ``Optimizer``), its ``Updater`` runs on CPU tensors, the state of
each key kept here; without one, the sum is ASSIGNED to the key, as
upstream's server does (``store = merged``).  The JAX server adds it to
the stored value instead (mxnet_tpu/kvstore_server.py:111).

The server is a host process, as ps-lite's is: it creates no CUDA
context (``tools.launch`` starts it with no card visible).  A worker that
drops its connection without ``shutdown`` is a dead rank: every later sync
round and barrier answers its peers with an error instead of waiting.
"""
from __future__ import annotations

import json
import os
import pickle
import socket
import struct
import threading
import time

import numpy as np

__all__ = ["KVServer", "WorkerClient", "run_server", "_init_params"]

_HEADER = struct.Struct("<Q")
_CHUNK = 1 << 22
# how long a worker waits for a refused connection to be accepted (the
# server process may still be starting)
CONNECT_WAIT_S = 60.0
# how long a sync round or barrier waits for its peers
ROUND_WAIT_S = 600.0


def _send_msg(sock, obj):
    payload = pickle.dumps(obj, protocol=4)
    sock.sendall(_HEADER.pack(len(payload)))
    sock.sendall(payload)


def _recv_into(sock, view):
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:], min(_CHUNK, len(view) - got))
        if not n:
            raise ConnectionError("socket closed")
        got += n


def _recv_msg(sock):
    hdr = bytearray(_HEADER.size)
    _recv_into(sock, memoryview(hdr))
    buf = bytearray(_HEADER.unpack(hdr)[0])
    _recv_into(sock, memoryview(buf))
    return pickle.loads(buf)


def _nodelay(sock):
    # a small message (a header, an RPC) must not wait for an ACK
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class KVServer:
    """The server role (KVStoreDistServer parity).  ``sock``, when given,
    is a socket already listening (``tools.launch`` opens it, so workers
    can connect before this process has started)."""

    def __init__(self, host, port, num_workers, sync_mode=True, sock=None):
        self._store = {}
        self._push_buf = {}  # key -> (sum, count, round)
        self._num_workers = num_workers
        self._sync = sync_mode
        self._updater = None
        self._optimizer = None
        self._cv = threading.Condition()
        self._barrier_count = 0
        self._barrier_gen = 0
        # key -> (handler threads blocked on it, the round they wait for)
        self._waiting = {}
        self._divergence = None
        if sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((host, port))
            sock.listen(num_workers + 2)
        self._sock = sock
        self.port = sock.getsockname()[1]
        self._done = threading.Event()
        # ranks whose connection dropped without shutdown
        self._dead = set()
        # the server's profiler (reference KVStoreServerProfilerCommand)
        self._prof_on = False
        self._prof_paused = False
        self._prof_stats = {}
        self._prof_file = "server_profile.json"

    def serve(self):
        """Take NumWorkers connections and answer them until each one ends.
        A connection past those gets an error to its first message."""
        threads = []
        for _ in range(self._num_workers):
            conn, _addr = self._sock.accept()
            _nodelay(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            threads.append(t)
        threading.Thread(target=self._refuse_extra, daemon=True).start()
        for t in threads:
            t.join()

    def close(self):
        """Stop listening (a thread blocked in ``accept`` wakes up)."""
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._sock.close()

    def _refuse_extra(self):
        while True:
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return
            try:
                _recv_msg(conn)
                _send_msg(conn, {"ok": False, "error":
                                 "all %d workers are connected: one dist "
                                 "kvstore a worker process"
                                 % self._num_workers})
            except (ConnectionError, OSError, EOFError):
                pass
            finally:
                conn.close()

    def _apply_update(self, key, agg):
        if self._optimizer is None:
            self._store[key] = agg
            return
        # the optimizer on CPU tensors (ApplyUpdates:346 parity); the
        # weight is updated in a copy, so a pull being pickled on another
        # thread never sees a half-written array
        import torch

        from .ndarray.ndarray import NDArray
        from . import optimizer as opt

        t0 = time.monotonic()
        if self._updater is None:
            self._updater = opt.get_updater(self._optimizer)
        w = NDArray(torch.from_numpy(self._store[key]).clone())
        g = NDArray(torch.from_numpy(np.ascontiguousarray(agg)))
        self._updater(int(key) if key.isdigit() else key, g, w)
        self._store[key] = w._data.numpy()
        self._prof_record("update", time.monotonic() - t0)

    def _wait_error(self):
        if self._dead:
            return {"ok": False,
                    "error": "worker failure detected: dead rank(s) %s"
                             % sorted(self._dead)}
        if self._divergence:
            return {"ok": False, "error": self._divergence}
        return {"ok": False,
                "error": "timed out waiting for peers (no failure "
                         "detected; a worker may be stalled)"}

    def _push_one(self, key, value, async_req=False):
        """Sum or apply one pushed value; returns an error dict or None.
        In sync mode it returns once every worker's value of this key has
        arrived and the sum was applied."""
        if not self._sync or async_req:
            with self._cv:
                self._apply_update(key, value)
            return None
        with self._cv:
            if self._dead:
                return self._wait_error()   # no round with a dead peer
            acc, cnt, gen = self._push_buf.get(key, (0.0, 0, 0))
            acc = value if cnt == 0 else acc + value
            cnt += 1
            if cnt == self._num_workers:
                self._apply_update(key, acc)
                self._push_buf[key] = (0.0, 0, gen + 1)
                self._cv.notify_all()
                return None
            self._push_buf[key] = (acc, cnt, gen)
            target = gen + 1
            # each worker's handler blocks on at most one key, and the
            # worker that completes a round never blocks: so when every
            # worker is blocked (its round not reached) across more than
            # one key, no round can complete.  Fail at once.
            cnt_w, _ = self._waiting.get(key, (0, target))
            self._waiting[key] = (cnt_w + 1, target)
            blocked = [k for k, (c, t) in self._waiting.items()
                       if c > 0 and self._push_buf.get(k, (0.0, 0, 0))[2] < t]
            if (sum(self._waiting[k][0] for k in blocked)
                    >= self._num_workers and len(blocked) > 1
                    and self._divergence is None):
                self._divergence = (
                    "sync push ordering divergence: all %d workers blocked "
                    "across keys %s; every worker must push the same key "
                    "sequence in sync mode"
                    % (self._num_workers, sorted(blocked)))
                self._cv.notify_all()
            self._cv.wait_for(
                lambda: self._push_buf[key][2] >= target or self._dead
                or self._divergence, timeout=ROUND_WAIT_S)
            c2w, t2w = self._waiting[key]
            self._waiting[key] = (c2w - 1, t2w)
            if self._push_buf[key][2] >= target:
                return None
            # a failed round: take this worker's value out again, so that
            # a retry never counts it twice
            a2, c2, g2 = self._push_buf[key]
            if g2 < target and c2 > 0:
                self._push_buf[key] = ((0.0, 0, g2) if c2 == 1
                                       else (a2 - value, c2 - 1, g2))
            err = self._wait_error()
            # the divergent round ends with its last waiter; later rounds
            # start clean
            if not any(c for c, _ in self._waiting.values()):
                self._divergence = None
            return err

    @staticmethod
    def _flag(body, default=False):
        """'1'/'0' and the profiler's 'run'/'stop'."""
        s = str(body or "").strip().lower()
        if s in ("1", "run", "true", "on"):
            return True
        if s in ("0", "stop", "false", "off"):
            return False
        return default

    def _handle_command(self, head, body):
        """The worker-to-server control channel.  The profiler heads follow
        the reference's KVStoreServerProfilerCommand (kvstore.h:49):
        set_config names the dump file and clears the stats, state turns
        them on or off, pause holds them, dump writes {op: [count,
        seconds]} as JSON.  An error comes back as {'ok': False}: an
        exception here would end the handler and mark its rank dead."""
        try:
            if head == "profiler_set_config":
                with self._cv:
                    self._prof_file = str(body or "server_profile.json")
                    self._prof_stats = {}
                return {"ok": True}
            if head == "profiler_state":
                with self._cv:
                    self._prof_on = self._flag(body)
                    self._prof_paused = False
                return {"ok": True}
            if head == "profiler_pause":
                with self._cv:
                    if self._flag(body, default=True):
                        self._prof_paused = self._prof_on
                        self._prof_on = False
                    elif self._prof_paused:
                        # resuming restores the state before the pause
                        self._prof_on = True
                        self._prof_paused = False
                return {"ok": True}
            if head == "profiler_dump":
                with self._cv:
                    stats = dict(self._prof_stats)
                    path = self._prof_file
                from .checkpoint import atomic_write

                atomic_write(path, json.dumps(stats).encode())
                return {"ok": True, "path": path}
            return {"ok": True}   # unknown heads are accepted, as upstream
        except Exception as e:  # noqa: BLE001 - answered, not raised
            return {"ok": False, "error": "server command %r failed: %s"
                                          % (head, e)}

    def _prof_record(self, op, seconds):
        if self._prof_on:
            with self._cv:
                cnt, total = self._prof_stats.get(op, (0, 0.0))
                self._prof_stats[op] = (cnt + 1, total + seconds)

    def _barrier(self):
        with self._cv:
            if self._dead:
                return self._wait_error()
            gen = self._barrier_gen
            self._barrier_count += 1
            if self._barrier_count == self._num_workers:
                self._barrier_count = 0
                self._barrier_gen += 1
                self._cv.notify_all()
                return {"ok": True}
            self._cv.wait_for(lambda: self._barrier_gen > gen or self._dead,
                              timeout=ROUND_WAIT_S)
            if self._barrier_gen > gen:
                return {"ok": True}
            self._barrier_count = max(0, self._barrier_count - 1)
            return self._wait_error()

    def _timed(self, op, fn):
        t0 = time.monotonic()
        out = fn()
        self._prof_record(op, time.monotonic() - t0)
        return out

    def _push_batch(self, msg):
        # one message for a whole step: the keys are summed in order, so
        # every worker's handler walks the same sequence of rounds
        for key, value in msg["items"]:
            err = self._push_one(key, value, msg.get("async"))
            if err:
                return err
        return None

    def _handle(self, conn):
        rank = None
        clean_exit = False
        try:
            while not self._done.is_set():
                msg = _recv_msg(conn)
                op = msg["op"]
                if op == "hello":
                    rank = msg.get("rank")
                    reply = {"ok": True}
                elif op == "health":
                    with self._cv:
                        reply = {"ok": True, "dead": sorted(self._dead)}
                elif op == "init":
                    with self._cv:
                        self._store.setdefault(msg["key"], msg["value"])
                    reply = {"ok": True}
                elif op == "push":
                    reply = self._timed("push", lambda: self._push_one(
                        msg["key"], msg["value"], msg.get("async"))) \
                        or {"ok": True}
                elif op == "push_batch":
                    reply = self._timed("push_batch",
                                        lambda: self._push_batch(msg)) \
                        or {"ok": True}
                elif op == "pull":
                    with self._cv:
                        reply = {"ok": True, "value": self._store[msg["key"]]}
                elif op == "pull_batch":
                    with self._cv:
                        reply = {"ok": True, "values": [
                            self._store[k] for k in msg["keys"]]}
                elif op == "set_optimizer":
                    with self._cv:
                        self._optimizer = pickle.loads(msg["value"])
                        self._updater = None
                    reply = {"ok": True}
                elif op == "barrier":
                    reply = self._barrier()
                elif op == "command":
                    reply = self._handle_command(msg.get("head"),
                                                 msg.get("body"))
                elif op == "shutdown":
                    _send_msg(conn, {"ok": True})
                    self._done.set()
                    clean_exit = True
                    break
                else:
                    reply = {"ok": False, "error": "unknown op %r" % (op,)}
                if op in ("pull", "pull_batch"):
                    self._timed(op, lambda: _send_msg(conn, reply))
                else:
                    _send_msg(conn, reply)
        except (ConnectionError, OSError, EOFError):
            pass
        finally:
            if not clean_exit and not self._done.is_set():
                with self._cv:
                    self._dead.add(-1 if rank is None else int(rank))
                    # with a dead peer no round can complete: drop the
                    # partial sums, so a retry never counts a survivor twice
                    self._push_buf = {k: (0.0, 0, gen) for k, (_a, _c, gen)
                                      in self._push_buf.items()}
                    self._barrier_count = 0
                    self._cv.notify_all()
            conn.close()


class WorkerClient:
    """A worker's connection (ps::KVWorker parity)."""

    def __init__(self, host, port, rank, num_workers):
        self.rank = rank
        self.num_workers = num_workers
        deadline = time.monotonic() + CONNECT_WAIT_S
        while True:
            try:
                self._sock = socket.create_connection(
                    (host, port), timeout=ROUND_WAIT_S)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.1)
        _nodelay(self._sock)
        self._lock = threading.Lock()
        self._rpc(op="hello", rank=rank)

    @classmethod
    def from_env(cls):
        from . import config as _config

        host = os.environ["DMLC_PS_ROOT_URI"]
        port = _config.get("DMLC_PS_ROOT_PORT")
        rank = int(os.environ.get("DMLC_WORKER_RANK",
                                  os.environ.get("DMLC_RANK", "0")))
        return cls(host, port, rank, _config.get("DMLC_NUM_WORKER"))

    def _rpc(self, **msg):
        from .base import MXNetError

        with self._lock:
            _send_msg(self._sock, msg)
            resp = _recv_msg(self._sock)
        if not resp.get("ok", True):
            # a peer died mid-round, the push order diverged, or the
            # server refused the request
            raise MXNetError(resp.get("error", "kvstore server error"))
        return resp

    def health(self):
        """The dead ranks the server has seen so far."""
        return self._rpc(op="health").get("dead", [])

    def init(self, key, value):
        self._rpc(op="init", key=key, value=np.asarray(value))

    def push(self, key, value, sync=True):
        """``sync=False`` applies this push at once on the server instead
        of waiting for the other workers' values."""
        msg = {"op": "push", "key": key, "value": np.asarray(value)}
        if not sync:
            msg["async"] = True
        self._rpc(**msg)

    def pull(self, key):
        return self._rpc(op="pull", key=key)["value"]

    def push_batch(self, items, sync=True):
        """Many (key, value) pushes in one message: a training step's
        gradients in one round trip."""
        msg = {"op": "push_batch",
               "items": [(k, np.asarray(v)) for k, v in items]}
        if not sync:
            msg["async"] = True
        self._rpc(**msg)

    def pull_batch(self, keys):
        return self._rpc(op="pull_batch", keys=list(keys))["values"]

    def set_optimizer(self, pickled):
        self._rpc(op="set_optimizer", value=pickled)

    def barrier(self):
        self._rpc(op="barrier")

    def command(self, head, body):
        return self._rpc(op="command", head=head, body=body)

    def shutdown(self):
        try:
            self._rpc(op="shutdown")
        except ConnectionError:
            pass

    def close(self):
        self._sock.close()


def _init_params():
    from . import config as _config

    return (os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
            _config.get("DMLC_PS_ROOT_PORT"),
            _config.get("DMLC_NUM_WORKER"))


def run_server(sync_mode=None):
    """The entry of a role=server process (parity: kvstore_server.py:64-73,
    MXKVStoreRunServer).  Serves on the socket ``MXTPU_PS_LISTEN_FD`` names,
    else on DMLC_PS_ROOT_PORT of every interface."""
    from . import config as _config

    _host, port, num_workers = _init_params()
    if sync_mode is None:
        sync_mode = not _config.get("MXTPU_PS_ASYNC")
    fd = _config.get("MXTPU_PS_LISTEN_FD")
    sock = socket.socket(fileno=fd) if fd >= 0 else None
    KVServer("0.0.0.0", port, num_workers, sync_mode=sync_mode,
             sock=sock).serve()


if __name__ == "__main__":  # pragma: no cover
    run_server()
