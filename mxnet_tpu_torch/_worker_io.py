"""The request loop shared by the C ABI workers (``predict_worker``,
``api_worker``): length-prefixed frames on stdin/stdout (the JAX
package's framing, ``cpp/mxtpu_ipc.h``), an error reply that keeps the
worker serving, and the optional ``MXTPU_WORKER_STATS`` record."""
from __future__ import annotations

import json
import os
import struct
import sys
import time


def _read_exact(f, n):
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError("client closed the pipe")
        buf += chunk
    return buf


def _write_stats(who, op_ms):
    """Append this worker's record to ``MXTPU_WORKER_STATS`` (if set):
    the hand-written kernels' launches in this process and each opcode's
    milliseconds in the worker."""
    path = os.environ.get("MXTPU_WORKER_STATS")
    if not path:
        return
    launches = {}
    if "mxnet_tpu_torch.kernels" in sys.modules:
        launches = dict(sys.modules["mxnet_tpu_torch.kernels"].launch_counts)
    with open(path, "a") as f:
        f.write(json.dumps({"worker": who, "pid": os.getpid(),
                            "launches": launches,
                            "op_ms": {str(k): v for k, v in op_ms.items()}})
                + "\n")


def serve(who, ops, wrap=None):
    """Answer requests from stdin on stdout until CLOSE (opcode 0) or the
    client's end of the pipe closes; ``ops`` maps an opcode to a function
    of its payload (``wrap(payload)`` when given) returning the reply."""
    fin = sys.stdin.buffer
    # the wire owns fd 1: duplicate it, then point fd 1 at stderr so
    # native-level writes (CUDA, nvcc, compiler logs) cannot corrupt the
    # length-prefixed protocol; reassigning sys.stdout alone only
    # catches Python-level prints
    fout = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    op_ms = {}
    try:
        while True:
            try:
                head = _read_exact(fin, 9)
            except EOFError:
                return
            opcode, plen = struct.unpack("<BQ", head)
            payload = _read_exact(fin, plen) if plen else b""
            if opcode == 0:
                return
            t0 = time.perf_counter()
            try:
                fn = ops[opcode]
                reply = fn(wrap(payload) if wrap else payload)
                fout.write(struct.pack("<BQ", 0, len(reply)) + reply)
            except Exception as e:  # error reply, keep serving
                msg = ("%s: %s" % (type(e).__name__, e)).encode("utf-8")
                fout.write(struct.pack("<BQ", 1, len(msg)) + msg)
            fout.flush()
            op_ms.setdefault(opcode, []).append(
                (time.perf_counter() - t0) * 1e3)
    finally:
        _write_stats(who, op_ms)
