"""Distributed job launcher, the port's copy of tools/launch.py (the
reference's tools/launch.py with dmlc-core's local tracker).

    python -m mxnet_tpu_torch.tools.launch -n 2 --launcher local \\
        python -m mxnet_tpu_torch.examples.train_imagenet --benchmark 1 \\
        --kv-store dist_device_sync

starts the port's parameter server (``kvstore_server.run_server``) and N
copies of the command, each told its role through the DMLC_* variables
that ``kvstore.create("dist*")`` reads.  The launcher opens the server's
listening socket itself and hands it over, so a worker can connect before
the server process is up.  The server sees no card
(``CUDA_VISIBLE_DEVICES`` empty): it sums and updates on the host.  If a
worker exits non-zero, the launcher stops the server and the other
workers and exits with that worker's code; once every worker has exited
0 it stops the server and exits 0.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["launch", "main"]

_SERVER = "from mxnet_tpu_torch.kvstore_server import run_server; run_server()"
# how long a process gets to end after SIGTERM before SIGKILL
_GRACE_S = 5.0
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _exit_code(code):
    return 128 - code if code < 0 else code


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + _GRACE_S
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(num_workers, command):
    """Run ``command`` (a list) as ``num_workers`` workers beside one
    parameter server on this machine; returns the exit code (0, or the
    first failing worker's).  Every process it started has ended when it
    returns."""
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.bind(("127.0.0.1", 0))
    listener.listen(num_workers + 2)
    base = dict(os.environ)
    base.update({"DMLC_PS_ROOT_URI": "127.0.0.1",
                 "DMLC_PS_ROOT_PORT": str(listener.getsockname()[1]),
                 "DMLC_NUM_WORKER": str(num_workers),
                 "DMLC_NUM_SERVER": "1"})
    server_env = dict(base, DMLC_ROLE="server", CUDA_VISIBLE_DEVICES="",
                      MXTPU_PS_LISTEN_FD=str(listener.fileno()),
                      PYTHONPATH=os.pathsep.join(
                          p for p in (_ROOT, base.get("PYTHONPATH")) if p))
    procs = []
    try:
        procs.append(subprocess.Popen([sys.executable, "-c", _SERVER],
                                      env=server_env,
                                      pass_fds=(listener.fileno(),)))
        listener.close()    # the server holds the socket now
        for rank in range(num_workers):
            procs.append(subprocess.Popen(command, env=dict(
                base, DMLC_ROLE="worker", DMLC_RANK=str(rank),
                DMLC_WORKER_RANK=str(rank))))
        live = procs[1:]
        while live:
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0:
                    return _exit_code(code)
            time.sleep(0.05)
        # every worker is done: the server ends as their sockets close
        try:
            procs[0].wait(timeout=_GRACE_S)
        except subprocess.TimeoutExpired:
            pass
        return 0
    finally:
        listener.close()
        _stop(procs)


def _on_signal(signum, _frame):
    raise SystemExit(128 + signum)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Launch a distributed job")
    parser.add_argument("-n", "--num-workers", type=int, required=True)
    parser.add_argument("-s", "--num-servers", type=int, default=1,
                        help="accepted for parity; one server serves all")
    parser.add_argument("--launcher", default="local", choices=["local"],
                        help="a multi-host job sets the DMLC_* variables "
                             "on each host")
    parser.add_argument("--sync-dst-dir", default=None)
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if not args.command:
        parser.error("no command to launch")
    signal.signal(signal.SIGTERM, _on_signal)
    sys.exit(launch(args.num_workers, args.command))


if __name__ == "__main__":
    main()
