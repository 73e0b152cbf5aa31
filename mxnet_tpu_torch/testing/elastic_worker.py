"""Subprocess body for the multi-process elastic-checkpoint drills
(parity: mxnet_tpu/testing/elastic_worker.py).

Launched by :class:`mxnet_tpu_torch.testing.faults.WorkerFleet` (tests)
or by hand::

    python -m mxnet_tpu_torch.testing.elastic_worker --dir /tmp/ckpt \\
        --steps 6 --save-every 2

One rank of a deterministic pod, in one of two modes:

* ``--mode protocol`` (default) — no collectives, no process group:
  rank/pod size come from the ``MXNET_DIST_PROC_ID`` /
  ``MXNET_DIST_NUM_PROCS`` env, the "model" is a
  per-rank-owned numpy block updated by a pure function of the step, and
  device sharding is duck-typed through
  :class:`~mxnet_tpu_torch.testing.faults.FakeShardedArray`.  Everything the
  sharded checkpoint layer does — per-host shard write, digest sidecar,
  cross-host barrier, process-0 manifest commit, restricted elastic
  restore, coordinated preemption — runs for REAL across OS processes,
  and because no floating-point reduction ever crosses ranks the
  trajectory is bit-for-bit identical on ANY topology (save on N,
  resume on N/2 or 1).  This is what makes the kill-and-resume matrix
  deterministic on a CPU-only host.
* ``--mode trainer`` — the full path across processes: a sharded
  ``ShardedTrainer`` joined to a process group.  It needs the
  distributed bootstrap and the sharded trainer, which are not ported
  yet, and raises ``MXNetError`` saying so.

Fault hooks (deterministic, keyed on step + rank):

* ``--kill-save-step S --kill-save-rank R`` — rank R hard-dies
  (``os._exit``) MID-shard-write during the save at step S via
  :func:`faults.kill_on_atomic_write`; surviving ranks hit the shard
  barrier timeout, print ``ELASTIC_SAVE_ABORTED`` and exit 3.
* ``--preempt-step S --preempt-rank R`` — rank R SIGTERMs itself right
  before step S: the coordinated handler publishes the commit flag and
  ALL ranks converge on ONE final manifest (``ELASTIC_PREEMPT_COMMIT``).

Markers on stdout (machine-parsed by tests/test_torch_elastic_checkpoint.py):

* ``ELASTIC_RESUMED rank=R step=S``
* ``ELASTIC_BLOCK rank=R step=S block=B <sha256>`` — protocol mode:
  digest of fixed row-block B of the state; block granularity is
  topology-independent, so digests compare across pod sizes.
* ``ELASTIC_SAVE_ABORTED rank=R step=S kind=<exc>`` (exit 3)
* ``ELASTIC_PREEMPT_COMMIT rank=R step=S``
* ``ELASTIC_DONE rank=R step=S``
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

ROWS_PER_BLOCK = 4
D = 6


# ---------------------------------------------------------------------------
# protocol mode: the commit protocol across real processes, no collectives
# ---------------------------------------------------------------------------

def _protocol_init(blocks):
    import numpy as np

    rng = np.random.RandomState(7)
    W = (rng.rand(blocks * ROWS_PER_BLOCK, D) * 0.1).astype(np.float32)
    M = np.zeros_like(W)
    return W, M


def _protocol_update(W, M, step, lo, hi):
    """One training 'step' on this rank's rows — a pure function of
    (state, step) touching ONLY [lo:hi), so the global trajectory is the
    concatenation of independent per-block trajectories: identical bytes
    no matter how many ranks computed it."""
    import numpy as np

    G = np.random.RandomState(1000 + int(step)) \
        .rand(*W.shape).astype(np.float32)
    W[lo:hi] = 0.9 * W[lo:hi] + 0.1 * G[lo:hi]
    M[lo:hi] = 0.8 * M[lo:hi] + 0.2 * W[lo:hi]


def _emit_blocks(W, M, blocks, lo, hi, rank, step):
    import numpy as np

    for b in range(blocks):
        blo, bhi = b * ROWS_PER_BLOCK, (b + 1) * ROWS_PER_BLOCK
        if blo < lo or bhi > hi:
            continue  # not (wholly) this rank's — peer prints it
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(W[blo:bhi]).tobytes())
        h.update(np.ascontiguousarray(M[blo:bhi]).tobytes())
        print("ELASTIC_BLOCK rank=%d step=%d block=%d %s"
              % (rank, step, b, h.hexdigest()), flush=True)


def _attach_barrier(directory, run_id, rank, nprocs, mgr, timeout=60.0):
    """Startup rendezvous: rank 0 sweeps aborted-save debris, THEN every
    rank writes an attach mark and waits for all N — no rank can begin
    its first save while the sweep might still be running."""
    if nprocs <= 1:
        mgr.sweep_orphans()
        return
    from mxnet_tpu_torch.checkpoint import atomic_write

    def _wait_for(paths, deadline):
        while not all(os.path.exists(p) for p in paths):
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "attach barrier timed out (run %s rank %d)"
                    % (run_id, rank))
            time.sleep(0.02)

    deadline = time.monotonic() + timeout
    marks = [os.path.join(directory, ".attach-%s-%d" % (run_id, r))
             for r in range(nprocs)]
    if rank == 0:
        for f in os.listdir(directory):
            if f.startswith(".attach-") and \
                    not f.startswith(".attach-%s-" % run_id):
                try:
                    os.unlink(os.path.join(directory, f))
                except OSError:
                    pass
        mgr.sweep_orphans()
    else:
        # the sweep unlinks stray *.tmp in the dir — including an
        # in-flight atomic mark — so peers hold their marks until rank
        # 0's post-sweep mark proves the sweep is over
        _wait_for(marks[:1], deadline)
    atomic_write(marks[rank], "1")
    _wait_for(marks, deadline)


def run_protocol(a):
    import numpy as np

    from mxnet_tpu_torch import checkpoint as ck
    from mxnet_tpu_torch.testing import faults

    rank = max(0, int(os.environ.get("MXNET_DIST_PROC_ID", "0")))
    nprocs = max(1, int(os.environ.get("MXNET_DIST_NUM_PROCS", "1")))
    blocks = int(a.blocks)
    if blocks % nprocs:
        raise SystemExit("--blocks %d not divisible by %d ranks"
                         % (blocks, nprocs))
    rows = blocks * ROWS_PER_BLOCK
    lo, hi = rank * rows // nprocs, (rank + 1) * rows // nprocs

    W, M = _protocol_init(blocks)
    mgr = ck.CheckpointManager(a.dir, keep_last=a.keep_last,
                               async_save=False, sharded=True,
                               process_index=rank, process_count=nprocs)
    _attach_barrier(a.dir, a.run_id, rank, nprocs, mgr)

    if a.kill_save_step > 0 and rank == a.kill_save_rank:
        faults.kill_on_atomic_write(os.path.join(
            os.path.basename(mgr.shard_dir(a.kill_save_step)),
            "shard-%05d.npz" % rank))

    step = 0
    restrict = {"w": [[[lo, hi], [0, D]]],
                "m": [[[lo, hi], [0, D]]]} if nprocs > 1 else None
    ckpt = mgr.load(restrict=restrict,
                    context={"mesh_axes": {"fsdp": nprocs},
                             "layout": "elastic_protocol"})
    if ckpt is not None:
        step = int(ckpt.meta["step"])
        W[lo:hi] = ckpt.arrays["w"][lo:hi]
        M[lo:hi] = ckpt.arrays["m"][lo:hi]
    print("ELASTIC_RESUMED rank=%d step=%d" % (rank, step), flush=True)
    _emit_blocks(W, M, blocks, lo, hi, rank, step)

    def arrays_now():
        return {"w": faults.FakeShardedArray(W, nprocs, rank),
                "m": faults.FakeShardedArray(M, nprocs, rank),
                "rng": np.array([7, step], np.int64)}

    def meta_now(**extra):
        meta = {"kind": "elastic_protocol", "step": int(step),
                "blocks": blocks, "mesh_axes": {"fsdp": nprocs},
                "layout": "elastic_protocol"}
        meta.update(extra)
        return meta

    mgr.install_preemption_handler(
        lambda: (step, arrays_now(), {}, meta_now()),
        coordinated=nprocs > 1)

    def commit_final():
        """The coordinated final save — same pod-wide agreement rule as
        ShardedTrainer._maybe_coordinated_commit: ride a periodic
        boundary (the pod's existing sync points), so every rank picks
        the same step with no new cross-host agreement."""
        mgr.save(step, arrays_now(),
                 meta=meta_now(preempted=True, coordinated=True))
        mgr.preempted = True
        mgr.clear_coordinated_commit()
        print("ELASTIC_PREEMPT_COMMIT rank=%d step=%d"
              % (rank, step), flush=True)

    try:
        while step < a.steps and not mgr.preempted:
            if a.preempt_step == step + 1 and rank == a.preempt_rank:
                faults.send_preemption()  # SIGTERM self -> commit flag
            step += 1
            # per-step pacing: ranks leave a save barrier within one
            # 0.02s sidecar poll of each other, so a step longer than
            # that bounds the skew — a commit flag published at step k
            # is durable before ANY rank's boundary check at k+1
            # (numpy updates alone run in ~0.1ms, far inside the skew)
            time.sleep(0.03)
            _protocol_update(W, M, step, lo, hi)
            _emit_blocks(W, M, blocks, lo, hi, rank, step)
            try:
                req = mgr.coordinated_commit_request()
                periodic = a.save_every and step % a.save_every == 0
                if req is not None and periodic and \
                        step >= int(req.get("target_step", step)):
                    commit_final()
                elif periodic:
                    mgr.save(step, arrays_now(), meta=meta_now())
            except (ck.AtomicWriteError, ck.CheckpointCorruptError) as e:
                print("ELASTIC_SAVE_ABORTED rank=%d step=%d kind=%s"
                      % (rank, step, type(e).__name__), flush=True)
                sys.stdout.flush()
                os._exit(3)
        if not mgr.preempted and \
                mgr.coordinated_commit_request() is not None:
            # end-of-data backstop: every rank exits the loop at the
            # same final step, so committing here stays coordinated
            commit_final()
    finally:
        mgr.uninstall_preemption_handler()
    print("ELASTIC_DONE rank=%d step=%d" % (rank, step), flush=True)


# ---------------------------------------------------------------------------
# trainer mode: the full ShardedTrainer path across processes
# ---------------------------------------------------------------------------

def run_trainer(a):
    from mxnet_tpu_torch.base import MXNetError

    raise MXNetError("elastic_worker --mode trainer is not ported yet: it "
                     "needs the distributed bootstrap and the sharded "
                     "ShardedTrainer (ROADMAP Queue 1 item 8)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", required=True)
    p.add_argument("--mode", choices=("protocol", "trainer"),
                   default="protocol")
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--save-every", type=int, default=2)
    p.add_argument("--keep-last", type=int, default=3)
    p.add_argument("--blocks", type=int, default=2,
                   help="protocol mode: fixed row-block count (state "
                        "rows = 4*blocks); must be divisible by the "
                        "rank count of every topology in the drill")
    p.add_argument("--run-id", default="r0",
                   help="attach-rendezvous namespace; identical across "
                        "the fleet, distinct between reruns on one dir")
    p.add_argument("--kill-save-step", type=int, default=0)
    p.add_argument("--kill-save-rank", type=int, default=-1)
    p.add_argument("--preempt-step", type=int, default=0)
    p.add_argument("--preempt-rank", type=int, default=-1)
    a = p.parse_args(argv)
    if a.mode == "protocol":
        run_protocol(a)
    else:
        run_trainer(a)


if __name__ == "__main__":
    main()
