"""Deterministic per-rank worker (parity:
mxnet_tpu/testing/goodput_worker.py) for goodput-ledger kill/resume drills.

Spawned by ``faults.WorkerFleet`` in ``tests/test_torch_cli.py``: runs a
collective-free synthetic step loop that exercises exactly the
producers the goodput ledger reads — a :class:`GoodputRecorder` begun
with the real resume provenance, ``productive_step`` segments per
step, periodic *committed* ``ckpt_save`` segments through a real
per-rank :class:`CheckpointManager` (the ``_note_goodput_save`` hook),
a ``ckpt_restore`` segment on resume, and a small injected
``data_wait`` per step.  ``--kill-rank``/``--kill-step`` make one rank
SIGKILL itself mid-run — no ``incarnation_end`` record lands, which is
exactly the evidence the reader prices as lost work.  A second fleet
run over the same dirs resumes from the last committed checkpoint and
exits cleanly.

Stdout markers the harness scrapes: ``GOODPUT_RESUMED <step>`` after
the (possibly empty) restore, ``GOODPUT_STEP <n>`` per step,
``GOODPUT_SAVED <n>`` per committed save, ``GOODPUT_KILL_WALL <s>``
right before the self-SIGKILL, ``GOODPUT_WALL <s>`` (the externally-
timed incarnation wall, measured WITHOUT the ledger) and
``GOODPUT_DONE`` on clean exit.

Run via ``WorkerFleet(n, ["-m", "mxnet_tpu_torch.testing.goodput_worker",
"--dir", ..., "--ckpt", ...])``; rank identity comes from the
``MXNET_DIST_PROC_ID`` env WorkerFleet sets.
"""
from __future__ import annotations

import argparse
import os
import signal
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dir", required=True, help="goodput job dir")
    p.add_argument("--ckpt", required=True,
                   help="checkpoint root (per-rank subdirs)")
    p.add_argument("--steps", type=int, default=12,
                   help="target final global step")
    p.add_argument("--step-time", type=float, default=0.03,
                   help="synthetic productive seconds per step")
    p.add_argument("--save-every", type=int, default=4,
                   help="commit a checkpoint every N steps")
    p.add_argument("--kill-rank", type=int, default=-1,
                   help="rank that SIGKILLs itself at --kill-step")
    p.add_argument("--kill-step", type=int, default=-1,
                   help="global step after which --kill-rank dies")
    p.add_argument("--data-wait", type=float, default=0.002,
                   help="injected data_wait seconds per step")
    args = p.parse_args(argv)

    rank = int(os.environ.get("MXNET_DIST_PROC_ID", "0"))

    import numpy as np

    from mxnet_tpu_torch import goodput
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.checkpoint import CheckpointManager

    tel.enable()
    tel.reset()

    t_wall0 = time.time()   # the EXTERNAL clock the sum-to-wall
    # invariant is checked against — independent of the ledger

    manager = CheckpointManager(os.path.join(args.ckpt, "r%d" % rank),
                                async_save=False, sharded=False)
    peek = manager.latest_step()   # manifest presence only: the
    # recorder must begin with the resume provenance BEFORE the real
    # (digest-verified) load, so the CheckpointManager goodput hook
    # records the ckpt_restore segment itself
    rec = goodput.GoodputRecorder(args.dir, rank=rank,
                                  flush_every=4).begin(
        start_reason="resume" if peek is not None else "fresh",
        resumed_from_step=peek,
        started_at=t_wall0)
    ckpt = manager.load()
    start_step = int(ckpt.step) if ckpt is not None else 0
    print("GOODPUT_RESUMED %d" % start_step, flush=True)

    step = start_step
    for step in range(start_step + 1, args.steps + 1):
        time.sleep(args.data_wait)
        goodput.record_segment("data_wait", args.data_wait)
        t0 = time.perf_counter()
        time.sleep(args.step_time)
        rec.segment("productive_step", time.perf_counter() - t0,
                    step=step)
        print("GOODPUT_STEP %d" % step, flush=True)
        if args.save_every and step % args.save_every == 0:
            # a real manager save: the ckpt_save segment (committed,
            # step-tagged) lands via the CheckpointManager goodput hook
            manager.save(step, {"w": np.full(4, float(step))},
                         meta={"step": step}, block=True)
            print("GOODPUT_SAVED %d" % step, flush=True)
        if rank == args.kill_rank and step == args.kill_step:
            # the preemptor that never says goodbye: no end record, no
            # atexit, no flush past the last sidecar cadence
            print("GOODPUT_KILL_WALL %.6f" % (time.time() - t_wall0),
                  flush=True)
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGKILL)
    rec.segment("drain", 0.0, step=step)
    goodput.note_exit("clean", step=step)
    print("GOODPUT_WALL %.6f" % (time.time() - t_wall0), flush=True)
    print("GOODPUT_DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
