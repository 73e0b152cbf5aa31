"""Deterministic per-rank worker (parity:
mxnet_tpu/testing/fleet_worker.py) for fleet-observatory drills.

Spawned by ``faults.WorkerFleet`` in ``tests/test_torch_cli.py``: runs a
collective-free synthetic step loop that exercises exactly the
telemetry the ``StepBreakdown`` attribution reads (step span, host
gap, prefetch wait), publishes fleet snapshots into ``--spool``, and
supports the two deterministic injections the tier-1 drill needs —
a straggler (``--straggler-rank``: that rank's data fetch goes through
``faults.LatencySpike``, so its ``data_wait`` bucket is the one that
grows) and a wall-clock skew (``--offset-rank``/``--offset`` feeds
``FleetPublisher(clock_offset=...)``).  ``--die-early-rank`` makes one
rank publish a couple of snapshots then exit, for the dead-rank
staleness drill.

Stdout markers the harness scrapes: ``FLEET_ATTACHED`` after the spool
barrier, ``FLEET_STEP <n>`` per step, ``FLEET_DONE`` on clean exit.

Run via ``WorkerFleet(n, ["-m", "mxnet_tpu_torch.testing.fleet_worker",
"--spool", ..., ...])``; rank identity comes from the
``MXNET_DIST_PROC_ID``/``MXNET_DIST_NUM_PROCS`` env WorkerFleet sets.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--spool", required=True, help="shared fleet spool dir")
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--straggler-rank", type=int, default=-1,
                   help="rank whose data fetch is latency-spiked")
    p.add_argument("--straggle-delay", type=float, default=0.04,
                   help="injected per-fetch delay on the straggler rank")
    p.add_argument("--offset-rank", type=int, default=-1,
                   help="rank publishing with a skewed wall clock")
    p.add_argument("--offset", type=float, default=0.0,
                   help="injected clock offset (seconds) on offset-rank")
    p.add_argument("--die-early-rank", type=int, default=-1,
                   help="rank that publishes at step 2 then exits "
                        "without finishing (dead-rank staleness drill)")
    p.add_argument("--linger", type=float, default=0.0,
                   help="sleep after the final publish (staleness drills)")
    args = p.parse_args(argv)

    rank = int(os.environ.get("MXNET_DIST_PROC_ID", "0"))
    n_procs = int(os.environ.get("MXNET_DIST_NUM_PROCS", "1"))

    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch import tracing
    from mxnet_tpu_torch.fleet import FleetPublisher
    from mxnet_tpu_torch.testing import faults

    tel.enable()
    tel.reset()
    tracing.enable()

    offset = args.offset if rank == args.offset_rank else 0.0
    pub = FleetPublisher(args.spool, rank=rank, n_procs=n_procs,
                         loop="sharded", clock_offset=offset)
    pub.attach()
    print("FLEET_ATTACHED", flush=True)

    def fetch(step):
        time.sleep(0.001)
        return step

    if rank == args.straggler_rank:
        fetch = faults.LatencySpike(fetch, args.straggle_delay)

    for step in range(args.steps):
        g0 = time.perf_counter()
        fetch(step)
        gap = time.perf_counter() - g0
        tel.HOST_GAP_SECONDS.observe(gap, loop="sharded")
        tel.PREFETCH_WAIT_SECONDS.observe(gap)
        t0 = time.perf_counter()
        with tracing.span("train_step", step=step, rank=rank):
            time.sleep(0.002)
        dur = time.perf_counter() - t0
        tel.TRAIN_STEP_SECONDS.observe(dur, loop="sharded")
        tel.TRAIN_STEPS.inc(loop="sharded")
        print("FLEET_STEP %d" % step, flush=True)
        if rank == args.die_early_rank and step == 2:
            pub.publish_once()
            print("FLEET_DIED_EARLY", flush=True)
            return 0

    pub.publish_once()
    if args.linger > 0:
        time.sleep(args.linger)
        pub.publish_once()
    print("FLEET_DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
