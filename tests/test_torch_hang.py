"""Hung-peer liveness on the port: the counterpart of tests/test_hang.py,
with the same runs and asserts against the port's tracker and api.  A
wedged (SIGSTOPped) worker must never hang the job: either the stall is
detected and the world recovers (the worker was resumed), or every survivor
aborts within the watchdog's bound.  The mechanisms are the native engine's
zero-progress timeout (``rabit_stall_timeout_sec``) and its recovery
watchdog (``rabit_timeout_sec``, exit code 10).

The workers run under a tracker of this process, not under LocalCluster, so
the test can SIGSTOP and SIGCONT one of them mid-collective.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# Self-verifying loop with a per-iteration sleep so the test has a window
# to stop a worker mid-run.
WORKER_SRC = """
import os, sys, time
import numpy as np
import rabit_tpu_torch as rt

rt.init()
rank, world = rt.get_rank(), rt.get_world_size()
# Tell the test we are past bootstrap, so the SIGSTOP lands mid-iteration
# (the initial wave has its own bounded-bootstrap coverage — see
# test_bootstrap_liveness.py — and this test targets the steady-state
# stall detector, not the bootstrap path).
with open(os.environ["HANG_READY_DIR"] + f"/ready.{rank}", "w") as f:
    f.write("1")
for it in range(40):
    out = rt.allreduce(np.full(16, float(rank + it), np.float64), rt.SUM)
    expect = world * it + world * (world - 1) / 2
    assert np.allclose(out, expect), (it, out[0], expect)
    rt.checkpoint({"it": it})
    time.sleep(0.05)
rt.tracker_print(f"[{rank}] hang-worker done")
rt.finalize()
"""


def spawn_world(world: int, extra_args: list[str], tmp: Path):
    from rabit_tpu_torch.tracker.tracker import Tracker

    worker = tmp / "worker.py"
    worker.write_text(WORKER_SRC)
    ready = tmp / "ready"
    ready.mkdir()
    tracker = Tracker(world_size=world, quiet=True).start()
    procs = []
    for i in range(world):
        env = dict(os.environ)
        env.update(
            PYTHONPATH=f"{REPO}:{env.get('PYTHONPATH', '')}",
            DMLC_TRACKER_URI=tracker.host,
            DMLC_TRACKER_PORT=str(tracker.port),
            DMLC_TASK_ID=str(i),
            HANG_READY_DIR=str(ready),
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), "rabit_engine=native", *extra_args],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True,
        ))
    deadline = time.time() + 60
    while time.time() < deadline and len(list(ready.iterdir())) < world:
        time.sleep(0.05)
    assert len(list(ready.iterdir())) == world, "workers did not finish init"
    return tracker, procs


def cleanup(tracker, procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    tracker.stop()


def test_sigstop_then_resume_recovers(tmp_path):
    """A worker wedged mid-run is detected as a stalled peer; once resumed
    it rejoins the re-formed mesh and the job completes cleanly."""
    tracker, procs = spawn_world(
        3,
        ["rabit_stall_timeout_sec=1", "rabit_timeout_sec=60"],
        tmp_path,
    )
    try:
        time.sleep(0.3)  # into the iteration loop
        os.kill(procs[1].pid, signal.SIGSTOP)
        time.sleep(3.0)  # stall detection (1s) definitely fires
        os.kill(procs[1].pid, signal.SIGCONT)
        deadline = time.time() + 60
        while time.time() < deadline and any(p.poll() is None for p in procs):
            time.sleep(0.1)
        rcs = [p.poll() for p in procs]
        errs = [p.stderr.read() if p.stderr else "" for p in procs]
        assert rcs == [0, 0, 0], f"exit codes {rcs}\n" + "\n".join(errs)
    finally:
        cleanup(tracker, procs)


def test_sigstop_forever_bounded_abort(tmp_path):
    """A permanently wedged worker must NOT hang the survivors forever: the
    default-armed watchdog aborts them (exit 10) within its bound."""
    tracker, procs = spawn_world(
        3,
        ["rabit_stall_timeout_sec=1", "rabit_timeout_sec=3"],
        tmp_path,
    )
    try:
        time.sleep(0.3)
        os.kill(procs[1].pid, signal.SIGSTOP)
        deadline = time.time() + 30
        survivors = [procs[0], procs[2]]
        while time.time() < deadline and any(p.poll() is None for p in survivors):
            time.sleep(0.1)
        rcs = [p.poll() for p in survivors]
        assert rcs == [10, 10], f"survivor exit codes {rcs} (want watchdog 10)"
        assert procs[1].poll() is None  # the wedged one is still stopped
    finally:
        cleanup(tracker, procs)
