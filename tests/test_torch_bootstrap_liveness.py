"""Initial-bootstrap liveness on the port: the counterpart of
tests/test_bootstrap_liveness.py, with the same injection and asserts
against the port's tracker, protocol and workers.  A worker that dies
between its tracker check-in and dialing its peers must not strand its
accept-side peers: one link-building pass is bounded
(``rabit_bootstrap_timeout_sec``), the survivors then re-enter the tracker
as a recovery wave, and the robust engine's watchdog covers the initial
Init.

The fault is injected by speaking the tracker's wire protocol: the test
checks in as task "0" (rank 0, the pure dialer at world 3, so both
survivors sit on the accept side), receives its assignment and silently
goes away.  The workers are tests/workers/torch_basic_worker.py with
``lazy=0``: under the native engine every checkpoint of a job must carry a
local model or none, and its default matrix follows one with a lazy
checkpoint.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

from rabit_tpu_torch.tracker import protocol
from rabit_tpu_torch.tracker.tracker import Tracker

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "workers" / "torch_basic_worker.py"


def _spawn(tracker, task_id: str, *extra: str) -> subprocess.Popen:
    env = dict(os.environ)
    env.update(
        PYTHONPATH=f"{REPO}:{env.get('PYTHONPATH', '')}",
        DMLC_TRACKER_URI=tracker.host,
        DMLC_TRACKER_PORT=str(tracker.port),
        DMLC_TASK_ID=task_id,
    )
    return subprocess.Popen(
        [sys.executable, str(WORKER), "rabit_engine=native", "200", "lazy=0", *extra],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )


def _checkin_then_vanish(tracker) -> None:
    """Check in as task "0", wait for the assignment (wave complete), then
    disappear without dialing anyone — the exact death window."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    port = lst.getsockname()[1]
    # Generous timeout: the wave assignment arrives only after BOTH real
    # workers check in, and their process startup can take tens of seconds
    # when the suite runs under heavy parallel load.  The timeout exists
    # only to bound a genuine hang, not to race worker startup.
    tr = socket.create_connection((tracker.host, tracker.port), timeout=120)
    tr.sendall(
        protocol.put_u32(protocol.MAGIC_HELLO)
        + protocol.put_u32(protocol.CMD_START)
        + protocol.put_i32(-1)
        + protocol.put_str("0")
        + protocol.put_u32(port)
    )
    asg = protocol.Assignment.recv(tr)
    assert asg.rank == 0, f"fake worker expected rank 0, got {asg.rank}"
    tr.close()
    lst.close()  # dead: listener gone, no dials will ever happen


def _drain(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_death_between_checkin_and_dial_recovers(tmp_path):
    """Survivors re-wave after the bootstrap timeout and the restarted
    worker completes the job: all three exit 0."""
    tracker = Tracker(world_size=3, quiet=True).start()
    args = ("rabit_bootstrap_timeout_sec=2", "rabit_stall_timeout_sec=2")
    procs = []
    try:
        procs = [_spawn(tracker, t, *args) for t in ("1", "2")]
        _checkin_then_vanish(tracker)
        # Survivors are now blocked waiting for rank 0's dials.  Give them
        # time to hit the bootstrap timeout and re-enter the tracker, then
        # provide the "restarted" worker (same task id, fresh process).
        time.sleep(3.0)
        assert all(p.poll() is None for p in procs), (
            "survivors died instead of re-waving: "
            + "; ".join(p.stderr.read() for p in procs if p.poll() is not None)
        )
        procs.append(_spawn(tracker, "0", *args))
        deadline = time.time() + 60
        while time.time() < deadline and any(p.poll() is None for p in procs):
            time.sleep(0.1)
        rcs = [p.poll() for p in procs]
        errs = [p.stderr.read() if p.stderr else "" for p in procs]
        assert rcs == [0, 0, 0], f"exit codes {rcs}\n" + "\n".join(errs)
    finally:
        _drain(procs)
        tracker.stop()


def test_death_in_bootstrap_never_restarted_aborts(tmp_path):
    """If the dead worker never comes back, survivors must not hang: the
    watchdog (armed across initial Init since round 4) aborts them with
    exit 10 within its bound."""
    tracker = Tracker(world_size=3, quiet=True).start()
    procs = []
    try:
        procs = [
            _spawn(
                tracker, t,
                "rabit_bootstrap_timeout_sec=1", "rabit_timeout_sec=5",
            )
            for t in ("1", "2")
        ]
        _checkin_then_vanish(tracker)
        deadline = time.time() + 40
        while time.time() < deadline and any(p.poll() is None for p in procs):
            time.sleep(0.1)
        rcs = [p.poll() for p in procs]
        errs = [p.stderr.read() if p.stderr else "" for p in procs]
        assert rcs == [10, 10], (
            f"survivor exit codes {rcs} (want watchdog 10)\n" + "\n".join(errs)
        )
    finally:
        _drain(procs)
        tracker.stop()
