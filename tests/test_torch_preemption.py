"""Induced preemption on the port: the counterpart of
tests/test_preemption.py, with the same runs and asserts against the port's
launcher and tests/workers/torch_recover_worker.py.  Timed SIGKILLs land
from outside the process (``LocalCluster(preempt=)``) wherever the worker
is: mid-collective, inside the checkpoint, during another worker's
recovery; the self-verifying workload must still complete with every
element checked.
"""

from __future__ import annotations

import sys
from pathlib import Path

from rabit_tpu_torch.tracker.launcher import LocalCluster

WORKER = str(Path(__file__).parent / "workers" / "torch_recover_worker.py")

# sleep=0.75 x 6 iterations lower-bounds the run at 4.5 s on any machine, so
# the timed kills below always land mid-work; ndata keeps the collectives
# non-trivial.
ARGS = ["rabit_engine=robust", "ndata=50000", "niter=6", "sleep=0.75"]


def run_with_preempts(preempts, nworkers=4, timeout=240.0):
    cmd = [sys.executable, WORKER, *ARGS]
    cluster = LocalCluster(nworkers, max_restarts=10, quiet=True)
    rc = cluster.run(cmd, timeout=timeout, preempt=preempts)
    assert rc == 0
    assert all(r == 0 for r in cluster.returncodes.values())
    return cluster


def test_preempt_single():
    """One worker SIGKILLed ~mid-run recovers and the job verifies."""
    cluster = run_with_preempts([(1.5, 1)])
    assert cluster.preempts_delivered == 1
    assert cluster.restarts["1"] >= 1


def test_preempt_two_at_once():
    """Two workers preempted at the same instant (multi-death)."""
    cluster = run_with_preempts([(1.5, 1), (1.5, 2)])
    assert cluster.preempts_delivered == 2


def test_preempt_repeated_same_rank():
    """The same worker preempted twice — the second kill can land during
    or shortly after its own recovery (die-hard, externally induced)."""
    cluster = run_with_preempts([(1.0, 2), (3.0, 2)])
    assert cluster.preempts_delivered == 2
    assert cluster.restarts["2"] >= 2


def test_preempt_during_bootstrap_window():
    """A kill landing in the startup/bootstrap window (before the first
    collective) must not strand the survivors: the round-4 bounded
    bootstrap re-waves them and the restarted worker completes the job.
    Complements test_bootstrap_liveness's deterministic injection with a
    stochastic external SIGKILL."""
    cmd = [sys.executable, WORKER, *ARGS,
           "rabit_bootstrap_timeout_sec=2"]
    cluster = LocalCluster(4, max_restarts=10, quiet=True)
    rc = cluster.run(cmd, timeout=240.0, preempt=[(0.05, 2)])
    assert rc == 0
    assert all(r == 0 for r in cluster.returncodes.values())
    assert cluster.preempts_delivered == 1
    assert cluster.restarts["2"] >= 1
