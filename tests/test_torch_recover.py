"""Kill-and-recover under the port's own engine, tracker and launcher.

The scenario matrix of tests/test_recover.py, run with the port's copy of
its self-verifying worker (tests/workers/torch_recover_worker.py) on
``rabit_tpu_torch.engine.native`` (``rabit_engine=mock``) under
``rabit_tpu_torch.tracker.launcher.LocalCluster``: the worker dies at exact
(rank, version, seqno, trial) points, the launcher restarts it, and the new
life recovers from its peers with every closed-form check passing.  Then
the two packages across each other, each side in its own processes: JAX's
worker under the port's launcher, and the port's worker under JAX's.

Op layout per iteration: seq 0 the MAX allreduce, seq 1/2 the broadcast's
length and payload, seq 3 the SUM allreduce, seq 4 the allgather; -1 kills
at the checkpoint's entry, -2 at load_checkpoint's, -3 in the commit window.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

from rabit_tpu.tracker.launcher import LocalCluster as JaxCluster
from rabit_tpu_torch.engine import native
from rabit_tpu_torch.tracker.launcher import LocalCluster

WORKERS = Path(__file__).parent / "workers"
WORKER = str(WORKERS / "torch_recover_worker.py")


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's library, built once before the workers load it."""
    native.build_lib()


def run(cluster_cls, worker: str, nworkers: int, args: list[str], max_restarts=10,
        timeout=120.0):
    cluster = cluster_cls(nworkers, max_restarts=max_restarts, quiet=True)
    assert cluster.run([sys.executable, worker, "rabit_engine=mock", *args],
                       timeout=timeout) == 0
    assert all(rc == 0 for rc in cluster.returncodes.values())
    verified = [m for m in cluster.messages if "iterations verified" in m]
    assert len(verified) == nworkers, list(cluster.messages)
    return cluster


# (workers, args, restarts per task id), after tests/test_recover.py
SCENARIOS = {
    "no-failure": (4, ["niter=3"], {}),
    "single-death": (4, ["niter=3", "mock=0,1,1,0"], {"0": 1}),
    "death-at-first-op": (4, ["niter=3", "mock=2,0,0,0"], {"2": 1}),
    "die-same-seqno": (6, ["niter=3", "mock=0,0,1,0;1,1,1,0;0,1,1,0;4,1,1,0;5,1,1,0"],
                       {"0": 1, "1": 1, "4": 1, "5": 1}),
    "die-hard": (4, ["niter=3", "mock=1,1,1,0;1,1,1,1"], {"1": 2}),
    "ring-path": (4, ["niter=3", "ndata=2048", "rabit_reduce_ring_mincount=1",
                      "mock=3,1,0,0"], {"3": 1}),
    "local-checkpoint": (4, ["niter=4", "local=1", "mock=2,2,3,0"], {"2": 1}),
    "lazy-checkpoint": (4, ["niter=3", "lazy=1", "mock=1,2,0,0"], {"1": 1}),
    # F1: the restarted life replays its pre-load_checkpoint broadcast from
    # the bootstrap cache by the call site's key
    "bootstrap-cache-replay": (4, ["niter=3", "preload_op=1", "rabit_bootstrap_cache=1",
                                   "mock=1,1,3,0"], {"1": 1}),
    "death-before-first-checkpoint": (4, ["niter=3", "preload_op=1",
                                          "rabit_bootstrap_cache=1", "mock=2,0,3,0"],
                                      {"2": 1}),
    "checkpoint-entry": (4, ["niter=3", "mock=1,1,-1,0"], {"1": 1}),
    "load-checkpoint-entry": (4, ["niter=3", "mock=2,1,0,0;2,0,-2,1"], {"2": 2}),
    "commit-window": (4, ["niter=3", "local=1", "mock=1,1,-3,0"], {"1": 1}),
    "commit-window-global-only": (4, ["niter=3", "mock=2,2,-3,0"], {"2": 1}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_recover_scenario(name):
    nworkers, args, restarts = SCENARIOS[name]
    cluster = run(LocalCluster, WORKER, nworkers, args)
    assert cluster.restarts == {str(i): restarts.get(str(i), 0) for i in range(nworkers)}
    if restarts:
        assert any("recovered version=" in m for m in cluster.messages)


@pytest.mark.parametrize("side", ["jax-worker-port-launcher", "port-worker-jax-launcher"])
def test_interop(side):
    """The two packages' trackers and engines speak one protocol: a kill
    mid-iteration recovers either way round."""
    if side == "jax-worker-port-launcher":
        cluster = run(LocalCluster, str(WORKERS / "recover_worker.py"), 4,
                      ["niter=3", "preload_op=1", "rabit_bootstrap_cache=1",
                       "mock=1,1,3,0"])
    else:
        cluster = run(JaxCluster, WORKER, 4, ["niter=3", "preload_op=1",
                                              "rabit_bootstrap_cache=1", "mock=1,1,3,0"])
    assert cluster.restarts["1"] == 1
