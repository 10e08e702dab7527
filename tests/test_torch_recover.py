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


# (workers, args, restarts per task id[, run's max_restarts and timeout]),
# after tests/test_recover.py
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
    # local models checkpointed but not replicated: a valid configuration
    # that must not trip the consistency check
    "local-model-zero-replicas": (4, ["niter=3", "local=1", "rabit_local_replica=0"], {},
                                  {"max_restarts": 0}),
    "local-double-death": (5, ["niter=4", "local=1", "mock=1,2,3,0;3,2,3,0"],
                           {"1": 1, "3": 1}),
    # each result kept by ~2 ranks only: the rotating replicas' drop rule
    "reduced-replica-budget": (6, ["niter=3", "rabit_global_replica=2", "mock=1,1,2,0"],
                               {"1": 1}),
    # one rank still replaying seqnos while the other is served its checkpoint
    "staggered-overlapping-recoveries": (5, ["niter=4", "mock=1,1,1,0;2,1,3,0"],
                                         {"1": 1, "2": 1}),
    "many-iterations-many-deaths": (4, ["niter=5", "mock=0,1,0,0;1,2,3,0;2,3,4,0;3,4,1,0"],
                                    {"0": 1, "1": 1, "2": 1, "3": 1},
                                    {"max_restarts": 10, "timeout": 180.0}),
    # the reference's CI gate: 10 workers x 10k floats, with a die-hard
    # second kill of rank 1 on its second life
    "reference-scale-10-workers-10k": (10, ["niter=3", "ndata=10000",
                                            "mock=0,0,1,0;1,1,1,0;4,1,1,0;9,1,1,0;1,1,1,1"],
                                       {"0": 1, "1": 2, "4": 1, "9": 1},
                                       {"max_restarts": 20, "timeout": 240.0}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_recover_scenario(name):
    nworkers, args, restarts, *limits = SCENARIOS[name]
    cluster = run(LocalCluster, WORKER, nworkers, args, **(limits[0] if limits else {}))
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


def test_recover_stats_lines():
    """tests/test_recover.py:195 on the port: with rabit_recover_stats=1 a
    survivor's failure_detected stamp and the restarted life's recover_stats
    counters at a nonzero version reach the tracker's events, and the
    summary's merge depth a round stays within twice the heap's height."""
    import math

    cluster = run(LocalCluster, WORKER, 4, ["niter=3", "mock=1,1,1,0",
                                            "rabit_recover_stats=1"])
    assert [e for e in cluster.events if e["kind"] == "failure_detected" and "at" in e]
    stats = [e for e in cluster.events
             if e["kind"] == "recover_stats" and e.get("version", 0) > 0]
    assert stats, cluster.events
    fields = stats[0]
    assert fields["summary_rounds"] >= 1 and fields["serve_bytes"] > 0
    depth_per_op = fields["summary_depth"] / fields["summary_rounds"]
    assert 1 <= depth_per_op <= 2 * math.ceil(math.log2(4)) + 1, fields
    if fields["table_rounds"] > 0:
        assert fields["table_hops"] / fields["table_rounds"] == 3, fields  # W - 1 hops
