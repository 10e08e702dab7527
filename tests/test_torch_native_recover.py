"""The port's GBDT recovering from kills on the port's own engine, tracker
and launcher: the byte-identical kill cases of
tests/test_torch_hybrid_recover.py (which keeps running over the JAX
package's engine) with the worker on ``rabit_tpu_torch.api``
(tests/workers/torch_gbdt_native_worker.py, ``rabit_engine=mock``), on the
CPU.

Within a run every rank's forest must match (the worker allgathers them);
across runs a kill-and-recover run's forest must equal the clean run's bit
for bit.  Per-version collectives (depth-3 trees): seq 0..2 the level
histograms, seq 3 the leaf masses, then the checkpoint (-3 kills in its
commit window).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

from rabit_tpu_torch.engine import native
from rabit_tpu_torch.tracker.launcher import LocalCluster

WORKER = str(Path(__file__).parent / "workers" / "torch_gbdt_native_worker.py")


def run_cluster(mode, worker_args, out: Path, max_restarts=10, timeout=240.0,
                expect_out=True):
    cmd = [sys.executable, WORKER, "rabit_engine=mock", f"mode={mode}", f"out={out}",
           *worker_args]
    cluster = LocalCluster(4, max_restarts=max_restarts, quiet=True,
                           extra_env={"OMP_NUM_THREADS": "1"})
    assert cluster.run(cmd, timeout=timeout) == 0
    assert all(rc == 0 for rc in cluster.returncodes.values())
    commits = [m for m in cluster.messages if " commit version=" in m]
    assert commits, "no commit stamps"
    if not expect_out:  # a stop_at= run exits before writing the forest
        return cluster, None
    return cluster, np.load(out.with_suffix(".npy"))


@pytest.fixture(scope="module")
def clean_forest(tmp_path_factory):
    """The no-failure forest of each mode; the two modes grow the same one."""
    native.build_lib()
    tmp = tmp_path_factory.mktemp("torch_native")
    forests = {m: run_cluster(m, ["ntrees=4"], tmp / m, max_restarts=0)[1]
               for m in ("hybrid", "gbdt")}
    assert forests["hybrid"].size > 0
    np.testing.assert_array_equal(forests["hybrid"], forests["gbdt"])
    return forests["hybrid"]


@pytest.mark.parametrize("mode,mock", [
    # rank 1 dies at the level-1 histogram of the second tree
    ("hybrid", "mock=1,1,1,0"), ("gbdt", "mock=1,1,1,0"),
    # a leaf-hop death, then a second death on the restarted life (die-hard)
    ("hybrid", "mock=2,0,3,0;2,2,0,1"),
    # death in the checkpoint commit window (post-barrier, pre-release)
    ("hybrid", "mock=3,2,-3,0"),
], ids=["mid-round", "gbdt-mid-round", "leaf-die-hard", "checkpoint-commit"])
def test_kill_and_recover_is_byte_identical(clean_forest, tmp_path, mode, mock):
    cluster, got = run_cluster(mode, ["ntrees=4", mock], tmp_path / "k")
    assert sum(cluster.restarts.values()) == mock.count(";") + 1  # every death happened
    np.testing.assert_array_equal(got, clean_forest)


def test_whole_job_preemption_resume(clean_forest, tmp_path):
    """Every worker stops after tree 2; a second job resumes from
    rabit_checkpoint_dir (forests and per-rank margins from disk) and ends
    in the uninterrupted run's forest."""
    d = f"rabit_checkpoint_dir={tmp_path / 'ckpt'}"
    c1, _ = run_cluster("hybrid", ["ntrees=4", "stop_at=2", d], tmp_path / "j1",
                        max_restarts=0, expect_out=False)
    assert any("stopping after tree 2" in m for m in c1.messages)
    c2, got = run_cluster("hybrid", ["ntrees=4", d], tmp_path / "j2", max_restarts=0)
    assert any("resumed at version 2" in m for m in c2.messages)
    np.testing.assert_array_equal(got, clean_forest)
