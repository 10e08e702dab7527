"""Whole-job preemption and durable resume on the port, fuzzed: the
counterpart of tests/test_fuzz_durable.py, its 15 seeds with the same draws
(its own ``draw_scenario``), arguments and asserts, against the port's
launcher and tests/workers/torch_recover_worker.py.

Each seed draws a world, an iteration count, a kill instant with per-rank
skew, optional local models and checkpoint blobs and optional disk damage
after the kill (one rank's newest file deleted or truncated), SIGKILLs the
whole first job at those instants, then requires a fresh cluster on the
same directory to resume and verify every iteration.  The port's store
(``rabit_tpu_torch.store``) must never yield a readable but wrong
checkpoint, must agree on the newest version every rank can be served, and
must rebuild lost rank-local state instead of crashing.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_fuzz_durable import N_SEEDS, SEED_BASE, draw_scenario  # noqa: E402

from rabit_tpu_torch.tracker.launcher import LocalCluster  # noqa: E402

WORKER = str(Path(__file__).parent / "workers" / "torch_recover_worker.py")


@pytest.mark.parametrize(
    "seed", range(SEED_BASE, SEED_BASE + N_SEEDS),
    ids=lambda s: f"seed{s}")
def test_fuzzed_whole_job_preemption(seed: int, tmp_path):
    sc = draw_scenario(seed)
    args = [f"rabit_checkpoint_dir={tmp_path}", f"niter={sc['niter']}",
            "ndata=1000", "sleep=0.15"]
    if sc["use_local"]:
        args.append("local=1")
    if sc["blob"]:
        args.append("blob_mb=0.25")
    cmd = [sys.executable, WORKER, "rabit_engine=robust", *args]

    # Job 1: SIGKILL every rank at its drawn instant.  With no restart
    # budget the launcher raises on the first observed death and its
    # cleanup SIGKILLs the remaining ranks — the whole-job preemption
    # shape.  Any outcome of this job is legal (it may even finish if the
    # draw outlives the run); the contract under test is entirely about
    # what job 2 finds on disk.
    c1 = LocalCluster(sc["world"], max_restarts=0, quiet=True)
    try:
        # TimeoutError too: LocalCluster raises it on the 90s deadline
        # (it is an OSError subclass, NOT a RuntimeError), and "any
        # outcome of job 1 is legal" includes running out the clock.
        c1.run(cmd, preempt=sc["preempt"], timeout=90.0)
    except (RuntimeError, TimeoutError):
        pass

    kind = "local" if sc["damage"].startswith("local_") else "global"
    # Newest by PARSED version: lexicographic sorting puts v10 before v2,
    # so the damage draw would silently hit a stale file at version >= 10.
    files = sorted(
        tmp_path.glob(f"{kind}_r{sc['damage_rank']}_v*.bin"),
        key=lambda p: int(re.search(r"_v(\d+)", p.name).group(1)))
    if files and sc["damage"].endswith("delete"):
        files[-1].unlink()
    elif files and sc["damage"].endswith("truncate"):
        files[-1].write_bytes(
            files[-1].read_bytes()[: files[-1].stat().st_size // 2])

    # Job 2: fresh cluster, same directory — must resume wherever the
    # kills landed and verify every iteration's closed-form results.
    c2 = LocalCluster(sc["world"], max_restarts=0, quiet=True)
    rc = c2.run(cmd, timeout=90.0)
    detail = (f"seed {seed}: {sc}; resume rc={rc} "
              f"returncodes={c2.returncodes} "
              f"messages={list(c2.messages)[-6:]}")  # bounded deque
    assert rc == 0 and all(r == 0 for r in c2.returncodes.values()), detail
    verified = sum(f"all {sc['niter']} iterations verified" in m
                   for m in c2.messages)
    assert verified == sc["world"], detail
