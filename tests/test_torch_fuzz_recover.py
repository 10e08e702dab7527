"""Randomized kill schedules on the port: the counterpart of
tests/test_fuzz_recover.py, seeds 0-29 of its 60 (the rest are in
tests/test_torch_fuzz_recover_b.py, the compressed campaign's 10 in
tests/test_torch_fuzz_recover_compressed.py; a file runs on one xdist
worker, so the campaign is cut into files by seed range).

Each seed expands, through tests/test_fuzz_recover.py's own
``draw_schedule``, into the same world size, engine options and 1-4 mock
kill entries over (rank, version, seqno, trial) points, the special seqnos
-1 (checkpoint entry), -2 (load entry) and -3 (commit window) included;
tests/workers/torch_recover_worker.py runs the self-verifying workload under
the port's launcher and every closed-form check must pass through every
induced death.  The same environment knobs widen the campaign
(``RABIT_FUZZ_SEEDS``, ``RABIT_FUZZ_SEED_BASE``, ``RABIT_FUZZ_WORLD_MAX``,
``RABIT_FUZZ_COMPRESS_SEEDS``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_fuzz_recover import (  # noqa: E402
    COMPRESS_SEED_BASE,
    N_COMPRESS_SEEDS,
    N_SEEDS,
    SEED_BASE,
    WORLD_MAX,
    draw_schedule,
)

from rabit_tpu_torch.tracker.launcher import LocalCluster  # noqa: E402

WORKER = str(Path(__file__).parent / "workers" / "torch_recover_worker.py")
#: the exact campaign's seeds, cut in two files
SPLIT = SEED_BASE + N_SEEDS // 2
COMPRESS_SEEDS = range(COMPRESS_SEED_BASE, COMPRESS_SEED_BASE + N_COMPRESS_SEEDS)


def run_schedule(seed: int, world: int, args: list[str]) -> None:
    cmd = [sys.executable, WORKER, "rabit_engine=mock", *args]
    cluster = LocalCluster(world, max_restarts=12, quiet=True)
    try:
        rc = cluster.run(cmd, timeout=240.0 * max(1.0, WORLD_MAX / 10.0))
    except Exception as e:  # noqa: BLE001 (re-raised with the recipe to reproduce it)
        raise AssertionError(f"seed {seed} (RABIT_FUZZ_WORLD_MAX={WORLD_MAX}): "
                             f"world={world} args={args!r} failed: {e}") from e
    assert rc == 0, (f"seed {seed} (RABIT_FUZZ_WORLD_MAX={WORLD_MAX}): "
                     f"world={world} args={args!r} rc={rc}")
    assert all(r == 0 for r in cluster.returncodes.values()), (
        f"seed {seed} (RABIT_FUZZ_WORLD_MAX={WORLD_MAX}): world={world} args={args!r} "
        f"returncodes={cluster.returncodes}")


def run_compressed(seed: int) -> None:
    """The compressed campaign: rabit_compress_allreduce=i8x2 on every f32
    collective (min_bytes=1), the MAX checked bitwise against the codec's
    reference fold, through every kill and replay."""
    world, args = draw_schedule(seed)
    args += ["rabit_compress_allreduce=i8x2", "rabit_compress_min_bytes=1", "codec=i8x2"]
    run_schedule(seed, world, args)


@pytest.mark.parametrize("seed", range(SEED_BASE, SPLIT), ids=lambda s: f"seed{s}")
def test_fuzzed_kill_schedule(seed: int):
    world, args = draw_schedule(seed)
    run_schedule(seed, world, args)
