"""Randomized kill schedules on the port, the second half of
tests/test_fuzz_recover.py's 60 seeds (see tests/test_torch_fuzz_recover.py,
whose runner this file shares)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_fuzz_recover import (  # noqa: E402
    N_SEEDS,
    SEED_BASE,
    SPLIT,
    draw_schedule,
    run_schedule,
)


@pytest.mark.parametrize("seed", range(SPLIT, SEED_BASE + N_SEEDS), ids=lambda s: f"seed{s}")
def test_fuzzed_kill_schedule(seed: int):
    world, args = draw_schedule(seed)
    run_schedule(seed, world, args)
