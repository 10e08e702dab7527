"""The compressed kill-schedule campaign on the port: the counterpart of
tests/test_fuzz_recover.py's ``test_fuzzed_kill_schedule_compressed``, the
same 10 seeds from 5000.  The schedules are the exact campaign's draws with
``rabit_compress_allreduce=i8x2`` forced onto every f32 collective
(``rabit_compress_min_bytes=1``); tests/workers/torch_recover_worker.py
checks the compressed MAX against the port's ``reference_allreduce``
(``codec=i8x2``) bitwise, so a kill mid-flush must still deliver the
reference fold's bits after the replay."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))

from test_torch_fuzz_recover import COMPRESS_SEEDS, run_compressed  # noqa: E402


@pytest.mark.parametrize("seed", COMPRESS_SEEDS, ids=lambda s: f"seed{s}")
def test_fuzzed_kill_schedule_compressed(seed: int):
    run_compressed(seed)
