"""The native speed test under the port's launcher: the counterpart of
tests/test_native_unit.py's ``test_speed_test_cluster``, with the same
arguments.  ``native/tests/speed_test.cc`` is built against the port's
native library (``engine.native.build_program``) and run by the port's
``LocalCluster`` at world 4 on the base and robust engines.

tests/test_native_unit.py's ``test_cpp_unit_tests`` runs the C++ engine's
own unit tests, which touch no Python package; it has no counterpart here.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

from rabit_tpu_torch.engine.native import build_program
from rabit_tpu_torch.tracker.launcher import LocalCluster

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


@pytest.mark.parametrize("engine", ["base", "robust"])
def test_speed_test_cluster(engine):
    binary = build_program(REPO / "native" / "tests" / "speed_test.cc")
    cluster = LocalCluster(4, quiet=True)
    rc = cluster.run([str(binary), "ndata=4096", "nrep=3", f"rabit_engine={engine}"],
                     timeout=60)
    assert rc == 0


def test_speed_runner_parses_every_op():
    """tools/torch_speed_runner.py's sweep at one point: one record per op
    (rank 0 reports), each with a positive rate."""
    from tools.torch_speed_runner import run

    recs = run("robust", 2, 4096, 2, timeout=60)
    assert sorted(r["op"] for r in recs) == sorted(
        ["allreduce-max", "allreduce-sum", "broadcast", "allgather"])
    assert all(r["mb_per_s"] > 0 and r["bytes"] == 4 * 4096 for r in recs)
