"""The guide's programs on the port: the counterpart of tests/test_guide.py,
with the same runs and asserts against ``guide/torch_*.py`` and the port's
``LocalCluster``.

The Python programs run solo and under the port's launcher; the hybrid one
on the CPU (``rabit_torch_device=cpu``: the demo runs on the card unless
asked), solo and at world 2 with worker 1 killed by the mock engine
(``mock=1,1,1,0``); the durable resume in two clusters.  The C++ programs
(guide/*.cc) are built against the port's native library
(``engine.native.build_program``) and run solo and under the port's
launcher.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

from rabit_tpu_torch.tracker.launcher import LocalCluster

REPO = Path(__file__).resolve().parents[1]
GUIDE = REPO / "guide"
CPU = "rabit_torch_device=cpu"


def run_solo(cmd: list[str], timeout: float = 60) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_basic_py_solo():
    out = run_solo([sys.executable, str(GUIDE / "torch_basic.py")])
    # solo mode: allreduce is identity
    assert "after-allreduce-sum" in out


def test_broadcast_py_solo():
    out = run_solo([sys.executable, str(GUIDE / "torch_broadcast.py")])
    assert "'hello world': 100" in out


def test_basic_py_cluster():
    cluster = LocalCluster(3, quiet=True)
    rc = cluster.run([sys.executable, str(GUIDE / "torch_basic.py"), "rabit_engine=robust"],
                     timeout=60)
    assert rc == 0


def test_lazy_allreduce_py_mock_failure():
    """Worker 0 dies at its first collective, restarts, and recovers."""
    cluster = LocalCluster(3, max_restarts=3, quiet=True)
    rc = cluster.run([sys.executable, str(GUIDE / "torch_lazy_allreduce.py"),
                      "rabit_engine=mock", "mock=0,0,0,0"], timeout=90)
    assert rc == 0
    assert cluster.restarts["0"] == 1


def test_hybrid_gbdt_py_solo():
    out = run_solo([sys.executable, str(GUIDE / "torch_hybrid_gbdt.py"), CPU], timeout=200)
    assert "hybrid gbdt: 3 trees" in out


def test_hybrid_gbdt_py_mock_failure():
    """The hybrid demo under a mid-training kill: worker 1 dies inside the
    round's engine hop, restarts, recovers forest and margin from its peers,
    and both workers report the same accuracy and the same forest (through
    the tracker's message log, which the demo reports into)."""
    cluster = LocalCluster(2, max_restarts=3, quiet=True)
    rc = cluster.run([sys.executable, str(GUIDE / "torch_hybrid_gbdt.py"),
                      "rabit_engine=mock", "mock=1,1,1,0", CPU], timeout=300)
    assert rc == 0
    assert cluster.restarts["1"] == 1
    reports = sorted(m for m in cluster.messages if "hybrid gbdt:" in m)
    assert len(reports) == 2, cluster.messages
    acc = [m.split("train-acc ")[1] for m in reports]
    assert acc[0] == acc[1], reports
    digests = {m.split("sha256 ")[1] for m in cluster.messages if "forest sha256" in m}
    assert len(digests) == 1, cluster.messages


def test_hybrid_gbdt_py_refuses_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the demo runs on it")
    proc = subprocess.run([sys.executable, str(GUIDE / "torch_hybrid_gbdt.py")],
                          capture_output=True, text=True, timeout=60, cwd=REPO)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


# --- C++ examples ----------------------------------------------------------


@pytest.fixture(scope="module")
def cpp_examples() -> dict[str, Path]:
    from rabit_tpu_torch.engine.native import build_program

    return {name: build_program(GUIDE / f"{name}.cc")
            for name in ("basic", "broadcast", "lazy_allreduce")}


def test_basic_cc_solo(cpp_examples):
    out = run_solo([str(cpp_examples["basic"])])
    assert "after-allreduce-sum: a={0, 1, 2}" in out


def test_basic_cc_cluster(cpp_examples):
    cluster = LocalCluster(4, quiet=True)
    rc = cluster.run([str(cpp_examples["basic"]), "rabit_engine=robust"], timeout=60)
    assert rc == 0


def test_broadcast_cc_cluster(cpp_examples):
    cluster = LocalCluster(3, quiet=True)
    rc = cluster.run([str(cpp_examples["broadcast"]), "rabit_engine=robust"], timeout=60)
    assert rc == 0


def test_lazy_allreduce_cc_mock_failure(cpp_examples):
    cluster = LocalCluster(3, max_restarts=3, quiet=True)
    rc = cluster.run([str(cpp_examples["lazy_allreduce"]), "rabit_engine=mock",
                      "mock=1,0,0,0"], timeout=90)
    assert rc == 0
    assert cluster.restarts["1"] == 1


def test_durable_resume_py(tmp_path):
    """Run the job to its end (the whole-job preemption), then a fresh
    cluster resumes from disk at the final version instead of retraining."""
    args = [sys.executable, str(GUIDE / "torch_durable_resume.py"), "rabit_engine=robust",
            f"rabit_checkpoint_dir={tmp_path}"]
    c1 = LocalCluster(2, quiet=True)
    assert c1.run(args, timeout=60) == 0
    c2 = LocalCluster(2, quiet=True)
    assert c2.run(args, timeout=60) == 0
    # The second job resumed: the workers assert rounds_done == NITER, which
    # holds only on a resume, since the loop body never runs.
    assert any("final weights" in m for m in c2.messages)
