"""tpulint's families over the port (tools/torch_tpulint.py).

* The port's tree is clean: every finding is in
  tools/torch_tpulint_baseline.json, and the CLI exits 0.
* The baseline is a ledger, not a mute button: every entry argues its
  case, and none is stale.
* The checks bite on the port: a blocking wait planted on the tracker's
  reactor loop, in a copy of the port under ``tmp_path``, is reported by
  the ``reactor-blocking`` family at its file and line, under the port's
  path.
"""

from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tools import torch_tpulint
from tools.tpulint.core import load_baseline

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def findings():
    return torch_tpulint.lint(REPO)


def test_port_lint_finds_nothing_outside_its_baseline():
    proc = subprocess.run([sys.executable, "tools/torch_tpulint.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new finding(s)" in proc.stdout and "0 stale" in proc.stdout


def test_port_baseline_argued_and_not_stale(findings):
    baseline = load_baseline(torch_tpulint.BASELINE)  # refuses an unargued entry
    assert baseline and all(len(why) > 40 for why in baseline.values())
    live = {f.fingerprint for f in findings}
    assert sorted(set(baseline) - live) == []
    assert sorted(live - set(baseline)) == []
    # findings are reported under the port's paths, never the mirror's
    assert not [f for f in findings if f.path.startswith("rabit_tpu/")]


def _copy_port(dst: Path) -> None:
    shutil.copytree(REPO / "rabit_tpu_torch", dst / "rabit_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(REPO / "native" / "src", dst / "native" / "src")
    (dst / "doc").mkdir()
    shutil.copy(REPO / "doc" / "parameters.md", dst / "doc" / "parameters.md")
    shutil.copy(REPO / "README.md", dst / "README.md")


def _plant(path: Path, method: str, stmt: str) -> int:
    """Put ``stmt`` first in ``method``'s body; returns its line."""
    src = path.read_text(encoding="utf-8")
    fn = next(n for n in ast.walk(ast.parse(src))
              if isinstance(n, ast.FunctionDef) and n.name == method)
    first = fn.body[0]
    lines = src.splitlines()
    lines.insert(first.lineno - 1, " " * first.col_offset + stmt)
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return first.lineno


@pytest.mark.parametrize("method,stmt", [
    # on the loop itself: an accept handler that sleeps
    ("_reactor_accept", "time.sleep(0.05)"),
    # through a helper every short RPC on the loop reaches: an untimed wait,
    # the shape of a reply held for a standby's acknowledgement
    ("_short_rpc_reply", "self._done.wait()"),
])
def test_planted_reactor_wait_is_reported(tmp_path, method, stmt):
    _copy_port(tmp_path)
    tracker = tmp_path / "rabit_tpu_torch" / "tracker" / "tracker.py"
    line = _plant(tracker, method, stmt)
    found = torch_tpulint.lint(tmp_path, only="reactor")
    hits = [f for f in found if f.rule == "reactor-blocking"
            and f.path == "rabit_tpu_torch/tracker/tracker.py" and f.line == line]
    assert hits, [f.render() for f in found]
    baseline = load_baseline(torch_tpulint.BASELINE)
    assert all(f.fingerprint not in baseline for f in hits)
