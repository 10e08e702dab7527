"""The port's recovery bench (tools/torch_recovery_bench.py) against
``rabit_tpu``'s tools/recovery_bench.py, on the CPU at small sizes.

* Each mode's JSON records carry exactly the keys the JAX tool's carry on
  the same arguments; the world sweep's and the blob mode's recovery
  counters (serve bytes, summary and table rounds, depth and hops) equal
  the JAX tool's: both run rabit's C++ engine on the same worker
  arguments.
* The port counterparts of tests/test_ha.py's two ``_failover_once``
  gates (world 2 direct, world 3 behind a relay), the elastic mode's
  promotion, shrink and grow-back at world 3, and a durable resume at
  world 2.
* The CLI prints parseable JSON lines; importing the tool (or
  tools/torch_allgather_probe.py) loads neither JAX nor ``rabit_tpu``;
  ``--device cuda`` without a card raises.
* tools/torch_allgather_probe.py at world 2 prints both median lines.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tools import recovery_bench as jax_bench
from tools import torch_recovery_bench as bench

ROOT = Path(__file__).resolve().parents[1]
TOOL = str(ROOT / "tools" / "torch_recovery_bench.py")

#: recover_stats counters both tools read from the same C++ engine
COUNTERS = ("recover_serve_bytes", "recover_summary_rounds", "recover_table_rounds",
            "recover_summary_depth", "recover_table_hops")


def printed(capsys, fn, *args, **kw) -> list[dict]:
    """The JSON records ``fn`` prints."""
    fn(*args, **kw)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_world_sweep_keys_and_counters_equal_jax(capsys):
    mine = printed(capsys, bench.world_sweep, [2])
    theirs = printed(capsys, jax_bench.world_sweep, [2])
    assert len(mine) == len(theirs) == 1
    assert mine[0].keys() == theirs[0].keys()
    for key in COUNTERS:
        assert key in mine[0] and mine[0][key] == theirs[0][key], key
    assert mine[0]["world"] == 2
    assert mine[0]["protocol_recovery_latency_s"] is not None
    assert mine[0]["detect_latency_s"] is not None


def test_blob_sweep_keys_and_serve_bytes_equal_jax(capsys):
    mine = printed(capsys, bench.blob_sweep, [1.0], [2])
    theirs = printed(capsys, jax_bench.blob_sweep, [1.0], [2])
    assert len(mine) == len(theirs) == 1
    assert mine[0].keys() == theirs[0].keys()
    assert mine[0]["recover_serve_bytes"] == theirs[0]["recover_serve_bytes"]
    assert mine[0]["recover_serve_bytes"] >= 1 << 20  # the blob crossed
    assert mine[0]["restore_bandwidth_mb_s"] > 0


def test_resume_sweep_record(capsys):
    mine = printed(capsys, bench.resume_sweep, [0.0], [2])
    theirs = printed(capsys, jax_bench.resume_sweep, [0.0], [2])
    assert len(mine) == len(theirs) == 1
    assert mine[0].keys() == theirs[0].keys()
    rec = mine[0]
    assert rec["mode"] == "durable_resume" and rec["world"] == 2
    assert rec["resumed_at_version"] == 2 and rec["niter"] == 4
    assert 0 < rec["resume_latency_s"] <= rec["resume_wall_s"]


def test_elastic_sweep_promotes_shrinks_and_grows_back(capsys):
    mine = printed(capsys, bench.elastic_sweep, [3], 1.0, device="cpu")
    theirs = printed(capsys, jax_bench.elastic_sweep, [3], 1.0)
    assert len(mine) == len(theirs) == 1
    assert mine[0].keys() == theirs[0].keys()
    rec = mine[0]
    assert rec["mode"] == "elastic" and rec["world"] == 3
    assert rec["promote_latency_s"] is not None
    assert [e["world"] for e in rec["promote_epochs"]][-1] == 3  # the spare took the slot
    assert rec["shrink_latency_s"] is not None and rec["grow_latency_s"] is not None
    worlds = [e["world"] for e in rec["shrink_epochs"]]
    assert 2 in worlds and worlds[-1] == 3  # shrunk to 2, grown back to 3


def test_failover_bench_smoke():
    """tests/test_ha.py::test_failover_bench_smoke on the port: a takeover
    within the lease, a post-failover recovery wave, and the standby
    expiring the scheduled death's re-armed lease (exactly one
    lease_expired)."""
    rec = bench._failover_once(2, relays=0, niter=8, iter_sleep=0.12, kill_at=0.5,
                               takeover_sec=0.4, device="cpu")
    assert rec["takeover_latency_s"] is not None
    assert rec["takeover_latency_s"] < 3.0
    assert rec["first_wave_after_s"] is not None
    assert rec["n_lease_expired"] == 1


def test_relay_rotates_and_replays_across_failover():
    """tests/test_ha.py::test_relay_rotates_and_replays_across_failover on
    the port: children behind a relay never re-dial; the relay's channel
    rotates to the promoted root, a worker dies after the cut, and the
    survivors' states are held to their closed form inside the helper."""
    counter = bench.contribution_counter(3, "cpu")
    rec = bench._failover_once(3, relays=1, niter=8, iter_sleep=0.12, kill_at=0.5,
                               takeover_sec=0.4, counter=counter)
    assert rec["relays"] == 1
    assert rec["takeover_latency_s"] is not None
    assert rec["first_wave_after_s"] is not None
    assert rec["n_lease_expired"] == 1  # the scheduled death, no more
    assert counter.n_calls > 0


def test_cli_failover_prints_json_lines_with_jax_keys():
    out = subprocess.run([sys.executable, TOOL, "--failover", "2", "--device", "cpu"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    recs = [json.loads(line) for line in out.stdout.splitlines() if line.strip()]
    assert [(r["mode"], r["world"], r["relays"]) for r in recs] == [
        ("ha_failover", 2, 0), ("ha_failover", 2, 1)]
    theirs = jax_bench._failover_once(2, relays=0)
    for rec in recs:
        assert rec.keys() == theirs.keys()
        assert rec["n_lease_expired"] == 1


def test_import_loads_no_jax(tmp_path):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import tools.torch_recovery_bench, tools.torch_allgather_probe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'rabit_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--failover", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench._elastic_once(2, with_spare=True, grow_back=False, shrink_after_sec=1.0)


def test_allgather_probe_prints_both_medians():
    """tools/torch_allgather_probe.py at world 2: rank 0's allreduce and
    allgather lines, each with a median, p90 and max."""
    out = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_allgather_probe.py"),
                          "--world", "2", "--iters", "5"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    medians = {}
    for line in out.stdout.splitlines():
        name, _, rest = line.partition(": ")
        fields = dict(kv.split("=") for kv in rest.split())
        medians[name] = float(fields["median"].removesuffix("ms"))
        assert set(fields) == {"median", "p90", "max"}
    assert sorted(medians) == ["allgather", "allreduce"]
    assert all(v > 0 for v in medians.values())
