"""The port's job telemetry and hang evidence.

tests/test_telemetry.py's cases against the port: a mock kill's recovery
wave, restart and per-rank allreduce stats in telemetry.json, with the
robust engine's stats prints turned into events; a clean run with one
wave, no restarts and no flight dumps; the ``CMD_METRICS`` wire and the
metrics heartbeat; the hang dump of survivors stuck behind a frozen peer;
the SIGTERM dump.  Then one scripted RPC sequence (a wave of 2, snapshots
with streamed deltas, prints, a lease that expires, shutdowns) against the
port's tracker and ``rabit_tpu``'s: the two telemetry documents are equal
on every key the port fills, timestamps dropped.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch.engine import native
from rabit_tpu_torch.obs import stream
from rabit_tpu_torch.obs.events import load_dump
from rabit_tpu_torch.obs.metrics import MetricsRegistry
from rabit_tpu_torch.obs.ship import Heartbeat, build_snapshot, renew_lease, ship_snapshot
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.launcher import LocalCluster
from rabit_tpu_torch.tracker.tracker import Tracker

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "workers" / "torch_recover_worker.py")


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's library, built once before the workers load it."""
    native.build_lib()


def wait_for(cond, timeout: float) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def run_obs_cluster(tmp_path, monkeypatch, worker_args, world=4, max_restarts=5):
    """A LocalCluster run with RABIT_OBS_DIR set for the workers (their
    flight dumps) and the tracker (telemetry.json)."""
    obs_dir = tmp_path / "obs"
    monkeypatch.setenv("RABIT_OBS_DIR", str(obs_dir))
    cluster = LocalCluster(world, max_restarts=max_restarts, quiet=True)
    assert cluster.run([sys.executable, WORKER, "rabit_engine=mock", *worker_args],
                       timeout=120.0) == 0
    assert all(r == 0 for r in cluster.returncodes.values())
    return cluster, obs_dir


def test_telemetry_json_records_recovery_wave(tmp_path, monkeypatch):
    """Rank 1 is mock-killed mid-iteration: telemetry.json shows the
    recovery wave, the restart and every rank's allreduce latency stats."""
    cluster, obs_dir = run_obs_cluster(
        tmp_path, monkeypatch, ["ndata=1000", "niter=3", "mock=1,1,1,0", "rabit_recover_stats=1"])
    assert cluster.restarts["1"] == 1
    t = json.loads((obs_dir / "telemetry.json").read_text())
    assert t["world_size"] == 4 and t["n_waves"] >= 2 and t["n_recovery_waves"] >= 1
    recovery = [w for w in t["waves"] if w["epoch"] > 0]
    assert any("1" in w["restarted"] for w in recovery), t["waves"]
    assert any(len(w["recovering"]) == 3 for w in recovery), t["waves"]
    assert t["restarts"] == {"1": 1}
    assert t["epochs"] == [{"epoch": w["epoch"], "world": 4} for w in t["waves"]]
    assert set(t["ranks"]) == {"0", "1", "2", "3"}
    for rank, snap in t["ranks"].items():
        assert snap["metrics"]["ops"]["allreduce"]["calls"] >= 1, rank
        hist = snap["metrics"]["histograms"]["allreduce_latency_seconds"]
        assert hist["count"] >= 1 and 0 < hist["p50"] <= hist["p99"] <= hist["max"]
    kinds = {e["kind"] for e in t["events"]}
    assert "failure_detected" in kinds
    assert any(e["kind"] == "recover_stats" and e.get("version", 0) > 0 for e in t["events"])
    # the restarted life resumed from the checkpoint, and counted it
    assert t["ranks"]["1"]["metrics"]["counters"]["load_checkpoint_recovered_total"] == 1
    assert cluster.telemetry == t
    assert any(e["kind"] == "wave" for e in cluster.events)


def test_telemetry_json_clean_run(tmp_path, monkeypatch):
    """No fault: one wave, no restarts, every rank's snapshot, no dumps."""
    cluster, obs_dir = run_obs_cluster(tmp_path, monkeypatch, ["ndata=100", "niter=2"],
                                       world=3, max_restarts=0)
    t = json.loads((obs_dir / "telemetry.json").read_text())
    assert t["n_recovery_waves"] == 0 and t["restarts"] == {}
    assert set(t["ranks"]) == {"0", "1", "2"}
    assert list(obs_dir.glob("flight-*.jsonl")) == []


def test_cmd_metrics_wire_and_heartbeat(tmp_path):
    """Snapshots land in the per-rank table, by a direct ship and by the
    Heartbeat thread (the newest wins); stop() writes telemetry.json."""
    tracker = Tracker(world_size=1, quiet=True, obs_dir=str(tmp_path / "obs")).start()
    try:
        reg = MetricsRegistry()
        reg.observe_op("allreduce", 64, 0.001)
        assert ship_snapshot(build_snapshot(reg, 0, "0"), tracker.host, tracker.port, "0")
        assert tracker.snapshots[0]["metrics"]["ops"]["allreduce"]["calls"] == 1
        reg.observe_op("allreduce", 64, 0.002)
        hb = Heartbeat(0.1, lambda: ship_snapshot(build_snapshot(reg, 0, "0"), tracker.host,
                                                  tracker.port, "0")).start()
        ok = wait_for(
            lambda: tracker.snapshots[0]["metrics"]["ops"]["allreduce"]["calls"] == 2, 5.0)
        hb.stop()
        assert ok
    finally:
        tracker.stop()
    t = json.loads((tmp_path / "obs" / "telemetry.json").read_text())
    assert t["ranks"]["0"]["metrics"]["ops"]["allreduce"]["calls"] == 2


HANG_WORKER = """
import os, sys, time
import numpy as np
sys.path.insert(0, os.environ["REPO"])
from rabit_tpu_torch import api
api.init()
rank = api.get_rank()
open(os.environ["READY_DIR"] + f"/ready.{rank}", "w").write("1")
for it in range(200):
    api.allreduce(np.full(16, float(rank + it), np.float64), api.SUM)
    time.sleep(0.05)
api.finalize()
"""


def test_hang_dumps_flight_recorder(tmp_path):
    """A frozen peer wedges the survivors in a collective; each survivor's
    watchdog (rabit_obs_hang_sec) dumps its ring, naming the stuck op."""
    obs_dir, ready = tmp_path / "obs", tmp_path / "ready"
    ready.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(HANG_WORKER)
    world = 3
    tracker = Tracker(world_size=world, quiet=True).start()
    procs = []
    try:
        for i in range(world):
            env = dict(os.environ, REPO=str(REPO), DMLC_TRACKER_URI=tracker.host,
                       DMLC_TRACKER_PORT=str(tracker.port), DMLC_TASK_ID=str(i),
                       READY_DIR=str(ready), RABIT_OBS_DIR=str(obs_dir))
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), "rabit_engine=native", "rabit_obs_hang_sec=1",
                 "rabit_timeout_sec=120"],  # the native watchdog parked outside the window
                env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        assert wait_for(lambda: len(list(ready.iterdir())) == world, 60), "workers did not init"
        time.sleep(0.3)
        os.kill(procs[1].pid, signal.SIGSTOP)
        assert wait_for(lambda: len(list(obs_dir.glob("flight-*-hang.jsonl"))) >= 2, 30)
        os.kill(procs[1].pid, signal.SIGCONT)
        dumps = sorted(obs_dir.glob("flight-*-hang.jsonl"))
        evs = load_dump(dumps[0])
        assert evs[0].kind == "flight_dump" and evs[0].fields["reason"] == "hang"
        kinds = [e.kind for e in evs]
        assert "hang_detected" in kinds and "op_inflight" in kinds
        stuck = next(e for e in evs if e.kind == "op_inflight")
        assert stuck.fields["op"] == "allreduce" and stuck.fields["stuck_seconds"] >= 1.0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tracker.stop()


def test_sigterm_dumps_flight_recorder(tmp_path):
    """SIGTERM on a worker with an obs dir dumps the ring before the
    process dies with the SIGTERM status."""
    obs_dir = tmp_path / "obs"
    worker = tmp_path / "solo.py"
    worker.write_text(
        "import os, sys, time\n"
        "import numpy as np\n"
        "sys.path.insert(0, os.environ['REPO'])\n"
        "from rabit_tpu_torch import api\n"
        "api.init(['rabit_engine=empty'])\n"
        "api.allreduce(np.arange(4, dtype=np.float32), api.SUM)\n"
        "print('READY', flush=True)\n"
        "time.sleep(30)\n")
    env = dict(os.environ, REPO=str(REPO), RABIT_OBS_DIR=str(obs_dir))
    proc = subprocess.Popen([sys.executable, str(worker)], env=env, stdout=subprocess.PIPE,
                            text=True)
    try:
        assert proc.stdout.readline().strip() == "READY"
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=15)
        assert proc.returncode == -signal.SIGTERM
        dumps = list(obs_dir.glob("flight-*-sigterm.jsonl"))
        assert len(dumps) == 1, list(obs_dir.iterdir())
        evs = load_dump(dumps[0])
        assert evs[0].fields["reason"] == "sigterm"
        assert any(e.kind == "op_end" and e.fields["op"] == "allreduce" for e in evs)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- one RPC sequence, both trackers -----------------------------------------

def scripted_job(tracker) -> dict:
    """A wave of 2 (JAX's client reads the assignments), one snapshot a
    rank with its streamed delta, a snapshot of an out-of-range rank, the
    robust engine's stats prints, a lease that lapses, the shutdowns.
    Returns the telemetry written at the job's end."""
    replies = {}

    def check_in(task: str) -> None:
        replies[task] = JP.tracker_rpc(tracker.host, tracker.port, JP.CMD_START, task,
                                       listen_port=41000 + int(task), timeout=5.0,
                                       reply_timeout=20.0, retries=0)

    threads = [threading.Thread(target=check_in, args=(t,)) for t in ("0", "1")]
    for th in threads:
        th.start()
        time.sleep(0.1)  # check-in order
    for th in threads:
        th.join(timeout=25)
    assert sorted(a.rank for a in replies.values()) == [0, 1]
    for rank in (0, 1):
        reg = MetricsRegistry()
        src = stream.DeltaSource(reg)
        reg.observe_op("allreduce", 1024 * (rank + 1), 0.001 * (rank + 1))
        reg.counter("checkpoint_commits_total").inc(3)
        stream.stream_count("wire_bytes", 512, registry=reg, codec="i8", fused=0)
        snap = build_snapshot(reg, rank, str(rank), extra={"delta": src.take()})
        assert ship_snapshot(snap, tracker.host, tracker.port, str(rank))
    assert ship_snapshot(build_snapshot(MetricsRegistry(), 7, "x"), tracker.host,
                         tracker.port, "x")
    for line in ("[1] failure_detected at=12.5",
                 "[0] recover_stats version=2 summary_rounds=4 table_rounds=2",
                 "[0] an ordinary print"):
        assert P.tracker_rpc(tracker.host, tracker.port, P.CMD_PRINT, "0", message=line,
                             timeout=2.0, retries=0) == P.ACK
    assert renew_lease(tracker.host, tracker.port, "0", 30.0, rank=0)
    assert renew_lease(tracker.host, tracker.port, "1", 0.5, rank=1)
    assert wait_for(lambda: any(e["kind"] == "lease_expired" for e in tracker.events), 5.0)
    for task in ("0", "1"):
        assert P.tracker_rpc(tracker.host, tracker.port, P.CMD_SHUTDOWN, task,
                             timeout=2.0, retries=0) == P.ACK
    assert tracker.wait(10.0)
    return json.loads((Path(tracker.obs_dir) / "telemetry.json").read_text())


TIMING = ("ts", "started_at", "finished_at", "last_fold_ts", "overdue")


def untimed(doc):
    if isinstance(doc, dict):
        return {k: untimed(v) for k, v in doc.items() if k not in TIMING}
    if isinstance(doc, list):
        return [untimed(v) for v in doc]
    return doc


def test_telemetry_equal_to_jax(tmp_path):
    docs = {}
    for name, cls in (("port", Tracker), ("jax", JaxTracker)):
        tracker = cls(world_size=2, quiet=True, obs_dir=str(tmp_path / name)).start()
        try:
            docs[name] = scripted_job(tracker)
        finally:
            tracker.stop()
    mine, theirs = docs["port"], docs["jax"]
    assert set(mine) <= set(theirs)
    assert set(mine) >= {"schema", "job", "world_size", "base_world", "started_at",
                         "finished_at", "n_waves", "n_recovery_waves", "n_lease_expired",
                         "schedule", "epochs", "restarts", "clocks", "stream", "waves",
                         "events", "ranks", "messages_dropped"}
    for key in set(mine) - set(TIMING):
        assert untimed(mine[key]) == untimed(theirs[key]), key
    assert mine["n_lease_expired"] == 1
    assert [e["kind"] for e in mine["events"]] == [
        "wave", "schedule_planned", "metrics_snapshot", "metrics_delta_folded", "metrics_snapshot",
        "metrics_delta_folded", "snapshot_rejected", "failure_detected", "recover_stats",
        "lease_expired"]
    assert mine["stream"]["total"]["counters"]["wire_bytes{codec=i8,fused=0}"] == 1024
