"""The port's liveness layer: heartbeat leases, the hang watchdog's
dump-then-die, and the launcher's suspect path.

tests/test_liveness.py's matrix against the port's ``Tracker`` and
``LocalCluster``: renewal keeps a worker live; an expiry is suspected within
two intervals; a shutdown and a new check-in clear the lease; a malformed
heartbeat is ignored; a snapshot's rank is validated at ingest; death times
are recorded; a frozen robust worker (SIGSTOP: no exit, no TCP error) is
suspected, SIGKILLed and restarted, and its self-verifying job completes
bitwise (the frozen GBDT worker's forest is held bitwise on the card, by
chip_smoke.py's liveness phase); a clean GBDT run with leases keeps them
all; and a rank stuck in a collective dumps ``-hang`` and
``-abort`` flight files and exits with ``HANG_ABORT_EXIT``.  Then the two
packages across each other: a port client's heartbeats and snapshots
against ``rabit_tpu``'s tracker and the reverse (``TimedAck`` parsed on
each side), in process and as worker processes under the other package's
launcher.

Leases here renew every 0.5 s or slower, and every subprocess has a
timeout of its own.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from rabit_tpu.obs import ship as jship
from rabit_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.launcher import LocalCluster as JaxCluster
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch.engine import native
from rabit_tpu_torch.obs import HANG_ABORT_EXIT
from rabit_tpu_torch.obs.events import load_dump
from rabit_tpu_torch.obs.metrics import MetricsRegistry
from rabit_tpu_torch.obs.ship import build_snapshot, renew_lease, ship_snapshot
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.launcher import LocalCluster
from rabit_tpu_torch.tracker.tracker import Tracker

REPO = Path(__file__).resolve().parents[1]
WORKERS = REPO / "tests" / "workers"
GBDT_WORKER = str(WORKERS / "torch_gbdt_native_worker.py")
HB = 0.5  # the lease interval of these tests


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


# -- the lease detector ------------------------------------------------------

def test_lease_renewal_keeps_worker_live():
    suspected: list[str] = []
    tracker = Tracker(world_size=2, quiet=True, on_suspect=suspected.append).start()
    try:
        deadline = time.time() + 3 * HB
        while time.time() < deadline:
            assert renew_lease(tracker.host, tracker.port, "3", HB, rank=1)
            time.sleep(HB / 2)
        assert suspected == []
        assert tracker.live_tasks() == ["3"]
    finally:
        tracker.stop()


def test_lease_expiry_suspects_within_two_intervals():
    suspected: list[str] = []
    tracker = Tracker(world_size=2, quiet=True, on_suspect=suspected.append).start()
    try:
        assert renew_lease(tracker.host, tracker.port, "5", HB, rank=1)
        silent_at = time.time()
        assert wait_for(lambda: suspected, 5.0)
        detect = time.time() - silent_at
        assert suspected == ["5"]
        # within LEASE_FACTOR x interval, plus the 50 ms scan and scheduling slack
        assert detect < P.LEASE_FACTOR * HB + 0.5, detect
        evs = [e for e in tracker.events if e["kind"] == "lease_expired"]
        assert len(evs) == 1 and evs[0]["task_id"] == "5"
        assert evs[0]["rank"] == 1 and evs[0]["interval"] == HB
        assert tracker.live_tasks() == []
        time.sleep(2 * HB)  # one hang, one suspicion: no re-fire without a renewal
        assert suspected == ["5"]
    finally:
        tracker.stop()


def test_lease_cleared_by_shutdown_and_checkin():
    suspected: list[str] = []
    tracker = Tracker(world_size=1, quiet=True, on_suspect=suspected.append).start()
    try:
        assert renew_lease(tracker.host, tracker.port, "0", HB)
        # a clean shutdown drops the lease: no suspicion after it
        assert P.tracker_rpc(tracker.host, tracker.port, P.CMD_SHUTDOWN, "0",
                             timeout=2.0, retries=0) == P.ACK
        assert tracker.live_tasks() == []
        time.sleep(3 * HB)
        assert suspected == []
    finally:
        tracker.stop()

    suspected2: list[str] = []
    tracker2 = Tracker(world_size=1, quiet=True, on_suspect=suspected2.append).start()
    try:
        # a (re-)check-in supersedes the previous life's lease
        assert renew_lease(tracker2.host, tracker2.port, "0", HB)
        asg = JP.tracker_rpc(tracker2.host, tracker2.port, JP.CMD_START, "0",
                             listen_port=50000, timeout=2.0, retries=0)
        assert isinstance(asg, JP.Assignment) and asg.rank == 0
        assert tracker2.live_tasks() == []
        time.sleep(3 * HB)
        assert suspected2 == []
    finally:
        tracker2.stop()


def test_completion_guard_waits_for_a_leased_task(tmp_path):
    """Every task id of the world has shut down, but another task still
    holds a lease: the job is not done until that lease expires, and then
    telemetry.json is written before wait() returns."""
    tracker = Tracker(world_size=2, quiet=True, obs_dir=str(tmp_path)).start()
    try:
        assert renew_lease(tracker.host, tracker.port, "spare", HB)
        for task in ("0", "1"):
            assert P.tracker_rpc(tracker.host, tracker.port, P.CMD_SHUTDOWN, task,
                                 timeout=2.0, retries=0) == P.ACK
        assert not tracker.wait(0.3)
        assert tracker.wait(5.0)
        assert (tmp_path / "telemetry.json").exists()
        t = tracker.telemetry
        assert t["n_lease_expired"] == 1 and t["events"][-1]["task_id"] == "spare"
    finally:
        tracker.stop()


def test_malformed_heartbeat_ignored():
    tracker = Tracker(world_size=1, quiet=True).start()
    try:
        for bad in ("banana", "-3.0", "0", "1e9"):
            assert P.tracker_rpc(tracker.host, tracker.port, P.CMD_HEARTBEAT, "0",
                                 message=bad, timeout=2.0, retries=0) == P.ACK
        assert tracker.live_tasks() == []
    finally:
        tracker.stop()


def test_snapshot_rank_validated_at_ingest():
    """Snapshots whose rank lies outside the world are rejected at ingest
    instead of polluting the per-rank table."""
    tracker = Tracker(world_size=2, quiet=True).start()
    try:
        reg = MetricsRegistry()
        reg.observe_op("allreduce", 64, 0.001)
        for bad_rank in (-1, 2, 99):
            assert ship_snapshot(build_snapshot(reg, bad_rank, "t"), tracker.host,
                                 tracker.port, "t")
        assert ship_snapshot(build_snapshot(reg, 1, "1"), tracker.host, tracker.port, "1")
        assert set(tracker.snapshots) == {1}
        rejected = [e for e in tracker.events if e["kind"] == "snapshot_rejected"]
        assert sorted(e["rank"] for e in rejected) == [-1, 2, 99]
        assert set(tracker.build_telemetry()["ranks"]) == {"1"}
    finally:
        tracker.stop()


def test_tracker_rpc_retries_then_gives_up():
    """A dead tracker is TrackerUnreachable after the retry budget, and
    the best-effort senders swallow it."""
    tracker = Tracker(world_size=1, quiet=True)
    host, port = tracker.host, tracker.port
    tracker.stop()
    t0 = time.time()
    with pytest.raises(P.TrackerUnreachable, match="2 attempt"):
        P.tracker_rpc(host, port, P.CMD_PRINT, "0", message="x", timeout=1.0, retries=1,
                      backoff=0.05)
    assert time.time() - t0 < 5
    assert not renew_lease(host, port, "0", HB)
    with pytest.raises(ValueError):  # a spare's park holds its own socket
        P.tracker_rpc(host, port, P.CMD_SPARE, "0")


# -- the launcher ------------------------------------------------------------

def gbdt_cmd(tmp: Path, *args: str) -> list[str]:
    return [sys.executable, GBDT_WORKER, "rabit_engine=robust", "mode=gbdt", "ntrees=6",
            f"out={tmp / 'forest'}", f"stats={tmp}", *args]


@pytest.fixture(scope="module")
def clean_run(tmp_path_factory):
    """A clean GBDT run with heartbeats and the flight recorder on: its
    forest, telemetry, obs dir and the ranks' registry files."""
    tmp = tmp_path_factory.mktemp("clean")
    obs_dir = tmp / "obs"
    cluster = LocalCluster(2, max_restarts=0, quiet=True)
    assert cluster.run(gbdt_cmd(tmp, f"rabit_heartbeat_sec={HB}", f"rabit_obs_dir={obs_dir}",
                                "rabit_trace_exit=1"), timeout=120.0) == 0
    stats = [json.loads((tmp / f"rank{r}.registry.json").read_text()) for r in range(2)]
    return {"forest": np.load(tmp / "forest.npy"), "telemetry": cluster.telemetry,
            "obs_dir": obs_dir, "stats": stats}


def test_clean_run_with_leases(clean_run):
    """No lease expires in a clean run; each rank's snapshot counts one
    allreduce a hop (depth + 1 a tree) and the accuracy count; each rank
    leaves an -exit dump."""
    t = clean_run["telemetry"]
    assert t["n_lease_expired"] == 0 and t["restarts"] == {}
    assert set(t["ranks"]) == {"0", "1"}
    for r, st in enumerate(clean_run["stats"]):
        assert st["hops"] == 6 * (3 + 1)
        calls = t["ranks"][str(r)]["metrics"]["ops"]["allreduce"]["calls"]
        assert calls == st["hops"] + 1 == st["registry"]["ops"]["allreduce"]["calls"]
        assert t["ranks"][str(r)]["metrics"]["counters"]["checkpoint_commits_total"] == 6
    dumps = sorted(p.name for p in clean_run["obs_dir"].glob("flight-*-exit.jsonl"))
    assert [d.split("-")[1] for d in dumps] == ["rank0", "rank1"]
    # each snapshot carries its rank's clock offset, from the timed ACKs
    assert all(s["clock"]["samples"] >= 1 for s in t["ranks"].values())


def test_silent_hang_detected_killed_restarted_job_completes():
    """A worker frozen mid-job (SIGSTOP) is suspected through its lease,
    SIGKILLed by the launcher and restarted, and the self-verifying job
    completes with every collective's result bitwise its closed form; the
    telemetry shows lease_expired followed by a recovery wave that
    restarts it.  The worker (the port's recover worker: no torch) holds
    its lease within about a second of its start, well before the freeze."""
    cluster = LocalCluster(3, max_restarts=5, quiet=True)
    rc = cluster.run([sys.executable, str(WORKERS / "torch_recover_worker.py"),
                      "rabit_engine=robust", "ndata=2000", "niter=10", "sleep=0.5",
                      f"rabit_heartbeat_sec={HB}", "rabit_stall_timeout_sec=1",
                      "rabit_timeout_sec=60"],
                     timeout=120.0, wedge=[(3.0, 1)])
    assert rc == 0 and cluster.returncodes == {"0": 0, "1": 0, "2": 0}
    assert cluster.wedges_delivered == 1
    assert cluster.restarts["1"] >= 1, "the frozen worker was never restarted"
    verified = [m for m in cluster.messages if "iterations verified" in m]
    assert len(verified) == 3, list(cluster.messages)
    t = cluster.telemetry
    leases = [e for e in t["events"] if e["kind"] == "lease_expired"]
    assert leases and leases[0]["task_id"] == "1", t["events"]
    assert t["n_lease_expired"] >= 1
    # silence starts at the SIGSTOP, when the lease is at most one renewal old
    detect = leases[0]["ts"] - cluster.wedge_times[0]
    assert 0 < detect < (1 + P.LEASE_FACTOR) * HB + 1.0, detect
    recovery = [w for w in t["waves"] if w["epoch"] > 0]
    assert any(w["ts"] > leases[0]["ts"] and "1" in w["restarted"] for w in recovery), \
        (leases, recovery)
    assert t["restarts"].get("1", 0) >= 1


def test_death_times_recorded_for_preemptions():
    """A preemption's SIGKILL lands in death_times once."""
    cluster = LocalCluster(2, max_restarts=3, quiet=True)
    assert cluster.run([sys.executable, str(WORKERS / "torch_recover_worker.py"),
                        "rabit_engine=robust", "ndata=500", "niter=6", "sleep=0.4"],
                       timeout=120.0, preempt=[(1.5, 1)]) == 0
    assert cluster.preempts_delivered == 1 and cluster.restarts["1"] >= 1
    assert len(cluster.death_times) == cluster.restarts["0"] + cluster.restarts["1"]


HANG_WORKER = """
import os, sys, time
import numpy as np
sys.path.insert(0, os.environ["REPO"])
from rabit_tpu_torch import api
api.init()
rank = api.get_rank()
open(os.environ["READY_DIR"] + f"/ready.{rank}", "w").write("1")
for it in range(400):
    api.allreduce(np.full(8, float(it), np.float64), api.SUM)
    time.sleep(0.05)
api.finalize()
"""


def start_hang_workers(tmp_path, tracker, world: int, args: list[str]):
    ready = tmp_path / "ready"
    ready.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(HANG_WORKER)
    procs = []
    for i in range(world):
        env = dict(os.environ, REPO=str(REPO), DMLC_TRACKER_URI=tracker.host,
                   DMLC_TRACKER_PORT=str(tracker.port), DMLC_TASK_ID=str(i),
                   READY_DIR=str(ready), RABIT_OBS_DIR=str(tmp_path / "obs"))
        procs.append(subprocess.Popen([sys.executable, str(worker), "rabit_engine=native",
                                       *args], env=env, stdout=subprocess.DEVNULL,
                                      stderr=subprocess.DEVNULL))
    assert wait_for(lambda: len(list(ready.iterdir())) == world, 60), "workers did not init"
    time.sleep(0.3)  # into the loop
    return procs


def test_hang_abort_dump_then_die(tmp_path):
    """Survivors stuck in a collective past rabit_hang_abort_sec dump their
    flight recorder (-hang, then -abort) and exit with HANG_ABORT_EXIT."""
    world = 3
    tracker = Tracker(world_size=world, quiet=True).start()
    procs = []
    try:
        # the native detectors parked outside the window: obs must fire
        procs = start_hang_workers(tmp_path, tracker, world, [
            "rabit_obs_hang_sec=0.5", "rabit_hang_abort_sec=1.5",
            "rabit_stall_timeout_sec=120", "rabit_timeout_sec=120"])
        os.kill(procs[1].pid, signal.SIGSTOP)
        frozen = time.time()
        survivors = [procs[0], procs[2]]
        assert wait_for(lambda: all(p.poll() is not None for p in survivors), 30)
        took = time.time() - frozen
        assert [p.poll() for p in survivors] == [HANG_ABORT_EXIT] * 2
        assert took < 10, took
        assert procs[1].poll() is None  # the frozen one stays stopped
        obs_dir = tmp_path / "obs"
        hang = sorted(obs_dir.glob("flight-*-hang.jsonl"))
        abort = sorted(obs_dir.glob("flight-*-abort.jsonl"))
        assert len(hang) >= 2 and len(abort) >= 2, list(obs_dir.iterdir())
        kinds = [e.kind for e in load_dump(abort[0])]
        assert "hang_detected" in kinds and "hang_abort" in kinds
        abort_ev = next(e for e in load_dump(abort[0]) if e.kind == "hang_abort")
        assert abort_ev.fields["exit_code"] == HANG_ABORT_EXIT
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tracker.stop()


# -- interop with rabit_tpu --------------------------------------------------

@pytest.mark.parametrize("side", ["port-client-jax-tracker", "jax-client-port-tracker"])
def test_lease_and_snapshot_interop(side):
    """Either package's senders against the other's tracker: the lease is
    granted and expires, the snapshot lands, and the timed ACK parses."""
    if side == "port-client-jax-tracker":
        tracker = JaxTracker(world_size=2, quiet=True).start()
        renew, ship, build, reg = renew_lease, ship_snapshot, build_snapshot, MetricsRegistry()
        rpc, timed = P.tracker_rpc, P.TimedAck
    else:
        tracker = Tracker(world_size=2, quiet=True).start()
        renew, ship, build, reg = (jship.renew_lease, jship.ship_snapshot,
                                   jship.build_snapshot, JaxRegistry())
        rpc, timed = JP.tracker_rpc, JP.TimedAck
    try:
        assert renew(tracker.host, tracker.port, "1", HB, rank=1)
        assert tracker.live_tasks() == ["1"]
        reg.observe_op("allreduce", 64, 0.001)
        assert ship(build(reg, 1, "1"), tracker.host, tracker.port, "1")
        assert tracker.snapshots[1]["metrics"]["ops"]["allreduce"]["calls"] == 1
        ack = rpc(tracker.host, tracker.port, P.CMD_HEARTBEAT, "0", message="0",
                  timeout=2.0, retries=0)
        assert isinstance(ack, timed) and ack == P.ACK
        assert abs(ack.offset) < 1.0 and 0 <= ack.err < 1.0
        assert wait_for(lambda: tracker.live_tasks() == [], 5.0)
        assert [e["task_id"] for e in tracker.events if e["kind"] == "lease_expired"] == ["1"]
        assert set(tracker.build_telemetry()["ranks"]) == {"1"}
    finally:
        tracker.stop()


@pytest.mark.parametrize("side", ["port-worker-jax-launcher", "jax-worker-port-launcher"])
def test_worker_interop(side):
    """Worker processes of one package, with leases, under the other's
    launcher and tracker: no lease expires and every rank's snapshot is in
    the telemetry."""
    args = ["rabit_engine=robust", "niter=2", "ndata=64", f"rabit_heartbeat_sec={HB}"]
    if side == "port-worker-jax-launcher":
        cluster = JaxCluster(2, quiet=True)
        worker = WORKERS / "torch_recover_worker.py"
    else:
        cluster = LocalCluster(2, quiet=True, extra_env={"JAX_PLATFORMS": "cpu"})
        worker = WORKERS / "recover_worker.py"
    assert cluster.run([sys.executable, str(worker), *args], timeout=120.0) == 0
    t = cluster.telemetry
    assert t["n_lease_expired"] == 0
    assert set(t["ranks"]) == {"0", "1"}
    for snap in t["ranks"].values():
        assert snap["metrics"]["ops"]["allreduce"]["calls"] >= 2
        assert snap["clock"]["samples"] >= 1
