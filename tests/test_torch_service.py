"""The multi-tenant collective service of the port (``rabit_tpu_torch.service``).

The port's counterpart of each test of tests/test_service.py, with the same
arguments and asserts, against ``rabit_tpu_torch``'s ``CollectiveService``,
``ElasticWorker``, ``Relay``, ``Standby`` and ``PooledWorker`` on the CPU,
and a parity set that holds the port against ``rabit_tpu`` both ways: the
keyed hellos' bytes, a worker of either package against the other's
service, a journal the port's service wrote replayed by both packages'
``ServiceState``, and a service's batch ACK read by both relays.
"""

from __future__ import annotations

import io
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

from rabit_tpu_torch.elastic.client import ElasticWorker
from rabit_tpu_torch.ha import Journal, Standby, replay
from rabit_tpu_torch.relay import Relay
from rabit_tpu_torch.service import (
    AdmissionRefused,
    CollectiveService,
    JobRegistry,
    PooledWorker,
    ServiceState,
    tenant_of,
)
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker


class _Sink:
    def __init__(self):
        self.buf = io.BytesIO()

    def sendall(self, data):
        self.buf.write(data)


def contribution(v: int, world: int, rank: int) -> np.ndarray:
    return np.full(4, v * (rank + 1), np.int64)


def expected(world: int, niter: int) -> np.ndarray:
    return np.full(4, (world * (world + 1) // 2) * (niter * (niter + 1) // 2), np.int64)


def run_workers(addr, specs, niter=3, deadline=30.0, worker_cls=ElasticWorker, **kw):
    """One worker thread a (job, task) spec; {wire task id: result}."""
    results: dict[str, object] = {}
    threads = []
    for job, task in specs:
        w = worker_cls(addr, task, contribution, niter, job=job, deadline_sec=deadline, **kw)
        threads.append(threading.Thread(
            target=lambda w=w: results.__setitem__(w.task_id, w.run()), daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=deadline + 10)
    return results


def wait_retired(svc, keys=None, timeout=5.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        live = svc.live_jobs()
        if (not live) if keys is None else not set(keys) & set(live):
            return
        time.sleep(0.05)


# -- the wire ----------------------------------------------------------------------

def test_job_key_join_split_round_trip():
    assert P.join_job("", "3") == "3"
    assert P.join_job("jx", "3") == "jx/3"
    assert P.split_job("3") == ("", "3")
    assert P.split_job("jx/3") == ("jx", "3")
    assert P.split_job("jx/s0") == ("jx", "s0")
    # only the first separator splits: a pool route key has one
    assert P.split_job("pool/w1") == (P.POOL_PREFIX, "w1")


_HELLO_SHAPES = [
    (P.CMD_START, dict(listen_port=712)),
    (P.CMD_SPARE, dict(listen_port=713)),
    (P.CMD_HEARTBEAT, dict(message="0.25")),
    (P.CMD_QUORUM, dict(message='{"epoch": 0}')),
    (P.CMD_BLOB, dict(blob=b"zz", blob_version=3)),
    (P.CMD_SHUTDOWN, {}),
]


def test_empty_job_key_hello_byte_identical():
    """job="" writes the single-job hello byte for byte, in every shape."""
    for cmd, kw in _HELLO_SHAPES:
        legacy, empty, keyed = _Sink(), _Sink(), _Sink()
        P.send_hello(legacy, cmd, "7", prev_rank=1, **kw)
        P.send_hello(empty, cmd, "7", prev_rank=1, job="", **kw)
        P.send_hello(keyed, cmd, "7", prev_rank=1, job="j", **kw)
        assert empty.buf.getvalue() == legacy.buf.getvalue()
        assert keyed.buf.getvalue() != legacy.buf.getvalue()


def _bootstrap_bytes(host: str, port: int, world: int) -> list[bytes]:
    """A raw-socket bootstrap of one world: every worker's whole reply
    stream (the Assignment up to EOF), in rank order."""
    out: list[bytes] = [b""] * world

    def client(i: int) -> None:
        with socket.create_connection((host, port), timeout=10) as s:
            P.send_hello(s, P.CMD_START, str(i), listen_port=6000 + i)
            s.settimeout(10)
            chunks = []
            while True:
                try:
                    data = s.recv(65536)
                except OSError:
                    break
                if not data:
                    break
                chunks.append(data)
            out[i] = b"".join(chunks)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    return out


def test_single_job_bytes_identical_to_plain_tracker():
    """A bare-id job through a service gets the bytes a plain Tracker
    sends: the single-job path is unrouted."""
    plain = Tracker(2, quiet=True).start()
    svc = CollectiveService(2, quiet=True).start()
    try:
        a = _bootstrap_bytes(plain.host, plain.port, 2)
        b = _bootstrap_bytes(svc.host, svc.port, 2)
        assert all(x for x in a) and a == b
    finally:
        plain.stop()
        svc.stop()


# -- admission ------------------------------------------------------------------------

def test_registry_quotas_and_keys():
    reg = JobRegistry(max_jobs=2, max_jobs_per_tenant=1, max_ranks=6)
    assert tenant_of("teamA.fit1") == "teamA"
    assert tenant_of("solo") == "solo"
    assert reg.admit("teamA.fit1", 4) is None
    assert "tenant" in reg.admit("teamA.fit2", 1)       # the tenant's quota
    assert "rank budget" in reg.admit("teamB.fit1", 3)  # 4 + 3 > 6
    assert reg.admit("teamB.fit1", 2) is None
    assert "service full" in reg.check("teamC.x", 1)
    assert "invalid" in reg.check("bad key!", 1)
    assert "reserved" in reg.check("pool", 1)
    assert "reserved" in reg.check("service", 1)
    assert "already live" in reg.check("teamB.fit1", 1)
    # a release frees the slot and the ranks
    reg.release("teamA.fit1")
    assert reg.admit("teamC.x", 4) is None
    assert reg.stats()["n_completed"] == 1


def test_admission_refused_api_and_wire():
    svc = CollectiveService(2, quiet=True, max_jobs=1).start()
    try:
        svc.admit("ja", 2)
        with pytest.raises(AdmissionRefused):
            svc.admit("jb", 2)
        refused = [e for e in svc.events if e["kind"] == "admission_refused"]
        assert refused and refused[-1]["job"] == "jb"
        # on the wire: a hello of an unknown job (auto_world off) is closed
        # with no reply
        with socket.create_connection((svc.host, svc.port), timeout=5) as s:
            P.send_hello(s, P.CMD_START, "0", listen_port=6100, job="zz")
            s.settimeout(5)
            assert s.recv(4) == b""
        refused = [e for e in svc.events if e["kind"] == "admission_refused"]
        assert any(e["job"] == "zz" for e in refused)
    finally:
        svc.stop()


# -- many jobs on one reactor -------------------------------------------------------------

def test_two_jobs_concurrent_bitwise_and_telemetry(tmp_path):
    obs = str(tmp_path / "obs")
    svc = CollectiveService(quiet=True, obs_dir=obs).start()
    try:
        parts = {k: svc.admit(k, 2) for k in ("ja", "jb")}
        res = run_workers((svc.host, svc.port), [(k, str(i)) for k in ("ja", "jb")
                                                 for i in range(2)])
        exp = expected(2, 3)
        for r in res.values():
            assert r.completed, r.error
            assert np.array_equal(r.state, exp)
        for part in parts.values():
            assert part.wait(5)
        wait_retired(svc)
        assert svc.live_jobs() == []
        kinds = [e["kind"] for e in svc.events]
        assert kinds.count("job_admitted") == 2
        assert kinds.count("job_completed") == 2
    finally:
        svc.stop()
    names = sorted(os.listdir(obs))
    assert "telemetry-ja.json" in names and "telemetry-jb.json" in names
    assert "telemetry-service.json" in names
    with open(os.path.join(obs, "telemetry-ja.json")) as f:
        tele = json.load(f)
    assert tele["job"] == "ja" and tele["world_size"] == 2
    with open(os.path.join(obs, "telemetry-service.json")) as f:
        stele = json.load(f)
    assert stele["service"]["n_admitted"] == 2
    from rabit_tpu_torch.obs import trace

    job = trace.load_job(obs, job_key="ja")
    assert job.telemetry and job.telemetry["job"] == "ja"


def test_noisy_neighbor_isolation_smoke():
    """A straggler storm in one job leaves its neighbour completing with the
    right bits (the timing bar is the bench's)."""
    svc = CollectiveService(quiet=True).start()
    try:
        svc.admit("victim", 2)
        svc.admit("calm", 2)

        def slow_contribution(v, world, rank):
            if rank == 1:
                time.sleep(0.4)  # every round
            return contribution(v, world, rank)

        results: dict[str, object] = {}
        threads = []
        for i in range(2):
            w = ElasticWorker((svc.host, svc.port), str(i), slow_contribution, 3,
                              job="victim", deadline_sec=40)
            threads.append(threading.Thread(
                target=lambda w=w: results.__setitem__(w.task_id, w.run()), daemon=True))
        for t in threads:
            t.start()
        t0 = time.monotonic()
        calm = run_workers((svc.host, svc.port), [("calm", "0"), ("calm", "1")])
        calm_wall = time.monotonic() - t0
        for t in threads:
            t.join(timeout=45)
        exp = expected(2, 3)
        for r in list(calm.values()) + list(results.values()):
            assert r.completed, r.error
            assert np.array_equal(r.state, exp)
        assert calm_wall < 30.0
    finally:
        svc.stop()


# -- the journal and the standby ------------------------------------------------------------

def test_service_journal_reopen_restores_live_jobs(tmp_path):
    path = str(tmp_path / "svc.journal")
    svc = CollectiveService(quiet=True, journal=path).start()
    svc.admit("done", 2)
    svc.admit("live", 2, pooled=True)
    res = run_workers((svc.host, svc.port), [("done", "0"), ("done", "1")])
    assert all(r.completed for r in res.values())
    wait_retired(svc, ["done"])
    assert "done" not in svc.live_jobs()
    svc.stop()
    # a new service on the same journal restores the live job only
    svc2 = CollectiveService(quiet=True, journal=path)
    try:
        assert svc2.live_jobs() == ["live"]
        part = svc2.partition("live")
        assert part is not None and part.world_size == 2
        restored = [e for e in svc2.events if e["kind"] == "job_admitted" and e.get("restored")]
        assert [e["job"] for e in restored] == ["live"]
        assert restored[0]["pooled"] is True
    finally:
        svc2.stop()


def test_kill_with_two_jobs_live_standby_restores_both():
    """The service killed mid-run with two jobs live: the service-mode
    standby replays the one journal, its CollectiveService restores both
    partitions, and both jobs complete bitwise through the cut."""
    svc = CollectiveService(quiet=True, journal=Journal(None, state=ServiceState())).start()
    standby = Standby(primary=(svc.host, svc.port), takeover_sec=0.6, service=True,
                      quiet=True).start()
    assert standby.wait_synced(5)
    addrs = [(svc.host, svc.port), (standby.host, standby.port)]
    for k in ("ja", "jb"):
        svc.admit(k, 2)

    def slow_contribution(v, world, rank):
        time.sleep(0.25)
        return contribution(v, world, rank)

    results: dict[str, object] = {}
    threads = []
    for key in ("ja", "jb"):
        for i in range(2):
            w = ElasticWorker(addrs, str(i), slow_contribution, 6, job=key, deadline_sec=60,
                              heartbeat_sec=0.3, rpc_timeout=1.0, wave_timeout=15.0)
            threads.append(threading.Thread(
                target=lambda w=w: results.__setitem__(w.task_id, w.run()), daemon=True))
    for t in threads:
        t.start()
    try:
        time.sleep(1.5)  # both jobs mid-run
        svc.kill()
        assert standby.wait_promoted(10)
        promoted = standby.tracker
        assert isinstance(promoted, CollectiveService)
        assert promoted.live_jobs() == ["ja", "jb"]
        for t in threads:
            t.join(timeout=60)
        exp = expected(2, 6)
        assert len(results) == 4
        for tid, r in sorted(results.items()):
            assert r.completed, (tid, r.error)
            assert np.array_equal(r.state, exp), tid
        # no live rank's lease expired across the cut
        assert not any(e["kind"] == "lease_expired"
                       for part in ("ja", "jb")
                       for e in (promoted.partition(part).events
                                 if promoted.partition(part) else []))
    finally:
        standby.stop()


# -- pooled workers ------------------------------------------------------------------------

def test_pooled_workers_leased_to_successive_jobs():
    svc = CollectiveService(quiet=True).start()
    pool = [PooledWorker((svc.host, svc.port), f"w{i}", contribution, 3, deadline_sec=40)
            for i in range(2)]
    threads = [p.start_thread() for p in pool]
    try:
        time.sleep(0.3)  # both parked
        exp = expected(2, 3)
        for k in ("fit1", "fit2"):
            part = svc.admit(k, 2, pooled=True)
            assert part.wait(20), f"{k} never completed"
        time.sleep(0.3)
        for p in pool:
            p.stop()
        for t in threads:
            t.join(timeout=10)
        for p in pool:
            fits = [r for r in p.results if r.promoted]
            assert len(fits) == 2  # leased to both jobs in turn
            for r in fits:
                assert r.completed and np.array_equal(r.state, exp)
        leased = [e for e in svc.events if e["kind"] == "worker_leased"]
        assert sorted({e["job"] for e in leased}) == ["fit1", "fit2"]
        assert all(e["task_id"].startswith("pool/") for e in leased)
    finally:
        for p in pool:
            p.stop()
        svc.stop()


# -- one relay tier -------------------------------------------------------------------------

def test_one_relay_tier_multiplexes_jobs():
    svc = CollectiveService(quiet=True).start()
    relay = Relay((svc.host, svc.port), relay_id="r0", flush_sec=0.05).start()
    try:
        for k in ("ja", "jb"):
            svc.admit(k, 2)
        info = svc._batch_ack_info()
        assert sorted(info["jobs"]) == ["ja", "jb"]
        res = run_workers((relay.host, relay.port), [(k, str(i)) for k in ("ja", "jb")
                                                     for i in range(2)],
                          heartbeat_sec=0.2)
        exp = expected(2, 3)
        for tid, r in res.items():
            assert r.completed, (tid, r.error)
            assert np.array_equal(r.state, exp)
        assert relay.stats["routed"] >= 4  # both jobs' waves routed back
    finally:
        relay.stop()
        svc.stop()


def test_relay_blob_cache_dedupes_per_job_version():
    svc = CollectiveService(quiet=True).start()
    relay = Relay((svc.host, svc.port), relay_id="r0", flush_sec=0.05).start()
    try:
        part = svc.admit("ja", 2)

        def upload(task, version, blob):
            with socket.create_connection((relay.host, relay.port), timeout=5) as s:
                P.send_hello(s, P.CMD_BLOB, task, blob=blob, blob_version=version)
                assert P.get_u32(s) == P.ACK

        upload("ja/0", 7, b"x" * 64)
        time.sleep(0.3)  # proxied, and cached once the tracker ACKed
        upload("ja/1", 7, b"x" * 64)  # another child, the same version: here
        upload("ja/0", 6, b"w" * 16)  # an older version: here
        assert relay.stats["blob_cache_hits"] == 2
        upload("ja/0", 8, b"y" * 32)  # a newer version: proxied
        deadline = time.monotonic() + 5
        while (part._blob is None or part._blob[0] != 8) and time.monotonic() < deadline:
            time.sleep(0.05)
        assert part._blob is not None and part._blob[0] == 8
        assert relay.stats["blob_cache_hits"] == 2
    finally:
        relay.stop()
        svc.stop()


# -- the state machine ------------------------------------------------------------------------

def test_service_state_routing_rules():
    st = ServiceState()
    st.apply("tick", {})  # no job: nothing comes into being
    st.apply("lease", {"job": "x", "task_id": "0", "interval": 0.5, "rank": 0})
    assert st.jobs == {}
    st.apply("init", {"job": "a", "base_world": 2})
    st.apply("init", {"job": "b", "base_world": 3})
    st.apply("wave", {"job": "a", "epoch": 0, "world": 2, "rank_map": {"0": 0, "1": 1},
                      "started": ["0", "1"], "promoted": []})
    assert st.jobs["a"].epoch == 0 and st.jobs["b"].epoch == -1
    st.apply("init", {"job": "service", "base_world": 9})  # serving evidence
    assert "service" not in st.jobs
    again = ServiceState.from_snapshot(st.snapshot())
    assert again.snapshot_bytes() == st.snapshot_bytes()
    st.apply("job_retired", {"job": "a"})
    assert sorted(st.jobs) == ["b"]


def test_service_state_from_plain_journal():
    """A single-job journal replays into the "" partition."""
    recs = [("init", {"base_world": 2}),
            ("wave", {"epoch": 0, "world": 2, "rank_map": {"0": 0, "1": 1},
                      "started": ["0", "1"], "promoted": []}),
            ("shutdown", {"task_id": "0"})]
    svc = ServiceState()
    for kind, fields in recs:
        svc.apply(kind, dict(fields))
    solo = replay([(k, dict(f)) for k, f in recs])
    assert svc.jobs[""].snapshot_bytes() == solo.snapshot_bytes()


# -- the schedule runner, keyed ----------------------------------------------------------------

def test_chaos_schedule_runs_namespaced():
    """A whole elastic scenario runs as one tenant: the task ids carry the
    key end to end, under every assert of the runner."""
    from rabit_tpu_torch.chaos import run_elastic_schedule

    res = run_elastic_schedule(4242, world=2, niter=3, deadline_sec=30.0, job="tenant1",
                               device="cpu")
    assert res.outcome == "completed" and res.n_completed >= 1


# -- the bench's gate ---------------------------------------------------------------------------

def test_service_bench_smoke_gate():
    from tools.torch_service_bench import bench_service

    records = bench_service(n_jobs=4, world=2, niter=2, sleep=0.02, relays=1,
                            chaos="straggler", straggle=0.25, bar=1.2, pool=2, pool_jobs=2,
                            deadline=40.0, assert_isolation=False, device="cpu")
    by_mode = {r["mode"]: r for r in records}
    assert by_mode["clean"]["bitwise_ok"] and by_mode["clean"]["completed"]
    assert by_mode["clean"]["jobs_per_sec"] > 0
    assert by_mode["clean"]["boot_p99_ms"] > 0
    assert by_mode["chaos"]["neighbors_bitwise_ok"]
    assert by_mode["chaos"]["victim_completed"]
    assert by_mode["pooled"]["fits_completed"] == 2
    assert by_mode["summary"]["wire_legacy_identical"]
    # every round of every worker went through the histogram
    assert by_mode["summary"]["contributions"] > 0


# -- parity with rabit_tpu, both ways -------------------------------------------------------------

@pytest.mark.parametrize("cmd,kw", _HELLO_SHAPES)
def test_parity_keyed_hello_bytes(cmd, kw):
    from rabit_tpu.tracker import protocol as JP

    ours, theirs = _Sink(), _Sink()
    P.send_hello(ours, cmd, "7", prev_rank=1, job="teamA.fit1", **kw)
    JP.send_hello(theirs, cmd, "7", prev_rank=1, job="teamA.fit1", **kw)
    assert ours.buf.getvalue() == theirs.buf.getvalue()
    assert P.POOL_PREFIX == JP.POOL_PREFIX and P.JOB_SEP == JP.JOB_SEP


def test_parity_jax_worker_against_port_service():
    """rabit_tpu's keyed ElasticWorker completes against the port's
    service, bitwise."""
    from rabit_tpu.elastic.client import ElasticWorker as JaxWorker

    svc = CollectiveService(quiet=True).start()
    try:
        svc.admit("jx", 2)
        res = run_workers((svc.host, svc.port), [("jx", "0"), ("jx", "1")],
                          worker_cls=JaxWorker)
        assert sorted(res) == ["jx/0", "jx/1"]
        for r in res.values():
            assert r.completed, r.error
            assert np.array_equal(r.state, expected(2, 3))
    finally:
        svc.stop()


def test_parity_port_worker_against_jax_service():
    """The port's keyed ElasticWorker completes against rabit_tpu's
    service, bitwise."""
    from rabit_tpu.service import CollectiveService as JaxService

    svc = JaxService(quiet=True).start()
    try:
        svc.admit("pt", 2)
        res = run_workers((svc.host, svc.port), [("pt", "0"), ("pt", "1")])
        assert sorted(res) == ["pt/0", "pt/1"]
        for r in res.values():
            assert r.completed, r.error
            assert np.array_equal(r.state, expected(2, 3))
    finally:
        svc.stop()


def test_parity_journal_replays_in_both_packages(tmp_path):
    """A journal the port's service wrote (two jobs interleaved, one
    retired) replays to the same ServiceState bytes in both packages, and
    to the service's own mirror."""
    from rabit_tpu.ha.journal import read_journal as jax_read_journal
    from rabit_tpu.service import ServiceState as JaxServiceState

    from rabit_tpu_torch.ha.journal import read_journal

    path = str(tmp_path / "svc.journal")
    svc = CollectiveService(quiet=True, journal=path).start()
    try:
        svc.admit("done", 2)
        svc.admit("live", 2, pooled=True)
        res = run_workers((svc.host, svc.port), [("done", "0"), ("done", "1")])
        assert all(r.completed for r in res.values())
        wait_retired(svc, ["done"])
    finally:
        svc.stop()
    mirror = svc.journal.state_bytes()  # every record the writer applied
    ours, theirs = ServiceState(), JaxServiceState()
    records, torn = read_journal(path)
    jax_records, jax_torn = jax_read_journal(path)
    assert not torn and not jax_torn and records == jax_records
    for kind, fields in records:
        ours.apply(kind, dict(fields))
        theirs.apply(kind, dict(fields))
    assert ours.snapshot_bytes() == theirs.snapshot_bytes() == mirror
    assert sorted(ours.jobs) == ["live"]


def test_parity_batch_ack_jobs_map_read_alike():
    """A service's batch ACK (two jobs, one with a delivery line) folds into
    the same per-job epoch caches and delivery lines in both relays."""
    from rabit_tpu.relay import Relay as JaxRelay

    svc = CollectiveService(quiet=True).start()
    ours = Relay((svc.host, svc.port), relay_id="p0")
    theirs = JaxRelay((svc.host, svc.port), relay_id="j0")
    try:
        svc.admit("ja", 2)
        part = svc.admit("jb", 3)
        with socket.create_connection((svc.host, svc.port), timeout=5) as s:
            P.send_hello(s, P.CMD_SUB, "pub0", job="jb", message=json.dumps(
                {"publish": {"version": 4, "epoch": 0, "digest": "ab" * 32, "size": 9}}))
            assert P.get_u32(s) == P.ACK
        assert part._delivery is not None and part._delivery["version"] == 4
        payload = json.dumps(svc._batch_ack_info()).encode()
        ours._fold_ack(payload)
        theirs._fold_ack(payload)
        assert ours._job_epochs == theirs._job_epochs
        assert sorted(ours._job_epochs) == ["ja", "jb"]
        assert ours._job_epochs["jb"]["world"] == 3
        assert ours._sub_lines == theirs._sub_lines
        assert ours._sub_lines["jb"]["version"] == 4
    finally:
        for r in (ours, theirs):
            r.stop()
        svc.stop()
