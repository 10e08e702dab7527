"""The port's reactor serving path and relay tier against rabit_tpu's.

* **Wire bytes.** The batch, route and delta frames of both packages are the
  same bytes for the same inputs and read each other's; the incremental
  hello parser gives rabit_tpu's ``Hello`` and ``rest()`` fed a byte at a
  time and in chunks of 3 and 1000; the relay commands, flags, job keys and
  the parity table agree.
* **Reactor vs threaded.** Reply bytes of every short RPC and the
  Assignment bytes of a scripted wave are identical on the port's
  ``reactor=True``, its ``reactor=False`` and rabit_tpu's tracker (clock
  stamps compared by shape); the same elastic job on both serving paths
  gives bitwise equal states and the same event kinds and counters; the
  reactor carries a relay's batch pipelined behind its hello, drops a torn
  hello without stalling, and ``kill()`` closes its connections.
  ``rabit_tracker_backlog``; ``_RelayedConn`` reads as EOF on a dead
  channel or a reported hang-up.
* **Relays across the packages.** The port's workers behind the port's
  relay in front of rabit_tpu's tracker, rabit_tpu's workers and relay in
  front of the port's tracker, and the port under its own: bootstrap,
  heartbeats, metrics with deltas and blob-cache hits, states bitwise the
  totals, root accepts O(relays).  Deltas the port's relay coalesces fold to
  the rollup of direct shipping and are the CMD_OBS payload rabit_tpu's
  relay builds from the same snapshots.  Quorum reports ride batches.
* **Faults.** A relay bounce (no lease_expired; a lost-relay incident opens
  and resolves), a relay across a tracker failover (``LocalCluster(
  standby=True, relays=1)``), a process-level relayed job with a mock kill
  (``LocalCluster(3, relays=2)``), and the port's scale sweep at world 256
  with rabit_tpu's assertions.
"""

from __future__ import annotations

import json
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from rabit_tpu.elastic.client import ElasticWorker as JaxWorker
from rabit_tpu.relay import RELAY_LEASE_PAD as JAX_LEASE_PAD
from rabit_tpu.relay import Relay as JaxRelay
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch.elastic.client import ElasticWorker
from rabit_tpu_torch.elastic.rebalance import shard_slice
from rabit_tpu_torch.engine import native
from rabit_tpu_torch.obs import stream
from rabit_tpu_torch.obs.metrics import MetricsRegistry
from rabit_tpu_torch.relay import RELAY_LEASE_PAD, Relay
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.launcher import LocalCluster
from rabit_tpu_torch.tracker.tracker import Tracker, _conn_dead, _RelayChannel, _RelayedConn

REPO = Path(__file__).resolve().parents[1]
WORKERS = REPO / "tests" / "workers"
sys.path.insert(0, str(WORKERS))
import torch_diag_job  # noqa: E402

sys.path.pop(0)


# -- wire bytes ------------------------------------------------------------------

MSGS = [("7", P.CMD_START, -1, "10.0.0.7", 40007, b"", 1.25),
        ("3", P.CMD_HEARTBEAT, 3, "", 0, b"0.500000", 2.5),
        ("9", P.CMD_METRICS, 9, "", 0, b'{"rank": 9}', 3.75),
        ("s1", P.CMD_SPARE, -1, "10.0.0.8", 40008, b"", 4.0),
        ("q#2", P.CMD_QUORUM, 2, "10.0.0.2", 0, b'{"epoch": 0, "v": 1}', 4.5),
        ("#delta", P.CMD_OBS, -1, "", 0, b"\x06\x70\xb1\x7a", 4.75),
        ("2", P.CMD_HANGUP, -1, "", 0, b"", 5.0)]


def pair_bytes(send: bytes, read):
    a, b = socket.socketpair()
    try:
        a.sendall(send)
        return read(b)
    finally:
        a.close()
        b.close()


def test_batch_frame_bytes_both_ways():
    mine = [P.BatchMsg(*m) for m in MSGS]
    theirs = [JP.BatchMsg(*m) for m in MSGS]
    assert P.put_batch_frame(mine) == JP.put_batch_frame(theirs)
    got = pair_bytes(JP.put_batch_frame(theirs), P.read_batch_frame)
    assert [tuple(vars(m).values()) for m in got] == MSGS
    got = pair_bytes(P.put_batch_frame(mine), JP.read_batch_frame)
    assert [tuple(vars(m).values()) for m in got] == MSGS
    assert P.put_batch_frame([]) == JP.put_batch_frame([])


@pytest.mark.parametrize("task_id,flags,payload", [
    ("task9", P.ROUTE_CLOSE, b"payload"), ("", 0, b'{"server_ts": 1.0}'), ("q#4", 1, b""),
    ("s2", 0, P.put_blob_frame(3, b"blob"))])
def test_route_frame_bytes_both_ways(task_id, flags, payload):
    assert P.put_route_frame(task_id, flags, payload) == JP.put_route_frame(task_id, flags,
                                                                            payload)
    assert pair_bytes(JP.put_route_frame(task_id, flags, payload),
                      P.read_route_frame) == (task_id, flags, payload)
    assert pair_bytes(P.put_route_frame(task_id, flags, payload),
                      JP.read_route_frame) == (task_id, flags, payload)


def delta_of(seed: int) -> dict:
    """A seeded delta window: counters and a link-wait histogram."""
    reg = MetricsRegistry()
    src = stream.DeltaSource(reg)
    rng = np.random.default_rng(seed)
    for _ in range(int(rng.integers(1, 6))):
        stream.stream_observe("link_wait_seconds", float(rng.uniform(0, 0.3)), registry=reg,
                              src=int(rng.integers(0, 3)), dst=int(rng.integers(0, 3)))
    stream.stream_count("wire_bytes", int(rng.integers(1, 1 << 20)), registry=reg,
                        codec="i8", fused=1)
    return src.take()


@pytest.mark.parametrize("seed", range(4))
def test_delta_frame_bytes_both_ways(seed):
    doc = stream.merge_delta_doc(stream.delta_doc("", 0, delta_of(seed)),
                                 stream.delta_doc("", 1, delta_of(seed + 10)))
    frame = P.put_delta_frame(doc)
    assert frame == JP.put_delta_frame(doc)
    assert P.delta_frame_from_bytes(frame) == JP.delta_frame_from_bytes(frame) == doc
    assert pair_bytes(frame, P.read_delta_frame) == pair_bytes(frame, JP.read_delta_frame)


@pytest.mark.parametrize("bad", [b"\x00" * 8, P.put_u32(P.MAGIC_DELTA) + P.put_u32(9) + b"x",
                                 P.put_u32(P.MAGIC_DELTA) + P.put_u32(2) + b"xx"])
def test_delta_frame_refusals_agree(bad):
    with pytest.raises(ValueError):
        P.delta_frame_from_bytes(bad)
    with pytest.raises(ValueError):
        JP.delta_frame_from_bytes(bad)


def hellos() -> list[bytes]:
    """One hello of every shape the parser knows, the task ids non-ASCII
    where they may be."""
    out = []
    for cmd in (P.CMD_START, P.CMD_RECOVER, P.CMD_SPARE):
        out.append(P.put_u32(P.MAGIC_HELLO) + P.put_u32(cmd) + P.put_i32(-1) + P.put_str("jöb/0")
                   + P.put_u32(40000 + cmd))
    for cmd in (P.CMD_PRINT, P.CMD_METRICS, P.CMD_HEARTBEAT, P.CMD_EPOCH, P.CMD_QUORUM,
                P.CMD_OBS, P.CMD_SUB, P.CMD_SNAP):
        out.append(P.put_u32(P.MAGIC_HELLO) + P.put_u32(cmd) + P.put_i32(4) + P.put_str("4")
                   + P.put_str(f"message of {cmd}"))
    out.append(P.put_u32(P.MAGIC_HELLO) + P.put_u32(P.CMD_BLOB) + P.put_i32(0) + P.put_str("0")
               + P.put_u32(3) + P.put_u32(5) + b"hello")
    for cmd in (P.CMD_SHUTDOWN, P.CMD_BATCH, P.CMD_JOURNAL, 99):
        out.append(P.put_u32(P.MAGIC_HELLO) + P.put_u32(cmd) + P.put_i32(1) + P.put_str("r1"))
    return out


def parse(mod, raw: bytes, chunk: int):
    sp = mod.StreamParser(mod.hello_parser())
    done = False
    for i in range(0, len(raw), chunk):
        done = sp.feed(raw[i:i + chunk])
    return done, vars(sp.result) if sp.done else None, sp.rest()


@pytest.mark.parametrize("chunk", [1, 3, 1000])
@pytest.mark.parametrize("tail", [b"", b"PIPELINED" * 3])
def test_hello_parser_against_jax(chunk, tail):
    for raw in hellos():
        mine, theirs = parse(P, raw + tail, chunk), parse(JP, raw + tail, chunk)
        assert mine == theirs and mine[0] and mine[2] == tail
        assert parse(P, raw[:-1], chunk)[:2] == (False, None)  # one byte short: not done


@pytest.mark.parametrize("raw", [P.put_u32(0xDEAD) + b"\x00" * 16,
                                 P.put_u32(P.MAGIC_HELLO) + P.put_u32(3) + P.put_i32(0)
                                 + P.put_u32(1 << 17),
                                 P.put_u32(P.MAGIC_HELLO) + P.put_u32(3) + P.put_i32(0)
                                 + P.put_str("0") + P.put_u32(65 << 20)])
def test_hello_parser_refusals_agree(raw):
    for mod in (P, JP):
        with pytest.raises(ValueError):
            mod.StreamParser(mod.hello_parser()).feed(raw)


def test_assignment_head_tail_equals_encode():
    """The reactor's split encoding (a head a member, one shared tail) is
    the bytes of Assignment.encode."""
    asg = P.Assignment(rank=2, world_size=5, parent=0, children=[5], ring_prev=1, ring_next=3,
                       peers={r: ("127.0.0.1", 40000 + r) for r in range(5)}, epoch=7,
                       rank_map={str(i): i for i in range(5)}, algo="swing",
                       ring_order=[0, 2, 4, 3, 1])
    split = (P.assignment_head_bytes(2, 5, 0, asg.children, 1, 3)
             + P.assignment_tail_bytes(asg.peers, 7, asg.rank_map, "swing", asg.ring_order))
    assert split == asg.encode()


def test_relay_constants_agree():
    for name in ("CMD_BATCH", "CMD_HANGUP", "CMD_OBS", "CMD_SUB", "CMD_SNAP", "ROUTE_CLOSE",
                 "MAGIC_DELTA", "DELTA_MAX_BYTES", "JOB_SEP"):
        assert getattr(P, name) == getattr(JP, name), name
    assert RELAY_LEASE_PAD == JAX_LEASE_PAD
    for tid in ("7", "job/7", "a/b/c", "", "/x"):
        assert P.split_job(tid) == JP.split_job(tid)
        assert P.join_job(*P.split_job(tid)) == JP.join_job(*JP.split_job(tid))
    for path, table in P.PARITY_EXEMPT.items():
        assert table.keys() <= JP.PARITY_EXEMPT[path].keys()
        assert all(hasattr(P, cmd) for cmd in table)


def test_relay_lease_padding_math():
    """The bounce-survival contract: the tracker's lease of a relayed child
    (LEASE_FACTOR x the padded interval) outlives a whole missed flush."""
    for child, flush in ((0.2, 0.25), (0.3, 0.05), (1.0, 0.25)):
        padded = max(child, flush) * RELAY_LEASE_PAD
        assert padded * P.LEASE_FACTOR >= 2 * flush + child


# -- reactor vs threaded --------------------------------------------------------

def rpc_bytes(addr, cmd, task_id, message="", listen_port=0, prev_rank=-1, blob=b"",
              blob_version=0) -> bytes:
    """One raw RPC: the hello out, every reply byte back until EOF."""
    with socket.create_connection(addr, timeout=5.0) as sock:
        sock.settimeout(5.0)
        P.send_hello(sock, cmd, task_id, prev_rank=prev_rank, listen_port=listen_port,
                     message=message, blob=blob, blob_version=blob_version)
        out = b""
        while True:
            try:
                chunk = sock.recv(4096)
            except socket.timeout:
                break
            if not chunk:
                break
            out += chunk
    return out


def three_trackers(world: int, **kw):
    return {"reactor": Tracker(world, quiet=True, **kw).start(),
            "threaded": Tracker(world, quiet=True, reactor=False, **kw).start(),
            "jax": JaxTracker(world, quiet=True, **kw).start()}


@pytest.mark.parametrize("quorum", ["", "1.0"])
def test_reply_bytes_identical_on_three_trackers(quorum):
    trackers = three_trackers(2, quorum=quorum)
    try:
        replies, stamped = {}, {}
        for name, tr in trackers.items():
            addr = (tr.host, tr.port)
            replies[name] = [
                rpc_bytes(addr, P.CMD_PRINT, "0", message="hello world"),
                rpc_bytes(addr, P.CMD_EPOCH, "0", message="3"),
                rpc_bytes(addr, P.CMD_BLOB, "0", blob=b"abc", blob_version=2),
                rpc_bytes(addr, P.CMD_QUORUM, "0", message='{"epoch": 0, "v": 1, "have": [0]}'),
                rpc_bytes(addr, P.CMD_QUORUM, "0", message="not json"),
                rpc_bytes(addr, P.CMD_SHUTDOWN, "5"),
                rpc_bytes(addr, 99, "0"),  # a command no tracker serves: closed unanswered
            ]
            stamped[name] = [rpc_bytes(addr, P.CMD_HEARTBEAT, "0", message="5.0"),
                             rpc_bytes(addr, P.CMD_METRICS, "0", message='{"rank": 0}')]
        assert replies["reactor"] == replies["threaded"] == replies["jax"]
        assert replies["jax"][-1] == b""
        for name, raws in stamped.items():
            for raw in raws:  # ACK + the tracker's clock as a decimal string
                assert raw[:4] == P.put_u32(P.ACK), name
                assert abs(float(raw[8:].decode()) - time.time()) < 5.0, name
        stats = {n: tr.serve_stats for n, tr in trackers.items()}
        assert stats["reactor"]["handler_threads_hwm"] == stats["jax"]["handler_threads_hwm"] == 0
        assert stats["threaded"]["handler_threads_hwm"] >= 1
        assert stats["reactor"]["rpcs"] == stats["jax"]["rpcs"]
    finally:
        for tr in trackers.values():
            tr.stop()


def scripted_wave(tr, world: int = 3) -> dict[str, bytes]:
    """``world`` scripted check-ins; task id -> the raw Assignment bytes."""
    out: dict[str, bytes] = {}

    def checkin(tid: str) -> None:
        out[tid] = rpc_bytes((tr.host, tr.port), P.CMD_START, tid, listen_port=41000 + int(tid))

    threads = [threading.Thread(target=checkin, args=(str(i),), daemon=True)
               for i in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10.0)
        assert not th.is_alive()
    return out


@pytest.mark.parametrize("schedule", ["auto", "ring", "swing"])
def test_assignment_bytes_identical_on_three_trackers(schedule):
    waves = {}
    for name, tr in three_trackers(3, schedule=schedule).items():
        try:
            waves[name] = scripted_wave(tr)
        finally:
            tr.stop()
    assert waves["reactor"] == waves["threaded"] == waves["jax"]
    assert all(len(b) > 40 and b[:4] == P.put_u32(P.MAGIC_ASSIGN)
               for b in waves["reactor"].values())


def hist_job(world, niter):
    data = (np.arange(8 * world, dtype=np.int64) * 3) % 8

    def contribution(v, w, r):
        rows = data[shard_slice(len(data), w, r)]
        return np.bincount(rows, minlength=8).astype(np.int64) * v

    expected = sum(np.bincount(data, minlength=8).astype(np.int64) * v
                   for v in range(1, niter + 1))
    return contribution, expected


def run_workers(addr_of, world: int, niter: int, worker_cls=ElasticWorker, **kw):
    """In-thread workers to their end; task id -> ElasticResult."""
    contribution, expected = hist_job(world, niter)
    results = {}
    workers = [worker_cls(addr_of(i), str(i), contribution, niter,
                          **{"heartbeat_sec": 0.2, "wave_timeout": 10.0, "link_timeout": 5.0,
                             "deadline_sec": 40.0, **kw}) for i in range(world)]
    threads = [threading.Thread(target=lambda w=w: results.__setitem__(w.task_id, w.run()),
                                daemon=True) for w in workers]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=45.0)
        assert not th.is_alive(), "a worker hung"
    for tid, res in results.items():
        assert res.completed, (tid, res.error)
        assert np.array_equal(res.state, expected), tid
    return results


def test_same_elastic_job_on_both_serving_paths():
    out = {}
    for reactor in (True, False):
        tr = Tracker(3, quiet=True, reactor=reactor).start()
        try:
            res = run_workers(lambda i: (tr.host, tr.port), 3, 3)
            assert tr.wait(8.0)
        finally:
            tr.stop()
        out[reactor] = (res, tr.telemetry)
    (res_r, tel_r), (res_t, tel_t) = out[True], out[False]
    for tid in res_r:
        assert np.array_equal(res_r[tid].state, res_t[tid].state)
    for key in ("n_waves", "n_recovery_waves", "n_lease_expired", "world_size",
                "messages_dropped", "n_relays_up", "n_relays_lost"):
        assert tel_r[key] == tel_t[key], key
    assert sorted(e["kind"] for e in tel_r["events"]) == sorted(e["kind"] for e in tel_t["events"])
    assert tel_r["serving"]["reactor"] and not tel_t["serving"]["reactor"]
    assert tel_r["serving"]["handler_threads_hwm"] == 0
    assert tel_t["serving"]["handler_threads_hwm"] >= 1
    assert tel_r["serving"]["reactor_conns_hwm"] >= 1 and tel_t["serving"]["reactor_conns_hwm"] == 0
    assert tel_r["serving"]["rpcs"] == tel_t["serving"]["rpcs"]


def test_backlog_config_key(monkeypatch):
    tr = Tracker(2, quiet=True)
    assert tr.backlog == JaxTracker(2, quiet=True).backlog == 1024
    tr.stop()
    monkeypatch.setenv("RABIT_TPU_RABIT_TRACKER_BACKLOG", "64")
    tr = Tracker(2, quiet=True)
    assert tr.backlog == 64 and tr.build_scrape()["serving"]["backlog"] == 64
    tr.stop()
    tr = Tracker(2, quiet=True, backlog=256)  # an explicit argument wins
    assert tr.backlog == 256
    tr.stop()


def test_relayed_conn_reads_dead_on_channel_loss_or_hangup():
    a, b = socket.socketpair()
    try:
        ch = _RelayChannel(a, "rX")
        vconn = _RelayedConn(ch, "5")
        assert not _conn_dead(vconn)        # open and idle
        vconn.sendall(b"probe")             # routes a frame
        assert P.read_route_frame(b) == ("5", 0, b"probe")
        ch.vconns["5"].child_dead = True    # a CMD_HANGUP fold
        assert _conn_dead(vconn)
        with pytest.raises(OSError):
            vconn.sendall(b"late")
        vconn2 = _RelayedConn(ch, "6")
        vconn2.close()                      # ROUTE_CLOSE goes to the relay
        assert P.read_route_frame(b) == ("6", P.ROUTE_CLOSE, b"")
        assert _conn_dead(vconn2) and "6" not in ch.vconns
        vconn3 = _RelayedConn(ch, "7")
        ch.close()
        assert _conn_dead(vconn3)           # a dead channel reads as EOF
        with pytest.raises(OSError):
            vconn3.sendall(b"late")
    finally:
        b.close()


@pytest.mark.parametrize("reactor", [True, False])
def test_relay_batch_pipelined_behind_its_hello(reactor):
    """A relay that writes its first envelope in the same write as its hello:
    the reactor carries the pipelined bytes to the channel's reader."""
    tr = Tracker(2, quiet=True, reactor=reactor).start()
    try:
        hello = P.put_u32(P.MAGIC_HELLO) + P.put_u32(P.CMD_BATCH) + P.put_i32(-1) + P.put_str("rp")
        batch = P.put_batch_frame([P.BatchMsg("0", P.CMD_PRINT, 0, "", 0, b"piped", 1.0),
                                   P.BatchMsg("1", P.CMD_HEARTBEAT, 1, "", 0, b"5.0", 1.0)])
        with socket.create_connection((tr.host, tr.port), timeout=5.0) as sock:
            sock.settimeout(5.0)
            sock.sendall(hello + batch)
            assert P.get_u32(sock) == P.ACK
            key, flags, payload = P.read_route_frame(sock)
        info = json.loads(payload)
        assert key == "" and flags == 0 and len(info["acks"]) == 2
        assert {"server_ts", "epoch", "world", "rewave"} <= set(info)
        assert "piped" in tr.messages and tr.live_tasks() == ["1"]
        assert tr.serve_stats["batches"] == 1 and tr.serve_stats["batch_msgs"] == 2
    finally:
        tr.stop()


def test_reactor_drops_a_torn_hello_and_serves_on():
    tr = Tracker(2, quiet=True).start()
    try:
        torn = socket.create_connection((tr.host, tr.port), timeout=5.0)
        torn.sendall(P.put_u32(P.MAGIC_HELLO) + P.put_u32(P.CMD_PRINT))  # and nothing more
        assert rpc_bytes((tr.host, tr.port), P.CMD_PRINT, "0", message="fine") == P.put_u32(P.ACK)
        bad = socket.create_connection((tr.host, tr.port), timeout=5.0)
        bad.settimeout(5.0)
        bad.sendall(P.put_u32(0xDEAD) + b"\x00" * 12)
        assert bad.recv(16) == b""  # a bad magic is dropped
        bad.close()
        torn.close()
    finally:
        tr.stop()


@pytest.mark.parametrize("reactor", [True, False])
def test_kill_closes_the_connections_and_answers_nothing(reactor):
    tr = Tracker(2, quiet=True, reactor=reactor).start()
    held = socket.create_connection((tr.host, tr.port), timeout=5.0)
    held.settimeout(5.0)
    held.sendall(P.put_u32(P.MAGIC_HELLO))  # a hello in flight at the kill
    pending = socket.create_connection((tr.host, tr.port), timeout=5.0)
    pending.settimeout(5.0)
    P.send_hello(pending, P.CMD_START, "0", listen_port=41000)
    time.sleep(0.2)
    tr.kill()
    try:
        assert pending.recv(16) == b""  # the forming wave dropped with no goodbye
        if reactor:
            assert held.recv(16) == b""  # the loop closed what it held
        with pytest.raises(OSError):
            socket.create_connection((tr.host, tr.port), timeout=2.0).close()
        assert tr.telemetry is None
    finally:
        held.close()
        pending.close()


# -- relays across the packages -------------------------------------------------

DIRECTIONS = {
    "port-workers-port-relay-jax-tracker": (ElasticWorker, Relay, JaxTracker),
    "jax-workers-jax-relay-port-tracker": (JaxWorker, JaxRelay, Tracker),
    "port-workers-port-relay-port-tracker": (ElasticWorker, Relay, Tracker),
}


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_relay_e2e_across_packages(direction):
    worker_cls, relay_cls, tracker_cls = DIRECTIONS[direction]
    world, niter = 3, 4
    tr = tracker_cls(world, quiet=True).start()
    relay = relay_cls((tr.host, tr.port), relay_id="rT", flush_sec=0.1).start()
    try:
        run_workers(lambda i: (relay.host, relay.port), world, niter, worker_cls=worker_cls)
        assert tr.wait(8.0)
        tel = tr.telemetry
        assert tel["n_relays_up"] == 1 and tel["n_lease_expired"] == 0
        assert tel["serving"]["batches"] >= 1
        assert tel["serving"]["batch_msgs"] >= world  # the liveness rode batches
        # the channel and rank 0's proxied blob uploads, never one a worker
        assert tel["serving"]["accepts"] <= 2 + niter
        assert sorted(tel["ranks"]) == ["0", "1", "2"]  # a snapshot a rank, through the relay
        assert sum(1 for e in tel["events"] if e["kind"] == "metrics_delta_folded") == world
        assert tel["stream"]["n_folds"] >= 1
        # a version the tracker already has is ACKed by the relay's cache
        blobs = sum(1 for e in tr.events if e["kind"] == "bootstrap_blob")
        assert P.tracker_rpc(relay.host, relay.port, P.CMD_BLOB, "0", blob=b"old",
                             blob_version=1, timeout=5.0) == P.ACK
        assert relay.stats["blob_cache_hits"] >= 1
        assert sum(1 for e in tr.events if e["kind"] == "bootstrap_blob") == blobs
        # the relay's child ACKs carry the tracker's clock, projected
        assert relay.clock_err < 0.5
        reply = P.tracker_rpc(relay.host, relay.port, P.CMD_HEARTBEAT, "probe", message="5.0")
        assert abs(reply.server_ts - time.time()) < 1.0
    finally:
        relay.stop()
        tr.stop()


def test_relay_blob_cache_supersedes_within_its_budget(monkeypatch):
    """Two jobs' blobs past a 10-byte budget: a version bump releases the
    superseded digest, and a digest no job holds goes first."""
    monkeypatch.setenv("RABIT_TPU_RABIT_RELAY_CACHE_BYTES", "10")
    mine, theirs = Relay(("127.0.0.1", 9)), JaxRelay(("127.0.0.1", 9))
    try:
        for r in (mine, theirs):
            r._cache_put("d1", b"123456", job="a", version=1)
            r._cache_put("d2", b"1234", job="b", version=1)
            r._cache_put("d3", b"12345678", job="a", version=2)  # supersedes d1
        assert list(mine._digest_blobs) == list(theirs._digest_blobs) == ["d2", "d3"]
        assert mine._blob_cache == theirs._blob_cache
        assert ([(e["digest"], e["reason"]) for e in mine.events]
                == [(e["digest"], e["reason"]) for e in theirs.events] == [("d1", "superseded")])
        assert mine.stats["evictions"] == theirs.stats["evictions"] == 1
    finally:
        mine.stop()
        theirs.stop()


def ship(addr, rank: int, delta: dict) -> None:
    snap = {"schema": 1, "rank": rank, "task_id": str(rank), "counters": {}, "histograms": {},
            "delta": delta}
    assert P.tracker_rpc(addr[0], addr[1], P.CMD_METRICS, str(rank), prev_rank=rank,
                         message=json.dumps(snap), timeout=5.0, retries=1) == P.ACK


def folded_windows(rollup: dict) -> dict:
    """Per rank: its counters and each histogram's count, the parts of a
    rendered rollup that only grow as windows fold (no float sums)."""
    return {rank: (state["counters"], {name: h["count"] for name, h in
                                       state["histograms"].items()})
            for rank, state in rollup["per_rank"].items()}


def test_relay_deltas_fold_as_direct_and_equal_jax_payload():
    windows = [(r, delta_of(10 * r + k)) for k in range(3) for r in range(3)]
    # the CMD_OBS payload each relay builds from the same snapshots
    payloads = []
    for relay_cls in (Relay, JaxRelay):
        relay = relay_cls(("127.0.0.1", 9), relay_id="rd").start()
        relay.set_partition(True)  # it coalesces, and nothing goes upstream
        try:
            for rank, delta in windows:
                ship((relay.host, relay.port), rank, delta)
            msgs = relay._build_batch()
        finally:
            relay.stop()
        payloads.append([m.payload for m in msgs if m.cmd == P.CMD_OBS])
        assert [m.task_id for m in msgs if m.cmd == P.CMD_OBS] == ["#delta"]
        assert sorted(m.task_id for m in msgs if m.cmd == P.CMD_METRICS) == ["0", "1", "2"]
    assert payloads[0] == payloads[1]
    # the rollup: through the relay (one frame a flush) and shipped directly
    direct, relayed = Tracker(3, quiet=True).start(), Tracker(3, quiet=True).start()
    relay = Relay((relayed.host, relayed.port), relay_id="rd", flush_sec=0.05).start()
    try:
        for rank, delta in windows:
            ship((direct.host, direct.port), rank, delta)
            ship((relay.host, relay.port), rank, delta)
        # wait until all nine windows are folded: a relay flush can carry the
        # first window of each rank while the later ones are still buffered
        want = stream.StreamRollup()
        for rank, delta in windows:
            want.fold(rank, delta)
        want = folded_windows(want.render())
        deadline = time.monotonic() + 10.0
        while (folded_windows(relayed._stream.render()) != want
               and time.monotonic() < deadline):
            time.sleep(0.05)
        mine, theirs = relayed._stream.render(), direct._stream.render()
        for key in ("total", "links", "per_rank"):
            assert mine[key] == theirs[key], key
        assert mine["n_folds"] <= theirs["n_folds"]  # coalesced: fewer, larger folds
        kinds = [e["kind"] for e in relayed.events]
        assert kinds.count("metrics_delta_folded") == 3
    finally:
        relay.stop()
        direct.stop()
        relayed.stop()


@pytest.mark.parametrize("relay_cls", [Relay, JaxRelay], ids=["port-relay", "jax-relay"])
def test_quorum_reports_ride_relay_batches(relay_cls):
    """CMD_QUORUM through a relay is a fold and a routed record: the root
    accepts the channel and rank 0's blob uploads, not a connection a rank
    and round."""
    world, niter = 2, 4
    tracker = Tracker(world, quiet=True, quorum="1.0").start()
    relay = relay_cls((tracker.host, tracker.port), relay_id="rq", flush_sec=0.05,
                      quiet=True).start()
    try:
        results = run_workers(lambda i: (relay.host, relay.port), world, niter,
                              heartbeat_sec=0.0, link_timeout=2.0, quorum="1.0",
                              quorum_wait=0.2)
    finally:
        relay.stop()
        tracker.stop()
    assert all(r.quorum_rounds == niter for r in results.values())
    assert tracker.serve_stats["batch_msgs"] >= world * niter
    assert tracker.serve_stats["accepts"] <= 2 + niter
    assert tracker.serve_stats["rpcs"] <= niter  # the blob uploads only


# -- faults ------------------------------------------------------------------------

def test_relay_bounce_keeps_leases_and_opens_a_lost_relay_incident(monkeypatch):
    """Relay 0 stopped mid-run and a new one started on its port 0.4 s
    later: no lease expires (the padded lease covers the gap), the tracker
    sees relay_lost then relay_up, and a lost-relay incident opens and
    resolves."""
    monkeypatch.setenv("RABIT_TPU_RABIT_DIAG_WINDOW_SEC", "0.1")
    contribution, _ = hist_job(3, 12)
    want = sum(contribution(v, 1, 0) for v in range(1, 13))
    out = torch_diag_job.run_job(3, 12, contribution, iter_sleep=0.1, deadline_sec=60.0,
                                 relays=2, heartbeat_sec=0.3, relay_bounce=(0.5, 0.4))
    ev = out["events"]
    for res in out["results"].values():
        assert res.completed and np.array_equal(res.state, want)
    assert not [e for e in ev if e["kind"] == "lease_expired"]
    kinds = [e["kind"] for e in ev if e["kind"] in ("relay_lost", "relay_up")]
    assert kinds[:4] == ["relay_up", "relay_up", "relay_lost", "relay_up"]
    lost = [e for e in ev if e["kind"] == "incident_opened" and e["class"] == "lost-relay"]
    assert [e["relay"] for e in lost] == ["relay0"]
    assert [e for e in ev if e["kind"] == "incident_resolved"
            and e["incident"] == lost[0]["incident"]]
    assert out["telemetry"]["n_relays_up"] == 3


def test_relay_rotates_across_a_tracker_failover():
    """LocalCluster(standby=True, relays=1): the primary is killed; the
    relay's channel fails over to the promoted tracker and replays, the
    workers never re-dial (only the relay's channel and its blob proxies
    reach the promoted tracker), and no lease expires."""
    cluster = LocalCluster(3, max_restarts=2, quiet=True, standby=True, takeover_sec=0.6,
                           relays=1, relay_flush_sec=0.1)
    rc = cluster.run([sys.executable, str(WORKERS / "torch_elastic_worker.py"), "niter=8",
                      "sleep=0.25", "hb=0.2", "deadline=90"], timeout=120.0,
                     kill_tracker_after=2.0)
    assert rc == 0
    assert all(code == 0 for code in cluster.returncodes.values()), cluster.returncodes
    kinds = [e["kind"] for e in cluster.events]
    assert kinds.count("tracker_failover") == 1 and "lease_expired" not in kinds
    assert cluster.relays[0].stats["failovers"] >= 1
    promoted = cluster.standby.tracker
    assert promoted is not None and cluster.telemetry is promoted.telemetry
    assert cluster.telemetry["n_relays_up"] >= 1
    assert promoted.serve_stats["accepts"] <= cluster.telemetry["n_relays_up"] + 8


def test_relay_replays_an_unacked_envelope_across_a_failover():
    """The first tracker of the relay's list reads one envelope and dies
    before its ACK: the channel rotates to the next address and replays
    the envelope there, so the print it carried is not lost."""
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead.listen(1)
    tr = Tracker(2, quiet=True).start()
    relay = Relay([dead.getsockname(), (tr.host, tr.port)], relay_id="rf", flush_sec=0.05,
                  rpc_timeout=1.0).start()

    def die_after_one_envelope():
        conn, _ = dead.accept()
        with conn:
            conn.settimeout(5.0)
            hello = P.StreamParser(P.hello_parser())
            while not hello.feed(P.recv_exact(conn, 1)):
                pass
            assert hello.result.cmd == P.CMD_BATCH
            conn.sendall(P.put_u32(P.ACK))
            got = P.read_batch_frame(conn)
            while not any(m.cmd == P.CMD_PRINT for m in got):
                got = P.read_batch_frame(conn)
        dead.close()  # no ACK: the next dial is refused and rotates

    th = threading.Thread(target=die_after_one_envelope, daemon=True)
    th.start()
    try:
        time.sleep(0.2)  # the channel is up to the first address
        assert P.tracker_rpc(relay.host, relay.port, P.CMD_PRINT, "0", message="survives",
                             timeout=5.0) == P.ACK
        th.join(timeout=10.0)
        deadline = time.monotonic() + 10.0
        while "survives" not in tr.messages and time.monotonic() < deadline:
            time.sleep(0.05)
        assert list(tr.messages).count("survives") == 1
        assert relay.stats["failovers"] >= 1 and relay.stats["replayed_msgs"] >= 1
        assert relay.tracker == (tr.host, tr.port)
    finally:
        relay.stop()
        tr.stop()


def test_relay_redials_at_once_when_its_channel_dies():
    """The channel dies with an envelope un-ACKed: the pump, waiting for
    that ACK, redials at once through the failover list instead of after
    ``rpc_timeout``, so a promoted standby hears from the relay within a
    flush or two."""
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead.listen(1)
    tr = Tracker(2, quiet=True).start()
    relay = Relay([dead.getsockname(), (tr.host, tr.port)], relay_id="rd", flush_sec=0.05,
                  rpc_timeout=3.0).start()
    closed = []

    def die_holding_an_envelope():
        conn, _ = dead.accept()
        with conn:
            conn.settimeout(5.0)
            hello = P.StreamParser(P.hello_parser())
            while not hello.feed(P.recv_exact(conn, 1)):
                pass
            conn.sendall(P.put_u32(P.ACK))
            P.read_batch_frame(conn)  # read, never ACKed
            dead.close()  # the next dial is refused and rotates
            closed.append(time.monotonic())

    th = threading.Thread(target=die_holding_an_envelope, daemon=True)
    th.start()
    try:
        th.join(10.0)
        assert closed
        deadline = time.monotonic() + 5.0
        while (not any(e["kind"] == "relay_up" for e in tr.events)
               and time.monotonic() < deadline):
            time.sleep(0.01)
        up = [e for e in tr.events if e["kind"] == "relay_up"]
        assert up and relay.tracker == (tr.host, tr.port)
        assert time.monotonic() - closed[0] < 1.5  # rpc_timeout is 3 s
    finally:
        relay.stop()
        tr.stop()

def test_relay_child_death_reported_and_recovered():
    """A child dies mid-job behind a relay: its peers recover through a
    wave, a new life of the same task id re-enters through the relay, and
    every state is its closed form (the launcher's restart, in threads)."""
    world, niter = 3, 4
    tr = Tracker(world, quiet=True).start()
    relay = Relay((tr.host, tr.port), relay_id="rR", flush_sec=0.1).start()
    addr = (relay.host, relay.port)
    contribution, expected = hist_job(world, niter)
    results = {}
    workers = [ElasticWorker(addr, str(i), contribution, niter, heartbeat_sec=0.2,
                             wave_timeout=10.0, link_timeout=5.0, deadline_sec=40.0,
                             fail=("die", 2) if i == 1 else None) for i in range(world)]
    threads = [threading.Thread(target=lambda w=w: results.__setitem__(w.task_id, w.run()),
                                daemon=True) for w in workers]
    try:
        for th in threads:
            th.start()
        deadline = time.monotonic() + 20.0
        while "1" not in results and time.monotonic() < deadline:
            time.sleep(0.05)
        assert results.get("1") is not None and results["1"].died
        restarted = {}
        again = ElasticWorker(addr, "1", contribution, niter, heartbeat_sec=0.2,
                              wave_timeout=10.0, link_timeout=5.0, deadline_sec=30.0)
        th1 = threading.Thread(target=lambda: restarted.update(r1=again.run()), daemon=True)
        th1.start()
        for th in threads + [th1]:
            th.join(timeout=30.0)
            assert not th.is_alive()
        assert restarted["r1"].completed, restarted["r1"].error
        assert np.array_equal(restarted["r1"].state, expected)
        for tid in ("0", "2"):
            assert results[tid].completed and np.array_equal(results[tid].state, expected)
    finally:
        relay.stop()
        tr.stop()


def test_relayed_cluster_process_level():
    """LocalCluster(3, relays=2): native workers under rabit_engine=mock, a
    mock kill, the restarted worker recovering through its relay."""
    native.build_lib()
    cluster = LocalCluster(3, max_restarts=3, quiet=True, relays=2)
    rc = cluster.run([sys.executable, str(WORKERS / "torch_recover_worker.py"),
                      "rabit_engine=mock", "ndata=500", "niter=3", "mock=1,1,1,0"],
                     timeout=120.0)
    assert rc == 0 and all(r == 0 for r in cluster.returncodes.values())
    tel = cluster.telemetry
    assert tel["n_relays_up"] == 2 and tel["n_recovery_waves"] >= 1
    assert tel["serving"]["accepts"] <= 4  # two channels (and reconnects)
    assert sum(1 for e in cluster.events if e["kind"] == "worker_recovered") >= 1


def test_launcher_cli_relays_flag():
    help_text = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.tracker.launcher",
                                "--help"], capture_output=True, text=True, cwd=REPO,
                               timeout=60, check=True).stdout
    assert "--relays" in help_text
    relay_help = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.relay", "--help"],
                                capture_output=True, text=True, cwd=REPO, timeout=60,
                                check=True).stdout
    for flag in ("--tracker", "--id", "--host", "--port", "--flush-sec", "--quiet"):
        assert flag in relay_help


def test_relay_main_prints_its_address():
    tr = Tracker(1, quiet=True).start()
    proc = subprocess.Popen([sys.executable, "-m", "rabit_tpu_torch.relay", "--tracker",
                             f"{tr.host}:{tr.port}", "--id", "rm", "--quiet"],
                            stdout=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = proc.stdout.readline()
        assert line.startswith("[relay rm] listening on 127.0.0.1:")
        port = int(line.rsplit(":", 1)[1])
        assert P.tracker_rpc("127.0.0.1", port, P.CMD_PRINT, "0", message="hi",
                             timeout=5.0) == P.ACK
        deadline = time.monotonic() + 10.0
        while "hi" not in tr.messages and time.monotonic() < deadline:
            time.sleep(0.05)
        assert "hi" in tr.messages
        assert any(e["kind"] == "relay_up" and e["relay"] == "rm" for e in tr.events)
    finally:
        proc.kill()
        proc.wait()
        tr.stop()


def test_scale_sweep_world_256():
    """rabit_tpu's acceptance shape on the port's tracker and relays: every
    arm closes its bootstrap and recovery waves at world 256; the relayed
    tracker accepts O(relays), the direct arms O(world); the loop's arms
    lose no lease."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from torch_scale_sweep import scale_sweep
    finally:
        sys.path.pop(0)
    recs = {r["arm"]: r for r in scale_sweep([256], hb_interval=0.4, hb_beats=2,
                                             deadline_sec=60.0, relays_for=lambda w: 2,
                                             emit=None)}
    assert set(recs) == {"threaded_direct", "reactor_direct", "relayed"}
    for arm, rec in recs.items():
        assert rec["bootstrap"]["wave_completed"] == 256, arm
        assert rec["recovery"]["wave_completed"] == 256, arm
        assert rec["liveness"]["rpc_p99_ms"] is not None, arm
    assert recs["relayed"]["tracker"]["accepts"] <= 8
    assert recs["threaded_direct"]["tracker"]["accepts"] >= 256
    assert recs["reactor_direct"]["tracker"]["accepts"] >= 256
    assert recs["threaded_direct"]["tracker"]["handler_threads_hwm"] >= 1
    assert recs["reactor_direct"]["tracker"]["handler_threads_hwm"] == 0
    for arm in ("reactor_direct", "relayed"):
        assert recs[arm]["lease_expired"] == 0, arm
    assert recs["relayed"]["snapshots"] == 256  # metrics through coalesced batches
