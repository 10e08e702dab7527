"""The port's model-delivery plane (rabit_tpu_torch.delivery) against
rabit_tpu's.

* **Counterparts** of the tests of tests/test_delivery.py, on the port's
  classes: the snap frame over a socket pair and in memory; publish, poll
  and a chunked digest-checked fetch against a live tracker; the dedup of
  identical bytes of two publishers (the ``have`` bit); catch-up to the
  newest version; the api's publish seam, which pins the published version
  in the store; a fetch through a relay equal to a direct one, the first a
  proxy and the next a cache hit; the relay cache's byte budget; the store's
  retention and pin; a tracker failover mid-stream
  (``tools/torch_delivery_bench.py``'s failover arm); the dedup arm; the
  writer's cadence with a swarm of 1000 subscribers (the tool's swarm arm,
  its subscribers in a spawned process, at the reference test's arguments
  and bars), the 10^4 swarm (slow), and the chunk window's default.
* **Parity with rabit_tpu**: the snap frames' bytes both ways; the CMD_SUB
  and CMD_SNAP replies byte-identical on the port's reactor, its threaded
  path and rabit_tpu's tracker, and through the port relay's batch fold;
  rabit_tpu's Publisher and Subscriber against the port's Tracker and
  Relay, and the port's against rabit_tpu's; a port journal holding
  ``snapshot_published`` replayed by both packages' ``ControlState`` to one
  delivery line; a Standby promoted from the port's journal answering the
  restored line.
"""

from __future__ import annotations

import hashlib
import json
import pickle
import socket
import time

import pytest

from rabit_tpu import delivery as jdel
from rabit_tpu import ha as jha
from rabit_tpu.relay import Relay as JaxRelay
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch import ha as pha
from rabit_tpu_torch.delivery import CHUNK_BYTES, Publisher, Subscriber, digest_of
from rabit_tpu_torch.relay import Relay
from rabit_tpu_torch.store import CheckpointStore
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker
from tools.torch_delivery_bench import run_dedup, run_failover, run_swarm


def wait_until(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


# -- wire units ----------------------------------------------------------------------

def test_snap_frame_round_trip():
    digest = digest_of(b"model-bytes")
    a, b = socket.socketpair()
    try:
        a.sendall(P.put_snap_frame(digest, 1 << 20, 4096, b"\x7f" * 512))
        a.sendall(P.put_snap_frame("", 0, 0, b""))  # the absence frame
        assert P.read_snap_frame(b) == (digest, 1 << 20, 4096, b"\x7f" * 512)
        assert P.read_snap_frame(b) == ("", 0, 0, b"")
    finally:
        a.close()
        b.close()


def test_snap_frame_from_bytes():
    digest = digest_of(b"x")
    frame = P.put_snap_frame(digest, 100, 25, b"chunk")
    assert P.snap_frame_from_bytes(frame) == (digest, 100, 25, b"chunk")


# -- publish / subscribe against a live tracker ---------------------------------------

def test_publish_poll_fetch_direct():
    tr = Tracker(1, quiet=True).start()
    try:
        blob = bytes(range(256)) * 41  # not a multiple of the chunk
        pub = Publisher(tr.host, tr.port, task_id="w0")
        reply = pub.publish(3, blob, epoch=2)
        assert reply["version"] == 3 and reply["digest"] == digest_of(blob)
        assert pub.uploads == 1
        sub = Subscriber(tr.host, tr.port, task_id="s0", chunk_bytes=1000, poll_sec=0.05)
        line = sub.poll()
        assert (line["version"], line["epoch"]) == (3, 2)
        got_line, got = sub.fetch(line)
        assert got == blob and got_line["size"] == len(blob)
        assert sub.seen_version == 3
        kinds = [e["kind"] for e in tr.events]
        assert kinds.count("snapshot_published") == 1 and kinds.count("snapshot_fetched") == 1
    finally:
        tr.stop()


def test_digest_dedup_second_publisher_skips_upload():
    tr = Tracker(1, quiet=True).start()
    try:
        blob = b"\xab" * 4096
        first = Publisher(tr.host, tr.port, job="jobA", task_id="w0")
        second = Publisher(tr.host, tr.port, job="jobB", task_id="w0")
        r1 = first.publish(1, blob)
        r2 = second.publish(1, blob)
        assert not r1.get("have") and first.uploads == 1
        assert r2.get("have") and second.uploads == 0
        assert second.dedup_skips == 1
        assert list(tr._snaps) == [digest_of(blob)]  # one copy, whatever the publishers
        assert {e["task_id"] for e in tr.events
                if e["kind"] == "snapshot_published"} == {"jobA/w0", "jobB/w0"}
    finally:
        tr.stop()


def test_subscriber_catch_up_converges_on_newest():
    tr = Tracker(1, quiet=True).start()
    try:
        pub = Publisher(tr.host, tr.port, task_id="w0")
        for v in (1, 2, 3):
            pub.publish(v, bytes([v]) * 2048)
        # asleep through v1 and v2, it wakes to the line naming v3
        sub = Subscriber(tr.host, tr.port, task_id="late", poll_sec=0.05)
        line = sub.wait_for(deadline_sec=5.0)
        assert line["version"] == 3
        assert sub.fetch(line)[1] == b"\x03" * 2048
        with pytest.raises(TimeoutError):
            sub.wait_for(99, deadline_sec=0.2)
    finally:
        tr.stop()


class _Eng:
    """The engine surface ``_publish_commit`` reads."""

    def version_number(self):
        return 2

    def obs_event(self, kind, /, **fields):
        self.event = (kind, fields)


def test_api_publish_seam_registers_and_pins(tmp_path):
    """api._publish_commit, the commit's seam: the committed blob's line
    lands on the tracker, the published version is pinned in the store and
    the engine records snapshot_published."""
    from rabit_tpu_torch import api

    tr = Tracker(1, quiet=True).start()
    store = CheckpointStore(str(tmp_path), rank=0, keep=2)
    old = (api._publisher, api._ckpt_store, api._ckpt_base)
    try:
        api._publisher = Publisher(tr.host, tr.port, task_id="pub-0")
        api._ckpt_store = store
        api._ckpt_base = 10
        blob = b"committed-model" * 100
        eng = _Eng()
        api._publish_commit(eng, blob)
        assert tr._delivery["version"] == 12  # the base plus the engine's version
        assert tr._delivery["digest"] == digest_of(blob)
        assert store._pinned == {12}
        assert eng.event == ("snapshot_published", {"version": 12, "nbytes": len(blob)})
        # a delivery outage never fails the commit
        api._publisher = Publisher("127.0.0.1", 1, task_id="pub-0", timeout=0.2, retries=0)
        api._publish_commit(eng, blob)
    finally:
        api._publisher, api._ckpt_store, api._ckpt_base = old
        tr.stop()


def test_api_init_builds_the_publisher_on_rank_0_only(monkeypatch):
    from rabit_tpu_torch import api
    from rabit_tpu_torch.config import Config

    from rabit_tpu_torch import obs

    monkeypatch.setattr(api, "create_engine", lambda cfg: _InitEngine(cfg))
    try:
        for rank, want in ((0, True), (1, False)):
            api.init([f"rank={rank}", "rabit_tracker_uri=127.0.0.1", "rabit_tracker_port=9",
                      "rabit_delivery_publish=1", "rabit_task_id=7"])
            try:
                assert (api._publisher is not None) is want
                if want:
                    assert (api._publisher.port, api._publisher.task_id) == (9, "pub-7")
            finally:
                api.finalize()
            assert api._publisher is None
        api.init(["rank=0", "rabit_tracker_uri=127.0.0.1"])  # publishing is off by default
        try:
            assert api._publisher is None
        finally:
            api.finalize()
    finally:
        obs.configure(Config([]))  # no tracker left configured for the next test
    assert Config([]).get("rabit_delivery_publish") == "0"


class _InitEngine:
    """An engine of a given rank that does nothing (``api.init``'s seam)."""

    def __init__(self, cfg):
        self.rank = cfg.get_int("rank", 0)

    def init(self):
        pass

    def get_rank(self):
        return self.rank

    def get_world_size(self):
        return 2

    def obs_event(self, kind, /, **fields):
        pass

    def shutdown(self):
        pass


# -- the relay tier --------------------------------------------------------------------

def test_fetch_through_relay_matches_direct():
    tr = Tracker(1, quiet=True).start()
    relay = Relay((tr.host, tr.port), relay_id="r0", flush_sec=0.05).start()
    try:
        blob = b"\xcd" * (64 << 10)
        Publisher(tr.host, tr.port, task_id="w0").publish(1, blob)
        direct = Subscriber(tr.host, tr.port, task_id="d0", poll_sec=0.05)
        relayed = Subscriber(relay.host, relay.port, task_id="r0", poll_sec=0.05)
        line = relayed.wait_for(1, deadline_sec=5.0)
        assert relayed.fetch(line)[1] == direct.fetch()[1] == blob
        assert relay.stats["snap_proxies"] == 1
        relayed.fetch(line)  # now cached by digest: a hit
        assert relay.stats["snap_cache_hits"] >= 1
    finally:
        relay.stop()
        tr.stop()


def test_relay_cache_budget_evicts_unreferenced(monkeypatch):
    monkeypatch.setenv("RABIT_TPU_RABIT_RELAY_CACHE_BYTES", "150000")
    tr = Tracker(1, quiet=True).start()
    relay = Relay((tr.host, tr.port), relay_id="r0", flush_sec=0.05).start()
    try:
        assert relay._cache_budget == 150000
        pub = Publisher(tr.host, tr.port, task_id="w0")
        sub = Subscriber(relay.host, relay.port, task_id="s0", poll_sec=0.05)
        blob_a, blob_b = b"\x01" * 100_000, b"\x02" * 100_000
        pub.publish(1, blob_a)
        assert sub.fetch(sub.wait_for(1, deadline_sec=5.0))[1] == blob_a
        # v2 supersedes v1: the old digest loses its hold and goes
        pub.publish(2, blob_b)
        assert sub.fetch(sub.wait_for(2, deadline_sec=5.0))[1] == blob_b
        assert wait_until(lambda: digest_of(blob_a) not in relay._digest_blobs)
        assert digest_of(blob_b) in relay._digest_blobs
        assert relay.stats["evictions"] >= 1
        reasons = {e["reason"] for e in relay.events if e.get("kind") == "blob_cache_evicted"}
        assert reasons & {"superseded", "lru"}
    finally:
        relay.stop()
        tr.stop()


def test_relay_holds_the_current_lines_digest_past_the_budget(monkeypatch):
    """The digest the current line names stays cached while LRU pressure
    from other digests evicts them, though it is the oldest; it goes once a
    newer line supersedes it."""
    monkeypatch.setenv("RABIT_TPU_RABIT_RELAY_CACHE_BYTES", "250000")
    tr = Tracker(1, quiet=True).start()
    relay = Relay((tr.host, tr.port), relay_id="r0", flush_sec=0.05).start()
    try:
        pub = Publisher(tr.host, tr.port, task_id="w0")
        sub = Subscriber(relay.host, relay.port, task_id="s0", poll_sec=0.05)
        cur = b"\x05" * 100_000
        pub.publish(1, cur)
        sub.fetch(sub.wait_for(1, deadline_sec=5.0))
        assert wait_until(lambda: relay._line_digests.get("") == digest_of(cur))
        others = [b"\x06" * 100_000, b"\x07" * 100_000]  # digests no line names
        for i, other in enumerate(others):
            Publisher(tr.host, tr.port, task_id=f"w{i + 1}")._upload(0, other)
            assert sub._fetch_once(digest_of(other)) == other
        assert list(relay._digest_blobs) == [digest_of(cur), digest_of(others[1])]
        pub.publish(2, b"\x08" * 10)
        assert wait_until(lambda: digest_of(cur) not in relay._digest_blobs)
        assert [(e["digest"], e["reason"]) for e in relay.events] == [
            (digest_of(others[0]), "lru"), (digest_of(cur), "superseded")]
    finally:
        relay.stop()
        tr.stop()


def test_relay_answers_polls_from_the_acked_line():
    """A poll before any batch ACK named a line parks and rides a batch (the
    tracker sees the subscriber); once an ACK carries the line the relay
    answers polls itself (the tracker sees no new subscriber)."""
    tr = Tracker(1, quiet=True).start()
    relay = Relay((tr.host, tr.port), relay_id="r0", flush_sec=0.05).start()
    try:
        first = Subscriber(relay.host, relay.port, task_id="early", poll_sec=0.05)
        assert first.poll()["version"] == 0
        assert tr._sub_ids == {"s#early"}
        Publisher(relay.host, relay.port, task_id="w0").publish(1, b"\x09" * 100)
        assert wait_until(lambda: relay._sub_lines.get("", {}).get("version") == 1)
        late = Subscriber(relay.host, relay.port, task_id="late", poll_sec=0.05)
        assert late.wait_for(1, deadline_sec=5.0)["version"] == 1
        assert tr._sub_ids == {"s#early"}
        assert relay._sub_lines[""]["version"] == 1
    finally:
        relay.stop()
        tr.stop()


# -- store retention -------------------------------------------------------------------

def test_store_retention_window_and_pin(tmp_path):
    store = CheckpointStore(str(tmp_path), rank=0, keep=2)
    for v in (1, 2, 3, 4):
        store.save(v, b"g%d" % v, None)
    assert store._versions == [3, 4]  # the keep=2 window
    store.pin(3)
    store.save(5, b"g5", None)
    store.save(6, b"g6", None)
    # the pinned version survives; the unpinned window is still 2
    assert store._versions == [3, 5, 6]
    assert store.load_global(3) == b"g3"
    store.pin(6)  # a newer pin releases the older, which then prunes
    store.save(7, b"g7", None)
    assert 3 not in store._versions


# -- HA: a tracker failover mid-stream -------------------------------------------------

def test_failover_restores_line_and_converges():
    rec = run_failover(n_subs=2, rounds=2, round_sec=0.1, size=8192, poll_sec=0.05)
    assert rec["line_restored"], rec
    assert rec["subscriber_errors"] == 0, rec
    assert rec["converged"] == 2, rec
    assert rec["failover_ok"], rec


# -- scale ---------------------------------------------------------------------------

def test_dedup_uplink_flat_as_tenants_grow():
    rec = run_dedup(size=32 << 10, tenant_counts=(1, 4))
    assert rec["dedup_ok"], rec
    assert all(r["snaps_held"] == 1 for r in rec["rows"])


def test_writer_cadence_with_1k_swarm():
    """The reference test's arguments and bars, with the 1000 subscribers
    driven from a spawned process of their own."""
    rec = run_swarm(n_subs=1000, n_relays=2, rounds=3, round_sec=0.4, size=64 << 10,
                    poll_sec=0.15, shards=4)
    assert rec["swarm_process"] == "spawned child"
    assert rec["polls"] > 0 and rec["n_lat"] > 0, rec
    assert rec["writer_cadence_ratio"] >= 0.70, rec
    assert rec["failures"] <= rec["polls"] * 0.05, rec


@pytest.mark.slow
def test_swarm_10k_acceptance():
    rec = run_swarm(n_subs=10_000, n_relays=2, rounds=6, round_sec=5.0, size=1 << 20,
                    poll_sec=2.0, shards=8)
    assert rec["prop_p99_ms"] < 5_000.0, rec   # p99 under one training round
    assert rec["writer_cadence_ratio"] >= 0.95, rec
    assert rec["failures"] <= rec["polls"] * 0.02, rec
    assert rec["fetch_errors"] == 0, rec


def test_chunking_covers_default_window():
    assert CHUNK_BYTES == jdel.CHUNK_BYTES > 0
    assert Subscriber("127.0.0.1", 1, chunk_bytes=0).chunk_bytes == 1


# -- parity with rabit_tpu -------------------------------------------------------------

@pytest.mark.parametrize("frame", [("ab" * 32, 1 << 20, 4096, b"\x7f" * 512),
                                   ("", 0, 0, b""), ("d" * 64, 5, 5, b"")],
                         ids=["chunk", "absence", "tail"])
def test_snap_frame_bytes_both_ways(frame):
    mine, theirs = P.put_snap_frame(*frame), JP.put_snap_frame(*frame)
    assert mine == theirs
    assert P.snap_frame_from_bytes(theirs) == JP.snap_frame_from_bytes(mine) == frame
    for put, read in ((P.put_snap_frame, JP.read_snap_frame),
                      (JP.put_snap_frame, P.read_snap_frame)):
        a, b = socket.socketpair()
        try:
            a.sendall(put(*frame))
            assert read(b) == frame
        finally:
            a.close()
            b.close()
    assert P.MAGIC_SNAP == JP.MAGIC_SNAP


@pytest.mark.parametrize("bad", [b"\x00" * 4, P.put_u32(P.MAGIC_SNAP) + P.put_u32(64) + b"x",
                                 P.put_snap_frame("ab", 3, 0, b"abc") + b"!"],
                         ids=["short", "torn-digest", "trailing-byte"])
def test_snap_frame_refusals_agree(bad):
    for mod in (P, JP):
        with pytest.raises(ValueError):
            mod.snap_frame_from_bytes(bad)


def rpc_bytes(addr, cmd, task_id, message="", blob=b"", blob_version=0) -> bytes:
    """One raw RPC: the hello out, every reply byte back until EOF."""
    with socket.create_connection(addr, timeout=5.0) as sock:
        sock.settimeout(5.0)
        P.send_hello(sock, cmd, task_id, message=message, blob=blob, blob_version=blob_version)
        out = b""
        while True:
            try:
                chunk = sock.recv(65536)
            except socket.timeout:
                break
            if not chunk:
                break
            out += chunk
    return out


def delivery_rpcs(addr) -> list[bytes]:
    """A publish, its upload, polls, fetches and malformed requests."""
    blob = bytes(range(256)) * 12
    d = digest_of(blob)
    line = {"version": 4, "epoch": 1, "digest": d, "size": len(blob)}
    return [
        rpc_bytes(addr, P.CMD_SUB, "s0", "{}"),
        rpc_bytes(addr, P.CMD_SNAP, "s0", json.dumps({"digest": d})),  # not held yet
        rpc_bytes(addr, P.CMD_SUB, "w0", json.dumps({"publish": line})),
        rpc_bytes(addr, P.CMD_BLOB, "w0", blob=blob, blob_version=4),
        rpc_bytes(addr, P.CMD_SUB, "w1", json.dumps({"publish": line})),  # have: true
        rpc_bytes(addr, P.CMD_SUB, "w0", json.dumps({"publish": {**line, "version": 3}})),
        rpc_bytes(addr, P.CMD_SUB, "s0", ""),
        rpc_bytes(addr, P.CMD_SUB, "s1", "not json"),
        rpc_bytes(addr, P.CMD_SNAP, "s0", json.dumps({"digest": d, "off": 1000, "len": 700})),
        rpc_bytes(addr, P.CMD_SNAP, "s0", json.dumps({"digest": d, "off": 3000})),
        rpc_bytes(addr, P.CMD_SNAP, "s0", json.dumps({"digest": d})),
        rpc_bytes(addr, P.CMD_SNAP, "s0", json.dumps({"digest": "0" * 64})),
        rpc_bytes(addr, P.CMD_SNAP, "s0", json.dumps({"digest": d, "off": "x"})),  # closed
        rpc_bytes(addr, P.CMD_SUB, "w2", json.dumps({"publish": {"version": "x"}})),  # closed
    ]


def test_reply_bytes_identical_on_three_trackers():
    trackers = {"reactor": Tracker(1, quiet=True).start(),
                "threaded": Tracker(1, quiet=True, reactor=False).start(),
                "jax": JaxTracker(1, quiet=True).start()}
    try:
        replies = {name: delivery_rpcs((tr.host, tr.port)) for name, tr in trackers.items()}
        assert replies["reactor"] == replies["threaded"] == replies["jax"]
        assert replies["jax"][-2:] == [b"", b""]
        for name in ("reactor", "threaded"):
            tr = trackers[name]
            assert tr._sub_ids == {"s0", "s1"}
            # the second publisher's line of the same version registers too
            assert [e["version"] for e in tr.events
                    if e["kind"] == "snapshot_published"] == [4, 4]
            assert sum(e["kind"] == "snapshot_fetched" for e in tr.events) == 1
            assert tr.build_scrape()["jobs"][""]["delivery"] == \
                trackers["jax"].build_scrape()["jobs"][""]["delivery"]
    finally:
        for tr in trackers.values():
            tr.stop()


def test_relay_fold_replies_are_the_direct_bytes():
    """A publish through the port relay rides a batch and the tracker's fold;
    its reply, and the polls and fetches answered at the relay, are the bytes
    a direct RPC gets from a tracker in the same state."""
    direct, behind = Tracker(1, quiet=True).start(), Tracker(1, quiet=True).start()
    relay = Relay((behind.host, behind.port), relay_id="r0", flush_sec=0.05).start()
    try:
        blob = b"\x11" * 5000
        line = {"version": 2, "epoch": 0, "digest": digest_of(blob), "size": len(blob)}
        pub = json.dumps({"publish": line})
        d_addr, r_addr = (direct.host, direct.port), (relay.host, relay.port)
        assert rpc_bytes(r_addr, P.CMD_SUB, "w0", pub) == rpc_bytes(d_addr, P.CMD_SUB, "w0",
                                                                     pub)
        for addr in (d_addr, r_addr):
            assert rpc_bytes(addr, P.CMD_BLOB, "w0", blob=blob, blob_version=2) == \
                P.put_u32(P.ACK)
        assert wait_until(lambda: relay._sub_lines.get("", {}).get("version") == 2)
        for msg in ("{}", json.dumps({"digest": line["digest"], "off": 10, "len": 20})):
            cmd = P.CMD_SNAP if "digest" in msg else P.CMD_SUB
            assert rpc_bytes(r_addr, cmd, "s0", msg) == rpc_bytes(d_addr, cmd, "s0", msg)
        assert rpc_bytes(r_addr, P.CMD_SNAP, "s0", json.dumps({"digest": "f" * 64})) == \
            P.put_snap_frame("", 0, 0, b"")
        assert behind.serve_stats["batch_msgs"] >= 1 and "s#w0" in {
            e.get("task_id") for e in behind.events if e["kind"] == "snapshot_published"}
    finally:
        relay.stop()
        direct.stop()
        behind.stop()


@pytest.mark.parametrize("side", ["jax-clients-port-serving", "port-clients-jax-serving"])
def test_publish_and_fetch_across_the_packages(side):
    mine = side.startswith("port")
    tr = (JaxTracker if mine else Tracker)(1, quiet=True).start()
    relay = (JaxRelay if mine else Relay)((tr.host, tr.port), relay_id="r0",
                                          flush_sec=0.05).start()
    pub_cls, sub_cls = (Publisher, Subscriber) if mine else (jdel.Publisher, jdel.Subscriber)
    try:
        blobs = {v: bytes([v]) * (3000 + 17 * v) for v in (1, 2, 3)}
        pub = pub_cls(relay.host, relay.port, task_id="w0")
        sub = sub_cls(relay.host, relay.port, task_id="s0", chunk_bytes=1024, poll_sec=0.05)
        direct = sub_cls(tr.host, tr.port, task_id="d0", poll_sec=0.05)
        for v, blob in blobs.items():
            reply = pub.publish(v, blob, epoch=1)
            assert reply["version"] == v and not reply["have"]
            line, got = sub.fetch(sub.wait_for(v, deadline_sec=5.0))
            assert got == blob == direct.fetch()[1]
            assert line["digest"] == hashlib.sha256(blob).hexdigest()
        again = pub_cls(tr.host, tr.port, task_id="w1").publish(4, blobs[3])
        assert again["have"]
        assert len(tr._snaps) == 3 and tr._delivery["version"] == 4
        # the uploads went through the relay, which kept their bytes by digest:
        # every fetch was served there
        assert relay.stats["snap_proxies"] == 0 and relay.stats["snap_cache_hits"] >= 3
    finally:
        relay.stop()
        tr.stop()


def test_journal_replays_to_one_line_in_both_packages(tmp_path):
    path = str(tmp_path / "journal.bin")
    tr = Tracker(1, quiet=True, journal=path).start()
    try:
        pub = Publisher(tr.host, tr.port, task_id="w0")
        for v in (1, 2, 3):
            pub.publish(v, bytes([v]) * 1000, epoch=v % 2)
        pub.publish(2, b"\x02" * 1000)  # older: not registered, not journaled
        tr.journal.flush(5.0)
        want = dict(tr._delivery)
    finally:
        tr.stop()
    states = []
    for read, replay in ((pha.read_journal, pha.replay), (jha.read_journal, jha.replay)):
        records, _ok = read(path)
        assert sum(k == "snapshot_published" for k, _ in records) == 3
        states.append(replay(records))
    assert states[0].delivery == states[1].delivery == want
    assert states[0].snapshot_bytes() == states[1].snapshot_bytes()


def test_promoted_standby_answers_the_restored_line(tmp_path):
    """A Standby tailing the port's journal file takes over a killed primary
    with the version line; a digest nobody re-pushed yet is an empty frame,
    the publisher's next commit re-feeds the bytes."""
    path = str(tmp_path / "journal.bin")
    tr = Tracker(1, quiet=True, journal=path, ha_tick_sec=0.05).start()
    standby = pha.Standby(journal_path=path, takeover_sec=0.6, poll_sec=0.05).start()
    try:
        blob = b"\x21" * 3000
        line = Publisher(tr.host, tr.port, task_id="w0").publish(1, blob)
        tr.journal.flush(5.0)
        tr.kill()
        assert standby.wait_promoted(10.0)
        addr = (standby.host, standby.port)
        want = {k: line[k] for k in ("version", "epoch", "digest", "size")}
        assert rpc_bytes(addr, P.CMD_SUB, "s0", "{}") == \
            P.put_u32(P.ACK) + P.put_str(json.dumps(want))
        ask = json.dumps({"digest": digest_of(blob)})
        assert rpc_bytes(addr, P.CMD_SNAP, "s0", ask) == P.put_snap_frame("", 0, 0, b"")
        Publisher(standby.host, standby.port, task_id="w0").publish(2, blob)
        assert Subscriber(*addr, task_id="s0").fetch()[1] == blob
    finally:
        standby.stop()
        tr.stop()


def test_gbdt_job_publishes_every_commit_through_relays(tmp_path):
    """chip_smoke.py's delivery run (a) on the CPU: two workers of
    tests/workers/torch_gbdt_native_worker.py (mode=gbdt, small data) behind
    two relays, rank 0 publishing (rabit_delivery_publish=1, a checkpoint
    dir) and killed in the commit window of version 2; two subscribers
    behind the relays follow the line, the run lingering until they hold
    version 3.  Every fetched blob hashes to its line, the last is rank 0's
    committed blob, and it decodes to the job's forest.npy."""
    import sys
    import threading
    from pathlib import Path

    import numpy as np

    from rabit_tpu_torch import api
    from rabit_tpu_torch.engine import native
    from rabit_tpu_torch.tracker.launcher import LocalCluster

    native.build_lib()
    worker = str(Path(__file__).parent / "workers" / "torch_gbdt_native_worker.py")
    ckpt, out = tmp_path / "ckpt", tmp_path / "forest"
    cmd = [sys.executable, worker, "rabit_engine=mock", "mode=gbdt", "ntrees=3", f"out={out}",
           "rabit_delivery_publish=1", f"rabit_checkpoint_dir={ckpt}", "mock=0,1,-3,0"]
    cluster = LocalCluster(2, max_restarts=2, quiet=True, relays=2,
                           extra_env={"OMP_NUM_THREADS": "1"})
    got, stop, done = [], threading.Event(), [threading.Event(), threading.Event()]

    def follow(i):
        while not cluster.relays and not stop.wait(0.02):
            pass
        relay = cluster.relays[i]
        sub = Subscriber(relay.host, relay.port, task_id=f"sub{i}", poll_sec=0.05)
        while not stop.is_set() and sub.seen_version < 3:
            line = sub.poll()
            if line["version"] > sub.seen_version:
                got.append((i,) + sub.fetch(line, deadline_sec=30.0))
            else:
                stop.wait(0.05)
        done[i].set()

    threads = [threading.Thread(target=follow, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    try:
        assert cluster.run(cmd, timeout=240.0, linger=lambda: all(d.is_set() for d in done)) == 0
    finally:
        stop.set()
    assert all(d.is_set() for d in done) and cluster.restarts == {"0": 1, "1": 0}
    assert all(digest_of(blob) == line["digest"] for _i, line, blob in got)
    last = {i: blob for i, line, blob in got if line["version"] == 3}
    committed = CheckpointStore(str(ckpt), 0).load_global(3)
    assert last[0] == last[1] == committed
    forest = pickle.loads(api._unwrap(committed)[1])
    packed = np.concatenate([np.asarray(a, np.float32).reshape(-1) for a in forest])
    assert packed.tobytes() == np.load(out.with_suffix(".npy")).tobytes()
    kinds = [e["kind"] for e in cluster.events]
    assert "snapshot_published" in kinds and "snapshot_fetched" in kinds


def test_committed_blob_decodes_to_the_forest(tmp_path):
    """What a subscriber fetches is the api's committed blob: with a store,
    the wrapped pickle, which unwraps to the model."""
    from rabit_tpu_torch import api

    model = (b"trees", list(range(5)))
    wrapped = api._wrap(7, pickle.dumps(model, protocol=pickle.HIGHEST_PROTOCOL))
    tr = Tracker(1, quiet=True).start()
    try:
        Publisher(tr.host, tr.port, task_id="w0").publish(8, wrapped)
        _line, blob = Subscriber(tr.host, tr.port, task_id="s0").fetch()
        base, inner = api._unwrap(blob)
        assert (base, pickle.loads(inner)) == (7, model)
    finally:
        tr.stop()
