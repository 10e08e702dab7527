"""The port's HA control plane against rabit_tpu's: journal frames, the
replayable control state, the journal and the warm standby on the same
inputs and across the packages, then tracker failover end to end on the
CPU.

* **Pure.** Journal frames are byte-identical and decode the same in both
  packages, torn and corrupt buffers included; hypothesis-drawn record
  sequences give byte-equal ``ControlState.snapshot_bytes()`` in both
  packages (the replay-determinism gate), and the port's journal file
  replays to its live mirror; snapshots round-trip, torn tails truncate,
  compaction keeps the bytes; a wave settles the quorum ledger;
  ``MembershipManager.restore`` continues the epoch line.
* **Across packages.** A journal file written by either package's tracker
  replays in the other's ``read_journal`` to the same bytes; either
  package's ``Standby`` tails the other's primary over ``CMD_JOURNAL`` to
  equal state bytes; a tracker with no journal refuses a standby.
* **End to end.** The counterparts of tests/test_ha.py's: the rpc rotates to
  the standby, the file tail and takeover, the takeover keeps the control
  state (frozen quorum records answered the same), a promoted journal is
  not applied twice, failover mid-wave and mid-run, the standby's death,
  ``LocalCluster(standby=True)`` with processes surviving
  ``kill_tracker_after``, and a quorum job failing over with records
  frozen.
"""

from __future__ import annotations

import json
import os
import random
import re
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rabit_tpu import ha as jha
from rabit_tpu.elastic.membership import MembershipManager as JaxMembership
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch import ha as pha
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.elastic.membership import MembershipManager
from rabit_tpu_torch.elastic.rebalance import shard_slice
from rabit_tpu_torch.obs import ship
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.launcher import LocalCluster
from rabit_tpu_torch.tracker.tracker import Tracker

sys.path.insert(0, str(Path(__file__).parent / "workers"))
import torch_diag_job  # noqa: E402

sys.path.pop(0)

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "workers" / "torch_elastic_worker.py")


def _wait(pred, timeout: float = 5.0) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


# -- journal frames ------------------------------------------------------------

FIELDS = [("wave", {"epoch": 3, "world": 2, "rank_map": {"0": 0, "1": 1}, "started": ["0"],
                    "promoted": []}),
          ("tick", {}), ("lease", {"task_id": "7", "interval": 0.25, "rank": -1}),
          ("quorum_freeze", {"epoch": 0, "version": 2, "world": 3,
                             "record": {"decided": True, "excluded": [2], "corrections": []}}),
          ("snapshot", {"state": {"world": 4, "spares": ["s0"], "q_streak": {"1": 2}}})]


@pytest.mark.parametrize("codec", ["", "identity", "zlib", "lz4"])
@pytest.mark.parametrize("kind,fields", FIELDS)
def test_journal_frames_match(codec, kind, fields):
    try:
        theirs = JP.put_journal_frame(kind, fields, codec=codec)
    except (ValueError, KeyError) as exc:
        with pytest.raises(type(exc)):
            P.put_journal_frame(kind, fields, codec=codec)
        return
    frame = P.put_journal_frame(kind, fields, codec=codec)
    assert frame == theirs
    a, b = socket.socketpair()
    try:
        a.sendall(frame * 2)
        assert P.read_journal_frame(b) == (kind, fields)
        assert JP.read_journal_frame(b) == (kind, fields)
    finally:
        a.close()
        b.close()
    bad = bytearray(frame)
    bad[-1] ^= 0xFF  # a flipped payload bit: the crc catches it
    a, b = socket.socketpair()
    try:
        a.sendall(bytes(bad))
        with pytest.raises(ValueError):
            P.read_journal_frame(b)
    finally:
        a.close()
        b.close()


@settings(max_examples=80, deadline=None)
@given(data=st.data())
def test_journal_buffers_parse_the_same(data):
    """Torn, corrupt and trailing-garbage buffers parse to the same
    records, consumed bytes and error in both packages."""
    n = data.draw(st.integers(1, 5))
    frames = b"".join(P.put_journal_frame(*FIELDS[data.draw(st.integers(0, len(FIELDS) - 1))],
                                          codec=data.draw(st.sampled_from(["", "zlib"])))
                      for _ in range(n))
    buf = bytearray(frames)
    cut = data.draw(st.integers(0, len(buf)))
    buf = buf[:cut]
    for _ in range(data.draw(st.integers(0, 2))):
        if buf:
            i = data.draw(st.integers(0, len(buf) - 1))
            buf[i] ^= data.draw(st.integers(1, 255))
    buf += data.draw(st.binary(max_size=12))
    assert (P.journal_frames_from_buffer(bytes(buf))
            == JP.journal_frames_from_buffer(bytes(buf)))


def test_tracker_rpc_goes_on_at_once_after_a_refused_dial():
    """A refused dial names no live tracker: the first pass over the
    failover list reaches the standby with no backoff (``backoff`` here
    would sleep 0.5-1 s), and a single address still backs off."""
    tracker = Tracker(1, quiet=True).start()
    dead = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    dead.bind(("127.0.0.1", 0))  # bound, not listening: refused
    dead_addr = dead.getsockname()
    try:
        t0 = time.monotonic()
        assert P.tracker_rpc(*dead_addr, P.CMD_PRINT, "t", message="hi", timeout=0.5,
                             retries=2, backoff=1.0,
                             addrs=[dead_addr, (tracker.host, tracker.port)]) == P.ACK
        assert time.monotonic() - t0 < 0.4
        t0 = time.monotonic()
        with pytest.raises(P.TrackerUnreachable):
            P.tracker_rpc(*dead_addr, P.CMD_PRINT, "t", message="x", timeout=0.5, retries=1,
                          backoff=0.4)
        assert time.monotonic() - t0 >= 0.2
    finally:
        dead.close()
        tracker.stop()


def test_journal_streamed_waits_for_every_stream():
    """``Journal.streamed`` returns once every subscriber's stream has sent
    what was enqueued before it (each sets its marker), False while one
    has not, and at once with no subscriber."""
    journal = pha.Journal(None)
    try:
        assert journal.streamed(1.0)
        sub = journal.subscribe()
        journal.append("tick")
        assert not journal.streamed(0.2)  # nobody sends this stream's frames
        stop = threading.Event()
        sent = []

        def stream():
            while not stop.is_set():
                try:
                    item = sub.get(timeout=0.05)
                except Exception:  # queue.Empty
                    continue
                if isinstance(item, threading.Event):
                    item.set()
                else:
                    sent.append(item)

        th = threading.Thread(target=stream, daemon=True)
        th.start()
        journal.append("tick")
        assert journal.streamed(2.0)
        # the snapshot frame and both ticks left before the marker was set
        assert len(sent) == 3
        stop.set()
        th.join(2.0)
    finally:
        journal.close()

def test_tracker_rpc_rotates_to_standby_address():
    tracker = Tracker(1, quiet=True).start()
    dead = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    dead.bind(("127.0.0.1", 0))  # bound, not listening: a standby before its takeover
    dead_addr = dead.getsockname()
    try:
        ack = P.tracker_rpc(dead_addr[0], dead_addr[1], P.CMD_PRINT, "t", message="hi",
                            timeout=0.5, retries=2, backoff=0.01,
                            addrs=[dead_addr, (tracker.host, tracker.port)])
        assert ack == P.ACK and "hi" in tracker.messages
        assert ship.renew_lease(*dead_addr, "t", 5.0, rank=0,
                                addrs=[dead_addr, (tracker.host, tracker.port)])
        assert tracker.live_tasks() == ["t"]
        snap = ship.build_snapshot(_empty_registry(), 0, "t")
        assert ship.ship_snapshot(snap, *dead_addr, "t", retries=1,
                                  addrs=[(tracker.host, tracker.port)])
        assert ship.clock_ping(*dead_addr, "t", samples=1, addrs=[]) == 0
        with pytest.raises(P.TrackerUnreachable):
            P.tracker_rpc(*dead_addr, P.CMD_PRINT, "t", message="x", timeout=0.5, retries=0,
                          addrs=[(tracker.host, tracker.port)])
    finally:
        dead.close()
        tracker.stop()


def _empty_registry():
    from rabit_tpu_torch.obs.metrics import MetricsRegistry

    return MetricsRegistry()


def test_obs_configure_reads_the_failover_list():
    from rabit_tpu_torch import obs

    cfg = Config(["rabit_tracker_uri=127.0.0.1", "rabit_tracker_port=1",
                  "rabit_tracker_addrs=127.0.0.1:1, 127.0.0.1:2,bad"])
    obs.configure(cfg)
    try:
        assert obs._STATE.tracker_addrs == [("127.0.0.1", 1), ("127.0.0.1", 2)]
    finally:
        obs.configure(Config([]))
    assert obs._STATE.tracker_addrs == []
    keys = ("rabit_tracker_addrs", "rabit_ha_journal", "rabit_ha_snapshot_every",
            "rabit_ha_takeover_sec", "rabit_ha_tick_sec")
    from rabit_tpu.config import Config as JaxConfig

    assert {k: Config([]).get(k) for k in keys} == {k: JaxConfig([]).get(k) for k in keys}


# -- the control state ---------------------------------------------------------

def _records(rng: random.Random, n: int) -> list:
    """A valid mutation sequence over every record kind a tracker journals
    (and rabit_tpu's snapshot_published)."""
    world = rng.choice([2, 3, 4])
    recs = [("init", {"base_world": world})]
    epoch = -1
    for _ in range(n):
        roll = rng.random()
        if roll < 0.12:
            epoch += 1
            w = rng.randint(max(1, world - 1), world + 1)
            recs.append(("wave", {"epoch": epoch, "world": w,
                                  "rank_map": {str(i): i for i in range(w)},
                                  "started": [str(i) for i in range(w) if rng.random() < 0.7],
                                  "promoted": [f"s{rng.randint(0, 2)}"] if rng.random() < 0.3
                                  else []}))
        elif roll < 0.3:
            recs.append(("lease", {"task_id": str(rng.randint(0, world)),
                                   "interval": rng.choice([0.1, 0.25, 0.5]),
                                   "rank": rng.randint(-1, world - 1)}))
        elif roll < 0.4:
            recs.append(("lease_drop", {"task_id": str(rng.randint(0, world))}))
        elif roll < 0.5:
            recs.append(("spare_park", {"task_id": f"s{rng.randint(0, 2)}",
                                        "blob_version": rng.randint(0, 5)}))
        elif roll < 0.56:
            recs.append(("spare_drop", {"task_ids": [f"s{rng.randint(0, 2)}"]}))
        elif roll < 0.64:
            recs.append(("shutdown", {"task_id": str(rng.randint(0, world))}))
        elif roll < 0.7:
            recs.append(("link_flag", {"src": str(rng.randint(0, world)),
                                       "dst": str(rng.randint(0, world))}))
        elif roll < 0.76:
            order = list(range(world))
            rng.shuffle(order)
            recs.append(("sched", {"epoch": max(epoch, 0), "algo": rng.choice(["tree", "swing"]),
                                   "ring": order}))
        elif roll < 0.82:
            v = rng.randint(1, 6)
            excl = [r for r in range(world) if rng.random() < 0.3]
            corr = [[rng.randint(1, 6), rng.randint(0, world - 1)]] if rng.random() < 0.3 else []
            recs.append(("quorum_freeze", {
                "epoch": max(epoch, 0), "version": v, "world": world,
                "record": {"decided": True, "epoch": max(epoch, 0), "version": v,
                           "k": world - len(excl), "excluded": excl, "corrections": corr}}))
        elif roll < 0.86:
            recs.append(("quorum_late", {"src_version": rng.randint(1, 6),
                                         "rank": rng.randint(0, world - 1)}))
        elif roll < 0.9:
            recs.append(("blob", {"version": rng.randint(0, 8)}))
        elif roll < 0.93:
            recs.append(("snapshot_published", {"version": rng.randint(1, 9),
                                                "epoch": max(epoch, 0), "digest": "ab" * 4,
                                                "size": rng.randint(1, 99)}))
        elif roll < 0.96:
            recs.append(("wave", {"epoch": "bad"}))  # malformed: dropped by both
        else:
            recs.append(("tick", {}))
    return recs


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 31), n=st.integers(0, 80))
def test_replay_determinism_gate(seed, n):
    recs = _records(random.Random(seed), n)
    mine, theirs = pha.replay(recs), jha.replay(recs)
    assert mine.snapshot_bytes() == theirs.snapshot_bytes()
    assert mine.applied == theirs.applied
    assert mine.quorum_seed() == theirs.quorum_seed()
    again = pha.ControlState.from_snapshot(json.loads(mine.snapshot_bytes()))
    assert again.snapshot_bytes() == mine.snapshot_bytes()


@pytest.mark.parametrize("seed", [11, 22])
def test_journal_file_replays_to_its_mirror(seed, tmp_path):
    path = str(tmp_path / "journal.bin")
    j = pha.Journal(path, snapshot_every=10_000)
    for kind, fields in _records(random.Random(seed), 60):
        j.append(kind, **fields)
    assert j.flush(10.0)
    mirror = j.state_bytes()
    j.close()
    for read, replay in ((pha.read_journal, pha.replay), (jha.read_journal, jha.replay)):
        records, torn = read(path)
        assert not torn and replay(records).snapshot_bytes() == mirror


def test_torn_tail_truncation_and_compaction(tmp_path):
    path = str(tmp_path / "journal.bin")
    j = pha.Journal(path, snapshot_every=10_000)
    j.append("init", base_world=2)
    j.append("wave", epoch=0, world=2, rank_map={"0": 0, "1": 1}, started=["0", "1"],
             promoted=[])
    assert j.flush(10.0)
    prefix = j.state_bytes()
    j.close()
    with open(path, "ab") as f:
        f.write(P.put_journal_frame("shutdown", {"task_id": "0"})[:9])
    for read, replay in ((pha.read_journal, pha.replay), (jha.read_journal, jha.replay)):
        records, torn = read(path)
        assert torn and replay(records).snapshot_bytes() == prefix
    events = []
    j2 = pha.Journal(path, snapshot_every=10_000, on_event=events.append)
    assert j2.state_bytes() == prefix
    assert [e["kind"] for e in events] == ["journal_gap", "journal_snapshot"]
    j2.close()
    records, torn = pha.read_journal(path)
    assert not torn and records[0][0] == "snapshot"
    assert pha.replay(records).snapshot_bytes() == prefix
    # compaction every 8 records: the file stays a snapshot head and a window
    events = []
    path2 = str(tmp_path / "compact.bin")
    j3 = pha.Journal(path2, snapshot_every=8, on_event=events.append)
    for kind, fields in _records(random.Random(5), 30):
        j3.append(kind, **fields)
    assert j3.flush(10.0)
    assert j3.n_snapshots >= 3
    records, torn = pha.read_journal(path2)
    assert not torn and records[0][0] == "snapshot" and len(records) <= 9
    assert jha.replay(records).snapshot_bytes() == j3.state_bytes()
    assert sum(e["kind"] == "journal_snapshot" for e in events) == j3.n_snapshots
    j3.close()


def test_wave_settles_the_quorum_ledger():
    for cs in (pha.ControlState(), jha.ControlState()):
        cs.apply("init", {"base_world": 2})
        cs.apply("quorum_freeze", {"epoch": 0, "version": 2, "world": 2,
                                   "record": {"decided": True, "epoch": 0, "version": 2, "k": 1,
                                              "excluded": [1], "corrections": []}})
        assert cs.q_outstanding == {"2:1": 2}
        cs.apply("wave", {"epoch": 1, "world": 2, "rank_map": {"0": 0, "1": 1}, "started": [],
                          "promoted": []})
        assert cs.q_outstanding == {} and cs.q_records == {}


def test_membership_restore_continues_the_epoch_line():
    for mm in (MembershipManager(3), JaxMembership(3)):
        mm.restore(4, 2, {"0": 0, "1": 1}, history=[(3, 3), (4, 2)])
        assert mm.epoch == 4 and mm.world == 2
        assert [(h.epoch, h.world_size) for h in mm.history] == [(3, 3), (4, 2)]
        assert dict(mm.history[-1].rank_map) == {"0": 0, "1": 1}
        we, _delta = mm.commit({"0": 0, "1": 1, "s0": 2}, 3)
        assert we.epoch == 5


# -- across packages -----------------------------------------------------------

PACKAGES = {"port": (Tracker, pha, P), "jax": (JaxTracker, jha, JP)}


def _drive(tracker, rpc) -> None:
    """Mutations through the wire: a wave of two, two leases, a frozen
    quorum record, a print-flagged link, a shutdown."""
    def boot(tid):
        rpc(tracker.host, tracker.port, JP.CMD_START, tid, listen_port=41000 + int(tid),
            timeout=5.0, reply_timeout=10.0)

    threads = [threading.Thread(target=boot, args=(t,), daemon=True) for t in ("0", "1")]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10.0)
    for tid in ("0", "1"):
        rpc(tracker.host, tracker.port, JP.CMD_HEARTBEAT, tid, prev_rank=int(tid),
            message="5.0", timeout=5.0)
    rpc(tracker.host, tracker.port, JP.CMD_QUORUM, "0", timeout=5.0,
        message=json.dumps({"epoch": 0, "v": 1, "have": [0], "held": []}))
    tracker.flag_link(0, 1)
    rpc(tracker.host, tracker.port, JP.CMD_SHUTDOWN, "1", timeout=5.0)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_file_across_packages(writer, tmp_path):
    path = str(tmp_path / "job.journal")
    tracker_cls, _ha, _ = PACKAGES[writer]
    tracker = tracker_cls(2, quiet=True, quorum="0.5", journal=path).start()
    try:
        _drive(tracker, JP.tracker_rpc)
        assert _wait(lambda: "1" in tracker._shutdown_tasks)
        assert tracker.journal.flush(5.0)
        mirror = tracker.journal.state_bytes()
    finally:
        tracker.kill()
    states = [ha.replay(ha.read_journal(path)[0]).snapshot_bytes() for ha in (pha, jha)]
    assert states[0] == states[1] == mirror
    snap = json.loads(mirror)
    assert snap["epochs"] == [[0, 2]] and snap["shutdown"] == ["1"]
    assert list(snap["leases"]) == ["0"] and len(snap["q_records"]) == 1
    assert snap["link_flags"] == [["0", "1"]]


@pytest.mark.parametrize("primary,standby", [("jax", "port"), ("port", "jax")])
def test_standby_tails_the_other_package(primary, standby):
    tracker_cls, pkg_ha, _ = PACKAGES[primary]
    tracker = tracker_cls(2, quiet=True, quorum="0.5", journal=pkg_ha.Journal(None)).start()
    sb = PACKAGES[standby][1].Standby(primary=(tracker.host, tracker.port), takeover_sec=30.0,
                                      poll_sec=0.05).start()
    try:
        assert sb.wait_synced(5.0)
        _drive(tracker, JP.tracker_rpc)
        assert tracker.journal.flush(5.0)
        want = tracker.journal.state_bytes()
        assert _wait(lambda: sb.state.snapshot_bytes() == tracker.journal.state_bytes())
        assert json.loads(want)["epochs"] == [[0, 2]]
        assert any(e["kind"] == "standby_synced" for e in sb.events)
        assert not sb.promoted.is_set()
    finally:
        sb.stop()
        tracker.stop()


def test_journalless_tracker_refuses_a_standby():
    tracker = Tracker(1, quiet=True).start()
    try:
        with socket.create_connection((tracker.host, tracker.port), timeout=2.0) as sock:
            P.send_hello(sock, P.CMD_JOURNAL, "sb")
            sock.settimeout(2.0)
            with pytest.raises((ConnectionError, socket.timeout)):
                P.get_u32(sock)
    finally:
        tracker.stop()
    with pytest.raises(NotImplementedError, match="10g"):
        pha.Standby(primary=("127.0.0.1", 1), service=True)


# -- standby takeover ----------------------------------------------------------

def test_standby_file_tail_and_takeover(tmp_path):
    path = str(tmp_path / "journal.bin")
    tracker = Tracker(2, quiet=True, journal=path, ha_tick_sec=0.05).start()
    sb = pha.Standby(journal_path=path, takeover_sec=0.6, poll_sec=0.05,
                     standby_id="filetail").start()
    try:
        assert sb.wait_synced(5.0)
        tracker._renew_lease("0", 0, "0.25")
        tracker.kill()
        assert sb.wait_promoted(8.0)
        promoted = sb.tracker
        assert promoted.port == sb.port and "0" in promoted._leases
        kinds = [e["kind"] for e in promoted.events]
        assert "tracker_failover" in kinds and "standby_synced" in kinds
    finally:
        sb.stop()
        tracker.stop()


def test_takeover_keeps_the_control_state_and_records(tmp_path):
    tracker = Tracker(2, quiet=True, quorum="0.5", journal=pha.Journal(None)).start()
    sb = pha.Standby(primary=(tracker.host, tracker.port), takeover_sec=0.5, poll_sec=0.05,
                     tracker_kwargs={"quorum": "0.5"}).start()
    report = json.dumps({"epoch": 0, "v": 1, "have": [0], "held": []})
    results = {}

    def boot(tid):
        results[tid] = JP.tracker_rpc(tracker.host, tracker.port, JP.CMD_START, tid,
                                      listen_port=42000 + int(tid), timeout=5.0,
                                      reply_timeout=10.0)

    threads = [threading.Thread(target=boot, args=(t,), daemon=True) for t in ("0", "1")]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(10.0)
        rec = P.tracker_rpc(tracker.host, tracker.port, P.CMD_QUORUM, "0", message=report,
                            timeout=5.0)
        assert rec["decided"] and rec["excluded"] == [1]
        assert sb.wait_synced(5.0) and tracker.journal.flush(5.0)
        assert _wait(lambda: sb.state.snapshot_bytes() == tracker.journal.state_bytes())
        tracker.kill()
        assert sb.wait_promoted(8.0)
        promoted = sb.tracker
        assert promoted.elastic.epoch == 0
        assert promoted._ranks == {"0": results["0"].rank, "1": results["1"].rank}
        assert promoted._n_starts == {"0": 1, "1": 1}
        assert P.tracker_rpc(promoted.host, promoted.port, P.CMD_QUORUM, "1", message=report,
                             timeout=5.0) == rec
        assert promoted.build_scrape({"registry": False})["jobs"][""]["quorum_outstanding"] == 1
    finally:
        sb.stop()
        tracker.stop()


def test_promoted_journal_not_applied_twice(tmp_path):
    path = str(tmp_path / "job.journal")
    tracker = Tracker(2, quiet=True, journal=path, ha_tick_sec=0.05).start()
    sb = pha.Standby(journal_path=path, takeover_sec=0.6, poll_sec=0.05).start()

    def boot(tid):
        JP.tracker_rpc(tracker.host, tracker.port, JP.CMD_START, tid,
                       listen_port=43000 + int(tid), timeout=5.0, reply_timeout=10.0)

    threads = [threading.Thread(target=boot, args=(t,), daemon=True) for t in ("0", "1")]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(10.0)
        assert tracker.journal.flush(5.0) and sb.wait_synced(5.0)
        tracker.kill()
        assert sb.wait_promoted(8.0)
        snap = sb.tracker.journal.state_snapshot()
        assert snap["n_starts"] == {"0": 1, "1": 1} and snap["epochs"] == [[0, 2]]
        assert snap == sb.state.snapshot()
    finally:
        sb.stop()
        tracker.stop()


# -- failover end to end -------------------------------------------------------

def _hist(world: int):
    rows, bins = 8 * world, 8
    data = np.arange(rows) % bins

    def per(v, w, r):
        return np.bincount(data[shard_slice(rows, w, r)], minlength=bins).astype(np.int64) * v

    def expected(niter):
        return sum(np.bincount(data, minlength=bins).astype(np.int64) * v
                   for v in range(1, niter + 1))

    return per, expected


def adjusted_expected(events, expected, per):
    """The totals less every contribution a record excluded and no
    correction folded (tests/test_quorum.py's _adjusted_expected)."""
    folded = {(e["src_version"], e["rank"]) for e in events if e["kind"] == "correction_folded"}
    adjusted = expected.copy()
    for e in events:
        if e["kind"] == "quorum_met":
            for r in e["excluded"]:
                if (e["version"], r) not in folded:
                    adjusted = adjusted - per(e["version"], e["world"], r)
    return adjusted


def _completed_states(out, want):
    for tid, res in sorted(out["results"].items()):
        assert res.completed, (tid, res.error)
        assert np.array_equal(res.state, want), tid


def _count(events, kind):
    return sum(e["kind"] == kind for e in events)


@pytest.mark.parametrize("journal", ["stream", "file"])
def test_failover_mid_wave(journal, tmp_path):
    """Workers 0 and 1 are parked in the bootstrap wave when the primary
    dies; worker 2 starts after the kill, so the wave can only close on the
    promoted standby.  With a file journal the standby's state at the
    takeover is the file's replay."""
    world, niter = 3, 4
    per, expected = _hist(world)
    path = str(tmp_path / "j.bin") if journal == "file" else None
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.05, deadline_sec=45.0,
                                 standby=True, kill_primary=0.3, hold_back=(2,),
                                 journal_path=path)
    _completed_states(out, expected(niter))
    assert _count(out["promoted_events"], "tracker_failover") == 1
    assert _count(out["promoted_events"], "wave") >= 1
    assert _count(out["events"], "lease_expired") == 0
    if path:
        assert out["file_bytes"] is not None and out["standby_bytes"] == out["file_bytes"]


def test_failover_mid_run_links_survive():
    world, niter = 3, 10
    per, expected = _hist(world)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.15, deadline_sec=45.0,
                                 heartbeat_sec=0.2, standby=True, takeover_sec=0.4,
                                 kill_primary=0.5)
    _completed_states(out, expected(niter))
    assert _count(out["promoted_events"], "tracker_failover") == 1
    assert _count(out["promoted_events"], "wave") == 0  # the ring was never rebuilt
    assert out["promoted_shutdowns"] == {"0", "1", "2"}
    assert _count(out["events"], "lease_expired") == 0


def test_standby_death_leaves_the_job_unbothered():
    world, niter = 3, 4
    per, expected = _hist(world)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.05, deadline_sec=30.0,
                                 standby=True, kill_standby=0.2)
    _completed_states(out, expected(niter))
    assert out["promoted_events"] == [] and _count(out["events"], "tracker_failover") == 0
    assert out["telemetry"]["n_waves"] == 1


def test_quorum_job_fails_over_with_records_frozen():
    """Failover run (b) of chip_smoke.py at a small size: the primary dies
    once it has frozen 3 records; the promoted tracker answers every one of
    them the same, the states equal the totals adjusted by both trackers'
    records, and every shutdown lands on the promoted tracker."""
    world, niter = 3, 10
    per, expected = _hist(world)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.05, deadline_sec=45.0,
                                 quorum="0.6", quorum_wait=0.12, quorum_flag_after=0,
                                 straggler=(2, 0.4, 3), heartbeat_sec=0.2, standby=True,
                                 kill_primary=("freezes", 3))
    states = [r.state for r in out["results"].values()]
    assert all(r.completed for r in out["results"].values())
    assert all(np.array_equal(states[0], s) for s in states)
    assert len(out["primary_records"]) >= 3
    for key, rec in out["primary_records"].items():
        assert out["promoted_answers"][key] == rec, key
    assert np.array_equal(states[0], adjusted_expected(out["events"], expected(niter), per))
    assert out["promoted_shutdowns"] == {"0", "1", "2"}
    assert _count(out["events"], "lease_expired") == 0
    assert _count(out["promoted_events"], "tracker_failover") == 1


def test_localcluster_standby_survives_a_tracker_kill():
    cluster = LocalCluster(3, max_restarts=2, quiet=True, standby=True, takeover_sec=0.6)
    rc = cluster.run([sys.executable, WORKER, "niter=8", "sleep=0.25", "hb=0.2",
                      "deadline=90"], timeout=120.0, kill_tracker_after=2.0)
    assert rc == 0
    assert all(code == 0 for t, code in cluster.returncodes.items()), cluster.returncodes
    kinds = [e["kind"] for e in cluster.events]
    assert kinds.count("tracker_failover") == 1 and kinds.count("standby_synced") >= 1
    assert "lease_expired" not in kinds
    assert cluster.telemetry is not None and cluster.telemetry["n_waves"] >= 0


def test_launcher_cli_flags():
    import subprocess

    help_text = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.tracker.launcher",
                                "--help"], capture_output=True, text=True, cwd=REPO,
                               timeout=60, check=True).stdout
    for flag in ("--standby", "--ha-journal", "--takeover-sec", "--kill-tracker-after"):
        assert flag in help_text
    ha_help = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.ha", "--help"],
                             capture_output=True, text=True, cwd=REPO, timeout=60,
                             check=True).stdout
    jax_help = subprocess.run([sys.executable, "-m", "rabit_tpu.ha", "--help"],
                              capture_output=True, text=True, cwd=REPO, timeout=60,
                              env={**os.environ, "JAX_PLATFORMS": "cpu"}, check=True).stdout
    options = re.compile(r"^\s+(--[\w-]+)", re.M)  # the options section's flags
    assert options.findall(ha_help) == options.findall(jax_help)
    assert "--primary" in options.findall(ha_help)
