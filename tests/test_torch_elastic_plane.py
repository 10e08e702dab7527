"""The port's elastic plane against ``rabit_tpu``'s (tests/test_elastic.py's
cases, on the same inputs).

* ``elastic.membership`` and ``elastic.rebalance``: ``decide`` / ``commit``,
  ``rank_map_delta``, the shard cut, ``rebalance_plan`` and ``refold``
  equal the JAX package's, case by case, and ``settings`` resolves the
  same config keys;
* the wire: the Assignment with its rank map and schedule, the blob,
  block and sched frames and the new hellos, byte for byte against
  ``rabit_tpu.tracker.protocol``, in both directions;
* in-thread jobs of ``ElasticWorker``s under the port's ``Tracker``: a
  spare promoted within one wave, a shrink and a grow-back, every state
  bitwise the expected totals, the events and telemetry.json as
  tests/test_elastic.py checks them; no spares and no shrink deadline
  keep a short wave waiting;
* across the packages, both ways: the port's workers under
  ``rabit_tpu``'s tracker and ``rabit_tpu``'s under the port's;
* processes under the port's ``LocalCluster``
  (tests/workers/torch_elastic_worker.py): a SIGKILL with a warm spare
  parked (the restarted worker parks as a surplus spare and is released),
  a spare taking a scheduled death's slot, and a shrink with a grow-back;
  every kill waits for the tracker's events, never for a time;
* the package surface: ``import rabit_tpu_torch`` is the rabit API and
  loads neither torch nor jax.
"""

from __future__ import annotations

import glob
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from rabit_tpu.config import Config as JaxConfig
from rabit_tpu.elastic import membership as jmem
from rabit_tpu.elastic import rebalance as jreb
from rabit_tpu.elastic import settings as jsettings
from rabit_tpu.elastic.client import ElasticWorker as JaxWorker
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch import elastic
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.elastic import membership as mem
from rabit_tpu_torch.elastic.client import ElasticWorker
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.launcher import LocalCluster, spare_task_id
from rabit_tpu_torch.tracker.tracker import Tracker

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = str(ROOT / "tests" / "workers" / "torch_elastic_worker.py")


# -- membership and rebalance -------------------------------------------------

# (base_world, min_world, shrink_after_sec, committed shrunk world or None,
#  [(n_pending, n_spares, wave_age), ...]): tests/test_elastic.py's cases
DECIDE_CASES = {
    "transitions": (4, 1, 2.0, None, [(4, 2, 0.0), (3, 1, 0.1), (3, 1, 0.5), (3, 0, 1.0),
                                      (3, 0, 2.5), (0, 3, 99.0)]),
    "legacy": (4, 1, 0.0, None, [(3, 0, 1e6), (4, 0, 0.0), (3, 1, 0.1), (3, 1, 0.3)]),
    "min_world": (4, 3, 1.0, None, [(2, 0, 5.0), (3, 0, 5.0), (1, 1, 5.0), (2, 1, 5.0)]),
    "grow": (4, 1, 1.0, 3, [(3, 1, 0.5), (4, 5, 0.5), (3, 0, 0.5), (2, 1, 0.1),
                            (2, 1, 0.5), (2, 1, 1.5), (1, 0, 2.0)]),
}


@pytest.mark.parametrize("case", sorted(DECIDE_CASES))
def test_decide_matches_jax(case):
    base, floor, shrink, shrunk, calls = DECIDE_CASES[case]
    mine = mem.MembershipManager(base, min_world=floor, shrink_after_sec=shrink,
                                 promote_after_sec=0.25)
    ref = jmem.MembershipManager(base, min_world=floor, shrink_after_sec=shrink,
                                 promote_after_sec=0.25)
    if shrunk is not None:
        rank_map = {str(r): r for r in range(shrunk)}
        mine.commit(rank_map, shrunk)
        ref.commit(rank_map, shrunk)
    for n_spares in (0, 1):
        assert mine.grow_wanted(n_spares) == ref.grow_wanted(n_spares)
    for call in calls:
        got, want = mine.decide(*call), ref.decide(*call)
        assert (got.action, got.world, got.take_spares, got.resized) == (
            want.action, want.world, want.take_spares, want.resized), call


def test_decide_transitions():
    m = mem.MembershipManager(4, shrink_after_sec=2.0, promote_after_sec=0.25)
    d = m.decide(4, 2, 0.0)
    assert (d.action, d.world, d.take_spares, d.resized) == (mem.CLOSE, 4, 0, 0)
    assert m.decide(3, 1, 0.1).action == mem.WAIT      # inside the promotion grace
    d = m.decide(3, 1, 0.5)
    assert (d.action, d.world, d.take_spares, d.resized) == (mem.CLOSE, 4, 1, 0)
    assert m.decide(3, 0, 1.0).action == mem.WAIT      # before the shrink deadline
    d = m.decide(3, 0, 2.5)
    assert (d.action, d.world, d.resized) == (mem.CLOSE, 3, -1)
    assert m.decide(0, 3, 99.0).action == mem.WAIT
    assert mem.MembershipManager(4).decide(3, 0, 1e6).action == mem.WAIT  # legacy


@pytest.mark.parametrize("maps", [
    [({"a": 0, "b": 1}, 2), ({"a": 0, "s0": 1}, 2), ({"s0": 0}, 1), ({"s0": 0, "a": 1}, 2)],
    [({"0": 0, "1": 1, "2": 2}, 3), ({"0": 0, "2": 1}, 2)],
], ids=["promote-shrink-grow", "moved"])
def test_commit_and_delta_match_jax(maps):
    mine, ref = mem.MembershipManager(3), jmem.MembershipManager(3)
    for rank_map, world in maps:
        e1, d1 = mine.commit(rank_map, world)
        e2, d2 = ref.commit(rank_map, world)
        assert (e1.epoch, e1.world_size, dict(e1.rank_map)) == (
            e2.epoch, e2.world_size, dict(e2.rank_map))
        assert d1 == d2
    assert [e.epoch for e in mine.history] == list(range(len(maps)))
    for bad in ({"a": 0, "b": 2}, {"a": 0}):
        with pytest.raises(ValueError):
            mine.commit(bad, 2)
    prev, new = maps[0][0], maps[-1][0]
    assert mem.rank_map_delta(prev, new) == jmem.rank_map_delta(prev, new)
    assert elastic.rank_map_delta is mem.rank_map_delta


@pytest.mark.parametrize("n_rows", [0, 1, 7, 64, 100, 1_000_003])
def test_shard_cut_and_plan_match_jax(n_rows):
    for world in (1, 2, 3, 5, 8):
        assert elastic.shard_bounds(n_rows, world) == jreb.shard_bounds(n_rows, world)
        for rank in range(world):
            assert elastic.shard_slice(n_rows, world, rank) == jreb.shard_slice(
                n_rows, world, rank)
        for new in (1, 2, 3, 4):
            assert elastic.rebalance_plan(n_rows, world, new) == jreb.rebalance_plan(
                n_rows, world, new)
    with pytest.raises(ValueError):
        elastic.shard_slice(10, 3, 3)


def test_refold_matches_jax_at_every_world():
    data = np.arange(24, dtype=np.int64) % 5
    total = np.bincount(data, minlength=5)
    for world in (1, 2, 3, 4):
        parts = [np.bincount(data[elastic.shard_slice(24, world, r)], minlength=5)
                 for r in range(world)]
        got = elastic.refold(parts)
        assert np.array_equal(got, total) and np.array_equal(got, jreb.refold(parts))
    with pytest.raises(ValueError):
        elastic.refold([])


@pytest.mark.parametrize("args", [
    [], ["rabit_spare=1", "rabit_shrink_after_sec=2.5", "rabit_min_world=2"],
    ["rabit_spare_promote_sec=0.5", "rabit_spare=0"],
])
def test_settings_match_jax(args):
    assert elastic.settings(Config(args)) == jsettings(JaxConfig(args))


# -- the wire -----------------------------------------------------------------

ASSIGNMENT = dict(rank=1, world_size=3, parent=0, children=[], ring_prev=0, ring_next=2,
                  peers={0: ("127.0.0.1", 1000), 1: ("127.0.0.1", 1001),
                         2: ("127.0.0.1", 1002)},
                  epoch=7, rank_map={"0": 0, "s0": 1, "2": 2}, algo="swing",
                  ring_order=[0, 2, 1])


def _through_socket(data: bytes, read):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        return read(b)
    finally:
        a.close()
        b.close()


def test_assignment_bytes_and_roundtrip_both_ways():
    mine, ref = P.Assignment(**ASSIGNMENT), JP.Assignment(**ASSIGNMENT)
    assert mine.encode() == ref.encode()
    assert _through_socket(ref.encode(), P.Assignment.recv) == mine
    got = _through_socket(mine.encode(), JP.Assignment.recv)
    assert got == ref and got.rank_map == {"0": 0, "s0": 1, "2": 2}


@pytest.mark.parametrize("version,blob", [(5, b"payload"), (0, b""), (3, bytes(range(256)))])
def test_blob_frame_matches_jax(version, blob):
    assert P.put_blob_frame(version, blob) == JP.put_blob_frame(version, blob)
    assert _through_socket(JP.put_blob_frame(version, blob), P.recv_blob_frame) == (
        version, blob)
    assert _through_socket(P.put_blob_frame(version, blob), JP.recv_blob_frame) == (
        version, blob)


def test_block_and_sched_frames_match_jax():
    frame = P.put_block_frame(9, 3, b"abc")
    assert frame == JP.put_block_frame(9, 3, b"abc")
    assert P.read_block_frame(frame) == JP.read_block_frame(frame) == (9, 3, b"abc")
    with pytest.raises(ValueError):
        P.read_block_frame(b"1234")
    sched = P.put_sched_frame("ring", [1, 0, 2])
    assert sched == JP.put_sched_frame("ring", [1, 0, 2])
    assert _through_socket(sched, P.read_sched_frame) == ("ring", [1, 0, 2])
    assert (P.CMD_SPARE, P.CMD_EPOCH, P.CMD_BLOB, P.MAGIC_LINK, P.MAGIC_BLOB) == (
        JP.CMD_SPARE, JP.CMD_EPOCH, JP.CMD_BLOB, JP.MAGIC_LINK, JP.MAGIC_BLOB)


@pytest.mark.parametrize("cmd,kw", [
    ("CMD_SPARE", {"listen_port": 4242}), ("CMD_EPOCH", {"message": "12"}),
    ("CMD_BLOB", {"blob": b"\x00\x01zz", "blob_version": 6}),
])
def test_hellos_match_jax(cmd, kw):
    def hello(mod):
        a, b = socket.socketpair()
        try:
            mod.send_hello(a, getattr(mod, cmd), "s0", prev_rank=2, **kw)
            a.close()
            return b.recv(1 << 16)
        finally:
            b.close()

    assert hello(P) == hello(JP)


def test_tracker_rpc_refuses_check_ins():
    """A spare's check-in is refused (its park holds a socket of its own);
    START and RECOVER ride tracker_rpc, so a dead port is unreachable."""
    with pytest.raises(ValueError):
        P.tracker_rpc("127.0.0.1", 1, P.CMD_SPARE, "0")
    for cmd in (P.CMD_START, P.CMD_RECOVER):
        with pytest.raises(P.TrackerUnreachable):
            P.tracker_rpc("127.0.0.1", 1, cmd, "0", timeout=0.5, retries=0)


# -- in-thread jobs -----------------------------------------------------------

def _histogram_job(world, n_bins=8, iter_sleep=0.05):
    """tests/test_elastic.py's shared-dataset histogram job."""
    n_rows = 8 * world
    data = np.arange(n_rows, dtype=np.int64) % n_bins

    def contribution(version, w, r):
        time.sleep(iter_sleep)
        shard = data[elastic.shard_slice(n_rows, w, r)]
        return np.bincount(shard, minlength=n_bins).astype(np.int64) * version

    def expected(niter):
        return sum(np.bincount(data, minlength=n_bins).astype(np.int64) * v
                   for v in range(1, niter + 1))

    return contribution, expected


def _run_job(tracker, specs, niter, contribution, deadline_sec=30.0, worker=ElasticWorker):
    """``worker`` threads per ``(task_id, spare, delay, fail)``; returns
    {task_id: result}."""
    addr = (tracker.host, tracker.port)
    results, lock = {}, threading.Lock()

    def run_one(task_id, spare, delay, fail):
        if delay:
            time.sleep(delay)
        res = worker(addr, task_id, contribution, niter, spare=spare, heartbeat_sec=0.15,
                     wave_timeout=10.0, link_timeout=1.0, deadline_sec=deadline_sec,
                     fail=fail).run()
        with lock:
            results[task_id] = res

    threads = [threading.Thread(target=run_one, args=spec, daemon=True) for spec in specs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=deadline_sec + 10.0)
        assert not th.is_alive(), f"worker thread hung: {specs}"
    return results


def test_spare_promotion_one_wave_bitwise(tmp_path):
    world, niter = 3, 5
    contribution, expected = _histogram_job(world)
    t0 = Tracker(world, quiet=True).start()
    try:
        clean = _run_job(t0, [(str(i), False, 0.0, None) for i in range(world)], niter,
                         contribution)
    finally:
        t0.stop()
    assert all(r.completed for r in clean.values())
    reference = clean["0"].state

    obs_dir = tmp_path / "obs"
    tracker = Tracker(world, quiet=True, obs_dir=str(obs_dir), promote_after_sec=0.1).start()
    try:
        specs = [(str(i), False, 0.0, ("die", 3) if i == 1 else None) for i in range(world)]
        specs.append(("s0", True, 0.0, None))
        results = _run_job(tracker, specs, niter, contribution)
    finally:
        tracker.stop()
    assert results["1"].died
    completed = [r for r in results.values() if r.completed]
    assert len(completed) == world
    assert results["s0"].promoted and results["s0"].completed
    for r in completed:
        assert np.array_equal(r.state, expected(niter))
        assert np.array_equal(r.state, reference)
    events = tracker.events
    assert [e for e in events if e["kind"] == "spare_promoted"]
    assert all(e["world"] == world for e in events if e["kind"] == "wave")
    assert not [e for e in events if e["kind"] == "world_shrunk"]
    tele = json.loads((obs_dir / "telemetry.json").read_text())
    assert tele["n_spares_promoted"] >= 1 and tele["n_shrunk"] == 0 == tele["n_grown"]
    assert [ep["world"] for ep in tele["epochs"]] == [world] * len(tele["epochs"])
    assert len(tele["epochs"]) >= 2


def test_shrink_then_grow_back(tmp_path):
    world, niter = 3, 14
    contribution, expected = _histogram_job(world, iter_sleep=0.15)
    obs_dir = tmp_path / "obs"
    tracker = Tracker(world, quiet=True, obs_dir=str(obs_dir), shrink_after_sec=1.0,
                      promote_after_sec=0.1).start()
    try:
        specs = [(str(i), False, 0.0, ("die", 3) if i == 2 else None) for i in range(world)]
        specs.append(("s0", True, 2.0, None))  # parks after the shrink deadline
        results = _run_job(tracker, specs, niter, contribution, deadline_sec=40.0)
    finally:
        tracker.stop()
    assert results["2"].died
    for r in (results["0"], results["1"]):
        assert r.completed, r.error
        assert np.array_equal(r.state, expected(niter))
        assert min(r.worlds) < world
    waves = [e for e in tracker.events if e["kind"] == "wave"]
    shrunk = [e for e in tracker.events if e["kind"] == "world_shrunk"]
    grown = [e for e in tracker.events if e["kind"] == "world_grown"]
    assert shrunk and (shrunk[0]["from"], shrunk[0]["to"]) == (world, world - 1)
    assert shrunk[0]["lost"] == ["2"]
    assert grown and grown[0]["to"] == world and grown[0]["joined"] == ["s0"]
    for w in waves:
        assert sorted(w["assignments"].values()) == list(range(w["world"]))
    epochs = [w["epoch"] for w in waves]
    assert epochs == sorted(set(epochs))
    assert results["s0"].promoted and results["s0"].completed
    assert np.array_equal(results["s0"].state, expected(niter))
    tele = json.loads((obs_dir / "telemetry.json").read_text())
    assert tele["n_shrunk"] >= 1 and tele["n_grown"] >= 1
    worlds = [ep["world"] for ep in tele["epochs"]]
    assert world - 1 in worlds and worlds[-1] == world


def test_no_spares_no_shrink_keeps_waiting():
    """With no spares and no shrink deadline a short wave waits, past the
    promotion grace and the monitor's scans, as before the elastic plane."""
    tracker = Tracker(2, quiet=True).start()
    try:
        sock = socket.create_connection((tracker.host, tracker.port), timeout=5)
        P.send_hello(sock, P.CMD_START, "0", listen_port=1)
        sock.settimeout(1.0)
        with pytest.raises(socket.timeout):
            sock.recv(4)
        assert tracker.epoch == -1 and not [e for e in tracker.events if e["kind"] == "wave"]
        sock.close()
    finally:
        tracker.stop()


# (tracker, worker) of each direction; the port's own pairing too, for the
# fail modes and the codec
PAIRS = {
    "port-workers-jax-tracker": (JaxTracker, ElasticWorker),
    "jax-workers-port-tracker": (Tracker, JaxWorker),
    "port-workers-port-tracker": (Tracker, ElasticWorker),
}


@pytest.mark.parametrize("direction,spare_fail", [
    *(pytest.param(d, None, id=d)
      for d in ("port-workers-jax-tracker", "jax-workers-port-tracker")),
    *(pytest.param(d, f, id=f"{d}-{f}")
      for d in PAIRS for f in ("die_parked", "die_promoted")),
])
def test_cross_package_spare_promotion(direction, spare_fail):
    """Rank 1 dies at version 3 with spares parked.  With ``spare_fail``,
    the first spare dies in the pool (``die_parked``: the tracker drops it)
    or the moment it is promoted (``die_promoted``: the survivors' links
    fail and the next wave takes the second spare); the wave still closes
    at the full world and every state is the totals."""
    world, niter = 3, 5
    contribution, expected = _histogram_job(world)
    tracker_cls, worker = PAIRS[direction]
    tracker = tracker_cls(world, quiet=True, promote_after_sec=0.1).start()
    try:
        specs = [(str(i), False, 0.0, ("die", 3) if i == 1 else None) for i in range(world)]
        specs.append(("s0", True, 0.0, (spare_fail,) if spare_fail else None))
        if spare_fail:
            specs.append(("s1", True, 0.05, None))  # parks behind s0
        results = _run_job(tracker, specs, niter, contribution, worker=worker)
    finally:
        tracker.stop()
    completed = [r for r in results.values() if r.completed]
    assert len(completed) == world
    for r in completed:
        assert np.array_equal(r.state, expected(niter))
    assert tracker.telemetry["n_spares_promoted"] >= 1
    waves = [e for e in tracker.events if e["kind"] == "wave"]
    assert all(w["world"] == world for w in waves)
    if spare_fail is None:
        assert results["s0"].promoted
        return
    s0, s1 = results["s0"], results["s1"]
    assert s0.died and not s0.completed
    assert s1.promoted and s1.completed, s1.error
    if spare_fail == "die_parked":
        assert not s0.promoted
        dropped = [e for e in tracker.events if e["kind"] == "spare_dropped"]
        assert dropped and dropped[0]["dropped"] == ["s0"]
    else:
        assert s0.promoted
        promoted = [e["task_id"] for e in tracker.events if e["kind"] == "spare_promoted"]
        assert promoted[:2] == ["s0", "s1"]


def _float_job():
    """Float32 contributions of a fixed world: rank r's block of version v
    drawn from seed (v, r), so that a codec's rounding shows."""
    def contribution(version, w, r):
        rng = np.random.default_rng([version, r])
        return (rng.standard_normal(64) * 100.0).astype(np.float32)

    return contribution


@pytest.mark.parametrize("codec", ["bf16", "i8"])
@pytest.mark.parametrize("direction", sorted(PAIRS))
def test_codec_job_bitwise_against_jax(codec, direction):
    """``codec=``: each rank's contribution crosses the ring encoded, and
    every rank folds the decoded blocks in rank order.  The states equal
    ``rabit_tpu``'s own workers' under its own tracker, and the fold of
    the JAX codec's decode(encode(.)), bit for bit."""
    from rabit_tpu.compress import get_codec as jax_codec

    world, niter = 3, 4
    contribution = _float_job()

    def job(tracker_cls, worker):
        tracker = tracker_cls(world, quiet=True).start()
        addr = (tracker.host, tracker.port)
        results, lock = {}, threading.Lock()

        def run_one(task_id):
            res = worker(addr, task_id, contribution, niter, heartbeat_sec=0.15,
                         wave_timeout=10.0, link_timeout=1.0, deadline_sec=30.0,
                         codec=codec).run()
            with lock:
                results[task_id] = res

        threads = [threading.Thread(target=run_one, args=(str(i),), daemon=True)
                   for i in range(world)]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=40.0)
                assert not th.is_alive(), f"worker thread hung: {direction}"
        finally:
            tracker.stop()
        assert all(r.completed for r in results.values()), [r.error for r in results.values()]
        return results

    c = jax_codec(codec)
    want = None
    for v in range(1, niter + 1):
        total = jreb.refold([c.decode(c.encode(contribution(v, world, r)), 64)
                             for r in range(world)])
        want = total if want is None else want + total
    reference = job(JaxTracker, JaxWorker)["0"].state
    assert np.array_equal(reference, want)
    for r in job(*PAIRS[direction]).values():
        assert r.state.dtype == np.float32
        assert np.array_equal(r.state, want)


@pytest.mark.parametrize("kw,item", [
    ({"quorum": "2"}, "10c"), ({"job": "j"}, "10g"), ({"slow_report_share": 0.3}, "10b"),
])
def test_unported_arguments_name_their_item(kw, item):
    if item in ("10b", "10c"):  # the slow-link report and quorum rounds are ported: accepted
        w = ElasticWorker(("127.0.0.1", 1), "0", lambda v, w, r: np.zeros(1), 1, **kw)
        if item == "10b":
            assert w.slow_report_share == kw["slow_report_share"]
        else:
            assert w.quorum_spec == kw["quorum"]
        w._listen.close()
    else:
        with pytest.raises(NotImplementedError, match=item):
            ElasticWorker(("127.0.0.1", 1), "0", lambda v, w, r: np.zeros(1), 1, **kw)
    # the tracker failover list is ported (item 10d): accepted, never refused
    w = ElasticWorker([("127.0.0.1", 1), ("127.0.0.1", 2)], "0", lambda v, w, r: np.zeros(1), 1)
    assert w.addrs == [("127.0.0.1", 1), ("127.0.0.1", 2)] and w.tracker == ("127.0.0.1", 1)
    w._listen.close()


# -- processes under the launcher ---------------------------------------------

def _parked(events):
    return any(e["kind"] == "spare_parked" for e in events)


def _committed(version):
    return lambda events: any(e["kind"] == "bootstrap_blob" and e["version"] >= version
                              for e in events)


def test_launcher_bookkeeping_is_keyed_by_task_id():
    cluster = LocalCluster(3, spares=2)
    assert set(cluster.restarts) == set(cluster.returncodes) == {"0", "1", "2", "s0", "s1"}
    assert spare_task_id(0) == "s0" and not spare_task_id(0).isdigit()


@pytest.mark.parametrize("restart_delay", [0.0, 3.0], ids=["during", "after-the-end"])
def test_sigkill_with_warm_spare_process_level(tmp_path, restart_delay):
    """Rank 1 SIGKILLed once a spare has parked and version 2 is committed:
    the spare takes the slot within one wave, the restarted worker finds
    its slot taken and parks, and is released when the job ends (or at
    once, when it checks in after the end, as a life slow to reach a card
    does); every completed state is bitwise the totals."""
    cluster = LocalCluster(2, max_restarts=1, quiet=True, spares=1)
    t0 = time.monotonic()
    rc = cluster.run([sys.executable, WORKER, "niter=8", "sleep=0.1", "hb=0.5",
                      f"restart_delay={restart_delay}", f"out={tmp_path}"], timeout=90.0,
                     preempt=[(0.0, 1)], start_when=lambda ev: _parked(ev) and _committed(2)(ev))
    assert time.monotonic() - t0 < 45.0  # no life waits out its 60 s deadline
    assert rc == 0 and cluster.preempts_delivered == 1
    assert cluster.returncodes == {"0": 0, "1": 0, "s0": 0}
    assert cluster.restarts["1"] == 1 and len(cluster.death_times) == 1
    tele = cluster.telemetry
    assert tele["n_spares_promoted"] == 1 and tele["n_shrunk"] == 0
    assert all(ep["world"] == 2 for ep in tele["epochs"])
    parked = [e["task_id"] for e in cluster.events if e["kind"] == "spare_parked"]
    assert parked == ["s0", "1"]
    runs = {os.path.basename(f).split("-")[0]: dict(np.load(f))
            for f in glob.glob(str(tmp_path / "*.npz"))}
    assert bool(runs["1"]["parked_only"]) and not bool(runs["1"]["completed"])
    assert bool(runs["s0"]["promoted"]) and bool(runs["s0"]["completed"])
    assert np.array_equal(runs["0"]["state"], runs["s0"]["state"])
    after = [t for r in runs.values() for _, t in r["commits"] if t > cluster.death_times[0]]
    assert after, "no commit after the kill"


def test_spare_takes_scheduled_death_process_level():
    cluster = LocalCluster(2, max_restarts=0, quiet=True, spares=1)
    rc = cluster.run([sys.executable, WORKER, "niter=8", "sleep=0.1", "hb=0.5", "die=1:3"],
                     timeout=90.0)
    assert rc == 0 and all(r == 0 for r in cluster.returncodes.values())
    assert cluster.telemetry["n_spares_promoted"] == 1
    assert all(ep["world"] == 2 for ep in cluster.telemetry["epochs"])


def test_shrink_and_grow_back_process_level():
    """No spare at the scheduled death: the world shrinks to 1 after the
    deadline; a spare that parks once the world has shrunk grows it back."""
    cluster = LocalCluster(2, max_restarts=0, quiet=True, spares=1, shrink_after_sec=1.0)
    rc = cluster.run([sys.executable, WORKER, "niter=10", "sleep=0.15", "hb=0.5", "die=1:3",
                      "park_after_shrink=1", "world=2"], timeout=90.0)
    assert rc == 0 and cluster.returncodes == {"0": 0, "1": 0, "s0": 0}
    tele = cluster.telemetry
    assert tele["n_shrunk"] == 1 and tele["n_grown"] == 1
    assert [ep["world"] for ep in tele["epochs"]] == [2, 1, 2]


def test_shrink_process_level():
    cluster = LocalCluster(2, max_restarts=0, quiet=True, shrink_after_sec=1.0)
    rc = cluster.run([sys.executable, WORKER, "niter=8", "sleep=0.1", "hb=0.5", "die=1:3"],
                     timeout=90.0)
    assert rc == 0 and cluster.returncodes["0"] == 0
    assert cluster.telemetry["n_shrunk"] >= 1 and cluster.telemetry["epochs"][-1]["world"] == 1


# -- the package surface ------------------------------------------------------

def test_package_is_the_rabit_api_without_torch_or_jax():
    code = (
        "import sys\n"
        "import rabit_tpu_torch as rabit\n"
        "import rabit_tpu_torch.elastic, rabit_tpu_torch.tracker\n"
        "from rabit_tpu_torch.tracker import Tracker, LocalCluster\n"
        "names = ['init', 'finalize', 'get_rank', 'get_world_size', 'is_distributed',\n"
        "         'tracker_print', 'get_processor_name', 'broadcast', 'allreduce',\n"
        "         'allgather', 'load_checkpoint', 'checkpoint', 'lazy_checkpoint',\n"
        "         'version_number', 'collective_stats', 'reset_collective_stats']\n"
        "assert all(callable(getattr(rabit, n)) for n in names)\n"
        "assert (rabit.MAX, rabit.MIN, rabit.SUM, rabit.BITOR) == (0, 1, 2, 3)\n"
        "assert rabit.__version__ and sorted(rabit.__all__) == sorted(names + "
        "['MAX', 'MIN', 'SUM', 'BITOR'])\n"
        "rabit.init(['rabit_engine=empty'])\n"
        "assert rabit.get_world_size() == 1 and rabit.allreduce(__import__('numpy')"
        ".ones(3), rabit.SUM).tolist() == [1.0, 1.0, 1.0]\n"
        "rabit.finalize()\n"
        "loaded = [m for m in sys.modules if m in ('torch', 'jax') or m.startswith(('torch.',"
        " 'jax.'))]\n"
        "print(loaded)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_collective_stats_and_public_names():
    import rabit_tpu as jrt
    import rabit_tpu_torch as rabit
    from rabit_tpu_torch import ops
    from rabit_tpu_torch.models import gbdt
    from rabit_tpu_torch.profile import GLOBAL_STATS

    assert sorted(rabit.__all__) == sorted(jrt.__all__)
    assert rabit.collective_stats() is GLOBAL_STATS
    with GLOBAL_STATS.timed("allreduce", 8):
        pass
    assert GLOBAL_STATS.ops
    rabit.reset_collective_stats()
    assert not GLOBAL_STATS.ops
    for name in ("node_histograms", "node_histograms_onehot", "node_histograms_pallas",
                 "node_histograms_scatter", "segment_sum", "segment_sum_matmul"):
        assert callable(getattr(ops, name)), name
    import torch

    rng = np.random.RandomState(3)
    xb = torch.as_tensor(rng.randint(0, 8, size=(50, 3)).astype(np.int32))
    g = torch.as_tensor(rng.randn(50).astype(np.float32))
    h = torch.ones(50)
    node = torch.as_tensor(rng.randint(0, 2, 50).astype(np.int32))
    assert torch.equal(gbdt.node_histograms(xb, g, h, node, 2, 8),
                       ops.node_histograms_scatter(xb, g, h, node, 2, 8))
