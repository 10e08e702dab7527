"""The port's quorum rounds against rabit_tpu's: the policy, the tracker's
ledger and the wire pieces on the same inputs, then K-of-N rounds end to end
on the CPU, within each package and across them.

* **Pure.** ``parse_spec``, ``quorum_count`` and ``resolve`` give the same
  results and raise the same errors on valid and malformed specs;
  ``QuorumTable`` gives the same ``(reply, events, flag_ranks)`` and
  ``outstanding()`` on hypothesis-drawn report sequences with epoch
  changes; block and skip frames are byte-identical; ``parse_addrs`` agrees.
* **The tracker.** A ``CMD_QUORUM`` report gets the same record from both
  packages' trackers, and the ``disabled`` and ``stale_epoch`` replies; the
  scrape's ``quorum_outstanding`` and the telemetry keys carry the ledger.
* **End to end.** The counterparts of tests/test_quorum.py's executor tests
  through tests/workers/torch_diag_job.py with numpy contributions: full
  quorum is bitwise the exact path, a healing straggler is excluded and its
  corrections fold with the exact accounting, a persistent straggler skips
  while the cadence tracks the median, a death with a correction in flight
  stays inside the accounting sandwich, the i8 codec stays within its
  bound, and a persistent late rank flags its incoming link.
* **Across packages.** rabit_tpu's quorum workers fold against the port's
  tracker, and the port's against rabit_tpu's.
"""

from __future__ import annotations

import json
import random
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rabit_tpu import quorum as jquorum
from rabit_tpu.config import Config as JaxConfig
from rabit_tpu.elastic.client import ElasticWorker as JaxWorker
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch import quorum as pquorum
from rabit_tpu_torch.config import Config as PortConfig
from rabit_tpu_torch.elastic.rebalance import shard_slice
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker

sys.path.insert(0, str(Path(__file__).parent / "workers"))
import torch_diag_job  # noqa: E402

sys.path.pop(0)

SPECS = ["", " ", "1.0", "0.75", "0.6", "0.67", "0.5", "6", "1", "100", " 0.5 ", "1.5", "0",
         "-2", "0.0", "fast", "0x2", "nan", "inf", "1e-9", "2.0"]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("ValueError", str(exc))


# -- policy --------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_policy_matches(spec):
    assert _outcome(pquorum.parse_spec, spec) == _outcome(jquorum.parse_spec, spec)
    for world in (0, 1, 2, 3, 4, 7, 8, 9):
        assert (_outcome(pquorum.quorum_count, world, spec)
                == _outcome(jquorum.quorum_count, world, spec))


@pytest.mark.parametrize("args", [
    [], ["rabit_quorum=0.75", "rabit_quorum_wait_sec=0.2", "rabit_quorum_flag_after=5"],
    ["rabit_quorum=2"], ["rabit_quorum=nope"], ["rabit_quorum=1.5"],
    ["rabit_quorum= 0.5 ", "rabit_quorum_wait_sec="],
])
def test_resolve_matches(args):
    got = _outcome(pquorum.resolve, PortConfig(args))
    assert got == _outcome(jquorum.resolve, JaxConfig(args))
    if args == []:
        assert got == ("ok", {"quorum": "", "wait_sec": 0.35, "flag_after": 3})


def test_config_defaults_match():
    keys = ("rabit_quorum", "rabit_quorum_wait_sec", "rabit_quorum_flag_after")
    assert {k: PortConfig([]).get(k) for k in keys} == {k: JaxConfig([]).get(k) for k in keys}


# -- the ledger ----------------------------------------------------------------

_REPORT = st.tuples(
    st.just("report"), st.integers(0, 2), st.integers(1, 6), st.integers(1, 5),
    st.lists(st.integers(0, 5), max_size=6),
    st.lists(st.tuples(st.integers(0, 6), st.integers(0, 5)), max_size=4))
_EPOCH = st.tuples(st.just("epoch"), st.integers(0, 3))


@settings(max_examples=60, deadline=None)
@given(spec=st.sampled_from(["0.6", "0.5", "2", "1", "1.0", "3"]),
       flag_after=st.integers(0, 3),
       ops=st.lists(st.one_of(_REPORT, _REPORT, _EPOCH), max_size=40))
def test_quorum_table_matches(spec, flag_after, ops):
    mine, theirs = pquorum.QuorumTable(spec, flag_after), jquorum.QuorumTable(spec, flag_after)
    for op in ops:
        if op[0] == "epoch":
            assert mine.epoch_changed(op[1]) == theirs.epoch_changed(op[1])
        else:
            _, epoch, version, world, have, held = op
            assert (mine.report(epoch, version, world, have, held)
                    == theirs.report(epoch, version, world, have, held))
            assert mine.has_record(epoch, version) == theirs.has_record(epoch, version)
        assert mine.outstanding() == theirs.outstanding()


def test_quorum_table_seed_answers_the_same():
    t = pquorum.QuorumTable("2")
    rec, _, _ = t.report(0, 1, 3, have=[0, 1], held=[])
    twin = pquorum.QuorumTable("2")
    twin.seed({"records": {(0, 1): rec}, "outstanding": {(1, 2): 3}, "late_seen": set(),
               "streak": {2: 1}})
    assert twin.report(0, 1, 3, have=[0, 1, 2], held=[])[0] == rec
    assert twin.outstanding() == t.outstanding() == [(1, 2, 3)]
    with pytest.raises(ValueError):
        pquorum.QuorumTable("nope")


# -- wire ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_block_and_skip_frames_match(seed):
    rng = random.Random(seed)
    v, origin = rng.randrange(1 << 32), rng.randrange(-(1 << 31), 1 << 31)
    payload = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 64)))
    frame = P.put_block_frame(v, origin, payload)
    assert frame == JP.put_block_frame(v, origin, payload)
    assert P.read_block_frame(frame) == JP.read_block_frame(frame) == (v, origin, payload)
    short = frame[:rng.randrange(0, 8)]
    for read in (P.read_block_frame, JP.read_block_frame):
        with pytest.raises(ValueError):
            read(short)
    rank, epoch, version = rng.randrange(-1, 64), rng.randrange(1 << 32), rng.randrange(1 << 32)
    skip = P.put_skip_frame(rank, epoch, version)
    assert skip == JP.put_skip_frame(rank, epoch, version)
    a, b = socket.socketpair()
    try:
        a.sendall(skip * 2)
        assert P.get_u32(b) == P.MAGIC_SKIP == JP.MAGIC_SKIP
        assert P.read_skip_frame(b) == (rank, epoch, version)
        assert JP.get_u32(b) == JP.MAGIC_SKIP
        assert JP.read_skip_frame(b) == (rank, epoch, version)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("spec", [
    "127.0.0.1:9091,10.0.0.2:9092", "", "nonsense,1.2.3.4:80,:x", " h:1 , h:2 ,", "a:b:3",
    "[::1]:90", "host:", ":"])
def test_parse_addrs_matches(spec):
    assert P.parse_addrs(spec) == JP.parse_addrs(spec)


def test_command_numbers_match():
    for name in ("CMD_QUORUM", "CMD_JOURNAL", "MAGIC_SKIP", "JOURNAL_MAGIC"):
        assert getattr(P, name) == getattr(JP, name), name


# -- the tracker's handler -----------------------------------------------------

def _report(epoch, v, have, held=()):
    return json.dumps({"epoch": epoch, "v": v, "have": list(have), "held": [list(h) for h in held]})


def test_tracker_handler_matches_and_refuses():
    """The same reports get the same replies from both trackers: a decided
    record, a repeat of it, a stale epoch; the scrape counts the exclusion
    still owed; a tracker with no quorum answers ``disabled``."""
    trackers = [Tracker(3, quiet=True, quorum="2").start(),
                JaxTracker(3, quiet=True, quorum="2").start()]
    try:
        replies = []
        for tr in trackers:
            rpc = P.tracker_rpc if isinstance(tr, Tracker) else JP.tracker_rpc
            got = [rpc(tr.host, tr.port, P.CMD_QUORUM, "0", message=m, timeout=5.0)
                   for m in (_report(-1, 1, [0, 1]), _report(-1, 1, [0, 1, 2]),
                             _report(6, 1, [0, 1]), "{not json")]
            got.append(tr.build_scrape({"registry": False})["jobs"][""]["quorum_outstanding"])
            replies.append(got)
        assert replies[0] == replies[1]
        rec, again, stale, bad, owed = replies[0]
        assert rec["decided"] and rec["excluded"] == [2] and again == rec
        assert stale == {"decided": False, "stale_epoch": True}
        assert bad["decided"] is False and owed == 1
        assert sum(e["kind"] == "quorum_met" for e in trackers[0].events) == 1
    finally:
        for tr in trackers:
            tr.stop()
    tracker = Tracker(2, quiet=True).start()
    try:
        reply = P.tracker_rpc(tracker.host, tracker.port, P.CMD_QUORUM, "0",
                              message=_report(0, 1, [0]), timeout=5.0)
        assert reply == {"decided": False, "disabled": True}
    finally:
        tracker.stop()


def test_api_quorum_policy_seam():
    from rabit_tpu_torch import api, obs

    api.init(["rabit_quorum=0.75", "rabit_engine=empty"])
    try:
        evs = [e for e in obs.get_recorder().snapshot() if e.kind == "quorum_policy"]
        assert evs and evs[-1].fields == {"quorum": "0.75", "wait_sec": 0.35, "flag_after": 3}
    finally:
        api.finalize()
    with pytest.raises(ValueError):
        api.init(["rabit_quorum=not-a-spec", "rabit_engine=empty"])
    api.finalize()


# -- end to end ----------------------------------------------------------------

ROWS_A_RANK, BINS = 8, 8


def _histogram(world: int, dtype=np.int64):
    """rabit_tpu's _histogram_job shape: the per-contribution histogram, and
    the closed-form totals."""
    n_rows = ROWS_A_RANK * world
    data = (np.arange(n_rows, dtype=np.int64) * 5) % BINS

    def per(version, w, r):
        return np.bincount(data[shard_slice(n_rows, w, r)], minlength=BINS).astype(dtype) * version

    def expected(niter):
        return sum(np.bincount(data, minlength=BINS).astype(dtype) * v
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


def _states(out):
    for tid, res in out["results"].items():
        assert res.completed, f"{tid}: {res.error}"
    states = [out["results"][t].state for t in sorted(out["results"])]
    for s in states[1:]:
        assert np.array_equal(states[0], s), "cross-rank divergence"
    return states[0]


def _kinds(out, kind):
    return [e for e in out["events"] if e["kind"] == kind]


def test_full_quorum_is_bitwise_exact():
    world, niter = 3, 4
    per, expected = _histogram(world)
    exact = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=40.0)
    full = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=40.0,
                                  quorum="1.0")
    assert np.array_equal(_states(exact), expected(niter))
    assert np.array_equal(_states(full), _states(exact))
    assert all(r.quorum_rounds == niter for r in full["results"].values())
    assert all(r.quorum_rounds == 0 for r in exact["results"].values())
    assert not _kinds(full, "quorum_met")
    assert full["telemetry"]["quorum"] == "1.0" and exact["telemetry"]["quorum"] == ""


def test_straggler_excluded_and_corrections_land():
    world, niter = 3, 8
    per, expected = _histogram(world)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=40.0,
                                 quorum="0.6", quorum_wait=0.12, quorum_flag_after=0,
                                 straggler=(2, 0.4, 3))
    state = _states(out)
    qm = _kinds(out, "quorum_met")
    assert qm and all(e["excluded"] == [2] for e in qm)
    assert _kinds(out, "contribution_late") and _kinds(out, "correction_folded")
    assert np.array_equal(state, adjusted_expected(out["events"], expected(niter), per))
    assert max(e["version"] for e in qm) < niter  # the final round is exact
    assert not _kinds(out, "correction_dropped")
    tele = out["telemetry"]
    assert tele["quorum"] == "0.6" and tele["n_quorum_met"] == len(qm)
    assert tele["n_corrections_folded"] == len(_kinds(out, "correction_folded"))
    assert tele["n_corrections_dropped"] == 0
    assert sorted(tuple(t) for t in tele["quorum_outstanding"]) == sorted(
        (e["version"], 2, world) for e in qm
        if (e["version"], 2) not in {(c["src_version"], c["rank"])
                                     for c in _kinds(out, "correction_folded")})
    res = out["results"]
    assert res["2"].skipped_contributions > 0
    assert all(r.excluded_rounds == len(qm) for r in res.values())
    assert sum(r.corrections_folded for r in res.values()) == world * tele["n_corrections_folded"]


def test_persistent_straggler_skips_and_tracks_median():
    world, niter, sleep = 3, 10, 0.02
    per, expected = _histogram(world)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=sleep, deadline_sec=40.0,
                                 quorum="0.6", quorum_wait=0.1, quorum_flag_after=0,
                                 straggler=(2, 0.16))
    state = _states(out)
    assert out["results"]["2"].skipped_contributions > 0
    assert np.array_equal(state, adjusted_expected(out["events"], expected(niter), per))
    ct = out["results"]["0"].commit_times
    cadence = (ct[niter - 1] - ct[1]) / (niter - 2)
    assert cadence < 4 * sleep, f"live cadence {cadence:.3f}s tracks the tail"


def test_replay_after_a_death_with_a_correction_in_flight():
    world, niter = 3, 6
    per, expected = _histogram(world)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=40.0,
                                 quorum="0.6", quorum_wait=0.12, quorum_flag_after=0,
                                 straggler=(1, 0.35, 2), fails={"2": ("die", 3)})
    res = out["results"]
    survivors = [res["0"], res["1"]]
    for r in survivors:
        assert r.completed and r.final_version == niter, r.error
    assert res["2"].died
    assert np.array_equal(survivors[0].state, survivors[1].state)
    assert len(_kinds(out, "wave")) >= 2
    floor = adjusted_expected(out["events"], expected(niter), per)
    assert np.all(survivors[0].state <= expected(niter))
    assert np.all(survivors[0].state >= floor)


def test_i8_codec_within_its_bound():
    world, niter = 3, 6
    per, expected = _histogram(world, dtype=np.float32)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=40.0,
                                 quorum="0.6", quorum_wait=0.12, quorum_flag_after=0,
                                 straggler=(2, 0.3, 2), codec="i8")
    state = _states(out)
    folded = {(e["src_version"], e["rank"]) for e in _kinds(out, "correction_folded")}
    missing = {(e["version"], r) for e in _kinds(out, "quorum_met") for r in e["excluded"]}
    missing -= folded
    adjusted = expected(niter).astype(np.float64)
    bound = 0.0
    for v in range(1, niter + 1):
        for r in range(world):
            block = per(v, world, r)
            if (v, r) in missing:
                adjusted = adjusted - block
            else:
                bound += (0.5 / 127.0) * float(np.max(np.abs(block))) * 1.001
    err = np.max(np.abs(state.astype(np.float64) - adjusted))
    assert err <= bound, f"i8+quorum err {err} over summed bound {bound}"


def test_persistent_late_rank_feeds_repair():
    world, niter = 3, 8
    per, _expected = _histogram(world)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.02, deadline_sec=40.0,
                                 quorum="0.6", quorum_wait=0.1, quorum_flag_after=3,
                                 straggler=(2, 0.2))
    _states(out)
    flagged = [e for e in _kinds(out, "link_degraded") if e.get("via") == "quorum"]
    assert flagged and flagged[0]["dst"] == 2
    assert out["n_repaired"] >= 1


@pytest.mark.parametrize("direction", ["jax-workers-port-tracker", "port-workers-jax-tracker"])
def test_quorum_across_packages(direction):
    world, niter = 3, 8
    per, expected = _histogram(world)
    classes = ({"worker_cls": JaxWorker} if direction.startswith("jax")
               else {"tracker_cls": JaxTracker})
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=40.0,
                                 quorum="0.6", quorum_wait=0.12, quorum_flag_after=0,
                                 straggler=(2, 0.4, 3), **classes)
    state = _states(out)
    qm = _kinds(out, "quorum_met")
    assert qm and all(e["excluded"] == [2] for e in qm)
    assert np.array_equal(state, adjusted_expected(out["events"], expected(niter), per))


# -- blocks larger than the socket buffers (F20) --------------------------------
#
# Every rank posts its block at once, so a round whose block is larger than
# what the loopback's socket buffers hold completes only when no rank blocks
# on an outbound link while its inbound one fills.  The blocks are
# integer-valued float64, so every order of summation gives the same bits.

MIB = 1 << 20


def _large_blocks(world: int, n_bytes: int, seed: int = 20):
    rng = np.random.default_rng(seed)
    base = [rng.integers(0, 1000, n_bytes // 8).astype(np.float64) for _ in range(world)]

    def per(version, w, r):
        return base[r] * version

    def expected(niter):
        return np.sum([per(v, world, r) for v in range(1, niter + 1) for r in range(world)],
                      axis=0)

    return per, expected


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("mib", [4, 8])
def test_quorum_round_with_blocks_past_the_socket_buffers(world, mib):
    niter = 3
    per, expected = _large_blocks(world, mib * MIB)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=30.0,
                                 quorum="1.0")
    assert np.array_equal(_states(out), expected(niter))
    assert all(r.quorum_rounds == niter for r in out["results"].values())
    assert out["elapsed"] < 15.0


def test_large_blocks_cross_skip_links_and_tees():
    world, niter = 3, 6
    per, expected = _large_blocks(world, 8 * MIB)
    out = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=40.0,
                                 quorum="0.6", quorum_wait=0.12, quorum_flag_after=0,
                                 straggler=(2, 0.4, 3))
    state = _states(out)
    qm = _kinds(out, "quorum_met")
    # the straggler is excluded; with 8 MiB frames on a loaded host another
    # rank's block may miss a round's 0.12 s wait too, which the record
    # accounts for like any exclusion
    assert any(e["excluded"] == [2] for e in qm)
    assert all(len(e["excluded"]) == 1 for e in qm)  # 2 of 3 fold
    assert np.array_equal(state, adjusted_expected(out["events"], expected(niter), per))
    assert max(e["version"] for e in qm) < niter  # the final round is exact


def test_large_blocks_match_rabit_tpu_bitwise():
    """3.67 MB blocks, which rabit_tpu's blocking sends still complete: the
    port's states are rabit_tpu's, bit for bit."""
    world, niter = 3, 3
    per, expected = _large_blocks(world, 3_670_016)
    port = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=30.0,
                                  quorum="1.0")
    jax = torch_diag_job.run_job(world, niter, per, iter_sleep=0.01, deadline_sec=30.0,
                                 quorum="1.0", worker_cls=JaxWorker, tracker_cls=JaxTracker)
    assert np.array_equal(_states(port), _states(jax))
    assert _states(port).tobytes() == expected(niter).tobytes()


def test_consensus_bench_quorum_ablation_gate():
    """tests/test_quorum.py:506 through the port's tool: quorum off tracks
    the 8x straggler's cadence, quorum on sheds it (its bars)."""
    from tools.torch_consensus_bench import quorum_ablation

    out = quorum_ablation(world=3, niter=15, iter_sleep=0.02, straggler_factor=8.0,
                          device="cpu")
    assert out["arms"]["straggler_on"]["n_quorum_met"] >= 1
    assert out["off_cadence_vs_base"] > 3.0, out
    assert out["on_cadence_vs_base"] < 2.5, out
    assert (out["arms"]["straggler_on"]["cadence_s"]
            < 0.5 * out["arms"]["straggler_off"]["cadence_s"]), out
