"""The port's observability core (rabit_tpu_torch.obs) against rabit_tpu.obs.

* tests/test_obs.py's cases on the port: the flight recorder's ring
  (eviction, resize, reserved names, JSONL round trip, thread safety),
  histogram percentiles and the overflow bucket, the registry and its
  snapshot, the ``CollectiveStats`` facade (``profile``), and the api's
  flight events under the solo engine.
* Parity with the JAX package on the same inputs: a seeded sequence of
  registry calls gives equal ``snapshot()`` and ``raw_state()`` documents;
  ``event_from_stats_line`` gives the same dicts; a dump written by either
  package loads in the other with the same events; the streamed deltas and
  the rollup agree; and one user program through ``rabit_tpu_torch.api``
  and ``rabit_tpu`` (solo engine) records the same event kinds with the
  same ``(version, seqno)`` stamps.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

import rabit_tpu as rt
from rabit_tpu import obs as jobs
from rabit_tpu.obs import events as jevents
from rabit_tpu.obs import metrics as jmetrics
from rabit_tpu.obs import stream as jstream
from rabit_tpu_torch import api, obs, profile
from rabit_tpu_torch.obs import events, metrics, stream
from rabit_tpu_torch.obs.events import Event, FlightRecorder, event_from_stats_line, load_dump
from rabit_tpu_torch.obs.metrics import Histogram, MetricsRegistry
from rabit_tpu_torch.profile import CollectiveStats


# -- flight recorder ---------------------------------------------------------

def test_ring_buffer_eviction():
    rec = FlightRecorder(capacity=4)
    for i in range(10):
        rec.record("tick", i=i)
    assert [e.fields["i"] for e in rec.snapshot()] == [6, 7, 8, 9]  # newest kept
    assert rec.dropped == 6


def test_ring_buffer_resize_keeps_newest():
    rec = FlightRecorder(capacity=8)
    for i in range(8):
        rec.record("tick", i=i)
    rec.set_capacity(3)
    assert [e.fields["i"] for e in rec.snapshot()] == [5, 6, 7]
    assert rec.capacity == 3 and rec.dropped == 5
    assert events.DEFAULT_CAPACITY == jevents.DEFAULT_CAPACITY == 2048


@pytest.mark.parametrize("field", ["ts", "kind"])
def test_reserved_field_names_rejected(field):
    with pytest.raises(ValueError):
        FlightRecorder().record("bad", **{field: 1.0})


def test_event_jsonl_round_trip(tmp_path):
    rec = FlightRecorder(capacity=16)
    rec.record("op_begin", op="allreduce", nbytes=4096, cache_key="f.py::12::train")
    rec.record("op_end", op="allreduce", nbytes=4096, seconds=0.0123)
    rec.record("checkpoint_commit", version=3)
    path = rec.dump(tmp_path / "flight.jsonl", header={"rank": 2})
    evs = load_dump(path)
    assert evs[0].kind == "flight_dump"
    assert evs[0].fields["rank"] == 2 and evs[0].fields["n_events"] == 3
    body = evs[1:]
    assert [e.kind for e in body] == ["op_begin", "op_end", "checkpoint_commit"]
    assert body[0].fields["cache_key"] == "f.py::12::train"
    assert body[1].fields["seconds"] == 0.0123
    assert body[2].fields["version"] == 3
    with open(path) as f:  # every line is JSON of its own
        for line in f:
            obj = json.loads(line)
            assert "ts" in obj and "kind" in obj


def test_event_round_trip_identity():
    ev = Event(12.5, "wave", {"epoch": 1, "recovering": ["2"]})
    back = Event.from_json(ev.to_json())
    assert (back.kind, back.ts, back.fields) == ("wave", 12.5, {"epoch": 1, "recovering": ["2"]})


def test_recorder_thread_safety():
    rec = FlightRecorder(capacity=128)

    def spin(tid):
        for i in range(500):
            rec.record("tick", tid=tid, i=i)

    threads = [threading.Thread(target=spin, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(rec.snapshot()) == 128
    assert rec.dropped == 8 * 500 - 128


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dump_loads_across_packages(tmp_path, writer):
    """A dump written by either package loads in the other with the same
    events (header included)."""
    rec = FlightRecorder(capacity=8) if writer == "port" else jevents.FlightRecorder(capacity=8)
    for i in range(11):
        rec.record("op_begin", op="allreduce", nbytes=8 * i, cache_key=f"k{i}",
                   version=i // 4, seqno=i % 4)
    rec.record("hang_detected", op="allreduce", cache_key=None, stuck_seconds=1.25)
    path = rec.dump(tmp_path / "flight.jsonl", header={"reason": "hang", "rank": 1})
    mine, theirs = load_dump(path), jevents.load_dump(path)
    assert [(e.ts, e.kind, e.fields) for e in mine] == [(e.ts, e.kind, e.fields) for e in theirs]
    assert mine[0].fields["dropped"] == 4 and mine[0].fields["n_events"] == 8
    assert [e.kind for e in mine[1:]] == ["op_begin"] * 7 + ["hang_detected"]


# -- stats-line bridge -------------------------------------------------------

STATS_LINES = [
    "[3] recover_stats version=2 summary_rounds=4 table_rounds=2 serve_bytes=1048576 "
    "summary_depth=8 table_hops=14",
    "[1] failure_detected at=171.250000",
    "[0] recover_stats_final summary_rounds=10 table_rounds=0 summary_depth=20 table_hops=0",
    "[2] recovered_at=12.5 version=3",
    "[0] resumed from disk at version 7",
    "[1] slow_link src=0 dst=1 wait=0.25 share=0.4 ts=3.5",
    "[0] all 3 iterations verified",
    "no prefix recover_stats version=1 x=abc",
]


def test_event_from_stats_line():
    ev = event_from_stats_line(STATS_LINES[0])
    assert ev is not None and ev.kind == "recover_stats"
    assert ev.fields["rank"] == 3 and ev.fields["version"] == 2
    assert ev.fields["serve_bytes"] == 1048576
    detected = event_from_stats_line(STATS_LINES[1])
    assert detected.kind == "failure_detected" and detected.fields["at"] == pytest.approx(171.25)
    assert event_from_stats_line(STATS_LINES[2]).kind == "recover_stats_final"
    assert event_from_stats_line("[0] all 3 iterations verified") is None


@pytest.mark.parametrize("line", STATS_LINES)
def test_event_from_stats_line_matches_jax(line):
    mine, theirs = event_from_stats_line(line, ts=5.0), jevents.event_from_stats_line(line, ts=5.0)
    if theirs is None:
        assert mine is None
        return
    assert (mine.ts, mine.kind, mine.fields) == (theirs.ts, theirs.kind, theirs.fields)
    assert events.parse_stats_line(line) == jevents.parse_stats_line(line)


# -- histogram ---------------------------------------------------------------

def test_histogram_percentiles_deterministic():
    h = Histogram(buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 3.0, 7.0):
        h.observe(v)
    assert h.percentile(50) == 4.0   # the 2nd of 3 lands in (2, 4]
    assert h.percentile(99) == 7.0   # bound 8 clamped to the observed max
    assert h.percentile(1) == 1.0    # the first bucket's bound, above the min
    snap = h.snapshot()
    assert snap["count"] == 3 and snap["min"] == 0.5 and snap["max"] == 7.0
    assert snap["p50"] == 4.0 and snap["p99"] == 7.0


def test_histogram_overflow_bucket():
    h = Histogram(buckets=(1.0,))
    h.observe(100.0)
    assert h.percentile(50) == 100.0  # the overflow bucket reports the max


def test_histogram_empty():
    h = Histogram()
    assert h.percentile(99) == 0.0
    assert h.snapshot() == {"count": 0, "sum": 0.0}


def test_histogram_rejects_unsorted_buckets():
    with pytest.raises(ValueError):
        Histogram(buckets=(2.0, 1.0))


def test_default_buckets_match_jax():
    assert metrics.DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS


# -- registry ----------------------------------------------------------------

def test_registry_counters_gauges():
    reg = MetricsRegistry()
    reg.counter("restarts_total").inc()
    reg.counter("restarts_total").inc(2)
    reg.gauge("version").set(7)
    snap = reg.snapshot()
    assert snap["counters"]["restarts_total"] == 3
    assert snap["gauges"]["version"] == 7.0


def test_registry_timed_span_nbytes_update():
    reg = MetricsRegistry()
    with reg.timed("broadcast", 0) as span:
        span.nbytes = 4096  # a non-root learns the length inside the window
    assert reg.ops["broadcast"].nbytes == 4096
    assert reg.snapshot()["histograms"]["broadcast_latency_seconds"]["count"] == 1


def test_registry_thread_safety():
    reg = MetricsRegistry()

    def spin():
        for _ in range(300):
            reg.observe_op("allreduce", 8, 0.001)
            reg.counter("c").inc()

    threads = [threading.Thread(target=spin) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.ops["allreduce"].calls == 8 * 300
    assert reg.counter("c").value == 8 * 300
    assert reg.snapshot()["histograms"]["allreduce_latency_seconds"]["count"] == 8 * 300


def seeded_calls(reg, seed: int) -> None:
    """A seeded sequence of every kind of registry call."""
    rng = np.random.RandomState(seed)
    ops = ("allreduce", "broadcast", "allgather")
    for _ in range(400):
        what = rng.randint(5)
        if what == 0:
            reg.observe_op(ops[rng.randint(3)], int(rng.randint(1 << 20)),
                           float(10.0 ** rng.uniform(-7, 2)))
        elif what == 1:
            reg.counter(f"c{rng.randint(4)}").inc(int(rng.randint(1, 100)))
        elif what == 2:
            reg.gauge(f"g{rng.randint(3)}").set(float(rng.randn()))
        elif what == 3:
            reg.histogram(f"h{rng.randint(3)}").observe(float(10.0 ** rng.uniform(-8, 3)))
        else:
            reg.histogram("coarse", buckets=(0.5, 1.0, 4.0)).observe(float(rng.uniform(0, 8)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_equals_jax(seed):
    mine, theirs = MetricsRegistry(), jmetrics.MetricsRegistry()
    seeded_calls(mine, seed)
    seeded_calls(theirs, seed)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.raw_state() == theirs.raw_state()
    assert mine.report() == theirs.report()
    json.dumps(mine.snapshot())  # JSON-able


def test_stream_deltas_and_rollup_equal_jax():
    """Successive deltas of the same registry calls, folded into each
    package's rollup, render equal documents and reconcile with the
    cumulative counters."""
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    srcs = (stream.DeltaSource(regs[0]), jstream.DeltaSource(regs[1]))
    rolls = (stream.StreamRollup(), jstream.StreamRollup())
    for window in range(4):
        for reg, mod in zip(regs, (stream, jstream)):
            seeded_calls(reg, 10 + window)
            mod.stream_count("wire_bytes", 100 * window, registry=reg, codec="i8", fused=1)
        deltas = [s.take() for s in srcs]
        assert deltas[0] == deltas[1]
        for roll, d in zip(rolls, deltas):
            roll.fold(window % 2, d, ts=1.0)
    assert [s.take() for s in srcs] == [None, None]  # nothing new
    assert rolls[0].render() == rolls[1].render()
    total = rolls[0].render()["total"]["counters"]
    assert total == dict(sorted(regs[0].raw_state()["counters"].items()))
    assert stream.series_name("wire_bytes", fused=1, codec="i8") == "wire_bytes{codec=i8,fused=1}"


# -- facade and api ----------------------------------------------------------

def test_collective_stats_facade_shares_global_registry():
    profile.GLOBAL_STATS.reset()
    obs.get_recorder().clear()
    api.init(["rabit_engine=empty"])
    api.allreduce(np.arange(10, dtype=np.float32), api.SUM)
    api.broadcast({"x": 1}, 0)
    api.finalize()
    s = profile.GLOBAL_STATS
    assert s.registry is obs.get_registry()
    assert s.ops["allreduce"].calls == 1 and s.ops["broadcast"].calls == 1
    hists = obs.get_registry().snapshot()["histograms"]
    assert hists["broadcast_latency_seconds"]["count"] == 1
    assert hists["allreduce_latency_seconds"]["count"] == 1
    assert "allreduce:" in s.report()


def test_private_collective_stats_isolated():
    s = CollectiveStats()
    with s.timed("allgather", 64):
        pass
    assert s.ops["allgather"].calls == 1
    assert "allgather" not in obs.get_registry().snapshot()["counters"]


def test_api_records_flight_events():
    obs.get_recorder().clear()
    profile.GLOBAL_STATS.reset()
    api.init(["rabit_engine=empty"])
    api.allreduce(np.arange(4, dtype=np.float32), api.SUM)
    api.checkpoint({"m": 1})
    api.finalize()
    recorded = obs.get_recorder().snapshot()
    kinds = [e.kind for e in recorded]
    assert "engine_ready" in kinds and "op_begin" in kinds and "op_end" in kinds
    assert "checkpoint_commit" in kinds and kinds[-1] == "engine_finalize"
    begin = next(e for e in recorded if e.kind == "op_begin")
    assert begin.fields["op"] == "allreduce" and begin.fields["nbytes"] == 16
    assert "cache_key" in begin.fields
    assert obs.get_registry().snapshot()["counters"]["checkpoint_commits_total"] == 1


def user_program(pkg, recorder) -> list[tuple]:
    """One program through either package's api on its solo engine: the
    recorded event kinds with their (version, seqno, op, nbytes)."""
    recorder.clear()
    pkg.init(["rabit_engine=empty"])
    version, _ = pkg.load_checkpoint()
    for it in range(3):
        pkg.allreduce(np.arange(6, dtype=np.float64) + it, pkg.MAX)
        pkg.broadcast({"it": it, "pad": "x" * it}, 0)
        pkg.allgather(np.arange(3, dtype=np.int32))
        pkg.allreduce(np.ones(2048, np.float32), pkg.SUM, codec="bf16")
        pkg.checkpoint({"m": it})
    pkg.finalize()
    keys = ("version", "seqno", "op", "nbytes", "codec", "recovered")
    return [(e.kind, {k: e.fields[k] for k in keys if k in e.fields})
            for e in recorder.snapshot()]


def test_api_event_sequence_equals_jax():
    mine = user_program(api, obs.get_recorder())
    theirs = user_program(rt, jobs.get_recorder())
    # the port's compress event has no JAX counterpart kind; the registry
    # holds what JAX's observe records (test_torch_codecs)
    assert [m for m in mine if m[0] != "compress"] == theirs
    stamps = [(f["version"], f["seqno"]) for k, f in mine if k == "op_begin"]
    assert stamps == [(v, s) for v in range(3) for s in range(4)]


# -- the process singletons: watchdog, spill and retention -------------------

@pytest.fixture
def configured(tmp_path):
    """obs configured with an obs dir for one test, reset after it."""
    from rabit_tpu_torch.config import Config

    def configure(*args: str) -> None:
        obs.configure(Config([f"rabit_obs_dir={tmp_path}", *args]), rank=3)

    obs.get_recorder().clear()
    yield configure
    obs.stop_heartbeat()
    obs.configure(Config(["rabit_obs_dir=NULL"]), rank=-1)


def wait_for(cond, timeout: float) -> bool:
    import time

    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def test_watchdog_declares_a_slow_collective_then_releases_it(configured, tmp_path):
    """A collective in flight past rabit_obs_hang_sec is declared hung: one
    -hang dump names it in flight, and lease renewals are withheld until
    the tracker's lease lapses.  When it completes the declaration is
    released (hang_recovered) and the renewals resume."""
    from rabit_tpu_torch.tracker.tracker import Tracker

    tracker = Tracker(1, quiet=True).start()
    try:
        configured("rabit_obs_hang_sec=0.3", f"rabit_tracker_uri={tracker.host}",
                   f"rabit_tracker_port={tracker.port}", "rabit_task_id=7",
                   "rabit_heartbeat_sec=0.5")
        assert wait_for(lambda: tracker.live_tasks() == ["7"], 5.0)
        with obs.collective("allreduce", 64, cache_key="k"):
            assert wait_for(lambda: list(tmp_path.glob("flight-rank3-*-hang.jsonl")), 5.0)
            assert wait_for(lambda: tracker.live_tasks() == [], 5.0)  # renewals withheld
        assert wait_for(lambda: not obs._STATE.hang_dumped, 5.0)
        assert wait_for(lambda: tracker.live_tasks() == ["7"], 5.0)  # and resumed
    finally:
        tracker.stop()
    kinds = [e.kind for e in obs.get_recorder().snapshot()]
    assert kinds.count("hang_detected") == 1 and "hang_recovered" in kinds
    assert [e["task_id"] for e in tracker.events if e["kind"] == "lease_expired"] == ["7"]
    dump = load_dump(next(tmp_path.glob("flight-rank3-*-hang.jsonl")))
    assert dump[0].fields["reason"] == "hang" and dump[0].fields["rank"] == 3
    stuck = [e for e in dump if e.kind == "op_inflight"]
    assert [(e.fields["op"], e.fields["cache_key"]) for e in stuck] == [("allreduce", "k")]


def test_spill_ticker_keeps_the_newest_dumps(configured, tmp_path):
    """rabit_obs_spill_sec spills the ring periodically; retention keeps
    rabit_obs_max_files dumps, the oldest evicted first."""
    configured("rabit_obs_spill_sec=0.05", "rabit_obs_max_files=3")
    assert wait_for(lambda: any(e.kind == "obs_evicted" for e in obs.get_recorder().snapshot()),
                    5.0)
    obs.stop_heartbeat()
    names = sorted(tmp_path.glob("flight-*-spill.jsonl"))
    assert 1 <= len(names) <= 3
    seqs = sorted(int(p.name.split("-n")[1].split("-")[0]) for p in names)
    assert seqs == list(range(seqs[-1] - len(seqs) + 1, seqs[-1] + 1)) and seqs[0] > 1
