"""The live telemetry plane on the port: the counterpart of
tests/test_obs_stream.py, the same asserts against ``rabit_tpu_torch``'s
obs stream, delta frames, relay, tracker, service, trace export and top:
series names, exactly-once delta extraction, relay coalescing against a
direct connection, the CMD_OBS scrape of a tracker and of a service
reconciled with the telemetry written after the job, follow-mode export
of a torn dump, and flight-dump retention.

tests/test_obs_stream.py's ``test_export_follow_grows_then_finalizes`` has
its counterpart in tests/test_torch_trace.py under the same name.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time

import pytest

from rabit_tpu_torch import obs
from rabit_tpu_torch.obs import stream
from rabit_tpu_torch.obs import trace
from rabit_tpu_torch.obs.events import Event
from rabit_tpu_torch.obs.metrics import MetricsRegistry
from rabit_tpu_torch.obs.top import render, scrape
from rabit_tpu_torch.relay import Relay
from rabit_tpu_torch.service import CollectiveService
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker


def canon(doc) -> str:
    return json.dumps(doc, sort_keys=True)


def make_registry(wire_i8=0, wire_topk_fused=0, waits=()) -> MetricsRegistry:
    reg = MetricsRegistry()
    if wire_i8:
        stream.stream_count("wire_bytes", wire_i8, registry=reg,
                            codec="i8", fused=0)
        stream.stream_count("raw_bytes", 4 * wire_i8, registry=reg,
                            codec="i8", fused=0)
    if wire_topk_fused:
        stream.stream_count("wire_bytes", wire_topk_fused, registry=reg,
                            codec="topk", fused=1)
    for w in waits:
        stream.stream_observe("link_wait_seconds", w, registry=reg,
                              src=0, dst=1)
    return reg


# -- series names -------------------------------------------------------------

def test_series_name_parse_round_trip():
    s = stream.series_name("wire_bytes", codec="i8", fused=1)
    assert s == "wire_bytes{codec=i8,fused=1}"
    assert stream.parse_series(s) == ("wire_bytes",
                                      {"codec": "i8", "fused": "1"})
    assert stream.parse_series("plain") == ("plain", {})


# -- delta math ---------------------------------------------------------------

def test_diff_then_merge_reconstructs_cumulative_state():
    """The reconciliation identity: folding every window delta from a
    zero baseline reproduces the cumulative raw state byte-for-byte."""
    reg = make_registry(wire_i8=1000, waits=[0.01, 0.02])
    prev = reg.raw_state()
    d1 = stream.diff_state(prev, None)
    stream.stream_count("wire_bytes", 500, registry=reg, codec="i8",
                        fused=0)
    stream.stream_observe("link_wait_seconds", 0.5, registry=reg,
                          src=0, dst=1)
    d2 = stream.diff_state(reg.raw_state(), prev)
    acc = stream.merge_state(stream.empty_state(), d1)
    stream.merge_state(acc, d2)
    assert canon(acc) == canon(reg.raw_state())
    # unchanged counters are omitted from the window
    assert "raw_bytes{codec=i8,fused=0}" not in d2["counters"]


def test_delta_source_exactly_once():
    reg = make_registry()
    src = stream.DeltaSource(reg)
    assert src.take() is None  # idle registry: nothing to ship
    stream.stream_count("wire_bytes", 100, registry=reg, codec="i8",
                        fused=0)
    d1 = src.take()
    assert d1["counters"] == {"wire_bytes{codec=i8,fused=0}": 100}
    assert src.take() is None  # window already shipped
    stream.stream_count("wire_bytes", 50, registry=reg, codec="i8",
                        fused=0)
    d2 = src.take()
    assert d2["counters"] == {"wire_bytes{codec=i8,fused=0}": 50}
    # fold-of-deltas == cumulative
    acc = stream.merge_state(stream.empty_state(), d1)
    stream.merge_state(acc, d2)
    assert canon(acc) == canon(reg.raw_state())


def test_histogram_delta_min_max_fold_monotone():
    reg = MetricsRegistry()
    src = stream.DeltaSource(reg)
    stream.stream_observe("link_wait_seconds", 0.5, registry=reg,
                          src=0, dst=1)
    d1 = src.take()
    stream.stream_observe("link_wait_seconds", 0.1, registry=reg,
                          src=0, dst=1)
    stream.stream_observe("link_wait_seconds", 0.9, registry=reg,
                          src=0, dst=1)
    d2 = src.take()
    acc = stream.merge_state(stream.empty_state(), d1)
    stream.merge_state(acc, d2)
    h = acc["histograms"]["link_wait_seconds{dst=1,src=0}"]
    assert h["count"] == 3
    assert h["min"] == pytest.approx(0.1)
    assert h["max"] == pytest.approx(0.9)
    assert h["sum"] == pytest.approx(1.5)
    summary = stream.summarize_histogram(h)
    assert summary["count"] == 3
    assert 0.1 <= summary["p50"] <= 0.9


def test_wire_bytes_by_codec_split():
    reg = make_registry(wire_i8=1500, wire_topk_fused=2000)
    rolled = stream.StreamRollup()
    rolled.fold(0, stream.diff_state(reg.raw_state(), None))
    split = stream.wire_bytes_by_codec(rolled.render()["total"])
    assert split == {"i8": 1500, "topk:fused": 2000}


# -- delta wire frames --------------------------------------------------------

def test_delta_frame_round_trip():
    doc = stream.delta_doc("ja", 3, {"counters": {"x": 1},
                                     "histograms": {}})
    frame = P.put_delta_frame(doc)
    assert P.delta_frame_from_bytes(frame) == doc
    # canonical: same doc -> same bytes
    assert frame == P.put_delta_frame(json.loads(canon(doc)))


def test_delta_frame_torn_and_corrupt():
    frame = P.put_delta_frame(stream.delta_doc("j", 0,
                                               {"counters": {"a": 2},
                                                "histograms": {}}))
    for torn in (frame[:3], frame[:8], frame[:-1]):
        with pytest.raises(ValueError):
            P.delta_frame_from_bytes(torn)
    with pytest.raises(ValueError):
        P.delta_frame_from_bytes(b"\x00\x00\x00\x00" + frame[4:])  # magic
    # declared length beyond the payload: torn
    with pytest.raises(ValueError):
        P.delta_frame_from_bytes(frame + b"junk")
    # valid frame, garbage zlib payload
    bad = frame[:4] + P.put_u32(4) + b"notz"
    with pytest.raises(ValueError):
        P.delta_frame_from_bytes(bad)


def test_read_delta_frame_over_socket():
    doc = stream.delta_doc("ja", 1, {"counters": {"wire": 9},
                                     "histograms": {}})
    a, b = socket.socketpair()
    try:
        a.sendall(P.put_delta_frame(doc))
        assert P.read_delta_frame(b) == doc
    finally:
        a.close()
        b.close()


# -- rollup + relay coalesce vs direct oracle --------------------------------

def _windows(job: str, rank: int, counts: list[int]) -> list[dict]:
    """One delta doc per activity window for one rank."""
    reg = MetricsRegistry()
    src = stream.DeltaSource(reg)
    out = []
    for n in counts:
        stream.stream_count("wire_bytes", n, registry=reg, codec="i8",
                            fused=0)
        stream.stream_observe("link_wait_seconds", n / 1e4, registry=reg,
                              src=(rank - 1) % 2, dst=rank)
        out.append(stream.delta_doc(job, rank, src.take()))
    return out


def test_relay_coalesce_equals_direct_fold():
    """Sum/merge coalescing at the relay loses no information: folding
    ONE coalesced per-job frame gives the same rollup as folding every
    window directly (the direct-connection oracle) — n_folds aside."""
    windows = _windows("ja", 0, [100, 250]) + _windows("ja", 1, [70, 30])

    direct = stream.StreamRollup()  # oracle: every window, one by one
    for doc in windows:
        for rank, delta in doc["ranks"].items():
            direct.fold(rank, delta)

    acc = None  # relay: coalesce per flush, then fold once
    for doc in windows:
        acc = stream.merge_delta_doc(acc, doc)
    coalesced = stream.StreamRollup()
    for rank, delta in acc["ranks"].items():
        coalesced.fold(rank, delta)

    a, b = direct.render(), coalesced.render()
    assert a["n_folds"] == 4 and b["n_folds"] == 2
    for key in ("total", "per_rank", "links"):
        assert canon(a[key]) == canon(b[key])
    assert stream.wire_bytes_by_codec(b["total"]) == {"i8": 450}


# -- tracker scrape RPC -------------------------------------------------------

def _ship_snapshot(addr, task_id, rank, delta, job=""):
    snap = {"schema": 1, "rank": rank, "task_id": task_id,
            "counters": {}, "histograms": {}, "delta": delta}
    ack = P.tracker_rpc(addr[0], addr[1], P.CMD_METRICS, task_id,
                        message=json.dumps(snap), timeout=5.0,
                        retries=1, job=job)
    assert ack == P.ACK


def test_tracker_scrape_live_and_telemetry_reconcile():
    """One plain tracker: CMD_OBS answers live with the folded rollup,
    scrape evidence lands once, and the shutdown telemetry's stream
    section is byte-for-byte the last live scrape's rollup."""
    tracker = Tracker(world_size=2, quiet=True).start()
    try:
        reg = make_registry(wire_i8=1000, waits=[0.01])
        src = stream.DeltaSource(reg)
        _ship_snapshot((tracker.host, tracker.port), "0", 0, src.take())
        stream.stream_count("wire_bytes", 500, registry=reg, codec="i8",
                            fused=0)
        _ship_snapshot((tracker.host, tracker.port), "0", 0, src.take())

        doc = scrape(tracker.host, tracker.port, registry=True)
        assert doc["schema"] == stream.STREAM_SCHEMA
        assert "registry" in doc
        job = doc["jobs"][""]
        rolled = job["stream"]
        assert rolled["n_folds"] == 2
        total = rolled["total"]["counters"]
        assert total["wire_bytes{codec=i8,fused=0}"] == 1500
        assert canon(rolled["total"]) == canon(rolled["per_rank"]["0"])
        assert job["world"] == 2 and job["leases"] == 0

        # second scrape (registry skipped) — still ONE obs_scrape event
        slim = scrape(tracker.host, tracker.port, registry=False)
        assert "registry" not in slim
        assert tracker.serve_stats["obs_scrapes"] == 2
        kinds = [e["kind"] for e in tracker.events]
        assert kinds.count("obs_scrape") == 1
        assert kinds.count("metrics_delta_folded") == 1

        live_stream = slim["jobs"][""]["stream"]
        tele = tracker.build_telemetry()
        assert canon(tele["stream"]) == canon(live_stream)
    finally:
        tracker.stop()


def _raw_bootstrap(addr, job, task, listen_port):
    with socket.create_connection(addr, timeout=10) as s:
        P.send_hello(s, P.CMD_START, task, listen_port=listen_port, job=job)
        s.settimeout(10)
        while True:
            try:
                if not s.recv(65536):
                    break
            except OSError:
                break


def test_service_scrape_tenants_match_posthoc_telemetry(tmp_path):
    """The acceptance e2e: two tenants' jobs live on one service; a live
    CMD_OBS scrape shows the per-tenant wire_bytes split, and the stream
    rollup it returns is byte-for-byte the one the per-job telemetry
    files record at retirement."""
    obs_dir = str(tmp_path / "obs")
    svc = CollectiveService(quiet=True, obs_dir=obs_dir).start()
    addr = (svc.host, svc.port)
    expected_split = {}
    try:
        svc.admit("ta.j1", 1)
        svc.admit("tb.j2", 1)
        boots = [threading.Thread(
            target=_raw_bootstrap, args=(addr, job, "0", 6200 + i),
            daemon=True) for i, job in enumerate(("ta.j1", "tb.j2"))]
        for t in boots:
            t.start()
        for t in boots:
            t.join(timeout=15)

        regs = {"ta.j1": make_registry(wire_i8=1000),
                "tb.j2": make_registry(wire_topk_fused=2000, waits=[0.02])}
        srcs = {k: stream.DeltaSource(r) for k, r in regs.items()}
        for key in regs:
            _ship_snapshot(addr, "0", 0, srcs[key].take(), job=key)
        stream.stream_count("wire_bytes", 500, registry=regs["ta.j1"],
                            codec="i8", fused=0)
        _ship_snapshot(addr, "0", 0, srcs["ta.j1"].take(), job="ta.j1")
        expected_split = {"ta": {"i8": 1500}, "tb": {"topk:fused": 2000}}

        live = scrape(svc.host, svc.port)
        assert sorted(live["tenants"]) == ["ta", "tb"]
        for tenant, split in expected_split.items():
            tdoc = live["tenants"][tenant]
            assert tdoc["wire_bytes"] == split
            assert tdoc["wire_bytes_total"] == sum(split.values())
        assert live["service"]["live"] == ["ta.j1", "tb.j2"]
        live_streams = {
            key: live["tenants"][t]["jobs"][key]["stream"]
            for t, key in (("ta", "ta.j1"), ("tb", "tb.j2"))}

        # a job-prefixed scrape routes to that partition's view
        part_doc = scrape(svc.host, svc.port, job="ta.j1")
        assert canon(part_doc["jobs"]["ta.j1"]["stream"]) == \
            canon(live_streams["ta.j1"])

        # retire both jobs; their telemetry files must carry the SAME
        # rollup the live scrape returned — byte-for-byte
        for key in ("ta.j1", "tb.j2"):
            part = svc.partition(key)
            P.tracker_rpc(addr[0], addr[1], P.CMD_SHUTDOWN, "0",
                          timeout=5.0, retries=1, job=key)
            assert part.wait(10), key
        deadline = time.monotonic() + 5
        while svc.live_jobs() and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        svc.stop()
    for key in ("ta.j1", "tb.j2"):
        with open(os.path.join(obs_dir, f"telemetry-{key}.json")) as f:
            tele = json.load(f)
        assert canon(tele["stream"]) == canon(live_streams[key]), key
    # per-tenant accounting recomputable from the persisted rollup
    assert stream.wire_bytes_by_codec(
        tele["stream"]["total"]) == expected_split["tb"]


def test_relay_coalesced_deltas_reach_service_rollup():
    """Deltas shipped THROUGH a relay (stripped from the snapshot,
    coalesced per job, folded from the CMD_OBS batch frame) land in the
    same rollup totals as shipping the same windows directly."""
    svc = CollectiveService(quiet=True).start()
    oracle = CollectiveService(quiet=True).start()
    relay = Relay((svc.host, svc.port), relay_id="r0",
                  flush_sec=0.05).start()
    try:
        svc.admit("ja", 2)
        oracle.admit("ja", 2)
        windows = _windows("ja", 0, [100, 250]) + _windows("ja", 1, [60])
        for doc in windows:
            for rank, delta in doc["ranks"].items():
                _ship_snapshot((relay.host, relay.port), rank, int(rank),
                               delta, job="ja")
                _ship_snapshot((oracle.host, oracle.port), rank,
                               int(rank), delta, job="ja")
        part, opart = svc.partition("ja"), oracle.partition("ja")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if part._stream.render()["n_folds"] and \
                    stream.wire_bytes_by_codec(
                        part._stream.render()["total"]) == {"i8": 410}:
                break
            time.sleep(0.05)
        got, want = part._stream.render(), opart._stream.render()
        for key in ("total", "per_rank", "links"):
            assert canon(got[key]) == canon(want[key])
        # the snapshot the relay forwarded upstream was stripped of the
        # delta: stored per-rank snapshots carry no "delta" key
        assert all("delta" not in s for s in part.snapshots.values())
    finally:
        relay.stop()
        svc.stop()
        oracle.stop()


# -- follow-mode export -------------------------------------------------------

def _spill_dump(obs_dir, rank, seq, events):
    path = os.path.join(
        obs_dir, f"flight-rank{rank}-pid{100 + rank}-n{seq}-spill.jsonl")
    header = Event(9.0, "flight_dump",
                   {"rank": rank, "reason": "spill", "pid": 100 + rank,
                    "n_events": len(events), "dropped": 0})
    with open(path, "w") as f:
        f.write(header.to_json() + "\n")
        for ts, kind, fields in events:
            f.write(Event(ts, kind, dict(fields)).to_json() + "\n")
    return path


def test_export_follow_tolerates_torn_dump(tmp_path):
    obs_dir = str(tmp_path)
    _spill_dump(obs_dir, 0, 1, [
        (1.0, "op_begin", dict(op="bcast", version=0, seqno=0)),
    ])
    with open(os.path.join(obs_dir, "flight-rank1-pid7-n1-spill.jsonl"),
              "w") as f:
        f.write('{"ts": 1.0, "kind": "torn')  # mid-write
    doc, _path, _report, rounds = trace.export_follow(
        obs_dir, interval=0.05, max_rounds=1)
    assert rounds == 1
    assert doc["otherData"]["ranks"] == [0]  # torn dump skipped
    # the strict loader still refuses it
    with pytest.raises(trace.TraceError):
        trace.load_job(obs_dir)


# -- flight-dump retention ----------------------------------------------------

def test_flight_dump_retention_evicts_oldest(tmp_path):
    obs_dir = str(tmp_path)
    paths = []
    for i in range(6):
        p = os.path.join(obs_dir, f"flight-rank0-pid9-n{i}-spill.jsonl")
        with open(p, "w") as f:
            f.write("{}\n")
        os.utime(p, (1000.0 + i, 1000.0 + i))
        paths.append(p)
    with open(os.path.join(obs_dir, "telemetry.json"), "w") as f:
        f.write("{}")  # non-flight files are never candidates
    assert obs._evict_flight_dumps(obs_dir, 4) == 2
    left = sorted(n for n in os.listdir(obs_dir)
                  if n.startswith("flight-"))
    assert left == [os.path.basename(p) for p in paths[2:]]
    assert os.path.exists(os.path.join(obs_dir, "telemetry.json"))
    # under the cap: no-op; cap 0 disables eviction
    assert obs._evict_flight_dumps(obs_dir, 4) == 0
    assert obs._evict_flight_dumps(obs_dir, 0) == 0
    evicted = [e for e in obs.GLOBAL_RECORDER.snapshot()
               if e.kind == "obs_evicted"]
    assert evicted and evicted[-1].fields["n"] == 2


# -- obs_top rendering --------------------------------------------------------

def test_top_render_is_pure_and_shows_cadence():
    base = {"schema": 1, "ts": 100.0, "started_at": 40.0,
            "serving": {"reactor": True, "accepts": 3, "rpcs": 7,
                        "obs_scrapes": 1},
            "jobs": {"": {"epoch": 0, "world": 2, "leases": 2,
                          "pending": 0, "restarts": 0,
                          "stream": {"n_folds": 2, "last_fold_ts": 99.0,
                                     "total": {"counters": {
                                         "wire_bytes{codec=i8,fused=0}":
                                             2048},
                                         "histograms": {}},
                                     "links": [{"src": "0", "dst": "1",
                                                "count": 4, "p50": 0.001,
                                                "p99": 0.01, "sum": 0.02}],
                                     "per_rank": {}}}}}
    prev = json.loads(json.dumps(base))
    prev["ts"] = 98.0
    prev["jobs"][""]["stream"]["n_folds"] = 0
    prev["jobs"][""]["stream"]["total"]["counters"] = {}
    frame = render(base, prev)
    assert "rabit-top" in frame and "1.0KiB/s" in frame
    assert "link 0->1" in frame and "p99=10.00ms" in frame
    assert render(base, prev) == frame  # pure
