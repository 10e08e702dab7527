"""The port tracker's live scrape, diagnosis tick and schedule repair,
against rabit_tpu's tracker.

* The counterpart of tests/test_diagnose.py's
  ``test_tracker_diag_tick_opens_and_scrape_serves_incident``: concentrated
  link waits shipped to the port's tracker open a degraded-link incident on
  its lease thread, which the ``CMD_OBS`` scrape serves.
* Scrapes across packages: rabit_tpu's ``obs.top.scrape`` reads the
  port's tracker and the port's reads rabit_tpu's, with the same sections
  and keys; ``obs.top.render`` gives the same frame in both packages; the
  ``obs_scrape`` event is recorded once; ``python -m
  rabit_tpu_torch.obs.top`` polls a live tracker.
* telemetry.json's keys differ from rabit_tpu's only by the 8 of the
  planes not ported (quorum, relays, serving).
* One scripted job on both trackers: an origin-stamped ``slow_link`` print
  flags the link, the ``epoch`` reply asks for a wave, and the wave's
  Assignments carry the same repaired ring; ``sched_repair=False`` keeps
  the plan; ``tools/torch_trace_tool.py report --flag-links`` arms the
  repair of a live tracker.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from rabit_tpu.obs import top as jtop
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch.obs import stream
from rabit_tpu_torch.obs import top
from rabit_tpu_torch.obs.diagnose import DIAG_SCHEMA
from rabit_tpu_torch.obs.metrics import MetricsRegistry
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_trace_tool  # noqa: E402

sys.path.pop(0)


def ship_waits(addr, src, waits, reg, rank=1):
    for w in waits:
        stream.stream_observe("link_wait_seconds", w, registry=reg, src=0, dst=1)
    snap = {"schema": 1, "rank": rank, "task_id": str(rank), "counters": {},
            "histograms": {}, "delta": src.take()}
    assert P.tracker_rpc(addr[0], addr[1], P.CMD_METRICS, str(rank), message=json.dumps(snap),
                         timeout=5.0, retries=1) == P.ACK


def test_tracker_diag_tick_opens_and_scrape_serves_incident(monkeypatch):
    monkeypatch.setenv("RABIT_TPU_RABIT_DIAG_WINDOW_SEC", "0.1")
    tracker = Tracker(world_size=2, quiet=True).start()
    try:
        reg = MetricsRegistry()
        src = stream.DeltaSource(reg)
        deadline = time.monotonic() + 15
        doc = None
        while time.monotonic() < deadline:
            ship_waits((tracker.host, tracker.port), src, [0.2, 0.2], reg)
            doc = top.scrape(tracker.host, tracker.port, registry=False)
            if doc["incidents"]["n_open"]:
                break
            time.sleep(0.15)
        assert doc is not None and doc["incidents"]["n_open"] == 1
        inc = doc["incidents"]["open"][0]
        assert inc["class"] == "degraded-link" and inc["subject"] == {"src": 0, "dst": 1}
        assert inc["job"] == ""
        jdoc = doc["jobs"][""]["incidents"]
        assert jdoc["schema"] == DIAG_SCHEMA and jdoc["n_opened"] == 1
        assert [e["kind"] for e in tracker.events].count("incident_opened") == 1
        # a degraded-link incident flags its link; the world's rank map is
        # still empty (no wave), so no task pair exists to flag yet
        assert doc["jobs"][""]["link_flags"] == 0
        frame = top.render(doc)
        assert "[degraded-link]" in frame and frame == jtop.render(doc)
        assert "registry" not in doc
    finally:
        tracker.stop()
    tele = tracker.telemetry
    assert tele["incidents"]["n_opened"] == 1 and tele["n_schedule_repaired"] == 0


def key_paths(doc, prefix="") -> set:
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("registry", "counters", "histograms", "per_rank"):
            out |= key_paths(v, prefix + k + ".")
    return out


def test_scrape_across_packages():
    port, jax = Tracker(2, quiet=True).start(), JaxTracker(2, quiet=True).start()
    try:
        for tr in (port, jax):  # one delta a tracker, so the rollup has a link
            reg = MetricsRegistry()
            ship_waits((tr.host, tr.port), stream.DeltaSource(reg), [0.01], reg)
        docs = {"jax-reads-port": jtop.scrape(port.host, port.port, registry=True),
                "port-reads-jax": top.scrape(jax.host, jax.port, registry=True),
                "port-reads-port": top.scrape(port.host, port.port),
                "jax-reads-jax": jtop.scrape(jax.host, jax.port)}
    finally:
        port.stop()
        jax.stop()
    assert key_paths(docs["jax-reads-port"]) == key_paths(docs["port-reads-jax"])
    assert key_paths(docs["port-reads-port"]) == key_paths(docs["jax-reads-jax"])
    mine, theirs = docs["jax-reads-port"]["jobs"][""], docs["port-reads-jax"]["jobs"][""]
    for key in ("epoch", "world", "base_world", "quorum_outstanding", "delivery", "link_flags",
                "n_snapshots", "messages_dropped"):
        assert mine[key] == theirs[key], key
    assert mine["stream"]["links"] == theirs["stream"]["links"]
    assert docs["jax-reads-port"]["serving"]["reactor"] is False
    for doc in docs.values():
        assert top.render(doc) == jtop.render(doc)
    assert sum(1 for e in port.events if e["kind"] == "obs_scrape") == 1
    assert port.serve_stats["obs_scrapes"] == 2 and port.serve_stats["accepts"] >= 3


def test_render_equal_to_jax_on_a_full_document():
    """Every pane: service, incidents, codecs, delivery, straggler watch,
    links; and the cadence against a previous poll."""
    def job(wire, folds, ts):
        return {"epoch": 2, "world": 3, "leases": 3, "pending": 1, "restarts": 1,
                "delivery": {"line": {"version": 4, "digest": "ab" * 20, "size": 5000},
                             "snaps": 2, "snap_bytes": 9000, "subscribers": 3},
                "stream": {"n_folds": folds,
                           "total": {"counters": {"wire_bytes{codec=i8,fused=0}": wire,
                                                  "wire_bytes{codec=bf16,fused=1}": 7}},
                           "per_rank": {"1": {"histograms": {
                               "link_wait_seconds{dst=1,src=0}": {"sum": 0.4}}},
                               "2": {"histograms": {
                                   "link_wait_seconds{dst=2,src=1}": {"sum": 1.2}}}},
                           "links": [{"src": "0", "dst": "1", "count": 9, "p50": 0.01,
                                      "p99": 0.2},
                                     {"src": "1", "dst": "2", "count": 9, "p50": 0.1,
                                      "p99": 0.4}]}}
    prev = {"schema": 1, "ts": 100.0, "started_at": 10.0, "jobs": {"": job(1000, 3, 100.0)}}
    doc = {"schema": 1, "ts": 104.0, "started_at": 10.0,
           "serving": {"reactor": True, "accepts": 5, "rpcs": 9, "obs_scrapes": 2},
           "service": {"live": 1, "admitted": 2, "completed": 1, "pool_parked": 0,
                       "auto_world": 0},
           "incidents": {"n_open": 1, "open": [{"class": "degraded-link", "id": "d#1",
                                                "job": "", "subject": {"src": 1, "dst": 2},
                                                "windows": 3}]},
           "jobs": {"": job(5000, 9, 104.0)}}
    for p in (None, prev):
        assert top.render(doc, p) == jtop.render(doc, p)
        assert top.render(doc, p, top_links=1) == jtop.render(doc, p, top_links=1)


JAX_ONLY = {"quorum", "n_quorum_met", "n_corrections_folded", "n_corrections_dropped",
            "quorum_outstanding", "n_relays_up", "n_relays_lost", "serving"}


def test_telemetry_keys_differ_only_by_unported_planes():
    port, jax = Tracker(2, quiet=True), JaxTracker(2, quiet=True)
    try:
        mine, theirs = port.build_telemetry(), jax.build_telemetry()
    finally:
        port.stop()
        jax.stop()
    assert set(theirs) - set(mine) == JAX_ONLY and len(JAX_ONLY) == 8
    assert set(mine) <= set(theirs)
    assert mine["incidents"] == theirs["incidents"]
    assert mine["n_schedule_repaired"] == theirs["n_schedule_repaired"] == 0


def test_top_cli_polls_a_live_tracker():
    tracker = Tracker(2, quiet=True).start()
    try:
        addr = f"{tracker.host}:{tracker.port}"
        out = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.obs.top", addr, "--once",
                              "--json"], capture_output=True, text=True, timeout=60,
                             cwd=REPO, check=True).stdout
        doc = json.loads(out)
        assert doc["schema"] == stream.STREAM_SCHEMA and "registry" not in doc
        assert top.main([addr, "--rounds", "2", "--interval", "0.1"]) == 0
        assert top.main([addr, "--once", "--registry", "--json"]) == 0
    finally:
        tracker.stop()
    with pytest.raises(NotImplementedError, match="10g"):
        top.scrape("127.0.0.1", 1, job="j")
    assert top.main([f"127.0.0.1:{tracker.port}", "--once"]) == 2  # the tracker is gone


# -- the repair loop ---------------------------------------------------------------------

def checkin(tracker, cls_proto, cmd, tasks, prev=None) -> dict:
    """One wave of check-ins (rabit_tpu's client, which reads the whole
    Assignment); returns task -> Assignment."""
    out = {}

    def one(t):
        out[t] = cls_proto.tracker_rpc(tracker.host, tracker.port, cmd, t,
                                       prev_rank=(prev or {}).get(t, -1),
                                       listen_port=41000 + int(t), timeout=5.0,
                                       reply_timeout=20.0, retries=0)

    threads = [threading.Thread(target=one, args=(t,)) for t in tasks]
    for th in threads:
        th.start()
        time.sleep(0.05)
    for th in threads:
        th.join(timeout=25)
    return out


def scripted_repair(tracker, line: str) -> dict:
    """A wave of 3; the print ``line``; the epoch reply; a wave of recovery
    check-ins; the shutdowns.  Returns the replies, rings and telemetry."""
    tasks = ["0", "1", "2"]
    first = checkin(tracker, JP, JP.CMD_START, tasks)
    assert JP.tracker_rpc(tracker.host, tracker.port, JP.CMD_PRINT, "2", message=line,
                          timeout=5.0, retries=0) == JP.ACK
    epoch = JP.tracker_rpc(tracker.host, tracker.port, JP.CMD_EPOCH, "0", message="1",
                           timeout=5.0, retries=0)
    second = checkin(tracker, JP, JP.CMD_RECOVER, tasks,
                     prev={t: a.rank for t, a in first.items()})
    for t in tasks:
        JP.tracker_rpc(tracker.host, tracker.port, JP.CMD_SHUTDOWN, t, timeout=5.0, retries=0)
    assert tracker.wait(10.0)
    return {"rings": [sorted({tuple(a.ring_order) for a in w.values()}) for w in
                      (first, second)],
            "epochs": [sorted({a.epoch for a in w.values()}) for w in (first, second)],
            "rewave": epoch["rewave"],
            "repaired": [{k: v for k, v in e.items() if k != "ts"} for e in tracker.events
                         if e["kind"] == "schedule_repaired"],
            "n_schedule_repaired": tracker.telemetry["n_schedule_repaired"]}


ORIGIN_LINE = "[2] slow_link src=1 dst=2 wait=0.0 share=1.0 origin=trace_tool"


@pytest.mark.parametrize("repair", [True, False])
def test_origin_stamped_report_repairs_like_jax(repair):
    got = {}
    for name, cls in (("port", Tracker), ("jax", JaxTracker)):
        tracker = cls(3, quiet=True, schedule="ring", sched_repair=repair).start()
        try:
            got[name] = scripted_repair(tracker, ORIGIN_LINE)
        finally:
            tracker.stop()
    assert got["port"] == got["jax"]
    mine = got["port"]
    assert mine["rings"][0] == [(0, 1, 2)] and mine["rewave"] is repair
    if repair:
        ring = mine["rings"][1][0]
        assert all((ring[i], ring[(i + 1) % 3]) != (1, 2) for i in range(3))
        assert mine["n_schedule_repaired"] == 1 and mine["repaired"][0]["avoided"] == [[1, 2]]
    else:
        assert mine["rings"][1] == [(0, 1, 2)] and mine["n_schedule_repaired"] == 0


def test_unstamped_report_only_feeds_the_monitor():
    tracker = Tracker(3, quiet=True, schedule="ring").start()
    try:
        got = scripted_repair(tracker, "[2] slow_link src=1 dst=2 wait=0.4 share=0.8")
    finally:
        tracker.stop()
    assert got["rewave"] is False and got["n_schedule_repaired"] == 0
    assert any(e["kind"] == "link_degraded" and not e.get("origin") for e in tracker.events)


def test_trace_tool_flag_links_arms_the_repair(tmp_path, capsys):
    """``report --flag-links`` pushes the straggler's incoming link of the
    job's last planned ring into a live tracker as an origin-stamped
    report: the tracker keeps the flag and asks for a repair wave."""
    obs = tmp_path / "obs"
    obs.mkdir()
    rows = []
    for rank, lag in ((0, 0.0), (1, 0.0), (2, 0.3)):
        lines = [{"ts": 99.0, "kind": "flight_dump", "rank": rank, "pid": rank}]
        for seq in range(3):
            t = 100.0 + seq + lag
            lines += [{"ts": t, "kind": "op_begin", "op": "allreduce", "version": 0,
                       "seqno": seq},
                      {"ts": t + 0.01, "kind": "op_end", "op": "allreduce", "version": 0,
                       "seqno": seq}]
        (obs / f"flight-rank{rank}-pid{rank}-n1-exit.jsonl").write_text(
            "\n".join(json.dumps(x) for x in lines) + "\n")
        rows.append(rank)
    (obs / "telemetry.json").write_text(json.dumps({"world_size": 3, "events": [
        {"ts": 99.5, "kind": "schedule_planned", "ring_order": [0, 1, 2]}]}))
    tracker = Tracker(3, quiet=True, schedule="ring").start()
    try:
        checkin_thread = threading.Thread(
            target=lambda: checkin(tracker, JP, JP.CMD_START, ["0", "1", "2"]))
        checkin_thread.start()
        checkin_thread.join(30)
        addr = f"{tracker.host}:{tracker.port}"
        assert torch_trace_tool.main(["report", str(obs), "--flag-links", addr, "--json"]) == 0
        flagged = json.loads(capsys.readouterr().out.splitlines()[0])
        assert flagged == {"flagged_links": [[1, 2]], "tracker": addr}
        assert tracker._epoch_info()["rewave"] is True
        assert top.scrape(tracker.host, tracker.port)["jobs"][""]["link_flags"] == 1
    finally:
        tracker.stop()
