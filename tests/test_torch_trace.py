"""The port's cross-rank trace merger against rabit_tpu's (obs/trace.py).

The same obs dir (flight dumps and telemetry.json, made from a seed with
numpy or drawn by hypothesis) goes through both packages' ``load_job``,
``pair_ops``, ``build_chrome_trace``, ``straggler_report`` and
``export_job``: the documents must be equal as canonical JSON.
``validate_chrome_trace`` must give the same errors on broken documents;
each package reads the dumps the other's flight recorder wrote; a torn dump
is skipped under ``tolerant=True`` and refused otherwise; ``export_follow``
grows a valid trace and then finalizes.  ``tools/torch_trace_tool.py``
prints what ``tools/trace_tool.py`` prints.  Last, a job of the port's
recover worker under the port's launcher, with a mock kill and an injected
straggler, merges into one valid trace whose report names the straggler.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rabit_tpu.obs import events as jevents
from rabit_tpu.obs import trace as jtrace
from rabit_tpu_torch.obs import events as pevents
from rabit_tpu_torch.obs import trace as ptrace

REPO = Path(__file__).resolve().parents[1]
WORKER = str(REPO / "tests" / "workers" / "torch_recover_worker.py")
sys.path.insert(0, str(REPO / "tools"))
import torch_trace_tool  # noqa: E402
import trace_tool  # noqa: E402

sys.path.pop(0)


def canon(doc) -> str:
    return json.dumps(doc, sort_keys=True)


# -- obs dirs ----------------------------------------------------------------

def write_dump(path: Path, rank: int, pid: int, events: list) -> None:
    lines = [pevents.Event(99.0, "flight_dump",
                           {"reason": "exit", "rank": rank, "pid": pid, "dump_seq": 1,
                            "n_events": len(events), "dropped": 0,
                            "task_id": str(rank)}).to_json()]
    lines += [e.to_json() for e in events]
    path.write_text("\n".join(lines) + "\n")


def synthetic_job(obs_dir: Path) -> None:
    """tests/test_trace.py's layout: two ranks, one collective a version,
    rank 1's clock 5 s behind the tracker's, one recovery wave."""
    obs_dir.mkdir(parents=True, exist_ok=True)
    E = pevents.Event

    def life(base: float, rank: int) -> list:
        return [
            E(base, "engine_init", {"engine": "NativeEngine", "backend": "robust"}),
            E(base + 0.20, "bootstrap_done", {"engine": "NativeEngine", "rank": rank,
                                              "world": 2, "attempt": 0, "seconds": 0.2}),
            E(base + 0.30, "op_begin", {"op": "allreduce", "version": 0, "seqno": 0,
                                        "nbytes": 64, "cache_key": "train.py::10::step"}),
            E(base + 0.40, "op_end", {"op": "allreduce", "version": 0, "seqno": 0,
                                      "nbytes": 64, "cache_key": "train.py::10::step",
                                      "seconds": 0.1}),
            E(base + 0.50, "checkpoint_commit", {"version": 1, "nbytes": 128}),
            E(base + 0.60, "op_begin", {"op": "allreduce", "version": 1, "seqno": 0,
                                        "nbytes": 64}),
            E(base + 0.72, "op_end", {"op": "allreduce", "version": 1, "seqno": 0,
                                      "nbytes": 64, "seconds": 0.12}),
        ]

    write_dump(obs_dir / "flight-rank0-pid100-n1-exit.jsonl", 0, 100, life(100.0, 0))
    write_dump(obs_dir / "flight-rank1-pid200-n1-exit.jsonl", 1, 200, life(95.01, 1))
    telemetry = {
        "schema": 1, "world_size": 2, "started_at": 99.9, "finished_at": 101.2,
        "n_waves": 2, "n_recovery_waves": 1, "n_lease_expired": 1, "restarts": {"1": 1},
        "clocks": {"1": {"offset_s": 5.0, "err_s": 0.002, "samples": 4}},
        "waves": [{"ts": 100.1, "kind": "wave", "epoch": 0, "assignments": {"0": 0, "1": 1},
                   "recovering": [], "restarted": []},
                  {"ts": 100.95, "kind": "wave", "epoch": 1,
                   "assignments": {"0": 0, "1": 1}, "recovering": ["0"],
                   "restarted": ["1"]}],
        "events": [{"ts": 100.8, "kind": "failure_detected", "rank": 0, "at": 100.79},
                   {"ts": 100.85, "kind": "lease_expired", "task_id": "1", "rank": 1,
                    "interval": 0.25, "overdue": 0.05}],
        "ranks": {},
    }
    (obs_dir / "telemetry.json").write_text(json.dumps(telemetry, indent=1, sort_keys=True))


INSTANTS = ("hang_detected", "checkpoint_commit", "engine_ready", "epoch_changed",
            "unknown_kind")
TRACKER_KINDS = ("lease_expired", "failure_detected", "wave_purged", "schedule_repaired",
                 "incident_opened", "spare_promoted", "obs_scrape", "not_rendered")


def random_job(obs_dir: Path, seed: int) -> None:
    """A job drawn from ``seed``: 2-4 ranks (one dump a life, a rank may
    have two lives), keyed collectives with random lateness and a few
    legacy (unkeyed) ones, spans still open at the dump, instants, clock
    offsets, recovery waves and tracker events."""
    rng = np.random.RandomState(seed)
    obs_dir.mkdir(parents=True, exist_ok=True)
    world = int(rng.randint(2, 5))
    versions = int(rng.randint(1, 4))
    base = 1000.0 + float(rng.randint(0, 100))
    lag = rng.uniform(0, 0.2, size=world) * (rng.rand(world) < 0.6)
    offsets = {r: float(rng.uniform(-3, 3)) for r in range(world)}
    ops = ("allreduce", "broadcast", "allgather")
    E = pevents.Event
    for rank in range(world):
        evs = [E(base - offsets[rank], "engine_init", {"engine": "NativeEngine"}),
               E(base - offsets[rank] + 0.05, "bootstrap_done", {"engine": "NativeEngine",
                                                                  "rank": rank})]
        t = base + 0.1
        for v in range(versions):
            for seq in range(int(rng.randint(1, 4))):
                op = ops[(v + seq) % 3]
                begin = t + lag[rank] + float(rng.uniform(0, 0.01))
                f = {"op": op, "version": v, "seqno": seq, "nbytes": int(rng.randint(1, 999))}
                if rng.rand() < 0.3:
                    f["fused"] = 1
                evs.append(E(begin - offsets[rank], "op_begin", dict(f)))
                if not (v == versions - 1 and rng.rand() < 0.2):  # in flight at the dump
                    evs.append(E(begin + float(rng.uniform(0.001, 0.05)) - offsets[rank],
                                 "op_end", dict(f)))
                t += 0.3
            evs.append(E(t - offsets[rank], INSTANTS[int(rng.randint(len(INSTANTS)))],
                         {"version": v + 1}))
        if rng.rand() < 0.5:  # legacy events: FIFO pairing
            evs.append(E(t + 0.1 - offsets[rank], "op_begin", {"op": "broadcast"}))
            evs.append(E(t + 0.2 - offsets[rank], "op_end", {"op": "broadcast"}))
        evs.sort(key=lambda e: e.ts)
        if rng.rand() < 0.3 and len(evs) > 4:  # two lives, overlapping events
            cut = len(evs) // 2
            write_dump(obs_dir / f"flight-rank{rank}-pid{10 + rank}-n1-hang.jsonl", rank,
                       10 + rank, evs[:cut + 2])
            write_dump(obs_dir / f"flight-rank{rank}-pid{50 + rank}-n2-exit.jsonl", rank,
                       50 + rank, evs[cut:])
        else:
            write_dump(obs_dir / f"flight-rank{rank}-pid{10 + rank}-n1-exit.jsonl", rank,
                       10 + rank, evs)
    if rng.rand() < 0.2:
        return  # no telemetry: no clocks, no waves
    end = base + 0.3 * versions * 3
    tele_events = [{"ts": round(float(rng.uniform(base, end)), 6),
                    "kind": TRACKER_KINDS[int(rng.randint(len(TRACKER_KINDS)))],
                    "rank": int(rng.randint(world))} for _ in range(int(rng.randint(0, 6)))]
    tele_events.sort(key=lambda e: e["ts"])
    waves = [{"ts": base, "kind": "wave", "epoch": 0}]
    for i in range(int(rng.randint(0, 3))):
        waves.append({"ts": round(float(rng.uniform(base, end)), 6), "kind": "wave",
                      "epoch": i + 1})
    clocks = {str(r): {"offset_s": round(offsets[r], 6),
                       "err_s": round(float(rng.uniform(0, 0.01)), 6), "samples": 3}
              for r in range(world) if rng.rand() < 0.8}
    telemetry = {"schema": 1, "world_size": world, "started_at": base - 0.5,
                 "clocks": clocks, "waves": waves, "events": tele_events + waves,
                 "ranks": {}}
    (obs_dir / "telemetry.json").write_text(json.dumps(telemetry, indent=1, sort_keys=True))


def both_exports(src: Path, tmp: Path, **kw):
    """export_job of each package on its own copy of ``src``: (doc,
    report, folded telemetry or None) a package."""
    out = {}
    for name, mod in (("port", ptrace), ("jax", jtrace)):
        d = tmp / name
        shutil.copytree(src, d)
        doc, path, report = mod.export_job(str(d), **kw)
        tele = d / "telemetry.json"
        out[name] = (doc, json.loads(Path(path).read_text()), report,
                     json.loads(tele.read_text()) if tele.exists() else None)
    return out["port"], out["jax"]


def span_dicts(spans) -> list:
    return [dataclasses.asdict(s) for s in spans]


def assert_jobs_equal(obs_dir: Path) -> None:
    pj, jj = ptrace.load_job(str(obs_dir)), jtrace.load_job(str(obs_dir))
    assert sorted(pj.ranks) == sorted(jj.ranks)
    for rank in pj.ranks:
        assert [(e.ts, e.kind, e.fields) for e in pj.ranks[rank]] == \
            [(e.ts, e.kind, e.fields) for e in jj.ranks[rank]]
        assert span_dicts(ptrace.pair_ops(pj.ranks[rank])) == \
            span_dicts(jtrace.pair_ops(jj.ranks[rank]))
    assert pj.clocks == jj.clocks and pj.max_clock_err() == jj.max_clock_err()
    assert ptrace.recovery_windows(pj) == jtrace.recovery_windows(jj)
    pa, ja = ptrace.collective_arrivals(pj), jtrace.collective_arrivals(jj)
    assert {k: {r: dataclasses.asdict(s) for r, s in v.items()} for k, v in pa.items()} == \
        {k: {r: dataclasses.asdict(s) for r, s in v.items()} for k, v in ja.items()}
    pj, jj = ptrace.load_job(str(obs_dir)), jtrace.load_job(str(obs_dir))
    pdoc, jdoc = ptrace.build_chrome_trace(pj), jtrace.build_chrome_trace(jj)
    assert canon(pdoc) == canon(jdoc)
    assert ptrace.validate_chrome_trace(pdoc) == [] == jtrace.validate_chrome_trace(jdoc)
    for k in (0, 1, 3, 9):
        assert canon(ptrace.straggler_report(pj, top_k=k)) == \
            canon(jtrace.straggler_report(jj, top_k=k))


# -- equal to rabit_tpu ----------------------------------------------------------

def test_synthetic_job_export_equal_to_jax(tmp_path):
    synthetic_job(tmp_path / "obs")
    assert_jobs_equal(tmp_path / "obs")
    port, jax = both_exports(tmp_path / "obs", tmp_path, top_k=2)
    assert canon(port[0]) == canon(jax[0]) and canon(port[1]) == canon(jax[1])
    assert canon(port[2]) == canon(jax[2])
    assert canon(port[3]) == canon(jax[3])  # the folded telemetry: stragglers
    assert port[3]["stragglers"]["collectives_total"] == 2
    assert sum(1 for e in port[0]["traceEvents"] if e["name"] == "recovery wave") == 1


@pytest.mark.parametrize("seed", range(12))
def test_seeded_jobs_equal_to_jax(tmp_path, seed):
    random_job(tmp_path / "obs", seed)
    assert_jobs_equal(tmp_path / "obs")
    port, jax = both_exports(tmp_path / "obs", tmp_path, top_k=3)
    for a, b in zip(port, jax):
        assert canon(a) == canon(b)


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_drawn_jobs_equal_to_jax(seed):
    with tempfile.TemporaryDirectory() as tmp:
        random_job(Path(tmp) / "obs", seed)
        assert_jobs_equal(Path(tmp) / "obs")


GOOD_EVENT = {"name": "x", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 0, "tid": 0}
BROKEN = {
    "not-a-dict": [1, 2],
    "no-events": {"displayTimeUnit": "ms"},
    "events-not-list": {"traceEvents": {"a": 1}},
    "event-not-object": {"traceEvents": [3]},
    "bad-ph": {"traceEvents": [{**GOOD_EVENT, "ph": "B"}]},
    "no-name": {"traceEvents": [{**GOOD_EVENT, "name": ""}]},
    "pid-not-int": {"traceEvents": [{**GOOD_EVENT, "pid": "0", "tid": 1.5}]},
    "ts-bool": {"traceEvents": [{**GOOD_EVENT, "ts": True}]},
    "negative-ts": {"traceEvents": [{**GOOD_EVENT, "ts": -1.0}]},
    "negative-dur": {"traceEvents": [{**GOOD_EVENT, "dur": -0.5}]},
    "no-dur": {"traceEvents": [{k: v for k, v in GOOD_EVENT.items() if k != "dur"}]},
    "instant-scope": {"traceEvents": [{**GOOD_EVENT, "ph": "i", "s": "x"}]},
    "args-not-object": {"traceEvents": [{**GOOD_EVENT, "args": [1]}]},
    "not-serializable": {"traceEvents": [{**GOOD_EVENT, "args": {"a": {1, 2}}}]},
    "metadata-negative-ts-ok": {"traceEvents": [{**GOOD_EVENT, "ph": "M", "ts": -5.0}]},
    "several": {"traceEvents": [GOOD_EVENT, {"ph": "X"}, {**GOOD_EVENT, "ph": "i"}]},
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_validate_errors_equal_to_jax(name):
    doc = BROKEN[name]
    assert ptrace.validate_chrome_trace(doc) == jtrace.validate_chrome_trace(doc)
    if name != "metadata-negative-ts-ok":
        assert ptrace.validate_chrome_trace(doc)


def test_dump_names_and_telemetry_discovery_equal_to_jax(tmp_path):
    for name in ("/x/flight-rank3-pid71-n2-hang.jsonl", "/x/flight-rank0-pid9-sigterm.jsonl",
                 "/x/flight-rank-1-pid5-n1-exit.jsonl", "/x/telemetry.json", "flight-x.jsonl"):
        assert ptrace.parse_dump_name(name) == jtrace.parse_dump_name(name)
    for name in ("telemetry.json", "telemetry-a.json", "telemetry-b.c.json", "flight-rank0-pid1"
                 "-exit.jsonl", "flight-rank1-pid2-n3-abort.jsonl", "other.txt"):
        (tmp_path / name).write_text("{}")
    assert ptrace.discover_dumps(str(tmp_path)) == jtrace.discover_dumps(str(tmp_path))
    assert ptrace.discover_telemetry_jobs(str(tmp_path)) == \
        jtrace.discover_telemetry_jobs(str(tmp_path)) == ["a", "b.c"]
    assert ptrace.telemetry_name("j") == jtrace.telemetry_name("j") == "telemetry-j.json"
    assert ptrace.discover_dumps(str(tmp_path / "absent")) == []


# -- files across packages ---------------------------------------------------------

def record_life(events_mod, path: Path, rank: int, seed: int) -> None:
    """One rank's flight recorder of ``events_mod``'s package: keyed
    collectives (rank-seeded lateness), a commit, dumped with its header."""
    rng = np.random.RandomState(seed + rank)
    rec = events_mod.FlightRecorder(64)
    rec.record("engine_init", engine="NativeEngine")
    for v in range(3):
        for seq in range(2):
            rec.record("op_begin", op="allreduce", version=v, seqno=seq,
                       nbytes=int(rng.randint(8, 99)))
            rec.record("op_end", op="allreduce", version=v, seqno=seq, nbytes=8)
        rec.record("checkpoint_commit", version=v + 1)
    rec.dump(path, header={"reason": "exit", "rank": rank, "pid": 100 + rank,
                           "dump_seq": 1, "task_id": str(rank)})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dumps_read_across_packages(tmp_path, writer):
    mod = pevents if writer == "port" else jevents
    for rank in range(3):
        record_life(mod, tmp_path / f"flight-rank{rank}-pid{100 + rank}-n1-exit.jsonl", rank, 5)
    pj, jj = ptrace.load_job(str(tmp_path)), jtrace.load_job(str(tmp_path))
    assert sorted(pj.ranks) == [0, 1, 2]
    for rank in range(3):
        assert [(e.ts, e.kind, e.fields) for e in pj.ranks[rank]] == \
            [(e.ts, e.kind, e.fields) for e in jj.ranks[rank]]
        assert len(ptrace.pair_ops(pj.ranks[rank])) == 6
    assert canon(ptrace.build_chrome_trace(pj)) == canon(jtrace.build_chrome_trace(jj))


@pytest.mark.parametrize("loader", ["port", "jax"])
def test_torn_dump_tolerant_and_strict(tmp_path, loader):
    mod = ptrace if loader == "port" else jtrace
    record_life(pevents, tmp_path / "flight-rank0-pid100-n1-exit.jsonl", 0, 1)
    record_life(jevents, tmp_path / "flight-rank1-pid101-n1-exit.jsonl", 1, 1)
    whole = (tmp_path / "flight-rank1-pid101-n1-exit.jsonl").read_text()
    (tmp_path / "flight-rank2-pid102-n1-spill.jsonl").write_text(whole[:len(whole) // 2 + 7])
    (tmp_path / "telemetry.json").write_text('{"clocks": ')  # torn too
    with pytest.raises(mod.TraceError):
        mod.load_job(str(tmp_path))
    job = mod.load_job(str(tmp_path), tolerant=True)
    assert sorted(job.ranks) == [0, 1] and job.telemetry is None
    other = jtrace if loader == "port" else ptrace
    assert canon(mod.build_chrome_trace(job)) == \
        canon(other.build_chrome_trace(other.load_job(str(tmp_path), tolerant=True)))


def test_export_follow_grows_then_finalizes(tmp_path):
    """A live obs dir: each round is a valid trace that grows as dumps land
    (a torn one skipped); the telemetry file ends the loop with the strict
    export, equal to rabit_tpu's."""
    obs = tmp_path / "obs"
    synthetic_job(tmp_path / "src")
    obs.mkdir()
    dumps = sorted((tmp_path / "src").glob("flight-*.jsonl"))
    shutil.copy(dumps[0], obs)
    (obs / "flight-rank5-pid1-n1-spill.jsonl").write_text('{"ts": 1.0, "kin')
    sizes = []

    def on_round(n, doc):
        assert ptrace.validate_chrome_trace(doc) == []
        sizes.append(len(doc["traceEvents"]))
        if n == 1:
            shutil.copy(dumps[1], obs)
        elif n == 2:
            (obs / "flight-rank5-pid1-n1-spill.jsonl").unlink()
            shutil.copy(tmp_path / "src" / "telemetry.json", obs)

    doc, path, report, rounds = ptrace.export_follow(str(obs), interval=0.01,
                                                     on_round=on_round)
    assert rounds == 3 and sizes[0] < sizes[1] and len(doc["traceEvents"]) > sizes[1]
    assert json.loads((obs / "telemetry.json").read_text())["stragglers"] == report
    jdoc, _, jreport = jtrace.export_job(str(obs))
    assert canon(doc) == canon(jdoc) and canon(report) == canon(jreport)
    # max_rounds on a dir that never finishes: tolerant, unfolded
    live = tmp_path / "live"
    live.mkdir()
    shutil.copy(dumps[0], live)
    doc, _, report, rounds = ptrace.export_follow(str(live), interval=0.01, max_rounds=2)
    assert rounds == 2 and report["collectives_total"] == 2 and report["collectives_analyzed"] == 0
    assert not (live / "telemetry.json").exists()


# -- the CLI -------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["export"], ["export", "--no-fold", "--top", "1"],
                                  ["report"], ["report", "--json", "--top", "2"],
                                  ["report", "--write-telemetry"], ["diagnose"],
                                  ["diagnose", "--json", "--fold"]])
def test_trace_tool_cli_equal_to_jax(tmp_path, capsys, argv):
    outs = {}
    for name, tool in (("port", torch_trace_tool), ("jax", trace_tool)):
        obs = tmp_path / name
        synthetic_job(obs)
        assert tool.main([argv[0], str(obs), *argv[1:]]) == 0
        out = capsys.readouterr().out.replace(str(obs), "OBS")
        tele = json.loads((obs / "telemetry.json").read_text())
        for e in tele.get("events", []):
            if e["kind"] == "critical_path_folded":
                e["ts"] = 0
        outs[name] = (out, canon(tele))
        if argv[0] == "export":
            trace_path = json.loads(out)["trace"].replace("OBS", str(obs))
            assert tool.main(["validate", trace_path]) == 0
            outs[name] += (capsys.readouterr().out,)
    assert outs["port"] == outs["jax"]


def test_trace_tool_cli_refuses_a_corrupt_dump(tmp_path, capsys):
    (tmp_path / "flight-rank0-pid1-n1-exit.jsonl").write_text("{not json\n")
    assert torch_trace_tool.main(["export", str(tmp_path)]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(BROKEN["negative-dur"]))
    assert torch_trace_tool.main(["validate", str(bad)]) == 1
    assert "INVALID" in capsys.readouterr().err


# -- a job of the port's worker ------------------------------------------------------

def rank_op_table(path: Path) -> dict:
    """(version, seqno) -> op of one dump's collectives."""
    return {(e.fields["version"], e.fields["seqno"]): e.fields["op"]
            for e in pevents.load_dump(path)
            if e.kind == "op_begin" and e.fields.get("seqno") is not None}


def test_trace_e2e_recovery_wave_and_straggler(tmp_path, monkeypatch):
    """The port's recover worker under the port's launcher: rank 1 killed by
    the mock engine (a recovery wave) and rank 2 an injected straggler.
    The obs dir merges into one valid trace whose (version, seqno)
    identities agree across ranks, every rank has a clock estimate, the
    recovery's collectives are tallied apart, and the straggler report and
    the critical path name rank 2; telemetry.json gains both reports."""
    from rabit_tpu_torch.engine import native
    from rabit_tpu_torch.obs import critical
    from rabit_tpu_torch.tracker.launcher import LocalCluster

    native.build_lib()
    obs = tmp_path / "obs"
    monkeypatch.setenv("RABIT_OBS_DIR", str(obs))  # the tracker's and the workers'
    world, straggler = 3, 2
    cluster = LocalCluster(world, max_restarts=3, quiet=True)
    assert cluster.run([sys.executable, WORKER, "rabit_engine=mock", "ndata=500", "niter=4",
                        "sleep=0.1", f"straggler={straggler}", "straggler_sleep=0.3",
                        "mock=1,1,1,0", "rabit_trace_exit=1",
                        "rabit_obs_heartbeat_sec=0.3"], timeout=120) == 0
    assert cluster.restarts["1"] == 1
    tables = {pevents_rank(p): rank_op_table(p) for p in obs.glob("flight-*-exit.jsonl")}
    assert set(tables) == set(range(world))
    for table in tables.values():
        for key, op in table.items():
            assert all(other.get(key, op) == op for other in tables.values()), key
    doc, path, report = ptrace.export_job(str(obs))
    assert ptrace.validate_chrome_trace(doc) == [] and os.path.exists(path)
    job = ptrace.load_job(str(obs))
    assert set(job.clocks) == set(range(world)) and job.max_clock_err() < 0.5
    assert report["collectives_analyzed"] >= 4 and report["collectives_recovery_affected"] >= 1
    top = report["top_stragglers"][0]
    assert top["rank"] == straggler and top["lateness_total_s"] >= 0.25
    cp = critical.critical_path_report(job)
    assert cp["top_gating_ranks"][0]["rank"] == straggler
    critical.fold_critical_path(str(obs), cp)
    tele = json.loads((obs / "telemetry.json").read_text())
    assert tele["stragglers"]["top_stragglers"][0]["rank"] == straggler
    assert tele["critical_path"]["top_gating_ranks"][0]["rank"] == straggler
    assert tele["n_schedule_repaired"] == 0 and tele["incidents"]["n_opened"] == 0
    # rabit_tpu's merger reads the port's job the same way
    jdoc, _, jreport = jtrace.export_job(str(obs), out_path=str(tmp_path / "j.json"),
                                         fold=False)
    assert canon(jreport) == canon(report)


def pevents_rank(path: Path) -> int:
    return ptrace.parse_dump_name(str(path))["rank"]


def test_trace_e2e_recovery_wave_wedge_and_straggler(tmp_path, monkeypatch):
    """tests/test_trace.py's acceptance run on the port, with its worker
    arguments: a world-4 job of the port's recover worker under the port's
    launcher, with rank 1 killed by the mock engine (a recovery wave), rank
    2 wedged (SIGSTOP, its lease lapses, SIGKILL, a restart) and rank 3 an
    injected straggler.  Every final life leaves an exit dump whose
    (version, seqno) line is contiguous from 0 in each version, the
    identities agree across ranks, every rank ran the final iteration's
    collectives, and the dumps merge into one valid trace naming rank 3."""
    from rabit_tpu_torch.engine import native
    from rabit_tpu_torch.tracker.launcher import LocalCluster

    native.build_lib()
    obs = tmp_path / "obs"
    monkeypatch.setenv("RABIT_OBS_DIR", str(obs))  # the tracker's and the workers'
    world, straggler = 4, 3
    cluster = LocalCluster(world, max_restarts=6, quiet=True)
    rc = cluster.run(
        [sys.executable, WORKER, "rabit_engine=mock",
         "ndata=500", "niter=4", "sleep=0.15",
         f"straggler={straggler}", "straggler_sleep=0.3",
         "preload_op=1", "rabit_bootstrap_cache=1",
         "mock=1,1,1,0",            # rank 1 dies at (v1, seq1): wave 1
         "rabit_trace_exit=1",      # clean exits leave trace dumps
         "rabit_obs_heartbeat_sec=0.3",
         "rabit_heartbeat_sec=0.25",  # the lease detector for the wedge
         "rabit_stall_timeout_sec=3", "rabit_timeout_sec=90"],
        timeout=180.0,
        wedge=[(2.0, 2)],           # rank 2 freezes: wave 2
    )
    assert rc == 0 and all(r == 0 for r in cluster.returncodes.values())
    assert cluster.restarts["1"] >= 1, "mock kill never restarted rank 1"
    assert cluster.wedges_delivered == 1
    assert cluster.restarts["2"] >= 1, "wedged rank 2 was never healed"
    assert cluster.telemetry and cluster.telemetry["n_recovery_waves"] >= 1
    tables = {pevents_rank(p): rank_op_table(p) for p in obs.glob("flight-*-exit.jsonl")}
    assert set(tables) == set(range(world)), sorted(obs.iterdir())
    for rank, table in tables.items():
        by_version: dict[int, list[int]] = {}
        for (v, s) in table:
            by_version.setdefault(v, []).append(s)
        for v, seqs in by_version.items():
            assert sorted(seqs) == list(range(len(seqs))), (rank, v, seqs)
        for key, op in table.items():
            assert all(other.get(key, op) == op for other in tables.values()), (key, rank)
    final_keys = [k for k in tables[0] if k[0] == 3]
    assert final_keys, tables[0]
    for rank in range(world):
        assert all(key in tables[rank] for key in final_keys), rank
    doc, path, report = ptrace.export_job(str(obs))
    assert ptrace.validate_chrome_trace(doc) == [] and os.path.exists(path)
    job = ptrace.load_job(str(obs))
    assert set(job.clocks) == set(range(world)) and job.max_clock_err() < 0.5
    assert report["collectives_analyzed"] >= 2
    top = report["top_stragglers"][0]
    assert top["rank"] == straggler and top["lateness_total_s"] >= 0.25
    tele = json.loads((obs / "telemetry.json").read_text())
    assert tele["stragglers"]["top_stragglers"][0]["rank"] == straggler
    assert set(tele["clocks"]) >= {str(r) for r in range(world)}


# -- the clock, span pairing and export units of tests/test_trace.py ------------------

def test_clock_sync_keeps_lowest_error_sample():
    """tests/test_trace.py:32 in both packages: the same samples give the
    same estimate and snapshot."""
    clocks = (ptrace.ClockSync(), jtrace.ClockSync())
    for c in clocks:
        assert c.estimate() is None and c.snapshot() is None
        for off, err in ((0.5, 0.010), (0.9, 0.050), (0.48, 0.002)):
            c.update(off, err)  # the worse error is ignored, the better wins
    assert clocks[0].estimate() == clocks[1].estimate() == (0.48, 0.002)
    assert clocks[0].snapshot() == clocks[1].snapshot() == {
        "offset_s": 0.48, "err_s": 0.002, "samples": 3}
    clocks[0].reset()
    assert clocks[0].estimate() is None


def test_timed_ack_midpoint_math():
    from rabit_tpu.tracker import protocol as JP
    from rabit_tpu_torch.tracker import protocol as P

    acks = [mod.TimedAck(mod.ACK, server_ts=105.0, t_send=99.0, t_recv=101.0)
            for mod in (P, JP)]
    for ack in acks:
        assert ack == P.ACK  # int-compatible for the callers that compare
        assert (ack.rtt, ack.err, ack.offset) == pytest.approx((2.0, 1.0, 5.0))
    assert (acks[0].rtt, acks[0].err, acks[0].offset) == (acks[1].rtt, acks[1].err,
                                                          acks[1].offset)


def test_clock_ping_live_tracker_no_lease():
    """A heartbeat of interval 0 to the port's tracker gives clock samples
    and no lease."""
    from rabit_tpu_torch.obs.ship import clock_ping
    from rabit_tpu_torch.tracker.tracker import Tracker

    tracker = Tracker(world_size=1, quiet=True).start()
    try:
        ptrace.GLOBAL_CLOCK.reset()
        assert clock_ping(tracker.host, tracker.port, "0", samples=3) == 3
        assert tracker.live_tasks() == []
        off, err = ptrace.GLOBAL_CLOCK.estimate()
        assert abs(off) < 0.5 and 0 <= err < 0.5  # one host, one clock
        assert ptrace.GLOBAL_CLOCK.samples == 3
    finally:
        tracker.stop()
        ptrace.GLOBAL_CLOCK.reset()


def test_clock_projection_is_monotonic_and_aligning():
    """Two skewed clocks observing the same instants project onto one
    timeline in rank order, as rabit_tpu's JobTrace projects them."""
    true_times = [10.0, 10.5, 11.25, 12.0]
    skews = {0: -3.0, 1: 0.25}
    jobs = (ptrace.JobTrace(), jtrace.JobTrace())
    for job, event in zip(jobs, (pevents.Event, jevents.Event)):
        for rank, skew in skews.items():
            job.ranks[rank] = [event(t + skew, "tick", {"i": i}) for i, t in enumerate(true_times)]
            job.clocks[rank] = {"offset_s": -skew, "err_s": 0.001, "samples": 5}
    for rank in skews:
        got = [jobs[0].project(rank, e.ts) for e in jobs[0].ranks[rank]]
        assert got == sorted(got) and got == pytest.approx(true_times, abs=1e-9)
        assert got == [jobs[1].project(rank, e.ts) for e in jobs[1].ranks[rank]]


def test_pair_ops_by_seqno_and_fifo_fallback():
    """Keyed spans pair by (version, seqno, op), a span without a seqno
    pairs first in first out, one in flight stays open: the same spans in
    both packages."""
    fields = [(1.0, "op_begin", {"op": "allreduce", "version": 0, "seqno": 0, "nbytes": 8}),
              (1.1, "op_begin", {"op": "broadcast"}),
              (1.2, "op_end", {"op": "broadcast"}),
              (1.3, "op_end", {"op": "allreduce", "version": 0, "seqno": 0, "nbytes": 8}),
              (1.4, "op_begin", {"op": "allgather", "version": 1, "seqno": 2, "nbytes": 4})]
    spans = [trace_mod.pair_ops([event(*f) for f in fields])
             for trace_mod, event in ((ptrace, pevents.Event), (jtrace, jevents.Event))]
    assert len(spans[0]) == 3
    keyed = {s.key: s for s in spans[0] if s.keyed}
    assert keyed[(0, 0, "allreduce")].end == 1.3 and keyed[(1, 2, "allgather")].end is None
    legacy = next(s for s in spans[0] if not s.keyed)
    assert legacy.op == "broadcast" and legacy.end == 1.2
    assert ([(s.key, s.keyed, s.begin, s.end) for s in spans[0]]
            == [(s.key, s.keyed, s.begin, s.end) for s in spans[1]])


def test_export_empty_dir_is_not_an_error(tmp_path):
    doc, _path, report = ptrace.export_job(str(tmp_path))
    assert doc["traceEvents"] == [] and report["collectives_total"] == 0
    assert ptrace.validate_chrome_trace(doc) == []
    with pytest.raises(ptrace.TraceError):  # a corrupt dump is refused
        (tmp_path / "flight-rank0-pid1-n1-exit.jsonl").write_text("{not json\n")
        ptrace.export_job(str(tmp_path))


def test_lease_renewal_resumes_after_hang_recovery(tmp_path):
    """Renewals are withheld while the watchdog holds a hang, and resume
    (here: fail for want of a tracker) once it is released."""
    from rabit_tpu_torch import obs
    from rabit_tpu_torch.config import Config

    obs.configure(Config([], {"rabit_obs_dir": str(tmp_path / "obs")}), rank=0)
    try:
        with obs._STATE.lock:
            obs._STATE.hang_dumped = True
        assert obs._renew_lease() is False  # withheld while hung
        with obs._STATE.lock:
            obs._STATE.hang_dumped = False
        assert obs._renew_lease() is False
        with obs._STATE.lock:
            assert obs._STATE.tracker is None
    finally:
        with obs._STATE.lock:
            obs._STATE.hang_dumped = False
        obs.configure(Config([]), rank=-1)
