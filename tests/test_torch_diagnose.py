"""The port's diagnosis plane against rabit_tpu's: the HealthMonitor's
incidents, the critical-path report, the repair functions and the delta
envelope, on the same inputs; then the plane end to end on the CPU.

* **Monitor.** Every scenario of tests/test_diagnose.py's rule tests, and
  hypothesis-drawn sequences of rollups and control-plane events, go to
  both packages' ``HealthMonitor`` window by window (the clock pinned):
  the opened and resolved incidents and ``render()`` must be equal.
* **Critical path.** tests/test_diagnose.py's synthetic rounds (the link
  gate, the compute gate, the recovery exclusion) and seeded rounds give
  equal ``critical_path_report`` and ``fold_critical_path`` results.
* **Repair and stream.** ``sched/repair.py``'s four functions,
  ``delta_doc`` / ``merge_delta_doc`` / ``wire_bytes_by_codec`` on seeded
  inputs, ``STREAM_METRICS`` and the diagnosis config keys.
* **End to end.** In-thread ``ElasticWorker`` jobs through the port's
  ``ChaosProxy`` (tests/workers/torch_diag_job.py): a slow link, a compute
  straggler and a clean run open the incidents (classes and subjects) that
  ``rabit_tpu.chaos.run_elastic_schedule`` opens for the same seed and
  arguments; the slow link is repaired; and rabit_tpu's workers with a
  slow link get the incident and the repair from the port's tracker.
"""

from __future__ import annotations

import json
import random
import sys
import time
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rabit_tpu import chaos as jchaos
from rabit_tpu import config as jconfig
from rabit_tpu import sched as jsched
from rabit_tpu.elastic.client import ElasticWorker as JaxWorker
from rabit_tpu.obs import critical as jcritical
from rabit_tpu.obs import diagnose as jdiag
from rabit_tpu.obs import events as jevents
from rabit_tpu.obs import stream as jstream
from rabit_tpu.obs import trace as jtrace
from rabit_tpu_torch import chaos as pchaos
from rabit_tpu_torch import config as pconfig
from rabit_tpu_torch import sched as psched
from rabit_tpu_torch.elastic.rebalance import shard_slice
from rabit_tpu_torch.obs import critical as pcritical
from rabit_tpu_torch.obs import diagnose as pdiag
from rabit_tpu_torch.obs import events as pevents
from rabit_tpu_torch.obs import stream as pstream
from rabit_tpu_torch.obs import trace as ptrace

sys.path.insert(0, str(Path(__file__).parent / "workers"))
import torch_diag_job  # noqa: E402

sys.path.pop(0)


def canon(doc) -> str:
    return json.dumps(doc, sort_keys=True, default=str)


# -- the monitor -----------------------------------------------------------------

def rollup(n_folds: int, links=()) -> dict:
    """A rendered-rollup stand-in: cumulative (count, wait-sum) link rows."""
    return {"n_folds": n_folds,
            "links": [{"src": str(s), "dst": str(d), "count": c, "sum": w}
                      for (s, d, c, w) in links]}


def monitors(**over):
    args = {"rabit_diag_min_wait_sec": "0.05", **{k: str(v) for k, v in over.items()}}
    argv = [f"{k}={v}" for k, v in args.items()]
    return pdiag.HealthMonitor(pconfig.Config(argv)), jdiag.HealthMonitor(jconfig.Config(argv))


def replay(steps, monkeypatch, **over) -> list:
    """Feed the same windows to both monitors with the clock pinned at each
    window's ``now``; every window's (opened, resolved) and render() must
    be equal.  Returns the port's incidents, opened and resolved."""
    port, jax = monitors(**over)
    clock = [0.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    seen = []
    for now, stream_doc, state in steps:
        clock[0] = 1000.0 + now
        got = [[i.to_doc() for i in x] for x in port.observe(now, stream_doc, state)]
        want = [[i.to_doc() for i in x] for x in jax.observe(now, stream_doc, state)]
        assert got == want, now
        assert canon(port.render()) == canon(jax.render())
        assert [i.to_doc() for i in port.open_incidents()] == \
            [i.to_doc() for i in jax.open_incidents()]
        seen += got[0] + got[1]
    return seen


def uniform3(i):
    return [(0, 1, 4 * i, 0.3 * i), (1, 2, 4 * i, 0.3 * i), (2, 0, 4 * i, 0.3 * i)]


def hole4(i):
    return [(3, 0, 4 * i, 0.4 * i), (0, 1, 4 * i, 0.4 * i), (1, 2, 4 * i, 0.001 * i),
            (2, 3, 4 * i, 0.4 * i)]


REPORT = {"kind": "link_degraded", "rank": 2, "src": 1, "dst": 2, "wait": 0.35, "share": 0.77}
QUORUM_FLAG = {"kind": "link_degraded", "rank": 0, "src": 2, "dst": 0, "via": "quorum"}
SCENARIOS = {
    "concentration": ({}, [(0.0, rollup(1, [(0, 1, 10, 1.0)]), {}),
                           (1.0, rollup(2, [(0, 1, 20, 2.0)]), {})]),
    "even-two-link-split": ({}, [(float(i), rollup(i, [(0, 1, 4 * i, 0.5 * i),
                                                       (1, 0, 4 * i, 0.5 * i)]), {})
                                 for i in range(1, 8)]),
    "below-min-wait": ({}, [(float(i), rollup(i, [(0, 1, 2 * i, 0.004 * i)]), {})
                            for i in range(1, 6)]),
    "hole": ({}, [(0.0, rollup(1, hole4(1)), {}), (1.0, rollup(2, hole4(2)), {})]),
    "self-report": ({}, [(0.0, rollup(1, uniform3(1)), {"events_delta": [REPORT, QUORUM_FLAG]}),
                         (1.0, rollup(2, uniform3(2)), {})]),
    "attribution-heals": ({"rabit_diag_resolve_windows": 2}, [
        (0.0, rollup(1, uniform3(1)[:2]), {"events_delta": [{**REPORT, "share": 0.6}]}),
        (1.0, rollup(2, uniform3(2)[:2]), {})]
        + [(float(i), rollup(i, uniform3(2)[:2]), {}) for i in range(3, 7)]),
    "origin-report-not-attributed": ({}, [
        (0.0, rollup(1, uniform3(1)), {"events_delta": [{**REPORT, "origin": "trace_tool"}]}),
        (1.0, rollup(2, uniform3(2)), {})]),
    "frozen-without-folds": ({"rabit_diag_resolve_windows": 2}, [
        (0.0, rollup(1, [(0, 1, 10, 1.0)]), {}), (1.0, rollup(2, [(0, 1, 20, 2.0)]), {})]
        + [(2.0 + i, rollup(2, [(0, 1, 20, 2.0)]), {}) for i in range(10)]),
    "preemption-storm": ({}, [
        (0.0, rollup(0), {"events_delta": [{"kind": "lease_expired", "task_id": str(t)}
                                           for t in range(3)]}),
        (1.0, rollup(0), {"events_delta": []})]),
    "single-death": ({}, [(float(i), rollup(0), {"events_delta": [
        {"kind": "lease_expired", "task_id": "1"}] if i == 0 else []}) for i in range(6)]),
    "saturation": ({"rabit_diag_resolve_windows": 2}, [
        (float(i), rollup(0), {"messages_dropped": 5}) for i in range(7)]),
    "lost-relay": ({"rabit_diag_resolve_windows": 2}, [
        (0.0, rollup(0), {"events_delta": [{"kind": "relay_lost", "relay": "r0"}]}),
        (1.0, rollup(0), {"events_delta": []})]
        + [(float(i), rollup(0), {"events_delta": [{"kind": "relay_up", "relay": "r0"}]
                                  if i == 2 else []}) for i in range(2, 6)]),
    "disabled": ({"rabit_diag_enable": 0}, [
        (0.0, rollup(5, [(0, 1, 10, 9.0)]),
         {"events_delta": [{"kind": "lease_expired", "task_id": "1"}] * 5})]),
}
OPENS = {"concentration": [("degraded-link", {"src": 0, "dst": 1})],
         "hole": [("compute-straggler", {"rank": 2})],
         "self-report": [("degraded-link", {"src": 1, "dst": 2})],
         "attribution-heals": [("degraded-link", {"src": 1, "dst": 2})] * 2,
         "frozen-without-folds": [("degraded-link", {"src": 0, "dst": 1})],
         "preemption-storm": [("preemption-storm", {"n_expired": 3})],
         "saturation": [("tracker-saturation", {"dropped": 5})] * 2,
         "lost-relay": [("lost-relay", {"relay": "r0"})] * 2}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_monitor_scenario_equal_to_jax(name, monkeypatch):
    over, steps = SCENARIOS[name]
    seen = replay(steps, monkeypatch, **over)
    assert [(i["class"], i["subject"]) for i in seen] == OPENS.get(name, [])


def test_incident_schema_equal_to_jax():
    assert pdiag.DIAG_SCHEMA == jdiag.DIAG_SCHEMA
    assert pdiag.INCIDENT_CLASSES == jdiag.INCIDENT_CLASSES
    assert (pdiag.DOMINANCE, pdiag.EVIDENCE_CAP, pdiag.HISTORY_CAP) == \
        (jdiag.DOMINANCE, jdiag.EVIDENCE_CAP, jdiag.HISTORY_CAP)


EVENT_KINDS = ("lease_expired", "link_degraded", "relay_lost", "relay_up", "wave")


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_drawn_rollup_sequences_equal_to_jax(data):
    """Random windows: link tables that grow (or stall), self-reports,
    lease expiries, relay events and print-log drops, under random
    hysteresis settings."""
    n_links = data.draw(st.integers(1, 5))
    links = [(i, (i + 1) % max(n_links, 2)) for i in range(n_links)]
    over = {"rabit_diag_open_windows": data.draw(st.integers(1, 3)),
            "rabit_diag_resolve_windows": data.draw(st.integers(1, 4)),
            "rabit_diag_storm_leases": data.draw(st.integers(1, 4))}
    counts = {lk: [0, 0.0] for lk in links}
    folds, dropped, steps = 0, 0, []
    for w in range(data.draw(st.integers(1, 14))):
        if data.draw(st.booleans()):
            folds += 1
            for lk in links:
                n = data.draw(st.integers(0, 6))
                counts[lk][0] += n
                counts[lk][1] += n * data.draw(st.sampled_from([0.0, 0.001, 0.05, 0.3]))
        events = []
        for _ in range(data.draw(st.integers(0, 3))):
            kind = data.draw(st.sampled_from(EVENT_KINDS))
            ev = {"kind": kind, "task_id": str(data.draw(st.integers(0, 4))),
                  "relay": f"r{data.draw(st.integers(0, 1))}"}
            if kind == "link_degraded":
                s, d = data.draw(st.sampled_from(links))
                ev.update(src=s, dst=d, share=data.draw(st.floats(0, 1)),
                          wait=data.draw(st.floats(0, 2)))
                if data.draw(st.booleans()):
                    ev["via"] = "quorum"
            events.append(ev)
        dropped += data.draw(st.sampled_from([0, 0, 3]))
        steps.append((float(w), rollup(folds, [(s, d, c, x) for (s, d), (c, x)
                                               in counts.items()]),
                      {"events_delta": events, "messages_dropped": dropped}))
    mp = pytest.MonkeyPatch()
    try:
        replay(steps, mp, **over)
    finally:
        mp.undo()


# -- the critical path -----------------------------------------------------------------

def round_events(by_rank, seqno, begins, ends, mod, op="allreduce"):
    for rank, b in begins.items():
        by_rank.setdefault(rank, []).append(
            mod.Event(b, "op_begin", {"op": op, "version": 0, "seqno": seqno}))
    for rank, e in ends.items():
        by_rank[rank].append(mod.Event(e, "op_end", {"op": op, "version": 0, "seqno": seqno}))


def link_gate(mod):
    evs, t = {}, 100.0
    for seq in range(4):
        round_events(evs, seq, {r: t for r in range(3)}, {r: t + 0.01 for r in range(3)}, mod)
        t += 1.0
    for seq in range(4, 7):
        round_events(evs, seq, {r: t for r in range(3)},
                     {0: t + 0.01, 1: t + 0.01, 2: t + 0.5}, mod)
        t += 1.0
    return evs, {"stream": {"links": [{"src": 1, "dst": 2, "count": 12, "sum": 1.45},
                                      {"src": "x", "dst": 2}]}}


def compute_gate(mod):
    evs, t = {}, 50.0
    for seq in range(2):
        round_events(evs, seq, {r: t for r in range(3)}, {r: t + 0.01 for r in range(3)}, mod)
        t += 1.0
    for seq in range(2, 6):
        round_events(evs, seq, {0: t, 1: t, 2: t + 0.4}, {r: t + 0.41 for r in range(3)}, mod)
        t += 1.0
    return evs, None


def recovery(mod):
    evs = {}
    round_events(evs, 0, {0: 10.0, 1: 10.0}, {0: 10.01, 1: 10.01}, mod)
    round_events(evs, 1, {0: 20.0, 1: 20.0}, {0: 20.01, 1: 20.6}, mod)
    return evs, {"events": [{"ts": 19.9, "kind": "lease_expired", "task_id": "1"}],
                 "waves": [{"epoch": 1, "ts": 20.5}]}


def seeded_rounds(seed):
    def make(mod):
        rng = np.random.RandomState(seed)
        world = int(rng.randint(2, 6))
        evs, t = {}, 1000.0
        for seq in range(int(rng.randint(1, 12))):
            begins = {r: t + float(rng.choice([0.0, 0.001, 0.3])) for r in range(world)}
            ends = {r: max(begins.values()) + float(rng.choice([0.01, 0.02, 0.4]))
                    for r in range(world) if rng.rand() < 0.95}
            round_events(evs, seq, begins, ends, mod)
            t += 1.0
        waves = [{"epoch": 1, "ts": 1000.0 + float(rng.uniform(0, 10))}]
        return evs, {"events": [{"ts": waves[0]["ts"] - 0.5, "kind": "wave_purged"}],
                     "waves": waves}
    return make


CASES = {"link-gate": link_gate, "compute-gate": compute_gate, "recovery": recovery,
         **{f"seeded-{s}": seeded_rounds(s) for s in range(8)}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_critical_path_equal_to_jax(name):
    reports = []
    for tmod, emod, cmod in ((ptrace, pevents, pcritical), (jtrace, jevents, jcritical)):
        evs, tele = CASES[name](emod)
        job = tmod.JobTrace(ranks={r: sorted(e, key=lambda x: x.ts) for r, e in evs.items()},
                            telemetry=tele)
        reports.append([cmod.critical_path_report(job, margin_sec=m, top_k=k)
                        for m, k in ((0.02, 3), (0.005, 1), (0.5, 5))])
    assert canon(reports[0]) == canon(reports[1])
    if name == "link-gate":
        top = reports[0][0]["top_gating_links"][0]
        assert (top["src"], top["dst"], top["rounds"]) == (1, 2, 3)
        assert top["streamed_wait_s"] == pytest.approx(1.45)
    elif name == "compute-gate":
        assert reports[0][0]["top_gating_ranks"][0]["rank"] == 2
    elif name == "recovery":
        assert reports[0][0]["rounds_recovery_affected"] == 1


@pytest.mark.parametrize("rank,ring", [(0, [0, 1, 2]), (2, [0, 1, 2]), (3, [0, 3, 5]),
                                       (0, [0, 3, 5]), (5, [5, 0, 3])])
def test_ring_prev_equal_to_jax(rank, ring):
    assert pcritical.ring_prev(rank, ring) == jcritical.ring_prev(rank, ring)


def test_fold_critical_path_equal_to_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    rep = {"schema": 1, "rounds_analyzed": 3, "top_gating_links": [{"src": 0, "dst": 1}],
           "top_gating_ranks": []}
    docs = []
    for name, mod in (("port", pcritical), ("jax", jcritical)):
        d = tmp_path / name
        d.mkdir()
        (d / "telemetry.json").write_text(json.dumps({"events": [], "world_size": 2}))
        assert mod.fold_critical_path(str(d), rep) is not None
        docs.append((d / "telemetry.json").read_text())
        assert mod.fold_critical_path(str(tmp_path / "absent"), rep) is None
    assert docs[0] == docs[1]
    assert json.loads(docs[0])["events"][0]["kind"] == "critical_path_folded"


# -- repair, the delta envelope, the config ---------------------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_repair_functions_equal_to_jax(seed):
    rng = np.random.RandomState(seed)
    world = int(rng.randint(2, 7))
    events = []
    for _ in range(int(rng.randint(0, 12))):
        ev = {"kind": rng.choice(["link_degraded", "link_degraded", "wave"]),
              "src": int(rng.randint(-1, world)), "dst": int(rng.randint(0, world))}
        if rng.rand() < 0.1:
            ev["src"] = "bad"
        events.append(ev)
    for n in (0, 1, 2):
        assert psched.links_from_events(events, n) == jsched.links_from_events(events, n)
    ring = list(rng.permutation(world))
    report = {"per_rank": {str(r): {"lateness_share": float(rng.rand())}
                           for r in range(world)}}
    report["per_rank"]["x"] = {"lateness_share": 1.0}
    for share in (0.1, 0.5, 0.9):
        assert psched.links_from_stragglers(report, ring, share) == \
            jsched.links_from_stragglers(report, ring, share)
    rank_map = {f"t{r}": int(p) for r, p in enumerate(rng.permutation(world))}
    links = {(int(rng.randint(world + 1)), int(rng.randint(world))) for _ in range(4)}
    tasks = psched.flags_to_tasks(links, rank_map)
    assert tasks == jsched.flags_to_tasks(links, rank_map)
    smaller = {t: r for t, r in rank_map.items() if rng.rand() < 0.7}
    assert psched.tasks_to_flags(tasks, smaller) == jsched.tasks_to_flags(tasks, smaller)


def test_stream_envelope_equal_to_jax():
    assert pstream.STREAM_METRICS == jstream.STREAM_METRICS
    assert pstream.STREAM_SCHEMA == jstream.STREAM_SCHEMA
    rng = np.random.RandomState(3)
    accs = [None, None]
    for _ in range(12):
        delta = {"counters": {pstream.series_name("wire_bytes", codec=c, fused=f):
                              int(rng.randint(1, 999))
                              for c in ("i8", "bf16") for f in (0, 1) if rng.rand() < 0.6},
                 "histograms": {}}
        if rng.rand() < 0.5:
            delta["histograms"]["link_wait_seconds{dst=1,src=0}"] = {
                "bounds": [0.1, 1.0], "counts": [int(rng.randint(3)), 1, 0], "count": 2,
                "sum": float(rng.rand()), "min": 0.01, "max": 0.5}
        job, rank = f"j{rng.randint(2)}", int(rng.randint(3))
        pd, jd = pstream.delta_doc(job, rank, delta), jstream.delta_doc(job, rank, delta)
        assert pd == jd
        accs = [pstream.merge_delta_doc(accs[0], pd), jstream.merge_delta_doc(accs[1], jd)]
        assert canon(accs[0]) == canon(accs[1])
        rendered = {"counters": dict(delta["counters"], raw_bytes=5,
                                     **{"wire_bytes{codec=x,fused=True}": 7})}
        assert pstream.wire_bytes_by_codec(rendered) == jstream.wire_bytes_by_codec(rendered)


def test_stream_names_are_declared():
    from rabit_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    pstream.stream_count("wire_bytes", 3, registry=reg, codec="i8", fused=0)
    pstream.stream_observe("link_wait_seconds", 0.2, registry=reg, src=0, dst=1)
    with pytest.raises(KeyError, match="wire_byte"):
        pstream.stream_count("wire_byte", 3, registry=reg)
    with pytest.raises(KeyError, match="link_wait"):
        pstream.stream_observe("link_wait", 0.1, registry=reg)
    assert reg.raw_state()["counters"] == {"wire_bytes{codec=i8,fused=0}": 3}


def test_diagnosis_config_keys_equal_to_jax():
    keys = [k for k in jconfig.DEFAULTS if k.startswith("rabit_diag_")] + ["rabit_sched_repair"]
    assert len(keys) == 9
    for k in keys:
        assert pconfig.DEFAULTS[k] == jconfig.DEFAULTS[k], k
    for argv in ([], ["rabit_sched_repair=0", "rabit_schedule=ring"]):
        want = jsched.resolve(jconfig.Config(argv))
        got = psched.resolve(pconfig.Config(argv))
        assert got == {k: want[k] for k in ("schedule", "mesh", "repair")}


# -- end to end, in threads ------------------------------------------------------------

def jax_like_job(seed: int, world: int, niter: int, schedule=None, **kw):
    """The port's job with run_elastic_schedule's draws for ``seed`` (its
    iteration sleep, schedule and dataset) and its bincount contribution;
    every completed state must equal the closed-form totals."""
    rng = random.Random(seed)
    rng.choice([0, 1, 2]), rng.choice([3, 4, 5])
    sleep = rng.choice([0.05, 0.1])
    if schedule is None:
        schedule = rng.choice(["auto", "tree", "ring", "swing"])
    n_rows, n_bins = 8 * world, 8
    data = np.array([rng.randrange(n_bins) for _ in range(n_rows)])

    def work(v, w, r):
        return np.bincount(data[shard_slice(n_rows, w, r)], minlength=n_bins).astype(
            np.int64) * v

    out = torch_diag_job.run_job(world, niter, work, seed=seed, schedule=schedule,
                                 iter_sleep=sleep, deadline_sec=60.0, **kw)
    want = sum(np.bincount(data, minlength=n_bins).astype(np.int64) * v
               for v in range(1, niter + 1))
    for res in out["results"].values():
        assert res.completed and np.array_equal(res.state, want), res.error
    return out


def every_incident(doc) -> list:
    return [(i["class"], i["subject"]) for i in doc["open"] + doc["recent"]]


E2E = {
    "slow-link": (dict(seed=11, world=3, niter=12, schedule="ring"),
                  dict(slow_link=(1, 2, 0.15), repair=True)),
    "straggler": (dict(seed=903, world=4, niter=10), dict(straggler=(2, 0.4))),
    "clean": (dict(seed=4242, world=3, niter=4), {}),
}


E2E_ATTEMPTS = 3


def on_one_attempt(check) -> None:
    """Run the timing-driven ``check`` up to E2E_ATTEMPTS times, until every
    assertion in it holds at once: a host busy with other tests can starve a
    worker thread long enough for either package's monitor to see a
    straggler that is not there."""
    for attempt in range(1, E2E_ATTEMPTS + 1):
        try:
            check()
            return
        except AssertionError:
            if attempt == E2E_ATTEMPTS:
                raise


@pytest.mark.parametrize("name", sorted(E2E))
def test_chaos_incidents_equal_to_jax(name):
    common, fault = E2E[name]

    def check():
        mine = jax_like_job(**common, **fault)
        theirs = jchaos.run_elastic_schedule(common["seed"], world=common["world"],
                                             niter=common["niter"],
                                             schedule=common.get("schedule"),
                                             deadline_sec=60.0, **fault)
        assert theirs.outcome == "completed"
        assert every_incident(mine["incidents"]) == every_incident(theirs.incidents)
        assert mine["incidents"]["n_opened"] == theirs.incidents["n_opened"]
        tele = mine["telemetry"]
        assert tele["incidents"]["n_opened"] == mine["incidents"]["n_opened"]
        assert tele["n_schedule_repaired"] == mine["n_repaired"]
        kinds = [e["kind"] for e in mine["events"]]
        assert kinds.count("incident_opened") == mine["incidents"]["n_opened"]
        if name == "slow-link":
            assert every_incident(mine["incidents"]) == [("degraded-link",
                                                          {"src": 1, "dst": 2})]
            inc = (mine["incidents"]["open"] + mine["incidents"]["recent"])[0]
            assert any(e["rule"] == "link-wait-attributed" for e in inc["evidence"])
            assert mine["n_repaired"] >= 1 and theirs.n_repaired >= 1
            ring = mine["rings"][-1]
            assert all((ring[i], ring[(i + 1) % 3]) != (1, 2) for i in range(3)), mine["rings"]
            assert mine["results"]["2"].slow_reports >= 1
        elif name == "straggler":
            assert every_incident(mine["incidents"]) == [("compute-straggler", {"rank": 2})]
        else:
            assert mine["incidents"]["n_opened"] == 0 and mine["n_repaired"] == 0

    on_one_attempt(check)


def test_jax_workers_under_the_port_tracker_get_incident_and_repair():
    """rabit_tpu's ElasticWorkers and its ChaosProxy against the port's
    tracker: the slow link's degraded-link incident, and the repair."""
    def check():
        out = jax_like_job(11, 3, 12, schedule="ring", slow_link=(1, 2, 0.15),
                           worker_cls=JaxWorker, proxy_cls=jchaos.ChaosProxy,
                           spec_cls=jchaos.FaultSpec)
        assert every_incident(out["incidents"]) == [("degraded-link", {"src": 1, "dst": 2})]
        assert out["n_repaired"] >= 1
        ring = out["rings"][-1]
        assert all((ring[i], ring[(i + 1) % 3]) != (1, 2) for i in range(3)), out["rings"]
        assert out["results"]["2"].slow_reports >= 1

    on_one_attempt(check)


def test_no_repair_when_sched_repair_is_off():
    """The control arm: the incident opens, the plan never changes."""
    def check():
        out = jax_like_job(11, 3, 12, schedule="ring", slow_link=(1, 2, 0.15), repair=False)
        assert every_incident(out["incidents"]) == [("degraded-link", {"src": 1, "dst": 2})]
        assert out["n_repaired"] == 0 and out["rings"] == [[0, 1, 2]]
        assert out["final"]["jobs"][""]["link_flags"] == 0

    on_one_attempt(check)


def test_chaos_proxy_faults_equal_to_jax():
    """The same seeded fault spec through each package's proxy in front of
    one echo server: the same refusals, truncations and forwarded bytes."""
    import socket
    import threading

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(64)

    def echo():
        while True:
            try:
                c, _ = srv.accept()
            except OSError:
                return
            with c:
                try:
                    while (data := c.recv(4096)):
                        c.sendall(data)
                except OSError:
                    pass

    threading.Thread(target=echo, daemon=True).start()
    stats = []
    try:
        for mod in (pchaos, jchaos):
            proxy = mod.ChaosProxy(srv.getsockname(), mod.FaultSpec(
                p_refuse=0.3, p_truncate=0.3, truncate_bytes=(1, 5)), seed=7).start()
            try:
                for i in range(20):
                    try:
                        with socket.create_connection((proxy.host, proxy.port),
                                                      timeout=2.0) as s:
                            s.settimeout(2.0)
                            s.sendall(b"0123456789")
                            s.shutdown(socket.SHUT_WR)
                            while s.recv(64):
                                pass
                    except OSError:
                        pass
            finally:
                proxy.stop()
            stats.append((proxy.stats.connections, proxy.stats.refused,
                          proxy.stats.truncated))
    finally:
        srv.close()
    assert stats[0] == stats[1] and stats[0][1] > 0 and stats[0][2] > 0
