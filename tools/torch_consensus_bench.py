"""The schedule tool on the PyTorch/CUDA port (the counterpart of
tools/consensus_bench.py): the same modes, flags and JSON lines, on the
port's tracker, ``ElasticWorker``, chaos runners and native engine.

* default (latency) mode: tiny-payload robust allreduce latency at
  ``--world`` with the consensus round's summary fast path on
  (``rabit_consensus_summary=1``) and forced off, through the port's
  launcher and native engine;
* ``--smoke``: one in-thread elastic job per ``rabit_schedule`` value
  (auto/tree/ring/swing); all four must complete bitwise identically and
  match the closed form.  Each contribution is a histogram of the rank's
  shard by ``ops.hist.node_histograms_kernel`` on ``--device`` (the card by
  default; ``cpu`` takes its plain twin), held against ``np.bincount``;
* ``--schedule-ablation``: the planner's cost-model curve on a simulated
  mesh (no cluster), with a degraded-link column;
* ``--slow-link-e2e``: a chaos ``slow_link`` schedule with repair off then
  on; the dst worker's link wait must drop once the ring routes around it;
* ``--quorum-ablation``: live-rank rounds/sec with a compute straggler,
  quorum off vs on vs on+i8;
* ``--scale-sweep``: ``tools/torch_scale_sweep.py``'s serving arms.

Usage:  python tools/torch_consensus_bench.py [--world 32] [--iters 200]
        [--smoke|--schedule-ablation|--slow-link-e2e|--quorum-ablation]
        [--device cuda|cpu]
Prints one JSON line per mode.  Imports torch, numpy and the port only.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

WORKER_SRC = """
import sys, time
import numpy as np
import rabit_tpu_torch as rt

iters = int(sys.argv[1])
out_path = sys.argv[2]
rt.init()
rank = rt.get_rank()
x = np.zeros(4, np.float32)
rt.allreduce(x, rt.SUM)  # warm links
t0 = time.perf_counter()
for _ in range(iters):
    rt.allreduce(x, rt.SUM)
dt = time.perf_counter() - t0
if rank == 0:
    with open(out_path, "w") as f:
        f.write(str(dt / iters))
rt.finalize()
"""


def run_mode(world: int, iters: int, summary_on: bool) -> tuple[float, dict]:
    """Per-op seconds of a 4-float robust allreduce at ``world``, and rank
    0's protocol counters from its ``recover_stats_final`` event."""
    from rabit_tpu_torch.tracker.launcher import LocalCluster

    with tempfile.TemporaryDirectory() as td:
        worker = Path(td) / "worker.py"
        worker.write_text(WORKER_SRC)
        out = Path(td) / "t.txt"
        cluster = LocalCluster(world, quiet=True, extra_env={"PYTHONPATH": str(REPO)})
        cmd = [sys.executable, str(worker), str(iters), str(out), "rabit_engine=native",
               "rabit_recover_stats=1", f"rabit_consensus_summary={int(summary_on)}"]
        rc = cluster.run(cmd, timeout=1200.0)
        assert rc == 0, f"cluster failed rc={rc}"
        # Per-op critical-path depth: the protocol's O(log W) against O(W),
        # which wall clocks at oversubscribed worlds cannot show.
        stats: dict = {}
        for ev in cluster.events:
            if ev["kind"] == "recover_stats_final" and ev.get("rank") == 0:
                sr = ev.get("summary_rounds", 0)
                tr = ev.get("table_rounds", 0)
                if sr:
                    stats["depth_per_summary"] = round(ev["summary_depth"] / sr, 2)
                if tr:
                    stats["hops_per_table"] = round(ev["table_hops"] / tr, 2)
                break
        return float(out.read_text()), stats


# -- the schedule surface ------------------------------------------------------

def schedule_job(world: int, niter: int, schedule: str, mesh: str = "", repair: bool = True,
                 device: str = "cuda", obs_dir: str | None = None, counts=None) -> dict:
    """One in-thread elastic job of ``world`` workers and ``niter`` versions
    on a tracker planning ``schedule`` on the mesh model ``mesh`` (with
    ``repair`` its ``sched_repair``).  Each
    contribution is the histogram of the rank's shard of a fixed column of
    16 bins, times the version, by ``node_histograms_kernel`` on ``device``
    (``counts``: a ``chaos._shard_counter`` over that column to reuse);
    every worker's state must be the closed form.  Returns the states, the
    tracker's ``schedule_planned`` events and its telemetry document (also
    ``telemetry.json`` in ``obs_dir``), and the kernel calls made."""
    import threading

    import numpy as np

    from rabit_tpu_torch.chaos import _shard_counter
    from rabit_tpu_torch.elastic.client import ElasticWorker
    from rabit_tpu_torch.elastic.rebalance import shard_slice
    from rabit_tpu_torch.tracker.tracker import Tracker

    n_rows, n_bins = 8 * world, 16
    data = (np.arange(n_rows, dtype=np.int64) * 7) % n_bins
    if counts is None:
        counts = _shard_counter(data, n_bins, device)
    n_before = counts.n_calls

    def contribution(version: int, w: int, r: int) -> np.ndarray:
        return counts(shard_slice(n_rows, w, r)) * version

    expected = sum(np.bincount(data, minlength=n_bins).astype(np.int64) * v
                   for v in range(1, niter + 1))
    tracker = Tracker(world, quiet=True, obs_dir=obs_dir, schedule=schedule,
                      sched_mesh=mesh, sched_repair=repair).start()
    results: dict[str, object] = {}
    lock = threading.Lock()

    def run_one(w: ElasticWorker) -> None:
        res = w.run()
        with lock:
            results[w.task_id] = res

    workers = [ElasticWorker((tracker.host, tracker.port), str(i), contribution, niter,
                             wave_timeout=10.0, link_timeout=5.0, deadline_sec=30.0)
               for i in range(world)]
    threads = [threading.Thread(target=run_one, args=(w,), daemon=True) for w in workers]
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=40.0)
            assert not th.is_alive(), f"{schedule}: worker thread hung"
    finally:
        tracker.stop()
    for tid, res in sorted(results.items()):
        assert res.completed, f"{schedule}: worker {tid} failed: {res.error}"
        assert np.array_equal(res.state, expected), (
            f"{schedule}: worker {tid} bits diverge from closed form")
    planned = [e for e in tracker.events if e["kind"] == "schedule_planned"]
    assert planned, f"{schedule}: no schedule_planned event"
    return {"states": {t: r.state for t, r in results.items()}, "planned": planned,
            "telemetry": tracker.telemetry, "n_contributions": counts.n_calls - n_before}


def run_smoke(world: int = 3, niter: int = 3, device: str = "cuda") -> dict:
    """One in-thread elastic job per ``rabit_schedule`` value
    (``schedule_job``); every mode must complete with the same bits, the
    closed form's.  Each contribution's histogram runs on ``device``
    (``node_histograms_kernel`` on the card); ``n_contributions`` is the
    number of kernel calls."""
    import numpy as np

    from rabit_tpu_torch import sched
    from rabit_tpu_torch.chaos import _shard_counter
    from rabit_tpu_torch.config import Config

    n_rows, n_bins = 8 * world, 16
    counts = _shard_counter((np.arange(n_rows, dtype=np.int64) * 7) % n_bins, n_bins, device)
    out: dict = {"bench": "schedule_smoke", "world": world, "niter": niter, "modes": {}}
    states: dict[str, np.ndarray] = {}
    for algo in sched.ALGOS:
        knobs = sched.resolve(Config([f"rabit_schedule={algo}"]))
        job = schedule_job(world, niter, knobs["schedule"], knobs["mesh"], knobs["repair"],
                           device, counts=counts)
        states[algo] = job["states"]["0"]
        out["modes"][algo] = {"resolved": job["planned"][-1]["algo"],
                              "ring_order": job["planned"][-1]["ring_order"],
                              "completed": len(job["states"])}
    reference = states["tree"]
    out["bitwise_identical"] = all(np.array_equal(states[a], reference) for a in states)
    assert out["bitwise_identical"], "schedules diverged bitwise"
    out["device"] = str(device)
    out["n_contributions"] = counts.n_calls
    return out


def schedule_ablation(worlds=(64, 128, 256, 384, 512), mesh_spec: str = "",
                      slow_factor: float = 8.0) -> list[dict]:
    """The planner's cost-model curve (no cluster): per world, the fixed
    tree+ring layout against the planned identity ring and the Swing
    serpentine ring on the simulated mesh, in lockstep-round units.  The
    degraded columns slow one ring link by ``slow_factor`` and compare the
    unrepaired plan with the repaired one."""
    from rabit_tpu_torch import sched

    lines = []
    for world in worlds:
        mesh = sched.mesh_for_world(world, mesh_spec)
        ring = sched.ring_cost(sched.plan(world, "ring").ring_order, mesh)
        swing_plan = sched.plan(world, "swing")
        swing = sched.ring_cost(swing_plan.ring_order, mesh)
        tree = sched.tree_cost(world, mesh)
        # degrade the first planned ring link; the repaired plan must route
        # around it and shed the slow factor from the bottleneck
        bad = swing_plan.links()[0]
        slow = {bad: slow_factor}
        unrepaired = sched.ring_cost(swing_plan.ring_order, mesh, slow=slow)
        repaired_plan = sched.plan(world, "swing", avoid={bad})
        repaired = sched.ring_cost(repaired_plan.ring_order, mesh, slow=slow)
        lines.append({
            "bench": "schedule_ablation",
            "world": world,
            "mesh": f"{mesh.rows}x{mesh.cols}" + ("" if mesh.wrap else ":nowrap"),
            "tree_depth": tree["depth"],
            "tree_critical_path": tree["critical_path"],
            "ring_round_cost": ring["round_cost"],
            "swing_round_cost": swing["round_cost"],
            "swing_vs_fixed_ring": round(ring["round_cost"] / swing["round_cost"], 2)
            if swing["round_cost"] else 1.0,
            "degraded_link": list(bad),
            "slow_factor": slow_factor,
            "degraded_unrepaired_cost": unrepaired["round_cost"],
            "degraded_repaired_cost": repaired["round_cost"],
            "repair_gain": round(unrepaired["round_cost"] / repaired["round_cost"], 2)
            if repaired["round_cost"] else 1.0,
            "repaired_avoided": [list(link) for link in repaired_plan.avoided],
        })
    return lines


def slow_link_e2e(world: int = 3, delay: float = 0.12, niter: int = 8, seed: int = 5,
                  device: str = "cuda") -> dict:
    """The live degraded-link A/B: the same chaos ``slow_link`` schedule
    with repair off then on; the dst worker's link wait must drop once the
    repaired ring routes around the link."""
    from rabit_tpu_torch.chaos import run_elastic_schedule

    link = (1, 2, delay)
    off = run_elastic_schedule(seed, world=world, schedule="ring", slow_link=link,
                               repair=False, niter=niter, deadline_sec=60.0, device=device)
    on = run_elastic_schedule(seed, world=world, schedule="ring", slow_link=link,
                              repair=True, niter=niter, deadline_sec=60.0, device=device)
    return {
        "bench": "slow_link_e2e",
        "world": world,
        "slow_link": list(link),
        "niter": niter,
        "unrepaired_dst_wait_s": off.dst_wait_s,
        "repaired_dst_wait_s": on.dst_wait_s,
        "wait_drop": round(off.dst_wait_s / on.dst_wait_s, 2)
        if on.dst_wait_s else float("inf"),
        "n_repaired_waves": on.n_repaired,
        "dst_reported": on.dst_slow_reports,
        "routed_around": on.n_repaired >= 1 and on.dst_wait_s < off.dst_wait_s,
    }


def quorum_ablation(world: int = 3, niter: int = 40, iter_sleep: float = 0.02,
                    straggler_factor: float = 8.0, quorum: str = "0.6", seed: int = 2601,
                    device: str = "cuda") -> dict:
    """Task 0's round cadence with a compute straggler (``straggler_factor``
    x the round's sleep on one rank), quorum off vs on vs on+i8: off gates
    every round on the straggler, on tracks the median worker (the bar:
    within 1.3x of the run with no straggler).  Each arm's correctness is
    asserted inside ``run_elastic_schedule``."""
    from rabit_tpu_torch.chaos import run_elastic_schedule

    delay = straggler_factor * iter_sleep
    strag = (world - 1, delay)

    def arm(label: str, **kw) -> dict:
        r = run_elastic_schedule(seed, world=world, schedule="ring", niter=niter,
                                 iter_sleep=iter_sleep, deadline_sec=120.0, device=device,
                                 **kw)
        assert r.outcome == "completed", f"{label}: {r}"
        return {
            "elapsed_s": round(r.elapsed, 3),
            "cadence_s": r.cadence_s,
            "rounds_per_sec": round(1.0 / r.cadence_s, 2) if r.cadence_s else 0.0,
            "n_quorum_met": r.n_quorum_met,
            "n_corrections_folded": r.n_corrections_folded,
        }

    arms = {
        "base": arm("base"),
        "straggler_off": arm("straggler_off", straggler=strag),
        "straggler_on": arm("straggler_on", straggler=strag, quorum=quorum),
        "straggler_on_i8": arm("straggler_on_i8", straggler=strag, quorum=quorum,
                               codec="i8"),
    }
    base_c = arms["base"]["cadence_s"] or 1e-9
    out = {
        "bench": "quorum_ablation",
        "world": world,
        "niter": niter,
        "iter_sleep_s": iter_sleep,
        "straggler_factor": straggler_factor,
        "straggler_rank": strag[0],
        "quorum": quorum,
        "arms": arms,
        "off_cadence_vs_base": round(arms["straggler_off"]["cadence_s"] / base_c, 2),
        "on_cadence_vs_base": round(arms["straggler_on"]["cadence_s"] / base_c, 2),
        "on_i8_cadence_vs_base": round(arms["straggler_on_i8"]["cadence_s"] / base_c, 2),
    }
    out["within_1_3x"] = out["on_cadence_vs_base"] <= 1.3
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=32)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny-world schedule sanity: all rabit_schedule values must "
                         "converge bitwise-identically")
    ap.add_argument("--schedule-ablation", action="store_true",
                    help="planner cost-model curve on a simulated mesh")
    ap.add_argument("--slow-link-e2e", action="store_true",
                    help="live chaos slow_link repair A/B")
    ap.add_argument("--quorum-ablation", action="store_true",
                    help="rounds/sec vs an injected straggler: quorum off/on/on+i8")
    ap.add_argument("--scale-sweep", action="store_true",
                    help="simulated-world control-plane sweep: threaded, reactor and "
                         "relayed serving (tools/torch_scale_sweep.py)")
    ap.add_argument("--scale-worlds", type=int, nargs="*", default=[512, 1024, 2048, 4096],
                    help="worlds for --scale-sweep")
    ap.add_argument("--quorum", default="0.6", help="rabit_quorum spec for --quorum-ablation")
    ap.add_argument("--quorum-niter", type=int, default=40)
    ap.add_argument("--straggler-factor", type=float, default=8.0)
    ap.add_argument("--worlds", type=int, nargs="*", default=[64, 128, 256, 384, 512],
                    help="worlds for --schedule-ablation")
    ap.add_argument("--mesh", default="", help="mesh spec RxC[:nowrap] for --schedule-ablation")
    ap.add_argument("--slow-factor", type=float, default=8.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the contributions' histograms run (the live modes)")
    args = ap.parse_args(argv)
    if args.smoke:
        print(json.dumps(run_smoke(device=args.device)), flush=True)
        return
    if args.schedule_ablation:
        for line in schedule_ablation(tuple(args.worlds), args.mesh, args.slow_factor):
            print(json.dumps(line), flush=True)
        return
    if args.slow_link_e2e:
        print(json.dumps(slow_link_e2e(device=args.device)), flush=True)
        return
    if args.quorum_ablation:
        print(json.dumps(quorum_ablation(niter=args.quorum_niter, quorum=args.quorum,
                                         straggler_factor=args.straggler_factor,
                                         device=args.device)), flush=True)
        return
    if args.scale_sweep:
        from tools.torch_scale_sweep import scale_sweep

        scale_sweep(args.scale_worlds)
        return
    results = {}
    for on in (True, False):
        per_op, stats = run_mode(args.world, args.iters, on)
        mode = "summary_ologw" if on else "table_ow"
        results[mode] = per_op
        print(json.dumps({"bench": "consensus_healthy_path", "mode": mode,
                          "world": args.world, "iters": args.iters,
                          "per_op_ms": round(per_op * 1e3, 3), **stats}), flush=True)
    print(json.dumps({"bench": "consensus_healthy_path", "world": args.world,
                      "speedup_summary_vs_table": round(
                          results["table_ow"] / results["summary_ologw"], 2)}), flush=True)


if __name__ == "__main__":
    main()
