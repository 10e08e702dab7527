"""Recovery-latency benchmark on the PyTorch/CUDA port: the counterpart of
tools/recovery_bench.py, with its modes, its CLI and defaults, and the keys
of its JSON records, driven against ``rabit_tpu_torch``.

Runs the self-verifying recovery workload (tests/workers/
torch_recover_worker.py, 10k floats x 3 iterations) under the port's
``LocalCluster`` twice per world size: clean, and with a mock death at
(rank 1, version 1, seq 1).  The difference is the end-to-end cost of
detecting the death, restarting the worker, re-bootstrapping the mesh,
replaying lost results, and serving the checkpoint.

Prints one JSON line per world size:
  {"world": N, "clean_s": ..., "failure_s": ..., "recovery_overhead_s": ...,
   "protocol_recovery_latency_s": ..., "detect_latency_s": ...,
   "recover_summary_rounds": ..., ...}

The process modes (the world sweep, ``--blob-mb``, ``--resume``) run numpy
workers over the port's native engine on the host CPU, as the JAX tool's
do: the workers import numpy and ``rabit_tpu_torch.api``, never torch, and
get the environment the port's launcher gives every worker (no card is
touched).  ``protocol_recovery_latency_s`` (the launcher seeing the death
-> the restarted worker's ``recovered_at`` stamp) leaves out the job's
first start, and its restart imports numpy and the port's api only: on a
machine where ``import torch`` alone takes seconds, a worker that imported
torch would add that much to it, to ``failure_s`` and to the resume rows.

``--elastic``: seeded promote/shrink/grow scenarios with in-thread
``ElasticWorker``s against the port's elastic tracker, the spare-promotion
latency against the shrink and grow-back latencies per world size, from
structured tracker events (``spare_promoted`` / ``world_shrunk`` /
``world_grown`` timestamps).

``--failover``: per world size, an in-thread elastic job with a warm
standby gets its primary tracker killed (``Tracker.kill()``) mid-run, with
and without a relay in front; rows report the takeover latency (kill ->
``tracker_failover``) and the recovery latency (kill -> the first
wave/commit after the takeover), all from structured events.

In both in-thread modes each worker's contribution is
``np.bincount(data[shard_slice(...)], minlength=8) * version``, computed
on ``--device`` (default ``cuda``) by the port's ``node_histograms_kernel``
through ``rabit_tpu_torch.chaos._shard_counter``: every call is held
against ``np.bincount`` and, on the card, the first against
``node_histograms_kernel_plain``.  ``cuda`` without a card raises; nothing
falls back to the CPU.

``--blob-mb B [B ...]``: the worker carries a B-MiB content-verified blob
in its global model, so the restarted rank's recovery streams a model
payload; rows report serve bytes and the effective restore bandwidth
(serve_bytes / protocol latency, a lower bound).

``--resume``: whole-job durable resume from a ``rabit_checkpoint_dir``
spill (``durable_resume`` records).

``--scale-sweep``: the simulated-world control-plane sweep of
tools/torch_scale_sweep.py (worlds 512 1024 2048 4096 unless given).

    python tools/torch_recovery_bench.py                  # worlds 4 8
    python tools/torch_recovery_bench.py 2 4 --blob-mb 1 16
    python tools/torch_recovery_bench.py --resume 2
    python tools/torch_recovery_bench.py --elastic 3 --device cpu
    python tools/torch_recovery_bench.py --failover 2 4   # on the card

Imports numpy and the port (torch through it), never JAX or ``rabit_tpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rabit_tpu_torch.tracker.launcher import LocalCluster  # noqa: E402

WORKER = str(REPO / "tests" / "workers" / "torch_recover_worker.py")

#: Bins of the in-thread modes' contribution (the row-5 kernel's width).
N_BINS = 8


def run_once(world: int, extra: list[str], timeout: float | None = None,
             max_restarts: int = 5):
    """Returns (wall_s, protocol_latency_s|None, events|None,
    detect_latency_s|None, resume_latency_s|None).  Protocol latency =
    from the launcher observing the death to the restarted worker's state
    being recovered from peers (its ``recovered_at`` stamp): the restart,
    the new life's start (numpy and the port's api, no torch), its
    bootstrap and the recovery.  Resume latency = launch -> the last rank's
    resumed-from-disk stamp; None unless the run resumed from a
    ``rabit_checkpoint_dir`` spill.  The defaults (mock engine, 10k
    floats, 3 iterations) come first; argv is last-match-wins in both the
    worker and the engine config, so anything in ``extra`` overrides.
    Every value comes from the tracker's structured events
    (``worker_recovered``, ``failure_detected``, ``recover_stats``,
    ``disk_resume``) and ``cluster.death_times``."""
    cmd = [sys.executable, WORKER, "rabit_engine=mock", "ndata=10000",
           "niter=3", *extra]
    cluster = LocalCluster(world, max_restarts=max_restarts, quiet=True)
    t0w = time.time()
    t0 = time.perf_counter()
    if timeout is None:
        timeout = max(180.0, world * 12.0)
    rc = cluster.run(cmd, timeout=timeout)
    dt = time.perf_counter() - t0
    if rc != 0 or any(r != 0 for r in cluster.returncodes.values()):
        raise RuntimeError(f"cluster failed: rc={rc} {cluster.returncodes}")
    resume_stamps = [ev["at"] for ev in cluster.events
                     if ev["kind"] == "disk_resume" and "at" in ev]
    resume_latency = (max(resume_stamps) - t0w) if resume_stamps else None
    latency = None
    stamps = [ev["recovered_at"] for ev in cluster.events
              if ev["kind"] == "worker_recovered" and "recovered_at" in ev]
    if stamps and cluster.death_times:
        latency = min(stamps) - cluster.death_times[0]
    # kill -> the first survivor noticing (EOF cascade or stall timeout)
    detect = None
    detects = [ev["at"] for ev in cluster.events
               if ev["kind"] == "failure_detected" and "at" in ev]
    if detects and cluster.death_times:
        detect = min(detects) - cluster.death_times[0]
    # the restarted life's LoadCheckPoint counters (rabit_recover_stats=1):
    # version > 0 names the recovered life, first lives report version 0
    events = None
    for ev in cluster.events:
        if ev["kind"] != "recover_stats" or ev.get("version", 0) <= 0:
            continue
        events = {
            "summary_rounds": ev["summary_rounds"],
            "table_rounds": ev["table_rounds"],
            "serve_bytes": ev["serve_bytes"],
        }
        if "summary_depth" in ev:
            events["summary_depth"] = ev["summary_depth"]
            events["table_hops"] = ev["table_hops"]
        break
    return dt, latency, events, detect, resume_latency


def world_sweep(worlds: list[int]) -> None:
    for world in worlds:
        clean = min(run_once(world, [])[0] for _ in range(2))
        fails = [
            run_once(world, ["mock=1,1,1,0", "rabit_recover_stats=1"])
            for _ in range(2)
        ]
        failure = min(f[0] for f in fails)
        lats = [f[1] for f in fails if f[1] is not None]
        events = next((f[2] for f in fails if f[2] is not None), None)
        detects = [f[3] for f in fails if f[3] is not None]
        rec = {
            "world": world,
            "clean_s": round(clean, 3),
            "failure_s": round(failure, 3),
            "recovery_overhead_s": round(failure - clean, 3),
            "protocol_recovery_latency_s":
                round(min(lats), 3) if lats else None,
            "detect_latency_s": round(min(detects), 3) if detects else None,
        }
        if events is not None:
            rec.update(
                recover_summary_rounds=events["summary_rounds"],
                recover_table_rounds=events["table_rounds"],
                recover_serve_bytes=events["serve_bytes"],
            )
            if "summary_depth" in events:
                rec.update(recover_summary_depth=events["summary_depth"],
                           recover_table_hops=events["table_hops"])
        print(json.dumps(rec), flush=True)


def blob_sweep(blob_mbs: list[float], worlds: list[int]) -> None:
    for world in worlds:
        for blob_mb in blob_mbs:
            fails = [
                run_once(world,
                         [f"blob_mb={blob_mb}", "mock=1,1,1,0",
                          "rabit_recover_stats=1"])
                for _ in range(2)
            ]
            lats = [f[1] for f in fails if f[1] is not None]
            events = next((f[2] for f in fails if f[2] is not None), None)
            lat = min(lats) if lats else None
            rec = {
                "blob_mb": blob_mb,
                "world": world,
                "failure_s": round(min(f[0] for f in fails), 3),
                "protocol_recovery_latency_s":
                    round(lat, 3) if lat else None,
            }
            if events is not None:
                rec["recover_serve_bytes"] = events["serve_bytes"]
                if lat:
                    rec["restore_bandwidth_mb_s"] = round(
                        events["serve_bytes"] / (1 << 20) / lat, 1)
            print(json.dumps(rec), flush=True)


def resume_sweep(blob_mbs: list[float], worlds: list[int]) -> None:
    """Whole-job (durable) resume timing: every worker dies, in-memory
    state is gone, and a fresh cluster resumes from the
    ``rabit_checkpoint_dir`` spill.

    Per row: job 1 runs niter=4 and exits cleanly at stop_at=2 (the
    aligned whole-job stop), job 2 resumes on the same directory and
    finishes.  resume_latency_s = job-2 launch -> the last rank's
    resumed-from-disk stamp (interpreter start, bootstrap, the resume
    consensus and the per-rank disk read).  fresh_wall_s (the same
    4-iteration job from scratch) isolates what resuming costs over a cold
    start at each payload size."""
    niter, stop_at = 4, 2
    for world in worlds:
        for blob_mb in blob_mbs:
            blob = [f"blob_mb={blob_mb}"] if blob_mb else []
            fresh = run_once(world, [f"niter={niter}", *blob])[0]
            with tempfile.TemporaryDirectory() as d:
                store = [f"rabit_checkpoint_dir={d}"]
                job1 = run_once(
                    world, [f"niter={niter}", f"stop_at={stop_at}",
                            *blob, *store])[0]
                wall, _, _, _, resume_latency = run_once(
                    world, [f"niter={niter}", *blob, *store],
                    max_restarts=0)
                if resume_latency is None:
                    raise RuntimeError("job 2 did not resume from disk")
            print(json.dumps({
                "mode": "durable_resume", "world": world,
                "blob_mb": blob_mb, "resumed_at_version": stop_at,
                "niter": niter,
                "fresh_wall_s": round(fresh, 3),
                "job1_wall_s": round(job1, 3),
                "resume_wall_s": round(wall, 3),
                "resume_latency_s": round(resume_latency, 3),
            }), flush=True)


def contribution_counter(world: int, device: str):
    """The in-thread modes' shard counter at ``world``: ``counts(rows)`` is
    ``np.bincount(data[rows], minlength=N_BINS)`` over ``data =
    arange(8 * world) % N_BINS``, one ``node_histograms_kernel`` call on
    ``device`` each (``counts.n_calls``; see ``chaos._shard_counter``).
    Raises for ``cuda`` without a card."""
    from rabit_tpu_torch.chaos import _shard_counter

    n_rows = 8 * world
    return _shard_counter(np.arange(n_rows) % N_BINS, N_BINS, device)


def _contribution(counter, n_rows: int, iter_sleep: float):
    from rabit_tpu_torch.elastic.rebalance import shard_slice

    def contribution(version, w, r):
        time.sleep(iter_sleep)
        return counter(shard_slice(n_rows, w, r)) * version

    return contribution


def _elastic_once(world: int, *, with_spare: bool, grow_back: bool,
                  shrink_after_sec: float, niter: int = 6,
                  iter_sleep: float = 0.05, kill_version: int = 2,
                  deadline_sec: float = 45.0, device: str = "cuda",
                  counter=None) -> dict:
    """One elastic scenario: kill rank-1's worker at ``kill_version``; with
    a spare parked the tracker must promote it within one wave, without
    one the wave closes shrunk after ``shrink_after_sec`` (and grows back
    when a late spare arrives, when ``grow_back``).  Latencies are death ->
    the membership event's ``ts``: the death instant is the dying worker
    thread's return, the membership instants are tracker-event timestamps.
    ``counter`` (a :func:`contribution_counter` of ``world``) lets the
    caller read the kernel's calls; by default one is made on
    ``device``."""
    from rabit_tpu_torch.elastic.client import ElasticWorker
    from rabit_tpu_torch.tracker.tracker import Tracker

    n_rows = 8 * world
    if counter is None:
        counter = contribution_counter(world, device)
    contribution = _contribution(counter, n_rows, iter_sleep)
    tracker = Tracker(world, quiet=True, shrink_after_sec=shrink_after_sec,
                      promote_after_sec=0.05).start()
    addr = (tracker.host, tracker.port)
    death_at = {}

    def run_worker(w: ElasticWorker) -> None:
        w.run()
        if w.fail is not None:
            death_at[w.task_id] = time.time()

    workers = [
        ElasticWorker(addr, str(i), contribution, niter,
                      heartbeat_sec=0.1, wave_timeout=15.0,
                      link_timeout=1.0, deadline_sec=deadline_sec,
                      fail=("die", kill_version) if i == 1 else None)
        for i in range(world)
    ]
    threads = [threading.Thread(target=run_worker, args=(w,), daemon=True)
               for w in workers]
    # a grow-back spare parks just after the shrink deadline would have
    # passed: the next version boundary's CMD_EPOCH poll sees the pool
    spare_delay = 0.0 if with_spare else (shrink_after_sec + 0.5
                                          if grow_back else None)

    def run_spare() -> None:
        if spare_delay:
            time.sleep(spare_delay)
        run_worker(ElasticWorker(addr, "s0", contribution, niter, spare=True,
                                 heartbeat_sec=0.1, wave_timeout=15.0,
                                 link_timeout=1.0,
                                 deadline_sec=deadline_sec))

    spare_th = (threading.Thread(target=run_spare, daemon=True)
                if spare_delay is not None else None)
    try:
        for th in threads:
            th.start()
        if spare_th is not None:
            spare_th.start()
        for th in threads:
            th.join(timeout=deadline_sec + 5.0)
            if th.is_alive():
                raise TimeoutError(f"elastic bench world={world}: hang")
    finally:
        tracker.stop()
        if spare_th is not None:
            spare_th.join(timeout=10.0)
    t_death = death_at.get("1")

    def first_ts(kind):
        return next((e["ts"] for e in tracker.events if e["kind"] == kind),
                    None)

    def lat(ts):
        return (round(ts - t_death, 3)
                if ts is not None and t_death is not None else None)

    return {
        "promote_latency_s": lat(first_ts("spare_promoted")),
        "shrink_latency_s": lat(first_ts("world_shrunk")),
        "grow_latency_s": lat(first_ts("world_grown")),
        "epochs": [{"epoch": we.epoch, "world": we.world_size}
                   for we in tracker.elastic.history],
    }


def _failover_once(world: int, *, relays: int, kill_at: float = 0.8,
                   niter: int = 10, iter_sleep: float = 0.12,
                   takeover_sec: float = 0.5,
                   deadline_sec: float = 60.0, device: str = "cuda",
                   counter=None) -> dict:
    """One HA failover scenario: an in-thread elastic job with a warm
    standby, the primary killed abruptly at ``kill_at``.  takeover = kill
    -> ``tracker_failover`` ts, recovery = kill -> the first post-failover
    progress (a wave closed on the standby, and the first worker commit
    after the cut).  The last rank dies a few versions after the tracker
    kill, so the survivors must re-wave on the promoted standby (shrink):
    a run that completes proves the failover carried a recovery wave.
    Every survivor's state is held to its closed form.  ``counter`` as in
    :func:`_elastic_once`."""
    from rabit_tpu_torch.elastic.client import ElasticWorker
    from rabit_tpu_torch.ha import Journal, Standby
    from rabit_tpu_torch.relay import Relay
    from rabit_tpu_torch.tracker.tracker import Tracker

    n_rows = 8 * world
    if counter is None:
        counter = contribution_counter(world, device)
    contribution = _contribution(counter, n_rows, iter_sleep)
    data = np.arange(n_rows) % N_BINS
    expected = sum(np.bincount(data, minlength=N_BINS).astype(np.int64) * v
                   for v in range(1, niter + 1))
    die_at = max(2, int(round(kill_at / iter_sleep)) + 2)  # post-failover
    tracker_kwargs = dict(quiet=True, promote_after_sec=0.05,
                          shrink_after_sec=0.8)
    tracker = Tracker(world, journal=Journal(None),
                      **tracker_kwargs).start()
    addr = (tracker.host, tracker.port)
    standby = Standby(primary=addr, takeover_sec=takeover_sec,
                      poll_sec=0.05,
                      tracker_kwargs=tracker_kwargs).start()
    addrs = [addr, (standby.host, standby.port)]
    relay_objs = [Relay(addrs, relay_id=f"relay{i}", flush_sec=0.1,
                        quiet=True).start() for i in range(relays)]

    def worker_target(i: int):
        if not relay_objs:
            return addrs
        r = relay_objs[i % len(relay_objs)]
        return (r.host, r.port)

    results = {}

    def run_worker(w):
        results[w.task_id] = w.run()

    workers = [ElasticWorker(worker_target(i), str(i), contribution, niter,
                             heartbeat_sec=0.15, wave_timeout=15.0,
                             link_timeout=2.0, deadline_sec=deadline_sec,
                             fail=(("die", die_at) if i == world - 1
                                   else None))
               for i in range(world)]
    threads = [threading.Thread(target=run_worker, args=(w,), daemon=True)
               for w in workers]
    try:
        for th in threads:
            th.start()
        time.sleep(kill_at)
        t_kill = time.time()
        t_kill_mono = time.monotonic()
        tracker.kill()
        for th in threads:
            th.join(timeout=deadline_sec + 10.0)
            if th.is_alive():
                raise TimeoutError(f"failover bench world={world}: hang")
    finally:
        standby.stop()
        tracker.stop()
        for r in relay_objs:
            r.stop()
    for res in results.values():
        if res.died:
            continue  # the scheduled post-failover death
        if not res.completed or not np.array_equal(res.state, expected):
            raise RuntimeError(f"failover bench world={world}: worker "
                               f"{res.task_id} wrong/incomplete "
                               f"({res.error!r})")
    promoted = standby.tracker
    events = list(tracker.events) + (list(promoted.events)
                                     if promoted is not None else [])
    t_failover = next((e["ts"] for e in events
                       if e["kind"] == "tracker_failover"), None)
    post_waves = [e["ts"] for e in events
                  if e["kind"] == "wave" and e["ts"] > (t_failover or 1e18)]
    # the first commit strictly after the kill (monotonic clock, the
    # workers' commit_times basis)
    post_commits = [ts for res in results.values()
                    for ts in res.commit_times.values()
                    if ts > t_kill_mono]
    return {
        "mode": "ha_failover", "world": world, "relays": relays,
        "kill_at_s": kill_at, "takeover_sec": takeover_sec,
        "takeover_latency_s": (round(t_failover - t_kill, 3)
                               if t_failover is not None else None),
        "first_wave_after_s": (round(min(post_waves) - t_kill, 3)
                               if post_waves else None),
        "first_commit_after_s": (round(min(post_commits) - t_kill_mono, 3)
                                 if post_commits else None),
        # exactly one expected: the scheduled post-failover death's lease,
        # expired by the standby; more would be live ranks suspected
        "n_lease_expired": sum(
            1 for e in events if e["kind"] == "lease_expired"),
    }


def failover_sweep(worlds: list[int], device: str = "cuda") -> list[dict]:
    """The --failover mode: kill-the-primary latency rows, direct and
    through a relay tier, per world size."""
    out = []
    for world in worlds:
        for relays in (0, 1):
            rec = _failover_once(world, relays=relays, device=device)
            out.append(rec)
            print(json.dumps(rec), flush=True)
    return out


def elastic_sweep(worlds: list[int], shrink_after_sec: float = 1.0,
                  device: str = "cuda") -> list[dict]:
    """The promotion-vs-shrink curve: per world size, the same induced
    death handled by a parked spare (promotion latency) and by the shrink
    deadline and a late grow-back (shrink/grow latencies)."""
    out = []
    for world in worlds:
        promote = _elastic_once(world, with_spare=True, grow_back=False,
                                shrink_after_sec=shrink_after_sec,
                                device=device)
        # a slower, longer job, so version boundaries remain after the
        # shrink for the grow-back wave to land on
        shrink = _elastic_once(world, with_spare=False, grow_back=True,
                               shrink_after_sec=shrink_after_sec,
                               niter=16, iter_sleep=0.15, device=device)
        rec = {
            "mode": "elastic", "world": world,
            "shrink_after_sec": shrink_after_sec,
            "promote_latency_s": promote["promote_latency_s"],
            "promote_epochs": promote["epochs"],
            "shrink_latency_s": shrink["shrink_latency_s"],
            "grow_latency_s": shrink["grow_latency_s"],
            "shrink_epochs": shrink["epochs"],
        }
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("worlds", nargs="*", type=int, default=None)
    ap.add_argument("--blob-mb", nargs="+", type=float, default=None,
                    help="checkpoint-serve scaling mode: blob sizes in MiB")
    ap.add_argument("--resume", action="store_true",
                    help="durable whole-job resume timing mode (combine "
                         "with --blob-mb for payload scaling; blob 0 rows "
                         "come from plain --resume)")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic-membership mode: spare-promotion vs "
                         "shrink-wave latency per world size")
    ap.add_argument("--failover", action="store_true",
                    help="HA failover mode: primary-tracker kill -> "
                         "standby takeover / first post-failover "
                         "progress latency, with and without relays")
    ap.add_argument("--shrink-after", type=float, default=1.0,
                    help="elastic mode's rabit_shrink_after_sec")
    ap.add_argument("--scale-sweep", action="store_true",
                    help="simulated-world recovery/bootstrap wave sweep "
                         "(worlds from the positional args, default "
                         "512 1024 2048 4096)")
    ap.add_argument("--device", default="cuda",
                    help="where the in-thread modes' contributions run "
                         "(cuda or cpu)")
    args = ap.parse_args(argv)
    if args.scale_sweep:
        from tools.torch_scale_sweep import scale_sweep

        scale_sweep(args.worlds or [512, 1024, 2048, 4096])
    elif args.failover:
        failover_sweep(args.worlds or [2, 4], device=args.device)
    elif args.elastic:
        elastic_sweep(args.worlds or [2, 4], args.shrink_after,
                      device=args.device)
    elif args.resume:
        resume_sweep(args.blob_mb or [0.0], args.worlds or [4])
    elif args.blob_mb:
        blob_sweep(args.blob_mb, args.worlds or [4])
    else:
        world_sweep(args.worlds or [4, 8])


if __name__ == "__main__":
    main()
