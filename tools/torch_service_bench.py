"""The multi-tenant service under load: N concurrent jobs on one control plane.

The port's counterpart of ``tools/service_bench.py``, with its record keys,
driven against ``rabit_tpu_torch``'s ``CollectiveService``, ``Relay``,
``ElasticWorker`` and ``PooledWorker``.  One service and a shared relay tier
serve N concurrent jobs of in-process worker threads on real sockets:

* ``clean``: N jobs admitted one after another (``stagger`` apart), their
  workers dialing through the relays; jobs a second, each job's wall
  time, and the p50 and p99 bootstrap latency (a worker's start to its
  first contribution);
* ``chaos``: the same N jobs with one victim, either a straggler (its rank
  1 slower by ``straggle`` seconds every round) or a kill (rank 1 dies
  silently mid-run and a new life checks in).  Every neighbour must
  complete bitwise equal to the closed form, and its wall time stay within
  ``bar`` times its clean run (asserted with ``assert_isolation``);
* ``pooled``: ``pool`` warm pooled workers serve ``pool_jobs`` pool-filled
  fits one after another; fits a second and leases a worker;
* ``summary``: the service's telemetry section and the relays' stats.

A rank's contribution of round ``v`` is ``np.full(8, v * (rank + 1))``
computed on ``device`` by ``ops.hist.node_histograms_kernel``: the g plane
of the ``[1, 1, 8, 2]`` histogram of 8 rows with bins 0..7, node 0 and
g = h = v * (rank + 1).  Each call is held exactly against the closed form
and, on the card, the first against ``node_histograms_kernel_plain`` (small
integers are exact in the hi/lo bf16 planes and in f32); ``device="cpu"``
takes the plain twin, so the numbers, and every bitwise check, are the JAX
package tool's.  Launches are serialized under one lock, so the kernel's
launch counter counts the contributions exactly.  The JAX tool's
``observed`` arm is not here.

    python tools/torch_service_bench.py --jobs 4 --world 2 --niter 2 --sleep 0.02 \\
        --relays 1 --straggle 0.25 --pool 2 --pool-jobs 2 --smoke

One JSON line a record.  Imports the port only (and the stdlib, numpy and
torch).
"""

from __future__ import annotations

import argparse
import io
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rabit_tpu_torch.elastic.client import ElasticWorker  # noqa: E402
from rabit_tpu_torch.relay import Relay  # noqa: E402
from rabit_tpu_torch.service import CollectiveService, PooledWorker  # noqa: E402
from rabit_tpu_torch.tracker import protocol as P  # noqa: E402

WIDTH = 8  # a contribution's length: the histogram's bins


def assert_legacy_wire_identical() -> None:
    """An empty job key writes the single-job hello byte for byte; a keyed
    one does not.  Checked on encoded bytes."""
    class _Sink:
        def __init__(self):
            self.buf = io.BytesIO()

        def sendall(self, data):
            self.buf.write(data)

    legacy, empty, keyed = _Sink(), _Sink(), _Sink()
    P.send_hello(legacy, P.CMD_START, "7", prev_rank=2, listen_port=9999)
    P.send_hello(empty, P.CMD_START, "7", prev_rank=2, listen_port=9999, job="")
    P.send_hello(keyed, P.CMD_START, "7", prev_rank=2, listen_port=9999, job="jx")
    assert empty.buf.getvalue() == legacy.buf.getvalue(), "an empty job key changed the wire"
    assert keyed.buf.getvalue() != legacy.buf.getvalue()


def expected_state(world: int, niter: int, width: int = WIDTH) -> np.ndarray:
    """The closed form: contribution(v, w, r) = v * (r + 1) everywhere,
    folded over the ranks and summed over the rounds."""
    ranks = world * (world + 1) // 2
    vers = niter * (niter + 1) // 2
    return np.full(width, ranks * vers, np.int64)


class DeviceFill:
    """``fill(value)``: ``np.full(WIDTH, value)`` as int64, computed by
    ``node_histograms_kernel`` on ``device`` (the module docstring).
    ``n_calls`` counts the kernel calls."""

    def __init__(self, device: str):
        import torch

        from rabit_tpu_torch.ops import hist

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("torch_service_bench: device='cuda' but no CUDA device is "
                               "available (pass device='cpu')")
        self._torch, self._hist = torch, hist
        self._xb = torch.arange(WIDTH, dtype=torch.int32, device=self.device).reshape(-1, 1)
        self._node = torch.zeros(WIDTH, dtype=torch.int32, device=self.device)
        self._lock = threading.Lock()
        self.n_calls = 0

    def __call__(self, value: int) -> np.ndarray:
        gh = self._torch.full((WIDTH,), float(value), dtype=self._torch.float32,
                              device=self.device)
        args = (self._xb, gh, gh, self._node, 1, WIDTH)
        with self._lock:
            got = self._hist.node_histograms_kernel(*args)[0, 0, :, 0].cpu().numpy()
            self.n_calls += 1
            first = self.n_calls == 1
        want = np.full(WIDTH, value, np.float32)
        if not np.array_equal(got, want):
            raise AssertionError(f"node_histograms_kernel gave {got!r}, want {want!r}")
        if first and self.device.type == "cuda":
            plain = self._hist.node_histograms_kernel_plain(*args)[0, 0, :, 0].cpu().numpy()
            if not np.array_equal(got, plain):
                raise AssertionError(f"node_histograms_kernel gave {got!r}, "
                                     f"node_histograms_kernel_plain {plain!r}")
        return got.astype(np.int64)


class JobRun:
    """One job's workers and measurements."""

    def __init__(self, key: str, world: int, niter: int, sleep: float, addr: tuple[str, int],
                 deadline: float, fill: DeviceFill,
                 straggler: tuple[int, float] | None = None,
                 kill: tuple[int, int] | None = None):
        self.key = key
        self.world = world
        self.niter = niter
        self.results: dict[str, object] = {}
        self.boot_lat: list[float] = []
        self.wall = -1.0
        self._lock = threading.Lock()
        self._addr = addr
        self._deadline = deadline
        self._sleep = sleep
        self._fill = fill
        self._straggler = straggler  # (rank, extra seconds)
        self._kill = kill            # (rank, at version)

    def _contribution(self, first: list[float]):
        sleep, straggler, fill = self._sleep, self._straggler, self._fill

        def contribution(v: int, world: int, rank: int) -> np.ndarray:
            if first[0] < 0:
                first[0] = time.monotonic()  # the first work: booted
            time.sleep(sleep)
            if straggler is not None and rank == straggler[0]:
                time.sleep(straggler[1])
            return fill(v * (rank + 1))

        return contribution

    def _run_worker(self, i: int, fail: tuple | None = None) -> None:
        t0 = time.monotonic()
        first = [-1.0]
        w = ElasticWorker(self._addr, str(i), self._contribution(first), self.niter,
                          job=self.key, deadline_sec=self._deadline, rpc_timeout=2.0,
                          wave_timeout=20.0, fail=fail)
        res = w.run()
        with self._lock:
            key = f"{i}" + ("+respawn" if fail is None and f"{i}" in self.results else "")
            self.results[key] = res
            if first[0] > 0:
                self.boot_lat.append(first[0] - t0)

    def run(self) -> "JobRun":
        t0 = time.monotonic()
        threads = []
        for i in range(self.world):
            fail = ("die", self._kill[1]) if self._kill is not None and i == self._kill[0] \
                else None
            threads.append(threading.Thread(target=self._run_worker, args=(i,),
                                            kwargs={"fail": fail}, daemon=True))
        for t in threads:
            t.start()
        if self._kill is not None:
            # the new life: it checks in after the silent death and rides
            # the recovery wave, as a launcher's restart does
            rank, at = self._kill

            def respawn():
                time.sleep(0.3 + 0.2 * at)
                self._run_worker(rank)

            t = threading.Thread(target=respawn, daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=self._deadline + 10)
        self.wall = time.monotonic() - t0
        return self

    def bitwise_ok(self) -> bool:
        exp = expected_state(self.world, self.niter)
        done = [r for r in self.results.values() if getattr(r, "completed", False)]
        return bool(done) and all(r.state is not None and np.array_equal(r.state, exp)
                                  for r in done)

    def completed(self) -> bool:
        byrank = {r.task_id: r for r in self.results.values()
                  if getattr(r, "completed", False)}
        return len(byrank) >= self.world - (1 if self._kill else 0)


def pctl(vals: list[float], q: float) -> float:
    if not vals:
        return -1.0
    return float(np.percentile(np.asarray(vals, np.float64), q))


def run_fleet(jobs: list[JobRun], stagger: float) -> float:
    """Run every job's workers, starting the jobs ``stagger`` apart (an
    admission churn, not one burst); the fleet's wall time."""
    t0 = time.monotonic()
    threads = []
    for j in jobs:
        threads.append(threading.Thread(target=j.run, daemon=True))
        threads[-1].start()
        time.sleep(stagger)
    for t in threads:
        t.join()
    return time.monotonic() - t0


def bench_service(n_jobs: int, world: int, niter: int, sleep: float, relays: int, chaos: str,
                  straggle: float, bar: float, pool: int, pool_jobs: int, deadline: float,
                  assert_isolation: bool, stagger: float = 0.05, obs_dir: str = "",
                  device: str = "cuda") -> list[dict]:
    """The clean, chaos and pooled arms and the summary (the module
    docstring); one record each."""
    assert_legacy_wire_identical()
    fill = DeviceFill(device)
    records: list[dict] = []
    svc = CollectiveService(quiet=True, obs_dir=obs_dir or None).start()
    tier = [Relay((svc.host, svc.port), relay_id=f"r{i}", flush_sec=0.05).start()
            for i in range(relays)]
    try:
        def addr_for(i: int) -> tuple[str, int]:
            if not tier:
                return (svc.host, svc.port)
            r = tier[i % len(tier)]
            return (r.host, r.port)

        base = dict(bench="service", jobs=n_jobs, world=world, niter=niter, relays=relays,
                    sleep_s=sleep, device=fill.device.type)

        # -- clean ---------------------------------------------------------------
        for i in range(n_jobs):
            svc.admit(f"clean{i}", world)
        clean = [JobRun(f"clean{i}", world, niter, sleep, addr_for(i), deadline, fill)
                 for i in range(n_jobs)]
        wall = run_fleet(clean, stagger)
        boots = [b for j in clean for b in j.boot_lat]
        ok = all(j.completed() and j.bitwise_ok() for j in clean)
        records.append(dict(base, mode="clean", wall_s=round(wall, 3),
                            jobs_per_sec=round(n_jobs / wall, 3),
                            boot_p50_ms=round(pctl(boots, 50) * 1e3, 3),
                            boot_p99_ms=round(pctl(boots, 99) * 1e3, 3),
                            job_walls_s=[round(j.wall, 3) for j in clean],
                            bitwise_ok=ok, completed=ok))
        assert ok, "clean arm: a job did not complete bitwise equal to the closed form"

        # -- chaos: one victim, N-1 neighbours ---------------------------------------
        if chaos != "none":
            kill = (1, max(2, niter // 2)) if chaos == "kill" else None
            strag = (1, straggle) if chaos == "straggler" else None
            for i in range(n_jobs):
                svc.admit(f"chaos{i}", world)
            fleet = [JobRun(f"chaos{i}", world, niter, sleep, addr_for(i), deadline, fill,
                            straggler=strag if i == 0 else None, kill=kill if i == 0 else None)
                     for i in range(n_jobs)]
            wall = run_fleet(fleet, stagger)
            neighbors = fleet[1:]
            ratios = [n.wall / c.wall for n, c in zip(neighbors, clean[1:]) if c.wall > 0]
            n_ok = all(j.completed() and j.bitwise_ok() for j in neighbors)
            victim = fleet[0]
            records.append(dict(base, mode="chaos", chaos=chaos,
                                straggle_s=straggle if strag else 0.0, wall_s=round(wall, 3),
                                victim_wall_s=round(victim.wall, 3),
                                victim_completed=victim.completed(),
                                victim_bitwise_ok=victim.bitwise_ok(),
                                neighbor_walls_s=[round(j.wall, 3) for j in neighbors],
                                neighbor_ratio_max=round(max(ratios), 3) if ratios else -1.0,
                                neighbor_ratio_bar=bar, neighbors_bitwise_ok=n_ok,
                                isolation_asserted=assert_isolation))
            assert n_ok, "chaos arm: a neighbour lost its completion or its bits"
            if assert_isolation and ratios:
                assert max(ratios) <= bar, (
                    f"chaos arm: a neighbour took {max(ratios):.2f}x its clean run "
                    f"(> {bar}x): the noisy neighbour was not isolated")

        # -- pooled ----------------------------------------------------------------
        if pool > 0:
            def pooled_contribution(v: int, w: int, r: int) -> np.ndarray:
                return fill(v * (r + 1))

            workers = [PooledWorker((svc.host, svc.port), f"w{i}", pooled_contribution,
                                    niter, deadline_sec=deadline) for i in range(pool)]
            threads = [p.start_thread() for p in workers]
            time.sleep(0.3)
            t0 = time.monotonic()
            fits_ok = 0
            for i in range(pool_jobs):
                part = svc.admit(f"fit{i}", min(world, pool), pooled=True)
                if part.wait(deadline):
                    fits_ok += 1
            pool_wall = time.monotonic() - t0
            for p in workers:
                p.stop()
            for t in threads:
                t.join(timeout=10)
            leases = [sum(1 for r in p.results if r.promoted) for p in workers]
            exp = expected_state(min(world, pool), niter)
            fits_bitwise = all(np.array_equal(r.state, exp)
                               for p in workers for r in p.results if r.completed)
            records.append(dict(base, mode="pooled", pool=pool, pool_jobs=pool_jobs,
                                fits_completed=fits_ok,
                                fits_per_sec=(round(fits_ok / pool_wall, 3)
                                              if pool_wall > 0 else -1.0),
                                leases_per_worker=leases, fits_bitwise_ok=fits_bitwise))
            assert fits_ok == pool_jobs and fits_bitwise, "pooled arm: a pool-filled fit failed"

        tele = svc.build_telemetry()
        records.append(dict(base, mode="summary", wire_legacy_identical=True,
                            service=tele.get("service", {}), contributions=fill.n_calls,
                            relay_stats=[dict(r.stats) for r in tier]))
    finally:
        for r in tier:
            r.stop()
        svc.stop()
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=8, help="concurrent jobs an arm")
    ap.add_argument("--world", type=int, default=3)
    ap.add_argument("--niter", type=int, default=8)
    ap.add_argument("--sleep", type=float, default=0.15,
                    help="seconds of compute a round a worker")
    ap.add_argument("--relays", type=int, default=2, help="shared relays (0: direct)")
    ap.add_argument("--chaos", default="straggler", choices=("straggler", "kill", "none"))
    ap.add_argument("--straggle", type=float, default=0.4,
                    help="the victim's rank 1: extra seconds a round")
    ap.add_argument("--bar", type=float, default=1.2,
                    help="a neighbour's wall time over its clean run, at most")
    ap.add_argument("--pool", type=int, default=3, help="pooled workers (0 skips the arm)")
    ap.add_argument("--pool-jobs", type=int, default=4, help="pool-filled fits in a row")
    ap.add_argument("--deadline", type=float, default=90.0)
    ap.add_argument("--device", default="cuda", help="where the contributions run")
    ap.add_argument("--smoke", action="store_true",
                    help="small: fewer rounds, the isolation bar recorded and not asserted")
    args = ap.parse_args(argv)
    if args.smoke:
        args.world = min(args.world, 2)
        args.niter = min(args.niter, 2)
        args.sleep = min(args.sleep, 0.03)
        args.straggle = min(args.straggle, 0.3)
        args.pool = min(args.pool, 2)
        args.pool_jobs = min(args.pool_jobs, 2)
        args.deadline = min(args.deadline, 45.0)
    records = bench_service(n_jobs=args.jobs, world=args.world, niter=args.niter,
                            sleep=args.sleep, relays=args.relays, chaos=args.chaos,
                            straggle=args.straggle, bar=args.bar, pool=args.pool,
                            pool_jobs=args.pool_jobs, deadline=args.deadline,
                            assert_isolation=not args.smoke, device=args.device)
    for rec in records:
        print(json.dumps(rec, sort_keys=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
