"""The port's GBDT under the port's own fault-tolerant engine: the
counterpart of tests/workers/torch_gbdt_hybrid_worker.py with every
collective through ``rabit_tpu_torch.api`` (the native engine, launched by
``rabit_tpu_torch.tracker.launcher``); imports torch, numpy and the port
only.

Each worker holds its rows (``elastic_shard``) and trains:

* ``mode=hybrid``: ``train_round_hybrid`` with a local group of this one
  process (gloo on the CPU; on the card an NCCL group of one whose store
  is a file of the worker's own), the hop ``api.allreduce``; the
  checkpoint holds the forest (global) and this rank's margin (local).
* ``mode=gbdt``: ``train_round`` with the hop on every level's histogram
  and on the leaf masses; the checkpoint holds the forest, and a restarted
  worker re-predicts its margin.

Under ``rabit_engine=mock mock=rank,version,seqno,trial`` a worker dies at
that point, its launcher restarts it, and it resumes from the checkpoint;
the forest must come out byte-identical to a run with no failure (the
ranks' forests are compared here, the runs' by the caller).  Version v's
collectives: seq 0..depth-1 the level histograms, seq depth the leaf
masses, then the checkpoint (-1 kills at its entry, -3 in its commit
window).

Worker args (k=v; the last one wins):
    mode=hybrid|gbdt  ntrees=N  out=PATH (rank 0 saves its forest, .npy)
    device=cpu|cuda   the device of the rows and the round (default cpu)
    rows=N            0 (default): 400 rows x 6 features, 16 bins, depth 3
                      (the CPU tests); N > 0: the headline data of
                      bench.py's generator, seed 0, N rows x 28 features x
                      256 bins, depth 6 (chip_smoke.py's recover phase)
    pause=S           sleep S seconds before each tree
    straggler=R       rank R also sleeps straggler_sleep seconds (default
                      0.25) before each tree's first collective: an
                      injected straggler for the trace analytics
    stop_at=K         every worker stops cleanly after tree K
    stats=DIR         write rank{r}.npz: the launches of this life, ms a
                      round, and with time_hop=1 the ms of one depth-6
                      level histogram's hop as numpy and as a card tensor;
                      and rank{r}.registry.json: this life's engine hops
                      and its metrics registry's snapshot (obs)
The config's own keys go to api.init as well, among them the liveness and
observability ones: rabit_heartbeat_sec, rabit_hang_abort_sec,
rabit_obs_dir, rabit_obs_hang_sec, rabit_trace_exit.
Every commit is stamped to the tracker: "[rank] commit version=V
attempt=A t=T" (T: time.time()).
"""

import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import api, obs  # noqa: E402
from rabit_tpu_torch.models import gbdt  # noqa: E402
from rabit_tpu_torch.ops import boost, hist  # noqa: E402


def getarg(name: str, default: str) -> str:
    for a in reversed(sys.argv[1:]):  # the last one wins, as in the config layer
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return default


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"[{api.get_rank()}] self-check failed: {what}")


def small_data(n=400, f=6, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    logits = X[:, 0] * X[:, 1] + 0.8 * (X[:, 2] > 0)
    return X, (logits > 0).astype(np.float32)


def headline_data(n_rows, n_features=28, n_bins=256, seed=0):
    """bench.py's Higgs-shaped generator: bins and labels (chip_smoke.py's
    make_data)."""
    rng = np.random.RandomState(seed)
    xb = rng.randint(0, n_bins, size=(n_rows, n_features), dtype=np.int32)
    logits = (xb[:, 0] > n_bins // 2).astype(np.float32) + 0.01 * xb[:, 1]
    return xb, (logits + rng.randn(n_rows) > 1.5).astype(np.float32)


def pack_forest(forest) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in gbdt.forest_to_numpy(forest)])


def main() -> int:
    torch.set_num_threads(1)  # the CPU sums run in one order on every life
    mode = getarg("mode", "hybrid")
    n_trees = int(getarg("ntrees", "4"))
    out_path = getarg("out", "")
    pause = float(getarg("pause", "0"))
    straggler = int(getarg("straggler", "-1"))
    straggler_sleep = float(getarg("straggler_sleep", "0.25"))
    stop_at = int(getarg("stop_at", "0"))
    dev = torch.device(getarg("device", "cpu"))
    n_rows = int(getarg("rows", "0"))
    stats_dir = getarg("stats", "")
    attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
    if dev.type == "cuda":
        # the card's context before the bootstrap: the ranks' first
        # collective then skews by their work (or straggler=), not by the
        # context's start-up
        torch.zeros(1, device=dev)
    api.init()
    rank, world = api.get_rank(), api.get_world_size()

    if n_rows:
        xb_all, y = headline_data(n_rows)
        cfg = gbdt.GBDTConfig(n_features=xb_all.shape[1], n_trees=n_trees)
        xs, ys = gbdt.elastic_shard(xb_all, y, world, rank)
        xb, ys = torch.as_tensor(xs, device=dev), torch.as_tensor(ys, device=dev)
    else:
        X, y = small_data()
        cfg = gbdt.GBDTConfig(n_features=X.shape[1], n_trees=n_trees, depth=3, n_bins=16)
        edges = torch.as_tensor(gbdt.compute_bin_edges(X, cfg.n_bins))
        xb = gbdt.quantize(torch.as_tensor(X[rank::world]), edges).to(dev)
        ys = torch.as_tensor(y[rank::world], device=dev)

    hops = []
    n_hops = [0]  # this life's engine hops

    def hop(a: np.ndarray) -> np.ndarray:
        hops.append(a.shape)
        n_hops[0] += 1
        return api.allreduce(np.asarray(a, np.float32), api.SUM)

    store_dir = None
    if mode == "hybrid":
        # the worker's local group: this process alone
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
            store_dir = tempfile.TemporaryDirectory()
            store = dist.FileStore(os.path.join(store_dir.name, "store"), 1)
            dist.init_process_group("nccl", store=store, rank=0, world_size=1)
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        step = lambda s: gbdt.train_round_hybrid(s, xb, ys, cfg, dist.group.WORLD, hop)
    else:
        on_dev = lambda a: torch.as_tensor(a, device=dev)
        hist_fn = lambda xb_, g, h, node, nn, nb: on_dev(hop(hist.node_histograms(
            xb_, g, h, node, nn, nb, mxu_i8=cfg.mxu_i8).cpu().numpy()))
        step = lambda s: gbdt.train_round(s, xb, ys, cfg, hist_fn,
                                          lambda gh: on_dev(hop(gh.cpu().numpy())))

    try:
        version, gmodel, margin = api.load_checkpoint(with_local=True)
        if version == 0:
            state = gbdt.init_state(cfg, len(ys), dev)
        else:
            if attempt == 0:  # a first life past version 0: the durable-spill resume
                api.tracker_print(f"[{rank}] resumed at version {version}")
            forest = gbdt.forest_from_numpy(gbdt.Forest(*gmodel), dev)
            if mode == "hybrid":
                check(margin is not None, "restarted worker got no local margin")
                margin = torch.as_tensor(margin, device=dev)
            else:  # the margin is derivable: re-predict this shard
                margin = gbdt.predict_margin(forest, xb, cfg)
            state = gbdt.TrainState(forest, margin, version)

        boost.launches.clear()
        boost.helper_launches.clear()
        ms = []
        for t in range(version, n_trees):
            if pause:
                time.sleep(pause)
            if rank == straggler:
                time.sleep(straggler_sleep)
            hops.clear()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = step(state)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            check(len(hops) == cfg.depth + 1, f"{len(hops)} engine hops in tree {t}")
            forest = tuple(gbdt.forest_to_numpy(state.forest))
            api.checkpoint(forest, state.margin.cpu().numpy() if mode == "hybrid" else None)
            check(api.version_number() == t + 1, "version after checkpoint")
            api.tracker_print(f"[{rank}] commit version={t + 1} attempt={attempt} "
                              f"t={time.time():.6f}")
            if stop_at and t + 1 == stop_at:
                api.tracker_print(f"[{rank}] stopping after tree {stop_at}")
                api.finalize()
                return 0
        launches = {**boost.launches, **boost.helper_launches}

        mine = pack_forest(state.forest)
        everyone = api.allgather(mine)
        for r in range(world):
            check(np.array_equal(everyone[r], mine), f"forest differs from rank {r}")
        pred = (gbdt.predict_margin(state.forest, xb, cfg) > 0).cpu().numpy()
        counts = api.allreduce(np.array([(pred == ys.cpu().numpy()).sum(), len(ys)],
                                        np.float64), api.SUM)
        acc = counts[0] / counts[1]
        if not n_rows:
            check(acc > 0.75, f"train accuracy {acc}")
        stats = {"ms": np.array(ms), "attempt": attempt, "acc": acc,
                 **{f"launches/{k}": v for k, v in launches.items()}}
        if getarg("time_hop", "0") == "1":
            # one depth-6 level histogram's hop: 64 nodes x 28 x 256 x (g, h)
            a = np.ones(64 * 28 * 256 * 2, np.float32)
            stats["hop_ms"] = mean_ms(lambda: api.allreduce(a, api.SUM))
            ta = torch.as_tensor(a, device=dev)
            stats["hop_tensor_ms"] = mean_ms(lambda: api.allreduce(ta, api.SUM))
        if stats_dir:
            np.savez(os.path.join(stats_dir, f"rank{rank}.npz"), **stats)
            with open(os.path.join(stats_dir, f"rank{rank}.registry.json"), "w") as f:
                json.dump({"hops": n_hops[0], "attempt": attempt,
                           "registry": obs.get_registry().snapshot()}, f)
        if out_path and rank == 0:
            np.save(out_path, mine)
        api.tracker_print(f"[{rank}] torch {mode} gbdt verified: {n_trees} trees, "
                          f"acc {acc:.3f}")
        api.finalize()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if store_dir is not None:
            store_dir.cleanup()
    return 0


def mean_ms(fn, reps: int = 10) -> float:
    """Mean host ms of a host-to-host collective after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


if __name__ == "__main__":
    sys.exit(main())
