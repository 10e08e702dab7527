"""The port's GBDT under the fault-tolerant engine: the counterpart of
tests/workers/gbdt_hybrid_worker.py (``mode=hybrid``, the default) and
tests/workers/gbdt_worker.py (``mode=gbdt``), on the CPU.

Each worker holds a row shard and trains with the port
(rabit_tpu_torch.models.gbdt); the hop between workers is the native
engine's allreduce (``rt``, rabit_tpu's control plane, which imports no
JAX).

* ``mode=hybrid``: ``train_round_hybrid`` with a local group of one gloo
  process (the worker), the histograms and leaf masses crossing ``rt``;
  the checkpoint holds the forest (global) and this rank's margin (local,
  ring-replicated by the engine).
* ``mode=gbdt``: ``train_round`` with the hook on each histogram and the
  leaf masses; the checkpoint holds the forest only, and a restarted
  worker re-derives its margin by prediction.

Under ``mock=rank,version,seqno,trial`` a worker dies where the mock engine
says, the launcher restarts it, it reloads its checkpoint, and training
resumes: the final forest must be byte-identical to a run with no failure
(tests/test_torch_hybrid_recover.py across runs; across ranks here).  The
per-version collective layout (depth-3 trees): seq 0..2 the level
histograms, seq 3 the leaf masses, then the checkpoint.  ``pause=S``
sleeps S seconds a tree; ``stop_at=K`` stops every worker cleanly after
tree K (whole-job preemption, with ``rabit_checkpoint_dir``).
"""

import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import rabit_tpu as rt  # noqa: E402
from rabit_tpu_torch.models import gbdt  # noqa: E402
from rabit_tpu_torch.ops import hist  # noqa: E402


def getarg(name: str, default: str) -> str:
    for a in reversed(sys.argv[1:]):  # the last one wins, as in the config layer
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return default


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"[{rt.get_rank()}] self-check failed: {what}")


def make_data(n=400, f=6, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    logits = X[:, 0] * X[:, 1] + 0.8 * (X[:, 2] > 0)
    return X, (logits > 0).astype(np.float32)


def pack_forest(forest) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in gbdt.forest_to_numpy(forest)])


def main() -> int:
    torch.set_num_threads(1)  # the CPU sums run in one order on every life
    mode = getarg("mode", "hybrid")
    n_trees = int(getarg("ntrees", "4"))
    out_path = getarg("out", "")
    pause = float(getarg("pause", "0"))
    stop_at = int(getarg("stop_at", "0"))
    rt.init()
    rank, world = rt.get_rank(), rt.get_world_size()

    X, y = make_data()
    cfg = gbdt.GBDTConfig(n_features=X.shape[1], n_trees=n_trees, depth=3, n_bins=16)
    edges = torch.as_tensor(gbdt.compute_bin_edges(X, cfg.n_bins))
    xb = gbdt.quantize(torch.as_tensor(X[rank::world]), edges)
    ys = torch.as_tensor(y[rank::world])

    hops = []

    def hook(a: np.ndarray) -> np.ndarray:
        hops.append(a.shape)
        return rt.allreduce(np.asarray(a, np.float32), rt.SUM)

    if mode == "hybrid":
        # the worker's local group: this process alone, in-process store
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        step = lambda s: gbdt.train_round_hybrid(s, xb, ys, cfg, dist.group.WORLD, hook)
    else:
        hist_fn = lambda xb_, g, h, node, nn, nb: torch.as_tensor(hook(
            hist.node_histograms(xb_, g, h, node, nn, nb).numpy()))
        step = lambda s: gbdt.train_round(s, xb, ys, cfg, hist_fn,
                                          lambda gh: torch.as_tensor(hook(gh.numpy())))

    version, gmodel, margin = rt.load_checkpoint(with_local=True)
    if version == 0:
        state = gbdt.init_state(cfg, len(ys), "cpu")
    else:
        if int(os.environ.get("DMLC_NUM_ATTEMPT", "0")) == 0:
            # a first life past version 0: the durable-spill resume
            rt.tracker_print(f"[{rank}] resumed at version {version}")
        forest = gbdt.forest_from_numpy(gbdt.Forest(*gmodel), "cpu")
        if mode == "hybrid":
            check(margin is not None, "restarted worker got no local margin")
            margin = torch.as_tensor(margin)
        else:  # the margin is derivable: re-predict this shard
            margin = gbdt.predict_margin(forest, xb, cfg)
        state = gbdt.TrainState(forest, margin, version)

    for t in range(version, n_trees):
        if pause:
            time.sleep(pause)
        hops.clear()
        state = step(state)
        check(len(hops) == cfg.depth + 1, f"{len(hops)} engine hops in tree {t}")
        forest = tuple(gbdt.forest_to_numpy(state.forest))
        rt.checkpoint(forest, state.margin.numpy() if mode == "hybrid" else None)
        check(rt.version_number() == t + 1, "version after checkpoint")
        if stop_at and t + 1 == stop_at:
            rt.tracker_print(f"[{rank}] stopping after tree {stop_at}")
            rt.finalize()
            return 0

    mine = pack_forest(state.forest)
    everyone = rt.allgather(mine)
    for r in range(world):
        check(np.array_equal(everyone[r], mine), f"forest differs from rank {r}")
    pred = gbdt.predict_margin(state.forest, xb, cfg).numpy() > 0
    counts = rt.allreduce(np.array([(pred == ys.numpy()).sum(), len(ys)], np.float64),
                          rt.SUM)
    acc = counts[0] / counts[1]
    check(acc > 0.75, f"train accuracy {acc}")
    if out_path and rank == 0:
        np.save(out_path, mine)
    rt.tracker_print(f"[{rank}] torch {mode} gbdt verified: {n_trees} trees, acc {acc:.3f}")
    rt.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
