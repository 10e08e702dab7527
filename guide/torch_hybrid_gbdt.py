#!/usr/bin/env python
"""Hybrid-deployment demo on the PyTorch/CUDA port (the counterpart of
guide/hybrid_gbdt.py): a device data plane under the fault-tolerant engine.

One boosting round is ``gbdt.train_round_hybrid``: each level's histogram
(``ops.hist.node_histograms``, the hand-written CUDA kernel on a card) is
summed over this worker's local ``torch.distributed`` group, a group of one
process here (NCCL on the card, gloo on the CPU), and the cross-worker
combine crosses the fault-tolerant engine (``rabit.allreduce``).
Checkpoints hold the forest globally and this rank's margin locally, so a
killed worker is restarted by the tracker, reloads both from its peers,
moves them back to its device, and the final forest is byte-identical to
that of a run with no failure.

Solo (no tracker; there is no engine hop):
    python guide/torch_hybrid_gbdt.py [rabit_torch_device=cpu]

Distributed, 2 workers, with worker 1 killed mid-training and recovered:
    python -m rabit_tpu_torch.tracker.launcher -n 2 --max-restarts 3 -- \\
        python guide/torch_hybrid_gbdt.py rabit_engine=mock mock=1,1,1,0

The demo runs on the card unless ``rabit_torch_device=cpu`` (or
``device="cpu"`` to ``main``) asks for the CPU; CUDA without a card raises.
"""
import hashlib
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rabit_tpu_torch as rabit  # noqa: E402
from rabit_tpu_torch.config import Config  # noqa: E402

N_TREES = 3
CFG_KW = dict(n_features=6, n_trees=N_TREES, depth=3, n_bins=16)


def shard(rank: int, world: int):
    """Every rank derives the same dataset and bin edges, then keeps its
    rows (an even count): ``(X, y, edges)``."""
    from rabit_tpu_torch.models import gbdt

    rng = np.random.RandomState(11)
    X = rng.randn(512, 6).astype(np.float32)
    y = (X[:, 0] + 0.7 * X[:, 1] > 0).astype(np.float32)
    edges = gbdt.compute_bin_edges(X, CFG_KW["n_bins"])
    Xs, ys = X[rank::world], y[rank::world]
    keep = len(ys) - len(ys) % 2
    return Xs[:keep], ys[:keep], edges


def forest_digest(forest) -> str:
    """sha256 of the forest's arrays, host bytes in field order."""
    from rabit_tpu_torch.models import gbdt

    h = hashlib.sha256()
    for a in gbdt.forest_to_numpy(forest):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def train(rank: int, world: int, device, engine_allreduce=None, local_group=None,
          resume=None, on_tree=None):
    """Train this rank's shard to ``N_TREES`` trees; returns ``(state, xb,
    ys)``.  ``resume`` is ``(version, forest arrays, margin)`` of a
    checkpoint, ``on_tree(state)`` runs after each tree (the checkpoint)."""
    import torch

    from rabit_tpu_torch.models import gbdt

    cfg = gbdt.GBDTConfig(**CFG_KW)
    Xs, ys_np, edges = shard(rank, world)
    xb = gbdt.quantize(torch.as_tensor(Xs, device=device),
                       torch.as_tensor(edges, device=device))
    ys = torch.as_tensor(ys_np, device=device)
    if resume is None:
        state = gbdt.init_state(cfg, len(ys_np), device)
    else:
        version, forest_np, margin_np = resume
        state = gbdt.TrainState(
            forest=gbdt.forest_from_numpy(gbdt.Forest(*forest_np), device),
            margin=torch.as_tensor(np.asarray(margin_np), dtype=torch.float32, device=device),
            round=version)
    for _ in range(state.round, N_TREES):
        state = gbdt.train_round_hybrid(state, xb, ys, cfg, local_group, engine_allreduce)
        if on_tree is not None:
            on_tree(state)
    return state, xb, ys


def main(argv: list[str] | None = None, device: str | None = None) -> int:
    import torch
    import torch.distributed as dist

    from rabit_tpu_torch.models import gbdt

    args = [a for a in (sys.argv[1:] if argv is None else argv) if "=" in a]
    dev = torch.device(device or Config(args).torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the demo runs on the card, and no CUDA device is available; "
                           "pass rabit_torch_device=cpu to run it on the CPU")
    rabit.init(args)
    rank, world = rabit.get_rank(), rabit.get_world_size()

    # The worker's local group: this process alone, on an in-process store.
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != 1:
        raise RuntimeError("the demo's worker is one process: a torch.distributed group "
                           f"of {dist.get_world_size()} is already up")

    # The cross-worker hop.  A worker killed here exits at once, so its
    # peers see the death at once, but prints the cause first, so a real
    # error is told apart from an injected kill.
    def engine_hook(a: np.ndarray) -> np.ndarray:
        try:
            return rabit.allreduce(np.asarray(a, np.float32), rabit.SUM)
        except BaseException:
            import traceback

            traceback.print_exc()
            os._exit(13)

    # First life: fresh state.  Restarted life: forest and margin from peers.
    version, forest_np, margin_np = rabit.load_checkpoint(with_local=True)
    resume = None
    if version > 0:
        print(f"@node[{rank}] recovered at version {version}")
        resume = (version, forest_np, margin_np)

    def commit(state):
        rabit.checkpoint(tuple(gbdt.forest_to_numpy(state.forest)),
                         state.margin.cpu().numpy())

    try:
        state, xb, ys = train(rank, world, dev, engine_hook if world > 1 else None,
                              dist.group.WORLD, resume, commit)
    finally:
        if own_group:
            dist.destroy_process_group()
    cfg = gbdt.GBDTConfig(**CFG_KW)
    pred = (gbdt.predict_margin(state.forest, xb, cfg) > 0).cpu().numpy()
    counts = rabit.allreduce(
        np.array([(pred == ys.cpu().numpy()).sum(), len(pred)], np.float64), rabit.SUM)
    msg = f"@node[{rank}] hybrid gbdt: {N_TREES} trees, train-acc {counts[0] / counts[1]:.3f}"
    digest = f"@node[{rank}] hybrid gbdt forest sha256 {forest_digest(state.forest)}"
    print(msg)
    print(digest)
    if world > 1:
        rabit.tracker_print(msg)  # in the launcher's message log
        rabit.tracker_print(digest)
    rabit.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
