"""One process of a worker made of two gloo processes (the port's
train_round_hybrid with a local group), on the CPU.

    python torch_hybrid_local_worker.py RANK STORE_FILE IN_NPZ OUT_NPZ

Both processes hold half of the rows in IN_NPZ (elastic_shard) and form
the local group.  Scenarios, each's forest and margin to OUT_NPZ:

* ``solo``   -- train_round_hybrid, no engine: only the local sums;
* ``dp``     -- train_round_dp over the same group (the reference of solo);
* ``hop``    -- train_round_hybrid with a host hook that doubles its input
  (as two identical workers would sum), counting the hook's calls here;
* ``dp2``    -- train_round with the local all_reduce doubled (the
  reference of hop).

Imports torch, numpy and the port only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch.models import gbdt  # noqa: E402
from rabit_tpu_torch.ops import hist  # noqa: E402


def _all_reduce(a):
    dist.all_reduce(a)
    return a


def main(rank, store_file, in_npz, out_npz):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, 2), rank=rank,
                            world_size=2, timeout=timedelta(seconds=60))
    data = np.load(in_npz)
    xb, y = gbdt.elastic_shard(data["xb"], data["y"], 2, rank)
    xb, y = torch.as_tensor(xb), torch.as_tensor(y)
    cfg = gbdt.GBDTConfig(n_features=xb.shape[1], n_trees=3, depth=3, n_bins=16)
    group = dist.new_group([0, 1])
    calls = []

    def double(a: np.ndarray) -> np.ndarray:
        calls.append(a.shape)
        return 2.0 * a

    hist2 = lambda xb_, g, h, node, nn, nb: 2.0 * _all_reduce(
        hist.node_histograms(xb_, g, h, node, nn, nb))
    steps = {
        "solo": lambda s: gbdt.train_round_hybrid(s, xb, y, cfg, group),
        "dp": lambda s: gbdt.train_round_dp(s, xb, y, cfg, dp_group=group),
        "hop": lambda s: gbdt.train_round_hybrid(s, xb, y, cfg, group, double),
        "dp2": lambda s: gbdt.train_round(s, xb, y, cfg, hist2,
                                          lambda gh: 2.0 * _all_reduce(gh)),
    }
    out = {}
    for key, step in steps.items():
        state = gbdt.init_state(cfg, len(y), "cpu")
        for _ in range(cfg.n_trees):
            state = step(state)
        for k, a in gbdt.forest_to_numpy(state.forest)._asdict().items():
            out[f"{key}_{k}"] = a
        out[f"{key}_margin"] = state.margin.numpy()
    out["hop_calls"] = np.array([len(s) for s in calls])  # the shapes' ranks, in order
    out["hop_shapes"] = np.array([s[0] for s in calls])   # their leading sizes
    np.savez(out_npz, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), *sys.argv[2:5])
