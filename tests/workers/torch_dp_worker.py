"""One rank of the port's data-parallel GBDT scenarios, on the CPU.

    python torch_dp_worker.py RANK WORLD STORE_FILE IN_NPZ OUT_NPZ

Joins a gloo group of WORLD (= 4) processes through a FileStore and runs,
on the inputs in IN_NPZ:

* ``dp``    -- train_round_dp over every rank, rows split by elastic_shard;
* ``fp``    -- train_round_dp on a 2 x 2 dp x fp grid (rank = 2*dp + fp:
  the members of an fp group hold the same rows, each histograms half the
  features);
* ``dp5`` / ``fused5`` -- train_round_dp and train_round_dp_fused (row
  blocks of 128) on the second data set;
* ``exact11`` / ``wire11`` -- train_round_dp_fused exact and with
  ``wire_i8=True, wire_block=16`` on the third (one row block of 128 a
  rank);
* ``refusal`` -- train_round_dp_fused with ``wire_i8=True`` on the second
  data set, whose level-0 histogram (5 * 16 * 2 = 160 floats) is no whole
  number of 256-float wire blocks a rank: the message it raises.

Each scenario's forest and this rank's margin go to OUT_NPZ.  Imports torch,
numpy and the port only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch.models import gbdt  # noqa: E402
from rabit_tpu_torch.ops import boost  # noqa: E402


def _train(step, cfg, xb, y):
    state = gbdt.init_state(cfg, len(y), "cpu")
    for _ in range(cfg.n_trees):
        state = step(state, xb, torch.as_tensor(y), cfg)
    return state


def _save(out, key, state):
    forest = gbdt.forest_to_numpy(state.forest)
    out[f"{key}_feature"] = forest.feature
    out[f"{key}_threshold"] = forest.threshold
    out[f"{key}_leaf"] = forest.leaf
    out[f"{key}_margin"] = state.margin.numpy()


def main(rank, world, store_file, in_npz, out_npz):
    torch.set_num_threads(1)
    store = dist.FileStore(store_file, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    data = np.load(in_npz)
    out = {}

    cfg = gbdt.GBDTConfig(n_features=8, n_trees=3, depth=4, n_bins=32)
    xb, y = gbdt.elastic_shard(data["xb"], data["y"], world, rank)
    _save(out, "dp", _train(gbdt.train_round_dp, cfg, torch.as_tensor(xb), y))

    # every rank creates every group, in the same order
    dp_groups = [dist.new_group([0, 2]), dist.new_group([1, 3])]
    fp_groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    dp_idx, fp_idx = divmod(rank, 2)
    xb, y = gbdt.elastic_shard(data["xb"], data["y"], 2, dp_idx)
    step = lambda s, x, yy, c: gbdt.train_round_dp(
        s, x, yy, c, dp_group=dp_groups[fp_idx], fp_group=fp_groups[dp_idx])
    _save(out, "fp", _train(step, cfg, torch.as_tensor(xb), y))

    cfg5 = gbdt.GBDTConfig(n_features=5, n_trees=2, depth=3, n_bins=16)
    xb, y = gbdt.elastic_shard(data["xb5"], data["y5"], world, rank)
    xb = torch.as_tensor(xb)
    _save(out, "dp5", _train(gbdt.train_round_dp, cfg5, xb, y))
    xb3, _ = boost.block_rows(xb, 128)
    _save(out, "fused5", _train(gbdt.train_round_dp_fused, cfg5, xb3, y))
    try:  # every rank refuses at the same point, before any hop
        gbdt.train_round_dp_fused(gbdt.init_state(cfg5, len(y), "cpu"), xb3,
                                  torch.as_tensor(y), cfg5, wire_i8=True)
        out["refusal"] = ""
    except ValueError as e:
        out["refusal"] = str(e)

    cfg11 = gbdt.GBDTConfig(n_features=4, n_trees=2, depth=3, n_bins=16)
    rows = slice(128 * rank, 128 * (rank + 1))
    xb3, _ = boost.block_rows(torch.as_tensor(data["xb11"][rows]), 128)
    y = data["y11"][rows]
    _save(out, "exact11", _train(gbdt.train_round_dp_fused, cfg11, xb3, y))
    wired = lambda s, x, yy, c: gbdt.train_round_dp_fused(s, x, yy, c, wire_i8=True,
                                                          wire_block=16)
    _save(out, "wire11", _train(wired, cfg11, xb3, y))

    np.savez(out_npz, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
