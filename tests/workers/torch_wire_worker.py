"""One rank of the int8-wire data-parallel round (train_round_dp_fused with
``wire_i8=True``) on a given device.

    python torch_wire_worker.py RANK WORLD STORE_FILE OUT_NPZ DEVICE

Joins a gloo group of WORLD processes through a FileStore (on ``cuda``,
every rank on card 0: NCCL refuses two ranks on one card, gloo takes CUDA
tensors through host memory), takes its row block of 128 rows of
tests/test_gbdt.py:345's data (128 * WORLD rows, 4 features, 16 bins),
and writes the forests of two trees of the exact fused dp round
(``exact_*``) and of the wire_i8 round (``wire_*``, ``wire_block=16``) to
OUT_NPZ.  Imports torch, numpy and the port only.
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


def main(rank, world, store_file, out_npz, device):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    rng = np.random.RandomState(11)
    n = 128 * world
    xb = rng.randint(0, 16, size=(n, 4)).astype(np.int32)
    y = rng.randint(0, 2, size=n).astype(np.float32)
    rows = slice(128 * rank, 128 * (rank + 1))
    xb3, _ = boost.block_rows(torch.as_tensor(xb[rows], device=device), 128)
    ys = torch.as_tensor(y[rows], device=device)
    cfg = gbdt.GBDTConfig(n_features=4, n_trees=2, depth=3, n_bins=16)
    out = {}
    for key, wire in (("exact", False), ("wire", True)):
        state = gbdt.init_state(cfg, 128, device)
        for _ in range(cfg.n_trees):
            state = gbdt.train_round_dp_fused(state, xb3, ys, cfg, wire_i8=wire,
                                              wire_block=16)
        forest = gbdt.forest_to_numpy(state.forest)
        out.update({f"{key}_feature": forest.feature, f"{key}_threshold": forest.threshold,
                    f"{key}_leaf": forest.leaf})
    np.savez(out_npz, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
