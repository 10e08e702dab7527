"""One rank of the port's sequence-parallel attention over a gloo group.

    python torch_ring_worker.py RANK WORLD STORE_FILE OUT_NPZ

Joins a gloo group of WORLD processes through a FileStore and runs
``ring_attention`` and ``ulysses_attention`` (rabit_tpu_torch.parallel.ring)
on this rank's sequence block of every case of :func:`cases`, causal and
not, in f32 and bf16; writes its output block (as f32) to OUT_NPZ under
``<fn>/<dtype>/<causal>``, and under ``refused`` the message of
``ulysses_attention`` given heads the group size does not divide.
tests/test_torch_ring.py builds the same inputs and runs the JAX package on
them.  Imports torch, numpy and the port only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch.parallel import ring  # noqa: E402

FNS = ("ring_attention", "ulysses_attention")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BLOCK, HEADS, DIM = 8, 4, 8


def inputs(world: int) -> list[np.ndarray]:
    """Global q, k, v ``[world * BLOCK, HEADS, DIM]`` f32, seeded by the
    world (bf16 cases round them to nearest even)."""
    rng = np.random.RandomState(50 + world)
    return [rng.randn(world * BLOCK, HEADS, DIM).astype(np.float32) for _ in range(3)]


def main(rank, world, store_file, out_npz):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    rows = slice(rank * BLOCK, (rank + 1) * BLOCK)
    out = {}
    for dname, dtype in DTYPES.items():
        q, k, v = (torch.as_tensor(a[rows]).to(dtype) for a in inputs(world))
        for name in FNS:
            for causal in (False, True):
                o = getattr(ring, name)(q, k, v, causal=causal)
                assert o.dtype == dtype and o.shape == q.shape, (o.dtype, o.shape)
                out[f"{name}/{dname}/{causal}"] = o.float().numpy()
    if world > 1:
        x = torch.zeros(BLOCK, world + 1, DIM)
        try:
            ring.ulysses_attention(x, x, x)
        except ValueError as e:
            out["refused"] = np.array(str(e))
    np.savez(out_npz, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
