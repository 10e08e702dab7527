"""One rank of the port's collectives (rabit_tpu_torch.parallel) on the CPU.

    python torch_parallel_worker.py RANK WORLD STORE_FILE OUT_NPZ

Joins a gloo group of WORLD processes through a FileStore, runs every case
of :func:`cases` (each a global numpy input whose row ``rank`` is this
rank's) through its function of ``rabit_tpu_torch.parallel``, and writes
this rank's outputs to OUT_NPZ under the case's name (pytrees as
``name/leaf``; a refused input as ``name`` = the error's message).
tests/test_torch_parallel.py builds the same inputs and runs the JAX
package's functions on them.  Imports torch, numpy and the port only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import parallel as tp  # noqa: E402
from rabit_tpu_torch.engine.base import BITOR, MAX, MIN, SUM  # noqa: E402


def cases(world: int) -> dict:
    """name -> (function name, global input (leading dim = world), kwargs).
    Inputs are seeded by the name and the world."""
    w = world
    rng = np.random.RandomState(10 + w)
    randn = lambda *shape: rng.randn(*shape).astype(np.float32)
    bits = lambda dtype, *shape: rng.randint(0, 256, size=shape + (np.dtype(dtype).itemsize,),
                                             dtype=np.uint8).view(dtype).reshape(shape)
    x = randn(w, 3, 5)
    tree = {"w": randn(w, 4, 3), "b": randn(w, 5),
            "steps": rng.randint(-50, 50, size=(w, 2)).astype(np.int32)}
    poisoned = np.random.RandomState(7).randn(w, w * 256).astype(np.float32)
    poisoned[0, 5] = np.inf
    return {
        "sum": ("allreduce", x, {"op": SUM}),
        "max": ("allreduce", x, {"op": MAX}),
        "min": ("allreduce", x, {"op": MIN}),
        "bitor_i32": ("allreduce", bits(np.int32, w, 4), {"op": BITOR}),
        "bitor_u8": ("allreduce", bits(np.uint8, w, 6), {"op": BITOR}),
        "bitor_i16": ("allreduce", bits(np.int16, w, 3), {"op": BITOR}),
        "bcast_f32": ("broadcast", randn(w, 4), {"root": w - 1}),
        "bcast_bool": ("broadcast", rng.rand(w, 5) > 0.5, {"root": 1}),
        "ag0": ("allgather", randn(w, 2, 3), {"axis": 0}),
        "ag1_tiled": ("allgather", randn(w, 2, 3), {"axis": 1, "tiled": True}),
        "rs0": ("reduce_scatter", randn(w, 2 * w, 3), {"axis": 0}),
        "rs1": ("reduce_scatter", randn(w, 3, 2 * w), {"axis": 1}),
        "shift": ("ring_shift", {"a": randn(w, 3),
                                 "b": rng.randint(0, 99, (w, 2, 2)).astype(np.int32)},
                  {"shift": 1}),
        "shift_back": ("ring_shift", randn(w, 3), {"shift": -1}),
        "ring_rs": ("ring_reduce_scatter", randn(w, 4 * w, 3), {}),
        "ring_ag": ("ring_allgather", randn(w, 3), {}),
        "ring_ar": ("ring_allreduce", randn(w, 4 * w), {}),
        "rq1": ("ring_allreduce_quantized",
                np.random.RandomState(4).randn(w, w * 256).astype(np.float32), {"planes": 1}),
        "rq2": ("ring_allreduce_quantized",
                np.random.RandomState(4).randn(w, w * 256).astype(np.float32), {"planes": 2}),
        "rq_nonfinite": ("ring_allreduce_quantized", poisoned, {}),
        "rq_block16": ("ring_allreduce_quantized", randn(w, w * 64), {"block": 16}),
        "rq_ragged": ("ring_allreduce_quantized", np.ones((w, w * 3), np.float32), {}),
        "rq_f64": ("ring_allreduce_quantized", np.ones((w, w * 256)), {}),
        "rq_planes3": ("ring_allreduce_quantized", np.ones((w, w * 256), np.float32),
                       {"planes": 3}),
        "fused_tree": ("fused_allreduce", tree, {"op": SUM}),
    }


def _flat(name, out, store):
    if isinstance(out, dict):
        for k, v in out.items():
            store[f"{name}/{k}"] = v.numpy()
    else:
        store[name] = out.numpy()


def main(rank, world, store_file, out_npz):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    out = {}
    for name, (fn, x, kw) in cases(world).items():
        mine = ({k: torch.as_tensor(v[rank]) for k, v in x.items()} if isinstance(x, dict)
                else torch.as_tensor(x[rank]))
        try:
            _flat(name, getattr(tp, fn)(mine, None, **kw), out)
        except ValueError as e:
            out[name] = np.array(str(e))

    # meshes: a 1-D mesh's group, and at world 4 a 2 x 2 mesh's "fp" group
    mesh = tp.create_mesh(("dp",), device_type="cpu")
    out["mesh_dp"] = tp.allreduce(torch.tensor([rank + 1]), mesh.get_group("dp")).numpy()
    out["mesh_placements"] = np.array(repr((tp.replicated(mesh),
                                            tp.sharded_along(mesh, "dp", 2, 1))))
    if world == 4:
        mesh2 = tp.create_mesh(("dp", "fp"), shape=(2, 2), device_type="cpu")
        got = tp.allreduce(torch.tensor([10 ** rank]), mesh2.get_group("fp"))
        out["mesh_fp"] = got.numpy()
        out["mesh2_placements"] = np.array(repr(tp.sharded_along(mesh2, "fp")))
    np.savez(out_npz, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
