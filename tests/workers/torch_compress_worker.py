"""One rank of the port's compressed collectives on the CPU.

    python torch_compress_worker.py RANK WORLD STORE_FILE OUT_NPZ

Joins a gloo group of WORLD processes through a FileStore and writes this
rank's results to OUT_NPZ:

* ``fused/<ring>/<codec>/<op>``: ``engine.fused.run_local`` (which checks
  that every rank got the same bits) on :func:`contribs` of 700 elements,
  along each ring of :func:`schedules`, for every fused codec x SUM/MAX;
* ``chunk/<bytes>``: i8x2 SUM of 5000 elements with hops split into sends
  of 64 B, 1 KiB and 4 MiB;
* ``api/<fused>/<codec>/<op>``: ``api.allreduce(x, op, codec=...)`` through
  ``TorchEngine`` (which adopts the program's group) with
  ``rabit_fused_allreduce`` 1 and 0, and ``rebuilt/<codec>`` the same call
  after ``TorchEngine.rebuild()``; ``policy``: an allreduce the
  ``rabit_compress_allreduce=i8`` policy compresses, ``small`` one under
  its floor; ``bcast``: a broadcast under ``rabit_compress_broadcast=zlib``.

tests/test_torch_fused.py checks them against both packages'
``reference_allreduce``.  Imports torch, numpy and the port only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import api  # noqa: E402
from rabit_tpu_torch.compress import get_codec  # noqa: E402
from rabit_tpu_torch.engine import fused  # noqa: E402
from rabit_tpu_torch.engine.base import MAX, SUM  # noqa: E402
from rabit_tpu_torch.sched import mesh_for_world, plan  # noqa: E402

CODECS = ("bf16", "bf16x2", "i8", "i8x2")
OPS = {"sum": SUM, "max": MAX}
CHUNKS = (64, 1024, 1 << 22)


def contribs(world: int, n: int, seed: int) -> list[np.ndarray]:
    """tests/test_fused.py's per-rank contributions."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 50).astype(np.float32) for _ in range(world)]


def schedules(world: int) -> dict:
    """tests/test_fused.py's three ring layouts, from the port's planner."""
    return {
        "identity": tuple(range(world)),
        "swing": plan(world, "swing", mesh_for_world(world)).ring_order,
        "repaired": plan(world, "ring", avoid={(0, 1)}).ring_order,
    }


def run_api(rank: int, world: int, out: dict, device: str = "cpu") -> None:
    """The compressed api cases on the engine that adopts the program's
    group; arrays' codec work on ``device``."""
    x = contribs(world, 1000, seed=11)[rank]
    base = ["rabit_engine=torch", f"rabit_torch_device={device}"]
    for mode in ("1", "0"):
        api.init(base + [f"rabit_fused_allreduce={mode}"])
        engine = api.get_engine()
        try:
            for cname in CODECS:
                if engine.fused_active(get_codec(cname), SUM) != (mode == "1"):
                    raise AssertionError(f"fused_active wrong for {cname} at mode {mode}")
                for oname, op in OPS.items():
                    out[f"api/{mode}/{cname}/{oname}"] = api.allreduce(x, op, codec=cname)
            if mode == "1":
                engine.rebuild()
                if engine._fused or engine._fused_order is not None:
                    raise AssertionError("rebuild() kept the fused rings")
                for cname in CODECS:
                    out[f"rebuilt/{cname}"] = api.allreduce(x, SUM, codec=cname)
        finally:
            api.finalize()
    api.init(base + ["rabit_compress_allreduce=i8", "rabit_compress_min_bytes=1K",
                     "rabit_compress_broadcast=zlib"])
    try:
        out["policy"] = api.allreduce(x, SUM)
        out["small"] = api.allreduce(x[:100], SUM)
        out["bcast"] = np.array(api.broadcast({"w": np.arange(3000) * (rank + 1)}, 1)["w"])
    finally:
        api.finalize()


def main(rank, world, store_file, out_npz):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    out = {}
    parts = contribs(world, 700, seed=world)
    for sname, order in schedules(world).items():
        out[f"order/{sname}"] = np.array(order)
        for cname in CODECS:
            for oname, op in OPS.items():
                out[f"fused/{sname}/{cname}/{oname}"] = fused.run_local(
                    parts, op, cname, ring_order=order, device="cpu")
    parts = contribs(world, 5000, seed=3)
    for chunk in CHUNKS:
        out[f"chunk/{chunk}"] = fused.run_local(parts, SUM, "i8x2", chunk_bytes=chunk,
                                                device="cpu")
    run_api(rank, world, out)
    np.savez(out_npz, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
