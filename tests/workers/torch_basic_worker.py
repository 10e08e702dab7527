"""Self-checking worker of the port's engine layer (rabit_tpu_torch.api):
every reduction's expected value is computed from the ranks' inputs with
numpy_reduce folded in rank order, and every element is checked.

    MASTER_ADDR=... MASTER_PORT=... WORLD_SIZE=... RANK=... \\
        python torch_basic_worker.py [N] rabit_engine=torch rabit_torch_device=cpu
    python -m rabit_tpu_torch.tracker.launcher -n 2 -- \\
        python torch_basic_worker.py [N] rabit_engine=native lazy=0

The matrix of tests/workers/basic_worker.py (allreduce MAX/SUM/MIN/BITOR,
broadcast, allgather, prepare_fun, checkpoints) minus compression and
fusion, over every dtype of DTYPE_ENUM and every op.  Float SUMs take
integer values, whose sum is exact in any order.  Exits non-zero on a
mismatch.  Imports torch, numpy and the port only.

``tensor_device=cuda`` sends the tensor case's tensor from the card.
``lazy=0`` checkpoints twice with a local model where the default follows
one such checkpoint with a lazy one: rabit's robust engine wants every
checkpoint of a job to carry a local model or none, and a lazy checkpoint
carries none.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import api  # noqa: E402
from rabit_tpu_torch.engine.base import DTYPE_ENUM, numpy_reduce  # noqa: E402

OPS = {"max": api.MAX, "min": api.MIN, "sum": api.SUM, "bitor": api.BITOR}


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(f"[rank {api.get_rank()}] check failed: {msg}")


def rank_input(dtype: np.dtype, op: int, rank: int, n: int) -> np.ndarray:
    """Rank ``rank``'s input to one (dtype, op) case, seeded by both."""
    rng = np.random.RandomState(1000 * DTYPE_ENUM[dtype] + 10 * op + rank)
    if dtype.kind == "f":
        if op == api.SUM:  # integers: their sum is exact in any order
            return rng.randint(-1000, 1000, size=n).astype(dtype)
        return (rng.randn(n) * 1e3).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(info.min, info.max, size=n, dtype=dtype)


def run_matrix(n: int = 64, lazy: bool = True, tensor_device: str = "cpu") -> None:
    """The whole matrix on the engine ``api.init`` started."""
    rank, world = api.get_rank(), api.get_world_size()

    # every dtype x every op against numpy_reduce of the ranks' inputs
    for dtype in DTYPE_ENUM:
        for name, op in OPS.items():
            if op == api.BITOR and dtype.kind == "f":
                continue
            inputs = [rank_input(dtype, op, r, n) for r in range(world)]
            want = inputs[0].copy()
            for x in inputs[1:]:
                want = numpy_reduce(op, want, x)
            got = api.allreduce(inputs[rank], op)
            check(got.dtype == dtype and got.shape == (n,), f"{name} {dtype}: dtype/shape")
            check(np.array_equal(got.view(np.uint8), want.view(np.uint8)),
                  f"allreduce {name} {dtype}: not the bits of numpy_reduce")
    # BITOR of one bit a rank, on every integer dtype (np.bitwise_or)
    for dtype in (d for d in DTYPE_ENUM if d.kind in "iu"):
        bits = 8 * dtype.itemsize
        mine = (np.arange(4, dtype=np.uint64) + rank) % bits
        got = api.allreduce((np.uint64(1) << mine).astype(dtype), api.BITOR)
        want = np.zeros(4, dtype)
        for r in range(world):
            want = np.bitwise_or(want, (np.uint64(1) << (np.arange(4, dtype=np.uint64)
                                                        + r) % bits).astype(dtype))
        check(np.array_equal(got, want), f"bitor {dtype}")
    # 64-bit payloads beyond the 32-bit range
    got = api.allreduce(np.array([(1 << 40) + rank], np.int64), api.MAX)
    check(got[0] == (1 << 40) + world - 1, "int64 max past 2**32")
    got = api.allreduce(np.array([(1 << 62) + rank], np.uint64), api.SUM)
    want = np.array([(1 << 62) + r for r in range(world)], np.uint64).sum(dtype=np.uint64)
    check(got[0] == want, "uint64 sum past 2**62 (wrapping past 2**64 at world 4)")
    # a torch tensor comes back a tensor of its dtype on its device
    t = api.allreduce(torch.full((3,), float(rank + 1), device=tensor_device), api.SUM)
    check(isinstance(t, torch.Tensor) and t.dtype == torch.float32
          and t.device.type == tensor_device
          and torch.equal(t.cpu(), torch.full((3,), world * (world + 1) / 2)), "tensor sum")

    # broadcast a python object from each root in turn
    for root in range(world):
        obj = {"root": root, "payload": list(range(root + 1))} if rank == root else None
        got = api.broadcast(obj, root)
        check(got == {"root": root, "payload": list(range(root + 1))},
              f"broadcast from {root}")
    check(api.broadcast(b"" if rank == 0 else None, 0) == b"", "broadcast of nothing")

    # allgather
    got = api.allgather(np.array([rank, rank * rank], dtype=np.int64))
    want = np.array([[r, r * r] for r in range(world)], dtype=np.int64)
    check(np.array_equal(got, want), "allgather int64")
    got = api.allgather(np.full((2, 3), rank, np.uint32))
    check(got.shape == (world, 2, 3) and all((got[r] == r).all() for r in range(world)),
          "allgather uint32 [2, 3]")

    # lazy prepare_fun: called once, right before the reduction
    called = []

    def prep(arr):
        called.append(1)
        arr[:] = rank

    out = api.allreduce(np.zeros(4, np.float32), api.SUM, prepare_fun=prep)
    check(called == [1], "prepare_fun called once")
    check(np.array_equal(out, np.full(4, world * (world - 1) / 2, np.float32)),
          "prepare_fun allreduce")

    # checkpoints: versioned, the local model per rank, lazy ones too
    v0, m0 = api.load_checkpoint()
    check(v0 == 0 and m0 is None, "fresh load_checkpoint")
    api.checkpoint({"iter": 1}, {"rank": rank})
    check(api.version_number() == 1, "version after checkpoint")
    check(api.load_checkpoint(with_local=True) == (1, {"iter": 1}, {"rank": rank}),
          "load_checkpoint returns the committed models")
    if lazy:
        model = {"iter": 2}
        api.lazy_checkpoint(model)
        check(api.load_checkpoint(with_local=True) == (2, {"iter": 2}, None),
              "lazy checkpoint")
    else:
        api.checkpoint({"iter": 2}, {"rank": rank, "iter": 2})
        check(api.load_checkpoint(with_local=True) == (2, {"iter": 2},
                                                       {"rank": rank, "iter": 2}),
              "second checkpoint")


def main() -> int:
    torch.set_num_threads(1)
    api.init()
    positional = [a for a in sys.argv[1:] if "=" not in a]
    try:
        run_matrix(int(positional[0]) if positional else 64,
                   lazy="lazy=0" not in sys.argv[1:],
                   tensor_device="cuda" if "tensor_device=cuda" in sys.argv[1:] else "cpu")
    except CheckFailed as e:
        print(e, file=sys.stderr, flush=True)
        return 2
    api.tracker_print(f"worker {api.get_rank()}/{api.get_world_size()} ok")
    api.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
