"""Worker of the custom reducer (``Engine.allreduce_fn``) on the port's
engines: each rank's input is seeded by its rank, the reducer keeps, per
element, the (key, val) pair with the larger key (ties: the larger val),
and the result goes to ``OUT.<rank>`` as raw bytes.

    MASTER_ADDR=... MASTER_PORT=... WORLD_SIZE=... RANK=... \\
        python torch_reducer_worker.py OUT rabit_engine=torch rabit_torch_device=cpu
    python -m rabit_tpu_torch.tracker.launcher -n 2 -- \\
        python torch_reducer_worker.py OUT rabit_engine=native

Imports numpy and the port only.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import api  # noqa: E402

PAIR = np.dtype([("key", "<i4"), ("val", "<f4")])
N = 257


def rank_input(rank: int) -> np.ndarray:
    rng = np.random.RandomState(7000 + rank)
    out = np.zeros(N, PAIR)
    out["key"] = rng.randint(0, 5, N)
    out["val"] = rng.randint(-50, 50, N).astype(np.float32)
    return out


def max_by_key(acc: np.ndarray, part: np.ndarray) -> np.ndarray:
    take = (part["key"] > acc["key"]) | ((part["key"] == acc["key"])
                                        & (part["val"] > acc["val"]))
    out = acc.copy()
    out[take] = part[take]
    return out


def main(argv: list[str]) -> int:
    out_path, args = argv[0], argv[1:]
    api.init(args)
    rank = api.get_rank()
    got = api.get_engine().allreduce_fn(rank_input(rank), max_by_key)
    Path(f"{out_path}.{rank}").write_bytes(np.ascontiguousarray(got).tobytes())
    api.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
