"""Small allgathers and allreduces side by side on the port's base engine:
the counterpart of tools/allgather_probe.py.

The consensus table exchange is the only user of small-payload allgather;
in rabit_tpu it took a flat ~44 ms an op on the table path while small
allreduces took tens of microseconds.  This probe times both on the
port's native base engine (no consensus wrapping), under the port's
``LocalCluster``, so a stall of the same shape can be attributed.  Rank 0
prints one line an op:

    allreduce: median=...ms p90=...ms max=...ms
    allgather: median=...ms p90=...ms max=...ms

    python tools/torch_allgather_probe.py [--world 2] [--iters 50] [--bytes 32]

The workers import numpy and the port's api (no torch) and run on the
host CPU; imports no JAX and nothing of rabit_tpu.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

WORKER_SRC = """
import sys, time
sys.path.insert(0, sys.argv[3])
import numpy as np
from rabit_tpu_torch import api as rt

iters = int(sys.argv[1])
nbytes = int(sys.argv[2])
rt.init()
rank = rt.get_rank()
x = np.zeros(max(nbytes // 8, 1), np.float64)
rt.allreduce(x, rt.SUM)  # warm links
rt.allgather(x)

for name, fn in [
    ("allreduce", lambda: rt.allreduce(x, rt.SUM)),
    ("allgather", lambda: rt.allgather(x)),
]:
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    if rank == 0:
        rt.tracker_print(
            f"{name}: median={ts[len(ts)//2]*1e3:.3f}ms "
            f"p90={ts[int(len(ts)*0.9)]*1e3:.3f}ms max={ts[-1]*1e3:.3f}ms\\n")
rt.finalize()
"""


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--bytes", type=int, default=32)
    ap.add_argument("--engine", default="base")
    args = ap.parse_args(argv)

    from rabit_tpu_torch.tracker.launcher import LocalCluster

    with tempfile.TemporaryDirectory() as td:
        worker = Path(td) / "worker.py"
        worker.write_text(WORKER_SRC)
        cluster = LocalCluster(args.world, quiet=True)
        rc = cluster.run(
            [sys.executable, str(worker), str(args.iters), str(args.bytes), str(REPO),
             f"rabit_engine={args.engine}"],
            timeout=300.0,
        )
        for m in cluster.messages:
            print(m.strip())
        return rc


if __name__ == "__main__":
    sys.exit(main())
