"""Self-verifying fault-tolerance workload on the port's api: the port's
copy of tests/workers/recover_worker.py (imports numpy and the port only).

Each iteration runs a MAX allreduce, a broadcast from a rotating root, a
SUM allreduce and an allgather, whose results are known in closed form and
checked element by element, then checkpoints.  Run under a launcher with
``rabit_engine=mock mock=rank,version,seqno,trial``, the engine kills the
process at exactly those points; the launcher restarts it, and the new
life must recover its model from its peers and keep every check passing.

Worker args (k=v, all also handed to the engine; the last one wins):
    ndata=N        elements per collective (default 100)
    niter=N        iterations == checkpoints (default 3)
    local=1        also checkpoint a per-rank local model
    lazy=1         use lazy_checkpoint
    preload_op=1   broadcast before load_checkpoint, which a restarted life
                   replays from the bootstrap cache (rabit_bootstrap_cache=1)
                   by its call site's cache key
    sleep=S        sleep S seconds before each iteration, so timed
                   preemptions and freezes land mid-work
    straggler=R    rank R also sleeps straggler_sleep seconds (default
                   0.25) before each iteration's first collective: an
                   injected straggler whose arrival skew the trace
                   analytics must pin on R (tools/torch_trace_tool.py)
    blob_mb=F      carry an F-MiB byte blob in the global model, its content
                   a closed form of the version, so a recovered or resumed
                   blob is checked byte for byte
    stop_at=K      every worker exits cleanly right after checkpoint K (a
                   whole-job stop, for the durable spill's resume)
    codec=NAME     check the f32 MAX allreduce against the codec's
                   reference fold (rabit_tpu_torch.compress
                   .reference_allreduce) instead of the exact value; pair
                   with rabit_compress_allreduce=NAME and a small
                   rabit_compress_min_bytes so the engine compresses.  The
                   check is exact: a compressed collective's result, after a
                   recovery's replay too, is bitwise the reference fold's
"""

import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import api as rt  # noqa: E402


def getarg(name: str, default: str) -> str:
    for a in reversed(sys.argv[1:]):  # the last one wins, as in the config layer
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return default


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"[{rt.get_rank()}] self-check failed: {what}")


def main() -> int:
    ndata = int(getarg("ndata", "100"))
    niter = int(getarg("niter", "3"))
    use_local = getarg("local", "0") == "1"
    use_lazy = getarg("lazy", "0") == "1"
    preload_op = getarg("preload_op", "0") == "1"
    pause = float(getarg("sleep", "0"))
    straggler = int(getarg("straggler", "-1"))
    straggler_sleep = float(getarg("straggler_sleep", "0.25"))
    codec = getarg("codec", "")
    blob_mb = float(getarg("blob_mb", "0"))
    stop_at = int(getarg("stop_at", "0"))

    def blob_for(ver: int) -> bytes:
        return bytes([ver & 0xFF]) * int(blob_mb * (1 << 20))

    rt.init()
    rank, world = rt.get_rank(), rt.get_world_size()

    if preload_op:
        cfg = rt.broadcast({"seed": 42, "ndata": ndata} if rank == 0 else None, 0)
        check(cfg == {"seed": 42, "ndata": ndata}, f"preload broadcast {cfg}")

    if use_local:
        version, model, lmodel = rt.load_checkpoint(with_local=True)
    else:
        version, model = rt.load_checkpoint()
        lmodel = None
    first_life = int(os.environ.get("DMLC_NUM_ATTEMPT", "0")) == 0
    if version == 0:
        model = {"iter": 0, "history": []}
        lmodel = {"rank": rank, "iter": 0}
    elif use_local and lmodel is None and first_life:
        # A durable resume's documented degradation: a first life killed
        # between the commit and its own local save resumes at the agreed
        # version with no local model, and rebuilds it.  A restarted life
        # must get its local model from its peers' replicas.
        lmodel = {"rank": rank, "iter": version}
        rt.tracker_print(f"[{rank}] rebuilt local state at version {version}")
    check(model["iter"] == version, f"model vs version {version}")
    if blob_mb and version > 0:
        check(model.get("blob") == blob_for(version), f"blob mismatch at version {version}")
    if use_local:
        check(lmodel["rank"] == rank, f"local model {lmodel} not mine")
    if not first_life:
        # the recovered_at= stamp makes the tracker record a worker_recovered event
        rt.tracker_print(f"[{rank}] recovered version={version} recovered_at={time.time():.6f}")
    elif version > 0:
        # a first life at version > 0 resumed from the durable spill: the
        # stamp makes the tracker record a disk_resume event
        rt.tracker_print(f"[{rank}] resumed from disk at version {version} ts={time.time():.6f}")

    for it in range(version, niter):
        if pause:
            time.sleep(pause)
        if rank == straggler:
            # the others reach the MAX allreduce first and wait here
            time.sleep(straggler_sleep)
        # MAX: data[i] = rank + i + it  ->  world-1 + i + it
        a = (np.arange(ndata) + rank + it).astype(np.float32)
        out = rt.allreduce(a, rt.MAX)
        if codec:
            # the compressed path: every rank's known contribution through
            # the codec's reference fold
            from rabit_tpu_torch.compress import reference_allreduce

            expect = reference_allreduce([(np.arange(ndata) + r + it).astype(np.float32)
                                          for r in range(world)], rt.MAX, codec)
        else:
            expect = (np.arange(ndata) + world - 1 + it).astype(np.float32)
        check(np.array_equal(out, expect), f"iter {it} max {out[:4]}")

        root = it % world
        msg = {"iter": it, "root": root}
        got = rt.broadcast(msg if rank == root else None, root)
        check(got == msg, f"iter {it} bcast {got}")

        # SUM: data[i] = i + rank + it -> world*(i+it) + world*(world-1)/2
        a = (np.arange(ndata) + rank + it).astype(np.float64)
        out = rt.allreduce(a, rt.SUM)
        expect = (world * (np.arange(ndata) + it) + world * (world - 1) / 2
                  ).astype(np.float64)
        check(np.array_equal(out, expect), f"iter {it} sum {out[:4]}")

        g = rt.allgather(np.array([rank, it, rank * it], np.int64))
        expect = np.array([[r, it, r * it] for r in range(world)], np.int64)
        check(np.array_equal(g, expect), f"iter {it} allgather {g}")

        # A fresh model object each iteration: a lazy checkpoint may still
        # serve the previous one while this one commits.
        model = {"iter": it + 1, "history": model["history"] + [it]}
        if blob_mb:
            model["blob"] = blob_for(it + 1)
        if use_local:
            lmodel = {"rank": rank, "iter": it + 1}
            rt.checkpoint(model, lmodel)
        elif use_lazy:
            rt.lazy_checkpoint(model)
        else:
            rt.checkpoint(model)
        check(rt.version_number() == it + 1, "version after checkpoint")
        if stop_at and it + 1 == stop_at:
            check(model["history"] == list(range(stop_at)), f"history at stop {model['history']}")
            rt.tracker_print(f"[{rank}] stopping at version {stop_at}")
            rt.finalize()
            return 0

    check(model["history"] == list(range(niter)), f"history {model['history']}")
    rt.tracker_print(f"[{rank}] all {niter} iterations verified")
    rt.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
