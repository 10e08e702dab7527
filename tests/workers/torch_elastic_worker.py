"""An elastic histogram job of the port: one worker of
``rabit_tpu_torch.elastic.ElasticWorker``, launched by the port's
``LocalCluster`` (``spares=K`` marks the hot spares with
``RABIT_TPU_RABIT_SPARE=1``), the counterpart of
tests/workers/elastic_worker.py.

Every version each rank histograms its ``shard_slice`` of one dataset, re-cut
at every world size: the bins of bench.py's generator (seed 0; ``rows`` x
28 features x ``bins``), row i in node ``(11 i) mod nodes``, with
g = ((7 i + 13 v) mod 17) - 8, an integer in [-8, 8], and h = 1.  Every f32
partial sum is then an integer below 2^24, so the histogram is exact and
crosses the ring as int64: the rank-order fold gives the same bits at every
world size.  The state is the sum of the versions' histograms.

* ``device=cpu`` (the default): the histogram in numpy (``np.bincount``).
  This mode imports no torch, so that a process starts in well under a
  second; the worker checks its final state against the world-1 totals in
  numpy and exits 1 on a wrong bit.
* ``device=cuda``: the bins stay whole on the card and each version
  launches ``ops.hist.node_histograms_kernel`` (csrc/hist.cu nodes mode)
  on this rank's rows.  Before it checks in (or parks) the worker warms
  up: the card touched, the bins resident, one contribution launched (not
  counted).  The caller checks the state (chip_smoke.py's elastic phase).

Worker args (k=v on the command line):
    device=cpu|cuda  rows=N (default 2000)  bins=B (default 16)
    nodes=K (default 4)  niter=N (default 6)
    sleep=S          seconds per version (default 0.05): keeps the run long
                     enough for a kill to land mid-job
    hb=S             heartbeat interval (default 0.2; leases expire at 2x)
    die=TASK:V       task TASK dies silently before contributing to version V
                     (exit 0 at once, with no teardown: a scheduled death is
                     not restarted)
    park_after_shrink=1  a spare parks only once the tracker's world is
                     below ``world`` (the grow-back spare of a shrink run);
                     otherwise a spare parks once the job's first wave has
                     closed, so that it stands by for a running job rather
                     than race a primary slow to start into that wave
    world=W          the launch world (for park_after_shrink; default 2)
    restart_delay=S  a restarted life (DMLC_NUM_ATTEMPT > 0) waits S seconds
                     before it checks in, as one that takes long to reach a
                     card does
    deadline=S       the worker's deadline (default 60)
    out=DIR          write DIR/<task>-<pid>.npz: the result, the commit
                     wall times, and (cuda) this life's kernel launches

Exit codes: 0 = completed (and, on the CPU, bitwise right), a spare never
needed, a worker released from its park, or a scheduled death; 1 = wrong
bits or an error.
"""

import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch.config import Config  # noqa: E402
from rabit_tpu_torch.elastic import settings, shard_slice  # noqa: E402
from rabit_tpu_torch.elastic.client import ElasticWorker  # noqa: E402
from rabit_tpu_torch.tracker import protocol as P  # noqa: E402

N_FEATURES = 28


def getarg(name: str, default: str) -> str:
    for a in sys.argv[1:]:
        if a.startswith(name + "="):
            default = a.split("=", 1)[1]
    return default


def make_bins(n_rows: int, n_bins: int, seed: int = 0) -> np.ndarray:
    """bench.py's generator's bins (its first draw), [n_rows, 28] int32."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, n_bins, size=(n_rows, N_FEATURES), dtype=np.int32)


def row_nodes(n_rows: int, n_nodes: int) -> np.ndarray:
    return (np.arange(n_rows, dtype=np.int64) * 11 % n_nodes).astype(np.int32)


def row_grads(lo: int, hi: int, version: int) -> np.ndarray:
    """g of rows [lo, hi) at ``version``: integers in [-8, 8]."""
    i = np.arange(lo, hi, dtype=np.int64)
    return ((7 * i + 13 * version) % 17 - 8).astype(np.float32)


def numpy_hist(xb, node, g, n_nodes: int, n_bins: int) -> np.ndarray:
    """[n_nodes, F, B, 2] int64 (g and h = 1) by bincount, exact."""
    F = xb.shape[1]
    idx = ((node.astype(np.int64)[:, None] * F + np.arange(F)) * n_bins + xb).reshape(-1)
    size = n_nodes * F * n_bins
    hg = np.bincount(idx, weights=np.repeat(g.astype(np.float64), F), minlength=size)
    hh = np.bincount(idx, minlength=size)
    return np.stack([hg.astype(np.int64), hh.astype(np.int64)], -1).reshape(
        n_nodes, F, n_bins, 2)


def expected_totals(xb, node, niter: int, n_nodes: int, n_bins: int) -> np.ndarray:
    n = xb.shape[0]
    return sum(numpy_hist(xb, node, row_grads(0, n, v), n_nodes, n_bins)
               for v in range(1, niter + 1))


def card_contribution(xb_np, node_np, n_nodes: int, n_bins: int):
    """The card's contribution and its launch counters: the bins and node
    ids move to the card once; each call launches the kernel on this
    rank's rows."""
    import torch

    from rabit_tpu_torch.ops import boost
    from rabit_tpu_torch.ops.hist import node_histograms_kernel

    dev = torch.device("cuda")
    xb = torch.as_tensor(xb_np, device=dev)
    node = torch.as_tensor(node_np, device=dev)
    n = xb.shape[0]

    def contribution(version: int, world: int, rank: int) -> np.ndarray:
        sl = shard_slice(n, world, rank)
        g = torch.as_tensor(row_grads(sl.start, sl.stop, version), device=dev)
        h = torch.ones_like(g)
        hist = node_histograms_kernel(xb[sl], g, h, node[sl], n_nodes, n_bins)
        return hist.to(torch.int64).cpu().numpy()

    return contribution, boost


def main() -> int:
    host = os.environ["DMLC_TRACKER_URI"]
    port = int(os.environ["DMLC_TRACKER_PORT"])
    task_id = os.environ["DMLC_TASK_ID"]
    knobs = settings(Config(sys.argv[1:]))
    device = getarg("device", "cpu")
    rows = int(getarg("rows", "2000"))
    n_bins = int(getarg("bins", "16"))
    n_nodes = int(getarg("nodes", "4"))
    niter = int(getarg("niter", "6"))
    sleep = float(getarg("sleep", "0.05"))
    hb = float(getarg("hb", "0.2"))
    deadline = float(getarg("deadline", "60"))
    out = getarg("out", "")
    fail = None
    die = getarg("die", "")
    if die:
        die_task, die_version = die.split(":")
        if die_task == task_id:
            fail = ("die", int(die_version))

    xb = make_bins(rows, n_bins)
    node = row_nodes(rows, n_nodes)
    boost = None
    if device == "cuda":
        work, boost = card_contribution(xb, node, n_nodes, n_bins)
        work(1, 1, 0)  # warm: the card touched, the bins resident, the kernel loaded
        boost.launches.clear()
        boost.helper_launches.clear()
    else:
        def work(version: int, world: int, rank: int) -> np.ndarray:
            sl = shard_slice(rows, world, rank)
            return numpy_hist(xb[sl], node[sl], row_grads(sl.start, sl.stop, version),
                              n_nodes, n_bins)

    def contribution(version: int, world: int, rank: int) -> np.ndarray:
        time.sleep(sleep)
        return work(version, world, rank)

    # The failover list: the launcher's --standby exports rabit_tracker_addrs
    # (the primary first, then the warm standby), and the worker rotates
    # through it.
    addrs = P.parse_addrs(Config(sys.argv[1:]).get("rabit_tracker_addrs", "") or "")
    if knobs["spare"]:
        after_shrink = getarg("park_after_shrink", "0") == "1"
        base = int(getarg("world", "2"))
        end = time.monotonic() + deadline
        while time.monotonic() < end:
            info = P.tracker_rpc(host, port, P.CMD_EPOCH, task_id, message="0",
                                 timeout=2.0, retries=3, addrs=addrs)
            if info["world"] < base if after_shrink else info["epoch"] >= 0:
                break
            time.sleep(0.05)

    if int(os.environ.get("DMLC_NUM_ATTEMPT", "0")) > 0:
        time.sleep(float(getarg("restart_delay", "0")))
    worker = ElasticWorker(addrs or (host, port), task_id, contribution, niter,
                           spare=knobs["spare"], heartbeat_sec=hb,
                           deadline_sec=deadline, fail=fail)
    res = worker.run()
    if out:
        wall = time.time() - time.monotonic()  # commit times onto the wall clock
        launches = {}
        if boost is not None:
            launches = {f"launches/{k}": v
                        for k, v in {**boost.launches, **boost.helper_launches}.items()}
        np.savez(os.path.join(out, f"{task_id}-{os.getpid()}.npz"),
                 state=res.state if res.state is not None else np.zeros(0, np.int64),
                 completed=res.completed, promoted=res.promoted, died=res.died,
                 parked_only=res.parked_only, worlds=np.array(res.worlds),
                 epochs=np.array(res.epochs),
                 commits=np.array(sorted((v, t + wall) for v, t in res.commit_times.items()),
                                  dtype=np.float64).reshape(-1, 2),
                 **launches)
    if res.died and fail is not None:
        # The scheduled death, not to be restarted: the process goes at once,
        # as a crashed one would.  Tearing down the card's context can take
        # longer than the lapsing lease, whose monitor then SIGKILLs a worker
        # with no restart left.
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)
    if res.parked_only:
        return 0  # a spare never needed, or a worker released from its park
    if not res.completed:
        print(f"[torch_elastic_worker {task_id}] failed: {res.error}", file=sys.stderr,
              flush=True)
        return 1
    if device == "cpu":
        want = expected_totals(xb, node, niter, n_nodes, n_bins)
        if not np.array_equal(res.state, want):
            print(f"[torch_elastic_worker {task_id}] WRONG BITS at worlds {res.worlds}",
                  file=sys.stderr, flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
