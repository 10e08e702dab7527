#!/usr/bin/env python3
"""Time the port's histogram path piece by piece on one CUDA card.

    python3 tools/torch_hist_levels.py [--rows N] [--chunk-rows C ...]

At bench.py's shape (1M rows x 28 features x 256 bins by default, seeded
random bins, node ids and split tables) and for each level d = 0..7 of the
route mode (d = 0: the root) in bf16 and i8, prints the CUDA-event mean ms
of ``hist_prep``, ``hist_partition``, ``hist_accumulate`` and the whole
``hist_level`` / ``hist_level0`` call, for each chunk size given.  The
card's name and power limit come first.  Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

F, B = 28, 256


def cuda_ms(torch, fn, reps: int = 10) -> float:
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile(torch, fn, reps: int = 10) -> None:
    """Device time per kernel (us a call) over ``reps`` calls of ``fn``, and
    the host's wall time a call."""
    import time

    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e6
    rows = []
    for e in p.key_averages():
        dev = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        if dev > 0 and e.device_type.name == "CUDA":
            rows.append((dev / reps, e.key[:60]))
    total = sum(t for t, _ in rows)
    print(f"    device {total:.1f} us a call (wall {wall:.1f} us): " +
          "; ".join(f"{k} {t:.1f}" for t, k in sorted(rows, reverse=True)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--chunk-rows", type=int, nargs="+", default=[4096])
    ap.add_argument("--profile", action="store_true",
                    help="also trace 10 calls a level under torch.profiler and "
                         "print the device time of each kernel")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from rabit_tpu_torch.ops import boost

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    rng = np.random.RandomState(0)
    n = args.rows
    t = lambda a: torch.as_tensor(a, device="cuda")
    xb3, _ = boost.block_rows(t(rng.randint(0, B, size=(n, F)).astype(np.int32)))
    g3, _ = boost.block_rows(t(rng.randn(n).astype(np.float32)))
    h3, _ = boost.block_rows(t(rng.rand(n).astype(np.float32)))
    rows = xb3.shape[0] * xb3.shape[1]
    for C in args.chunk_rows:
        for i8 in (False, True):
            for d in range(8):
                n_prev = max(1, 2 ** (d - 1))
                node3 = t(rng.randint(0, n_prev, size=tuple(g3.shape)).astype(np.int32))
                feat = t(rng.randint(0, F, size=n_prev).astype(np.int32))
                thr = t(rng.randint(0, B, size=n_prev).astype(np.int32))
                mode = "root" if d == 0 else "route"
                kw = dict(n_rows=rows, block=xb3.shape[1], n_nodes=2 ** d, i8=i8)
                nd = None if d == 0 else node3
                prep = lambda: boost.hist_prep(mode, xb3, nd, g3, h3, feat, thr, **kw)
                key, counts, scale = prep()
                part_fn = lambda: boost.hist_partition(None if d == 0 else key, g3, h3,
                                                       counts, scale, chunk_rows=C, **kw)
                part = part_fn()
                acc = lambda: boost.hist_accumulate(xb3, part, scale, block=kw["block"],
                                                    n_nodes=2 ** d, n_bins=B, i8=i8,
                                                    name="probe")
                whole = ((lambda: boost.hist_level0(xb3, g3, h3, n_bins=B, mxu_i8=i8))
                         if d == 0 else
                         (lambda: boost.hist_level(xb3, node3, g3, h3, feat, thr,
                                                   depth=d, n_bins=B, mxu_i8=i8)))
                print(f"C={C} {'i8' if i8 else 'bf16'} d={d}: prep {cuda_ms(torch, prep):.4f}"
                      f" partition {cuda_ms(torch, part_fn):.4f} accumulate "
                      f"{cuda_ms(torch, acc):.4f} whole {cuda_ms(torch, whole):.4f} ms"
                      f" ({int(part.node_chunk0[-1])} chunks)", flush=True)
                if args.profile:
                    profile(torch, whole)
    return 0


if __name__ == "__main__":
    sys.exit(main())
