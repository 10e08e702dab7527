#!/usr/bin/env python3
"""Time the port's histogram path piece by piece on one CUDA card.

    python3 tools/torch_hist_levels.py [--rows N] [--chunk-rows C ...]
        [--depths 0 1 ... 7] [--bins B ...] [--profile] [--helpers]
        [--digest FILE] [--tree DIR]

At bench.py's shape (1M rows x 28 features x 256 bins by default, seeded
random bins, node ids and split tables) and for each bin count and each
level d given (default 0..7) of the route mode (d = 0: the root) in bf16
and i8, prints the CUDA-event mean ms of ``hist_prep``, ``hist_partition``,
``hist_accumulate``, the whole ``hist_level`` / ``hist_level0`` call and
the whole ``node_histograms_kernel`` call (the same rows unblocked, node ids
over 2**d nodes), for each chunk size given, and the least time the whole
call could take: the bytes it must move at 3.35 TB/s.  Those are the rows
(xb, g, h, the node id in and out) and, deep in the tree, the histogram
itself and the chunk partials that hist_accumulate writes and sum_chunks
reads back (8 bytes a (chunk, feature, bin)); past d = 12 these outweigh
the rows.  Levels past 12 hold more than 4096 nodes: the sorting
partition.  Past 256 bins the tile kernel reads each row's bins once a
window of 256 bins; a second bound counts those reads.

``--profile`` adds each CUDA kernel's device time a call
(``chip_smoke.kernel_ms``) and the host's wall time a call
(``tools/torch_route_levels.host_us``); ``--helpers`` prints only the
device time of ``hist_prep`` and ``hist_partition`` a call (bf16), the
figures PERF.md holds them to, and with ``--both-paths`` each on both
partition paths (the shared-memory counters, at most 4096 nodes, and the
sorting path; the tool moves ``boost._SORT_NODES`` to force one), which
sets where the wrapper switches.  ``--digest FILE`` writes a SHA-256 of
each output (histograms, node ids, counts, i8 scales, partition) of every
level, encoding and mode to FILE as JSON, so that two versions' outputs can
be compared bit for bit.  ``--tree DIR`` times the
``rabit_tpu_torch`` of another checkout (a ``git archive`` of the parent
commit, say), so that two versions are compared in one call.  The card's name and power limit come
first.  Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import HBM_BYTES_PER_S, cuda_ms, kernel_ms, nvidia_smi  # noqa: E402
from tools.torch_route_levels import host_us  # noqa: E402

F, B = 28, 256


def device_us(torch, fn, reps: int = 10, show: bool = False) -> float:
    """Device time a call of ``fn`` (us), kernel by kernel when ``show``
    (with the host's wall time a call)."""
    ks = {k: v * 1e3 for k, v in kernel_ms(torch, fn, reps).items()}
    total = sum(ks.values())
    if show:
        print(f"    device {total:.1f} us a call (host {host_us(torch, fn, reps):.1f} us): " +
              "; ".join(f"{k[:60]} {t:.1f}" for k, t in sorted(ks.items(), key=lambda kv: -kv[1])),
              flush=True)
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--chunk-rows", type=int, nargs="+", default=[4096])
    ap.add_argument("--depths", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--bins", type=int, nargs="+", default=[B])
    ap.add_argument("--digest", help="write each output's SHA-256 to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 10 calls a level under torch.profiler and "
                         "print the device time of each kernel")
    ap.add_argument("--helpers", action="store_true",
                    help="print only hist_prep's and hist_partition's device time a "
                         "call (bf16)")
    ap.add_argument("--both-paths", action="store_true",
                    help="with --helpers: time both partition paths (this tree only)")
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose rabit_tpu_torch to time (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from rabit_tpu_torch.ops import boost, hist

    print(nvidia_smi())
    print(f"rabit_tpu_torch from {os.path.dirname(boost.__file__)}", flush=True)
    digests = {}

    def digest(key, *ts):
        for i, a in enumerate(ts):
            if a is not None:
                b = a.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                digests[f"{key}/{i}"] = hashlib.sha256(b).hexdigest()

    for n_bins in args.bins:
        levels(torch, boost, hist, args, n_bins, digest)
    if args.digest:
        with open(args.digest, "w") as f:
            json.dump(digests, f, indent=0, sort_keys=True)
    return 0


def levels(torch, boost, hist, args, B, digest) -> None:
    """The timings of one bin count B."""
    rng = np.random.RandomState(0)
    n = args.rows
    t = lambda a: torch.as_tensor(a, device="cuda")
    xb3, _ = boost.block_rows(t(rng.randint(0, B, size=(n, F)).astype(np.int32)))
    g3, _ = boost.block_rows(t(rng.randn(n).astype(np.float32)))
    h3, _ = boost.block_rows(t(rng.rand(n).astype(np.float32)))
    rows = xb3.shape[0] * xb3.shape[1]
    n_win = -(-B // 256)  # the tile kernel's bin windows
    for C in args.chunk_rows:
        for i8 in (False,) if args.helpers else (False, True):
            for d in args.depths:
                n_prev = max(1, 2 ** (d - 1))
                node3 = t(rng.randint(0, n_prev, size=tuple(g3.shape)).astype(np.int32))
                feat = t(rng.randint(0, F, size=n_prev).astype(np.int32))
                thr = t(rng.randint(0, B, size=n_prev).astype(np.int32))
                ids = t(rng.randint(0, 2 ** d, size=n).astype(np.int32))
                mode = "root" if d == 0 else "route"
                kw = dict(n_rows=rows, block=xb3.shape[1], n_nodes=2 ** d, i8=i8)
                nd = None if d == 0 else node3
                prep = lambda: boost.hist_prep(mode, xb3, nd, g3, h3, feat, thr, **kw)
                key, counts, scale = prep()
                part_fn = lambda: boost.hist_partition(None if d == 0 else key, g3, h3,
                                                       counts, scale, chunk_rows=C, **kw)
                part = part_fn()
                if args.helpers:
                    paths = ((None,) if not args.both_paths else
                             (False, True) if 2 ** d <= 4096 else (True,))
                    for large in paths:
                        if large is not None:  # force a path: the sorting one past 0
                            sort_nodes, boost._SORT_NODES = boost._SORT_NODES, 0 if large else 4096
                        p_fn = lambda: boost.hist_prep(mode, xb3, nd, g3, h3, feat, thr, **kw)
                        k2, c2, s2 = p_fn()
                        q_fn = lambda: boost.hist_partition(None if d == 0 else k2, g3, h3,
                                                            c2, s2, chunk_rows=C, **kw)
                        name = "" if large is None else " sorting" if large else " shared"
                        print(f"d={d}{name} helpers device us a call: prep "
                              f"{device_us(torch, p_fn, 20):.2f} partition "
                              f"{device_us(torch, q_fn, 20):.2f}", flush=True)
                        if large is not None:
                            boost._SORT_NODES = sort_nodes
                    continue
                acc = lambda: boost.hist_accumulate(xb3, part, scale, block=kw["block"],
                                                    n_nodes=2 ** d, n_bins=B, i8=i8,
                                                    name="probe")
                whole = ((lambda: boost.hist_level0(xb3, g3, h3, n_bins=B, mxu_i8=i8))
                         if d == 0 else
                         (lambda: boost.hist_level(xb3, node3, g3, h3, feat, thr,
                                                   depth=d, n_bins=B, mxu_i8=i8)))
                nodes = lambda: hist.node_histograms_kernel(
                    xb3.reshape(-1, F)[:n], g3.reshape(-1)[:n], h3.reshape(-1)[:n], ids,
                    2 ** d, B, mxu_i8=i8)
                chunks = int(part.node_chunk0[-1])
                enc = "i8" if i8 else "bf16"
                if args.digest:
                    out, node_out = (whole(), None) if d == 0 else whole()
                    n_listed = int(part.node_base[-1])
                    digest(f"B={B} C={C} {enc} d={d} route", out, node_out, counts, scale,
                           part.node_chunk0, part.chunk_begin[:chunks],
                           None if part.perm is None else part.perm[:n_listed],
                           part.planes[:n_listed])
                    digest(f"B={B} C={C} {enc} d={d} nodes", nodes())
                out_bytes = 2 ** d * F * B * 8
                byts = (rows * (4 * F + 2 * 4 + (8 if d else 0))  # xb, g, h, node in/out
                        + out_bytes + (2 * chunks * F * B * 8 if d else 0))
                reread = rows * 4 * F * (n_win - 1)  # the bins again, a window each
                print(f"B={B} C={C} {enc} d={d}: prep {cuda_ms(torch, prep, 10):.4f}"
                      f" partition {cuda_ms(torch, part_fn, 10):.4f} accumulate "
                      f"{cuda_ms(torch, acc, 10):.4f} whole {cuda_ms(torch, whole, 10):.4f}"
                      f" nodes {cuda_ms(torch, nodes, 10):.4f} ms"
                      f" ({chunks} chunks; bound {byts / HBM_BYTES_PER_S * 1e3:.4f} ms:"
                      f" {byts / 1e6:.1f} MB, of which histogram {out_bytes / 1e6:.1f} MB;"
                      f" with {n_win} windows' reads {(byts + reread) / HBM_BYTES_PER_S * 1e3:.4f}"
                      " ms)", flush=True)
                del part
                if args.profile:
                    device_us(torch, whole, show=True)
                    device_us(torch, nodes, show=True)


if __name__ == "__main__":
    sys.exit(main())
