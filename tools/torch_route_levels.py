#!/usr/bin/env python3
"""Time the port's final row passes (route_level, route_margin_level,
leaf_fit) on one CUDA card.

    python3 tools/torch_route_levels.py [--rows N] [--depths 6 8] [--reps 50]
        [--leaf-depths 6 8 13 16] [--profile]
        [--strides 1 4 8 16 28 32 64] [--stride-rows N] [--tree DIR]

On chip_smoke.py's data (bench.py's generator, seed 0; 1M rows x 28
features x 256 bins by default) with its seeded node ids and split tables
(``Smoke.level_inputs``), prints for each kernel at each depth given:

* ``device_us``: the kernel's device time per launch from ``torch.profiler``
  (``chip_smoke.device_ms``), warm (back-to-back launches on the same
  inputs) and cold (a 256 MB read before each launch evicts the 50 MB L2);
* ``host_us``: the host's wall time per wrapper call, calls issued back to
  back with no synchronisation (what the host spends to launch one), the
  median over 11 windows;
* ``event_us``: the CUDA-event mean over back-to-back calls
  (``chip_smoke.cuda_ms``, as its report takes it: about the larger of the
  two above).

``--leaf-depths`` times ``leaf_fit`` the same way (all its kernels and
fills: ``device_us`` is everything one call puts on the card) on the real
round's last level of a depth-6 tree (``Smoke.leaf_inputs``, what
chip_smoke.py reports) and on seeded node ids at each depth given, beside
its floor: a row's 64-byte bin fetch and 16 bytes of node id, g, h in and
leaf id out at 3.35 TB/s.  ``--profile`` adds each of its kernels' and
fills' device time a call (``chip_smoke.kernel_ms``).  Leave
``--depths`` empty to time ``leaf_fit`` alone.

``--strides`` routes ``--stride-rows`` rows whose bin rows are S int32 wide
(one bin read a row, as in the round) and prints the cold device time per
row and the bytes a row that time would move at 3.35 TB/s: whether one
row's bin costs one 32-byte sector of device-memory traffic or more.

``--tree DIR`` times the ``rabit_tpu_torch`` of another checkout (for
example a ``git archive`` of the parent commit) with this checkout's
``chip_smoke.py``, so that two versions are compared in one call.  The
card's name and power limit come first; the last line is one JSON object
with every figure.  Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (DEPTH, HBM_BYTES_PER_S, N_BINS, Smoke, cuda_ms,  # noqa: E402
                        device_ms, kernel_ms, nvidia_smi)

KERNEL = "route_kernel"  # the profiler's name of both route kernels
FLUSH = "reduce"         # the L2 flush's kernel (no kernel of leaf_fit's has the word)
LEAF_FLOOR_BYTES = 64 + 16  # a row's bin fetch; node id, g, h in, leaf id out


def host_us(torch, fn, reps: int, windows: int = 11) -> float:
    """Wall time per call of ``fn`` issued back to back, no synchronisation
    inside a window of ``reps`` calls (the device runs behind): the median
    over ``windows`` windows, so that a moment the shared host is busy
    elsewhere does not decide it."""
    fn()
    per_call = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def levels(torch, smoke, args, flush) -> dict:
    boost, xb3, margin3 = smoke.boost, smoke.xb3, smoke.margin3
    rows = xb3.shape[0] * xb3.shape[1]
    out = {}
    for d in args.depths:
        node3, feat, thr = smoke.level_inputs(d)
        gen = torch.Generator(device="cuda").manual_seed(7)
        leaf = torch.randn(2 ** d, generator=gen, device="cuda")
        calls = {
            "route_level": lambda: boost.route_level(xb3, node3, feat, thr, depth=d),
            "route_margin_level": lambda: boost.route_margin_level(
                xb3, node3, margin3, feat, thr, leaf, depth=d),
        }
        for name, fn in calls.items():
            r = {"warm_device_us": device_ms(torch, fn, args.reps, KERNEL) * 1e3,
                 "cold_device_us": device_ms(torch, lambda: (flush(), fn()),
                                             args.reps, KERNEL) * 1e3,
                 "host_us": host_us(torch, fn, args.reps),
                 "event_us": cuda_ms(torch, fn, args.reps) * 1e3}
            per_row = 32 + 4 + 4 + (8 if name == "route_margin_level" else 0)
            r["bound_us"] = rows * per_row / HBM_BYTES_PER_S * 1e6
            out[f"{name} d={d}"] = r
            print(f"{name} d={d}: device {r['warm_device_us']:.2f} us warm, "
                  f"{r['cold_device_us']:.2f} us cold; host {r['host_us']:.2f} us a "
                  f"call; event mean {r['event_us']:.2f} us; bound "
                  f"{r['bound_us']:.2f} us", flush=True)
    return out


def leaf_levels(torch, smoke, args, flush) -> dict:
    """leaf_fit on the real round's last level and at each --leaf-depths."""
    boost = smoke.boost
    rows = smoke.xb3.shape[0] * smoke.xb3.shape[1]
    floor_us = rows * LEAF_FLOOR_BYTES / HBM_BYTES_PER_S * 1e6
    smoke.levels = smoke.real_levels()
    cases = {f"real d={DEPTH}": (smoke.leaf_inputs()[0], DEPTH)}
    for d in args.leaf_depths:
        node3, feat, thr = smoke.level_inputs(d)
        cases[f"d={d}"] = ((smoke.xb3, node3, smoke.g3, smoke.h3, feat, thr), d)
    out = {}
    for name, (largs, d) in cases.items():
        fn = lambda: boost.leaf_fit(*largs, depth=d)
        try:
            fn()
        except ValueError as e:  # a depth an older tree refuses
            out[name] = {"refused": str(e)}
            print(f"leaf_fit {name}: refused ({e})", flush=True)
            continue
        r = {"warm_device_us": device_ms(torch, fn, args.reps, skip=FLUSH) * 1e3,
             "cold_device_us": device_ms(torch, lambda: (flush(), fn()), args.reps,
                                         skip=FLUSH) * 1e3,
             "host_us": host_us(torch, fn, args.reps),
             "event_us": cuda_ms(torch, fn, args.reps) * 1e3,
             "floor_us": floor_us}
        out[name] = r
        print(f"leaf_fit {name}: device {r['warm_device_us']:.2f} us warm, "
              f"{r['cold_device_us']:.2f} us cold; host {r['host_us']:.2f} us a call; "
              f"event mean {r['event_us']:.2f} us; floor {floor_us:.2f} us", flush=True)
        if args.profile:
            r["kernels_us"] = {k: v * 1e3 for k, v in
                               kernel_ms(torch, fn, args.reps, skip=FLUSH).items()}
            print("    " + "; ".join(f"{k[:48]} {v:.2f}" for k, v in sorted(
                r["kernels_us"].items(), key=lambda kv: -kv[1])), flush=True)
    return out


def strides(torch, boost, args, flush) -> dict:
    """Cold device time of route_level at several bin-row widths."""
    out = {}
    n, d = args.stride_rows, 6
    gen = torch.Generator(device="cuda").manual_seed(5)
    node3 = torch.randint(0, 2 ** (d - 1), (n // 1024, 1024, 1), generator=gen,
                          device="cuda", dtype=torch.int32)
    thr = torch.randint(0, N_BINS, (2 ** (d - 1),), generator=gen, device="cuda",
                        dtype=torch.int32)
    for s in args.strides:
        xb3 = torch.randint(0, N_BINS, (n // 1024, 1024, s), generator=gen,
                            device="cuda", dtype=torch.int32)
        feat = torch.randint(0, s, (2 ** (d - 1),), generator=gen, device="cuda",
                             dtype=torch.int32)
        fn = lambda: (flush(), boost.route_level(xb3, node3, feat, thr, depth=d))
        us = device_ms(torch, fn, args.reps, KERNEL) * 1e3
        ns_row = us * 1e3 / n
        out[s] = {"cold_device_us": us, "ns_per_row": ns_row,
                  "bytes_per_row_at_peak": ns_row * 1e-9 * HBM_BYTES_PER_S}
        print(f"stride {s} int32 ({4 * s} B a row), {n} rows: {us:.2f} us cold, "
              f"{ns_row * 1e3:.3f} ps a row = {out[s]['bytes_per_row_at_peak']:.1f} "
              f"B a row at 3.35 TB/s (node in + out: 8 B)", flush=True)
        del xb3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--depths", type=int, nargs="*", default=[6, 8])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--leaf-depths", type=int, nargs="*", default=None,
                    help="also time leaf_fit: the real round's last level and these depths")
    ap.add_argument("--profile", action="store_true",
                    help="with --leaf-depths: each leaf_fit kernel's device time a call")
    ap.add_argument("--strides", type=int, nargs="*", default=[])
    ap.add_argument("--stride-rows", type=int, default=8 << 20)
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose rabit_tpu_torch to time (default: this one)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from rabit_tpu_torch.models import gbdt
    from rabit_tpu_torch.ops import boost, hist

    card = nvidia_smi()
    print(card)
    print(f"rabit_tpu_torch from {os.path.dirname(boost.__file__)}", flush=True)
    big = torch.zeros(256 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: big.max()  # reads 256 MB: the L2 holds none of the inputs
    smoke = Smoke(torch, boost, hist, gbdt, args.rows)
    report = {"card": card, "tree": tree, "levels": levels(torch, smoke, args, flush)}
    if args.leaf_depths is not None:
        report["leaf_fit"] = leaf_levels(torch, smoke, args, flush)
    if args.strides:
        report["strides"] = strides(torch, boost, args, flush)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
