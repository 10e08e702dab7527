"""Time the chip_smoke.py phases that spawn or launch worker processes on
the card, for a same-call A/B of two checkouts.

    python3 tools/torch_smoke_phases.py                   # this checkout
    python3 tools/torch_smoke_phases.py --tree _tree/parent
    python3 tools/torch_smoke_phases.py --phases quorum,failover
    python3 tools/torch_smoke_phases.py --phases relay
    python3 tools/torch_smoke_phases.py --phases dp,hybrid,recover,liveness,service
    python3 tools/torch_smoke_phases.py --phases relay,delivery,surface
    python3 tools/torch_smoke_phases.py --phases recovery

Builds the kernels and the native engine, then runs, in chip_smoke.py's
order and with its checks, the phases dp, engine, compress, hybrid and
recover of the checkout at ``--tree`` (default: the repository this file
is in), and its diagnose phase where that checkout's chip_smoke.py has
one.  ``--phases`` runs the named phases instead, in the order given
(any ``Smoke.<name>_phase`` that needs no earlier phase: ``quorum``,
``failover``, ``relay``, ``elastic``, ``service``, ``surface``, ...;
``relay`` runs the recover phase's clean gbdt run and its mid-tree kill
run behind relays itself unless ``recover`` ran before it; ``recover`` needs ``dp`` and ``hybrid`` before
it, whose forest it holds the native engine's to, and ``liveness`` needs
``recover``; ``dp`` is the dp phase's two steps).  Prints the card's name and power limit
(``nvidia-smi``) and one
``[phases] <tree> {...}`` line: each phase's wall seconds, the build and
the data set-up apart, and ``changed``, the sum of the phases.  Two whole
runs of chip_smoke.py back to back take longer than a machine with the
card may be held, so an A/B of two checkouts runs this for each, in both
orders.  Exits 1 when a phase fails.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose chip_smoke.py runs (default: this one)")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run instead of the default set")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)  # its chip_smoke and rabit_tpu_torch, also in spawned ranks
    import chip_smoke as cs
    import torch
    from rabit_tpu_torch import _build
    from rabit_tpu_torch.engine import native
    from rabit_tpu_torch.models import gbdt
    from rabit_tpu_torch.ops import boost, hist

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    took, t0 = {}, time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t0
        took[name] = round(time.perf_counter() - t0, 1)
        print(f"[{name}] took {took[name]} s", flush=True)
        t0 = time.perf_counter()

    try:
        native.build_lib()
        _build.build_all()
        lap("build")
        smoke = cs.Smoke(torch, boost, hist, gbdt, args.rows)
        lap("setup")
        if args.phases:
            for name in args.phases.split(","):
                if name == "dp":
                    smoke.dp_single()
                    smoke.dp_two_ranks()
                else:
                    print(f"[{name}] " + json.dumps(getattr(smoke, f"{name}_phase")()),
                          flush=True)
                lap(name)
        else:
            smoke.dp_single()
            smoke.dp_two_ranks()
            lap("dp")
            smoke.engine_phase()
            lap("engine")
            smoke.compress_phase()
            lap("compress")
            smoke.hybrid_phase()
            lap("hybrid")
            smoke.recover_phase()
            lap("recover")
            if hasattr(smoke, "diagnose_phase"):
                smoke.diagnose_phase()
                lap("diagnose")
    except cs.PhaseFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    phases = {k: v for k, v in took.items() if k not in ("build", "setup")}
    print(f"[phases] {os.path.basename(tree)} "
          + json.dumps({**took, "changed": round(sum(phases.values()), 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
