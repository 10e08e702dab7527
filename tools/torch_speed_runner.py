#!/usr/bin/env python
"""Sweep the native collective micro-benchmark over payload sizes and world
sizes on the PyTorch/CUDA port (the counterpart of tools/speed_runner.py):
``native/tests/speed_test.cc`` is built against the port's native library
(``engine.native.build_program``, into the port's build directory) and run
as local processes under the port's ``LocalCluster``, one JSON line per
(engine, world, size, op) with mean latency and MB/s.

    python tools/torch_speed_runner.py [--engines base,robust] [--workers 2,4,8] \\
        [--json-out RESULTS/torch_speed.jsonl]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from rabit_tpu_torch.engine.native import build_program  # noqa: E402
from rabit_tpu_torch.tracker.launcher import LocalCluster  # noqa: E402

SOURCE = REPO / "native" / "tests" / "speed_test.cc"

# "allreduce-max: mean=0.000123s sigma=1.2e-05 median=0.000119s bytes=40000
#  speed=325.20 MB/s" (the speed is the median's: robust to scheduler stalls
#  on an oversubscribed host)
_LINE = re.compile(
    r"(?P<op>[\w-]+)\s*: mean=(?P<mean>[\d.e+-]+)s sigma=(?P<sigma>[\d.e+-]+) "
    r"median=(?P<median>[\d.e+-]+)s "
    r"bytes=(?P<bytes>\d+) speed=(?P<mbps>[\d.e+-]+) MB/s"
)


def run(engine: str, nworkers: int, ndata: int, nrep: int, timeout: float = 600) -> list[dict]:
    """One speed test under the port's launcher; its parsed lines."""
    cluster = LocalCluster(nworkers, quiet=True)
    rc = cluster.run([str(build_program(SOURCE)), f"ndata={ndata}", f"nrep={nrep}",
                      f"rabit_engine={engine}"], timeout=timeout)
    if rc != 0:
        raise RuntimeError(f"speed test ({engine}, world {nworkers}) exited {rc}")
    records = []
    for msg in cluster.messages:
        m = _LINE.search(msg)
        if m:
            records.append({
                "engine": engine,
                "world": nworkers,
                "ndata": ndata,
                "op": m.group("op"),
                "mean_s": float(m.group("mean")),
                "sigma_s": float(m.group("sigma")),
                "median_s": float(m.group("median")),
                "bytes": int(m.group("bytes")),
                "mb_per_s": float(m.group("mbps")),
            })
    return records


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--engines", default="base,robust")
    ap.add_argument("--workers", default="2,4,8")
    ap.add_argument("--sizes", default="10000,100000,1000000,10000000")
    ap.add_argument("--nrep", type=int, default=10)
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)

    records = []
    for engine in args.engines.split(","):
        for nworkers in map(int, args.workers.split(",")):
            for ndata in map(int, args.sizes.split(",")):
                for rec in run(engine, nworkers, ndata, args.nrep):
                    records.append(rec)
                    print(json.dumps(rec), flush=True)
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
