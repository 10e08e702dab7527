#!/usr/bin/env python
"""Basic allreduce demo on the PyTorch/CUDA port (the counterpart of
guide/basic.py): every rank fills a vector with rank+i, then MAX- and
SUM-allreduces it.

Run standalone (solo mode) or under the port's local tracker:
    python -m rabit_tpu_torch.tracker.launcher -n 4 -- python guide/torch_basic.py rabit_engine=robust
"""
import os
import sys

import numpy as np

# for a normal run without the tracker script, make the repo importable
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rabit_tpu_torch as rabit  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    rabit.init(argv)
    n = 3
    rank = rabit.get_rank()
    a = np.zeros(n)
    for i in range(n):
        a[i] = rank + i

    print(f"@node[{rank}] before-allreduce: a={a}")
    a = rabit.allreduce(a, rabit.MAX)
    print(f"@node[{rank}] after-allreduce-max: a={a}")
    a = rabit.allreduce(a, rabit.SUM)
    print(f"@node[{rank}] after-allreduce-sum: a={a}")
    rabit.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
