#!/usr/bin/env python
"""Lazy-preparation demo on the PyTorch/CUDA port (the counterpart of
guide/lazy_allreduce.py): the prepare function fills the buffer right
before the reduction, and is skipped when the result is recovered from a
peer's replay buffer, which is why it exists.  Run on the mock engine so
failures can be injected (``rabit_engine=mock`` and the
``mock=rank,version,seqno,trial`` kill switch ride in as argv ``k=v``
params):

    python -m rabit_tpu_torch.tracker.launcher -n 4 --max-restarts 3 -- \\
        python guide/torch_lazy_allreduce.py rabit_engine=mock mock=0,0,0,0
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

    def prepare(arr):
        print(f"@node[{rank}] run prepare function")
        for i in range(n):
            arr[i] = rank + i

    print(f"@node[{rank}] before-allreduce: a={a}")
    a = rabit.allreduce(a, rabit.MAX, prepare_fun=prepare)
    print(f"@node[{rank}] after-allreduce-max: a={a}")
    a = rabit.allreduce(a, rabit.SUM)
    print(f"@node[{rank}] after-allreduce-sum: a={a}")
    rabit.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
