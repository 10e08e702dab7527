#!/usr/bin/env python
"""Broadcast demo on the PyTorch/CUDA port (the counterpart of
guide/broadcast.py): rank 0 broadcasts an arbitrary picklable object to
everyone.

Run under the port's local tracker:
    python -m rabit_tpu_torch.tracker.launcher -n 4 -- python guide/torch_broadcast.py rabit_engine=robust
"""
import os
import sys

# for a normal run without the tracker script, make the repo importable
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rabit_tpu_torch as rabit  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    rabit.init(argv)
    rank = rabit.get_rank()
    s = None
    if rank == 0:
        s = {"hello world": 100, 2: 3}
    print(f'@node[{rank}] before-broadcast: s="{s}"')
    s = rabit.broadcast(s, 0)
    print(f'@node[{rank}] after-broadcast: s="{s}"')
    rabit.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
