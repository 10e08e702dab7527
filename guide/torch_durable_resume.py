#!/usr/bin/env python
"""Durable-spill demo on the PyTorch/CUDA port (the counterpart of
guide/durable_resume.py): surviving a whole-job preemption.

Peer recovery covers single worker deaths: peers hold the state in memory.
A preemption that kills every worker at once needs
``rabit_checkpoint_dir=<path>``: each committed checkpoint also lands on
disk (CRC-checked, atomic, the newest versions kept), and a fresh cluster
resumes from the newest version every rank can serve instead of training
from zero.

Run twice with the same directory and watch the second run skip the rounds
already trained:

    python -m rabit_tpu_torch.tracker.launcher -n 2 -- \\
        python guide/torch_durable_resume.py rabit_engine=robust \\
        rabit_checkpoint_dir=/tmp/durable_demo
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rabit_tpu_torch as rabit  # noqa: E402

NITER = 4


def main(argv: list[str] | None = None) -> int:
    rabit.init(argv)
    rank = rabit.get_rank()

    version, model = rabit.load_checkpoint()
    if version == 0:
        model = {"weights": np.zeros(4), "rounds_done": 0}
        print(f"@node[{rank}] fresh start")
    else:
        # On a re-run this prints at once at version NITER: the state came
        # off the durable spill, not from surviving peers.
        print(f"@node[{rank}] resumed from disk at version {version}: {model}")

    for it in range(version, NITER):
        grad = np.full(4, float(rank + it))
        grad = rabit.allreduce(grad, rabit.SUM)
        model = {
            "weights": model["weights"] + grad,
            "rounds_done": model["rounds_done"] + 1,
        }
        rabit.checkpoint(model)
        print(f"@node[{rank}] round {it} done, weights={model['weights']}")

    assert model["rounds_done"] == NITER, model
    rabit.tracker_print(f"[{rank}] final weights {model['weights']}\n")
    rabit.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
