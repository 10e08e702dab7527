"""Solo (single-process) engine.

The port's copy of ``rabit_tpu/engine/empty.py``'s ``SoloEngine``: rank 0,
world size 1, every collective an identity, and versioned checkpoints in
memory, so single-process programs run the whole API with no
configuration.
"""

from __future__ import annotations

import numpy as np

from rabit_tpu_torch.engine.base import Engine, HostCheckpoints


class SoloEngine(HostCheckpoints, Engine):
    def __init__(self, config):
        Engine.__init__(self, config)
        HostCheckpoints.__init__(self)

    def get_rank(self) -> int:
        return 0

    def get_world_size(self) -> int:
        return 1

    def allreduce(self, data, op, prepare_fun=None, cache_key=None):
        if prepare_fun is not None:
            prepare_fun(data)
        return data

    def allreduce_fn(self, data, reduce_fn, prepare_fun=None, cache_key=None):
        if prepare_fun is not None:
            prepare_fun(data)
        return data

    def broadcast(self, data, root, cache_key=None):
        if root != 0:
            raise ValueError(f"broadcast root {root} out of range for world size 1")
        if data is None:
            raise ValueError("root must pass data to broadcast")
        return data

    def allgather(self, data: np.ndarray, cache_key=None) -> np.ndarray:
        return data
