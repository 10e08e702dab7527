"""The port's engine registry: the backend is a config key,
``rabit_engine=auto|torch|empty``, resolved when ``api.init`` runs.

``auto`` takes the torch.distributed engine when its bootstrap is given
(any of ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` or
their ``rabit_torch_*`` config keys), and the solo engine otherwise.
"""

from __future__ import annotations

from rabit_tpu_torch.config import Config
from rabit_tpu_torch.engine.base import Engine


def create_engine(config: Config) -> Engine:
    kind = config.get("rabit_engine", "auto")
    if kind == "auto":
        from rabit_tpu_torch.engine.torch_dist import bootstrap_settings

        kind = "torch" if any(bootstrap_settings(config)) else "empty"
    if kind == "empty":
        from rabit_tpu_torch.engine.empty import SoloEngine

        return SoloEngine(config)
    if kind == "torch":
        from rabit_tpu_torch.engine.torch_dist import TorchEngine

        return TorchEngine(config)
    raise ValueError(f"unknown rabit_engine {kind!r} (the port has torch and empty)")
