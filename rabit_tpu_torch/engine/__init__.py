"""The port's engine registry: the backend is a config key,
``rabit_engine=auto|torch|empty|native|robust|base|mock``, resolved when
``api.init`` runs.

``auto`` takes the native fault-tolerant engine when a tracker address is
set (``rabit_tracker_uri``, which a launcher hands a worker as
``DMLC_TRACKER_URI``), as ``rabit_tpu``'s registry does; else the
torch.distributed engine when its bootstrap is given (any of
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` or their
``rabit_torch_*`` config keys); else the solo engine.  ``native``,
``robust``, ``base`` and ``mock`` are the native library's backends
(``engine.native``).
"""

from __future__ import annotations

from rabit_tpu_torch.config import Config
from rabit_tpu_torch.engine.base import Engine


def create_engine(config: Config) -> Engine:
    kind = config.get("rabit_engine", "auto")
    if kind == "auto":
        if config.get("rabit_tracker_uri", "NULL") not in ("NULL", ""):
            kind = "native"
        else:
            from rabit_tpu_torch.engine.torch_dist import bootstrap_settings

            kind = "torch" if any(bootstrap_settings(config)) else "empty"
    if kind == "empty":
        from rabit_tpu_torch.engine.empty import SoloEngine

        return SoloEngine(config)
    if kind == "torch":
        from rabit_tpu_torch.engine.torch_dist import TorchEngine

        return TorchEngine(config)
    from rabit_tpu_torch.engine.native import KINDS, NativeEngine

    if kind in KINDS:
        return NativeEngine(config, kind)
    raise ValueError(f"unknown rabit_engine {kind!r} (the port has torch, empty, "
                     f"{', '.join(KINDS)})")
