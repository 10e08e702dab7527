"""Layered ``key=value`` configuration of the port's engine layer.

The port's own copy of what it needs from ``rabit_tpu/config.py`` (the port
imports nothing of the JAX package): built-in defaults, then ``RABIT_TPU_*``
environment variables, then argv ``k=v`` pairs in order (the last one
wins), then keyword overrides.
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping

DEFAULTS: dict[str, str] = {
    "rabit_engine": "auto",         # auto | torch | empty
    # TorchEngine: "cuda" stages arrays on the card and uses NCCL, "cpu"
    # uses gloo.  The torch.distributed bootstrap falls back to the
    # standard MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK variables
    # where these are empty.
    "rabit_torch_device": "cuda",
    "rabit_torch_master_addr": "",
    "rabit_torch_master_port": "",
    "rabit_torch_world_size": "",
    "rabit_torch_rank": "",
}


class Config:
    """Merged configuration with typed accessors."""

    def __init__(self, args: Iterable[str] | None = None,
                 overrides: Mapping[str, str] | None = None):
        self._cfg = dict(DEFAULTS)
        for name, val in os.environ.items():
            if name.startswith("RABIT_TPU_"):
                self._cfg[name[len("RABIT_TPU_"):].lower()] = val
        for arg in args or []:
            if "=" in arg:
                key, val = arg.split("=", 1)
                self._cfg[key] = val
        for key, val in (overrides or {}).items():
            self._cfg[key] = str(val)

    def get(self, key: str, default: str | None = None) -> str | None:
        return self._cfg.get(key, default)
