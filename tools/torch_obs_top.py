"""Repo-root launcher for the port's rabit-top (``rabit_tpu_torch/obs/top.py``;
the counterpart of tools/obs_top.py).

Same CLI as ``python -m rabit_tpu_torch.obs.top``: a poll-based, curses-free
live view of a running tracker or service over the CMD_OBS scrape RPC:

  python tools/torch_obs_top.py HOST:PORT [--interval 2] [--job KEY]
                                [--once] [--json] [--registry]
"""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rabit_tpu_torch.obs.top import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
