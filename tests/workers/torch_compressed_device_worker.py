"""One rank of the compressed allreduce with the fused ring off.

    python torch_compressed_device_worker.py RANK WORLD STORE_FILE OUT_NPZ [DEVICE]

Joins a gloo group of WORLD processes through a FileStore, starts the
port's api on ``TorchEngine`` (which adopts the group) with
``rabit_fused_allreduce=0`` and ``rabit_torch_device=DEVICE`` (cpu, the
default, or cuda: the codec work on the card, the planes through host
memory) and writes this rank's results to OUT_NPZ:

* ``dev/<codec>/<op>``: ``api.allreduce(x, op, codec=...)`` of
  :func:`contribs` (1000 elements) for every codec with a device path and
  SUM, MAX and MIN; the engine's ``fused_active`` must say False and the
  numpy host transport (``compress.host_allreduce``, counted here) must not
  run: the codec work stays on the engine's device;
* ``fused_flags``: per codec, whether those calls counted wire bytes under
  ``fused=1`` (the streamed ``wire_bytes`` series; all False) and under
  ``fused=0`` (``unfused_counted``; all True);
* ``host/<codec>``: ``TorchEngine.allreduce_compressed`` with a codec that
  has no device path (the numpy codec of the same name), which takes the
  host transport, and ``host_calls``: how often it ran (2: once a codec).

tests/test_torch_compressed_device.py checks the results against both
packages' ``reference_allreduce``.  Imports torch, numpy and the port only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import api, compress, obs  # noqa: E402
from rabit_tpu_torch.compress import get_codec  # noqa: E402
from rabit_tpu_torch.engine.base import MAX, MIN, SUM  # noqa: E402
from rabit_tpu_torch.obs.stream import series_name  # noqa: E402

CODECS = ("bf16", "bf16x2", "i8", "i8x2")  # ("identity" forces the exact path)
OPS = {"sum": SUM, "max": MAX, "min": MIN}
N = 1000


def contribs(world: int, n: int = N, seed: int = 23) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 50).astype(np.float32) for _ in range(world)]


def host_only(name: str):
    """The codec ``name`` with its device path switched off."""
    c = get_codec(name)
    return type(f"HostOnly{type(c).__name__}", (type(c),), {"has_torch": False})()


def main() -> int:
    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    calls = []
    real = compress.host_allreduce

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    compress.host_allreduce = counted
    x = contribs(world)[rank]
    res = {}
    api.init(["rabit_engine=torch", f"rabit_torch_device={device}",
              "rabit_fused_allreduce=0"])
    try:
        engine = api.get_engine()
        for cname in CODECS:
            if engine.fused_active(get_codec(cname), SUM):
                raise AssertionError(f"fused_active for {cname} with the ring off")
            for oname, op in OPS.items():
                res[f"dev/{cname}/{oname}"] = api.allreduce(x, op, codec=cname)
        if calls:
            raise AssertionError(f"the host transport ran {len(calls)} times")
        reg = obs.get_registry()
        wire = {(c, f): reg.counter(series_name("wire_bytes", codec=c, fused=f)).value
                for c in CODECS for f in (0, 1)}
        res["fused_flags"] = np.array([wire[(c, 1)] > 0 for c in CODECS])
        res["unfused_counted"] = np.array([wire[(c, 0)] > 0 for c in CODECS])
        for cname in ("bf16", "i8"):
            res[f"host/{cname}"] = engine.allreduce_compressed(x, SUM, host_only(cname))
        res["host_calls"] = np.array(len(calls))
    finally:
        api.finalize()
        dist.destroy_process_group()
    np.savez(out, **res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
