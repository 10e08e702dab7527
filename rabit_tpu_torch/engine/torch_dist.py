"""torch.distributed engine: the port's counterpart of ``rabit_tpu/engine/xla.py``.

Rank and world are those of torch.distributed's default process group; the
collectives are its collectives.  With ``rabit_torch_device=cuda`` (the
default) arrays are staged on this rank's card and cross NCCL; with
``cpu`` they stay on the host and cross gloo.  ``init`` bootstraps the
default group from ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK`` (or the ``rabit_torch_*`` config keys, which win) over TCP, or
adopts a group the program has already made; with none of them set the
engine runs solo.

Exactness.  Every dtype of ``DTYPE_ENUM`` under every op gives the bits
``numpy_reduce`` gives where the op does not depend on the order of its
operands (integers under any op, floats under MAX and MIN); a float SUM is
the backend's sum, the same on every rank.  Neither backend has a bitwise
OR, and neither takes unsigned 32- or 64-bit integers, so:

* BITOR is lowered to MAX over bit planes (``np.unpackbits``: one byte a
  bit, 0 or 1), as ``rabit_tpu/engine/xla.py`` lowers it, on both
  backends, so both give the same bits;
* uint32 and uint64 cross as int32 and int64 of the same bits: a SUM
  wraps modulo 2**32 (2**64) in either reading, and for MAX and MIN the
  sign bit is flipped first, which maps unsigned order onto signed order.

Compressed allreduce (``allreduce_compressed``) of a float32 payload
under SUM, MAX or MIN, with a codec that has a device path, on more than
one rank: with ``rabit_fused_allreduce`` on (the default), the fused
quantized ring of ``engine.fused`` along the planned ring order, built once
per (op, codec, element count); with it off, ``rabit_tpu``'s unfused device
path (``XlaEngine._compressed_fns``): the codec's encode, one
``all_gather`` of the encoded uint8 planes over the default group, and the
rank-order decode-fold as separate eager ops.  Either way the codec work
runs on this rank's card with ``rabit_torch_device=cuda`` (on the host
with ``cpu``), and the bytes cross the default group (through host memory
where that group is gloo).  Any other payload, codec or op, and world 1,
take the numpy host transport of the base class, as in ``rabit_tpu``.  The
result equals ``compress.reference_allreduce`` of the ranks'
contributions bit for bit.

Checkpoints stay in host memory, one copy a process (recovery of a lost
process is the robust engine's work, which this one does not do).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from rabit_tpu_torch.engine.base import (BITOR, DTYPE_ENUM, MAX, MIN, SUM, Engine,
                                         HostCheckpoints)
from rabit_tpu_torch.engine import fused

_TORCH_OP = {MAX: dist.ReduceOp.MAX, MIN: dist.ReduceOp.MIN, SUM: dist.ReduceOp.SUM}
# unsigned dtypes the backends lack -> (the signed dtype of the same bits,
# its sign bit)
_SIGNED = {np.dtype("uint32"): (np.dtype("int32"), np.int32(-2 ** 31)),
           np.dtype("uint64"): (np.dtype("int64"), np.int64(-2 ** 63))}
_ENV = {"rabit_torch_master_addr": "MASTER_ADDR", "rabit_torch_master_port": "MASTER_PORT",
        "rabit_torch_world_size": "WORLD_SIZE", "rabit_torch_rank": "RANK"}


def bootstrap_settings(config) -> tuple[str, str, str, str]:
    """(address, port, world size, rank) of the torch.distributed bootstrap,
    each from its config key or else its environment variable ("" when
    neither is set)."""
    return tuple(config.get(key, "") or os.environ.get(env, "")
                 for key, env in _ENV.items())


class TorchEngine(HostCheckpoints, Engine):
    def __init__(self, config):
        Engine.__init__(self, config)
        HostCheckpoints.__init__(self)
        self._device = torch.device(config.torch_device)
        if self._device.type not in ("cuda", "cpu"):
            raise ValueError(f"rabit_torch_device={self._device}: the engine stages "
                             "arrays on cuda or cpu")
        self._owns_group = False
        self._rank, self._world = 0, 1
        self._stage = None  # where arrays cross the group (None: solo)
        # the fused rings, per (op, codec, element count), and their ring
        # order; rabit_fused_allreduce and rabit_fused_chunk_kib
        self._fused: dict[tuple, object] = {}
        self._fused_order: tuple[int, ...] | None = None
        self._fused_on = fused.fused_mode(config)
        self._fused_chunk = fused.chunk_bytes_from_config(config)

    # -- lifecycle -----------------------------------------------------------

    def init(self) -> None:
        if self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("rabit_torch_device=cuda but no CUDA device is "
                               "available; pass rabit_torch_device=cpu for gloo")
        settings = bootstrap_settings(self.config)
        if any(settings) and not all(settings):
            # A half-set bootstrap must fail loudly: skipping it would leave
            # this process at world 1 while its peers wait for it.
            addr, port, world, rank = settings
            raise RuntimeError(
                f"incomplete torch.distributed settings: address={addr!r} "
                f"port={port!r} world_size={world!r} rank={rank!r}; set all of "
                "MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK (or the "
                "rabit_torch_* config keys), or none")
        if all(settings) and not dist.is_initialized():
            addr, port, world, rank = settings
            backend = "nccl" if self._device.type == "cuda" else "gloo"
            if backend == "nccl":
                torch.cuda.set_device(self._card(int(rank)))
            dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                    world_size=int(world), rank=int(rank))
            self._owns_group = True
        self.rebuild()

    def shutdown(self) -> None:
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False
        self.rebuild()

    def rebuild(self) -> None:
        """Adopt the current world: re-read rank and world from the default
        process group (none: solo) and drop what was derived from the old
        one (the staging device, which follows the rank and the backend,
        and the fused rings with their ring order, built for the old
        world).  The counterpart of XlaEngine.rebuild_mesh; checkpoints are
        kept."""
        self._stage = None
        self._fused.clear()
        self._fused_order = None
        if dist.is_available() and dist.is_initialized():
            self._rank, self._world = dist.get_rank(), dist.get_world_size()
            self._stage = (torch.device("cuda", self._card(self._rank))
                           if dist.get_backend() == "nccl" else torch.device("cpu"))
        else:
            self._rank, self._world = 0, 1

    def _card(self, rank: int) -> int:
        """This rank's card: the one asked for, else one a rank in turn."""
        if self._device.index is not None:
            return self._device.index
        return rank % torch.cuda.device_count()

    def get_rank(self) -> int:
        return self._rank

    def get_world_size(self) -> int:
        return self._world

    # -- collectives ---------------------------------------------------------

    def _all_reduce(self, arr: np.ndarray, op) -> np.ndarray:
        t = torch.from_numpy(np.array(arr, copy=True)).to(self._stage)
        dist.all_reduce(t, op=op)
        return t.cpu().numpy()

    def allreduce(self, data, op, prepare_fun=None, cache_key=None):
        if prepare_fun is not None:
            prepare_fun(data)
        arr = np.ascontiguousarray(data)
        if arr.dtype not in DTYPE_ENUM:
            raise TypeError(f"dtype {arr.dtype} not supported")
        if op not in (MAX, MIN, SUM, BITOR):
            raise ValueError(f"unknown reduction op {op}")
        if op == BITOR and arr.dtype.kind == "f":
            raise TypeError(f"BITOR of {arr.dtype}")
        if self._stage is None:
            return data
        if op == BITOR:
            planes = self._all_reduce(np.unpackbits(arr.reshape(-1).view(np.uint8)),
                                      dist.ReduceOp.MAX)
            return np.packbits(planes).view(arr.dtype).reshape(arr.shape)
        if arr.dtype in _SIGNED:
            signed, sign = _SIGNED[arr.dtype]
            flip = sign if op != SUM else signed.type(0)
            out = self._all_reduce(arr.view(signed) ^ flip, _TORCH_OP[op]) ^ flip
            return out.view(arr.dtype).reshape(arr.shape)
        return self._all_reduce(arr, _TORCH_OP[op]).reshape(arr.shape)

    def fused_active(self, codec, op) -> bool:
        """True when allreduce_compressed takes the fused ring for this
        (codec, op): ``rabit_fused_allreduce`` on, more than one rank, a
        codec with a device path and an op the fold covers."""
        return (self._fused_on and self._world > 1 and codec.has_torch
                and op in fused.FUSED_OPS)

    def _fused_fn(self, op: int, codec, n: int):
        key = (op, codec.name, n)
        if key not in self._fused:
            if self._fused_order is None:
                self._fused_order = fused.plan_ring_order(self._world, self.config)
            device = (torch.device("cuda", self._card(self._rank))
                      if self._device.type == "cuda" else torch.device("cpu"))
            self._fused[key] = fused.build_fused_allreduce(
                None, self._fused_order, op, codec, n,
                chunk_bytes=self._fused_chunk, device=device)
        return self._fused[key]

    def _codec_device(self) -> torch.device:
        """Where the codec work of a compressed allreduce runs."""
        if self._device.type == "cuda":
            return torch.device("cuda", self._card(self._rank))
        return torch.device("cpu")

    def _gathered_fold(self, x: torch.Tensor, op: int, codec) -> torch.Tensor:
        """The unfused device path: encode, one all_gather of the encoded
        planes, and the rank-order decode-fold, each an eager op, so no
        fold contracts into another."""
        n = x.numel()
        wire = codec.torch_encode(x.to(self._codec_device()))
        mine = wire.to(self._stage)
        parts = [torch.empty_like(mine) for _ in range(self._world)]
        dist.all_gather(parts, mine)
        fold = fused.fold_fn(op)
        acc = None
        for part in parts:
            dec = codec.torch_decode(part.to(wire.device), n)
            acc = dec if acc is None else fold(acc, dec)
        return acc

    def allreduce_compressed(self, data, op, codec, prepare_fun=None, cache_key=None):
        if prepare_fun is not None:
            prepare_fun(data)
        arr = np.ascontiguousarray(data)
        if (self._world == 1 or not codec.has_torch or arr.dtype != np.float32
                or op not in fused.FUSED_OPS):
            return super().allreduce_compressed(arr, op, codec, cache_key=cache_key)
        from rabit_tpu_torch.compress import observe

        on_ring = self._fused_on  # the guard above covered the rest of fused_active
        t0 = time.perf_counter()
        x = torch.from_numpy(arr.reshape(-1))
        if on_ring:
            out = self._fused_fn(op, codec, arr.size)(x)
        else:
            out = self._gathered_fold(x, op, codec)
        result = out.cpu().numpy().reshape(arr.shape)
        observe(self, codec.name, raw=arr.nbytes, wire=codec.wire_len(arr.size),
                encode_s=time.perf_counter() - t0, fused=on_ring)
        return result

    def broadcast(self, data, root, cache_key=None):
        if not 0 <= root < self._world:
            raise ValueError(f"broadcast root {root} out of range for world size "
                             f"{self._world}")
        is_root = self._rank == root
        if is_root and data is None:
            raise ValueError("root must pass data to broadcast")
        if self._stage is None:
            return data
        # Length, then payload, as the reference binding does.
        n = torch.tensor([len(data) if is_root else 0], dtype=torch.int64,
                         device=self._stage)
        dist.broadcast(n, src=root)
        size = int(n.item())
        if size == 0:
            return b""
        if is_root:
            buf = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(self._stage)
        else:
            buf = torch.empty(size, dtype=torch.uint8, device=self._stage)
        dist.broadcast(buf, src=root)
        return bytes(data) if is_root else buf.cpu().numpy().tobytes()

    def allgather(self, data, cache_key=None):
        if self._stage is None:
            return data
        arr = np.ascontiguousarray(data).reshape(-1)
        t = torch.from_numpy(arr.view(np.uint8).copy()).to(self._stage)
        parts = [torch.empty_like(t) for _ in range(self._world)]
        dist.all_gather(parts, t)
        return np.concatenate([p.cpu().numpy() for p in parts]).view(arr.dtype)
