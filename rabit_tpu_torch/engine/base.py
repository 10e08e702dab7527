"""Engine interface: the backend seam of the port's collectives.

The port's own copy of what it needs from ``rabit_tpu/engine/base.py`` (the
port imports nothing of the JAX package): the reduction op and dtype enums
of the reference C API, ``numpy_reduce`` (the elementwise meaning of each
op) and the ``Engine`` ABC that every backend implements and ``api``
dispatches to.  Buffers at this layer are numpy arrays or raw bytes.
"""

from __future__ import annotations

import socket
from abc import ABC, abstractmethod
from typing import Callable

import numpy as np

from rabit_tpu_torch.config import Config

# Reduction op enum, as the reference C API numbers them.
MAX = 0
MIN = 1
SUM = 2
BITOR = 3

_NUMPY_OPS: dict[int, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    MAX: np.maximum,
    MIN: np.minimum,
    SUM: np.add,
    BITOR: np.bitwise_or,
}

# dtype enum, as the reference C API numbers them.
DTYPE_ENUM = {
    np.dtype("int8"): 0,
    np.dtype("uint8"): 1,
    np.dtype("int32"): 2,
    np.dtype("uint32"): 3,
    np.dtype("int64"): 4,
    np.dtype("uint64"): 5,
    np.dtype("float32"): 6,
    np.dtype("float64"): 7,
}


def numpy_reduce(op: int, dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """Apply a builtin reduction op elementwise."""
    if op not in _NUMPY_OPS:
        raise ValueError(f"unknown reduction op {op}")
    return _NUMPY_OPS[op](dst, src)


class Engine(ABC):
    """Backend interface."""

    def __init__(self, config: Config):
        self.config = config

    def obs_event(self, kind: str, /, **fields):
        """Record a structured engine-layer event into the process flight
        recorder (``obs``), tagged with the backend class."""
        from rabit_tpu_torch import obs

        return obs.record_event(kind, engine=type(self).__name__, **fields)

    # -- lifecycle ---------------------------------------------------------

    def init(self) -> None:
        """Connect/bootstrap.  Called once by ``api.init``."""

    def shutdown(self) -> None:
        """Graceful teardown.  Called by ``api.finalize``."""

    def init_after_exception(self) -> None:
        """Recover engine state after the caller caught an exception (the
        reference's ``IEngine::InitAfterException``).  Only the native
        engine can."""
        raise RuntimeError(f"{type(self).__name__} cannot recover from exceptions")

    # -- topology ----------------------------------------------------------

    @abstractmethod
    def get_rank(self) -> int: ...

    @abstractmethod
    def get_world_size(self) -> int: ...

    def is_distributed(self) -> bool:
        return self.get_world_size() > 1

    def get_host(self) -> str:
        return socket.gethostname()

    def get_ring_prev_rank(self) -> int:
        """Rank of the ring predecessor."""
        world = self.get_world_size()
        return (self.get_rank() + world - 1) % world

    # -- collectives -------------------------------------------------------

    @abstractmethod
    def allreduce(self, data: np.ndarray, op: int,
                  prepare_fun: Callable[[np.ndarray], None] | None = None,
                  cache_key: str | None = None) -> np.ndarray:
        """Returns the reduced array (same shape and dtype as ``data``).
        ``prepare_fun`` fills ``data`` lazily, right before the reduction."""

    @abstractmethod
    def broadcast(self, data: bytes | None, root: int,
                  cache_key: str | None = None) -> bytes:
        """Broadcast a byte string from ``root`` to everyone."""

    @abstractmethod
    def allgather(self, data: np.ndarray,
                  cache_key: str | None = None) -> np.ndarray:
        """Equal-sized per-rank slices in, their concatenation over ranks
        (rank order) out."""

    def allreduce_compressed(self, data: np.ndarray, op: int, codec,
                             prepare_fun: Callable[[np.ndarray], None] | None = None,
                             cache_key: str | None = None) -> np.ndarray:
        """Allreduce with a wire codec (``rabit_tpu_torch.compress``): each
        rank's contribution crosses the engine encoded; every rank decodes
        and folds the gathered planes identically, so the result is bitwise
        identical on all ranks and equals ``reference_allreduce``.

        Default: the numpy host transport over this engine's own
        ``allgather`` (plus a tiny size-agreement allreduce when the
        deflate stage, ``rabit_compress_wire_deflate``, makes wire sizes
        data-dependent).  ``TorchEngine`` overrides it with the codec work
        on its device (the fused ring, or with ``rabit_fused_allreduce=0``
        one all_gather of the encoded planes).  ``prepare_fun`` runs
        eagerly: its output feeds the encoder."""
        from rabit_tpu_torch import compress

        if prepare_fun is not None:
            prepare_fun(data)
        return compress.host_allreduce(self, np.ascontiguousarray(data), op, codec,
                                       cache_key=cache_key,
                                       deflate=compress.policy().wire_deflate)

    def fused_active(self, codec, op) -> bool:
        """True when ``allreduce_compressed(codec, op)`` runs the fused
        ring on the device (``engine.fused``) rather than the unfused device
        path or the host transport.  Only ``TorchEngine`` says so."""
        return False

    # -- custom reduction --------------------------------------------------

    def allreduce_fn(self, data: np.ndarray,
                     reduce_fn: Callable[[np.ndarray, np.ndarray], np.ndarray],
                     prepare_fun: Callable[[np.ndarray], None] | None = None,
                     cache_key: str | None = None) -> np.ndarray:
        """Allreduce with a user reduction ``reduce_fn(acc, part) -> acc``
        (the reference's Reducer): gather every rank's slice, then fold
        them in rank order, so every rank computes the same result."""
        if prepare_fun is not None:
            prepare_fun(data)
        flat = np.ascontiguousarray(data).reshape(-1)
        gathered = self.allgather(flat, cache_key=cache_key)
        world = self.get_world_size()
        parts = gathered.reshape(world, *data.shape)
        acc = np.array(parts[0], copy=True)
        for i in range(1, world):
            acc = reduce_fn(acc, parts[i])
        return acc.astype(data.dtype).reshape(data.shape)

    # -- checkpoint / recovery --------------------------------------------

    @abstractmethod
    def load_checkpoint(self) -> tuple[int, bytes | None, bytes | None]:
        """(version, global_blob, local_blob); version 0: none yet."""

    @abstractmethod
    def checkpoint(self, global_blob: bytes, local_blob: bytes | None = None) -> None:
        """Commit an iteration: store the blobs, bump the version."""

    def lazy_checkpoint(self, get_global_blob: Callable[[], bytes]) -> None:
        """Defer serialization until the blob is asked for.  Default: eager."""
        self.checkpoint(get_global_blob())

    @abstractmethod
    def version_number(self) -> int: ...

    # -- observability -----------------------------------------------------

    def tracker_print(self, msg: str) -> None:
        print(msg, end="" if msg.endswith("\n") else "\n", flush=True)


class ShutdownSignal(Exception):
    """Raised internally when the tracker orders shutdown."""


class HostCheckpoints:
    """Versioned checkpoints kept in this process's memory: what the solo
    and torch.distributed engines do in place of the robust engine's
    peer-replicated copies."""

    def __init__(self):
        self._version = 0
        self._global_blob: bytes | None = None
        self._local_blob: bytes | None = None
        self._lazy_thunk: Callable[[], bytes] | None = None

    def load_checkpoint(self):
        if self._global_blob is None and self._lazy_thunk is not None:
            self._global_blob = bytes(self._lazy_thunk())
        return self._version, self._global_blob, self._local_blob

    def checkpoint(self, global_blob: bytes, local_blob: bytes | None = None) -> None:
        self._global_blob = bytes(global_blob)
        self._local_blob = None if local_blob is None else bytes(local_blob)
        self._lazy_thunk = None
        self._version += 1

    def lazy_checkpoint(self, get_global_blob: Callable[[], bytes]) -> None:
        # A lazy checkpoint carries no local model (reference contract).
        self._lazy_thunk = get_global_blob
        self._global_blob = None
        self._local_blob = None
        self._version += 1

    def version_number(self) -> int:
        return self._version
