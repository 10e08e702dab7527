"""LazyAllreduce: host-side fusion of small reductions.

The port's own copy of ``rabit_tpu/fusion.py``.  Instead of paying one
collective per small buffer, pending reductions are queued and flushed as
ONE allreduce per (dtype, op, codec) group, through
``rabit_tpu_torch.api.allreduce`` by default: on ``TorchEngine`` a
compressed group's flush is one fused quantized ring (``engine.fused``),
an exact one one ``all_reduce``.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable

import numpy as np

from rabit_tpu_torch.engine.base import SUM


class _Handle:
    """Future-like handle for one queued buffer."""

    __slots__ = ("_result",)

    def __init__(self) -> None:
        self._result: np.ndarray | None = None

    def get(self) -> np.ndarray:
        if self._result is None:
            raise RuntimeError("LazyAllreduce handle read before flush()")
        return self._result


class LazyAllreduce:
    """Queue buffers with ``add``; ``flush`` runs one fused allreduce per
    (dtype, op, codec) group and resolves every handle.

    Determinism: groups flush in first-queued order, so as long as every
    rank queues the same logical sequence of (dtype, op, codec) buffers
    (what plain collectives already require), every rank issues identical
    fused collectives in identical order.

    ``add(..., codec=...)`` tags a buffer with a ``rabit_tpu_torch.compress``
    codec: same-codec buffers fuse into one compressed collective, and
    ``codec=None`` buffers still pick up the ``rabit_compress_allreduce``
    policy at flush time exactly like a direct ``api.allreduce`` call.  A
    custom ``allreduce_fn`` without a ``codec`` parameter gets the fused
    buffers exact (the codec still partitions the groups).
    """

    def __init__(self, allreduce_fn: Callable[..., np.ndarray] | None = None):
        if allreduce_fn is None:
            from rabit_tpu_torch import api

            allreduce_fn = lambda buf, op, codec=None: api.allreduce(
                buf, op, codec=codec)
        self._allreduce = allreduce_fn
        try:
            self._takes_codec = "codec" in inspect.signature(
                allreduce_fn).parameters
        except (TypeError, ValueError):
            self._takes_codec = False
        self._pending: list[tuple[np.ndarray, int, str | None, _Handle]] = []

    def add(self, data: np.ndarray, op: int = SUM,
            codec: str | None = None) -> _Handle:
        handle = _Handle()
        self._pending.append((np.ascontiguousarray(data), op, codec, handle))
        return handle

    def __len__(self) -> int:
        return len(self._pending)

    def flush(self) -> None:
        groups: dict[tuple[Any, int, str | None],
                     list[tuple[np.ndarray, _Handle]]] = {}
        for arr, op, codec, handle in self._pending:
            groups.setdefault((arr.dtype, op, codec), []).append((arr, handle))
        self._pending.clear()
        for (dtype, op, codec), items in groups.items():
            flats = [a.reshape(-1) for a, _ in items]
            fused = np.concatenate(flats) if len(flats) > 1 else flats[0].copy()
            if self._takes_codec:
                reduced = np.asarray(self._allreduce(fused, op, codec=codec))
            else:
                reduced = np.asarray(self._allreduce(fused, op))
            offset = 0
            for arr, handle in items:
                handle._result = (
                    reduced[offset: offset + arr.size].reshape(arr.shape).astype(dtype)
                )
                offset += arr.size
