"""Dense row partition of a dataset across a world of ranks, and the
rank-order fold.

The port's own copy of ``rabit_tpu/elastic/rebalance.py`` (the port imports
nothing of the JAX package).  When the world shrinks or grows back, every
rank re-cuts its shard from ``(n_rows, world, rank)`` alone: every row
belongs to exactly one rank at every world size, and two ranks' shards
differ by at most one row.  ``refold`` sums the ranks' contributions in
rank order, so an exact dtype (integer histograms) gives the same bits on
every rank and at every world size.
"""

from __future__ import annotations

import numpy as np


def shard_bounds(n_rows: int, world: int) -> list[tuple[int, int]]:
    """Dense contiguous ``[lo, hi)`` row ranges per rank.  The remainder
    rows go to the lowest ranks."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    base, rem = divmod(n_rows, world)
    bounds = []
    lo = 0
    for r in range(world):
        hi = lo + base + (1 if r < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def shard_slice(n_rows: int, world: int, rank: int) -> slice:
    """This rank's rows under the dense partition (a ``slice``, so callers
    can index numpy arrays without copying)."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside 0..{world - 1}")
    lo, hi = shard_bounds(n_rows, world)[rank]
    return slice(lo, hi)


def rebalance_plan(n_rows: int, old_world: int, new_world: int) -> dict:
    """The rows that change owners when the partition re-cuts from
    ``old_world`` to ``new_world`` ranks: per new rank the old ranks whose
    ranges overlap its new range (``sources``: ``(old_rank, lo, hi)``), and
    the rows that move (``moved_rows``)."""
    old = shard_bounds(n_rows, old_world)
    new = shard_bounds(n_rows, new_world)
    sources: dict[int, list[tuple[int, int, int]]] = {}
    moved = 0
    for nr, (nlo, nhi) in enumerate(new):
        parts = []
        for orank, (olo, ohi) in enumerate(old):
            lo, hi = max(nlo, olo), min(nhi, ohi)
            if lo < hi:
                parts.append((orank, lo, hi))
                if orank != nr:
                    moved += hi - lo
        sources[nr] = parts
    return {"moved_rows": moved, "sources": sources,
            "old_world": old_world, "new_world": new_world}


def refold(parts: list[np.ndarray]) -> np.ndarray:
    """Rank-order fold of per-rank contributions: rank 0 first, then 1,
    and so on."""
    if not parts:
        raise ValueError("refold needs at least one contribution")
    acc = np.array(parts[0], copy=True)
    for p in parts[1:]:
        acc = acc + p
    return acc
