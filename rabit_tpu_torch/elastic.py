"""Dense row partition of a dataset across a world of ranks.

The port's own copy of ``rabit_tpu/elastic/rebalance.py``'s
``shard_bounds`` and ``shard_slice`` (the port imports nothing of the JAX
package): every row belongs to exactly one rank at every world size, and
two ranks' shards differ by at most one row.
"""

from __future__ import annotations


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
