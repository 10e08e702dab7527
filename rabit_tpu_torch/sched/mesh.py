"""Mesh model: the planner's picture of the interconnect.

The port's own copy of ``rabit_tpu/sched/mesh.py``: ranks are placed
**row-major** on a ``rows x cols`` grid (a torus when ``wrap``), the link
cost between two ranks is the Manhattan distance between their placements
(with per-axis wraparound on a torus), and the dims come from an explicit
``"RxC"`` spec (``rabit_sched_mesh``) or a near-square factorization of the
world size, so the planner always has some model to plan against (a
1 x W mesh plans every ring as the identity ring).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshModel:
    """A ``rows x cols`` grid (torus when ``wrap``) holding ``world``
    ranks row-major.  ``rows * cols >= world``; trailing cells of the
    last row may be empty (non-rectangular worlds)."""

    world: int
    rows: int
    cols: int
    wrap: bool = True

    def __post_init__(self):
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {self.world}")
        if self.rows < 1 or self.cols < 1:
            raise ValueError(f"bad mesh dims {self.rows}x{self.cols}")
        if self.rows * self.cols < self.world:
            raise ValueError(
                f"mesh {self.rows}x{self.cols} too small for world "
                f"{self.world}")

    def coords(self, rank: int) -> tuple[int, int]:
        """(row, col) of ``rank`` under the row-major placement."""
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside 0..{self.world - 1}")
        return divmod(rank, self.cols)

    def _axis_dist(self, a: int, b: int, extent: int) -> int:
        d = abs(a - b)
        return min(d, extent - d) if self.wrap and extent > 1 else d

    def hops(self, a: int, b: int) -> int:
        """Link hop distance between two ranks' placements (0 for a==b)."""
        (ra, ca), (rb, cb) = self.coords(a), self.coords(b)
        return (self._axis_dist(ra, rb, self.rows)
                + self._axis_dist(ca, cb, self.cols))


def auto_dims(world: int) -> tuple[int, int]:
    """Near-square ``rows x cols`` with ``rows * cols == world`` — rows is
    the largest divisor of ``world`` not exceeding sqrt(world) (primes
    degrade to 1 x W, where every planned ring equals the identity ring)."""
    rows = 1
    for r in range(int(math.isqrt(world)), 0, -1):
        if world % r == 0:
            rows = r
            break
    return rows, world // rows


def parse_mesh_spec(spec: str) -> tuple[int, int, bool] | None:
    """Parse a ``rabit_sched_mesh`` value: ``"RxC"`` (torus) or
    ``"RxC:nowrap"`` (open grid).  Empty/whitespace -> None (auto dims).
    Malformed specs raise — a typo'd topology must not silently plan
    against the wrong machine."""
    spec = (spec or "").strip().lower()
    if not spec:
        return None
    wrap = True
    if spec.endswith(":nowrap"):
        wrap = False
        spec = spec[: -len(":nowrap")]
    try:
        rows_s, cols_s = spec.split("x", 1)
        rows, cols = int(rows_s), int(cols_s)
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r} (want 'RxC[:nowrap]')")
    if rows < 1 or cols < 1:
        raise ValueError(f"bad mesh spec {spec!r} (dims must be >= 1)")
    return rows, cols, wrap


def mesh_for_world(world: int, spec: str = "") -> MeshModel:
    """The planner's mesh for ``world`` ranks: explicit dims from
    ``spec`` when given (and large enough), else the near-square auto
    factorization."""
    parsed = parse_mesh_spec(spec)
    if parsed is not None:
        rows, cols, wrap = parsed
        if rows * cols >= world:
            return MeshModel(world, rows, cols, wrap)
        # an explicit spec the CURRENT world outgrew (elastic grow past
        # the configured slice): fall back to auto dims rather than fail
        # a recovery wave over a stale operator hint
    rows, cols = auto_dims(world)
    return MeshModel(world, rows, cols, True)
