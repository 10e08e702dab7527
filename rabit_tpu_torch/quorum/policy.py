"""How many contributions make a round (pure arithmetic).

The port's own copy of ``rabit_tpu/quorum/policy.py``.  A ``rabit_quorum``
spec is a fraction in ``(0, 1]`` (``"0.75"``: three quarters of the current
world; ``"1.0"``: everyone, so the quorum machinery runs but never
excludes) or an integer count (``"6"``: six ranks, clamped into
``[1, world]``).  An integer literal is always a count: ``"1"`` is a
one-rank quorum, ``"1.0"`` all of them.  The empty spec turns quorum mode
off.  A fraction resolves against the current world, so K follows every
shrink and grow-back wave.
"""

from __future__ import annotations

import math


def parse_spec(spec: str) -> tuple[str, float]:
    """Validate a spec; returns ``("frac", f)`` or ``("count", n)``.
    Raises ValueError on anything else."""
    spec = (spec or "").strip()
    if not spec:
        raise ValueError("empty quorum spec (use '' to disable quorum mode)")
    try:
        n = int(spec)
    except ValueError:
        pass
    else:
        if n < 1:
            raise ValueError(f"rabit_quorum count must be >= 1, got {n}")
        return ("count", float(n))
    try:
        f = float(spec)
    except ValueError:
        raise ValueError(f"rabit_quorum={spec!r} is neither a count nor a fraction")
    if not 0.0 < f <= 1.0:
        raise ValueError(f"rabit_quorum fraction must be in (0, 1], got {f}")
    return ("frac", f)


def quorum_count(world: int, spec: str) -> int:
    """K for one world size.  The empty spec and ``"1.0"`` give the whole
    world; a count is clamped into ``[1, world]``."""
    world = int(world)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    spec = (spec or "").strip()
    if not spec:
        return world
    kind, value = parse_spec(spec)
    if kind == "count":
        return max(1, min(world, int(value)))
    return max(1, min(world, math.ceil(value * world)))
