"""Membership epochs: the elastic world's record of who is in the job.

The port's own copy of ``rabit_tpu/elastic/membership.py``.  The job's
composition is a rising **world epoch** ``(epoch, world_size, rank_map)``,
and a recovery wave may close at another world size than it opened:

* **promote**: a parked hot spare fills the dead rank's slot and the wave
  closes at the same size;
* **shrink**: no spare arrives within ``shrink_after_sec``, so the wave
  closes with the survivors, ranked densely;
* **grow**: the world is below its launch size and spares are parked, so
  the next wave (which workers enter at a version boundary) takes them
  back up to ``base_world``.

The module decides and records only (no sockets, threads or tracker
state): the tracker feeds it check-in counts and wave ages under its lock
and commits the waves it closes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

#: decide() actions.
WAIT = "wait"
CLOSE = "close"


@dataclass(frozen=True)
class WorldEpoch:
    """One committed membership generation; ``rank_map`` is the whole
    task-id -> rank assignment of the wave that opened it."""

    epoch: int
    world_size: int
    rank_map: Mapping[str, int] = field(default_factory=dict)


@dataclass(frozen=True)
class WaveDecision:
    """What to do with a pending wave now: ``action`` WAIT or CLOSE; on
    CLOSE, the ``world`` to close at, how many parked spares to promote
    into it first (``take_spares``), and ``resized`` = world - the previous
    world (negative: shrink, positive: grow)."""

    action: str
    world: int = 0
    take_spares: int = 0
    resized: int = 0


def rank_map_delta(prev: Mapping[str, int], new: Mapping[str, int]) -> dict:
    """The membership change between two epochs' rank maps:
    ``{"joined": {task: rank}, "left": {task: old_rank}, "moved": {task:
    [old_rank, new_rank]}}``."""
    return {"joined": {t: r for t, r in new.items() if t not in prev},
            "left": {t: r for t, r in prev.items() if t not in new},
            "moved": {t: [prev[t], r] for t, r in new.items()
                      if t in prev and prev[t] != r}}


class MembershipManager:
    """The world-epoch line of one job.  Not thread-safe by itself: the
    tracker calls it under its own lock.  ``base_world`` is the launch size
    and the grow-back target; ``current`` is the newest committed epoch
    (epoch -1, the launch size and an empty map before the first wave)."""

    def __init__(self, base_world: int, *, min_world: int = 1,
                 shrink_after_sec: float = 0.0, promote_after_sec: float = 0.25):
        if base_world < 1:
            raise ValueError(f"base_world must be >= 1, got {base_world}")
        self.base_world = int(base_world)
        self.min_world = max(int(min_world), 1)
        self.shrink_after_sec = float(shrink_after_sec)
        self.promote_after_sec = float(promote_after_sec)
        self.current = WorldEpoch(-1, self.base_world, {})
        #: committed epochs, oldest first (telemetry's resize timeline)
        self.history: list[WorldEpoch] = []

    @property
    def epoch(self) -> int:
        return self.current.epoch

    @property
    def world(self) -> int:
        return self.current.world_size

    def grow_wanted(self, n_spares: int) -> bool:
        """True when the world is below its launch size and parked spares
        could fill it: the flag of the epoch reply that makes workers
        re-enter a wave at their next version boundary."""
        return n_spares > 0 and self.world < self.base_world

    def restore(self, epoch: int, world_size: int, rank_map: Mapping[str, int],
                history: list[tuple[int, int]] | None = None) -> None:
        """Adopt a replayed epoch line (a standby's takeover, ``ha``): the
        promoted tracker continues the same rising numbering, since a
        reused epoch would let stale links and quorum records pass for
        fresh ones.  ``history`` rebuilds the timeline from ``(epoch,
        world)`` pairs (the journal keeps no rank map of a past epoch)."""
        self.current = WorldEpoch(int(epoch), int(world_size), dict(rank_map))
        self.history = [WorldEpoch(int(e), int(w), {}) for e, w in (history or [])]
        if self.history and self.history[-1].epoch == self.current.epoch:
            self.history[-1] = self.current  # the newest entry keeps its map

    def decide(self, n_pending: int, n_spares: int, wave_age: float) -> WaveDecision:
        """Close, promote and close, shrink and close, or wait, for a wave
        of ``n_pending`` live check-ins with ``n_spares`` parked spares,
        forming for ``wave_age`` seconds.  In order:

        1. grow back toward ``base_world`` when check-ins and spares exceed
           the current (shrunk) world;
        2. close when the wave is full;
        3. promote parked spares into the missing slots once the wave has
           been short for ``promote_after_sec`` (a live worker's own
           check-in wins its slot inside that grace);
        4. shrink to the survivors once ``shrink_after_sec`` passes with no
           spare (0 disables shrinking: the wave waits until it is full);
        5. else wait.
        """
        if n_pending <= 0:
            return WaveDecision(WAIT)
        target = self.world
        if self.world < self.base_world:
            reachable = min(self.base_world, n_pending + n_spares)
            if reachable > target:
                target = reachable
        if n_pending >= target:
            return WaveDecision(CLOSE, world=target, take_spares=0,
                                resized=target - self.world)
        missing = target - n_pending
        if n_spares > 0 and wave_age >= self.promote_after_sec:
            take = min(missing, n_spares)
            if n_pending + take >= target:
                return WaveDecision(CLOSE, world=target, take_spares=take,
                                    resized=target - self.world)
            # a partial fill: promote what there is, then the shrink clock
            # decides about the rest
            if (self.shrink_after_sec > 0 and wave_age >= self.shrink_after_sec
                    and n_pending + take >= self.min_world):
                return WaveDecision(CLOSE, world=n_pending + take, take_spares=take,
                                    resized=n_pending + take - self.world)
            return WaveDecision(WAIT)
        if (self.shrink_after_sec > 0 and wave_age >= self.shrink_after_sec
                and n_pending >= self.min_world):
            return WaveDecision(CLOSE, world=n_pending, resized=n_pending - self.world)
        return WaveDecision(WAIT)

    def commit(self, rank_map: Mapping[str, int],
               world_size: int) -> tuple[WorldEpoch, dict]:
        """Commit a closed wave as the next epoch; returns it and its
        ``rank_map_delta`` against the previous one.  Epoch numbers rise by
        one and are never reused: they stamp assignments and peer-link
        handshakes."""
        if sorted(rank_map.values()) != list(range(world_size)):
            raise ValueError(f"rank_map {dict(rank_map)!r} is not a dense assignment "
                             f"of world {world_size}")
        prev = self.current
        new = WorldEpoch(prev.epoch + 1, int(world_size), dict(rank_map))
        self.current = new
        self.history.append(new)
        return new, rank_map_delta(prev.rank_map, new.rank_map)
