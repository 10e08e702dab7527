"""Worker-side shipping to the tracker: metric snapshots and heartbeat
leases.

The port's own copy of ``rabit_tpu/obs/ship.py``.  A worker ships its
registry snapshot as a ``CMD_METRICS`` message (a JSON string, framed like
a print): at finalize always, and every ``rabit_obs_heartbeat_sec`` when
that is set.  The tracker keeps the newest snapshot a rank and writes them
into telemetry.json.

With ``rabit_heartbeat_sec`` > 0 a second periodic sender renews a
``CMD_HEARTBEAT`` lease: the tracker suspects a worker whose lease lapses
for ``LEASE_FACTOR`` intervals, the failure detector for deaths that leave
no exit code and no TCP error (a frozen process, a preempted VM).

Everything rides ``tracker.protocol.tracker_rpc`` and is best-effort: a
dead tracker or a refused connection is swallowed (a missed renewal is
healed by the next tick; the lease tolerates one).  Nothing here touches a
tensor or the card, so the sender threads run beside a CUDA main thread
without waiting on it.
"""

from __future__ import annotations

import json
import threading
from typing import Callable

from rabit_tpu_torch.obs.trace import GLOBAL_CLOCK
from rabit_tpu_torch.tracker import protocol as P

#: Current snapshot envelope version (bump on incompatible change).
SNAPSHOT_SCHEMA = 1


def _note_clock(reply: object) -> None:
    """Fold a timestamped ACK into the process clock estimate."""
    if isinstance(reply, P.TimedAck):
        GLOBAL_CLOCK.update(reply.offset, reply.err)


def build_snapshot(registry, rank: int, task_id: str, host: str = "",
                   extra: dict | None = None) -> dict:
    """The JSON envelope a worker ships: identity + full registry state."""
    snap = {
        "schema": SNAPSHOT_SCHEMA,
        "rank": rank,
        "task_id": task_id,
        "host": host,
        "metrics": registry.snapshot(),
    }
    if extra:
        snap.update(extra)
    return snap


def ship_snapshot(snapshot: dict, tracker_host: str, tracker_port: int,
                  task_id: str, timeout: float = 5.0, retries: int = 0,
                  addrs: list | None = None) -> bool:
    """Send one snapshot; True on ACK.  Raises nothing.  ``addrs`` is the
    failover list (``rabit_tracker_addrs``)."""
    try:
        reply = P.tracker_rpc(tracker_host, tracker_port, P.CMD_METRICS, task_id,
                              message=json.dumps(snapshot), timeout=timeout,
                              retries=retries, addrs=addrs)
    except (P.TrackerUnreachable, ValueError):
        return False
    _note_clock(reply)
    return reply == P.ACK


def renew_lease(tracker_host: str, tracker_port: int, task_id: str,
                interval: float, rank: int = -1,
                timeout: float | None = None, addrs: list | None = None) -> bool:
    """Renew this worker's heartbeat lease; True on ACK.  Raises nothing.

    No retries: a renewal that misses its window is worthless, the next
    tick is the retry, and the tracker's lease tolerates one miss
    (``LEASE_FACTOR``).  The send is bounded by ``timeout`` (default: one
    interval) so a wedged tracker cannot back the sender up.  With an
    ``addrs`` failover list one retry is allowed: the rotation lands it on
    the standby, so a lease taken over is renewed within the same tick."""
    try:
        reply = P.tracker_rpc(tracker_host, tracker_port, P.CMD_HEARTBEAT, task_id,
                              prev_rank=rank, message=repr(float(interval)),
                              timeout=timeout if timeout is not None else max(interval, 0.2),
                              retries=1 if addrs else 0, addrs=addrs)
    except (P.TrackerUnreachable, ValueError):
        return False
    _note_clock(reply)
    return reply == P.ACK


def clock_ping(tracker_host: str, tracker_port: int, task_id: str,
               samples: int = 2, timeout: float = 2.0, addrs: list | None = None) -> int:
    """Collect clock-offset samples with no other effect: a heartbeat of
    interval 0 grants no lease, but its reply carries the tracker's clock.
    Used at finalize, so a job that never renewed leases still ships a
    clock estimate.  Returns how many samples landed; raises nothing."""
    got = 0
    for _ in range(max(samples, 0)):
        try:
            reply = P.tracker_rpc(tracker_host, tracker_port, P.CMD_HEARTBEAT, task_id,
                                  message="0", timeout=timeout, retries=0, addrs=addrs)
        except (P.TrackerUnreachable, ValueError):
            return got
        _note_clock(reply)
        got += 1
    return got


class Heartbeat:
    """Daemon thread invoking ``ship()`` every ``interval`` seconds until
    stopped — the one periodic-sender mechanism, used for both metric
    snapshots and lease renewals.  ``ship`` runs on the heartbeat thread;
    whatever it reads must be thread-safe by contract.  ``immediate=True``
    fires once at start() so a lease exists before the first full interval
    elapses."""

    def __init__(self, interval: float, ship: Callable[[], object],
                 immediate: bool = False):
        self._interval = max(float(interval), 0.05)
        self._ship = ship
        self._immediate = immediate
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="rabit-obs-heartbeat", daemon=True
        )

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)

    def _run(self) -> None:
        if self._immediate:
            self._ship()
        while not self._stop.wait(self._interval):
            self._ship()
