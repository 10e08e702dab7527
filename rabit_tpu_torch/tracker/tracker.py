"""The tracker: rank assignment, the bootstrap and recovery waves of
rabit's C++ engine, and the elastic plane's spares and resizes.

The port's core of ``rabit_tpu/tracker/tracker.py``.  Workers check in
with ``start`` (a fresh process) or ``recover`` (a survivor whose
collective failed); once ``world_size`` check-ins are pending, the wave
closes: ranks are assigned (``assign_ranks``: a task id keeps its rank),
the world epoch rises by one (the first wave is epoch 0), and every member
gets its Assignment (``protocol``): ring neighbours, the tree, the whole
peer table, the epoch, and the schedule ``sched.plan`` lays out, byte for
byte what ``rabit_tpu``'s tracker sends for the same check-ins.  A
check-in whose worker hung up while the wave filled is purged before the
wave closes, so a worker that dies between its check-in and the reply
cannot strand the others.  ``print`` messages go to ``messages`` (the
robust engine's stats lines also become ``events``); the job is done once
as many task ids as the world holds have shut down and no other task
holds a lease.

Elastic worlds (``elastic``): the epoch line belongs to
``elastic.MembershipManager``, which decides every wave.  A worker with
``rabit_spare=1`` checks in with ``spare``, receives the cached bootstrap
blob (which rank 0 uploads with ``blob`` after each commit) and parks on a
warm socket.  A wave short of a rank takes a parked spare once it has
waited ``promote_after_sec`` (``spare_promoted``), at once when the dead
rank's lease expired (``note_dead``); with no spare past
``shrink_after_sec`` it closes with the survivors (``world_shrunk``), and
when spares park again below the launch size the ``epoch`` reply asks the
workers to re-enter a wave at their next version boundary, which grows
the world back (``world_grown``).  A check-in the closing wave has no slot
for, and a fresh worker's check-in whose slot a spare has taken, park as
spares too.  The age-gated decisions run on a monitor thread; with no
spares and ``shrink_after_sec=0`` no wave closes but a full one, as
before.

Liveness: a worker with ``rabit_heartbeat_sec`` renews a lease
(``CMD_HEARTBEAT``); a lease silent for ``LEASE_FACTOR`` intervals
expires, is recorded as ``lease_expired`` and is handed to
``on_suspect(task_id)`` (the launcher SIGKILLs the worker, and the usual
recovery wave follows).  A shutdown or a new check-in of the task id drops
its lease.

Schedules: every wave is planned by ``sched.plan`` (``schedule``:
auto|tree|ring|swing).  A degraded link, flagged by a confirmed
``degraded-link`` incident or an operator's ``origin=``-stamped
``slow_link`` print (``flag_link``), is kept as a task-id pair; with
``sched_repair`` on, the ``epoch`` reply asks for a wave at the next
version boundary, as for a grow-back, and that wave's plan routes the ring
around the link (``schedule_repaired``).

Telemetry: ``CMD_METRICS`` snapshots (the newest a rank; their streamed
``delta`` windows folded into a rollup), the waves, the leases, the
restarts, the promotions and resizes, the schedule repairs and the
incidents make the job's telemetry document (``build_telemetry``), written
atomically to ``<obs_dir>/telemetry.json`` when the job ends or the
tracker stops.  Its keys are ``rabit_tpu``'s, less those of the planes not
ported (quorum, relays and the serving stats).

Diagnosis: once a ``rabit_diag_window_sec`` window, the lease thread hands
the rollup and the window's new events to an ``obs.diagnose.HealthMonitor``,
which opens and resolves incidents (``incident_opened`` /
``incident_resolved``); a ``degraded-link`` incident flags its link.  A
``CMD_OBS`` hello is answered with ``build_scrape``: the live control
state, the rollup, the incidents and this process's metrics registry, the
document ``obs.top`` renders.

One thread accepts; each connection is served on a thread of its own, one
more scans the leases (and runs the diagnosis windows) and one the forming
wave.  Quorum records, relays, the HA standby and delivery are
``rabit_tpu``'s and not ported; the scrape gives their sections the values
``rabit_tpu``'s gives with those planes off.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from rabit_tpu_torch import sched
from rabit_tpu_torch.elastic.membership import CLOSE, MembershipManager
from rabit_tpu_torch.obs import diagnose as obs_diagnose
from rabit_tpu_torch.obs import stream as obs_stream
from rabit_tpu_torch.obs.events import event_from_stats_line
from rabit_tpu_torch.obs.metrics import GLOBAL_REGISTRY
from rabit_tpu_torch.tracker import protocol as P

HELLO_TIMEOUT_SEC = 60.0  # a torn hello must not pin its thread and socket forever
MAX_MESSAGES = 4096       # the print log keeps the newest
LISTEN_BACKLOG = 1024
TELEMETRY_SCHEMA = 1


def _aggregate_incidents(jobs: dict) -> dict:
    """The scrape's top-level incidents digest: every job's open incidents,
    each stamped with its job key, in one section."""
    open_inc: list[dict] = []
    for job_key, jdoc in sorted(jobs.items()):
        for inc in ((jdoc.get("incidents") or {}).get("open") or ()):
            open_inc.append({**inc, "job": job_key})
    return {"schema": obs_diagnose.DIAG_SCHEMA, "n_open": len(open_inc), "open": open_inc}


@dataclass
class _Pending:
    conn: socket.socket
    task_id: str
    listen_port: int
    host: str
    cmd: int
    origin: str = "worker"  # "spare": it came out of the spare pool


@dataclass
class _Lease:
    expires: float   # time.monotonic() deadline
    interval: float  # the worker's renewal interval (seconds)
    rank: int        # the rank the worker reported (-1 before its assignment)


def _conn_dead(conn: socket.socket) -> bool:
    """True when the worker of a held-open check-in has hung up (EOF or
    reset visible without consuming data): it sends nothing after its
    hello, so a readable EOF means it left the wave."""
    try:
        return conn.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
    except (BlockingIOError, InterruptedError):
        return False  # open and idle, the normal pending state
    except OSError:
        return True


def assign_ranks(wave: list[tuple[str, str]], world_size: int,
                 prev_ranks: dict[str, int]) -> dict[str, int]:
    """Ranks for a wave ``[(task_id, host), ...]`` in check-in order
    (``rabit_tpu.tracker.tracker.assign_ranks``).  Precedence:

    1. a task id seen before keeps its rank;
    2. a launcher-numbered id ``int(task_id)`` takes that rank when free;
    3. the rest get the free ranks grouped by host, hosts in first-seen
       order, so ring neighbours share a host where they can.
    """
    ranks: dict[str, int] = {}
    taken: set[int] = set()
    for task_id, _host in wave:
        prev = prev_ranks.get(task_id)
        # Two task ids can hold the same stale rank; the first in the wave
        # keeps it.
        if prev is not None and 0 <= prev < world_size and prev not in taken:
            ranks[task_id] = prev
            taken.add(prev)
    for task_id, _host in wave:
        if task_id in ranks:
            continue
        try:
            cand = int(task_id)
        except ValueError:
            continue
        if 0 <= cand < world_size and cand not in taken:
            ranks[task_id] = cand
            taken.add(cand)
    groups: dict[str, list[str]] = {}
    first_seen: dict[str, int] = {}
    for i, (task_id, host) in enumerate(wave):
        if task_id in ranks:
            continue
        groups.setdefault(host, []).append(task_id)
        first_seen.setdefault(host, i)
    free = iter(r for r in range(world_size) if r not in taken)
    for host in sorted(groups, key=first_seen.get):
        for task_id in groups[host]:
            ranks[task_id] = next(free)
    return ranks


class Tracker:
    """A tracker for one job of ``world_size`` workers, listening on
    ``host:port`` (port 0: any free port; ``self.port`` says which) from
    construction; ``start`` begins serving.  ``schedule`` is the algorithm
    of each wave's plan (``sched.ALGOS``; on the near-square mesh model),
    and ``sched_repair`` whether a flagged link is routed around at the
    next wave.  ``obs_dir`` (default: ``RABIT_OBS_DIR``) is where
    telemetry.json goes; ``on_suspect(task_id)`` is called from the lease
    thread when a lease expires (its exceptions are swallowed).
    ``shrink_after_sec``, ``min_world`` and ``promote_after_sec`` are the
    elastic knobs (``elastic.settings``); ``world_size`` is the current
    world, ``base_world`` the launch size."""

    def __init__(self, world_size: int, host: str = "127.0.0.1", port: int = 0,
                 quiet: bool = False, obs_dir: str | None = None,
                 on_suspect: Callable[[str], None] | None = None,
                 shrink_after_sec: float = 0.0, min_world: int = 1,
                 promote_after_sec: float = 0.25, schedule: str = "auto",
                 sched_repair: bool = True):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if schedule not in sched.ALGOS:
            raise ValueError(f"schedule={schedule!r} not in {sched.ALGOS}")
        self.world_size = world_size
        self.base_world = world_size
        self.elastic = MembershipManager(world_size, min_world=min_world,
                                         shrink_after_sec=shrink_after_sec,
                                         promote_after_sec=promote_after_sec)
        self.quiet = quiet
        self.on_suspect = on_suspect
        self.obs_dir = obs_dir if obs_dir is not None else (
            os.environ.get("RABIT_OBS_DIR", "") or None)
        self.messages: deque[str] = deque(maxlen=MAX_MESSAGES)
        self.messages_dropped = 0
        #: the job's timeline: one {"ts", "kind": "wave", "epoch", "world",
        #: "assignments", "recovering", "restarted", "delta"} a closed wave,
        #: the spares' and resizes' events, lease expiries, snapshots, and
        #: events from the workers' stats lines
        self.events: list[dict] = []
        self.schedule = schedule
        self.sched_repair = bool(sched_repair)
        self._link_flags: set[tuple[str, str]] = set()  # (src task, dst task)
        self._repair_wanted = False
        self.snapshots: dict[int, dict] = {}  # rank -> newest shipped snapshot
        self.telemetry: dict | None = None
        self._stream = obs_stream.StreamRollup()
        self._delta_ranks: set[str] = set()
        self._health = obs_diagnose.HealthMonitor()
        self._diag_next = 0.0   # monotonic start of the next diagnosis window
        self._diag_ev_idx = 0   # events the past windows consumed
        self._obs_scraped = False  # the one obs_scrape event is recorded
        #: the serving counters of the scrape's ``serving`` section (the
        #: keys of rabit_tpu's; no reactor and no relay batches here)
        self.serve_stats: dict[str, int] = {
            "accepts": 0, "rpcs": 0, "handler_threads_hwm": 0, "reactor_conns_hwm": 0,
            "batches": 0, "batch_msgs": 0, "obs_scrapes": 0}
        self._stats_lock = threading.Lock()
        self._handler_threads = 0
        self._leases: dict[str, _Lease] = {}
        self._started_at = time.time()
        self._telemetry_written = False
        self._telemetry_flushed = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(LISTEN_BACKLOG)
        self.host, self.port = self._srv.getsockname()
        self._lock = threading.Lock()
        self._pending: list[_Pending] = []
        self._wave_started: float | None = None  # monotonic, the wave's first check-in
        self._spares: list[_Pending] = []  # parked spares (warm sockets)
        self._spares_seen = False  # a spare has parked: the job is elastic
        self._blob: tuple[int, bytes] | None = None  # (version, bootstrap blob)
        self._ranks: dict[str, int] = {}  # task id -> its last rank
        self._n_starts: dict[str, int] = {}  # task id -> start check-ins
        self._shutdown_tasks: set[str] = set()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None

    @property
    def epoch(self) -> int:
        """The newest committed world epoch (-1 before the first wave)."""
        return self.elastic.epoch

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Tracker":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="rabit-torch-tracker")
        self._thread.start()
        threading.Thread(target=self._lease_monitor, daemon=True,
                         name="rabit-torch-tracker-leases").start()
        threading.Thread(target=self._wave_monitor, daemon=True,
                         name="rabit-torch-tracker-waves").start()
        return self

    def wait(self, timeout: float | None = None) -> bool:
        """True once the job is done (telemetry.json is then written)."""
        return self._done.wait(timeout)

    def stop(self) -> None:
        """Stop serving, drop every held check-in, and write telemetry.json
        with what the tracker has, if the job's end has not."""
        self._done.set()
        # shutdown() before close() wakes the accept() the serving thread
        # is blocked in; close() alone would leave it listening.
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        with self._lock:
            held, self._pending = self._pending, []
        for p in held:
            p.conn.close()
        self._release_spares()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.write_telemetry()

    def _release_spares(self) -> None:
        """Close every parked spare's warm socket: the spare sees EOF and
        leaves its park.  Runs when the job is done and at ``stop``."""
        with self._lock:
            spares, self._spares = self._spares, []
        for sp in spares:
            sp.conn.close()

    # -- serving -------------------------------------------------------------

    def _serve(self) -> None:
        # Serves until ``stop`` closes the socket, the job's end included: a
        # restarted worker that checks in after it is parked and released.
        while True:
            try:
                conn, addr = self._srv.accept()
            except OSError:
                break
            with self._stats_lock:
                self.serve_stats["accepts"] += 1
            threading.Thread(target=self._handle_counted, args=(conn, addr),
                             daemon=True).start()

    def _handle_counted(self, conn: socket.socket, addr) -> None:
        with self._stats_lock:
            self._handler_threads += 1
            self.serve_stats["handler_threads_hwm"] = max(
                self.serve_stats["handler_threads_hwm"], self._handler_threads)
        try:
            self._handle(conn, addr)
        finally:
            with self._stats_lock:
                self._handler_threads -= 1

    def _handle(self, conn: socket.socket, addr) -> None:
        try:
            conn.settimeout(HELLO_TIMEOUT_SEC)
            if P.get_u32(conn) != P.MAGIC_HELLO:
                conn.close()
                return
            cmd = P.get_u32(conn)
            prev_rank = P.get_i32(conn)  # a task id keys the ranks; leases record it
            task_id = P.get_str(conn)
            if cmd in (P.CMD_START, P.CMD_RECOVER, P.CMD_SPARE):
                listen_port = P.get_u32(conn)
                conn.settimeout(None)  # held until the wave closes
                with self._lock:
                    # A check-in supersedes the previous life's lease: the
                    # fresh worker renews once it is up, and a stale lease
                    # must not suspect it mid-bootstrap.
                    self._leases.pop(task_id, None)
                p = _Pending(conn, task_id, listen_port, addr[0], cmd)
                if cmd == P.CMD_SPARE or self._done.is_set():
                    # the socket stays open until a promotion answers it, or
                    # the release at the job's end
                    self._park_spare(p)
                    return
                wave = self._register(p)
                if wave is not None:
                    self._send_wave(wave)
                return
            with self._stats_lock:
                self.serve_stats["rpcs"] += 1
            if cmd == P.CMD_EPOCH:
                P.get_str(conn)  # the worker's committed version (informational)
                conn.sendall(P.put_u32(P.ACK) + P.put_str(json.dumps(self._epoch_info())))
            elif cmd == P.CMD_BLOB:
                version = P.get_u32(conn)
                nbytes = P.get_u32(conn)
                self._keep_blob(task_id, version, P.recv_exact(conn, nbytes) if nbytes else b"")
                conn.sendall(P.put_u32(P.ACK))
            elif cmd == P.CMD_PRINT:
                self._log_print(P.get_str(conn))
                conn.sendall(P.put_u32(P.ACK))
            elif cmd == P.CMD_METRICS:
                self._accept_snapshot(P.get_str(conn))
                conn.sendall(P.put_u32(P.ACK) + self._clock_stamp())
            elif cmd == P.CMD_HEARTBEAT:
                self._renew_lease(task_id, prev_rank, P.get_str(conn))
                conn.sendall(P.put_u32(P.ACK) + self._clock_stamp())
            elif cmd == P.CMD_SHUTDOWN:
                with self._lock:
                    # dropped before the ACK: a clean exit is never suspected
                    self._leases.pop(task_id, None)
                conn.sendall(P.put_u32(P.ACK))
                self._note_shutdown(task_id)
            elif cmd == P.CMD_OBS:
                conn.sendall(P.put_u32(P.ACK) + P.put_str(json.dumps(
                    self._scrape(task_id, P.get_str(conn)))))
            conn.close()  # and any command the core tracker does not serve
        except (ConnectionError, OSError, ValueError):
            conn.close()

    @staticmethod
    def _clock_stamp() -> bytes:
        """The tracker's clock, appended to metrics and heartbeat ACKs: one
        half of a worker's offset estimate (``protocol.TimedAck``)."""
        return P.put_str(f"{time.time():.6f}")

    def _log_print(self, msg: str) -> None:
        """Keep one worker print in the bounded log, and turn the robust
        engine's stats lines into events."""
        with self._lock:
            if len(self.messages) >= MAX_MESSAGES:
                if self.messages_dropped == 0:
                    self.events.append({"ts": round(time.time(), 6),
                                        "kind": "messages_dropped", "cap": MAX_MESSAGES})
                self.messages_dropped += 1
            self.messages.append(msg)
        ev = event_from_stats_line(msg)
        if ev is not None:
            with self._lock:
                self.events.append({"ts": round(ev.ts, 6), "kind": ev.kind, **ev.fields})
            # A worker's slow_link report feeds the HealthMonitor, whose
            # confirmed incident flags the link; a report stamped origin=
            # (an operator's, e.g. torch_trace_tool.py report --flag-links)
            # is a decision, not a symptom, and flags it at once.
            if ev.kind == "link_degraded" and ev.fields.get("origin"):
                self._flag_link(ev.fields)
        if not self.quiet:
            print(msg, end="" if msg.endswith("\n") else "\n", flush=True)

    def _note_shutdown(self, task_id: str) -> None:
        with self._lock:
            self._shutdown_tasks.add(task_id)
            done = self._complete_locked()
        if done:
            self._finalize_done()

    def _complete_locked(self) -> bool:
        """The completion guard: as many task ids as the current world
        holds have shut down, and no task that has not holds a lease (a
        dead one's lease expires and releases the guard; after a shrink a
        survivor still re-waving holds one)."""
        return (len(self._shutdown_tasks) >= self.world_size
                and not set(self._leases) - self._shutdown_tasks)

    def _finalize_done(self) -> None:
        """Write telemetry.json BEFORE releasing ``wait()``: once the
        launcher sees the job done, the file exists.  Then the parked
        spares are released, so that their processes end with the job."""
        self.write_telemetry()
        self._done.set()
        self._release_spares()

    def _epoch_info(self) -> dict:
        """The ``epoch`` reply: the current epoch and world, and whether a
        grow-back or a schedule repair waits for the workers' next version
        boundary (both are resolved by the same wave)."""
        with self._lock:
            self._reap_spares_locked()
            return {"epoch": self.elastic.epoch, "world": self.world_size,
                    "rewave": (self.elastic.grow_wanted(len(self._spares))
                               or self._repair_wanted)}

    def _keep_blob(self, task_id: str, version: int, blob: bytes) -> None:
        """Keep the newest uploaded state as the blob a parked spare gets."""
        with self._lock:
            if self._blob is None or version >= self._blob[0]:
                self._blob = (version, blob)
            self.events.append({"ts": round(time.time(), 6), "kind": "bootstrap_blob",
                                "task_id": task_id, "version": version,
                                "nbytes": len(blob)})

    # -- liveness ------------------------------------------------------------

    def _renew_lease(self, task_id: str, rank: int, payload: str) -> None:
        """Grant or renew a lease: the worker renews every ``interval``
        seconds and is suspected after LEASE_FACTOR intervals of silence.
        A malformed or non-positive interval is ignored."""
        try:
            interval = float(payload)
        except ValueError:
            return
        if not 0 < interval < 86400:
            return
        with self._lock:
            self._leases[task_id] = _Lease(
                time.monotonic() + P.LEASE_FACTOR * interval, interval, rank)

    def _lease_monitor(self) -> None:
        while not self._done.wait(0.05):
            self._lease_tick(time.monotonic())

    def _lease_tick(self, now: float) -> None:
        """One scan: an expired lease is removed before ``on_suspect``
        fires, so one hang gives exactly one suspicion (the restarted life
        takes a lease of its own)."""
        expired: list[tuple[str, _Lease]] = []
        with self._lock:
            for task_id, lease in list(self._leases.items()):
                if now >= lease.expires:
                    del self._leases[task_id]
                    expired.append((task_id, lease))
            for task_id, lease in expired:
                self.events.append({
                    "ts": round(time.time(), 6), "kind": "lease_expired",
                    "task_id": task_id, "rank": lease.rank, "interval": lease.interval,
                    "overdue": round(now - lease.expires, 6)})
        for task_id, lease in expired:
            if not self.quiet:
                print(f"[tracker] lease expired for task {task_id} (rank {lease.rank}, "
                      f"interval {lease.interval}s): suspecting worker", flush=True)
            if self.on_suspect is not None:
                try:
                    self.on_suspect(task_id)
                except Exception:  # noqa: BLE001 (detection must survive its hook)
                    pass
            # a task known dead: a parked spare takes its slot at once
            self.note_dead(task_id)
        if expired:
            # An expired lease may have been all that held the completion
            # guard open: every other task has shut down.
            with self._lock:
                done = self._complete_locked()
            if done:
                self._finalize_done()
        self._diag_tick(now)

    def live_tasks(self) -> list[str]:
        """Task ids that hold an unexpired lease."""
        with self._lock:
            return sorted(self._leases)

    # -- diagnosis and the live scrape -----------------------------------------

    def _diag_tick(self, now: float) -> None:
        """One diagnosis window (``rabit_diag_window_sec`` cadence) on the
        lease thread.  The window's state is copied under the lock, the
        rules run outside it (the monitor and the rollup hold leaf locks of
        their own), and a ``degraded-link`` incident flags its link with no
        lock held."""
        hm = self._health
        if not hm.enabled or now < self._diag_next:
            return
        self._diag_next = now + hm.window_sec
        with self._lock:
            events_delta = self.events[self._diag_ev_idx:]
            self._diag_ev_idx = len(self.events)
            dropped = self.messages_dropped
        opened, resolved = hm.observe(now, self._stream.render(),
                                      {"events_delta": events_delta,
                                       "messages_dropped": dropped})
        if not opened and not resolved:
            return
        ts = round(time.time(), 6)
        with self._lock:
            for kind, incs in (("incident_opened", opened), ("incident_resolved", resolved)):
                for inc in incs:
                    self.events.append({"ts": ts, "kind": kind, "incident": inc.incident_id,
                                        "class": inc.cls, **inc.subject})
        for inc in opened:
            if not self.quiet:
                print(f"[tracker] incident opened: {inc.incident_id} {inc.subject}",
                      flush=True)
            if inc.cls == "degraded-link":
                try:
                    src, dst = int(inc.subject.get("src")), int(inc.subject.get("dst"))
                except (TypeError, ValueError):
                    continue
                self.flag_link(src, dst)
        for inc in resolved:
            if not self.quiet:
                print(f"[tracker] incident resolved: {inc.incident_id} after "
                      f"{inc.windows} window(s)", flush=True)

    def _scrape(self, task_id: str, message: str) -> dict:
        """Serve one ``CMD_OBS`` scrape; the first of the tracker's life is
        recorded as an ``obs_scrape`` event (one, so a poller does not flood
        the timeline)."""
        try:
            opts = json.loads(message) if message else {}
        except ValueError:
            opts = {}
        doc = self.build_scrape(opts if isinstance(opts, dict) else {})
        with self._stats_lock:
            self.serve_stats["obs_scrapes"] += 1
        with self._lock:
            if not self._obs_scraped:
                self._obs_scraped = True
                self.events.append({"ts": round(time.time(), 6), "kind": "obs_scrape",
                                    "task_id": task_id})
        return doc

    def _scrape_job_state(self) -> dict:
        """The job's live scrape section, from copies of the control state
        taken under the lock: membership, leases, spares, the forming wave,
        the link flags, the rollup and the incidents.  ``quorum_outstanding``
        and ``delivery`` carry ``rabit_tpu``'s values with those planes off."""
        with self._lock:
            live = {
                "epoch": self.elastic.epoch,
                "world": self.world_size,
                "base_world": self.base_world,
                "leases": len(self._leases),
                "spares": len(self._spares),
                "pending": len(self._pending),
                "n_shutdown": len(self._shutdown_tasks),
                "restarts": sum(n - 1 for n in self._n_starts.values() if n > 1),
                "quorum_outstanding": 0,
                "link_flags": len(self._link_flags),
                "n_events": len(self.events),
                "n_snapshots": len(self.snapshots),
                "messages_dropped": self.messages_dropped,
                "delivery": {"line": None, "snaps": 0, "snap_bytes": 0, "subscribers": 0},
            }
        live["stream"] = self._stream.render()
        live["incidents"] = self._health.render()
        return live

    def build_scrape(self, opts: dict | None = None) -> dict:
        """The ``CMD_OBS`` document (``rabit_tpu``'s schema): live tracker
        state, the job's rollup and incidents, and this process's metrics
        registry unless ``opts`` sets ``registry`` false."""
        opts = opts or {}
        with self._stats_lock:
            serve = dict(self.serve_stats)
        doc = {
            "schema": obs_stream.STREAM_SCHEMA,
            "ts": round(time.time(), 6),
            "started_at": round(self._started_at, 6),
            "serving": {"reactor": False, "backlog": LISTEN_BACKLOG, **serve},
            "jobs": {"": self._scrape_job_state()},
        }
        doc["incidents"] = _aggregate_incidents(doc["jobs"])
        if opts.get("registry", True):
            doc["registry"] = GLOBAL_REGISTRY.snapshot()
        return doc

    # -- telemetry -----------------------------------------------------------

    def _accept_snapshot(self, payload: str) -> None:
        """Keep one CMD_METRICS snapshot (the newest a rank wins: a
        restarted life's replaces its predecessor's).  A snapshot whose rank
        lies outside the world is rejected; its streamed ``delta`` is
        stripped and folded into the rollup, so the kept snapshot is
        cumulative only."""
        try:
            snap = json.loads(payload)
            rank = int(snap.get("rank", -1))
        except (ValueError, TypeError, AttributeError):
            return  # a malformed snapshot must not hurt the tracker
        delta = snap.pop("delta", None)
        if not 0 <= rank < self.world_size:
            with self._lock:
                self.events.append({"ts": round(time.time(), 6), "kind": "snapshot_rejected",
                                    "rank": rank, "task_id": str(snap.get("task_id", ""))})
            return
        with self._lock:
            self.snapshots[rank] = snap
            self.events.append({"ts": round(time.time(), 6), "kind": "metrics_snapshot",
                                "rank": rank, "task_id": snap.get("task_id", "")})
        if isinstance(delta, dict) and delta:
            stamp = round(time.time(), 6)
            self._stream.fold(rank, delta, ts=stamp)
            with self._lock:
                if str(rank) not in self._delta_ranks:  # the first fold a rank
                    self._delta_ranks.add(str(rank))
                    self.events.append({"ts": stamp, "kind": "metrics_delta_folded",
                                        "rank": str(rank)})

    def build_telemetry(self) -> dict:
        """The job's telemetry document: per-rank snapshots (op stats and
        latency percentiles), the waves and epochs, lease expiries,
        restarts, promotions, resizes and schedule repairs, clock offsets,
        the streamed rollup and the incidents, under ``rabit_tpu``'s key
        names."""
        with self._lock:
            events = list(self.events)
            snapshots = {str(r): s for r, s in sorted(self.snapshots.items())}
            restarts = {t: n - 1 for t, n in self._n_starts.items() if n > 1}
            epochs = [{"epoch": we.epoch, "world": we.world_size}
                      for we in self.elastic.history]
            dropped = self.messages_dropped
        waves = [e for e in events if e["kind"] == "wave"]
        clocks = {r: s["clock"] for r, s in snapshots.items()
                  if isinstance(s, dict) and s.get("clock")}
        return {
            "schema": TELEMETRY_SCHEMA,
            "job": "",
            "world_size": self.world_size,
            "base_world": self.base_world,
            "started_at": round(self._started_at, 6),
            "finished_at": round(time.time(), 6),
            "n_waves": len(waves),
            "n_recovery_waves": sum(1 for w in waves if w["epoch"] > 0),
            "n_lease_expired": sum(1 for e in events if e["kind"] == "lease_expired"),
            "n_shrunk": sum(1 for e in events if e["kind"] == "world_shrunk"),
            "n_grown": sum(1 for e in events if e["kind"] == "world_grown"),
            "n_spares_promoted": sum(1 for e in events if e["kind"] == "spare_promoted"),
            "schedule": self.schedule,
            "n_schedule_repaired": sum(1 for e in events
                                       if e["kind"] == "schedule_repaired"),
            "messages_dropped": dropped,
            "epochs": epochs,
            "restarts": restarts,
            "clocks": clocks,
            "stream": self._stream.render(),
            "incidents": self._health.render(),
            "waves": waves,
            "events": events,
            "ranks": snapshots,
        }

    def write_telemetry(self) -> str | None:
        """Build the document into ``self.telemetry`` and write it to
        ``<obs_dir>/telemetry.json`` (a temporary file renamed into place,
        so a reader never sees a torn file).  The first caller wins; a later
        one waits until the file is down.  Returns the path, or None without
        an obs dir.  Never raises on a write error."""
        with self._lock:
            claimed = self._telemetry_written
            self._telemetry_written = True
        if claimed:
            self._telemetry_flushed.wait(5.0)
            return None
        try:
            self.telemetry = self.build_telemetry()
            if not self.obs_dir:
                return None
            os.makedirs(self.obs_dir, exist_ok=True)
            path = os.path.join(self.obs_dir, "telemetry.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.telemetry, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
            return path
        except OSError:
            return None  # observability must not fail the job
        finally:
            self._telemetry_flushed.set()

    # -- waves ---------------------------------------------------------------

    def _register(self, p: _Pending) -> dict | None:
        """Admit one check-in; returns the closed wave, or None while the
        wave fills.  A check-in from a task id already pending replaces
        the stale one.  In an elastic job a fresh worker's check-in whose
        task id the current epoch does not hold, while no wave forms (a
        spare took its slot), is parked as a spare."""
        with self._lock:
            for stale in [q for q in self._pending if q.task_id == p.task_id]:
                stale.conn.close()
            self._pending = [q for q in self._pending if q.task_id != p.task_id]
            slot_taken = (p.cmd == P.CMD_START and not self._pending
                          and self.elastic.epoch >= 0
                          and (self._spares_seen or self.elastic.shrink_after_sec > 0)
                          and p.task_id not in self.elastic.current.rank_map)
            if not slot_taken:
                self._pending.append(p)
                if self._wave_started is None:
                    self._wave_started = time.monotonic()
                return self._close_wave_locked(timer=False)
        self._park_spare(p)
        return None

    def _park_spare(self, p: _Pending) -> None:
        """Park a spare: send it the cached bootstrap blob and keep its
        socket in the pool, where a promotion answers it with an
        Assignment."""
        with self._lock:
            self._leases.pop(p.task_id, None)
            version, blob = self._blob if self._blob is not None else (0, b"")
        try:
            p.conn.sendall(P.put_blob_frame(version, blob))
        except OSError:
            p.conn.close()
            return
        with self._lock:
            for stale in [s for s in self._spares if s.task_id == p.task_id]:
                stale.conn.close()
            self._spares = [s for s in self._spares if s.task_id != p.task_id]
            p.origin, p.cmd = "spare", P.CMD_START
            self._spares.append(p)
            self._spares_seen = True
            pool = len(self._spares)
            self.events.append({"ts": round(time.time(), 6), "kind": "spare_parked",
                                "task_id": p.task_id, "blob_version": version,
                                "pool": pool})
        if not self.quiet:
            print(f"[tracker] spare {p.task_id} parked (blob v{version}, pool {pool})",
                  flush=True)
        if self._done.is_set():
            self._release_spares()  # parked after the job's end: released at once

    def _purge_dead_locked(self) -> None:
        """Drop pending check-ins whose worker hung up: a dead socket would
        get its Assignment into the void, and a shrink counts live
        survivors only."""
        dead = [p for p in self._pending if _conn_dead(p.conn)]
        if not dead:
            return
        for p in dead:
            p.conn.close()
        self._pending = [p for p in self._pending if p not in dead]
        self.events.append({"ts": round(time.time(), 6), "kind": "wave_purged",
                            "dropped": sorted(p.task_id for p in dead)})

    def _reap_spares_locked(self) -> None:
        """Drop parked spares whose warm socket hung up: a spare that died
        in the pool is neither counted nor promoted."""
        dead = [s for s in self._spares if _conn_dead(s.conn)]
        if not dead:
            return
        for s in dead:
            s.conn.close()
        self._spares = [s for s in self._spares if s not in dead]
        self.events.append({"ts": round(time.time(), 6), "kind": "spare_dropped",
                            "dropped": sorted(s.task_id for s in dead)})

    def _close_wave_locked(self, timer: bool) -> dict | None:
        """Close the pending wave if ``MembershipManager.decide`` says so;
        returns the wave (members, surplus check-ins to park) or None.

        ``timer=False`` is the check-in path: only a full wave (or a grow
        that absorbs spares) closes, so a job with no spares and no shrink
        deadline closes its waves exactly as before.  ``timer=True`` is the
        wave monitor's and ``note_dead``'s path, which also applies the
        age-gated promotion and shrink."""
        if not self._pending:
            self._wave_started = None
            return None
        # (a spare that note_dead moved into the wave counts as well: the
        # pool may be empty now)
        elastic_active = (bool(self._spares) or self.elastic.shrink_after_sec > 0
                          or self.world_size < self.base_world
                          or any(p.origin == "spare" for p in self._pending))
        if timer and not elastic_active:
            return None
        age = time.monotonic() - (self._wave_started or time.monotonic())
        if len(self._pending) >= self.world_size or timer:
            self._purge_dead_locked()
        if timer:
            self._reap_spares_locked()
        if not self._pending:
            self._wave_started = None
            return None
        decision = self.elastic.decide(
            len(self._pending), len(self._spares) if elastic_active else 0, age)
        if decision.action != CLOSE:
            return None
        for _ in range(decision.take_spares):
            if not self._spares:
                break
            self._pending.append(self._spares.pop(0))
        world = decision.world
        # Members: check-ins holding a rank of this world first, then in
        # check-in order.  In an elastic job the rest (a restarted worker
        # racing a promoted spare for one slot) park as spares; otherwise
        # they wait for the next wave, as before.
        order = sorted(range(len(self._pending)), key=lambda i: (
            not 0 <= self._ranks.get(self._pending[i].task_id, -1) < world, i))
        members = [self._pending[i] for i in sorted(order[:world])]
        rest = [self._pending[i] for i in sorted(order[world:])]
        surplus = rest if elastic_active else []
        self._pending = [] if elastic_active else rest
        self._wave_started = time.monotonic() if self._pending else None
        promoted = [p.task_id for p in members if p.origin == "spare"]
        self._ranks.update(assign_ranks([(p.task_id, p.host) for p in members], world,
                                        self._ranks))
        rank_map = {p.task_id: self._ranks[p.task_id] for p in members}
        prev_world = self.world_size
        prev_map = dict(self.elastic.current.rank_map)
        wepoch, delta = self.elastic.commit(rank_map, world)
        self.world_size = world
        restarted = []
        for p in members:
            if p.cmd == P.CMD_START:
                if self._n_starts.get(p.task_id, 0) > 0:
                    restarted.append(p.task_id)
                self._n_starts[p.task_id] = self._n_starts.get(p.task_id, 0) + 1
        ts = round(time.time(), 6)
        self.events.append({
            "ts": ts, "kind": "wave", "epoch": wepoch.epoch,
            "world": world, "assignments": dict(rank_map),
            "recovering": sorted(p.task_id for p in members if p.cmd == P.CMD_RECOVER),
            "restarted": sorted(restarted), "delta": delta})
        for task_id in promoted:
            self.events.append({"ts": ts, "kind": "spare_promoted", "task_id": task_id,
                                "rank": rank_map[task_id], "epoch": wepoch.epoch})
        if world < prev_world:
            self.events.append({"ts": ts, "kind": "world_shrunk", "epoch": wepoch.epoch,
                                "from": prev_world, "to": world,
                                "lost": sorted(t for t in prev_map if t not in rank_map)})
        elif world > prev_world:
            self.events.append({"ts": ts, "kind": "world_grown", "epoch": wepoch.epoch,
                                "from": prev_world, "to": world,
                                "joined": sorted(delta["joined"])})
        return {"members": members, "world": world, "epoch": wepoch.epoch,
                "rank_map": rank_map, "surplus": surplus}

    def _wave_monitor(self) -> None:
        """The age-gated wave decisions (promotion, shrink, grow), every
        50 ms; nothing for a job with no spares and no shrink deadline."""
        while not self._done.wait(0.05):
            self._wave_tick()

    def _wave_tick(self) -> None:
        with self._lock:
            wave = self._close_wave_locked(timer=True)
        if wave is not None:
            self._send_wave(wave)

    def note_exit(self, task_id: str) -> None:
        """The launcher saw the process of ``task_id`` die: its lease goes
        (a dead life's lease must not suspect the next life while it
        starts), and a parked spare takes its slot at once (``note_dead``)."""
        with self._lock:
            self._leases.pop(task_id, None)
        self.note_dead(task_id)

    def note_dead(self, task_id: str) -> None:
        """A task known dead (its lease expired): move a parked spare into
        the forming wave, so that the wave closes as soon as the survivors
        have checked in, without the promotion grace."""
        with self._lock:
            if any(p.task_id == task_id for p in self._pending):
                return  # it is checking in: not dead after all
            self._reap_spares_locked()
            if not self._spares:
                return
            self._pending.append(self._spares.pop(0))
            if self._wave_started is None:
                self._wave_started = time.monotonic()
            wave = self._close_wave_locked(timer=True)
        if wave is not None:
            self._send_wave(wave)

    # -- schedules -----------------------------------------------------------

    def _flag_link(self, fields: dict) -> None:
        """Take one degraded-link report: keep the (src, dst) link as a
        task-id pair and ask for a repair wave.  With ``sched_repair`` off
        the report is telemetry only and the plan never changes."""
        if not self.sched_repair:
            return
        try:
            src, dst = int(fields["src"]), int(fields["dst"])
        except (KeyError, TypeError, ValueError):
            return
        with self._lock:
            fresh = sched.flags_to_tasks([(src, dst)],
                                         self.elastic.current.rank_map) - self._link_flags
            if not fresh:
                return
            self._link_flags |= fresh
            self._repair_wanted = True
        if not self.quiet:
            print(f"[tracker] link {src}->{dst} flagged degraded; repair replan armed",
                  flush=True)

    def flag_link(self, src: int, dst: int) -> None:
        """Flag a degraded link directly (a confirmed incident, or an
        analytics tool's verdict): the same effect as a worker report."""
        self._flag_link({"src": src, "dst": dst})

    def _plan_schedule(self, world: int, rank_map: dict[str, int]) -> sched.Plan:
        """The closing wave's schedule: the flags as this epoch's rank pairs,
        routed around.  The plan consumes the repair request."""
        with self._lock:
            avoid = sched.tasks_to_flags(self._link_flags, rank_map)
            self._repair_wanted = False
        return sched.plan(world, self.schedule, mesh=sched.mesh_for_world(world),
                          avoid=avoid)

    def _send_wave(self, wave: dict) -> None:
        """One Assignment a member, and a blob frame a surplus check-in
        (now parked), sent outside the lock."""
        world, rank_map = wave["world"], wave["rank_map"]
        peers = {rank_map[p.task_id]: (p.host, p.listen_port) for p in wave["members"]}
        splan = self._plan_schedule(world, rank_map)
        ts = round(time.time(), 6)
        with self._lock:
            self.events.append({
                "ts": ts, "kind": "schedule_planned",
                "epoch": wave["epoch"], "algo": splan.algo, "world": world,
                "ring_order": list(splan.ring_order), "n_avoided": len(splan.avoided)})
            if splan.repaired or splan.residual:
                self.events.append({
                    "ts": ts, "kind": "schedule_repaired", "epoch": wave["epoch"],
                    "algo": splan.algo, "avoided": [list(lk) for lk in splan.avoided],
                    "residual": [list(lk) for lk in splan.residual]})
        if (splan.repaired or splan.residual) and not self.quiet:
            print(f"[tracker] schedule repaired for epoch {wave['epoch']}: routed around "
                  f"{list(splan.avoided)}"
                  + (f", residual {list(splan.residual)}" if splan.residual else ""),
                  flush=True)
        tail = P.assignment_tail_bytes(peers, wave["epoch"], rank_map, splan.algo,
                                       list(splan.ring_order))
        for p in wave["members"]:
            rank = rank_map[p.task_id]
            parent, children = P.tree_topology(rank, world)
            head = P.assignment_head_bytes(rank, world, parent, children,
                                           (rank - 1) % world, (rank + 1) % world)
            try:
                p.conn.sendall(head + tail)
            except OSError:
                pass  # the worker died mid-bootstrap; its peers' next wave covers it
            finally:
                p.conn.close()
        for p in wave["surplus"]:
            self._park_spare(p)
