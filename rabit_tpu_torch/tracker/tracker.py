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

Delivery (``delivery``): ``CMD_SUB`` is the version-line RPC.  A poll is
answered with the newest published line; a ``publish`` registers a new line
(``snapshot_published``, journaled, so a standby restores it) and says
whether the digest's bytes are held already, so that a publisher of bytes
another one shipped skips its upload.  Every ``CMD_BLOB`` upload is also
kept by its sha256 digest, which the tracker computes itself, and
``CMD_SNAP`` serves a window of those bytes as a snap frame (an unknown
digest: an empty frame, which the subscriber retries); the first fetch of
a digest is a ``snapshot_fetched`` event.  The line rides every relay's
batch ACK, so relays answer their children's polls themselves.

Quorum rounds (``quorum``): with ``quorum=`` set the tracker owns each
round's exclusion record.  ``CMD_QUORUM`` reports name the blocks a rank
holds; the first report that meets the K-of-N quorum freezes ``(epoch,
version) -> (excluded, corrections)`` (``quorum_met``), and every later
report of the round, the straggler's included, gets the same record.  A
late block folds as a correction at the next record that holds it
(``contribution_late``, ``correction_folded``); a wave drops the corrections
still outstanding (``correction_dropped``); a rank excluded
``quorum_flag_after`` rounds in a row has its incoming ring link flagged
(``link_degraded`` with ``via: "quorum"``) for the schedule repair.

High availability (``ha``): with ``journal=`` (a ``ha.Journal``, or a path)
every mutation of the control state is journaled, with ``rabit_tpu``'s
record kinds and fields, and ``CMD_JOURNAL`` streams the journal to a warm
standby (refused when nothing is journaled).  A wave's Assignments leave
only once its record has left on every standby's stream (write-ahead), so a
promoted standby never closes an epoch a member already holds, and the
wave's timeline entries go in only then.  ``kill`` is the in-process
SIGKILL.  A standby's promoted tracker is built on its pre-bound socket
(``listen_sock=``) from the replayed state (``resume_from=``): ranks, epoch
line, shutdowns, flagged links, planned ring and frozen quorum records carry
over, and the journaled leases re-arm with fresh deadlines, as does the
delivery line (its bytes are not journaled: the publisher's next commit
re-pushes them).

Telemetry: ``CMD_METRICS`` snapshots (the newest a rank; their streamed
``delta`` windows folded into a rollup), the waves, the leases, the
restarts, the promotions and resizes, the schedule repairs, the quorum
records, the relay channels, the serving counters and the incidents make the
job's telemetry document (``build_telemetry``), written atomically to
``<obs_dir>/telemetry.json`` when the job ends or the tracker stops.  Its
keys are ``rabit_tpu``'s.

Diagnosis: once a ``rabit_diag_window_sec`` window, the lease thread hands
the rollup and the window's new events to an ``obs.diagnose.HealthMonitor``,
which opens and resolves incidents (``incident_opened`` /
``incident_resolved``); a ``degraded-link`` incident flags its link, and a
relay channel that stays down opens a ``lost-relay`` one.  A ``CMD_OBS``
hello is answered with ``build_scrape``: the live control state, the
serving counters, the rollup, the incidents and this process's metrics
registry, the document ``obs.top`` renders.

Serving (``reactor``, the default): one ``selectors`` loop accepts every
connection, parses its hello incrementally (``protocol.hello_parser``) and
answers every short RPC (heartbeat, metrics, epoch poll, quorum report,
print, blob, shutdown, scrape, delivery poll and snapshot fetch) inline,
from ``_short_rpc_reply``, which the threaded path and the relay fold
share, so all three give the same bytes.
A START / RECOVER check-in is registered on the loop and held off it; a wave
it closes is sent from a thread of its own (``_send_wave_async``), as are a
spare's park, a standby's journal stream and a relay's channel, so the loop
never blocks on an O(world) broadcast, a large blob or a disk write.
``reactor=False`` serves each connection on a thread of its own, the
comparison arm.  The listen backlog is ``rabit_tracker_backlog``.  Either
path serves until ``stop`` or ``kill``, past the job's end: a restarted
worker that checks in then is parked and released.  One more thread scans
the leases (and runs the diagnosis windows and the journal's keepalive) and
one the forming wave.

Relays (``relay``): a relay checks in with ``CMD_BATCH`` and holds one
channel, on a thread of its own (``_serve_relay``): every batch envelope is
folded (``_fold_batch_msg``: check-ins, spares, heartbeats, metrics, prints,
shutdowns, quorum reports, delivery polls and publishes, delta frames and
hang-ups) and answered with an ACK frame that carries the tracker's clock,
the epoch line and the delivery line; a check-in's reply (an Assignment, a
park frame), a quorum record and a delivery reply go back by task id on the
same channel.  A relayed check-in is a virtual connection
(``_RelayedConn``) that reads as hung up when its channel dies or the relay
reports its child gone, so the wave purge and the spare reaping clean up
after a relay as after a socket.  Relay channels are ``relay_up`` /
``relay_lost`` events, not membership: the relay reconnects and its
children never notice.  The headless service partition is ``rabit_tpu``'s
and not ported.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import selectors
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

from rabit_tpu_torch import sched
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.elastic.membership import CLOSE, MembershipManager
from rabit_tpu_torch.obs import diagnose as obs_diagnose
from rabit_tpu_torch.obs import stream as obs_stream
from rabit_tpu_torch.obs.events import event_from_stats_line
from rabit_tpu_torch.obs.metrics import GLOBAL_REGISTRY
from rabit_tpu_torch.quorum import QuorumTable
from rabit_tpu_torch.tracker import protocol as P

MAX_MESSAGES = 4096       # the print log keeps the newest
TELEMETRY_SCHEMA = 1
#: Seconds at most a wave's Assignments wait for its journal record to leave
#: on every standby's stream (the write-ahead in ``_send_assignments``).
JOURNAL_WAVE_WAIT_SEC = 1.0


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


#: The hellos that carry a message string after the task id.
_MESSAGE_CMDS = (P.CMD_PRINT, P.CMD_METRICS, P.CMD_HEARTBEAT, P.CMD_EPOCH, P.CMD_QUORUM,
                 P.CMD_OBS, P.CMD_SUB, P.CMD_SNAP)


def _conn_dead(conn) -> bool:
    """True when the worker of a held-open check-in has hung up (EOF or
    reset visible without consuming data): it sends nothing after its
    hello, so a readable EOF means it left the wave.  A relayed check-in's
    ``_RelayedConn`` reads as EOF once its channel is dead or its relay
    reported the child gone."""
    try:
        return conn.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
    except (BlockingIOError, InterruptedError):
        return False  # open and idle, the normal pending state
    except OSError:
        return True


class _RelayChannel:
    """One relay's channel.  Its batch frames are read on the channel's own
    thread; its writes (routed replies, batch ACKs) go through a queue that
    one writer thread drains, so any tracker thread can route a reply
    without blocking or holding a lock around a send."""

    def __init__(self, sock: socket.socket, relay_id: str):
        self.sock = sock
        self.relay_id = relay_id
        self.dead = False
        #: the live virtual connections by task id (a CMD_HANGUP marks one dead)
        self.vconns: dict[str, _RelayedConn] = {}
        self._q: queue.Queue = queue.Queue()
        threading.Thread(target=self._drain, daemon=True,
                         name=f"rabit-torch-relay-tx-{relay_id}").start()

    def _drain(self) -> None:
        while True:
            frame = self._q.get()
            if frame is None or self.dead:
                break
            try:
                self.sock.sendall(frame)
            except OSError:
                self.dead = True
                break

    def send_route(self, task_id: str, flags: int, payload: bytes) -> bool:
        """Queue one route frame; False when the channel is dead (the caller
        treats the child as hung up)."""
        if self.dead:
            return False
        self._q.put(P.put_route_frame(task_id, flags, payload))
        return True

    def close(self) -> None:
        self.dead = True
        self._q.put(None)
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class _RelayedConn:
    """A check-in that rides a relay's channel: the few socket methods the
    wave machinery calls (``sendall``, ``close``, ``recv`` for the
    ``_conn_dead`` peek, ``settimeout``), routed to the child parked at the
    relay."""

    def __init__(self, channel: _RelayChannel, task_id: str):
        self._channel = channel
        self.task_id = task_id
        self._closed = False
        self.child_dead = False  # the relay reported the child hung up
        channel.vconns[task_id] = self

    def sendall(self, data: bytes) -> None:
        if self.child_dead or not self._channel.send_route(self.task_id, 0, bytes(data)):
            raise OSError("relay channel down")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._channel.vconns.get(self.task_id) is self:
            del self._channel.vconns[self.task_id]
        self._channel.send_route(self.task_id, P.ROUTE_CLOSE, b"")

    def recv(self, n: int, flags: int = 0) -> bytes:
        if self._channel.dead or self._closed or self.child_dead:
            return b""  # reads as EOF: the purge and the reaping drop it
        raise BlockingIOError  # open and idle

    def settimeout(self, timeout) -> None:
        pass


class _BufferedSock:
    """A ``recv`` that serves the bytes a client pipelined behind the hello
    the reactor parsed before it reads the socket."""

    def __init__(self, sock: socket.socket, rest: bytes):
        self._sock = sock
        self._rest = bytearray(rest)

    def recv(self, n: int) -> bytes:
        if self._rest:
            out = bytes(self._rest[:n])
            del self._rest[:n]
            return out
        return self._sock.recv(n)


class _RConn:
    """A connection on the reactor: its hello parser, the reply bytes not yet
    sent and the deadline of a torn hello."""

    __slots__ = ("sock", "addr", "parser", "out", "deadline")

    def __init__(self, sock: socket.socket, addr, deadline: float):
        self.sock = sock
        self.addr = addr
        self.parser = P.StreamParser(P.hello_parser())
        self.out = bytearray()
        self.deadline = deadline


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
    world, ``base_world`` the launch size.  ``quorum`` (a ``rabit_quorum``
    spec, "" for none) and ``quorum_flag_after`` set up the quorum records;
    ``journal`` (a ``ha.Journal`` or a path), ``resume_from`` (a replayed
    ``ha.ControlState``), ``listen_sock`` (a bound socket to listen on
    instead of ``host:port``) and ``ha_tick_sec`` (the journal's keepalive
    cadence, default ``rabit_ha_tick_sec``) are the HA plane's.  ``reactor``
    serves on one selectors loop (False: a thread a connection), with a
    listen backlog of ``backlog`` (default ``rabit_tracker_backlog``).
    ``conn_timeout_sec`` bounds the read of a hello on both serving paths: a
    torn or partial hello is dropped at that deadline instead of pinning a
    thread and a socket (0 disables it)."""

    def __init__(self, world_size: int, host: str = "127.0.0.1", port: int = 0,
                 quiet: bool = False, obs_dir: str | None = None,
                 on_suspect: Callable[[str], None] | None = None,
                 shrink_after_sec: float = 0.0, min_world: int = 1,
                 promote_after_sec: float = 0.25, schedule: str = "auto",
                 sched_repair: bool = True, quorum: str = "", quorum_flag_after: int = 3,
                 journal=None, resume_from=None, listen_sock: socket.socket | None = None,
                 ha_tick_sec: float | None = None, reactor: bool = True,
                 backlog: int | None = None, conn_timeout_sec: float = 60.0):
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
        self.conn_timeout_sec = float(conn_timeout_sec)
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
        # the quorum records (None: quorum mode off), and the newest planned
        # ring, whose predecessor of a persistent straggler is flagged
        self._quorum = QuorumTable(quorum, flag_after=quorum_flag_after) if quorum else None
        self._last_ring: list[int] = []
        self.snapshots: dict[int, dict] = {}  # rank -> newest shipped snapshot
        self.telemetry: dict | None = None
        self._stream = obs_stream.StreamRollup()
        self._delta_ranks: set[str] = set()
        self._health = obs_diagnose.HealthMonitor()
        self._diag_next = 0.0   # monotonic start of the next diagnosis window
        self._diag_ev_idx = 0   # events the past windows consumed
        self._obs_scraped = False  # the one obs_scrape event is recorded
        #: the serving counters (the scrape's and telemetry's ``serving``):
        #: connections accepted, short RPCs answered, the peak of live handler
        #: threads (threaded path) and of connections on the loop (reactor),
        #: relay envelopes folded and the sub-messages in them, scrapes
        self.serve_stats: dict[str, int] = {
            "accepts": 0, "rpcs": 0, "handler_threads_hwm": 0, "reactor_conns_hwm": 0,
            "batches": 0, "batch_msgs": 0, "obs_scrapes": 0}
        self._stats_lock = threading.Lock()
        self._handler_threads = 0
        self._reactor = bool(reactor)
        if backlog is None:
            backlog = Config().get_int("rabit_tracker_backlog", 1024)
        self.backlog = max(int(backlog), 1)
        self._relay_channels: list[_RelayChannel] = []
        self._stopping = threading.Event()  # stop() or kill(): serving ends
        self._leases: dict[str, _Lease] = {}
        self._started_at = time.time()
        self._telemetry_written = False
        self._telemetry_flushed = threading.Event()
        if listen_sock is not None:
            # a standby's takeover: it bound its advertised address long
            # ago, and listens only now
            self._srv = listen_sock
        else:
            self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind((host, port))
        self._srv.listen(self.backlog)
        self.host, self.port = self._srv.getsockname()
        self._lock = threading.Lock()
        self._pending: list[_Pending] = []
        self._wave_started: float | None = None  # monotonic, the wave's first check-in
        self._spares: list[_Pending] = []  # parked spares (warm sockets)
        self._spares_seen = False  # a spare has parked: the job is elastic
        self._blob: tuple[int, bytes] | None = None  # (version, bootstrap blob)
        # The delivery plane: the published version line (None: nothing
        # published), every uploaded blob by its digest, the subscriber
        # task ids seen and the digests fetched at least once.
        self._delivery: dict | None = None
        self._snaps: dict[str, bytes] = {}
        self._sub_ids: set[str] = set()
        self._fetched_digests: set[str] = set()
        self._ranks: dict[str, int] = {}  # task id -> its last rank
        self._n_starts: dict[str, int] = {}  # task id -> start check-ins
        self._shutdown_tasks: set[str] = set()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None
        # The HA plane: the journal (None: nothing journaled, and a standby's
        # CMD_JOURNAL is refused), the standbys' channels, kill()'s flag.
        self._killed = False
        self._journal_conns: list[socket.socket] = []
        if isinstance(journal, str):
            from rabit_tpu_torch.ha.journal import Journal

            journal = Journal(journal, snapshot_every=Config().get_int(
                "rabit_ha_snapshot_every", 256))
        self.journal = journal
        if self.journal is not None:
            self.journal.on_event = self._journal_event
        self._ha_tick_sec = (float(ha_tick_sec) if ha_tick_sec is not None
                             else float(Config().get("rabit_ha_tick_sec", "0.25") or "0.25"))
        if resume_from is not None:
            self._adopt_state(resume_from)
        self._journal("init", base_world=self.base_world)

    # -- the HA journal ------------------------------------------------------

    def _journal(self, kind: str, **fields) -> None:
        """Append one mutation record; non-blocking, so safe under the
        lock."""
        if self.journal is not None:
            self.journal.append(kind, **fields)

    def _journal_event(self, ev: dict) -> None:
        """The journal writer's events (journal_snapshot, journal_gap), into
        the timeline."""
        with self._lock:
            self.events.append({"ts": round(time.time(), 6), **ev})

    def _adopt_state(self, st) -> None:
        """Seed this tracker from a replayed ``ha.ControlState`` (a
        standby's takeover), so that every wave it closes is the one the
        dead primary would have closed.  Journaled leases re-arm with fresh
        deadlines: a worker that died in the cut is still suspected, a live
        one renews long before."""
        self.base_world = int(st.base_world) or self.base_world
        self.world_size = int(st.world) or self.world_size
        self.elastic.base_world = self.base_world
        if st.epoch >= 0:
            self.elastic.restore(st.epoch, st.world, st.rank_map,
                                 history=[tuple(e) for e in st.epochs])
        self._ranks.update(st.ranks)
        self._n_starts.update(st.n_starts)
        self._shutdown_tasks |= set(st.shutdown)
        self._link_flags |= {tuple(p) for p in st.link_flags}
        self._last_ring = list(st.last_ring)
        if self._quorum is not None:
            self._quorum.seed(st.quorum_seed())
        now = time.monotonic()
        for task_id, (interval, rank) in sorted(st.leases.items()):
            if task_id not in self._shutdown_tasks:
                self._leases[task_id] = _Lease(now + P.LEASE_FACTOR * float(interval),
                                               float(interval), int(rank))
        # The delivery line carries over; the snapshot bytes do not (relays
        # keep their copies and the publisher re-pushes at its next commit,
        # so a fetch of a digest not yet re-pushed reads an empty frame).
        if st.delivery:
            self._delivery = dict(st.delivery)

    def _drop_lease_locked(self, task_id: str) -> None:
        """Drop a lease, and journal the drop when there was one.  The
        caller holds the lock."""
        if self._leases.pop(task_id, None) is not None:
            self._journal("lease_drop", task_id=task_id)

    @property
    def epoch(self) -> int:
        """The newest committed world epoch (-1 before the first wave)."""
        return self.elastic.epoch

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Tracker":
        serve = self._serve_reactor if self._reactor else self._serve
        self._thread = threading.Thread(target=serve, daemon=True, name="rabit-torch-tracker")
        self._thread.start()
        threading.Thread(target=self._lease_monitor, daemon=True,
                         name="rabit-torch-tracker-leases").start()
        threading.Thread(target=self._wave_monitor, daemon=True,
                         name="rabit-torch-tracker-waves").start()
        return self

    def wait(self, timeout: float | None = None) -> bool:
        """True once the job is done (telemetry.json is then written)."""
        return self._done.wait(timeout)

    def _close_listener(self) -> None:
        """End serving: shutdown() before close() wakes an accept() the
        threaded path is blocked in (close() alone would leave it
        listening); the reactor's loop sees ``_stopping`` within a tick and
        closes the connections it holds."""
        self._stopping.set()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()

    def _join_serving(self) -> None:
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5)

    def stop(self) -> None:
        """Stop serving, drop every held check-in and relay channel, and
        write telemetry.json with what the tracker has, if the job's end has
        not."""
        self._done.set()
        self._close_listener()
        with self._lock:
            held, self._pending = self._pending, []
            jconns, self._journal_conns = self._journal_conns, []
            channels, self._relay_channels = self._relay_channels, []
        for p in held:
            p.conn.close()
        for conn in jconns:
            conn.close()
        for ch in channels:
            ch.close()
        self._release_spares()
        self._join_serving()
        self.write_telemetry()
        if self.journal is not None:
            self.journal.close()

    def kill(self) -> None:
        """An abrupt death, the in-process SIGKILL: every socket drops with
        no goodbye (the forming wave, the spares, the standbys' and relays'
        channels, the listener and the reactor's connections), no telemetry
        is written, and the journal stops where it is.  Workers fail over
        through their address lists and relays through theirs; a standby's
        channel sees EOF and its takeover lease starts to run."""
        self._killed = True
        with self._lock:
            self._telemetry_written = True  # a SIGKILL leaves no telemetry
        self._telemetry_flushed.set()
        self._done.set()
        self._close_listener()
        with self._lock:
            jconns, self._journal_conns = self._journal_conns, []
            channels, self._relay_channels = self._relay_channels, []
            held = [p.conn for p in self._pending] + [s.conn for s in self._spares]
            self._pending, self._spares = [], []
        for ch in channels:
            ch.close()
        for conn in jconns + held:
            conn.close()
        self._join_serving()
        if self.journal is not None:
            self.journal.close()

    def _release_spares(self) -> None:
        """Close every parked spare's warm socket: the spare sees EOF and
        leaves its park.  Runs when the job is done and at ``stop``; the
        release is journaled as a ``spare_drop``."""
        with self._lock:
            spares, self._spares = self._spares, []
            if spares:
                self._journal("spare_drop", task_ids=sorted(sp.task_id for sp in spares))
        for sp in spares:
            sp.conn.close()

    # -- serving -------------------------------------------------------------

    def _serve(self) -> None:
        """The threaded path (``reactor=False``): a thread a connection."""
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
            if self.conn_timeout_sec > 0:
                conn.settimeout(self.conn_timeout_sec)
            if P.get_u32(conn) != P.MAGIC_HELLO:
                conn.close()
                return
            h = P.Hello(P.get_u32(conn), P.get_i32(conn), P.get_str(conn))
            if h.cmd in (P.CMD_START, P.CMD_RECOVER, P.CMD_SPARE):
                h.listen_port = P.get_u32(conn)
            elif h.cmd == P.CMD_BLOB:
                h.blob_version = P.get_u32(conn)
                nbytes = P.get_u32(conn)
                h.blob = P.recv_exact(conn, nbytes) if nbytes else b""
            elif h.cmd in _MESSAGE_CMDS:
                h.message = P.get_str(conn)
            if self._killed:
                conn.close()  # a dead tracker answers nothing
                return
            if h.cmd in (P.CMD_START, P.CMD_RECOVER, P.CMD_SPARE):
                conn.settimeout(None)  # held until the wave closes
                self._checkin(_Pending(conn, h.task_id, h.listen_port, addr[0], h.cmd),
                              inline=True)
                return
            if h.cmd in (P.CMD_BATCH, P.CMD_JOURNAL):
                conn.settimeout(None)  # this thread serves the channel
                if h.cmd == P.CMD_BATCH:
                    self._serve_relay(conn, h.task_id, addr)
                else:
                    self._serve_journal(conn, h.task_id)
                return
            reply, post = self._short_rpc_reply(h)
            conn.sendall(reply)
            if post is not None:
                post()
            conn.close()
        except (ConnectionError, OSError, ValueError):
            conn.close()  # and any command the tracker does not serve

    def _checkin(self, p: _Pending, inline: bool) -> None:
        """Admit one START / RECOVER / SPARE check-in, a socket or a relayed
        child's virtual connection.  A check-in supersedes the previous
        life's lease: the fresh worker renews once it is up, and a stale
        lease must not suspect it mid-bootstrap.  A spare, and any check-in
        after the job's end, parks (its socket stays open until a promotion
        answers it, or the release at the job's end); the rest join the
        forming wave.  ``inline`` sends a closed wave and a park reply on
        this thread (the threaded path); else each goes out on a thread of
        its own (the reactor and the relay fold must not block)."""
        with self._lock:
            self._drop_lease_locked(p.task_id)
        if p.cmd == P.CMD_SPARE or self._done.is_set():
            wave = {"members": [], "surplus": [p]}
        else:
            wave = self._register(p)
        if wave is None:
            return
        if inline:
            self._send_wave(wave)
        else:
            self._send_wave_async(wave)

    def _short_rpc_reply(self, h: P.Hello, counted: bool = True
                         ) -> tuple[bytes, Callable[[], None] | None]:
        """Serve one short RPC: its effects now, and its reply bytes with the
        work that must follow the ACK (a shutdown's completion check).  The
        threaded path, the reactor and the relay fold all serve through this,
        so their bytes are the same.  ``counted`` counts it in ``rpcs`` (a
        relay's sub-message counts in ``batch_msgs`` instead).  ValueError
        for a command the tracker does not serve."""
        if counted:
            with self._stats_lock:
                self.serve_stats["rpcs"] += 1
        if h.cmd == P.CMD_EPOCH:
            # the worker's committed version rides as the message (informational)
            return P.put_u32(P.ACK) + P.put_str(json.dumps(self._epoch_info())), None
        if h.cmd == P.CMD_BLOB:
            self._keep_blob(h.task_id, h.blob_version, h.blob)
            return P.put_u32(P.ACK), None
        if h.cmd == P.CMD_QUORUM:
            return P.put_u32(P.ACK) + P.put_str(json.dumps(self._quorum_report(h.message))), None
        if h.cmd == P.CMD_PRINT:
            self._log_print(h.message)
            return P.put_u32(P.ACK), None
        if h.cmd == P.CMD_METRICS:
            self._accept_snapshot(h.message)
            return P.put_u32(P.ACK) + self._clock_stamp(), None
        if h.cmd == P.CMD_HEARTBEAT:
            self._renew_lease(h.task_id, h.prev_rank, h.message)
            return P.put_u32(P.ACK) + self._clock_stamp(), None
        if h.cmd == P.CMD_SHUTDOWN:
            with self._lock:
                # dropped before the ACK: a clean exit is never suspected
                self._drop_lease_locked(h.task_id)
            return P.put_u32(P.ACK), lambda: self._note_shutdown(h.task_id)
        if h.cmd == P.CMD_OBS:
            return P.put_u32(P.ACK) + P.put_str(json.dumps(
                self._scrape(h.task_id, h.message))), None
        if h.cmd == P.CMD_SUB:
            return self._sub_reply(h.task_id, h.message), None
        if h.cmd == P.CMD_SNAP:
            # the reply is a snap frame, with no ACK before it
            return self._snap_reply(h.task_id, h.message), None
        raise ValueError(f"command {h.cmd} is not served")

    # -- the reactor -----------------------------------------------------------

    def _serve_reactor(self) -> None:
        """The default serving path: one selectors loop accepts, parses each
        hello as its bytes come and answers every short RPC inline;
        check-ins, spares, relay channels and journal channels leave the
        loop once their hello is whole.  A hello still torn
        ``conn_timeout_sec`` after its accept is dropped by the sweep, which
        runs every 0.5 s."""
        sel = selectors.DefaultSelector()
        try:
            self._srv.setblocking(False)
            sel.register(self._srv, selectors.EVENT_READ, None)
        except (OSError, ValueError):
            sel.close()
            return
        conns: set[_RConn] = set()
        next_sweep = time.monotonic() + 0.5
        try:
            while not self._stopping.is_set():
                try:
                    events = sel.select(0.05)
                except OSError:
                    break
                for key, mask in events:
                    if self._stopping.is_set():
                        break
                    if key.data is None:
                        self._reactor_accept(sel, conns)
                    elif mask & selectors.EVENT_READ:
                        self._reactor_read(sel, conns, key.data)
                    elif mask & selectors.EVENT_WRITE:
                        self._reactor_flush(sel, conns, key.data)
                now = time.monotonic()
                if now >= next_sweep:
                    next_sweep = now + 0.5
                    for rc in [r for r in conns if r.deadline and now > r.deadline]:
                        self._reactor_drop(sel, conns, rc)
        finally:
            for rc in list(conns):
                self._reactor_drop(sel, conns, rc)
            sel.close()

    def _reactor_accept(self, sel, conns: set[_RConn]) -> None:
        while True:
            try:
                conn, addr = self._srv.accept()
            except OSError:  # BlockingIOError: nothing more to accept
                return
            conn.setblocking(False)
            deadline = (time.monotonic() + self.conn_timeout_sec
                        if self.conn_timeout_sec > 0 else 0.0)
            rc = _RConn(conn, addr, deadline)
            try:
                sel.register(conn, selectors.EVENT_READ, rc)
            except (OSError, ValueError):
                conn.close()
                continue
            conns.add(rc)
            with self._stats_lock:
                self.serve_stats["accepts"] += 1
                self.serve_stats["reactor_conns_hwm"] = max(
                    self.serve_stats["reactor_conns_hwm"], len(conns))

    def _reactor_drop(self, sel, conns: set[_RConn], rc: _RConn) -> None:
        conns.discard(rc)
        try:
            sel.unregister(rc.sock)
        except (KeyError, OSError, ValueError):
            pass
        rc.sock.close()

    def _reactor_detach(self, sel, conns: set[_RConn], rc: _RConn) -> None:
        """Hand a socket whose hello is whole off the loop (a held check-in,
        a channel): unregistered here, on the loop's thread, before any
        other thread may close it, and back to blocking mode."""
        conns.discard(rc)
        try:
            sel.unregister(rc.sock)
        except (KeyError, OSError, ValueError):
            pass
        rc.sock.setblocking(True)

    def _reactor_read(self, sel, conns: set[_RConn], rc: _RConn) -> None:
        try:
            data = rc.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._reactor_drop(sel, conns, rc)
            return
        if not data:
            self._reactor_drop(sel, conns, rc)
            return
        try:
            if not rc.parser.feed(data):
                return
        except ValueError:
            self._reactor_drop(sel, conns, rc)  # a bad magic, an oversized field
            return
        h: P.Hello = rc.parser.result
        if self._killed:
            self._reactor_drop(sel, conns, rc)  # a dead tracker answers nothing
            return
        if h.cmd in (P.CMD_START, P.CMD_RECOVER, P.CMD_SPARE):
            self._reactor_detach(sel, conns, rc)
            self._checkin(_Pending(rc.sock, h.task_id, h.listen_port, rc.addr[0], h.cmd),
                          inline=False)
            return
        if h.cmd == P.CMD_BATCH:
            self._reactor_detach(sel, conns, rc)
            threading.Thread(target=self._serve_relay,
                             args=(rc.sock, h.task_id, rc.addr, rc.parser.rest()),
                             daemon=True, name=f"rabit-torch-relay-rx-{h.task_id}").start()
            return
        if h.cmd == P.CMD_JOURNAL:
            self._reactor_detach(sel, conns, rc)
            threading.Thread(target=self._serve_journal, args=(rc.sock, h.task_id),
                             daemon=True, name=f"rabit-torch-ha-tx-{h.task_id}").start()
            return
        try:
            reply, post = self._short_rpc_reply(h)
        except (ValueError, OSError):
            self._reactor_drop(sel, conns, rc)
            return
        rc.out += reply
        self._reactor_flush(sel, conns, rc)
        if post is not None:
            post()

    def _reactor_flush(self, sel, conns: set[_RConn], rc: _RConn) -> None:
        """Send the reply without blocking the loop (a reply larger than the
        socket's buffer waits for EVENT_WRITE); once it is out the
        connection closes, one RPC a connection as on the threaded path."""
        while rc.out:
            try:
                n = rc.sock.send(rc.out)
            except (BlockingIOError, InterruptedError):
                try:
                    sel.modify(rc.sock, selectors.EVENT_WRITE, rc)
                except (KeyError, OSError, ValueError):
                    self._reactor_drop(sel, conns, rc)
                return
            except OSError:
                self._reactor_drop(sel, conns, rc)
                return
            del rc.out[:n]
        self._reactor_drop(sel, conns, rc)

    # -- relay channels ----------------------------------------------------------

    def _serve_relay(self, conn: socket.socket, relay_id: str, addr, rest: bytes = b"") -> None:
        """Serve one relay's channel: ACK its hello, then fold its batch
        envelopes until EOF or ``stop``, each answered with an ACK frame
        (``_batch_ack_info`` and the tracker's clock at each sub-message's
        fold).  A channel's death is no membership event: its virtual
        connections read as hung up, and the relay reconnects."""
        channel = _RelayChannel(conn, relay_id)
        try:
            conn.sendall(P.put_u32(P.ACK))
        except OSError:
            channel.close()
            return
        with self._lock:
            self._relay_channels.append(channel)
            self.events.append({"ts": round(time.time(), 6), "kind": "relay_up",
                                "relay": relay_id, "host": addr[0]})
        if not self.quiet:
            print(f"[tracker] relay {relay_id} channel up ({addr[0]})", flush=True)
        src = _BufferedSock(conn, rest) if rest else conn
        try:
            while not self._stopping.is_set():
                msgs = P.read_batch_frame(src)
                acks = [self._fold_batch_msg(channel, m) for m in msgs]
                with self._stats_lock:
                    self.serve_stats["batches"] += 1
                    self.serve_stats["batch_msgs"] += len(msgs)
                info = self._batch_ack_info()
                info["acks"] = acks
                if msgs:  # an empty keepalive refreshes the relay's caches only
                    with self._lock:
                        self.events.append({"ts": info["server_ts"], "kind": "batch_folded",
                                            "relay": relay_id, "n": len(msgs)})
                channel.send_route("", 0, json.dumps(info).encode())
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            channel.close()
            with self._lock:
                if channel in self._relay_channels:
                    self._relay_channels.remove(channel)
                self.events.append({"ts": round(time.time(), 6), "kind": "relay_lost",
                                    "relay": relay_id})
            if not self.quiet and not self._stopping.is_set():
                print(f"[tracker] relay {relay_id} channel lost (its children stay; the "
                      "relay reconnects)", flush=True)

    def _batch_ack_info(self) -> dict:
        """The batch ACK's document: the tracker's clock, and the epoch line
        and delivery line the relay answers its children's polls from."""
        info = {"server_ts": round(time.time(), 6)}
        info.update(self._epoch_info())
        with self._lock:
            if self._delivery is not None:
                info["delivery"] = dict(self._delivery)
        return info

    def _fold_batch_msg(self, channel: _RelayChannel, m: P.BatchMsg) -> float:
        """Fold one relayed sub-message; returns the tracker's clock at the
        fold, for the batch ACK's ``acks``.  A check-in becomes a virtual
        connection; a quorum report's record goes back to the child parked
        as ``q#<task id>``, and a delivery reply to the one parked as
        ``s#<task id>``, in the direct path's bytes; a delta frame folds
        into the rollup; a hang-up marks the child's virtual connection
        dead.  Epoch polls never ride a batch (the relay answers them), blobs
        and snapshot fetches are proxied around it, and a malformed
        sub-message is ignored."""
        ts = round(time.time(), 6)
        try:
            if m.cmd in (P.CMD_START, P.CMD_RECOVER, P.CMD_SPARE):
                vconn = _RelayedConn(channel, m.task_id)
                self._checkin(_Pending(vconn, m.task_id, m.listen_port, m.host, m.cmd),
                              inline=False)
            elif m.cmd == P.CMD_OBS:
                self._fold_delta_frame(m.payload, ts)
            elif m.cmd == P.CMD_HANGUP:
                vconn = channel.vconns.get(m.task_id)
                if vconn is not None:
                    vconn.child_dead = True
            elif m.cmd in (P.CMD_HEARTBEAT, P.CMD_METRICS, P.CMD_PRINT, P.CMD_SHUTDOWN,
                           P.CMD_QUORUM, P.CMD_SUB):
                reply, post = self._short_rpc_reply(
                    P.Hello(m.cmd, m.prev_rank, m.task_id, message=m.payload.decode()),
                    counted=False)
                if m.cmd in (P.CMD_QUORUM, P.CMD_SUB):
                    channel.send_route(m.task_id, P.ROUTE_CLOSE, reply)
                if post is not None:
                    post()
        except (ValueError, UnicodeDecodeError):
            pass  # one malformed sub-message must not hurt the batch
        return ts

    def _serve_journal(self, conn: socket.socket, standby_id: str) -> None:
        """Stream the journal to a warm standby: ACK, then every frame the
        journal's writer hands this subscription (a snapshot first, then
        each record in commit order; the ``tick`` records are the standby's
        keepalive).  With no journal the channel is refused (closed with no
        ACK): a misconfigured standby must not sync an empty state."""
        if self.journal is None:
            if not self.quiet:
                print(f"[tracker] standby {standby_id} asked for the journal but journaling "
                      "is off (pass journal= or rabit_ha_journal); refusing", flush=True)
            conn.close()
            return
        try:
            conn.sendall(P.put_u32(P.ACK))
        except OSError:
            conn.close()
            return
        sub = self.journal.subscribe()
        with self._lock:
            self._journal_conns.append(conn)
        if not self.quiet:
            print(f"[tracker] standby {standby_id} journal channel up", flush=True)
        try:
            while not self._done.is_set():
                try:
                    frame = sub.get(timeout=0.25)
                except queue.Empty:
                    continue
                if isinstance(frame, threading.Event):
                    frame.set()  # a write-ahead marker: what came before it is sent
                    continue
                conn.sendall(frame)
        except OSError:
            pass
        finally:
            self.journal.unsubscribe(sub)
            with self._lock:
                if conn in self._journal_conns:
                    self._journal_conns.remove(conn)
            conn.close()
            # a gone stream holds no write-ahead wait up
            while True:
                try:
                    frame = sub.get_nowait()
                except queue.Empty:
                    break
                if isinstance(frame, threading.Event):
                    frame.set()

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
            if task_id not in self._shutdown_tasks:  # journaled once a task
                self._shutdown_tasks.add(task_id)
                self._journal("shutdown", task_id=task_id)
            done = self._complete_locked()
        if done:
            # the finalizer writes telemetry.json: off the serving thread,
            # which may be the reactor's loop or a relay's fold
            threading.Thread(target=self._finalize_done, daemon=True,
                             name="rabit-torch-tracker-finalize").start()

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
        """Keep the newest uploaded state as the blob a parked spare gets,
        and every upload under its sha256 digest for ``CMD_SNAP`` (computed
        here, so the store is self-certifying, and identical uploads of two
        publishers land on one entry)."""
        digest = hashlib.sha256(blob).hexdigest()
        with self._lock:
            if self._blob is None or version >= self._blob[0]:
                self._blob = (version, blob)
                self._journal("blob", version=version)
            self._snaps[digest] = blob
            self.events.append({"ts": round(time.time(), 6), "kind": "bootstrap_blob",
                                "task_id": task_id, "version": version,
                                "nbytes": len(blob)})

    # -- delivery ------------------------------------------------------------

    @staticmethod
    def _json_doc(message: str) -> dict:
        """A message's JSON object ({} when it is empty, malformed or not an
        object)."""
        try:
            req = json.loads(message) if message else {}
        except ValueError:
            req = {}
        return req if isinstance(req, dict) else {}

    def _sub_reply(self, task_id: str, message: str) -> bytes:
        """One ``CMD_SUB``: a poll gets the current line (a subscriber's
        first poll counts into ``delivery_subscribers``); a ``publish``
        registers a line no older than the current one, journals it and
        says (``have``) whether the digest's bytes are held.  The threaded
        path, the reactor and the relay fold all serve through this."""
        req = self._json_doc(message)
        pub = req.get("publish")
        if isinstance(pub, dict):
            try:
                line = {"version": int(pub.get("version", 0)),
                        "epoch": int(pub.get("epoch", 0)),
                        "digest": str(pub.get("digest", "")), "size": int(pub.get("size", 0))}
            except TypeError as exc:  # closed unanswered, as a malformed number is
                raise ValueError(f"malformed publish: {exc}") from exc
            with self._lock:
                if self._delivery is None or line["version"] >= self._delivery["version"]:
                    self._delivery = line
                    self._journal("snapshot_published", **line)
                    self.events.append({"ts": round(time.time(), 6),
                                        "kind": "snapshot_published", "task_id": task_id,
                                        **line})
                reply = dict(self._delivery)
                reply["have"] = line["digest"] in self._snaps
            return P.put_u32(P.ACK) + P.put_str(json.dumps(reply))
        with self._lock:
            line = (dict(self._delivery) if self._delivery is not None
                    else {"version": 0, "epoch": 0, "digest": "", "size": 0})
            new_sub = task_id not in self._sub_ids
            self._sub_ids.add(task_id)
        if new_sub:
            obs_stream.stream_count("delivery_subscribers", 1, job="")
        return P.put_u32(P.ACK) + P.put_str(json.dumps(line))

    def _snap_reply(self, task_id: str, message: str) -> bytes:
        """One ``CMD_SNAP``: the requested window of a held digest's bytes
        as a snap frame (no ACK before it).  An unknown digest answers an
        empty frame: the line is registered before its bytes land, and a
        promoted standby holds the line before anyone re-pushes the bytes,
        so absence is a race the subscriber retries past."""
        req = self._json_doc(message)
        digest = str(req.get("digest", ""))
        with self._lock:
            blob = self._snaps.get(digest)
        if blob is None:
            return P.put_snap_frame("", 0, 0, b"")
        try:
            off = max(int(req.get("off", 0)), 0)
            ln = int(req.get("len", 0) or 0)
        except TypeError as exc:  # closed unanswered, as a malformed number is
            raise ValueError(f"malformed fetch: {exc}") from exc
        chunk = blob[off:off + ln] if ln > 0 else blob[off:]
        with self._lock:
            if digest not in self._fetched_digests:
                # one event a digest: a swarm must not flood the timeline
                self._fetched_digests.add(digest)
                self.events.append({"ts": round(time.time(), 6), "kind": "snapshot_fetched",
                                    "task_id": task_id, "digest": digest,
                                    "nbytes": len(blob)})
        obs_stream.stream_count("delivery_bytes_served", len(chunk), job="", digest=digest)
        return P.put_snap_frame(digest, len(blob), off, chunk)

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
            prev = self._leases.get(task_id)
            self._leases[task_id] = _Lease(
                time.monotonic() + P.LEASE_FACTOR * interval, interval, rank)
            # Grants and changes are journaled, not renewals: the deadline is
            # wall-clock and re-arms fresh at a takeover.
            if prev is None or prev.interval != interval or prev.rank != rank:
                self._journal("lease", task_id=task_id, interval=interval, rank=rank)

    def _lease_monitor(self) -> None:
        next_tick = time.monotonic() + self._ha_tick_sec
        while not self._done.wait(0.05):
            now = time.monotonic()
            if self.journal is not None and now >= next_tick:
                # the keepalive: an idle primary must not look dead to its
                # standby
                next_tick = now + self._ha_tick_sec
                self._journal("tick")
            self._lease_tick(now)

    def _lease_tick(self, now: float) -> None:
        """One scan: an expired lease is removed before ``on_suspect``
        fires, so one hang gives exactly one suspicion (the restarted life
        takes a lease of its own)."""
        expired: list[tuple[str, _Lease]] = []
        with self._lock:
            for task_id, lease in list(self._leases.items()):
                if now >= lease.expires:
                    del self._leases[task_id]
                    self._journal("lease_drop", task_id=task_id)
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
        doc = self.build_scrape(self._json_doc(message))
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
        the link flags, the quorum records still owed, the delivery line with
        the digest store's size and the subscribers seen, the rollup and the
        incidents."""
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
                "quorum_outstanding": (len(self._quorum.outstanding())
                                       if self._quorum is not None else 0),
                "link_flags": len(self._link_flags),
                "n_events": len(self.events),
                "n_snapshots": len(self.snapshots),
                "messages_dropped": self.messages_dropped,
                "delivery": {
                    "line": dict(self._delivery) if self._delivery is not None else None,
                    "snaps": len(self._snaps),
                    "snap_bytes": sum(len(b) for b in self._snaps.values()),
                    "subscribers": len(self._sub_ids)},
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
            "serving": {"reactor": self._reactor, "backlog": self.backlog, **serve},
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
            self._fold_delta_doc(obs_stream.delta_doc("", rank, delta))

    def _fold_delta_frame(self, payload: bytes, ts: float | None = None) -> None:
        """Fold one relay-coalesced CMD_OBS delta frame into the rollup."""
        self._fold_delta_doc(P.delta_frame_from_bytes(payload), ts)

    def _fold_delta_doc(self, doc: dict, ts: float | None = None) -> None:
        """Fold one delta document (``{"schema", "job", "ranks": {rank:
        delta}}``) into the rollup; a document of another schema is dropped
        whole.  The first fold of a rank is a ``metrics_delta_folded``
        event."""
        if doc.get("schema") != obs_stream.STREAM_SCHEMA:
            return
        stamp = ts if ts is not None else round(time.time(), 6)
        for rank, delta in doc.get("ranks", {}).items():
            if not isinstance(delta, dict):
                continue
            self._stream.fold(rank, delta, ts=stamp)
            with self._lock:
                if str(rank) not in self._delta_ranks:
                    self._delta_ranks.add(str(rank))
                    self.events.append({"ts": stamp, "kind": "metrics_delta_folded",
                                        "rank": str(rank)})

    def build_telemetry(self) -> dict:
        """The job's telemetry document: per-rank snapshots (op stats and
        latency percentiles), the waves and epochs, lease expiries,
        restarts, promotions, resizes and schedule repairs, the quorum
        records, the serving counters and relay channels, clock offsets, the
        streamed rollup and the incidents, under ``rabit_tpu``'s key
        names."""
        with self._lock:
            events = list(self.events)
            snapshots = {str(r): s for r, s in sorted(self.snapshots.items())}
            restarts = {t: n - 1 for t, n in self._n_starts.items() if n > 1}
            epochs = [{"epoch": we.epoch, "world": we.world_size}
                      for we in self.elastic.history]
            dropped = self.messages_dropped
            q_outstanding = ([list(t) for t in self._quorum.outstanding()]
                             if self._quorum is not None else [])
        with self._stats_lock:
            serve = dict(self.serve_stats)
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
            "quorum": self._quorum.spec if self._quorum is not None else "",
            "n_quorum_met": sum(1 for e in events if e["kind"] == "quorum_met"),
            "n_corrections_folded": sum(1 for e in events
                                        if e["kind"] == "correction_folded"),
            "n_corrections_dropped": sum(1 for e in events
                                         if e["kind"] == "correction_dropped"),
            # the exclusions still undelivered, [src_version, rank, world]
            "quorum_outstanding": q_outstanding,
            # the serving path, its connection and thread peaks and the
            # relays' batches
            "serving": {"reactor": self._reactor, "backlog": self.backlog, **serve},
            "messages_dropped": dropped,
            "n_relays_up": sum(1 for e in events if e["kind"] == "relay_up"),
            "n_relays_lost": sum(1 for e in events if e["kind"] == "relay_lost"),
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
        spare took its slot), is returned as a wave of no members that
        parks it as a spare."""
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
        return {"members": [], "surplus": [p]}

    def _park_spare(self, p: _Pending) -> None:
        """Park a spare: send it the cached bootstrap blob and keep its
        socket in the pool, where a promotion answers it with an
        Assignment."""
        with self._lock:
            self._drop_lease_locked(p.task_id)
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
            self._journal("spare_park", task_id=p.task_id, blob_version=version)
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
        self._journal("spare_drop", task_ids=sorted(s.task_id for s in dead))
        self.events.append({"ts": round(time.time(), 6), "kind": "spare_dropped",
                            "dropped": sorted(s.task_id for s in dead)})

    def _awaited_locked(self) -> list[str]:
        """Members of the current epoch that have not checked in to the
        forming wave but still hold a live lease.  An elastic wave waits for
        them: the members of one epoch leave it at different moments (one
        polls the grow-back flag a version later than another, one detects a
        dead peer later), and a wave that closed without a live member would
        give its slot to a spare or shrink it away, leaving the member to
        form a world of its own.  A dead member's lease lapses within
        ``LEASE_FACTOR`` intervals (or the launcher drops it at once), after
        which the promotion and shrink rules decide as before; a job
        without leases never waits here."""
        now = time.monotonic()
        pending = {p.task_id for p in self._pending}
        return sorted(t for t in self.elastic.current.rank_map
                      if t not in pending and t not in self._shutdown_tasks
                      and (lease := self._leases.get(t)) is not None and lease.expires > now)

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
        if elastic_active and self._awaited_locked():
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
        ts = round(time.time(), 6)
        # the wave's timeline entries go in when its Assignments leave
        # (_send_assignments): a tracker killed before then leaves no trace
        commit_events: list[dict] = []
        if self._quorum is not None:
            # The epoch boundary drops the corrections still owed: ranks
            # renumber and shards re-cut, so an old block can never fold.
            for sv, r, w in self._quorum.epoch_changed(wepoch.epoch):
                commit_events.append({"ts": ts, "kind": "correction_dropped",
                                      "epoch": wepoch.epoch, "src_version": sv, "rank": r,
                                      "world": w})
        restarted = []
        for p in members:
            if p.cmd == P.CMD_START:
                if self._n_starts.get(p.task_id, 0) > 0:
                    restarted.append(p.task_id)
                self._n_starts[p.task_id] = self._n_starts.get(p.task_id, 0) + 1
        commit_events.append({
            "ts": ts, "kind": "wave", "epoch": wepoch.epoch,
            "world": world, "assignments": dict(rank_map),
            "recovering": sorted(p.task_id for p in members if p.cmd == P.CMD_RECOVER),
            "restarted": sorted(restarted), "delta": delta})
        for task_id in promoted:
            commit_events.append({"ts": ts, "kind": "spare_promoted", "task_id": task_id,
                                  "rank": rank_map[task_id], "epoch": wepoch.epoch})
        if world < prev_world:
            commit_events.append({"ts": ts, "kind": "world_shrunk", "epoch": wepoch.epoch,
                                  "from": prev_world, "to": world,
                                  "lost": sorted(t for t in prev_map if t not in rank_map)})
        elif world > prev_world:
            commit_events.append({"ts": ts, "kind": "world_grown", "epoch": wepoch.epoch,
                                  "from": prev_world, "to": world,
                                  "joined": sorted(delta["joined"])})
        # The wave is the control plane's commit: one record carries what a
        # standby needs to close the same waves, and its epoch boundary
        # settles the replayed quorum ledger as epoch_changed did this one.
        self._journal("wave", epoch=wepoch.epoch, world=world, rank_map=dict(rank_map),
                      started=sorted(p.task_id for p in members if p.cmd == P.CMD_START),
                      promoted=sorted(promoted))
        return {"members": members, "world": world, "epoch": wepoch.epoch,
                "rank_map": rank_map, "surplus": surplus, "events": commit_events}

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
            self._drop_lease_locked(task_id)
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
            for src_t, dst_t in sorted(fresh):
                self._journal("link_flag", src=src_t, dst=dst_t)
        if not self.quiet:
            print(f"[tracker] link {src}->{dst} flagged degraded; repair replan armed",
                  flush=True)

    def _quorum_report(self, payload: str) -> dict:
        """Fold one ``CMD_QUORUM`` report into the records, record the
        table's events, journal a freeze (once a round) and a late delivery,
        and flag the incoming ring link of a rank late ``quorum_flag_after``
        rounds in a row (outside the lock: ``flag_link`` takes it)."""
        try:
            req = json.loads(payload)
            epoch = int(req["epoch"])
            version = int(req["v"])
            have = [int(r) for r in req.get("have", ())]
            held = [(int(sv), int(r)) for sv, r in req.get("held", ())]
        except (ValueError, TypeError, KeyError):
            return {"decided": False, "error": "malformed report"}
        late_links: list[tuple[int, int]] = []
        with self._lock:
            if self._quorum is None:
                return {"decided": False, "disabled": True}
            if epoch != self.elastic.epoch:
                # a worker a wave behind: its round is redone in the new
                # epoch, never decided against a stale world
                return {"decided": False, "stale_epoch": True}
            known = self._quorum.has_record(epoch, version)
            rec, events, flag_ranks = self._quorum.report(epoch, version, self.world_size,
                                                          have, held)
            ts = round(time.time(), 6)
            for ev in events:
                self.events.append({"ts": ts, **ev})
                if ev["kind"] == "contribution_late":
                    self._journal("quorum_late", src_version=ev["src_version"],
                                  rank=ev["rank"])
            if not known and rec.get("decided"):
                # This report froze the record, which every rank folds by: it
                # must survive a failover byte for byte.
                self._journal("quorum_freeze", epoch=epoch, version=version,
                              world=self.world_size, record=dict(rec))
            order = self._last_ring or list(range(self.world_size))
            pos = {r: i for i, r in enumerate(order)}
            for r in flag_ranks:
                if r in pos and len(order) >= 2:
                    late_links.append((order[(pos[r] - 1) % len(order)], r))
        for src, dst in late_links:
            with self._lock:
                self.events.append({"ts": round(time.time(), 6), "kind": "link_degraded",
                                    "rank": dst, "src": src, "dst": dst, "via": "quorum"})
            if not self.quiet:
                print(f"[tracker] rank {dst} persistently late under quorum; flagging "
                      f"incoming link {src}->{dst} for repair", flush=True)
            self.flag_link(src, dst)
        return rec

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

    def _send_wave_async(self, wave: dict) -> None:
        """``_send_wave`` on a thread of its own (the reactor's and the
        relay fold's callers)."""
        threading.Thread(target=self._send_wave, args=(wave,), daemon=True,
                         name="rabit-torch-tracker-wave-send").start()

    def _send_wave(self, wave: dict) -> None:
        """One Assignment a member, and a blob frame a surplus check-in
        (now parked), sent outside the lock."""
        if wave["members"]:
            self._send_assignments(wave)
        for p in wave["surplus"]:
            self._park_spare(p)

    def _send_assignments(self, wave: dict) -> None:
        world, rank_map = wave["world"], wave["rank_map"]
        peers = {rank_map[p.task_id]: (p.host, p.listen_port) for p in wave["members"]}
        splan = self._plan_schedule(world, rank_map)
        with self._lock:
            self._last_ring = list(splan.ring_order) or list(range(world))
            self._journal("sched", epoch=wave["epoch"], algo=splan.algo,
                          ring=list(self._last_ring))
        if self.journal is not None:
            # Write-ahead: the wave and its plan reach the journal file and
            # every standby's stream before an Assignment leaves, so a standby
            # promoted once a member holds the epoch never closes it again.
            self.journal.streamed(JOURNAL_WAVE_WAIT_SEC)
            if self._killed:
                # died during the wait: a dead tracker sends nothing more
                for p in wave["members"]:
                    p.conn.close()
                return
        ts = round(time.time(), 6)
        with self._lock:
            self.events.extend(wave["events"])
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
