"""The tracker: rank assignment and the bootstrap and recovery waves of
rabit's C++ engine.

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
cannot strand the others.  ``print`` messages go to ``messages``; the job
is done once every task id has shut down.

One thread accepts; each connection is served on a thread of its own.
Leases, spares and resizes, relays, the HA standby, quorum records,
delivery and telemetry are ``rabit_tpu``'s and not ported.
"""

from __future__ import annotations

import socket
import threading
import time
from collections import deque
from dataclasses import dataclass

from rabit_tpu_torch.sched import mesh_for_world, plan
from rabit_tpu_torch.tracker import protocol as P

HELLO_TIMEOUT_SEC = 60.0  # a torn hello must not pin its thread and socket forever
MAX_MESSAGES = 4096       # the print log keeps the newest


@dataclass
class _Pending:
    conn: socket.socket
    task_id: str
    listen_port: int
    host: str
    cmd: int


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
    construction; ``start`` begins serving.  The schedule is
    ``rabit_tpu``'s default (``rabit_schedule=auto`` on the near-square
    mesh model)."""

    def __init__(self, world_size: int, host: str = "127.0.0.1", port: int = 0,
                 quiet: bool = False):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self.world_size = world_size
        self.quiet = quiet
        self.messages: deque[str] = deque(maxlen=MAX_MESSAGES)
        #: one {"ts", "kind": "wave", "epoch", "world", "assignments",
        #: "recovering", "restarted"} a closed wave
        self.events: list[dict] = []
        self.epoch = -1  # the first wave is epoch 0
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1024)
        self.host, self.port = self._srv.getsockname()
        self._lock = threading.Lock()
        self._pending: list[_Pending] = []
        self._ranks: dict[str, int] = {}  # task id -> its last rank
        self._n_starts: dict[str, int] = {}  # task id -> start check-ins
        self._shutdown_tasks: set[str] = set()
        self._done = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Tracker":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="rabit-torch-tracker")
        self._thread.start()
        return self

    def wait(self, timeout: float | None = None) -> bool:
        """True once every task id has shut down."""
        return self._done.wait(timeout)

    def stop(self) -> None:
        """Stop serving and drop every held check-in."""
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
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- serving -------------------------------------------------------------

    def _serve(self) -> None:
        while not self._done.is_set():
            try:
                conn, addr = self._srv.accept()
            except OSError:
                break
            threading.Thread(target=self._handle, args=(conn, addr), daemon=True).start()

    def _handle(self, conn: socket.socket, addr) -> None:
        try:
            conn.settimeout(HELLO_TIMEOUT_SEC)
            if P.get_u32(conn) != P.MAGIC_HELLO:
                conn.close()
                return
            cmd = P.get_u32(conn)
            P.get_i32(conn)  # the worker's previous rank: its task id is the key
            task_id = P.get_str(conn)
            if cmd in (P.CMD_START, P.CMD_RECOVER):
                listen_port = P.get_u32(conn)
                conn.settimeout(None)  # held until the wave closes
                wave = self._register(_Pending(conn, task_id, listen_port, addr[0], cmd))
                if wave is not None:
                    self._send_wave(wave)
                return
            if cmd == P.CMD_PRINT:
                self._log_print(P.get_str(conn))
                conn.sendall(P.put_u32(P.ACK))
            elif cmd == P.CMD_SHUTDOWN:
                conn.sendall(P.put_u32(P.ACK))
                self._note_shutdown(task_id)
            conn.close()  # and any command the core tracker does not serve
        except (ConnectionError, OSError, ValueError):
            conn.close()

    def _log_print(self, msg: str) -> None:
        self.messages.append(msg)
        if not self.quiet:
            print(msg, end="" if msg.endswith("\n") else "\n", flush=True)

    def _note_shutdown(self, task_id: str) -> None:
        with self._lock:
            self._shutdown_tasks.add(task_id)
            done = len(self._shutdown_tasks) >= self.world_size
        if done:
            self._done.set()

    # -- waves ---------------------------------------------------------------

    def _register(self, p: _Pending) -> dict | None:
        """Admit one check-in; returns the closed wave, or None while the
        wave fills.  A check-in from a task id already pending replaces
        the stale one."""
        with self._lock:
            for stale in [q for q in self._pending if q.task_id == p.task_id]:
                stale.conn.close()
            self._pending = [q for q in self._pending if q.task_id != p.task_id]
            self._pending.append(p)
            if len(self._pending) < self.world_size:
                return None
            self._purge_dead_locked()
            if len(self._pending) < self.world_size:
                return None
            return self._close_wave_locked()

    def _purge_dead_locked(self) -> None:
        dead = [p for p in self._pending if _conn_dead(p.conn)]
        for p in dead:
            p.conn.close()
        self._pending = [p for p in self._pending if p not in dead]

    def _close_wave_locked(self) -> dict:
        world = self.world_size
        # Members: check-ins holding a rank of this world first, then in
        # check-in order; any others wait for the next wave.
        order = sorted(range(len(self._pending)), key=lambda i: (
            not 0 <= self._ranks.get(self._pending[i].task_id, -1) < world, i))
        chosen = sorted(order[:world])
        members = [self._pending[i] for i in chosen]
        self._pending = [self._pending[i] for i in sorted(order[world:])]
        self._ranks.update(assign_ranks([(p.task_id, p.host) for p in members], world,
                                        self._ranks))
        rank_map = {p.task_id: self._ranks[p.task_id] for p in members}
        self.epoch += 1
        restarted = []
        for p in members:
            if p.cmd == P.CMD_START:
                if self._n_starts.get(p.task_id, 0) > 0:
                    restarted.append(p.task_id)
                self._n_starts[p.task_id] = self._n_starts.get(p.task_id, 0) + 1
        self.events.append({
            "ts": round(time.time(), 6), "kind": "wave", "epoch": self.epoch,
            "world": world, "assignments": dict(rank_map),
            "recovering": sorted(p.task_id for p in members if p.cmd == P.CMD_RECOVER),
            "restarted": sorted(restarted)})
        return {"members": members, "world": world, "epoch": self.epoch,
                "rank_map": rank_map}

    def _send_wave(self, wave: dict) -> None:
        """One Assignment a member, sent outside the lock."""
        world, rank_map = wave["world"], wave["rank_map"]
        peers = {rank_map[p.task_id]: (p.host, p.listen_port) for p in wave["members"]}
        splan = plan(world, "auto", mesh=mesh_for_world(world))
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
