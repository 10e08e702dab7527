"""The tracker's wire format: the core of ``rabit_tpu/tracker/protocol.py``
that rabit's C++ engine speaks (``native/src/comm.h``, ``comm.cc``).

All integers are little-endian u32 or i32; a string is its u32 byte length
and its utf-8 bytes.  A worker opens a fresh connection for each message:

    u32 MAGIC_HELLO, u32 cmd, i32 prev_rank (-1 before an assignment),
    str task_id, then
      CMD_START / CMD_RECOVER: u32 listen_port (the worker listens before
                               it checks in); answered with an Assignment
                               once the wave of world_size check-ins is
                               complete;
      CMD_PRINT:               str message; answered with u32 ACK;
      CMD_SHUTDOWN:            nothing more; answered with u32 ACK.

An Assignment is ``assignment_head_bytes`` (MAGIC_ASSIGN, the rank, the
world, the tree parent and children, the ring neighbours) followed by
``assignment_tail_bytes``, the same for every member of a wave: the peer
table, the wave's epoch, the epoch's task-id -> rank map and the planned
schedule (algorithm name, ring order).  The C++ client reads through the
epoch and closes; the fields behind it are for schedule-aware clients, and
the bytes are those ``rabit_tpu``'s tracker sends.

The observability commands carry a message like a print, and their ACK is
followed by the tracker's clock as a string (``TimedAck``):

      CMD_METRICS:             str JSON snapshot (``obs.ship.build_snapshot``);
      CMD_HEARTBEAT:           str decimal lease interval in seconds (0 or
                               less grants no lease: a clock ping).

A lease lapses after ``LEASE_FACTOR`` intervals without a renewal.

The elastic plane's commands (``elastic``):

      CMD_SPARE:               u32 listen_port; answered at once with a blob
                               frame (``put_blob_frame``: MAGIC_BLOB, u32
                               version, u32 nbytes, the cached bootstrap
                               blob; version 0 and no bytes when none is
                               cached), after which the connection stays
                               open (a warm socket) until the spare is
                               promoted, with an Assignment, or released;
      CMD_EPOCH:               str version (the worker's committed version);
                               answered with u32 ACK and a str JSON
                               ``{"epoch", "world", "rewave"}``: rewave asks
                               the worker to re-enter a wave at this version
                               boundary (a grow-back or a schedule repair is
                               waiting);
      CMD_BLOB:                u32 version, u32 nbytes, the bytes of the
                               current state, compressed by the sender;
                               answered with u32 ACK.  The tracker keeps the
                               newest as the blob a parked spare receives.

The live scrape (``obs.top``):

      CMD_OBS:                 str JSON options (``{"registry": false}``
                               skips the registry section); answered with
                               u32 ACK and a str JSON scrape document
                               (``Tracker.build_scrape``).

A START or RECOVER check-in that the wave has no slot for is answered with
a blob frame too: it is parked as a spare on the same socket.  Workers of
an elastic job link to their ring neighbours with the handshake u32
MAGIC_LINK, i32 rank, u32 epoch (a dialer of another epoch is dropped).
``Assignment`` reads a whole Assignment back.  ``put_block_frame`` tags a
payload with (version, origin rank) as ``rabit_tpu``'s quorum rounds do.

Python-side messages go through ``tracker_rpc``: one connection each,
every socket operation bounded, transport failures retried with jittered
exponential backoff.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import time
from dataclasses import dataclass, field

MAGIC_HELLO = 0x7AB17001
MAGIC_ASSIGN = 0x7AB17002
MAGIC_LINK = 0x7AB17003
MAGIC_BLOB = 0x7AB17004
ACK = 0

CMD_START = 1
CMD_RECOVER = 2
CMD_PRINT = 3
CMD_SHUTDOWN = 4
CMD_METRICS = 5
CMD_HEARTBEAT = 6
CMD_SPARE = 7
CMD_EPOCH = 8
CMD_BLOB = 9
#: The live-telemetry scrape (the hello only: ``rabit_tpu``'s relays also
#: carry CMD_OBS delta frames, which wait for the relays' port).
CMD_OBS = 14

#: How many renewal intervals a lease survives without a renewal.  2 means
#: one lost or late heartbeat is tolerated; the second expires the lease, so
#: a frozen worker is suspected within 2 x rabit_heartbeat_sec.
LEASE_FACTOR = 2.0

_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")


def recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed connection")
        buf.extend(chunk)
    return bytes(buf)


def put_u32(v: int) -> bytes:
    return _U32.pack(v)


def put_i32(v: int) -> bytes:
    return _I32.pack(v)


def put_str(s: str) -> bytes:
    raw = s.encode()
    return _U32.pack(len(raw)) + raw


def get_u32(sock) -> int:
    return _U32.unpack(recv_exact(sock, 4))[0]


def get_i32(sock) -> int:
    return _I32.unpack(recv_exact(sock, 4))[0]


def get_str(sock) -> str:
    n = get_u32(sock)
    return recv_exact(sock, n).decode() if n else ""


def assignment_head_bytes(rank: int, world_size: int, parent: int,
                          children: list[int], ring_prev: int,
                          ring_next: int) -> bytes:
    """The part of an Assignment that differs between the members of a
    wave: MAGIC_ASSIGN through the ring neighbours."""
    out = [put_u32(MAGIC_ASSIGN), put_i32(rank), put_u32(world_size), put_i32(parent),
           put_u32(len(children))]
    out += [put_i32(c) for c in children]
    out += [put_i32(ring_prev), put_i32(ring_next)]
    return b"".join(out)


def assignment_tail_bytes(peers: dict[int, tuple[str, int]], epoch: int,
                          rank_map: dict[str, int], algo: str,
                          ring_order: list[int]) -> bytes:
    """The part of an Assignment every member of a wave gets: the peer
    table in rank order, the epoch, the rank map in task-id order and the
    schedule (algorithm name, ring order)."""
    out = [put_u32(len(peers))]
    for r, (host, port) in sorted(peers.items()):
        out += [put_i32(r), put_str(host), put_u32(port)]
    out.append(put_u32(epoch))
    out.append(put_u32(len(rank_map)))
    for task_id, r in sorted(rank_map.items()):
        out += [put_str(task_id), put_i32(r)]
    out.append(put_sched_frame(algo, ring_order))
    return b"".join(out)


def put_sched_frame(algo: str, ring_order: list[int]) -> bytes:
    """The Assignment's trailing schedule: the algorithm's name and the
    planned ring order (empty: the identity ring)."""
    out = [put_str(algo), put_u32(len(ring_order))]
    out += [put_i32(r) for r in ring_order]
    return b"".join(out)


def read_sched_frame(sock) -> tuple[str, list[int]]:
    """Read one trailing schedule; returns (algo, ring_order)."""
    algo = get_str(sock)
    ring_order = [get_i32(sock) for _ in range(get_u32(sock))]
    return algo, ring_order


@dataclass
class Assignment:
    """One member's Assignment, as the tracker sends it (``encode``) and a
    Python worker reads it back (``recv``, or ``recv_body`` after the
    caller has read MAGIC_ASSIGN itself)."""

    rank: int
    world_size: int
    parent: int
    children: list[int]
    ring_prev: int
    ring_next: int
    peers: dict[int, tuple[str, int]] = field(default_factory=dict)
    epoch: int = 0
    rank_map: dict[str, int] = field(default_factory=dict)
    algo: str = ""
    ring_order: list[int] = field(default_factory=list)

    def encode(self) -> bytes:
        return (assignment_head_bytes(self.rank, self.world_size, self.parent,
                                      self.children, self.ring_prev, self.ring_next)
                + assignment_tail_bytes(self.peers, self.epoch, self.rank_map,
                                        self.algo, self.ring_order))

    @classmethod
    def recv(cls, sock) -> "Assignment":
        magic = get_u32(sock)
        if magic != MAGIC_ASSIGN:
            raise ValueError(f"bad assignment magic {magic:#x}")
        return cls.recv_body(sock)

    @classmethod
    def recv_body(cls, sock) -> "Assignment":
        rank = get_i32(sock)
        world = get_u32(sock)
        parent = get_i32(sock)
        children = [get_i32(sock) for _ in range(get_u32(sock))]
        ring_prev = get_i32(sock)
        ring_next = get_i32(sock)
        peers = {}
        for _ in range(get_u32(sock)):
            r = get_i32(sock)
            host = get_str(sock)
            peers[r] = (host, get_u32(sock))
        epoch = get_u32(sock)
        rank_map = {}
        for _ in range(get_u32(sock)):
            task_id = get_str(sock)
            rank_map[task_id] = get_i32(sock)
        algo, ring_order = read_sched_frame(sock)
        return cls(rank, world, parent, children, ring_prev, ring_next, peers, epoch,
                   rank_map, algo, ring_order)


def put_blob_frame(version: int, blob: bytes) -> bytes:
    """The park reply: the cached bootstrap blob behind MAGIC_BLOB (version
    0 and no bytes when nothing is cached)."""
    return b"".join([put_u32(MAGIC_BLOB), put_u32(version), put_u32(len(blob)), blob])


def recv_blob_frame(sock) -> tuple[int, bytes]:
    """Read one blob frame; returns (version, payload)."""
    magic = get_u32(sock)
    if magic != MAGIC_BLOB:
        raise ValueError(f"bad blob magic {magic:#x}")
    version = get_u32(sock)
    n = get_u32(sock)
    return version, recv_exact(sock, n) if n else b""


def put_block_frame(version: int, origin: int, payload: bytes) -> bytes:
    """A payload tagged with its version and origin rank."""
    return _U32.pack(version) + _I32.pack(origin) + payload


def read_block_frame(data: bytes) -> tuple[int, int, bytes]:
    """Parse a tagged payload; returns (version, origin, bytes).  Raises
    ValueError on anything too short to carry the tag."""
    if len(data) < 8:
        raise ValueError(f"short block frame ({len(data)} bytes)")
    return _U32.unpack_from(data, 0)[0], _I32.unpack_from(data, 4)[0], data[8:]


def tree_topology(rank: int, world: int) -> tuple[int, list[int]]:
    """Balanced binary heap tree: parent (r-1)//2, children 2r+1 / 2r+2."""
    parent = (rank - 1) // 2 if rank > 0 else -1
    children = [c for c in (2 * rank + 1, 2 * rank + 2) if c < world]
    return parent, children


def send_hello(sock, cmd: int, task_id: str, prev_rank: int = -1,
               listen_port: int = 0, message: str = "", blob: bytes = b"",
               blob_version: int = 0) -> None:
    """One worker hello (see the module docstring)."""
    out = [put_u32(MAGIC_HELLO), put_u32(cmd), put_i32(prev_rank), put_str(task_id)]
    if cmd in (CMD_START, CMD_RECOVER, CMD_SPARE):
        out.append(put_u32(listen_port))
    elif cmd in (CMD_PRINT, CMD_METRICS, CMD_HEARTBEAT, CMD_EPOCH, CMD_OBS):
        out.append(put_str(message))
    elif cmd == CMD_BLOB:
        out += [put_u32(blob_version), put_u32(len(blob)), blob]
    sock.sendall(b"".join(out))


class TimedAck(int):
    """An ACK that carries the tracker's clock stamp (metrics and heartbeat
    replies).  Equal to the plain ACK value, so ``reply == ACK`` holds;
    ``offset`` and ``err`` are the NTP-style midpoint estimate of
    tracker_clock - worker_clock and its bound."""

    server_ts: float
    t_send: float
    t_recv: float

    def __new__(cls, ack: int, server_ts: float, t_send: float,
                t_recv: float) -> "TimedAck":
        self = super().__new__(cls, ack)
        self.server_ts = server_ts
        self.t_send = t_send
        self.t_recv = t_recv
        return self

    @property
    def rtt(self) -> float:
        return max(self.t_recv - self.t_send, 0.0)

    @property
    def offset(self) -> float:
        """tracker_ts - worker_ts; project with worker_ts + offset."""
        return self.server_ts - (self.t_send + self.t_recv) / 2.0

    @property
    def err(self) -> float:
        """Half the round trip: the offset estimate's error bound."""
        return self.rtt / 2.0


class TrackerUnreachable(ConnectionError):
    """The tracker could not be reached, or never replied, within the retry
    budget of :func:`tracker_rpc`."""


def tracker_rpc(host: str, port: int, cmd: int, task_id: str, *,
                prev_rank: int = -1, message: str = "", blob: bytes = b"",
                blob_version: int = 0, timeout: float = 10.0,
                retries: int = 5, backoff: float = 0.1, backoff_cap: float = 2.0):
    """One Python-side tracker message (print, metrics, heartbeat,
    shutdown, epoch poll, blob upload, scrape), the counterpart of
    ``rabit_tpu.tracker.protocol.tracker_rpc`` for one tracker address.
    Check-ins are refused here: the native engine and ``ElasticWorker``
    make them on sockets of their own, and a spare's stays open.

    One RPC is a fresh connection, the hello and the reply; ``timeout``
    bounds the connect and every read.  Transport failures (refused, reset,
    a torn reply, a timed-out read) are retried up to ``retries`` more
    times after ``backoff * 2^attempt`` seconds (capped at ``backoff_cap``, scaled by
    a uniform 0.5-1.0 so a restart wave does not stampede the tracker);
    when the budget is spent, :class:`TrackerUnreachable`.

    Returns the ACK, as a :class:`TimedAck` for METRICS and HEARTBEAT, and
    the reply's dict for EPOCH (``{"epoch", "world", "rewave"}``) and OBS
    (the scrape document)."""
    if cmd not in (CMD_PRINT, CMD_SHUTDOWN, CMD_METRICS, CMD_HEARTBEAT, CMD_EPOCH,
                   CMD_BLOB, CMD_OBS):
        raise ValueError(f"tracker_rpc does not send command {cmd}")
    retries = max(int(retries), 0)
    last_err: Exception | None = None
    for attempt in range(retries + 1):
        try:
            with socket.create_connection((host, int(port)), timeout=timeout) as sock:
                sock.settimeout(timeout)
                t_send = time.time()
                send_hello(sock, cmd, task_id, prev_rank=prev_rank, message=message,
                           blob=blob, blob_version=blob_version)
                ack = get_u32(sock)
                if cmd in (CMD_METRICS, CMD_HEARTBEAT):
                    server_ts = float(get_str(sock))
                    return TimedAck(ack, server_ts, t_send, time.time())
                if cmd in (CMD_EPOCH, CMD_OBS):
                    return json.loads(get_str(sock))
                return ack
        except (ConnectionError, OSError) as exc:  # socket.timeout is an OSError
            last_err = exc
            if attempt < retries:
                delay = min(backoff * (2 ** attempt), backoff_cap)
                time.sleep(delay * (0.5 + 0.5 * random.random()))
    raise TrackerUnreachable(
        f"tracker {host}:{port} unreachable: {retries + 1} attempt(s) failed "
        f"(cmd={cmd}, task_id={task_id!r}); last error: {last_err!r}")
