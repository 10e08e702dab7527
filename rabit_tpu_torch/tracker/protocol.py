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

Quorum rounds (``quorum``):

      CMD_QUORUM:              str JSON report ``{"epoch": E, "v": V, "have":
                               [ranks], "held": [[src_v, rank], ...]}`` (the
                               ranks whose version-V blocks the worker holds,
                               and the late blocks of earlier rounds it could
                               fold); answered with u32 ACK and a str JSON
                               record: ``{"decided": true, "epoch", "version",
                               "k", "excluded", "corrections"}``, frozen by the
                               first report that meets the quorum, or
                               ``{"decided": false, ...}`` (``disabled`` with
                               no quorum table, ``stale_epoch`` for a report
                               of another epoch).

The delivery plane (``delivery``):

      CMD_SUB:                 str JSON: a reader's poll (``{}``) or a
                               writer's ``{"publish": {"version", "epoch",
                               "digest", "size"}}``; answered with u32 ACK and
                               a str JSON version line ``{"version", "epoch",
                               "digest", "size"}`` (version 0: nothing
                               published yet), a publish's reply with
                               ``have``: whether the tracker already holds the
                               digest's bytes (the publisher then skips its
                               upload);
      CMD_SNAP:                str JSON ``{"digest", "off", "len"}`` (off and
                               len optional: the whole blob); answered with
                               one snap frame and no ACK (``put_snap_frame``:
                               MAGIC_SNAP, str digest, u32 total size, u32
                               offset, u32 nbytes, the chunk); an unknown
                               digest answers an empty frame (digest "", total
                               0), a retryable absence.

The HA standby's channel (``ha``):

      CMD_JOURNAL:             nothing more; answered with u32 ACK and then a
                               stream of journal frames (``put_journal_frame``:
                               the RJL1 header, a crc over the encoded payload,
                               the codec-compressed JSON record), a snapshot of
                               the control state first, then every mutation
                               as it commits and a ``tick`` every
                               ``rabit_ha_tick_sec``.  A tracker that journals
                               nothing closes the connection unanswered.

The relay tier (``relay``): a relay checks in with ``CMD_BATCH`` (its id as
the task id, nothing more), is answered with u32 ACK, and the connection
then carries framed traffic both ways:

      relay -> tracker:        one batch envelope a flush (``put_batch_frame``:
                               u32 n, then per sub-message str task_id, u32
                               cmd, i32 prev_rank, str host (the child's, for
                               the peer table), u32 listen_port, u32 nbytes +
                               payload, str recv_ts).  Heartbeats, metrics,
                               prints and shutdowns the relay terminated,
                               parked START / RECOVER / SPARE check-ins, quorum
                               reports (under ``q#<task id>``), one CMD_OBS
                               delta frame a job (``put_delta_frame``, under
                               ``<job>/#delta``) and ``CMD_HANGUP``, a parked
                               child's EOF;
      tracker -> relay:        route frames (``put_route_frame``: str task_id,
                               u32 flags, u32 nbytes + payload) that deliver a
                               reply (an Assignment, a park frame, a quorum
                               record) to the parked child, closing it when
                               ``flags & ROUTE_CLOSE``; task id "" is the batch
                               ACK, JSON ``{"server_ts", "acks", "epoch",
                               "world", "rewave"}``.

The event-loop serving paths (the tracker's reactor, the relay's child loop)
parse a hello incrementally: ``hello_parser`` under a ``StreamParser``, whose
``rest()`` carries the bytes a client pipelined behind its hello.

A START or RECOVER check-in that the wave has no slot for is answered with
a blob frame too: it is parked as a spare on the same socket.  Workers of
an elastic job link to their ring neighbours with the handshake u32
MAGIC_LINK, i32 rank, u32 epoch (a dialer of another epoch is dropped).  A
quorum round's successor that waited past its deadline dials around its
silent predecessor with u32 MAGIC_SKIP, i32 rank, u32 epoch, u32 version
(``put_skip_frame``), and the acceptor tees every tagged block onto that
socket.  ``Assignment`` reads a whole Assignment back.  ``put_block_frame``
tags a quorum round's payload with (version, origin rank).

Python-side messages go through ``tracker_rpc``: one connection each,
every socket operation bounded, transport failures retried with jittered
exponential backoff, rotating through the failover list ``addrs``
(``rabit_tracker_addrs``: the primary first, then its warm standby;
``parse_addrs``).
"""

from __future__ import annotations

import json
import random
import socket
import struct
import time
import zlib
from dataclasses import dataclass, field

MAGIC_HELLO = 0x7AB17001
MAGIC_ASSIGN = 0x7AB17002
MAGIC_LINK = 0x7AB17003
MAGIC_BLOB = 0x7AB17004
MAGIC_SKIP = 0x7AB17005
MAGIC_DELTA = 0x7AB17006
MAGIC_SNAP = 0x7AB17007
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
CMD_QUORUM = 10
#: A warm standby asking to tail the tracker's control-plane journal.
CMD_JOURNAL = 13
#: A relay's persistent channel (its hello; then batch and route frames).
CMD_BATCH = 11
#: A relay's sub-message only, never a hello: a parked child hung up, so its
#: virtual connection at the tracker reads as EOF.
CMD_HANGUP = 12
#: As a hello, the live-telemetry scrape; as a relay's sub-message, one
#: coalesced metric-delta frame to fold into the rollup.
CMD_OBS = 14
#: The delivery plane's version-line poll or publish, and its
#: content-addressed snapshot fetch (``delivery``).
CMD_SUB = 15
CMD_SNAP = 16

#: Route-frame flag: close the parked child's connection after delivering.
ROUTE_CLOSE = 1

#: Commands one serving path handles and another does not, by design (the
#: threaded handler and the reactor serve the same set; the relay's batch
#: fold is the one with exceptions), limited to the commands the port
#: defines.
PARITY_EXEMPT = {
    "relay-fold": {
        "CMD_EPOCH": "never rides a batch: the relay answers epoch polls from its "
                     "ack-refreshed cache",
        "CMD_BLOB": "proxied straight through by the relay: blob uploads are large and "
                    "rare and keep the synchronous path",
        "CMD_BATCH": "a batch cannot nest inside a batch: the envelope is the relay "
                     "channel itself",
        "CMD_JOURNAL": "a standby tails the journal over a direct socket, never through "
                       "a relay",
        "CMD_SNAP": "proxied straight through by the relay with digest-keyed caching: "
                    "snapshot fetches are large and the relay serves repeat digests itself",
    },
}

#: The job key's separator inside a wire task id, ``"<job>/<task>"``; a bare
#: task id belongs to the job "".
JOB_SEP = "/"

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


def put_snap_frame(digest: str, total: int, off: int, payload: bytes) -> bytes:
    """One CMD_SNAP reply: MAGIC_SNAP, the content digest the bytes hash to,
    the blob's total size, the chunk's offset, then the chunk.  A miss is
    ``("", 0, 0, b"")``.  The same bytes go over a direct socket, a relay's
    route frame and out of the relay's digest-keyed cache."""
    return b"".join([put_u32(MAGIC_SNAP), put_str(digest), put_u32(total), put_u32(off),
                     put_u32(len(payload)), payload])


def read_snap_frame(sock) -> tuple[str, int, int, bytes]:
    """Read one snap frame off a blocking stream: ``(digest, total, off,
    chunk)``.  ValueError on a bad magic or an oversized chunk,
    ConnectionError on EOF."""
    magic = get_u32(sock)
    if magic != MAGIC_SNAP:
        raise ValueError(f"bad snap magic {magic:#x}")
    digest = get_str(sock)
    total = get_u32(sock)
    off = get_u32(sock)
    n = get_u32(sock)
    if n > 1 << 30:
        raise ValueError(f"oversized snap chunk ({n} bytes)")
    return digest, total, off, recv_exact(sock, n) if n else b""


def snap_frame_from_bytes(data: bytes) -> tuple[str, int, int, bytes]:
    """Parse one whole snap frame held in memory.  ValueError on a bad magic
    or a torn frame."""
    if len(data) < 8:
        raise ValueError(f"short snap frame ({len(data)} bytes)")
    if _U32.unpack_from(data, 0)[0] != MAGIC_SNAP:
        raise ValueError(f"bad snap magic {_U32.unpack_from(data, 0)[0]:#x}")
    dn = _U32.unpack_from(data, 4)[0]
    if len(data) < 8 + dn + 12:
        raise ValueError(f"torn snap frame ({len(data)} bytes)")
    digest = data[8:8 + dn].decode()
    total = _U32.unpack_from(data, 8 + dn)[0]
    off = _U32.unpack_from(data, 12 + dn)[0]
    n = _U32.unpack_from(data, 16 + dn)[0]
    if len(data) != 20 + dn + n:
        raise ValueError(f"torn snap frame ({len(data)} of {20 + dn + n})")
    return digest, total, off, data[20 + dn:]


def put_block_frame(version: int, origin: int, payload: bytes) -> bytes:
    """A payload tagged with its version and origin rank."""
    return _U32.pack(version) + _I32.pack(origin) + payload


def read_block_frame(data: bytes) -> tuple[int, int, bytes]:
    """Parse a tagged payload; returns (version, origin, bytes).  Raises
    ValueError on anything too short to carry the tag."""
    if len(data) < 8:
        raise ValueError(f"short block frame ({len(data)} bytes)")
    return _U32.unpack_from(data, 0)[0], _I32.unpack_from(data, 4)[0], data[8:]


def put_skip_frame(rank: int, epoch: int, version: int) -> bytes:
    """The quorum skip handshake: MAGIC_SKIP, the dialer's rank, its epoch
    and the round it is stuck on."""
    return b"".join([put_u32(MAGIC_SKIP), put_i32(rank), put_u32(epoch), put_u32(version)])


def read_skip_frame(sock) -> tuple[int, int, int]:
    """Read the skip handshake after the caller consumed MAGIC_SKIP;
    returns (dialer_rank, epoch, version)."""
    rank = get_i32(sock)
    epoch = get_u32(sock)
    version = get_u32(sock)
    return rank, epoch, version


#: The journal frame's header (``ha``): magic, codec id (``compress``'s ids,
#: 0 the identity), three pad bytes, crc32 over the ENCODED payload, its
#: length.  The crc is checked before any decode, so a torn tail record
#: reads as absent.
JOURNAL_MAGIC = b"RJL1"
_JHDR = struct.Struct("<4sBxxxII")


def put_journal_frame(kind: str, fields: dict | None = None, codec: str = "zlib") -> bytes:
    """One control-plane journal record, ``{"kind": .., <fields>}`` as
    sorted-key compact JSON, through ``codec`` behind the crc'd RJL1
    header.  The same bytes go to a journal file and a CMD_JOURNAL
    channel."""
    payload = json.dumps({"kind": kind, **(fields or {})}, sort_keys=True,
                         separators=(",", ":")).encode()
    codec_id = 0
    if codec and codec != "identity":
        from rabit_tpu_torch.compress import get_codec

        c = get_codec(codec)
        payload = c.encode_bytes(payload)
        codec_id = c.codec_id
    return _JHDR.pack(JOURNAL_MAGIC, codec_id, zlib.crc32(payload), len(payload)) + payload


def read_journal_frame(sock) -> tuple[str, dict]:
    """Read one journal frame off a blocking socket; returns ``(kind,
    fields)``.  Raises ValueError on a bad magic, a crc mismatch or an
    undecodable payload, ConnectionError at EOF."""
    magic, codec_id, crc, n = _JHDR.unpack(recv_exact(sock, _JHDR.size))
    if magic != JOURNAL_MAGIC:
        raise ValueError(f"bad journal magic {magic!r}")
    return decode_journal_payload(codec_id, crc, recv_exact(sock, n) if n else b"")


def decode_journal_payload(codec_id: int, crc: int, payload: bytes) -> tuple[str, dict]:
    """Check one journal payload's crc, then decode it to ``(kind,
    fields)``; raises ValueError when it is damaged."""
    if zlib.crc32(payload) != crc:
        raise ValueError("journal frame crc mismatch")
    if codec_id != 0:
        from rabit_tpu_torch.compress import get_codec_by_id

        try:
            payload = get_codec_by_id(codec_id).decode_bytes(payload)
        except Exception as exc:  # noqa: BLE001 (an unknown codec or a torn stream)
            raise ValueError(f"journal frame undecodable: {exc!r}")
    try:
        obj = json.loads(payload.decode())
        kind = str(obj.pop("kind"))
    except (ValueError, KeyError, UnicodeDecodeError) as exc:
        raise ValueError(f"journal record malformed: {exc!r}")
    return kind, obj


def journal_frames_from_buffer(buf: bytes) -> tuple[list[tuple[str, dict]], int, str | None]:
    """Every complete journal frame at the head of ``buf``: returns
    ``(records, consumed_bytes, error)``.  A partial tail frame is left
    unconsumed (more bytes may come); a damaged frame stops the parse with
    ``error`` set and nothing past the last good record consumed."""
    records: list[tuple[str, dict]] = []
    off = 0
    while len(buf) - off >= _JHDR.size:
        magic, codec_id, crc, n = _JHDR.unpack_from(buf, off)
        if magic != JOURNAL_MAGIC:
            return records, off, f"bad journal magic {magic!r}"
        if len(buf) - off - _JHDR.size < n:
            break  # a partial tail frame
        payload = bytes(buf[off + _JHDR.size:off + _JHDR.size + n])
        try:
            records.append(decode_journal_payload(codec_id, crc, payload))
        except ValueError as exc:
            return records, off, str(exc)
        off += _JHDR.size + n
    return records, off, None


def parse_addrs(spec: str) -> list[tuple[str, int]]:
    """A ``rabit_tracker_addrs`` value ("host:port,host:port", the primary
    first) as an address list for ``tracker_rpc``; malformed entries are
    skipped, so a bad value falls back to the primary address."""
    out: list[tuple[str, int]] = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        host, _, port_s = part.rpartition(":")
        try:
            out.append((host, int(port_s)))
        except ValueError:
            continue
    return out


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
    elif cmd in (CMD_PRINT, CMD_METRICS, CMD_HEARTBEAT, CMD_EPOCH, CMD_QUORUM, CMD_OBS,
                 CMD_SUB, CMD_SNAP):
        out.append(put_str(message))
    elif cmd == CMD_BLOB:
        out += [put_u32(blob_version), put_u32(len(blob)), blob]
    sock.sendall(b"".join(out))


def join_job(job: str, task_id: str) -> str:
    """The wire task id of ``task_id`` in job ``job`` (unchanged for "")."""
    return f"{job}{JOB_SEP}{task_id}" if job else task_id


def split_job(task_id: str) -> tuple[str, str]:
    """``(job, local task id)`` of a wire task id; ``("", task_id)`` when it
    carries no job key."""
    job, sep, rest = task_id.partition(JOB_SEP)
    return (job, rest) if sep else ("", task_id)


@dataclass
class BatchMsg:
    """One sub-message of a relay's batch envelope: the child's hello fields,
    the child's host as the relay saw it, the payload and the relay's clock
    when the child's message landed."""

    task_id: str
    cmd: int
    prev_rank: int = -1
    host: str = ""
    listen_port: int = 0
    payload: bytes = b""
    recv_ts: float = 0.0


def put_batch_frame(msgs: list[BatchMsg]) -> bytes:
    """One batch envelope (relay -> tracker)."""
    out = [put_u32(len(msgs))]
    for m in msgs:
        out += [put_str(m.task_id), put_u32(m.cmd), put_i32(m.prev_rank), put_str(m.host),
                put_u32(m.listen_port), put_u32(len(m.payload)), m.payload,
                put_str(f"{m.recv_ts:.6f}")]
    return b"".join(out)


def read_batch_frame(sock) -> list[BatchMsg]:
    """Read one batch envelope off a relay's channel."""
    msgs = []
    for _ in range(get_u32(sock)):
        task_id = get_str(sock)
        cmd = get_u32(sock)
        prev_rank = get_i32(sock)
        host = get_str(sock)
        listen_port = get_u32(sock)
        n = get_u32(sock)
        payload = recv_exact(sock, n) if n else b""
        recv_ts = float(get_str(sock) or "0")
        msgs.append(BatchMsg(task_id, cmd, prev_rank, host, listen_port, payload, recv_ts))
    return msgs


def put_route_frame(task_id: str, flags: int, payload: bytes) -> bytes:
    """One routed reply (tracker -> relay) for the child parked as
    ``task_id``; task id "" is the batch ACK."""
    return b"".join([put_str(task_id), put_u32(flags), put_u32(len(payload)), payload])


def read_route_frame(sock) -> tuple[str, int, bytes]:
    """Read one routed reply; returns ``(task_id, flags, payload)``."""
    task_id = get_str(sock)
    flags = get_u32(sock)
    n = get_u32(sock)
    return task_id, flags, recv_exact(sock, n) if n else b""


#: The most bytes one encoded delta frame may hold: a delta is a few counters
#: and fixed-bucket histograms a rank, so a larger one is torn or foreign.
DELTA_MAX_BYTES = 4 << 20


def put_delta_frame(doc: dict) -> bytes:
    """A coalesced delta document (``obs.stream.delta_doc``) as MAGIC_DELTA,
    the encoded length and zlib-compressed sorted-key compact JSON."""
    payload = zlib.compress(json.dumps(doc, sort_keys=True, separators=(",", ":")).encode())
    if len(payload) > DELTA_MAX_BYTES:
        raise ValueError(f"oversized delta frame ({len(payload)} bytes)")
    return put_u32(MAGIC_DELTA) + put_u32(len(payload)) + payload


def read_delta_frame(sock) -> dict:
    """Read one delta frame off a blocking stream; ValueError when it is
    torn or foreign, ConnectionError at EOF."""
    magic = get_u32(sock)
    if magic != MAGIC_DELTA:
        raise ValueError(f"bad delta magic {magic:#x}")
    n = get_u32(sock)
    if n > DELTA_MAX_BYTES:
        raise ValueError(f"oversized delta frame ({n} bytes)")
    return _decode_delta_payload(recv_exact(sock, n) if n else b"")


def delta_frame_from_bytes(data: bytes) -> dict:
    """Parse one whole delta frame held in memory (a CMD_OBS sub-message's
    payload); ValueError on a bad magic, a length the buffer disagrees with
    or an undecodable payload."""
    if len(data) < 8:
        raise ValueError(f"short delta frame ({len(data)} bytes)")
    magic, n = _U32.unpack_from(data, 0)[0], _U32.unpack_from(data, 4)[0]
    if magic != MAGIC_DELTA:
        raise ValueError(f"bad delta magic {magic:#x}")
    if n > DELTA_MAX_BYTES:
        raise ValueError(f"oversized delta frame ({n} bytes)")
    if len(data) != 8 + n:
        raise ValueError(f"torn delta frame ({len(data)} of {8 + n} bytes)")
    return _decode_delta_payload(data[8:])


def _decode_delta_payload(payload: bytes) -> dict:
    try:
        doc = json.loads(zlib.decompress(payload).decode())
    except (ValueError, zlib.error, UnicodeDecodeError) as exc:
        raise ValueError(f"delta frame undecodable: {exc!r}")
    if not isinstance(doc, dict):
        raise ValueError("delta frame payload is not an object")
    return doc


@dataclass
class Hello:
    """One parsed hello, the unit of work of the event-loop serving paths."""

    cmd: int
    prev_rank: int
    task_id: str
    listen_port: int = 0
    message: str = ""
    blob_version: int = 0
    blob: bytes = b""


def hello_parser():
    """An incremental parser of one hello: a generator that yields the count
    of bytes it needs next, is sent exactly that many (``StreamParser``) and
    returns a ``Hello``; ValueError on a bad magic or an oversized field."""
    magic = _U32.unpack((yield 4))[0]
    if magic != MAGIC_HELLO:
        raise ValueError(f"bad hello magic {magic:#x}")
    cmd = _U32.unpack((yield 4))[0]
    prev_rank = _I32.unpack((yield 4))[0]
    n = _U32.unpack((yield 4))[0]
    if n > 1 << 16:
        raise ValueError(f"oversized task_id ({n} bytes)")
    task_id = (yield n).decode() if n else ""
    if cmd in (CMD_START, CMD_RECOVER, CMD_SPARE):
        return Hello(cmd, prev_rank, task_id, listen_port=_U32.unpack((yield 4))[0])
    if cmd in (CMD_PRINT, CMD_METRICS, CMD_HEARTBEAT, CMD_EPOCH, CMD_QUORUM, CMD_OBS, CMD_SUB,
               CMD_SNAP):
        n = _U32.unpack((yield 4))[0]
        if n > 64 << 20:
            raise ValueError(f"oversized message ({n} bytes)")
        return Hello(cmd, prev_rank, task_id, message=(yield n).decode() if n else "")
    if cmd == CMD_BLOB:
        version = _U32.unpack((yield 4))[0]
        n = _U32.unpack((yield 4))[0]
        if n > 1 << 30:
            raise ValueError(f"oversized blob ({n} bytes)")
        return Hello(cmd, prev_rank, task_id, blob_version=version,
                     blob=(yield n) if n else b"")
    # CMD_SHUTDOWN, CMD_BATCH, CMD_JOURNAL and any other: the base hello is all
    return Hello(cmd, prev_rank, task_id)


class StreamParser:
    """Drives a byte-count parser (``hello_parser``) over a non-blocking
    stream: ``feed`` the chunks as they arrive; once the parser returns,
    ``done`` is set, ``result`` holds its value and ``rest()`` the bytes
    received past the message."""

    def __init__(self, gen):
        self._gen = gen
        self._need = next(gen)
        self._buf = bytearray()
        self.done = False
        self.result = None

    def feed(self, data: bytes) -> bool:
        """Feed newly received bytes; True once the message is parsed."""
        self._buf += data
        if self.done:
            return True
        while len(self._buf) >= self._need:
            chunk = bytes(self._buf[:self._need])
            del self._buf[:self._need]
            try:
                self._need = self._gen.send(chunk)
            except StopIteration as stop:
                self.result = stop.value
                self.done = True
                return True
        return False

    def rest(self) -> bytes:
        """The bytes received past the parsed message (a client that
        pipelined its next bytes behind its hello)."""
        return bytes(self._buf)


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
                prev_rank: int = -1, listen_port: int = 0, message: str = "",
                blob: bytes = b"", blob_version: int = 0, timeout: float = 10.0,
                reply_timeout: float | None = None, retries: int = 5,
                backoff: float = 0.1, backoff_cap: float = 2.0,
                rng: random.Random | None = None,
                addrs: list[tuple[str, int]] | None = None, job: str = ""):
    """One Python-side tracker message (a bootstrap check-in, print,
    metrics, heartbeat, shutdown, epoch poll, blob upload, quorum report,
    scrape, delivery poll or publish, snapshot fetch), the counterpart of ``rabit_tpu.tracker.protocol.tracker_rpc``.
    A spare's check-in does not ride this path: its socket stays open
    (``elastic.client``).

    One RPC is a fresh connection, the hello and the reply; ``timeout``
    bounds the connect and every control reply, and ``reply_timeout``
    (default: ``timeout``) the wait for a START / RECOVER Assignment, which
    the tracker holds until the wave closes.  Transport failures (refused,
    reset, a torn reply, a timed-out read) are retried up to ``retries``
    more times after ``backoff * 2^attempt`` seconds (capped at
    ``backoff_cap``, scaled by a uniform 0.5-1.0 drawn from ``rng``, default
    the ``random`` module, so a restart wave does not stampede the
    tracker); when the budget is spent, :class:`TrackerUnreachable`.
    Retrying a check-in is safe: the tracker replaces a task id's stale
    pending check-in.  ``addrs`` is the failover list
    (``rabit_tracker_addrs``): attempt i goes to candidate i mod n of
    ``(host, port)`` followed by the new addresses of ``addrs``, so a dead
    primary costs one attempt and the next lands on its standby with no
    backoff between them when the dead one refused the dial.  ``job``
    is the multi-job key, joined into the wire task id (``join_job``: job
    "tenant", task "0" arrive as "tenant/0").

    Returns the :class:`Assignment` for START and RECOVER, the ACK, as a
    :class:`TimedAck` for METRICS and HEARTBEAT, the reply's dict for EPOCH
    (``{"epoch", "world", "rewave"}``), QUORUM (the round's record), OBS
    (the scrape document) and SUB (the version line), and for SNAP the snap
    frame's ``(digest, total, off, chunk)``, which comes with no ACK."""
    if cmd not in (CMD_START, CMD_RECOVER, CMD_PRINT, CMD_SHUTDOWN, CMD_METRICS,
                   CMD_HEARTBEAT, CMD_EPOCH, CMD_BLOB, CMD_QUORUM, CMD_OBS, CMD_SUB,
                   CMD_SNAP):
        raise ValueError(f"tracker_rpc does not send command {cmd}")
    task_id = join_job(job, task_id)
    rng = rng if rng is not None else random
    retries = max(int(retries), 0)
    cands = [(host, int(port))]
    for a in addrs or []:
        t = (a[0], int(a[1]))
        if t not in cands:
            cands.append(t)
    last_err: Exception | None = None
    for attempt in range(retries + 1):
        host, port = cands[attempt % len(cands)]
        try:
            with socket.create_connection((host, int(port)), timeout=timeout) as sock:
                sock.settimeout(timeout)
                t_send = time.time()
                send_hello(sock, cmd, task_id, prev_rank=prev_rank,
                           listen_port=listen_port, message=message, blob=blob,
                           blob_version=blob_version)
                if cmd in (CMD_START, CMD_RECOVER):
                    sock.settimeout(reply_timeout if reply_timeout is not None else timeout)
                    return Assignment.recv(sock)
                if cmd == CMD_SNAP:
                    return read_snap_frame(sock)
                ack = get_u32(sock)
                if cmd in (CMD_METRICS, CMD_HEARTBEAT):
                    server_ts = float(get_str(sock))
                    return TimedAck(ack, server_ts, t_send, time.time())
                if cmd in (CMD_EPOCH, CMD_QUORUM, CMD_OBS, CMD_SUB):
                    return json.loads(get_str(sock))
                return ack
        except (ConnectionError, OSError) as exc:  # socket.timeout is an OSError
            last_err = exc
            # a refused dial names no live tracker to spare: the first pass
            # over the failover list goes on at once, later retries back off
            if attempt < retries and not (isinstance(exc, ConnectionRefusedError)
                                          and attempt + 1 < len(cands)):
                delay = min(backoff * (2 ** attempt), backoff_cap)
                time.sleep(delay * (0.5 + 0.5 * rng.random()))
    raise TrackerUnreachable(
        f"tracker {host}:{port} unreachable: {retries + 1} attempt(s) failed "
        f"(cmd={cmd}, task_id={task_id!r}); last error: {last_err!r}")
