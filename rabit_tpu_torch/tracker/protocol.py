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
"""

from __future__ import annotations

import struct

MAGIC_HELLO = 0x7AB17001
MAGIC_ASSIGN = 0x7AB17002
MAGIC_LINK = 0x7AB17003
ACK = 0

CMD_START = 1
CMD_RECOVER = 2
CMD_PRINT = 3
CMD_SHUTDOWN = 4

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
    out += [put_str(algo), put_u32(len(ring_order))]
    out += [put_i32(r) for r in ring_order]
    return b"".join(out)


def tree_topology(rank: int, world: int) -> tuple[int, list[int]]:
    """Balanced binary heap tree: parent (r-1)//2, children 2r+1 / 2r+2."""
    parent = (rank - 1) // 2 if rank > 0 else -1
    children = [c for c in (2 * rank + 1, 2 * rank + 2) if c < world]
    return parent, children
