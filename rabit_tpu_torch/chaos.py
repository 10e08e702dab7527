"""The chaos proxy: scriptable TCP fault injection.

The port's own copy of ``FaultSpec`` and ``ChaosProxy`` from
``rabit_tpu/chaos.py``.  A :class:`ChaosProxy` sits between workers and the
tracker, or between peers, forwards the byte streams and injects the
network faults of real incidents:

* **refuse**: a new connection is accepted and closed at once;
* **delay**: every forwarded chunk waits a sampled latency first;
* **truncate**: the client-to-upstream stream is cut after a sampled
  prefix, mid-message;
* **blackhole**: the connection stays open but nothing is forwarded;
* **partition**: a switch; while on, new connections are refused and
  every established one is cut;
* **slow_link**: one direction of one peer link is slow: only the
  client-to-upstream direction is delayed, and, when the proxy fronts a
  worker's listen socket, only for the dialer whose MAGIC_LINK hello names
  a chosen source rank.  This is the fault the schedule's degraded-link
  repair routes around: an ``ElasticWorker`` that advertises the proxy's
  port (``advertise_port``) gets its incoming link from that rank slowed.

All randomness comes from one seeded ``random.Random``, so a failing
schedule replays.  Pure stdlib and threads: a connection costs two pump
threads.  ``rabit_tpu``'s schedule runners (``run_schedule``,
``run_elastic_schedule``) and its relay and failover faults wait for the
planes they drive (ROADMAP.md Queue 1 item 10h).
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

from rabit_tpu_torch.tracker import protocol as P

#: recv chunk size of the pump loops; also the granularity of delay faults.
_CHUNK = 4096

#: link-hello field codecs (same layout as protocol.py's MAGIC_LINK frame)
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")


@dataclass
class FaultSpec:
    """Probabilities/ranges of the injected faults.  Mutable at runtime:
    assigning a fresh spec to ``proxy.spec`` re-scripts the proxy live
    (e.g. heavy faults during bootstrap, then heal)."""

    p_refuse: float = 0.0
    p_truncate: float = 0.0
    truncate_bytes: tuple[int, int] = (0, 64)
    p_blackhole: float = 0.0
    delay: tuple[float, float] = (0.0, 0.0)
    #: asymmetric per-link slowness: ``(src_rank, delay_s)`` delays every
    #: client->upstream chunk of connections whose MAGIC_LINK hello names
    #: ``src_rank`` as the dialer (``src_rank=None`` delays the c2u
    #: direction of EVERY connection — the one-way-congested tracker
    #: path).  A proxy with slow_link set is a dedicated link proxy: the
    #: sampled faults above do not apply to it.
    slow_link: tuple[int | None, float] | None = None

    def clear(self) -> "FaultSpec":
        return FaultSpec()


@dataclass
class ChaosStats:
    connections: int = 0
    refused: int = 0
    truncated: int = 0
    blackholed: int = 0
    severed_by_partition: int = 0
    bytes_forwarded: int = 0
    slowed: int = 0  # connections whose c2u direction got the slow_link


@dataclass
class _Conn:
    client: socket.socket
    upstream: socket.socket
    closed: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock)

    def sever(self) -> None:
        with self.lock:
            if self.closed:
                return
            self.closed = True
        for s in (self.client, self.upstream):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class ChaosProxy:
    """TCP proxy with scriptable fault injection (see module docstring).

    Usage::

        proxy = ChaosProxy((tracker.host, tracker.port),
                           FaultSpec(p_refuse=0.3), seed=7).start()
        ...point workers at (proxy.host, proxy.port)...
        proxy.spec = FaultSpec()        # heal mid-run
        proxy.set_partition(True)       # or cut everything
        proxy.stop()
    """

    def __init__(self, upstream: tuple[str, int],
                 spec: FaultSpec | None = None, seed: int = 0,
                 listen_host: str = "127.0.0.1", listen_port: int = 0):
        self.upstream = (upstream[0], int(upstream[1]))
        self.spec = spec if spec is not None else FaultSpec()
        self.stats = ChaosStats()
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._partitioned = False
        self._stopped = threading.Event()
        self._conns: list[_Conn] = []
        self._conns_lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((listen_host, listen_port))
        self._srv.listen(128)
        self.host, self.port = self._srv.getsockname()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ChaosProxy":
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="chaos-accept").start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            c.sever()

    def set_partition(self, on: bool) -> None:
        """While partitioned, refuse new connections and sever live ones."""
        self._partitioned = bool(on)
        if on:
            with self._conns_lock:
                conns, self._conns = self._conns, []
            for c in conns:
                self.stats.severed_by_partition += 1
                c.sever()

    # -- internals ---------------------------------------------------------

    def _roll(self) -> random.Random:
        # One shared seeded stream; per-decision access is serialized so a
        # given seed yields a reproducible fault sequence for a (mostly)
        # deterministic connection order.
        return self._rng

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                client, _ = self._srv.accept()
            except OSError:
                return
            self.stats.connections += 1
            with self._rng_lock:
                refuse = (self._partitioned or
                          self._roll().random() < self.spec.p_refuse)
            if refuse:
                self.stats.refused += 1
                try:
                    client.close()
                except OSError:
                    pass
                continue
            threading.Thread(target=self._serve_conn, args=(client,),
                             daemon=True, name="chaos-conn").start()

    @staticmethod
    def _peek_link_hello(client: socket.socket) -> tuple[bytes, int | None]:
        """Read the 12-byte MAGIC_LINK hello (magic, rank, epoch) off a
        fresh peer-link connection.  Returns (bytes read, dialer rank or
        None); the bytes are forwarded upstream by the caller, so the
        handshake is observed, never consumed."""
        head = b""
        try:
            client.settimeout(5.0)
            while len(head) < 12:
                chunk = client.recv(12 - len(head))
                if not chunk:
                    break
                head += chunk
        except OSError:
            return head, None
        if len(head) < 8:
            return head, None
        magic = _U32.unpack_from(head, 0)[0]
        if magic != P.MAGIC_LINK:
            return head, None
        return head, _I32.unpack_from(head, 4)[0]

    def _serve_conn(self, client: socket.socket) -> None:
        spec = self.spec
        head = b""
        c2u_delay: tuple[float, float] | None = None
        if spec.slow_link is not None:
            # Dedicated link proxy: identify the dialer from the link
            # hello, delay only the matching client->upstream direction.
            src_rank, slow_s = spec.slow_link
            dialer = None
            if src_rank is not None:
                head, dialer = self._peek_link_hello(client)
            if src_rank is None or dialer == src_rank:
                c2u_delay = (float(slow_s), float(slow_s))
                self.stats.slowed += 1
        try:
            up = socket.create_connection(self.upstream, timeout=5.0)
        except OSError:
            try:
                client.close()
            except OSError:
                pass
            return
        conn = _Conn(client, up)
        with self._conns_lock:
            self._conns.append(conn)
        if spec.slow_link is not None:
            if head:
                try:
                    up.sendall(head)
                    self.stats.bytes_forwarded += len(head)
                except OSError:
                    conn.sever()
                    return
            threading.Thread(
                target=self._pump,
                args=(conn, client, up, None, c2u_delay or (0.0, 0.0)),
                daemon=True, name="chaos-pump-c2u").start()
            threading.Thread(
                target=self._pump, args=(conn, up, client, None, (0.0, 0.0)),
                daemon=True, name="chaos-pump-u2c").start()
            return
        with self._rng_lock:
            rng = self._roll()
            blackhole = rng.random() < spec.p_blackhole
            truncate_at = None
            if rng.random() < spec.p_truncate:
                truncate_at = rng.randint(*spec.truncate_bytes)
            delays = spec.delay
        if blackhole:
            # Forward nothing, close nothing: the silent-partition shape.
            # The conn stays registered so stop()/partition() reap it, and
            # both endpoints see only their own deadlines.
            self.stats.blackholed += 1
            return
        if truncate_at is not None:
            self.stats.truncated += 1
        threading.Thread(
            target=self._pump, args=(conn, client, up, truncate_at, delays),
            daemon=True, name="chaos-pump-c2u").start()
        threading.Thread(
            target=self._pump, args=(conn, up, client, None, delays),
            daemon=True, name="chaos-pump-u2c").start()

    def _pump(self, conn: _Conn, src: socket.socket, dst: socket.socket,
              truncate_at: int | None, delays: tuple[float, float]) -> None:
        budget = truncate_at
        try:
            try:
                src.settimeout(0.2)  # poll the stop/partition flags
            except OSError:
                return  # the sibling pump already severed this conn
            while not self._stopped.is_set() and not conn.closed:
                try:
                    data = src.recv(_CHUNK)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                if delays[1] > 0:
                    with self._rng_lock:
                        pause = self._roll().uniform(*delays)
                    if pause > 0:
                        time.sleep(pause)
                if budget is not None:
                    data = data[:budget]
                    budget -= len(data)
                try:
                    if data:
                        dst.sendall(data)
                        self.stats.bytes_forwarded += len(data)
                except OSError:
                    break
                if budget == 0:
                    break  # prefix forwarded; sever mid-message
        finally:
            conn.sever()
