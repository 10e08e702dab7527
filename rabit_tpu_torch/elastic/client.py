"""The elastic worker: the Python client of the tracker's elastic plane.

The port's own copy of ``rabit_tpu/elastic/client.py``.  One
:class:`ElasticWorker` binds a listen socket, checks in (``CMD_START``, or
``CMD_SPARE`` to park in the hot-spare pool), links to its planned ring
neighbours with the epoch in the handshake, and runs a deterministic
contribute-allreduce-commit loop whose result is **bitwise the same on
every rank at every world size**: each version ring-allgathers the ranks'
contributions and folds them in rank order (``rebalance.refold``), so an
exact dtype (integer histograms) gives the same bits however the world
resized on the way.

The ring is the one the tracker planned (the Assignment's trailing
schedule; the identity ring when there is none): links go to the planned
neighbours and the gathered blocks are placed by ring position, while the
fold stays in rank order.  ``codec=`` sends each contribution through a
wire codec of ``compress`` (the same bytes on every rank, decoded and
folded in rank order).  The worker times each wait on its incoming ring
link (``link_wait_seconds{src,dst}``, streamed to the tracker on its
heartbeat) and, once those waits pass ``slow_report_share`` of the
epoch's wall time, reports the link as degraded: at most one ``slow_link``
print an epoch, which the tracker's diagnosis plane attributes and the
next wave's plan routes around.  ``advertise_port`` is the port peers are
told to dial instead of the listen port (a ``chaos.ChaosProxy`` in front of
it slows one link).

Quorum rounds (``quorum=``, ``quorum``) replace the lockstep allgather with
a straggler-tolerant round: tagged blocks ``(version, origin, payload)``
flood the planned ring, with skip links around a predecessor silent past
``quorum_wait`` (MAGIC_SKIP; the upstream rank tees its flow onto the
dialer); each round asks the tracker for its frozen K-of-N exclusion record
(``CMD_QUORUM``), waits for the blocks the record names and folds them in
rank order, a straggler's late blocks after them as corrections.  Each
outbound link sends from a queue of its own, so a block larger than the
socket buffers never stalls a ring in which every rank sends at once.  The final
round is always exact, and a rank the group has moved past skips its
contribution to a round the record already excluded it from (the bounded
catch-up).  Every fold is bitwise the same on every rank.

``tracker`` is one address or a failover list (``rabit_tracker_addrs``: the
primary, then its warm standby).  Check-ins rotate from the address that
last answered, every message goes through ``tracker_rpc``'s rotation, and
the shutdown's retries outlast a standby's takeover, so the death of the
tracker is a retry, not a lost job.

When a link fails mid-collective the epoch is abandoned: links close, the
worker checks in again with ``CMD_RECOVER``, and the next wave (the same
size after a spare's promotion, smaller after a shrink, larger after a
grow-back) re-cuts the work and resumes from the last committed version.
After every wave the ranks agree on the newest committed version and the
lowest rank that holds it sends its state around the ring to those
behind (``_sync_state``).  A parked spare starts from the bootstrap blob
the tracker hands it (rank 0 uploads its state after every commit,
``_ship_blob``) and is brought up to date the same way.  At each version
boundary the worker polls ``CMD_EPOCH`` and re-enters a wave when the
reply asks for it (a grow-back).  A worker parked because its slot was
taken, and a spare never needed, end when the tracker releases them.

Every socket operation is bounded, so being stuck is an error, not a
hang.  ``job=`` prefixes the wire task id with a job key
(``protocol.join_job``), so a multi-tenant ``CollectiveService`` routes
the worker to its job's partition; "" is the single-job namespace, byte
for byte.
"""

from __future__ import annotations

import collections
import json
import pickle
import select
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from rabit_tpu_torch.elastic.rebalance import refold
from rabit_tpu_torch.obs.metrics import MetricsRegistry
from rabit_tpu_torch.obs.ship import Heartbeat, build_snapshot, renew_lease, ship_snapshot
from rabit_tpu_torch.obs.stream import DeltaSource, stream_observe
from rabit_tpu_torch.tracker import protocol as P

#: Frames at least this long are sent from a thread while the hop receives:
#: two ranks that send each other a large frame at once must not both block
#: in ``sendall`` with full socket buffers.
_THREADED_SEND_BYTES = 1 << 16


class _LinkSender:
    """One outbound link of a quorum round: a queue of frames that a thread
    of its own sends in order.  The worker never blocks on the link, so a
    block larger than the socket buffers cannot stall a ring in which every
    rank sends at once; the pump goes on reading meanwhile.  A send that
    makes no progress for the socket's timeout ends the thread with
    ``error`` set (as does any other send error), and the queue is
    dropped."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.error: OSError | None = None
        self._queue: collections.deque[bytes] = collections.deque()
        self._busy = False
        self._closed = False
        self._cv = threading.Condition()
        threading.Thread(target=self._run, daemon=True, name="rabit-quorum-send").start()

    def put(self, data: bytes) -> None:
        with self._cv:
            if self.error is None and not self._closed:
                self._queue.append(data)
                self._cv.notify_all()

    def owes(self) -> bool:
        """Frames queued or in flight, and the link still healthy."""
        with self._cv:
            return self.error is None and (self._busy or bool(self._queue))

    def wait_sent(self, timeout: float) -> None:
        """Wait until nothing is owed, the link failed or ``timeout`` passed."""
        end = time.monotonic() + timeout
        with self._cv:
            while self.error is None and (self._busy or self._queue):
                left = end - time.monotonic()
                if left <= 0:
                    return
                self._cv.wait(left)

    def close(self) -> None:
        """Drop what is queued and end the thread; the link is shut down so
        that a send blocked on it returns now (the caller closes it)."""
        with self._cv:
            self._closed = True
            self._queue.clear()
            self._cv.notify_all()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed:
                    return
                data = memoryview(self._queue.popleft())
                self._busy = True
            try:
                while data:  # each send waits at most the socket's timeout
                    data = data[self.sock.send(data):]
            except OSError as exc:
                with self._cv:
                    self.error = exc
                    self._busy = False
                    self._queue.clear()
                    self._cv.notify_all()
                return
            with self._cv:
                self._busy = False
                self._cv.notify_all()


class EpochBroken(Exception):
    """The current epoch's links are unusable (a peer died, a stale epoch,
    a timeout): abandon the epoch and re-enter a wave."""


class Rewave(Exception):
    """The tracker asked for a wave at this version boundary (a grow-back)."""


class Released(Exception):
    """The tracker closed this worker's park: the job is done without it."""


@dataclass
class ElasticResult:
    task_id: str
    completed: bool = False
    died: bool = False
    promoted: bool = False
    parked_only: bool = False
    final_version: int = 0
    state: np.ndarray | None = None
    epochs: list[int] = field(default_factory=list)
    worlds: list[int] = field(default_factory=list)
    error: str = ""
    #: seconds spent waiting on the incoming ring link, over all epochs
    wait_prev_s: float = 0.0
    #: slow_link reports this worker sent (at most one an epoch)
    slow_reports: int = 0
    #: rounds folded under a tracker-agreed exclusion record
    quorum_rounds: int = 0
    #: rounds whose record excluded at least one rank
    excluded_rounds: int = 0
    #: late blocks (corrections) this worker folded
    corrections_folded: int = 0
    #: rounds this worker did not contribute to while catching up (the
    #: group's record had already excluded it)
    skipped_contributions: int = 0
    #: time.monotonic() of each version's commit
    commit_times: dict = field(default_factory=dict)


class ElasticWorker:
    """One participant of an elastic job (see the module docstring).

    ``contribution(version, world, rank) -> np.ndarray`` is the work of one
    version: it must cover this rank's shard of the same dataset at any
    world size (``rebalance.shard_slice`` cuts it) with a shape that does
    not depend on the world, so that the rank-order fold gives the same
    totals across resizes.  ``fail`` schedules a death: ``("die", v)``
    leaves silently before contributing to version ``v``;
    ``("die_parked",)`` is a spare that dies in the pool;
    ``("die_promoted",)`` a spare that dies the moment it is promoted,
    before any link is up.  ``tracker`` is ``(host, port)`` or a failover
    list of them; ``quorum`` is a ``rabit_quorum`` spec ("" for the exact
    rounds) and ``quorum_wait`` the round's deadline before a partial
    report and a skip dial.  ``rpc_timeout`` bounds every message to the
    tracker (a check-in's connect, an epoch poll, a blob upload, a quorum
    report, the shutdown).  ``job`` is the job key the task id is joined
    to ("j" and "0" check in as "j/0").
    """

    def __init__(
        self,
        tracker,
        task_id: str,
        contribution: Callable[[int, int, int], np.ndarray],
        niter: int,
        *,
        spare: bool = False,
        heartbeat_sec: float = 0.0,
        rpc_timeout: float = 2.0,
        wave_timeout: float = 20.0,
        link_timeout: float = 10.0,
        deadline_sec: float = 60.0,
        fail: tuple | None = None,
        advertise_port: int | None = None,
        slow_report_share: float = 0.0,
        codec: str = "",
        quorum: str = "",
        quorum_wait: float = 0.35,
        job: str = "",
    ):
        self.quorum_spec = str(quorum or "")
        if self.quorum_spec:
            from rabit_tpu_torch.quorum import parse_spec

            parse_spec(self.quorum_spec)  # a typo'd quorum fails before any socket
        if tracker and isinstance(tracker[0], (tuple, list)):
            self.addrs = [(t[0], int(t[1])) for t in tracker]
        else:
            self.addrs = [(tracker[0], int(tracker[1]))]
        self.tracker = self.addrs[0]
        self._active = 0  # the address that last answered a check-in
        self.task_id = P.join_job(job, task_id)
        self.contribution = contribution
        self.niter = int(niter)
        self.spare = bool(spare)
        self.heartbeat_sec = float(heartbeat_sec)
        self.rpc_timeout = float(rpc_timeout)
        self.wave_timeout = float(wave_timeout)
        self.link_timeout = float(link_timeout)
        self.deadline = time.monotonic() + float(deadline_sec)
        self.fail = fail
        self._stop = threading.Event()
        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind(("127.0.0.1", 0))
        self._listen.listen(16)
        self.listen_port = self._listen.getsockname()[1]
        # the port peers dial: the listen port, or a proxy's in front of it
        self.advertise_port = advertise_port
        # past this share of the epoch's wall time waiting on the incoming
        # link, report the link once an epoch (0: never)
        self.slow_report_share = float(slow_report_share)
        self._links: dict[int, socket.socket] = {}
        self._hb: Heartbeat | None = None
        self._rank = -1
        # the planned ring of the current epoch
        self._order: list[int] = []
        self._pos = 0
        self._ring_prev = -1
        self._ring_next = -1
        self._wait_total_s = 0.0
        self._epoch_wait_s = 0.0
        self._epoch_started = 0.0
        self._epoch_reported = False
        self._n_slow_reports = 0
        # this worker's own registry (several workers may share a process):
        # the link waits, shipped as deltas on the heartbeat
        self._metrics_reg = MetricsRegistry()
        self._delta_src = DeltaSource(self._metrics_reg)
        self.codec_name = str(codec or "")
        self._codec = None
        if self.codec_name:
            from rabit_tpu_torch.compress import get_codec

            self._codec = get_codec(self.codec_name)
        # quorum mode: the round's deadline, and the round state of the epoch
        # (cleared with the links)
        self.quorum_wait = float(quorum_wait)
        self._qframes: dict[tuple[int, int], bytes] = {}  # (version, origin) -> payload
        self._qseen: set[tuple[int, int]] = set()
        self._qagreed_prev: set[tuple[int, int]] = set()
        self._known_late: set[int] = set()
        self._skip_in: list[socket.socket] = []   # dialed around a silent predecessor
        self._tee_out: list[socket.socket] = []   # dialed by someone routing around ours
        self._senders: dict[socket.socket, _LinkSender] = {}  # the round's outbound queues
        self._skip_from = -1
        self._next_closed = False  # the ring's next rank closed its end this epoch
        self._qlike: np.ndarray | None = None     # the decode template
        self._q_rounds = 0
        self._q_excluded_rounds = 0
        self._q_corrections = 0
        self._q_skipped = 0
        self._commit_times: dict[int, float] = {}
        self._version = 0
        self._state: np.ndarray | None = None

    # -- lifecycle -----------------------------------------------------------

    def stop(self) -> None:
        self._stop.set()

    def _check_deadline(self) -> None:
        if self._stop.is_set():
            raise EpochBroken("stopped")
        if time.monotonic() > self.deadline:
            raise TimeoutError(f"elastic worker {self.task_id}: deadline exceeded")

    # -- tracker messages ----------------------------------------------------

    def _connect(self) -> socket.socket:
        """Dial the tracker, through the failover list from the address that
        last answered; raises the last OSError when none answers."""
        last: Exception | None = None
        for i in range(len(self.addrs)):
            idx = (self._active + i) % len(self.addrs)
            try:
                sock = socket.create_connection(self.addrs[idx], timeout=self.rpc_timeout)
            except OSError as exc:
                last = exc
                continue
            self._active = idx
            return sock
        raise last if last is not None else OSError("no tracker address")

    def _checkin(self, cmd: int, prev_rank: int) -> P.Assignment:
        """A START or RECOVER check-in on a socket of its own.  The reply is
        an Assignment (the wave closed with this worker in it) or a blob
        frame (no slot: the worker is parked, and the same socket waits for
        a promotion).  A failed transport or a timed-out wave checks in
        again (the tracker replaces a task id's stale check-in) until the
        deadline; a park the tracker closes raises :class:`Released`."""
        while True:
            self._check_deadline()
            sock = None
            parked = False
            try:
                sock = self._connect()
                P.send_hello(sock, cmd, self.task_id, prev_rank=prev_rank,
                             listen_port=self.advertise_port or self.listen_port)
                asg = self._await_assignment(sock)
                if asg is None:
                    parked = True
                    asg = self._await_assignment(sock, parked=True)
                if asg is not None:
                    return asg
            except (OSError, ValueError, ConnectionError, EpochBroken):
                if parked and not self._stop.is_set():
                    raise Released()
            finally:
                if sock is not None:
                    sock.close()
            time.sleep(0.05)

    def _await_assignment(self, sock: socket.socket,
                          parked: bool = False) -> P.Assignment | None:
        """Wait (bounded, and stopped by ``stop``) for the wave's reply:
        the Assignment, or None when a blob frame says this worker is now
        parked.  A parked wait lasts until the deadline."""
        end = min(time.monotonic() + self.wave_timeout, self.deadline)
        while True:
            self._check_deadline()
            sock.settimeout(0.2)
            try:
                magic = P.get_u32(sock)
            except socket.timeout:
                if time.monotonic() > end and not parked:
                    raise EpochBroken("wave reply timed out")
                continue
            sock.settimeout(self.link_timeout)
            if magic == P.MAGIC_ASSIGN:
                return P.Assignment.recv_body(sock)
            if magic == P.MAGIC_BLOB and not parked:
                version = P.get_u32(sock)
                n = P.get_u32(sock)
                self._note_blob(version, P.recv_exact(sock, n) if n else b"")
                return None
            raise ValueError(f"unexpected wave reply magic {magic:#x}")

    def _park(self) -> P.Assignment | None:
        """Park as a spare: take the bootstrap blob, then hold the warm
        socket until a promotion (an Assignment), a release (EOF when the
        job is done) or the fail schedule's death."""
        sock = self._connect()
        try:
            P.send_hello(sock, P.CMD_SPARE, self.task_id,
                         listen_port=self.advertise_port or self.listen_port)
            sock.settimeout(self.wave_timeout)
            version, blob = P.recv_blob_frame(sock)
            self._note_blob(version, blob)
            if self.fail is not None and self.fail[0] == "die_parked":
                raise EpochBroken("spare died while parked")
            while True:
                if self._stop.is_set() or time.monotonic() > self.deadline:
                    return None
                sock.settimeout(0.2)
                try:
                    magic = P.get_u32(sock)
                except socket.timeout:
                    continue
                except (ConnectionError, OSError):
                    return None  # released, or the tracker is gone: never needed
                sock.settimeout(self.link_timeout)
                if magic != P.MAGIC_ASSIGN:
                    return None
                return P.Assignment.recv_body(sock)
        finally:
            sock.close()

    def _maybe_report_slow(self, asg: P.Assignment) -> None:
        """Report the incoming ring link as degraded once the waits on it
        have taken ``slow_report_share`` of this epoch's wall time: a
        ``slow_link`` print the tracker turns into a ``link_degraded``
        event, at most one an epoch.  A delayed frame cascades downstream,
        but the slow link's dst waits on every delayed hop, so reporting
        one's own incoming link is the right attribution."""
        if (self.slow_report_share <= 0 or self._epoch_reported
                or asg.world_size <= 1):
            return
        elapsed = time.monotonic() - self._epoch_started
        if elapsed < 0.2:  # too little evidence to indict a link
            return
        share = self._epoch_wait_s / elapsed
        if share < self.slow_report_share:
            return
        self._epoch_reported = True
        self._n_slow_reports += 1
        line = (f"[{asg.rank}] slow_link src={self._ring_prev} dst={asg.rank} "
                f"wait={self._epoch_wait_s:.3f} share={share:.3f}")
        try:
            P.tracker_rpc(self.tracker[0], self.tracker[1], P.CMD_PRINT, self.task_id,
                          prev_rank=asg.rank, message=line, timeout=self.rpc_timeout,
                          retries=1, addrs=self.addrs)
        except (P.TrackerUnreachable, ValueError):
            pass  # a report must never fail the job

    def _query_epoch(self) -> dict | None:
        try:
            info = P.tracker_rpc(self.tracker[0], self.tracker[1], P.CMD_EPOCH,
                                 self.task_id, prev_rank=self._rank,
                                 message=str(self._version), timeout=self.rpc_timeout,
                                 retries=1, addrs=self.addrs)
            return info if isinstance(info, dict) else None
        except (P.TrackerUnreachable, ValueError):
            return None

    def _ship_blob(self) -> None:
        """Rank 0 hands the tracker its state after each commit, as the
        blob a parked spare starts from: the pickled (version, state),
        zlib-compressed as the durable store's frames are.  Best effort, on
        one connection from the address that last answered."""
        from rabit_tpu_torch.compress import get_codec

        blob = get_codec("zlib").encode_bytes(
            pickle.dumps((self._version, self._state), protocol=pickle.HIGHEST_PROTOCOL))
        try:
            with self._connect() as sock:
                sock.settimeout(self.rpc_timeout)
                P.send_hello(sock, P.CMD_BLOB, self.task_id, prev_rank=self._rank,
                             blob=blob, blob_version=self._version)
                P.get_u32(sock)  # the ACK
        except (OSError, ConnectionError, ValueError):
            pass

    def _note_blob(self, version: int, blob: bytes) -> None:
        if version <= 0 or not blob:
            return
        from rabit_tpu_torch.compress import get_codec

        try:
            ver, state = pickle.loads(get_codec("zlib").decode_bytes(blob))
        except Exception:  # noqa: BLE001 (a torn blob is only a cold start)
            return
        if ver > self._version:
            self._version, self._state = int(ver), state

    # -- peer links ----------------------------------------------------------

    def _adopt_schedule(self, asg: P.Assignment) -> None:
        """The planned ring of the Assignment when it is a permutation of
        the ranks, else the identity ring; the epoch's wait accounting
        starts over."""
        world = asg.world_size
        if len(asg.ring_order) == world and sorted(asg.ring_order) == list(range(world)):
            self._order = list(asg.ring_order)
        else:
            self._order = list(range(world))
        self._pos = self._order.index(asg.rank)
        self._ring_prev = self._order[(self._pos - 1) % world]
        self._ring_next = self._order[(self._pos + 1) % world]
        self._epoch_wait_s = 0.0
        self._epoch_started = time.monotonic()
        self._epoch_reported = False

    def _build_links(self, asg: P.Assignment) -> None:
        """Link to the planned ring neighbours: the lower rank dials, the
        higher accepts, and the MAGIC_LINK handshake carries (rank, epoch),
        so a dialer of an earlier epoch is dropped (the native engine's
        rule)."""
        self._close_links()
        self._adopt_schedule(asg)
        if asg.world_size <= 1:
            return
        neighbors = {self._ring_prev, self._ring_next} - {asg.rank}
        expect_accept = {p for p in neighbors if p < asg.rank}
        deadline = min(time.monotonic() + self.link_timeout, self.deadline)
        for peer in sorted(p for p in neighbors if p > asg.rank):
            host, port = asg.peers[peer]
            try:
                s = socket.create_connection((host, port), timeout=self.link_timeout)
                s.settimeout(self.link_timeout)
                s.sendall(P.put_u32(P.MAGIC_LINK) + P.put_i32(asg.rank)
                          + P.put_u32(asg.epoch))
            except OSError as exc:
                raise EpochBroken(f"dial to rank {peer} failed: {exc!r}")
            self._links[peer] = s
        while expect_accept:
            if self._stop.is_set() or time.monotonic() > deadline:
                raise EpochBroken(f"links from {sorted(expect_accept)} never arrived")
            self._listen.settimeout(0.2)
            try:
                s, _ = self._listen.accept()
            except socket.timeout:
                continue
            except OSError as exc:
                raise EpochBroken(f"accept failed: {exc!r}")
            try:
                s.settimeout(self.link_timeout)
                magic = P.get_u32(s)
                peer = P.get_i32(s)
                epoch = P.get_u32(s)
            except (ConnectionError, OSError):
                s.close()
                continue
            if magic != P.MAGIC_LINK or epoch != asg.epoch or peer not in expect_accept:
                s.close()  # a dialer of an earlier epoch
                continue
            self._links[peer] = s
            expect_accept.discard(peer)

    def _close_links(self) -> None:
        # what this rank still owes its successor goes out first, unless the
        # worker was stopped; a send that stalls fails within link_timeout
        nxt = self._senders.get(self._links.get(self._ring_next))
        if nxt is not None and not self._stop.is_set():
            nxt.wait_sent(min(self.link_timeout, max(self.deadline - time.monotonic(), 0.0)))
        for sender in self._senders.values():
            sender.close()
        self._senders.clear()
        for s in self._links.values():
            try:
                s.close()
            except OSError:
                pass
        self._links.clear()
        # The quorum round state belongs to the epoch: the skip and tee
        # sockets go with the ring links, and no block or record survives a
        # wave (ranks renumber).
        for s in self._skip_in + self._tee_out:
            try:
                s.close()
            except OSError:
                pass
        self._skip_in = []
        self._tee_out = []
        self._qframes.clear()
        self._qseen.clear()
        self._qagreed_prev.clear()
        self._known_late.clear()
        self._skip_from = -1
        self._next_closed = False

    @staticmethod
    def _send_frame(sock: socket.socket, payload: bytes) -> None:
        try:
            sock.sendall(P.put_u32(len(payload)) + payload)
        except OSError as exc:
            raise EpochBroken(f"link send failed: {exc!r}")

    @staticmethod
    def _recv_frame(sock: socket.socket) -> bytes:
        try:
            n = P.get_u32(sock)
            return P.recv_exact(sock, n) if n else b""
        except (ConnectionError, OSError) as exc:
            raise EpochBroken(f"link recv failed: {exc!r}")

    def _hop(self, payload: bytes) -> bytes:
        """Send ``payload`` to the ring's next rank and receive the previous
        rank's frame.  A large frame is sent from a thread meanwhile: in a
        world of two both ranks send first, over one socket."""
        nxt, prv = self._links[self._ring_next], self._links[self._ring_prev]
        if len(payload) < _THREADED_SEND_BYTES:
            self._send_frame(nxt, payload)
            return self._recv_frame(prv)
        failed: list[EpochBroken] = []

        def send() -> None:
            try:
                self._send_frame(nxt, payload)
            except EpochBroken as exc:
                failed.append(exc)

        sender = threading.Thread(target=send, daemon=True, name="rabit-elastic-send")
        sender.start()
        incoming = self._recv_frame(prv)  # on failure the caller closes the links
        sender.join(self.link_timeout + 1.0)
        if failed or sender.is_alive():
            raise failed[0] if failed else EpochBroken("link send timed out")
        return incoming

    # -- collectives ---------------------------------------------------------

    def _ring_allgather(self, asg: P.Assignment, payload: bytes) -> list[bytes]:
        """Every rank's payload in rank order: world - 1 hops around the
        planned ring, each block placed by its ring position."""
        world = asg.world_size
        if world == 1:
            return [payload]
        blocks: dict[int, bytes] = {asg.rank: payload}
        outgoing = payload
        for step in range(world - 1):
            t0 = time.monotonic()
            incoming = self._hop(outgoing)
            wait = time.monotonic() - t0
            self._epoch_wait_s += wait
            self._wait_total_s += wait
            stream_observe("link_wait_seconds", wait, registry=self._metrics_reg,
                           src=self._ring_prev, dst=asg.rank)
            blocks[self._order[(self._pos - 1 - step) % world]] = incoming
            outgoing = incoming
        return [blocks[r] for r in range(world)]

    def _ring_broadcast(self, asg: P.Assignment, root: int, payload: bytes | None) -> bytes:
        """``payload`` from ``root`` around the ring (world - 1 hops); every
        rank ends with the same bytes."""
        world = asg.world_size
        if world == 1:
            return payload
        dist = (self._pos - self._order.index(root)) % world
        if dist == 0:
            self._send_frame(self._links[self._ring_next], payload)
            return payload
        payload = self._recv_frame(self._links[self._ring_prev])
        if dist < world - 1:
            self._send_frame(self._links[self._ring_next], payload)
        return payload

    def _encode_block(self, contrib: np.ndarray) -> bytes:
        """One rank's wire block: its raw bytes, or the codec's encoding."""
        if self._codec is None:
            return contrib.tobytes()
        if contrib.dtype != np.float32:
            raise ValueError(f"codec={self.codec_name!r} needs float32 contributions, "
                             f"got {contrib.dtype}")
        return self._codec.encode(contrib.reshape(-1))

    def _decode_block(self, blob: bytes, like: np.ndarray) -> np.ndarray:
        if self._codec is None:
            return np.frombuffer(blob, dtype=like.dtype).reshape(like.shape)
        return self._codec.decode(blob, int(like.size)).reshape(like.shape)

    def _allreduce_sum(self, asg: P.Assignment, contrib: np.ndarray) -> np.ndarray:
        """The rank-order fold of the gathered contributions."""
        contrib = np.ascontiguousarray(contrib)
        parts = self._ring_allgather(asg, self._encode_block(contrib))
        return refold([self._decode_block(b, contrib) for b in parts])

    # -- quorum rounds ---------------------------------------------------------
    #
    # A quorum round floods tagged blocks (version, origin, payload) over the
    # planned ring and its skip links: a block seen for the first time is
    # kept and passed to the ring's next rank and every tee, so a duplicate
    # is harmless and the flow goes around a straggler.  The round then asks
    # the tracker for its frozen record (one CMD_QUORUM), waits for every
    # block and correction the record names, and folds them in rank order.

    def _quorum_on(self) -> bool:
        return bool(self.quorum_spec)

    def _q_have(self, v: int) -> set[int]:
        """Ranks whose version-``v`` block this worker holds."""
        return {r for (vv, r) in self._qframes if vv == v}

    def _q_send(self, s: socket.socket, frame: bytes) -> None:
        """Queue a block frame on an outbound link's sender."""
        sender = self._senders.get(s)
        if sender is None:
            sender = self._senders[s] = _LinkSender(s)
        sender.put(P.put_u32(len(frame)) + frame)

    def _q_check_sends(self) -> None:
        """Act on the outbound links whose sender failed: a tee is dropped;
        the ring's next rank having closed its end is noted; any other
        failure of the next link (a stall past link_timeout included)
        breaks the epoch."""
        for s, sender in list(self._senders.items()):
            exc = sender.error
            if exc is None:
                continue
            if s in self._tee_out:
                self._drop_tee(s)
                continue
            del self._senders[s]
            if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
                # The next rank closed its end: it folded the final round
                # and left, or it died, which its own successor reads as EOF
                # and passes around the ring to us.  Either way it needs
                # nothing more from this rank, and the round goes on from
                # what the inbound links still hold.
                self._next_closed = True
                continue
            raise EpochBroken(f"link send failed: {exc!r}")

    def _q_flush(self, asg: P.Assignment, deadline: float) -> None:
        """Pump until every outbound link has sent what it was given (or
        failed, as ``_q_check_sends`` rules): a round folds only once this
        rank owes nothing."""
        while True:
            self._q_check_sends()
            if not any(sender.owes() for sender in self._senders.values()):
                return
            self._check_deadline()
            if time.monotonic() > deadline:
                raise EpochBroken("quorum round: outbound blocks not sent within bound")
            self._qpump(asg, tick=0.002)

    def _qpost(self, asg: P.Assignment, v: int, origin: int, payload: bytes) -> bool:
        """Keep a tagged block the first time it is seen and queue it for
        the ring's next rank and every tee; True when it was new."""
        key = (v, origin)
        if key in self._qseen:
            return False
        self._qseen.add(key)
        self._qframes[key] = payload
        self._q_check_sends()
        frame = P.put_block_frame(v, origin, payload)
        nxt = self._links.get(self._ring_next) if asg.world_size > 1 else None
        if nxt is not None and not self._next_closed:
            self._q_send(nxt, frame)
        for s in self._tee_out:
            self._q_send(s, frame)
        return True

    def _drop_tee(self, s: socket.socket) -> None:
        sender = self._senders.pop(s, None)
        if sender is not None:
            sender.close()
        s.close()
        if s in self._tee_out:
            self._tee_out.remove(s)

    def _drop_skip(self, s: socket.socket) -> None:
        s.close()
        if s in self._skip_in:
            self._skip_in.remove(s)

    def _q_accept(self, asg: P.Assignment) -> None:
        """Take one dial made mid-round: a MAGIC_SKIP hello of this epoch
        becomes a tee (the dialer routes around our silent successor) and
        is sent every block kept; anything else (a dialer of a dead epoch)
        is dropped."""
        self._listen.settimeout(0.2)
        try:
            s, _ = self._listen.accept()
        except OSError:  # socket.timeout included
            return
        try:
            s.settimeout(self.link_timeout)
            if P.get_u32(s) != P.MAGIC_SKIP:
                s.close()
                return
            _peer, epoch, _since = P.read_skip_frame(s)
        except (ConnectionError, OSError, ValueError):
            s.close()
            return
        if epoch != asg.epoch:
            s.close()
            return
        for (v, origin) in sorted(self._qframes):
            self._q_send(s, P.put_block_frame(v, origin, self._qframes[(v, origin)]))
        self._tee_out.append(s)

    def _q_skip_dial(self, asg: P.Assignment, v: int) -> None:
        """Route around a silent upstream: dial the ring predecessor of the
        current source and take the flow from there.  Each stall walks one
        rank further back, so two adjacent stragglers are passed one dial
        at a time."""
        world = asg.world_size
        if world <= 2:
            return  # no third rank to route through
        cur = self._skip_from if self._skip_from >= 0 else self._ring_prev
        pos = self._order.index(cur)
        target = self._order[(pos - 1) % world]
        if target == asg.rank or target == cur:
            return
        self._skip_from = target  # the next stall walks further back
        try:
            host, port = asg.peers[target]
            s = socket.create_connection((host, port), timeout=self.link_timeout)
            s.settimeout(self.link_timeout)
            s.sendall(P.put_skip_frame(asg.rank, asg.epoch, v))
        except (OSError, KeyError):
            return
        self._skip_in.append(s)

    def _qpump(self, asg: P.Assignment, tick: float = 0.05) -> bool:
        """One bounded pass over every inbound source (the ring's previous
        rank, the skip links, the listen socket for dials around our
        neighbour); True when a new block landed."""
        self._q_check_sends()
        ins: list[socket.socket] = []
        if asg.world_size > 1 and self._ring_prev in self._links:
            ins.append(self._links[self._ring_prev])
        ins += self._skip_in
        ins.append(self._listen)
        try:
            readable, _, _ = select.select(ins, [], [], tick)
        except (OSError, ValueError):
            raise EpochBroken("select failed on ring sockets")
        progress = False
        for s in readable:
            if s is self._listen:
                self._q_accept(asg)
                continue
            try:
                data = self._recv_frame(s)
            except EpochBroken:
                if s in self._skip_in:
                    self._drop_skip(s)  # a redundant path died; the ring remains
                    continue
                raise
            try:
                v, origin, payload = P.read_block_frame(data)
            except ValueError:
                continue  # a torn or foreign frame
            if 0 <= origin < asg.world_size and self._qpost(asg, v, origin, payload):
                progress = True
        return progress

    def _q_rpc(self, asg: P.Assignment, v: int, have: list[int],
               held: list[tuple[int, int]]) -> dict | None:
        """One CMD_QUORUM report (canonical JSON); the reply, or None when
        the transport missed (the caller's bounded loop asks again)."""
        msg = json.dumps({"epoch": asg.epoch, "v": v, "have": have,
                          "held": [list(t) for t in held]},
                         sort_keys=True, separators=(",", ":"))
        try:
            reply = P.tracker_rpc(self.tracker[0], self.tracker[1], P.CMD_QUORUM,
                                  self.task_id, prev_rank=asg.rank, message=msg,
                                  timeout=self.rpc_timeout, retries=1, addrs=self.addrs)
            return reply if isinstance(reply, dict) else None
        except (P.TrackerUnreachable, ValueError):
            return None

    def _q_wait_pass(self, asg: P.Assignment, v: int, last_progress: float) -> float:
        """One pass of a round's waiting: pump, and past ``quorum_wait``
        without a new block dial around the silent source.  Returns the
        time of the last progress."""
        if self._qpump(asg):
            return time.monotonic()
        if time.monotonic() - last_progress > self.quorum_wait:
            self._q_skip_dial(asg, v)
            return time.monotonic()
        return last_progress

    def _quorum_allreduce(self, asg: P.Assignment, v: int,
                          contrib: np.ndarray | None) -> np.ndarray:
        """One K-of-N round: collect, agree, drain, fold.  ``contrib=None``
        is the catch-up: the group's record for this round was decided
        without us (blocks of a later round prove it), so the frozen record
        is folded and the worker moves on.  The final round is exact."""
        from rabit_tpu_torch.quorum import quorum_count

        world = asg.world_size
        k = quorum_count(world, self.quorum_spec)
        all_ranks = set(range(world))
        exact = k >= world or v >= self.niter
        if contrib is not None:
            self._qpost(asg, v, asg.rank, self._encode_block(contrib))
        if self._qlike is None:
            if contrib is None:
                raise EpochBroken("quorum catch-up before any contribution")
            self._qlike = np.zeros_like(contrib)
        deadline = min(time.monotonic() + self.wave_timeout, self.deadline)
        try:
            rec = self._q_agree(asg, v, contrib is not None, exact, deadline)
            self._q_flush(asg, deadline)
        except EpochBroken:
            # A link closed under the round.  When the round's record is
            # already frozen and every block it names is held, fold it as
            # every other rank did: abandoning it would redo the round in
            # the next epoch under other exclusions, with the corrections
            # owed dropped at the wave, and this rank's state would no longer
            # match theirs.  What the healthy links still owe goes out first.
            rec = self._q_frozen_record(asg, v)
            if rec is None:
                raise
            for sender in self._senders.values():
                sender.wait_sent(max(deadline - time.monotonic(), 0.0))
        excluded = {int(r) for r in rec.get("excluded", ())}
        corrections = sorted((int(sv), int(r)) for sv, r in rec.get("corrections", ()))
        # fold in rank order, the corrections after the round's blocks in
        # (src_version, rank) order: the same bits on every rank
        agreed = sorted(all_ranks - excluded)
        parts = [self._decode_block(self._qframes[(v, r)], self._qlike) for r in agreed]
        parts += [self._decode_block(self._qframes[key], self._qlike) for key in corrections]
        total = refold(parts)
        self._q_rounds += 1
        if excluded:
            self._q_excluded_rounds += 1
        self._q_corrections += len(corrections)
        self._known_late = set(excluded)
        # the folded corrections go, and one round of payloads is kept for a
        # skip dialer's catch-up
        for key in corrections:
            self._qframes.pop(key, None)
        for key in self._qagreed_prev:
            self._qframes.pop(key, None)
        self._qagreed_prev = {(v, r) for r in agreed}
        return total

    @staticmethod
    def _q_needs(rec: dict, v: int, world: int) -> set[tuple[int, int]]:
        """The blocks a frozen record folds: round ``v``'s of every rank it
        did not exclude, and the corrections it names."""
        excluded = {int(r) for r in rec.get("excluded", ())}
        return ({(v, r) for r in range(world) if r not in excluded}
                | {(int(sv), int(r)) for sv, r in rec.get("corrections", ())})

    def _q_frozen_record(self, asg: P.Assignment, v: int) -> dict | None:
        """Round ``v``'s record when the tracker has frozen it and every
        block it names is held, else None.  The report it sends holds no
        block, so it can never decide the round itself."""
        if self._stop.is_set() or time.monotonic() > self.deadline:
            return None
        for _ in range(2):
            reply = self._q_rpc(asg, v, [], [])
            if reply is not None:
                break
        if reply is None or not reply.get("decided"):
            return None
        if not self._q_needs(reply, v, asg.world_size) <= set(self._qframes):
            return None
        return reply

    def _q_agree(self, asg: P.Assignment, v: int, contributed: bool, exact: bool,
                 deadline: float) -> dict:
        """Collect, agree and drain round ``v``: the frozen record, with every
        block it names held."""
        all_ranks = set(range(asg.world_size))
        # collect until the expected blocks landed (a rank known late is not
        # waited for) or the quorum deadline passed
        expected = set(all_ranks) if exact else all_ranks - self._known_late
        if contributed:
            expected.add(asg.rank)
        else:
            expected.discard(asg.rank)
        qdl = time.monotonic() + self.quorum_wait
        last_progress = time.monotonic()
        while not expected <= self._q_have(v):
            self._check_deadline()
            if time.monotonic() > deadline:
                raise EpochBroken(f"quorum round v{v}: collect timed out")
            last_progress = self._q_wait_pass(asg, v, last_progress)
            if not exact and time.monotonic() > qdl:
                break
        # agree: every rank asks every round, since a slower reporter may
        # have frozen a smaller fold than what this rank collected
        rec: dict | None = None
        while rec is None:
            self._check_deadline()
            if time.monotonic() > deadline:
                raise EpochBroken(f"quorum round v{v}: no record within bound")
            held = sorted((sv, r) for (sv, r) in self._qframes if sv < v)
            reply = self._q_rpc(asg, v, sorted(self._q_have(v)), held)
            if reply is not None:
                if reply.get("disabled"):
                    raise EpochBroken("worker runs quorum mode but the tracker has no quorum "
                                      "table (set Tracker(quorum=...))")
                if reply.get("stale_epoch"):
                    raise EpochBroken("quorum report hit a newer epoch")
                if reply.get("decided"):
                    rec = reply
                    break
            last_progress = self._q_wait_pass(asg, v, last_progress)
        # drain: the record is law; hold every block and correction it names
        need = self._q_needs(rec, v, asg.world_size)
        while not need <= set(self._qframes):
            self._check_deadline()
            if time.monotonic() > deadline:
                raise EpochBroken(f"quorum round v{v}: agreed blocks never arrived: "
                                  f"{sorted(need - set(self._qframes))}")
            last_progress = self._q_wait_pass(asg, v, last_progress)
        return rec

    def _sync_state(self, asg: P.Assignment) -> None:
        """After a wave: agree on the newest committed version, and bring
        every rank behind it up to date from the lowest rank that holds it
        (one pass of its state around the ring)."""
        vers = self._ring_allgather(asg, np.array([self._version], np.int64).tobytes())
        versions = [int(np.frombuffer(b, np.int64)[0]) for b in vers]
        vmax = max(versions)
        if vmax <= 0 or all(v == vmax for v in versions):
            return
        root = versions.index(vmax)
        blob = (pickle.dumps((self._version, self._state), protocol=pickle.HIGHEST_PROTOCOL)
                if asg.rank == root else None)
        got = self._ring_broadcast(asg, root, blob)
        if self._version < vmax:
            self._version, self._state = pickle.loads(got)

    # -- heartbeats ----------------------------------------------------------

    def _start_heartbeat(self) -> None:
        if self.heartbeat_sec <= 0 or self._hb is not None:
            return
        host, port = self.tracker

        def tick() -> bool:
            if self._stop.is_set():
                return False
            ok = renew_lease(host, port, self.task_id, self.heartbeat_sec, rank=self._rank,
                             addrs=self.addrs)
            rank = self._rank
            if rank >= 0:  # the tracker refuses a snapshot of no rank
                delta = self._delta_src.take()
                if delta:
                    snap = build_snapshot(self._metrics_reg, rank, self.task_id,
                                          extra={"delta": delta})
                    ship_snapshot(snap, host, port, self.task_id,
                                  timeout=max(self.heartbeat_sec, 0.2), addrs=self.addrs)
            return ok

        self._hb = Heartbeat(self.heartbeat_sec, tick, immediate=True).start()

    def _stop_heartbeat(self) -> None:
        hb, self._hb = self._hb, None
        if hb is not None:
            hb.stop()

    # -- the job loop --------------------------------------------------------

    def run(self) -> ElasticResult:
        res = ElasticResult(task_id=self.task_id)
        try:
            return self._run(res)
        except Released:
            res.parked_only = True
            return res
        except P.TrackerUnreachable as exc:
            res.error = repr(exc)
            return res
        except EpochBroken as exc:
            res.error = repr(exc)
            res.died = True
            return res
        except (ConnectionError, OSError) as exc:
            # the deadline and socket timeouts (TimeoutError is an OSError),
            # or a tracker already gone: reported, never raised into the caller
            res.error = repr(exc)
            return res
        finally:
            res.wait_prev_s = round(self._wait_total_s, 6)
            res.slow_reports = self._n_slow_reports
            res.quorum_rounds = self._q_rounds
            res.excluded_rounds = self._q_excluded_rounds
            res.corrections_folded = self._q_corrections
            res.skipped_contributions = self._q_skipped
            res.commit_times = dict(self._commit_times)
            self._stop_heartbeat()
            self._close_links()
            self._listen.close()

    def _run(self, res: ElasticResult) -> ElasticResult:
        if self.spare:
            asg = self._park()
            if asg is None:
                res.parked_only = True
                res.died = self.fail is not None and self.fail[0] == "die_parked"
                return res
            res.promoted = True
            if self.fail is not None and self.fail[0] == "die_promoted":
                # promoted, but no link ever comes up: the peers' link build
                # fails and the next wave plans without this spare
                res.died = True
                return res
        else:
            asg = self._checkin(P.CMD_START, -1)
        while True:
            self._rank = asg.rank
            res.epochs.append(asg.epoch)
            res.worlds.append(asg.world_size)
            try:
                self._build_links(asg)
                self._sync_state(asg)
                self._start_heartbeat()
                while self._version < self.niter:
                    v = self._version + 1
                    if self.fail is not None and self.fail[0] == "die" and v >= self.fail[1]:
                        # a silent death: heartbeats stop and every socket
                        # closes; the peers' links break and the lease lapses
                        self._stop_heartbeat()
                        self._close_links()
                        res.died = True
                        res.final_version = self._version
                        res.state = self._state
                        return res
                    self._check_deadline()
                    if self._quorum_on():
                        # The bounded catch-up: a block of a later round
                        # proves round v's record froze without ours, so the
                        # record is folded instead of a round the job has
                        # moved past.  The backlog is drained first: a rank
                        # back from a slow contribution has not read its
                        # sockets since the round began.
                        while self._qpump(asg, tick=0.0):
                            pass
                        ahead = max((vv for (vv, _r) in self._qseen), default=0)
                        contrib = None
                        if ahead <= v:
                            contrib = np.ascontiguousarray(
                                self.contribution(v, asg.world_size, asg.rank))
                        else:
                            self._q_skipped += 1
                        total = self._quorum_allreduce(asg, v, contrib)
                    else:
                        contrib = np.ascontiguousarray(
                            self.contribution(v, asg.world_size, asg.rank))
                        total = self._allreduce_sum(asg, contrib)
                    self._state = total if self._state is None else self._state + total
                    self._version = v
                    self._commit_times[v] = time.monotonic()
                    if asg.rank == 0:
                        self._ship_blob()
                    if self._version < self.niter:
                        self._maybe_report_slow(asg)
                        info = self._query_epoch()
                        if info is not None and info.get("rewave"):
                            raise Rewave()
                break
            except Rewave:
                self._close_links()
                asg = self._checkin(P.CMD_RECOVER, asg.rank)
            except EpochBroken:
                self._check_deadline()
                self._close_links()
                asg = self._checkin(P.CMD_RECOVER, asg.rank)
        try:
            # with a failover list the retries outlast a standby's takeover
            # lease, or the job's completion misses this clean exit; the
            # heartbeats go on until it is ACKed, so the lease a promoted
            # standby re-arms does not lapse while the shutdown looks for it
            # (the tracker takes no renewal of a task that has shut down)
            P.tracker_rpc(self.tracker[0], self.tracker[1], P.CMD_SHUTDOWN, self.task_id,
                          prev_rank=asg.rank, timeout=self.rpc_timeout,
                          retries=7 if len(self.addrs) > 1 else 1, backoff_cap=0.5,
                          addrs=self.addrs)
        except (P.TrackerUnreachable, ValueError):
            pass
        self._stop_heartbeat()
        res.completed = True
        res.final_version = self._version
        res.state = self._state
        return res
