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
folded in rank order).

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
hang.  Left out, and refused with ``NotImplementedError``: quorum rounds,
the tracker failover list, the multi-job key and the slow-link reports
(ROADMAP.md Queue 1, items 10c, 10d, 10g and 10b).
"""

from __future__ import annotations

import pickle
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

#: Seconds a message to the tracker (a check-in's connect, an epoch poll,
#: a blob upload, the shutdown) may take.
_RPC_TIMEOUT = 2.0


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
    #: time.monotonic() of each version's commit
    commit_times: dict = field(default_factory=dict)


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"ElasticWorker {what} is not ported yet (ROADMAP.md Queue 1 item {item})")


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
    before any link is up.
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
        wave_timeout: float = 20.0,
        link_timeout: float = 10.0,
        deadline_sec: float = 60.0,
        fail: tuple | None = None,
        codec: str = "",
        slow_report_share: float = 0.0,
        quorum: str = "",
        job: str = "",
    ):
        if tracker and isinstance(tracker[0], (tuple, list)):
            _refuse("with a tracker failover list", "10d")
        if quorum:
            _refuse("quorum rounds (quorum=)", "10c")
        if job:
            _refuse("with a multi-job key (job=)", "10g")
        if slow_report_share:
            _refuse("slow-link reports (slow_report_share=)", "10b")
        self.tracker = (tracker[0], int(tracker[1]))
        self.task_id = task_id
        self.contribution = contribution
        self.niter = int(niter)
        self.spare = bool(spare)
        self.heartbeat_sec = float(heartbeat_sec)
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
        self._links: dict[int, socket.socket] = {}
        self._hb: Heartbeat | None = None
        self._rank = -1
        # the planned ring of the current epoch
        self._order: list[int] = []
        self._pos = 0
        self._ring_prev = -1
        self._ring_next = -1
        self._wait_total_s = 0.0
        # this worker's own registry (several workers may share a process):
        # the link waits, shipped as deltas on the heartbeat
        self._metrics_reg = MetricsRegistry()
        self._delta_src = DeltaSource(self._metrics_reg)
        self.codec_name = str(codec or "")
        self._codec = None
        if self.codec_name:
            from rabit_tpu_torch.compress import get_codec

            self._codec = get_codec(self.codec_name)
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
        return socket.create_connection(self.tracker, timeout=_RPC_TIMEOUT)

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
                             listen_port=self.listen_port)
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
                         listen_port=self.listen_port)
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

    def _query_epoch(self) -> dict | None:
        try:
            info = P.tracker_rpc(self.tracker[0], self.tracker[1], P.CMD_EPOCH,
                                 self.task_id, prev_rank=self._rank,
                                 message=str(self._version), timeout=_RPC_TIMEOUT,
                                 retries=1)
            return info if isinstance(info, dict) else None
        except (P.TrackerUnreachable, ValueError):
            return None

    def _ship_blob(self) -> None:
        """Rank 0 hands the tracker its state after each commit, as the
        blob a parked spare starts from: the pickled (version, state),
        zlib-compressed as the durable store's frames are.  Best effort."""
        from rabit_tpu_torch.compress import get_codec

        blob = get_codec("zlib").encode_bytes(
            pickle.dumps((self._version, self._state), protocol=pickle.HIGHEST_PROTOCOL))
        try:
            P.tracker_rpc(self.tracker[0], self.tracker[1], P.CMD_BLOB, self.task_id,
                          prev_rank=self._rank, blob=blob, blob_version=self._version,
                          timeout=_RPC_TIMEOUT, retries=0)
        except (P.TrackerUnreachable, ValueError):
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
        the ranks, else the identity ring."""
        world = asg.world_size
        if len(asg.ring_order) == world and sorted(asg.ring_order) == list(range(world)):
            self._order = list(asg.ring_order)
        else:
            self._order = list(range(world))
        self._pos = self._order.index(asg.rank)
        self._ring_prev = self._order[(self._pos - 1) % world]
        self._ring_next = self._order[(self._pos + 1) % world]

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
        for s in self._links.values():
            try:
                s.close()
            except OSError:
                pass
        self._links.clear()

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
            ok = renew_lease(host, port, self.task_id, self.heartbeat_sec, rank=self._rank)
            rank = self._rank
            if rank >= 0:  # the tracker refuses a snapshot of no rank
                delta = self._delta_src.take()
                if delta:
                    snap = build_snapshot(self._metrics_reg, rank, self.task_id,
                                          extra={"delta": delta})
                    ship_snapshot(snap, host, port, self.task_id,
                                  timeout=max(self.heartbeat_sec, 0.2))
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
                    contrib = np.ascontiguousarray(
                        self.contribution(v, asg.world_size, asg.rank))
                    total = self._allreduce_sum(asg, contrib)
                    self._state = total if self._state is None else self._state + total
                    self._version = v
                    self._commit_times[v] = time.monotonic()
                    if asg.rank == 0:
                        self._ship_blob()
                    if self._version < self.niter:
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
        self._stop_heartbeat()
        try:
            P.tracker_rpc(self.tracker[0], self.tracker[1], P.CMD_SHUTDOWN, self.task_id,
                          prev_rank=asg.rank, timeout=_RPC_TIMEOUT, retries=1,
                          backoff_cap=0.5)
        except (P.TrackerUnreachable, ValueError):
            pass
        res.completed = True
        res.final_version = self._version
        res.state = self._state
        return res
