"""The relay tier: stateless fan-in nodes between the workers and the
tracker.

The port's own copy of ``rabit_tpu/relay``.  A :class:`Relay` speaks the
tracker's wire to its children (a worker points ``DMLC_TRACKER_URI`` at it
and changes nothing else) and holds ONE ``CMD_BATCH`` channel to the
tracker:

* **terminated** here: heartbeats (a local lease table with the tracker's
  rule; every live lease is re-advertised upstream once a flush with the
  padded interval ``max(child, flush) * RELAY_LEASE_PAD``, so the tracker's
  lease covers the batching and a relay bounce while the local lease stays
  the fast detector), metrics snapshots (the newest a task; a piggybacked
  ``delta`` is stripped and merged per job, ``obs.stream.delta_doc`` /
  ``merge_delta_doc``, and goes upstream as one CMD_OBS delta frame a
  flush), epoch polls (answered from the cache the batch ACKs refresh),
  prints and shutdowns (ACKed here and queued; a shutdown flushes at once);
* **parked and routed**: a START / RECOVER / SPARE check-in parks the
  child's connection here and rides the next batch, which goes at once; the
  tracker's reply (an Assignment, a park frame) comes back on the channel
  by task id.  A CMD_QUORUM report parks the same way under ``q#<task
  id>`` and gets its frozen record in the direct path's bytes.  A parked
  child's EOF goes upstream as ``CMD_HANGUP``;
* **delivery**: a ``CMD_SUB`` poll is answered here from the version line
  the last batch ACK carried; a publish, and a poll before any ACK named a
  line, parks under ``s#<task id>`` and rides the next batch.  A
  ``CMD_SNAP`` fetch of a digest in the cache is answered here with the
  window it asks for (``snap_cache_hits``); a miss goes to the tracker on a
  thread of its own, which fetches the whole blob once and caches it by
  digest (``snap_proxies``);
* **proxied**: a CMD_BLOB upload goes through on a short connection of its
  own, behind a per-job (version, digest) cache: an upload of a version the
  tracker already ACKed is ACKed here (``blob_cache_hits``).  The cache's
  bytes are keyed by digest and bounded by ``rabit_relay_cache_bytes``:
  least recently used and ``superseded`` entries go first
  (``blob_cache_evicted`` events in ``events``).  Snapshot fetches share
  the cache: the digest the current version line names is held, and
  released (``superseded``) when the line moves on;
* **clock-projected**: the relay brackets every batch's round trip and
  keeps an NTP-style estimate of the tracker's clock; the ACKs of its
  children's heartbeats and metrics carry the projected tracker time, so a
  relayed rank's ``ClockSync`` converges as a direct one's does.

A dead relay is a reconnect, not a membership event: its children retry
the same address, parked check-ins are re-sent when the channel is back,
and the tracker's purge treats a dead channel's check-ins as hung up.  A
dead tracker is a reconnect too: ``tracker`` may be a list of addresses
(the primary, then its standby), the channel rotates to the next one when
a dial fails, and on every reconnect the un-ACKed envelope is replayed
(less heartbeats, metrics and deltas, which coalesce again or would count
twice); the tracker dedupes check-ins and shutdowns by task id and decides
each quorum record once, so the replay is safe and the children never
re-dial.

One relay tier serves every job of a multi-tenant ``CollectiveService``:
a child's job key rides in its route key, and the service's batch ACK
carries a ``jobs`` map whose epoch and delivery lines answer each job's
``CMD_EPOCH`` and ``CMD_SUB`` polls here.  A job the map no longer names is
over: its blob and line holds are released (``job_retired``), so their
bytes leave once no other job holds the digest.
"""

from __future__ import annotations

import hashlib
import json
import selectors
import socket
import threading
import time
from collections import OrderedDict

from rabit_tpu_torch.config import Config
from rabit_tpu_torch.obs import stream as obs_stream
from rabit_tpu_torch.tracker import protocol as P

#: The upstream lease padding: a child's lease goes to the tracker with the
#: interval ``max(child_interval, flush_sec) * RELAY_LEASE_PAD``, so the
#: tracker's LEASE_FACTOR x interval lease outlives one whole missed flush.
RELAY_LEASE_PAD = 2.0

#: Seconds a routed reply to a parked child may block the channel's reader
#: before the child counts as gone.
_HELD_SEND_TIMEOUT = 30.0
_HELLO_TIMEOUT = 60.0  # a child's torn hello is dropped after this long

#: Sub-messages an un-ACKed envelope does not replay: heartbeats and metrics
#: coalesce again at the next flush, and a delta the old tracker did fold
#: would count twice.
_NO_REPLAY = (P.CMD_HEARTBEAT, P.CMD_METRICS, P.CMD_OBS)

#: The longest pause, in seconds, between two sweeps of the tracker list
#: while the channel is down.  A promoted standby re-arms the children's
#: leases at LEASE_FACTOR x their padded interval, so the channel must be
#: back well inside that.
_RECONNECT_CAP = 0.25


class _Child:
    """A child connection on the relay's loop."""

    __slots__ = ("sock", "addr", "parser", "out", "deadline", "task_id", "held")

    def __init__(self, sock: socket.socket, addr, deadline: float):
        self.sock = sock
        self.addr = addr
        self.parser = P.StreamParser(P.hello_parser())
        self.out = bytearray()
        self.deadline = deadline
        self.task_id = ""
        self.held = False


class _LocalLease:
    __slots__ = ("interval", "expires", "prev_rank")

    def __init__(self, interval: float, expires: float, prev_rank: int):
        self.interval = interval
        self.expires = expires
        self.prev_rank = prev_rank


class Relay:
    """One relay node, listening on ``host:port`` (port 0: any free port;
    ``self.port`` says which) from construction.  ``tracker`` is one
    ``(host, port)`` or a failover list of them, the primary first;
    ``flush_sec`` is the upstream batch cadence, ``rpc_timeout`` bounds
    every upstream dial and read.  ``start`` runs the child loop (accept,
    parse, terminate or park) and the upstream pump (a batch a flush, at
    once when a check-in, quorum report or shutdown waits, and a reader that
    routes the tracker's frames); ``stop`` ends both, and no thread blocks
    past ``rpc_timeout`` on the tracker."""

    def __init__(self, tracker, relay_id: str = "r0", host: str = "127.0.0.1", port: int = 0,
                 flush_sec: float = 0.25, backlog: int = 1024, rpc_timeout: float = 5.0,
                 quiet: bool = True):
        if tracker and isinstance(tracker[0], (tuple, list)):
            self.trackers = [(t[0], int(t[1])) for t in tracker]
        else:
            self.trackers = [(tracker[0], int(tracker[1]))]
        self._tr = 0  # the address believed primary
        self.relay_id = relay_id
        self.flush_sec = float(flush_sec)
        self.rpc_timeout = float(rpc_timeout)
        self.quiet = quiet
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(backlog)
        self.host, self.port = self._srv.getsockname()
        self._stopped = threading.Event()
        self._lock = threading.Lock()
        # what the next flush carries (all under _lock)
        self._leases: dict[str, _LocalLease] = {}
        self._metrics: dict[str, tuple[int, bytes, float]] = {}  # task -> the newest
        self._deltas: dict[str, dict] = {}  # job -> merged delta doc (windows add up)
        self._queued: list[P.BatchMsg] = []
        self._held: dict[str, socket.socket] = {}     # parked children by key
        self._held_msg: dict[str, P.BatchMsg] = {}    # their hellos, re-sent on a reconnect
        self._held_sent: set[str] = set()
        # Sockets other threads want closed: only the child loop closes a
        # socket it has registered (a close on another thread frees the fd
        # while it is registered, and the next accept's reuse of the fd then
        # fails to register).
        self._defer_close: set[socket.socket] = set()
        self._flush_now = threading.Event()
        self._chan: socket.socket | None = None
        self._chan_lock = threading.Lock()
        self._ack = threading.Event()
        self._partitioned = False
        self._last_batch_send: float | None = None
        self.clock_offset = 0.0   # tracker clock - relay clock
        self.clock_err = float("inf")
        self._epoch_cache = {"epoch": 0, "world": 0, "rewave": False}
        # each job's epoch line from a service's batch ACK (bare task ids,
        # and jobs the ACK has not named yet, read the cache above)
        self._job_epochs: dict[str, dict] = {}
        # The blob cache: bytes by digest (LRU order, bounded), each job's
        # newest (version, digest), and a count of the jobs that hold a digest.
        self._blob_cache: dict[str, tuple[int, str]] = {}
        self._digest_blobs: OrderedDict[str, bytes] = OrderedDict()
        self._digest_refs: dict[str, int] = {}
        self._cache_used = 0
        self._cache_budget = Config().get_size("rabit_relay_cache_bytes", 256 << 20)
        # The delivery lines the batch ACKs carry, by job, and the digest
        # each line holds in the cache.
        self._sub_lines: dict[str, dict] = {}
        self._line_digests: dict[str, str] = {}
        #: the relay's own timeline (blob_cache_evicted), bounded
        self.events: list[dict] = []
        # The last envelope's replayable sub-messages, kept until its ACK:
        # a channel cut between the send and the ACK replays them.
        self._unacked: list[P.BatchMsg] = []
        self._replay = False
        self.stats = {"children": 0, "rpcs_terminated": 0, "batches": 0, "batch_msgs": 0,
                      "routed": 0, "reconnects": 0, "failovers": 0, "replayed_msgs": 0,
                      "blob_cache_hits": 0, "snap_cache_hits": 0, "snap_proxies": 0,
                      "evictions": 0}

    @property
    def tracker(self) -> tuple[str, int]:
        """The tracker address believed primary (the reconnect loop rotates
        it when a dial fails)."""
        return self.trackers[self._tr]

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "Relay":
        threading.Thread(target=self._serve_children, daemon=True,
                         name=f"relay-children-{self.relay_id}").start()
        threading.Thread(target=self._upstream_pump, daemon=True,
                         name=f"relay-upstream-{self.relay_id}").start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        self._flush_now.set()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()
        self._drop_channel()
        with self._lock:
            held, self._held = self._held, {}
            self._held_msg.clear()
            self._held_sent.clear()
        for conn in held.values():
            conn.close()

    def set_partition(self, on: bool) -> None:
        """Cut the relay off the tracker (``on``) or heal it: cut, it serves
        its children but cannot reach the tracker, so batches fail and
        parked check-ins wait for the heal; the tracker's padded leases
        decide whether the cut was survivable."""
        self._partitioned = bool(on)
        if on:
            self._drop_channel()
        else:
            self._flush_now.set()

    def _stamp(self) -> bytes:
        """The projected tracker clock, in the format of the tracker's own
        heartbeat and metrics ACK stamp."""
        return P.put_str(f"{time.time() + self.clock_offset:.6f}")

    # -- the child loop --------------------------------------------------------

    def _serve_children(self) -> None:
        sel = selectors.DefaultSelector()
        try:
            self._srv.setblocking(False)
            sel.register(self._srv, selectors.EVENT_READ, None)
        except (OSError, ValueError):
            sel.close()
            return
        children: set[_Child] = set()
        next_sweep = time.monotonic() + 0.5
        try:
            while not self._stopped.is_set():
                try:
                    events = sel.select(0.05)
                except OSError:
                    break
                for key, mask in events:
                    if key.data is None:
                        self._accept_children(sel, children)
                    elif mask & selectors.EVENT_READ:
                        self._child_read(sel, children, key.data)
                    elif mask & selectors.EVENT_WRITE:
                        self._child_flush(sel, children, key.data)
                if self._defer_close:
                    with self._lock:
                        dead, self._defer_close = self._defer_close, set()
                    for ch in [c for c in children if c.sock in dead]:
                        self._child_drop(sel, children, ch)
                        dead.discard(ch.sock)
                    for sock in dead:  # never registered, or dropped already
                        sock.close()
                now = time.monotonic()
                if now >= next_sweep:
                    next_sweep = now + 0.5
                    self._expire_local_leases()
                    for ch in [c for c in children if c.deadline and now > c.deadline]:
                        self._child_drop(sel, children, ch)
        finally:
            for ch in list(children):
                self._child_drop(sel, children, ch)
            sel.close()

    def _accept_children(self, sel, children: set[_Child]) -> None:
        while True:
            try:
                conn, addr = self._srv.accept()
            except OSError:  # BlockingIOError: nothing more to accept
                return
            conn.setblocking(False)
            ch = _Child(conn, addr, time.monotonic() + _HELLO_TIMEOUT)
            try:
                sel.register(conn, selectors.EVENT_READ, ch)
            except (OSError, ValueError):
                conn.close()
                continue
            children.add(ch)
            self.stats["children"] += 1

    def _child_drop(self, sel, children: set[_Child], ch: _Child) -> None:
        children.discard(ch)
        try:
            sel.unregister(ch.sock)
        except (KeyError, OSError, ValueError):
            pass
        if ch.held:
            # a parked child hung up: the tracker's wave purge must count it
            # out (unless a fresh check-in of the task replaced it)
            self._unhold(ch.task_id, notify=True, expect=ch.sock)
        ch.sock.close()

    def _child_detach(self, sel, children: set[_Child], ch: _Child) -> None:
        children.discard(ch)
        try:
            sel.unregister(ch.sock)
        except (KeyError, OSError, ValueError):
            pass
        ch.sock.setblocking(True)

    def _child_read(self, sel, children: set[_Child], ch: _Child) -> None:
        try:
            data = ch.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._child_drop(sel, children, ch)
            return
        if not data:
            self._child_drop(sel, children, ch)
            return
        if ch.held:
            return  # a parked child says nothing past its hello
        try:
            if not ch.parser.feed(data):
                return
        except ValueError:
            self._child_drop(sel, children, ch)
            return
        h: P.Hello = ch.parser.result
        ch.task_id = h.task_id
        self._dispatch_child(sel, children, ch, h)

    def _park(self, ch: _Child, key: str, msg: P.BatchMsg) -> None:
        """Park a child under ``key`` until the tracker's routed reply; its
        message rides the next batch, which goes at once.  The connection
        stays on the loop (read-registered), so its EOF is seen."""
        ch.held = True
        ch.deadline = 0.0
        ch.task_id = key
        with self._lock:
            old = self._held.pop(key, None)
            self._held[key] = ch.sock
            self._held_msg[key] = msg
            self._held_sent.discard(key)
            if old is not None and old is not ch.sock:
                self._defer_close.add(old)
        self._flush_now.set()

    def _dispatch_child(self, sel, children: set[_Child], ch: _Child, h: P.Hello) -> None:
        if h.cmd in (P.CMD_START, P.CMD_RECOVER, P.CMD_SPARE):
            if h.cmd != P.CMD_SPARE:
                with self._lock:
                    self._leases.pop(h.task_id, None)
            self._park(ch, h.task_id, P.BatchMsg(h.task_id, h.cmd, h.prev_rank, ch.addr[0],
                                                 h.listen_port, b"", time.time()))
            return
        if h.cmd == P.CMD_QUORUM:
            key = "q#" + h.task_id
            self._park(ch, key, P.BatchMsg(key, P.CMD_QUORUM, h.prev_rank, ch.addr[0], 0,
                                           h.message.encode(), time.time()))
            return
        if h.cmd == P.CMD_BLOB:
            # A version the tracker already ACKed is ACKed here; a newer one
            # goes through on a thread of its own with bounded timeouts, so
            # the loop never blocks on the tracker.
            job = P.split_job(h.task_id)[0]
            with self._lock:
                cached = self._blob_cache.get(job)
            if cached is not None and h.blob_version <= cached[0]:
                self.stats["blob_cache_hits"] += 1
                self.stats["rpcs_terminated"] += 1
                ch.out += P.put_u32(P.ACK)
                self._child_flush(sel, children, ch)
                return
            self._child_detach(sel, children, ch)
            threading.Thread(target=self._proxy_blob, args=(ch.sock, h, job), daemon=True,
                             name=f"relay-proxy-{self.relay_id}").start()
            return
        if h.cmd == P.CMD_SUB:
            job = P.split_job(h.task_id)[0]
            with self._lock:
                line = self._sub_lines.get(job)
            if line is None or "publish" in h.message:
                key = "s#" + h.task_id
                self._park(ch, key, P.BatchMsg(key, P.CMD_SUB, h.prev_rank, ch.addr[0], 0,
                                               h.message.encode(), time.time()))
                return
            ch.out += P.put_u32(P.ACK) + P.put_str(json.dumps(line))
        elif h.cmd == P.CMD_SNAP:
            try:
                req = json.loads(h.message) if h.message else {}
            except ValueError:
                req = {}
            req = req if isinstance(req, dict) else {}
            digest = str(req.get("digest", ""))
            with self._lock:
                blob = self._digest_blobs.get(digest)
                if blob is not None:
                    self._digest_blobs.move_to_end(digest)
            if blob is None:
                # the whole blob comes from the tracker once, on a thread
                self.stats["snap_proxies"] += 1
                obs_stream.stream_count("delivery_cache_misses", 1, relay=self.relay_id)
                self._child_detach(sel, children, ch)
                threading.Thread(target=self._proxy_snap, args=(ch.sock, h, req), daemon=True,
                                 name=f"relay-snap-{self.relay_id}").start()
                return
            self.stats["snap_cache_hits"] += 1
            obs_stream.stream_count("delivery_cache_hits", 1, relay=self.relay_id)
            ch.out += self._snap_window(digest, blob, req)
        elif h.cmd == P.CMD_HEARTBEAT:
            try:
                interval = float(h.message)
            except ValueError:
                interval = 0.0
            if 0 < interval < 86400:
                with self._lock:
                    self._leases[h.task_id] = _LocalLease(
                        interval, time.monotonic() + P.LEASE_FACTOR * interval, h.prev_rank)
            ch.out += P.put_u32(P.ACK) + self._stamp()
        elif h.cmd == P.CMD_METRICS:
            ch.out += P.put_u32(P.ACK) + self._stamp()
            self._keep_metrics(h)
        elif h.cmd == P.CMD_EPOCH:
            job = P.split_job(h.task_id)[0]
            cache = self._job_epochs.get(job) if job else None
            ch.out += P.put_u32(P.ACK) + P.put_str(
                json.dumps(cache if cache is not None else self._epoch_cache))
        elif h.cmd in (P.CMD_PRINT, P.CMD_SHUTDOWN):
            with self._lock:
                if h.cmd == P.CMD_SHUTDOWN:
                    self._leases.pop(h.task_id, None)
                self._queued.append(P.BatchMsg(h.task_id, h.cmd, h.prev_rank, ch.addr[0], 0,
                                               h.message.encode(), time.time()))
            if h.cmd == P.CMD_SHUTDOWN:
                self._flush_now.set()  # the job's completion must not wait a flush
            ch.out += P.put_u32(P.ACK)
        else:
            self._child_drop(sel, children, ch)  # a command the relay does not serve
            return
        self.stats["rpcs_terminated"] += 1
        self._child_flush(sel, children, ch)

    def _keep_metrics(self, h: P.Hello) -> None:
        """Keep a child's snapshot, the newest a task; its piggybacked delta
        is stripped first and merged into its job's document (windows add
        up: replacing would lose all but the last)."""
        payload, doc = h.message, None
        try:
            snap = json.loads(payload)
            delta = snap.pop("delta", None) if isinstance(snap, dict) else None
            if isinstance(delta, dict) and delta:
                doc = obs_stream.delta_doc(P.split_job(h.task_id)[0],
                                           int(snap.get("rank", h.prev_rank)), delta)
                payload = json.dumps(snap)
        except (ValueError, TypeError):
            doc = None
        with self._lock:
            self._metrics[h.task_id] = (h.prev_rank, payload.encode(), time.time())
            if doc is not None:
                self._deltas[doc["job"]] = obs_stream.merge_delta_doc(
                    self._deltas.get(doc["job"]), doc)

    def _child_flush(self, sel, children: set[_Child], ch: _Child) -> None:
        while ch.out:
            try:
                n = ch.sock.send(ch.out)
            except (BlockingIOError, InterruptedError):
                try:
                    sel.modify(ch.sock, selectors.EVENT_WRITE, ch)
                except (KeyError, OSError, ValueError):
                    self._child_drop(sel, children, ch)
                return
            except OSError:
                self._child_drop(sel, children, ch)
                return
            del ch.out[:n]
        self._child_drop(sel, children, ch)

    def _proxy_blob(self, conn: socket.socket, h: P.Hello, job: str) -> None:
        """Pass one blob upload to the tracker and its ACK back; only once
        the tracker ACKed is the blob cached for (job, version), so the
        cache never swallows an upload the tracker did not get."""
        acked = False
        try:
            with socket.create_connection(self.tracker, timeout=self.rpc_timeout) as up:
                up.settimeout(self.rpc_timeout)
                P.send_hello(up, P.CMD_BLOB, h.task_id, prev_rank=h.prev_rank, blob=h.blob,
                             blob_version=h.blob_version)
                ack = P.get_u32(up)
            acked = True
            conn.settimeout(self.rpc_timeout)
            conn.sendall(P.put_u32(ack))
        except (ConnectionError, OSError, ValueError):
            pass  # the child's bounded RPC retries
        finally:
            conn.close()
        if acked and h.blob_version > 0:
            self._cache_put(hashlib.sha256(h.blob).hexdigest(), h.blob, job, h.blob_version)

    def _proxy_snap(self, conn: socket.socket, h: P.Hello, req: dict) -> None:
        """Fetch one digest's whole snapshot from the tracker, cache it by
        digest and answer the child's window; a digest the tracker lacks
        answers the empty frame, which the subscriber retries past."""
        digest = str(req.get("digest", ""))
        blob = None
        try:
            try:
                with socket.create_connection(self.tracker, timeout=self.rpc_timeout) as up:
                    up.settimeout(self.rpc_timeout)
                    P.send_hello(up, P.CMD_SNAP, h.task_id,
                                 message=json.dumps({"digest": digest}))
                    got, total, _off, payload = P.read_snap_frame(up)
                if got == digest and payload and len(payload) == total:
                    blob = payload
                    self._cache_put(digest, blob)
            except (ConnectionError, OSError, ValueError):
                pass
            conn.settimeout(self.rpc_timeout)
            conn.sendall(P.put_snap_frame("", 0, 0, b"") if blob is None
                         else self._snap_window(digest, blob, req))
        except OSError:
            pass
        finally:
            conn.close()

    @staticmethod
    def _snap_window(digest: str, blob: bytes, req: dict) -> bytes:
        """The snap frame of ``[off, off + len)`` of a cached blob (no len,
        or 0: the rest of the blob)."""
        try:
            off = max(int(req.get("off", 0)), 0)
            ln = int(req.get("len", 0) or 0)
        except (TypeError, ValueError):
            off, ln = 0, 0
        chunk = blob[off:off + ln] if ln > 0 else blob[off:]
        return P.put_snap_frame(digest, len(blob), off, chunk)

    # -- the blob cache --------------------------------------------------------

    def _cache_put(self, digest: str, blob: bytes, job: str | None = None,
                   version: int = 0) -> None:
        """Keep the bytes under their digest and, for an upload, bind
        ``job``'s newest (version, digest), releasing the digest it
        supersedes; past the byte budget the least recently used digest
        nothing holds goes."""
        with self._lock:
            if job is not None:
                old = self._blob_cache.get(job)
                self._blob_cache[job] = (version, digest)
                if old is None or old[1] != digest:
                    self._digest_refs[digest] = self._digest_refs.get(digest, 0) + 1
                    if old is not None:
                        self._release_digest_locked(old[1], "superseded")
            if digest in self._digest_blobs:
                self._digest_blobs.move_to_end(digest)
            else:
                self._digest_blobs[digest] = blob
                self._cache_used += len(blob)
            while self._cache_used > self._cache_budget:
                victim = next((d for d in self._digest_blobs
                               if self._digest_refs.get(d, 0) <= 0 and d != digest), None)
                if victim is None:
                    break
                vb = self._digest_blobs.pop(victim)
                self._cache_used -= len(vb)
                self._note_evicted_locked(victim, len(vb), "lru")

    def _hold_line_locked(self, job: str, line: dict) -> None:
        """Adopt ``job``'s delivery line from a batch ACK: the digest it
        names is held in the cache (no LRU eviction while it is current)
        and the digest of the line it supersedes is released."""
        self._sub_lines[job] = dict(line)
        digest = str(line.get("digest", ""))
        old = self._line_digests.get(job)
        if old == digest:
            return
        if digest:
            self._line_digests[job] = digest
            self._digest_refs[digest] = self._digest_refs.get(digest, 0) + 1
        else:
            self._line_digests.pop(job, None)
        if old:
            self._release_digest_locked(old, "superseded")

    def _release_digest_locked(self, digest: str, reason: str) -> None:
        """Drop one job's hold of a digest; its bytes go once none holds it."""
        n = self._digest_refs.get(digest, 1) - 1
        if n > 0:
            self._digest_refs[digest] = n
            return
        self._digest_refs.pop(digest, None)
        blob = self._digest_blobs.pop(digest, None)
        if blob is not None:
            self._cache_used -= len(blob)
            self._note_evicted_locked(digest, len(blob), reason)

    def _note_evicted_locked(self, digest: str, nbytes: int, reason: str) -> None:
        self.stats["evictions"] += 1
        if len(self.events) < 4096:
            self.events.append({"ts": round(time.time(), 6), "kind": "blob_cache_evicted",
                                "relay": self.relay_id, "digest": digest, "nbytes": nbytes,
                                "reason": reason})

    def _expire_local_leases(self) -> None:
        """Drop the local leases past LEASE_FACTOR intervals: the child is
        gone, its upstream renewals stop, and the tracker's padded lease
        expires it."""
        now = time.monotonic()
        with self._lock:
            for task_id in [t for t, lease in self._leases.items() if now >= lease.expires]:
                del self._leases[task_id]

    def _unhold(self, key: str, notify: bool, expect: socket.socket | None = None) -> None:
        """Forget a parked child; with ``notify``, and once its hello went
        upstream, queue a CMD_HANGUP for it.  ``expect``: only if the parked
        socket is still this one (a fresh check-in of the task replaced it)."""
        with self._lock:
            if expect is not None and self._held.get(key) is not expect:
                return
            self._held.pop(key, None)
            self._held_msg.pop(key, None)
            was_sent = key in self._held_sent
            self._held_sent.discard(key)
            if notify and was_sent:
                self._queued.append(P.BatchMsg(key, P.CMD_HANGUP, -1, "", 0, b"", time.time()))
                self._flush_now.set()

    # -- the upstream pump -----------------------------------------------------

    def _drop_channel(self) -> None:
        with self._chan_lock:
            chan, self._chan = self._chan, None
        if chan is not None:
            try:
                chan.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            chan.close()

    def _connect_channel(self) -> socket.socket | None:
        if self._partitioned:
            return None
        try:
            chan = socket.create_connection(self.tracker, timeout=self.rpc_timeout)
            chan.settimeout(self.rpc_timeout)
            P.send_hello(chan, P.CMD_BATCH, self.relay_id)
            if P.get_u32(chan) != P.ACK:
                chan.close()
                return None
            chan.settimeout(None)
        except (ConnectionError, OSError, ValueError):
            # the next dial tries the next address: a standby's pre-bound
            # socket refuses until it takes over
            if len(self.trackers) > 1:
                self._tr = (self._tr + 1) % len(self.trackers)
                self.stats["failovers"] += 1
            return None
        with self._chan_lock:
            self._chan = chan
        with self._lock:
            # a fresh channel re-announces every parked check-in (the tracker
            # replaces a task's stale pending entry) and replays the
            # envelope not yet ACKed
            self._held_sent.clear()
            self._replay = bool(self._unacked)
        self.stats["reconnects"] += 1
        threading.Thread(target=self._channel_reader, args=(chan,), daemon=True,
                         name=f"relay-rx-{self.relay_id}").start()
        if not self.quiet:
            print(f"[relay {self.relay_id}] channel up to {self.tracker[0]}:{self.tracker[1]}",
                  flush=True)
        return chan

    def _channel_reader(self, chan: socket.socket) -> None:
        """Route the tracker's frames to parked children until the channel
        dies: one reader a channel."""
        try:
            while not self._stopped.is_set():
                key, flags, payload = P.read_route_frame(chan)
                if key == "":
                    self._fold_ack(payload)
                    continue
                with self._lock:
                    conn = self._held.get(key)
                if conn is None:
                    continue  # the child gave up and checked in again
                self.stats["routed"] += 1
                try:
                    if payload:
                        conn.settimeout(_HELD_SEND_TIMEOUT)
                        conn.sendall(payload)
                except OSError:
                    self._unhold(key, notify=True, expect=conn)
                    with self._lock:
                        self._defer_close.add(conn)
                    continue
                if flags & P.ROUTE_CLOSE:
                    self._unhold(key, notify=False, expect=conn)
                    with self._lock:
                        self._defer_close.add(conn)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with self._chan_lock:
                if self._chan is chan:
                    self._chan = None
            chan.close()
            # a pump waiting for this channel's ACK redials now, not after
            # rpc_timeout
            self._ack.set()

    def _fold_ack(self, payload: bytes) -> None:
        """A batch ACK: refresh the epoch caches, the delivery lines (a
        service's ``jobs`` map: every job's, and the retirement sweep) and
        the clock projection (the tightest bracket wins, with decay), and
        clear the envelope held for replay."""
        try:
            info = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            return
        if "epoch" in info:
            self._epoch_cache = {"epoch": info.get("epoch", 0), "world": info.get("world", 0),
                                 "rewave": bool(info.get("rewave"))}
        line = info.get("delivery")
        if isinstance(line, dict):
            with self._lock:
                self._hold_line_locked("", line)
        jobs = info.get("jobs")
        if isinstance(jobs, dict):
            # one swap of the whole map: a reader never sees it torn
            self._job_epochs = {str(k): {"epoch": v.get("epoch", 0), "world": v.get("world", 0),
                                         "rewave": bool(v.get("rewave"))}
                                for k, v in jobs.items() if isinstance(v, dict)}
            with self._lock:
                for job, v in jobs.items():
                    if isinstance(v, dict) and isinstance(v.get("delivery"), dict):
                        self._hold_line_locked(str(job), v["delivery"])
                for job in [j for j in self._blob_cache if j and j not in jobs]:
                    self._release_digest_locked(self._blob_cache.pop(job)[1], "job_retired")
                for job in [j for j in self._sub_lines if j and j not in jobs]:
                    del self._sub_lines[job]
                    old = self._line_digests.pop(job, None)
                    if old:
                        self._release_digest_locked(old, "job_retired")
        t_recv, t_send = time.time(), self._last_batch_send
        server_ts = info.get("server_ts")
        if t_send is not None and server_ts is not None:
            err = max(t_recv - t_send, 0.0) / 2.0
            if err <= self.clock_err * 2.0 or err < 0.05:
                self.clock_offset = float(server_ts) - (t_send + t_recv) / 2
                self.clock_err = err
        with self._lock:
            self._unacked = []
        self._ack.set()

    def _build_batch(self) -> list[P.BatchMsg]:
        """The next envelope: the parked messages not yet sent, every live
        lease with the padded interval, the newest snapshot a task since the
        last flush, one delta frame a job (an oversized one is dropped
        whole), then the queued prints, shutdowns and hang-ups.  A child's
        snapshot goes before its shutdown, as on a direct path, so the
        telemetry written at the job's end holds its last snapshot."""
        now = time.time()
        with self._lock:
            msgs, queued, self._queued = [], self._queued, []
            for key, msg in self._held_msg.items():
                if key not in self._held_sent:
                    msgs.append(msg)
                    self._held_sent.add(key)
            for task_id, lease in self._leases.items():
                up = max(lease.interval, self.flush_sec) * RELAY_LEASE_PAD
                msgs.append(P.BatchMsg(task_id, P.CMD_HEARTBEAT, lease.prev_rank, "", 0,
                                       f"{up:.6f}".encode(), now))
            for task_id, (rank, payload, ts) in self._metrics.items():
                msgs.append(P.BatchMsg(task_id, P.CMD_METRICS, rank, "", 0, payload, ts))
            self._metrics = {}
            deltas, self._deltas = self._deltas, {}
        for job, doc in sorted(deltas.items()):
            try:
                frame = P.put_delta_frame(doc)
            except ValueError:
                continue
            msgs.append(P.BatchMsg(P.join_job(job, "#delta"), P.CMD_OBS, -1, "", 0, frame, now))
        return msgs + queued

    def _upstream_pump(self) -> None:
        backoff, misses = 0.05, 0
        while not self._stopped.is_set():
            self._flush_now.wait(self.flush_sec)
            self._flush_now.clear()
            if self._stopped.is_set():
                return
            with self._chan_lock:
                chan = self._chan
            if chan is None:
                chan = self._connect_channel()
                if chan is None:
                    # the next address is dialled at the next flush; only a
                    # whole sweep of the list that failed backs off
                    misses += 1
                    if misses % len(self.trackers) == 0:
                        time.sleep(backoff)
                        backoff = min(backoff * 2, _RECONNECT_CAP)
                    continue
                backoff, misses = 0.05, 0
            # an empty batch goes out too: the keepalive that refreshes the
            # epoch cache and the clock projection
            msgs = self._build_batch()
            with self._lock:
                if self._replay and self._unacked:
                    msgs = self._unacked + msgs
                    self.stats["replayed_msgs"] += len(self._unacked)
                self._replay = False
                self._unacked = [m for m in msgs if m.cmd not in _NO_REPLAY]
            self._ack.clear()
            self._last_batch_send = time.time()
            try:
                chan.sendall(P.put_batch_frame(msgs))
            except OSError:
                self._drop_channel()  # parked hellos re-send on the reconnect
                continue
            self.stats["batches"] += 1
            self.stats["batch_msgs"] += len(msgs)
            self._ack.wait(self.rpc_timeout)
