"""The warm standby: tail the primary's journal, replay it, take over.

The port's own copy of ``rabit_tpu/ha/standby.py``.  A :class:`Standby`
binds its advertised address at once but does not listen, so a client that
dials it before a takeover is refused and rotates back to the primary
(``tracker_rpc``'s failover list).  It tails the primary's journal and
replays every record into its own
:class:`~rabit_tpu_torch.ha.state.ControlState`, over either of two
transports with the same frames:

* **streamed**: one ``CMD_JOURNAL`` channel to the primary, a snapshot
  first, then every mutation as it commits, and ``tick`` keepalives.
  Every later snapshot frame is checked against the replay: on a
  difference the standby records ``journal_gap`` and adopts the snapshot;
* **file**: tail a ``rabit_ha_journal`` file (a compaction swaps the
  inode, and the tailer reads the new file from its start).

The takeover is lease-shaped (``takeover_sec``): once nothing has arrived
for that long (the channel down, or the file's ticks stopped), the standby
records ``tracker_failover``, listens on its bound socket and starts a port
:class:`~rabit_tpu_torch.tracker.tracker.Tracker` seeded with the replayed
state (``resume_from=``): the ranks, the epoch line, the frozen quorum
records, the flagged links and the spare roster survive, and the journaled
leases re-arm with fresh deadlines.  Workers fail over on their side
(``rabit_tracker_addrs``), and the interrupted wave closes again on the new
tracker.
"""

from __future__ import annotations

import os
import socket
import threading
import time

from rabit_tpu_torch.ha.journal import Journal
from rabit_tpu_torch.ha.state import ControlState
from rabit_tpu_torch.tracker import protocol as P


class Standby:
    """One warm-standby tracker.  ``primary=(host, port)`` tails over
    CMD_JOURNAL, ``journal_path=`` tails a file (one of the two is
    needed); ``journal`` is the file the promoted tracker journals to (by
    default the tailed one), and ``tracker_kwargs`` go to the promoted
    :class:`Tracker` (``quorum``, ``on_suspect``, ...).  ``service=True``
    tails a multi-job service's journal into a ``ServiceState`` and
    promotes a ``CollectiveService`` that restores every live job."""

    def __init__(self, primary: tuple[str, int] | None = None, journal_path: str | None = None,
                 host: str = "127.0.0.1", port: int = 0, standby_id: str = "standby0",
                 takeover_sec: float = 1.0, poll_sec: float = 0.1, journal: str | None = None,
                 tracker_kwargs: dict | None = None, quiet: bool = True, service: bool = False):
        if primary is None and journal_path is None:
            raise ValueError("standby needs a primary address and/or a journal path to tail")
        # A multi-job service's journal replays into a ServiceState (every
        # job's partition from the one interleaved stream), and the takeover
        # promotes a CollectiveService.
        self.service = bool(service)
        if service:
            from rabit_tpu_torch.service.state import ServiceState

            self._state_cls = ServiceState
        else:
            self._state_cls = ControlState
        self.primary = (primary[0], int(primary[1])) if primary is not None else None
        self.journal_path = journal_path
        self.standby_id = standby_id
        self.takeover_sec = float(takeover_sec)
        self.poll_sec = float(poll_sec)
        self.promoted_journal = journal if journal is not None else journal_path
        self.tracker_kwargs = dict(tracker_kwargs or {})
        self.quiet = quiet
        self.state = self._state_cls()
        self.events: list[dict] = []  # seeded into the promoted tracker's timeline
        self.synced = threading.Event()    # the first snapshot applied
        self.promoted = threading.Event()
        self.tracker = None                # the promoted Tracker
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # Bound now, listening only at the takeover: until then a dial is
        # refused, which is the signal the clients' rotation expects.
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host, self.port = self._sock.getsockname()
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "Standby":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"rabit-torch-ha-{self.standby_id}")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop tailing, and stop the promoted tracker when there is one."""
        self._stop.set()
        tracker = self.tracker
        if tracker is not None:
            tracker.stop()
        else:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def kill(self) -> None:
        """An abrupt death: the standby, or the tracker it became, goes
        with no teardown."""
        self._stop.set()
        tracker = self.tracker
        if tracker is not None:
            tracker.kill()
        else:
            try:
                self._sock.close()
            except OSError:
                pass

    def wait_synced(self, timeout: float | None = None) -> bool:
        return self.synced.wait(timeout)

    def wait_promoted(self, timeout: float | None = None) -> bool:
        return self.promoted.wait(timeout)

    # -- tailing ---------------------------------------------------------------

    def _note(self, ev: dict) -> None:
        ev = {"ts": round(time.time(), 6), **ev}
        with self._lock:
            self.events.append(ev)
        if not self.quiet:
            print(f"[standby {self.standby_id}] {ev}", flush=True)

    def _apply_records(self, records: list[tuple[str, dict]]) -> None:
        """Fold tailed records in; a snapshot record after the first sync is
        checked byte for byte against the replay."""
        for kind, fields in records:
            if kind == "snapshot" and self.synced.is_set():
                mine = self.state.snapshot_bytes()
                theirs = self._state_cls.from_snapshot(fields["state"]).snapshot_bytes()
                if mine != theirs:
                    # records were lost or applied differently: the evidence
                    # first, then the primary's snapshot
                    self._note({"kind": "journal_gap", "applied": self.state.applied,
                                "mine": len(mine), "theirs": len(theirs)})
                    self.state.apply(kind, fields)
                continue
            self.state.apply(kind, fields)
            if kind == "snapshot" and not self.synced.is_set():
                self._note({"kind": "standby_synced", "epoch": self.state.epoch,
                            "world": self.state.world})
                self.synced.set()

    def _run(self) -> None:
        """Tail until the takeover lease lapses, then promote.  ``alive_at``
        moves with every byte of the stream and every read of new frames
        from the file."""
        alive_at = time.monotonic()
        chan: socket.socket | None = None
        buf = bytearray()
        file_pos = 0
        file_id: tuple[int, int] | None = None
        while not self._stop.is_set():
            if time.monotonic() - alive_at > self.takeover_sec:
                if chan is not None:
                    try:
                        chan.close()
                    except OSError:
                        pass
                self._take_over()
                return
            if self.primary is not None:
                if chan is None:
                    chan = self._dial_primary()
                    if chan is not None:
                        buf = bytearray()
                if chan is not None:
                    got = self._pump_channel(chan, buf)
                    if got is None:  # the channel died
                        try:
                            chan.close()
                        except OSError:
                            pass
                        chan = None
                    elif got:
                        alive_at = time.monotonic()
                    continue  # the pump's receive timeout paced this pass
            if self.journal_path is not None:
                file_pos, file_id, fresh = self._tail_file(file_pos, file_id)
                if fresh:
                    alive_at = time.monotonic()
            self._stop.wait(self.poll_sec)

    def _dial_primary(self) -> socket.socket | None:
        try:
            chan = socket.create_connection(self.primary, timeout=1.0)
        except OSError:
            return None
        try:
            chan.settimeout(1.0)
            P.send_hello(chan, P.CMD_JOURNAL, self.standby_id)
            if P.get_u32(chan) != P.ACK:
                chan.close()
                return None
            chan.settimeout(self.poll_sec)
            return chan
        except (ConnectionError, OSError, ValueError):
            chan.close()
            return None

    def _pump_channel(self, chan: socket.socket, buf: bytearray) -> bool | None:
        """One bounded read and parse: True when bytes arrived, False on a
        quiet pass, None when the channel died."""
        try:
            data = chan.recv(65536)
        except socket.timeout:
            return False
        except OSError:
            return None
        if not data:
            return None
        buf += data
        records, consumed, err = P.journal_frames_from_buffer(bytes(buf))
        del buf[:consumed]
        self._apply_records(records)
        if err is not None:
            self._note({"kind": "journal_gap", "transport": "stream", "error": err})
            return None  # a fresh snapshot comes with the next channel
        return True

    def _tail_file(self, pos: int, fid: tuple[int, int] | None
                   ) -> tuple[int, tuple[int, int] | None, bool]:
        """Read the complete frames past ``pos``; after a compaction (a new
        inode, or a file shorter than ``pos``) read from the start."""
        try:
            st = os.stat(self.journal_path)
        except OSError:
            return pos, fid, False
        if fid is not None and (st.st_ino != fid[0] or st.st_size < pos):
            pos = 0  # compacted: the file starts with a snapshot now
        fid = (st.st_ino, st.st_size)
        if st.st_size <= pos:
            return pos, fid, False
        try:
            with open(self.journal_path, "rb") as f:
                f.seek(pos)
                data = f.read()
        except OSError:
            return pos, fid, False
        records, consumed, err = P.journal_frames_from_buffer(data)
        self._apply_records(records)
        if records and not self.synced.is_set():
            # a file tailed from its first byte is consistent from its first
            # record (the stream waits for its snapshot)
            self._note({"kind": "standby_synced", "epoch": self.state.epoch,
                        "world": self.state.world})
            self.synced.set()
        if err is not None:
            # damage mid-file: stop before it; the primary's next compaction
            # rewrites the file and the tailer reads it again
            self._note({"kind": "journal_gap", "transport": "file", "error": err})
        return pos + consumed, fid, bool(records)

    # -- the takeover ------------------------------------------------------------

    def _take_over(self) -> None:
        from rabit_tpu_torch.tracker.tracker import Tracker

        if self._stop.is_set():
            return
        ev = {"kind": "tracker_failover", "standby": self.standby_id,
              "epoch": self.state.epoch, "world": self.state.world,
              "synced": self.synced.is_set()}
        if self.service:
            ev["jobs"] = self.state.n_jobs
        self._note(ev)
        kwargs = dict(self.tracker_kwargs)
        kwargs.setdefault("quiet", self.quiet)
        journal = Journal(self.promoted_journal, state=self.state) if self.promoted_journal \
            else None
        # The tracker listens on the bound socket (listen_sock=): only now do
        # the clients' rotations start landing here.
        if self.service:
            # a whole service: every live job's partition is admitted again
            # from the replayed ServiceState
            from rabit_tpu_torch.service.service import CollectiveService

            tracker = CollectiveService(self.state.world or 1, listen_sock=self._sock,
                                        resume_from=self.state, journal=journal, **kwargs)
        else:
            tracker = Tracker(self.state.base_world or self.state.world or 1,
                              listen_sock=self._sock, resume_from=self.state, journal=journal,
                              **kwargs)
        with self._lock:
            tracker.events[:0] = self.events
        self.tracker = tracker
        tracker.start()
        self.promoted.set()
        if not self.quiet:
            print(f"[standby {self.standby_id}] promoted to primary at {self.host}:{self.port} "
                  f"(epoch {self.state.epoch}, world {self.state.world})", flush=True)
