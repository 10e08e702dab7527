"""The control-plane journal: append, compact, stream.

The port's own copy of ``rabit_tpu/ha/journal.py``.  One :class:`Journal`
owns one writer thread fed by a queue: every tracker mutation enqueues a
``(kind, fields)`` record (non-blocking, safe under the tracker's lock),
and the writer frames it (``protocol.put_journal_frame``: crc'd and
codec-tagged), appends it to the journal file when there is one, folds it
into the in-memory :class:`~rabit_tpu_torch.ha.state.ControlState` mirror
and hands the frame to every subscriber (the CMD_JOURNAL channels of warm
standbys).  One writer puts file, mirror and subscribers in one total
order, which makes "the standby's replay is the primary's state" a byte
comparison.

Compaction: after ``snapshot_every`` records the writer rewrites the file
as one ``snapshot`` record (a temporary file renamed over it) and sends the
same frame to the subscribers, so a replay stays as long as the live state,
and every streaming standby gets a point where it checks its bytes against
the primary's (``journal_gap`` on a difference, then it adopts the
snapshot).

Opening an existing journal replays it (a torn tail reads as absent) and
compacts it at once.  A caller-supplied ``state`` is authoritative (a
promoted standby has replayed this very file or its stream), so the file is
compacted under it and not applied again.  ``path=None`` keeps the journal
in memory: the mirror and the stream still work, which is all a streamed
standby needs.  Records are flushed, not fsync'd unless ``fsync=True``: a
lost tail record costs one re-formed wave, never a wrong bit.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable

from rabit_tpu_torch.ha.state import ControlState
from rabit_tpu_torch.tracker import protocol as P


def read_journal(path: str) -> tuple[list[tuple[str, dict]], bool]:
    """Every intact record of a journal file, and whether a partial or
    damaged frame followed them (it stays on disk: the next writer compacts
    over it)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], False
    records, consumed, err = P.journal_frames_from_buffer(data)
    return records, (err is not None or consumed < len(data))


def replay(records: list[tuple[str, dict]], state: ControlState | None = None) -> ControlState:
    """Fold ``records`` into ``state`` (a fresh one by default)."""
    state = state if state is not None else ControlState()
    for kind, fields in records:
        state.apply(kind, fields)
    return state


class Journal:
    """One tracker's journal.  ``state`` seeds the mirror; ``on_event``
    receives the writer's ``journal_snapshot`` and ``journal_gap`` event
    dicts (the tracker adds them to its timeline)."""

    def __init__(self, path: str | None = None, codec: str = "zlib",
                 snapshot_every: int = 256, state: ControlState | None = None,
                 on_event: Callable[[dict], None] | None = None, fsync: bool = False,
                 seeded: bool | None = None):
        self.path = path
        self.codec = codec
        self.snapshot_every = max(int(snapshot_every), 1)
        self.fsync = bool(fsync)
        self.on_event = on_event
        self._state = state if state is not None else ControlState()
        self._lock = threading.Lock()  # mirror reads against the writer's applies
        self._subs: list[queue.Queue] = []
        self._q: queue.Queue = queue.Queue()
        self._file = None
        self._since_snapshot = 0
        self.n_appended = 0
        self.n_snapshots = 0
        self._closed = threading.Event()
        # A supplied state is the replay of the file already, unless the
        # caller says otherwise (seeded=False: a fresh mirror to replay into).
        self._seeded = (state is not None) if seeded is None else bool(seeded)
        if path:
            self._bootstrap_file(path)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rabit-torch-ha-journal")
        self._thread.start()

    # -- any thread: everything enqueues -------------------------------------

    def append(self, kind: str, **fields) -> None:
        """Record one mutation.  Non-blocking: the framing, the write and
        the fan-out happen on the writer thread, in enqueue order."""
        if not self._closed.is_set():
            self._q.put(("rec", kind, fields))

    def subscribe(self) -> queue.Queue:
        """A live frame stream that starts with a snapshot of the mirror
        and then carries every later record: no gap, no duplicate."""
        sub: queue.Queue = queue.Queue()
        self._q.put(("sub", sub))
        return sub

    def unsubscribe(self, sub: queue.Queue) -> None:
        self._q.put(("unsub", sub))

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait until every record enqueued so far is written and handed
        out."""
        done = threading.Event()
        self._q.put(("flush", done))
        return done.wait(timeout)

    def close(self) -> None:
        self._closed.set()
        self._q.put(None)
        self._thread.join(timeout=5.0)

    def state_bytes(self) -> bytes:
        """The mirror's canonical snapshot bytes."""
        with self._lock:
            return self._state.snapshot_bytes()

    def state_snapshot(self) -> dict:
        with self._lock:
            return self._state.snapshot()

    # -- the writer ------------------------------------------------------------

    def _bootstrap_file(self, path: str) -> None:
        """Open the file, replaying (unless seeded) and compacting what it
        holds, on the constructing thread, so the mirror is ready before the
        tracker mutates anything."""
        records, torn = read_journal(path)
        if records and not self._seeded:
            with self._lock:
                replay(records, self._state)
        if torn:
            self._emit({"kind": "journal_gap", "path": path, "records": len(records)})
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if records or torn:
            self._compact()  # a clean snapshot head over the old history
        else:
            self._file = open(path, "ab")

    def _emit(self, event: dict) -> None:
        if self.on_event is not None:
            try:
                self.on_event(event)
            except Exception:  # noqa: BLE001 (telemetry must not stop the writer)
                pass

    def _snapshot_frame(self) -> bytes:
        with self._lock:
            snap = self._state.snapshot()
        return P.put_journal_frame("snapshot", {"state": snap}, self.codec)

    def _compact(self) -> None:
        """Rewrite the file as one snapshot record (temporary file, then
        rename) and send the same frame to the subscribers."""
        frame = self._snapshot_frame()
        if self.path:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(frame)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._file = open(self.path, "ab")
        for sub in self._subs:
            sub.put(frame)
        self._since_snapshot = 0
        self.n_snapshots += 1
        self._emit({"kind": "journal_snapshot", "n": self.n_snapshots, "nbytes": len(frame)})

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                break
            op = item[0]
            if op == "rec":
                _, kind, fields = item
                frame = P.put_journal_frame(kind, fields, self.codec)
                with self._lock:
                    self._state.apply(kind, fields)
                if self._file is not None:
                    try:
                        self._file.write(frame)
                        self._file.flush()
                        if self.fsync:
                            os.fsync(self._file.fileno())
                    except OSError:
                        pass  # a full disk must not take the tracker down
                for sub in self._subs:
                    sub.put(frame)
                self.n_appended += 1
                self._since_snapshot += 1
                if self._since_snapshot >= self.snapshot_every:
                    self._compact()
            elif op == "sub":
                sub = item[1]
                sub.put(self._snapshot_frame())
                self._subs.append(sub)
            elif op == "unsub":
                if item[1] in self._subs:
                    self._subs.remove(item[1])
            elif op == "flush":
                item[1].set()
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
