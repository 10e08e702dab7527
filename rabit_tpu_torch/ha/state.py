"""The control plane as a replayable state machine.

The port's own copy of ``rabit_tpu/ha/state.py``.  What the tracker must
not lose with its process (the rank assignments, the epoch line, the lease
grants, the spare pool, the frozen quorum records, the flagged links, the
planned ring) lives in one :class:`ControlState`, changed only by
:meth:`apply`-ing journal records (``ha.journal``).  The primary appends a
record at every mutation, a warm standby replays the same records, and both
must reach the same bytes, so the representation is plain:

* every field is JSON data (dicts keyed by strings, sorted at snapshot
  time): no sockets, clocks or object identities;
* :meth:`snapshot_bytes` is canonical (sorted keys, no whitespace), so
  "the standby's state is the primary's" is one byte comparison, and the
  two packages' ``ControlState`` give the same bytes for the same records;
* an unknown record kind (the ``tick`` keepalive) is ignored and a
  malformed one dropped: a journal is evidence, and its replay recovers
  whatever prefix is intact.

Left out on purpose: the lease deadlines (a promoted tracker re-arms every
journaled lease with a fresh deadline), the bootstrap blob's bytes (only its
version: rank 0 uploads it again after its next commit) and telemetry.
"""

from __future__ import annotations

import json


def _qkey(a: int, b: int) -> str:
    """JSON-safe key for an (int, int) pair (epoch:version, sv:rank)."""
    return f"{int(a)}:{int(b)}"


def _unqkey(key: str) -> tuple[int, int]:
    a, _, b = key.partition(":")
    return int(a), int(b)


class ControlState:
    """One tracker's replayable control-plane state (module docstring)."""

    def __init__(self) -> None:
        self.base_world = 0
        self.world = 0
        self.epoch = -1
        self.rank_map: dict[str, int] = {}    # current epoch's assignment
        self.ranks: dict[str, int] = {}       # all-time stable ranks
        self.n_starts: dict[str, int] = {}    # CMD_START admissions per task
        self.epochs: list[list[int]] = []     # [[epoch, world], ...]
        self.leases: dict[str, list] = {}     # task -> [interval, rank]
        self.spares: list[str] = []           # parked spares, pool order
        self.blob_version = 0                 # newest cached bootstrap blob
        self.shutdown: list[str] = []         # tasks that shut down cleanly
        self.link_flags: list[list[str]] = []  # [[src_task, dst_task], ...]
        self.sched_algo = ""
        self.last_ring: list[int] = []
        # the delivery plane's version line, the newest published
        # {version, epoch, digest, size} ({} before any): the tracker
        # journals each as ``snapshot_published``, and a rabit_tpu journal's
        # replays to the same bytes
        self.delivery: dict = {}
        # the quorum ledgers, mirroring quorum.QuorumTable
        self.q_records: dict[str, dict] = {}       # "epoch:v" -> record
        self.q_outstanding: dict[str, int] = {}    # "sv:rank" -> world
        self.q_late_seen: list[str] = []           # "sv:rank"
        self.q_streak: dict[str, int] = {}         # str(rank) -> streak
        self.applied = 0  # records folded in (snapshot resets it too)

    # -- record application -------------------------------------------------

    def apply(self, kind: str, fields: dict) -> None:
        """Fold one journal record in.  Must stay deterministic: the
        primary's mirror and every standby replay the identical
        sequence and are byte-compared."""
        try:
            getattr(self, f"_apply_{kind}", self._apply_ignore)(fields)
        except (KeyError, TypeError, ValueError):
            return  # a malformed record must not poison the replay
        self.applied += 1

    def _apply_ignore(self, fields: dict) -> None:
        pass  # tick keepalives, future record kinds

    def _apply_init(self, f: dict) -> None:
        self.base_world = int(f["base_world"])
        if self.world == 0:
            self.world = self.base_world

    def _apply_wave(self, f: dict) -> None:
        self.epoch = int(f["epoch"])
        self.world = int(f["world"])
        self.rank_map = {str(t): int(r) for t, r in f["rank_map"].items()}
        self.ranks.update(self.rank_map)
        for t in f.get("started", ()):
            self.n_starts[str(t)] = self.n_starts.get(str(t), 0) + 1
        gone = set(self.rank_map) | set(map(str, f.get("promoted", ())))
        self.spares = [s for s in self.spares if s not in gone]
        self.epochs.append([self.epoch, self.world])
        # the epoch boundary settles the quorum ledger by dropping, and
        # records of older epochs are pruned (QuorumTable.epoch_changed)
        self.q_outstanding = {}
        self.q_late_seen = []
        self.q_streak = {}
        self.q_records = {k: r for k, r in self.q_records.items()
                          if _unqkey(k)[0] >= self.epoch}

    def _apply_spare_park(self, f: dict) -> None:
        t = str(f["task_id"])
        self.spares = [s for s in self.spares if s != t] + [t]
        self.blob_version = max(self.blob_version,
                                int(f.get("blob_version", 0)))

    def _apply_spare_drop(self, f: dict) -> None:
        gone = set(map(str, f["task_ids"]))
        self.spares = [s for s in self.spares if s not in gone]

    def _apply_lease(self, f: dict) -> None:
        self.leases[str(f["task_id"])] = [float(f["interval"]),
                                          int(f["rank"])]

    def _apply_lease_drop(self, f: dict) -> None:
        self.leases.pop(str(f["task_id"]), None)

    def _apply_shutdown(self, f: dict) -> None:
        t = str(f["task_id"])
        if t not in self.shutdown:
            self.shutdown.append(t)
            self.shutdown.sort()
        self.leases.pop(t, None)

    def _apply_link_flag(self, f: dict) -> None:
        pair = [str(f["src"]), str(f["dst"])]
        if pair not in self.link_flags:
            self.link_flags.append(pair)
            self.link_flags.sort()

    def _apply_sched(self, f: dict) -> None:
        self.sched_algo = str(f.get("algo", ""))
        self.last_ring = [int(r) for r in f.get("ring", ())]

    def _apply_blob(self, f: dict) -> None:
        self.blob_version = max(self.blob_version, int(f["version"]))

    def _apply_snapshot_published(self, f: dict) -> None:
        line = {"version": int(f["version"]), "epoch": int(f["epoch"]),
                "digest": str(f["digest"]), "size": int(f["size"])}
        if line["version"] >= int(self.delivery.get("version", 0)):
            self.delivery = line

    def _apply_quorum_freeze(self, f: dict) -> None:
        """A round's exclusion record froze: mirror QuorumTable.report's
        decided branch (corrections retired, exclusions outstanding,
        streaks advanced)."""
        epoch, version = int(f["epoch"]), int(f["version"])
        world = int(f["world"])
        rec = dict(f["record"])
        self.q_records[_qkey(epoch, version)] = rec
        for sv, r in rec.get("corrections", ()):
            self.q_outstanding.pop(_qkey(sv, r), None)
        excluded = {int(r) for r in rec.get("excluded", ())}
        for r in sorted(excluded):
            self.q_outstanding[_qkey(version, r)] = world
        for r in range(world):
            key = str(r)
            if r in excluded:
                self.q_streak[key] = self.q_streak.get(key, 0) + 1
            else:
                self.q_streak[key] = 0

    def _apply_quorum_late(self, f: dict) -> None:
        key = _qkey(int(f["src_version"]), int(f["rank"]))
        if key not in self.q_late_seen:
            self.q_late_seen.append(key)
            self.q_late_seen.sort()

    def _apply_snapshot(self, f: dict) -> None:
        self.load_snapshot(f["state"])

    # -- snapshots ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The full state as one plain JSON document (the compaction
        head record's payload, and the unit the determinism gate
        compares)."""
        return {
            "base_world": self.base_world,
            "world": self.world,
            "epoch": self.epoch,
            "rank_map": dict(self.rank_map),
            "ranks": dict(self.ranks),
            "n_starts": dict(self.n_starts),
            "epochs": [list(e) for e in self.epochs],
            "leases": {t: list(v) for t, v in self.leases.items()},
            "spares": list(self.spares),
            "blob_version": self.blob_version,
            "shutdown": sorted(self.shutdown),
            "link_flags": sorted(list(p) for p in self.link_flags),
            "sched_algo": self.sched_algo,
            "last_ring": list(self.last_ring),
            "delivery": dict(self.delivery),
            "q_records": {k: dict(r) for k, r in self.q_records.items()},
            "q_outstanding": dict(self.q_outstanding),
            "q_late_seen": sorted(self.q_late_seen),
            "q_streak": dict(self.q_streak),
        }

    def snapshot_bytes(self) -> bytes:
        """CANONICAL byte encoding of :meth:`snapshot` — sorted keys, no
        whitespace — so replay determinism is one byte comparison."""
        return json.dumps(self.snapshot(), sort_keys=True,
                          separators=(",", ":")).encode()

    def load_snapshot(self, snap: dict) -> None:
        fresh = ControlState()
        fresh.base_world = int(snap.get("base_world", 0))
        fresh.world = int(snap.get("world", 0))
        fresh.epoch = int(snap.get("epoch", -1))
        fresh.rank_map = {str(t): int(r)
                          for t, r in snap.get("rank_map", {}).items()}
        fresh.ranks = {str(t): int(r)
                       for t, r in snap.get("ranks", {}).items()}
        fresh.n_starts = {str(t): int(n)
                          for t, n in snap.get("n_starts", {}).items()}
        fresh.epochs = [[int(e), int(w)] for e, w in snap.get("epochs", ())]
        fresh.leases = {str(t): [float(v[0]), int(v[1])]
                        for t, v in snap.get("leases", {}).items()}
        fresh.spares = [str(s) for s in snap.get("spares", ())]
        fresh.blob_version = int(snap.get("blob_version", 0))
        fresh.shutdown = sorted(str(t) for t in snap.get("shutdown", ()))
        fresh.link_flags = sorted([str(a), str(b)]
                                  for a, b in snap.get("link_flags", ()))
        fresh.sched_algo = str(snap.get("sched_algo", ""))
        fresh.last_ring = [int(r) for r in snap.get("last_ring", ())]
        fresh.delivery = dict(snap.get("delivery", {}))
        fresh.q_records = {str(k): dict(r)
                           for k, r in snap.get("q_records", {}).items()}
        fresh.q_outstanding = {str(k): int(w) for k, w in
                               snap.get("q_outstanding", {}).items()}
        fresh.q_late_seen = sorted(str(k)
                                   for k in snap.get("q_late_seen", ()))
        fresh.q_streak = {str(r): int(n)
                          for r, n in snap.get("q_streak", {}).items()}
        self.__dict__.update(fresh.__dict__)

    @classmethod
    def from_snapshot(cls, snap: dict) -> "ControlState":
        state = cls()
        state.load_snapshot(snap)
        return state

    # -- derived views (what a promoted tracker seeds itself from) ----------

    def quorum_seed(self) -> dict:
        """The QuorumTable restore payload (``quorum.QuorumTable.seed``):
        the frozen records and the three ledgers, in the table's key
        shapes."""
        return {
            "records": {_unqkey(k): dict(r)
                        for k, r in self.q_records.items()},
            "outstanding": {_unqkey(k): w
                            for k, w in self.q_outstanding.items()},
            "late_seen": {_unqkey(k) for k in self.q_late_seen},
            "streak": {int(r): n for r, n in self.q_streak.items()},
        }
