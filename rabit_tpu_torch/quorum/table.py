"""The tracker's quorum ledger: one exclusion record a round.

The port's own copy of ``rabit_tpu/quorum/table.py``.  Every rank of a
quorum round must fold the same K contributions, or the folds diverge.
Workers report what they hold (``CMD_QUORUM``) and the first report that
meets the quorum freezes the round's record ``(epoch, version) ->
(excluded, corrections)``; every later report, the straggler's own included,
is answered with the same record, so a replay after a recovery reads the
same exclusions.

The table is bookkeeping only (no sockets, no clock); the tracker calls it
under its lock and records the events it returns.  Three ledgers ride
along:

* **outstanding**: ``(src_version, rank) -> world`` for each excluded
  contribution not yet folded; the deciding report of a later record that
  holds one folds it (``correction_folded``), and an epoch change drops
  them all (``correction_dropped``: ranks renumber at a wave);
* **late evidence**: the first report that holds an outstanding block
  gives ``contribution_late``;
* **streaks**: a rank excluded ``flag_after`` rounds in a row is handed
  back to the tracker, which flags its incoming ring link for the next
  wave's schedule repair.
"""

from __future__ import annotations

from rabit_tpu_torch.quorum.policy import parse_spec, quorum_count


class QuorumTable:
    """One job's quorum ledger.  Not thread-safe: the tracker holds its lock
    around every call."""

    def __init__(self, spec: str, flag_after: int = 3):
        parse_spec(spec)  # a typo'd spec fails at construction
        self.spec = str(spec)
        self.flag_after = max(int(flag_after), 0)
        #: (epoch, version) -> the frozen record (the CMD_QUORUM reply)
        self._records: dict[tuple[int, int], dict] = {}
        #: (src_version, rank) -> the world the exclusion happened at
        self._outstanding: dict[tuple[int, int], int] = {}
        self._late_seen: set[tuple[int, int]] = set()
        self._streak: dict[int, int] = {}

    def report(self, epoch: int, version: int, world: int, have: list[int],
               held: list) -> tuple[dict, list[dict], list[int]]:
        """Fold one worker's report in; returns ``(reply, events,
        flag_ranks)``: the frozen record (or an undecided placeholder), the
        telemetry events (without ``ts``), and the ranks whose exclusion
        streak just reached ``flag_after``."""
        events: list[dict] = []
        flags: list[int] = []
        held_t = sorted({(int(sv), int(r)) for sv, r in held})
        for t in held_t:
            if t in self._outstanding and t not in self._late_seen:
                self._late_seen.add(t)
                events.append({"kind": "contribution_late", "epoch": epoch,
                               "version": version, "src_version": t[0], "rank": t[1]})
        key = (int(epoch), int(version))
        rec = self._records.get(key)
        if rec is None:
            have_set = {int(r) for r in have if 0 <= int(r) < world}
            k = quorum_count(world, self.spec)
            if len(have_set) < k:
                return {"decided": False, "k": k, "version": version}, events, flags
            held_ok = [t for t in held_t if t in self._outstanding]
            excluded = sorted(set(range(world)) - have_set)
            rec = {"decided": True, "epoch": int(epoch), "version": int(version), "k": k,
                   "excluded": excluded, "corrections": [list(t) for t in held_ok]}
            self._records[key] = rec
            for t in held_ok:
                del self._outstanding[t]
            for r in excluded:
                self._outstanding[(int(version), r)] = int(world)
            if excluded:
                events.append({"kind": "quorum_met", "epoch": epoch, "version": version,
                               "k": k, "world": world, "n_have": len(have_set),
                               "excluded": excluded})
            for sv, r in held_ok:
                events.append({"kind": "correction_folded", "epoch": epoch,
                               "version": version, "src_version": sv, "rank": r})
            for r in range(world):
                if r in rec["excluded"]:
                    streak = self._streak.get(r, 0) + 1
                    self._streak[r] = streak
                    if self.flag_after and streak == self.flag_after:
                        flags.append(r)
                else:
                    self._streak[r] = 0
        return rec, events, flags

    def has_record(self, epoch: int, version: int) -> bool:
        """True when the round's record is frozen (the tracker journals a
        freeze once)."""
        return (int(epoch), int(version)) in self._records

    def seed(self, seed: dict) -> None:
        """Restore the ledgers from a replayed control state
        (``ha.ControlState.quorum_seed``): a promoted tracker answers every
        decided round with the same frozen record."""
        self._records = {(int(e), int(v)): dict(r)
                         for (e, v), r in seed.get("records", {}).items()}
        self._outstanding = {(int(sv), int(r)): int(w)
                             for (sv, r), w in seed.get("outstanding", {}).items()}
        self._late_seen = {(int(sv), int(r)) for sv, r in seed.get("late_seen", ())}
        self._streak = {int(r): int(n) for r, n in seed.get("streak", {}).items()}

    def epoch_changed(self, epoch: int) -> list[tuple[int, int, int]]:
        """A wave committed ``epoch``: the outstanding corrections are
        dropped (returned as ``[(src_version, rank, world), ...]`` for the
        ``correction_dropped`` events) and the records of older epochs are
        pruned, so a redone round is decided afresh."""
        dropped = sorted((sv, r, w) for (sv, r), w in self._outstanding.items())
        self._outstanding.clear()
        self._late_seen.clear()
        self._streak.clear()
        self._records = {k: r for k, r in self._records.items() if k[0] >= int(epoch)}
        return dropped

    def outstanding(self) -> list[tuple[int, int, int]]:
        """Undelivered exclusions as ``(src_version, rank, world)``: the
        exact mass missing from the folds."""
        return sorted((sv, r, w) for (sv, r), w in self._outstanding.items())
