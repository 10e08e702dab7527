"""Every live job's control state as one replayable state machine.

The port's own copy of ``rabit_tpu/service/state.py``.  A
:class:`ServiceState` is to a service what
:class:`~rabit_tpu_torch.ha.state.ControlState` is to one tracker: it is
mutated by the same journal records, each carrying one more field, ``job``,
the key of the partition it belongs to.  One journal file (or
``CMD_JOURNAL`` stream) holds every live job's history interleaved in
commit order, and a replay restores every partition.

Routing rules:

* a record's ``job`` (default "") selects the partition, and the fold is
  exactly ``ControlState.apply``;
* a partition comes into being only through its ``init`` record or a
  ``job_admit`` record: stray records of jobs never admitted, and the
  untagged ``tick`` keepalives, are dropped;
* ``job_retired`` removes a finished job's partition, so a replay restores
  the jobs admitted and not yet finished;
* a ``snapshot`` record of a service state (it has the ``service`` key)
  replaces everything; a single-job snapshot goes into its partition like
  any other record, so a journal written by a plain tracker replays into
  the "" job;
* records tagged ``service`` (the service's own serving evidence) are
  dropped.

``snapshot_bytes`` is canonical (sorted keys, no whitespace), so "the
standby's replay is the primary's mirror" stays one byte comparison with
any number of jobs interleaved.
"""

from __future__ import annotations

import json

from rabit_tpu_torch.ha.state import ControlState

#: Record kinds that may create a partition.
_CREATE_KINDS = ("init", "job_admit")


class ServiceState:
    """Every live job's :class:`ControlState`, and the admission metadata a
    promoted service re-admits the partitions from."""

    def __init__(self) -> None:
        self.jobs: dict[str, ControlState] = {}
        #: per job, from its ``job_admit`` record: {"world", "pooled", "tenant"}
        self.meta: dict[str, dict] = {}
        self.applied = 0  # records folded in

    def job(self, key: str) -> ControlState:
        """The partition of ``key``, created empty when absent."""
        return self.jobs.setdefault(str(key), ControlState())

    def apply(self, kind: str, fields: dict) -> None:
        """Fold one journal record in (the module docstring's rules).  A
        malformed record is dropped and never poisons the replay."""
        fields = dict(fields or {})
        try:
            key = str(fields.pop("job", ""))
        except (TypeError, ValueError):
            return
        if key == "service":
            return  # the service's own serving evidence, never job state
        if kind == "snapshot":
            state = fields.get("state")
            if isinstance(state, dict) and state.get("service"):
                self.load_snapshot(state)
            else:
                self.job(key).apply(kind, fields)
            self.applied += 1
            return
        if kind == "job_admit":
            try:
                world = int(fields.get("world", 0))
            except (TypeError, ValueError):
                return
            self.meta[key] = {"world": world, "pooled": bool(fields.get("pooled")),
                              "tenant": str(fields.get("tenant", ""))}
            self.job(key)
            self.applied += 1
            return
        if kind == "job_retired":
            self.jobs.pop(key, None)
            self.meta.pop(key, None)
            self.applied += 1
            return
        if key not in self.jobs and kind not in _CREATE_KINDS:
            return  # keepalives and records of jobs never admitted
        self.job(key).apply(kind, fields)
        self.applied += 1

    def snapshot(self) -> dict:
        return {
            "service": 1,
            "jobs": {k: cs.snapshot() for k, cs in sorted(self.jobs.items())},
            "meta": {k: dict(m) for k, m in sorted(self.meta.items())},
        }

    def snapshot_bytes(self) -> bytes:
        """The canonical bytes (sorted keys, no whitespace)."""
        return json.dumps(self.snapshot(), sort_keys=True, separators=(",", ":")).encode()

    def load_snapshot(self, snap: dict) -> None:
        self.jobs = {str(k): ControlState.from_snapshot(s)
                     for k, s in (snap.get("jobs") or {}).items()}
        self.meta = {str(k): dict(m) for k, m in (snap.get("meta") or {}).items()}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "ServiceState":
        state = cls()
        state.load_snapshot(snap)
        return state

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    @property
    def epoch(self) -> int:
        """The "" job's epoch (-1 when it does not live), for the
        standby's log lines."""
        cs = self.jobs.get("")
        return cs.epoch if cs is not None else -1

    @property
    def world(self) -> int:
        cs = self.jobs.get("")
        return cs.world if cs is not None else 0
