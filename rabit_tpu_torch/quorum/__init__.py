"""Quorum rounds: a straggler-tolerant K-of-N partial allreduce.

The port's own copy of ``rabit_tpu/quorum``.  A collective round of rabit's
lockstep ring is as slow as its slowest worker.  In quorum mode a round
completes once **K of N** contributions have folded; a straggler's late
blocks land as **correction terms** at the next round that holds them; and
a per-round **exclusion record**, frozen once by the tracker, keeps every
rank's fold (and every replay after a recovery) bitwise the same.

* ``policy``: the ``rabit_quorum`` spec (a fraction or a count) resolved
  to K for the current world (``parse_spec``, ``quorum_count``);
* ``table``: the tracker's ledger (``QuorumTable``): decide-once records,
  the outstanding corrections (dropped at an epoch boundary), the
  late-delivery events and the exclusion streaks that flag a persistent
  straggler's incoming ring link;
* the executor is ``elastic.client.ElasticWorker(quorum=...)``: tagged
  block frames over the planned ring with skip links around a silent
  predecessor, one ``CMD_QUORUM`` report a round, rank-order folds.

The engines' collectives stay exact: quorum is a contract between the
tracker and the schedule-aware executor.  ``rabit_quorum=""`` (the
default) or ``"1.0"`` never excludes, so the results are bitwise the exact
path's.
"""

from rabit_tpu_torch.quorum.policy import (  # noqa: F401 (re-exports)
    parse_spec,
    quorum_count,
)
from rabit_tpu_torch.quorum.table import QuorumTable  # noqa: F401


def resolve(cfg) -> dict:
    """The quorum config keys as the tracker's and the worker's knobs.
    Raises ValueError on a malformed ``rabit_quorum``: a typo'd quorum must
    not quietly run exact."""
    spec = (cfg.get("rabit_quorum", "") or "").strip()
    if spec:
        parse_spec(spec)
    return {
        "quorum": spec,
        "wait_sec": float(cfg.get("rabit_quorum_wait_sec", "0.35") or "0.35"),
        "flag_after": cfg.get_int("rabit_quorum_flag_after", 3),
    }
