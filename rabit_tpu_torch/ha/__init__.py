"""The HA control plane: the tracker's journaled state and a warm standby
that takes over when the tracker dies.

The port's own copy of ``rabit_tpu/ha``.  A worker may die and the job goes
on; without this package the job still died with its tracker, the one
process that holds the ranks, the leases, the epoch line, the quorum records
and the plans.  Three pieces close that:

* :class:`~rabit_tpu_torch.ha.state.ControlState`: the control plane as a
  replayable state machine with a canonical byte snapshot;
* :class:`~rabit_tpu_torch.ha.journal.Journal`: every mutation appended as
  a crc'd, codec-tagged frame (``protocol.put_journal_frame``), compacted
  to the live state, written to ``rabit_ha_journal`` and/or streamed over
  ``CMD_JOURNAL``;
* :class:`~rabit_tpu_torch.ha.standby.Standby`: tails the journal, replays
  it (checked byte for byte at the primary's snapshots) and takes over on
  the primary's takeover lease; the workers fail over through
  ``rabit_tracker_addrs``.

Journals, standbys and trackers of this package and of ``rabit_tpu``'s
interoperate: the frames, the records and the snapshot bytes are the same.
``python -m rabit_tpu_torch.ha --primary HOST:PORT`` runs a standby alone.
"""

from rabit_tpu_torch.ha.journal import Journal, read_journal, replay
from rabit_tpu_torch.ha.standby import Standby
from rabit_tpu_torch.ha.state import ControlState

__all__ = ["ControlState", "Journal", "Standby", "read_journal", "replay"]
