"""Clock alignment against the tracker.

The port's copy of ``ClockSync`` and ``GLOBAL_CLOCK`` from
``rabit_tpu/obs/trace.py``: every timestamped tracker reply (metrics and
heartbeat ACKs) is one NTP-style sample of this worker's clock offset, and
the best estimate rides in each shipped snapshot and telemetry.json's
``clocks``.  The rest of that file (the cross-rank merger, the Chrome
export, the straggler report) is not ported yet.
"""

from __future__ import annotations

import math
import threading


class ClockSync:
    """NTP-style offset estimator for one worker against the tracker clock.

    Each timestamped tracker RPC yields ``offset = server_ts - midpoint``
    with error bound ``rtt / 2``; the estimator keeps the lowest-error
    sample (late samples win ties, so a long-running worker tracks drift
    at equal quality).  ``offset`` maps this process's ``time.time()``
    onto the tracker's: ``tracker_ts = worker_ts + offset``.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._offset = 0.0
        self._err = math.inf
        self._samples = 0

    def update(self, offset: float, err: float) -> None:
        with self._lock:
            self._samples += 1
            if err <= self._err:
                self._offset, self._err = float(offset), float(err)

    def reset(self) -> None:
        with self._lock:
            self._offset, self._err, self._samples = 0.0, math.inf, 0

    @property
    def samples(self) -> int:
        with self._lock:
            return self._samples

    def estimate(self) -> tuple[float, float] | None:
        """(offset_s, err_s), or None before the first sample."""
        with self._lock:
            if self._samples == 0:
                return None
            return self._offset, self._err

    def snapshot(self) -> dict | None:
        """JSON-able record shipped inside metric snapshots."""
        est = self.estimate()
        if est is None:
            return None
        return {"offset_s": round(est[0], 6), "err_s": round(est[1], 6),
                "samples": self.samples}


#: Process-wide clock estimate against this job's tracker (updated by
#: ``obs.ship`` on every timestamped RPC; shipped in snapshots).
GLOBAL_CLOCK = ClockSync()
