"""The port's tracker: the core of ``rabit_tpu/tracker`` that rabit's C++
engine needs (start, recover, print, shutdown), the liveness and
telemetry commands of ``obs`` (metrics, heartbeat) and the elastic
plane's (spare, epoch, blob).

``protocol`` holds the wire format and ``tracker_rpc``, ``tracker.Tracker``
the rank assignment, the bootstrap and recovery waves, the hot-spare
pool with its shrink and grow-back waves, the heartbeat leases and
telemetry.json, ``launcher.LocalCluster`` a cluster of local worker
processes (and hot spares) under one tracker, restarted when they die or,
silent past their lease, are killed.  Pure Python: importing it loads no
torch.
"""

from rabit_tpu_torch.tracker.tracker import Tracker

__all__ = ["Tracker", "LocalCluster"]


def __getattr__(name):
    # Lazy, so that ``python -m rabit_tpu_torch.tracker.launcher`` does not
    # import the launcher twice.
    if name == "LocalCluster":
        from rabit_tpu_torch.tracker.launcher import LocalCluster

        return LocalCluster
    raise AttributeError(name)
