"""The port's tracker: the core of ``rabit_tpu/tracker`` that rabit's C++
engine needs (start, recover, print, shutdown) and the liveness and
telemetry commands of ``obs`` (metrics, heartbeat).

``protocol`` holds the wire format and ``tracker_rpc``, ``tracker.Tracker``
the rank assignment, the bootstrap and recovery waves, the heartbeat
leases and telemetry.json, ``launcher.LocalCluster`` a cluster of local
worker processes under one tracker, restarted when they die or, silent
past their lease, are killed.  Pure Python: importing it loads no torch.
"""
