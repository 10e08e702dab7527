"""The port's tracker: the core of ``rabit_tpu/tracker`` that rabit's C++
engine needs (start, recover, print, shutdown).

``protocol`` holds the wire format, ``tracker.Tracker`` the rank
assignment and the bootstrap and recovery waves, ``launcher.LocalCluster``
a cluster of local worker processes under one tracker, restarted when they
die.  Pure Python: importing it loads no torch.
"""
