"""Pooled workers: warm processes leased to one job after another.

The port's own copy of ``rabit_tpu/service/pool.py``.  A
:class:`PooledWorker` is the client half of the service's pool: it parks
once a lease cycle under the reserved ``pool/<name>`` task id
(``CMD_SPARE``, the spares' park with its warm socket and cached blob),
waits to be leased into whichever job's wave the service fills next, runs
that job to its end in the ordinary
:class:`~rabit_tpu_torch.elastic.client.ElasticWorker` loop, and parks
again.  The process, its runtime and its heartbeat machinery stay warm
from one fit to the next.

The worker never learns a job key: its task id keeps the ``pool/`` prefix
through the lease, and the service routes its RPCs to the job it is leased
to.  It is released by an EOF on its park socket (the service died or
``stop`` was called) or when ``max_leases`` runs out.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from rabit_tpu_torch.elastic.client import ElasticResult, ElasticWorker
from rabit_tpu_torch.tracker import protocol as P


class PooledWorker:
    """One member of the pool (see the module docstring).

    ``contribution(version, world, rank)`` is the work of one round for
    every job the worker is leased to (jobs differ by world and rank here);
    ``max_leases=0`` goes on until the pool is released."""

    def __init__(self, tracker, name: str,
                 contribution: Callable[[int, int, int], np.ndarray], niter: int, *,
                 max_leases: int = 0, heartbeat_sec: float = 0.0, deadline_sec: float = 60.0,
                 rpc_timeout: float = 2.0, wave_timeout: float = 20.0, quorum: str = "",
                 codec: str = ""):
        self.tracker = tracker
        self.task_id = P.join_job(P.POOL_PREFIX, name)
        self.contribution = contribution
        self.niter = int(niter)
        self.max_leases = int(max_leases)
        self.heartbeat_sec = float(heartbeat_sec)
        self.deadline_sec = float(deadline_sec)
        self.rpc_timeout = float(rpc_timeout)
        self.wave_timeout = float(wave_timeout)
        self.quorum = quorum
        self.codec = codec
        self.results: list[ElasticResult] = []
        self._stop = threading.Event()
        self._current: ElasticWorker | None = None

    def stop(self) -> None:
        self._stop.set()
        cur = self._current
        if cur is not None:
            cur.stop()

    def run(self) -> list[ElasticResult]:
        """Park, be leased, fit, park again, until released or the lease
        budget is spent.  One ElasticResult a cycle (a last parked-only one
        marks the release)."""
        while not self._stop.is_set():
            worker = ElasticWorker(self.tracker, self.task_id, self.contribution, self.niter,
                                   spare=True, heartbeat_sec=self.heartbeat_sec,
                                   deadline_sec=self.deadline_sec, rpc_timeout=self.rpc_timeout,
                                   wave_timeout=self.wave_timeout, quorum=self.quorum,
                                   codec=self.codec)
            self._current = worker
            if self._stop.is_set():
                worker.stop()  # stop() came before this worker was current
            try:
                res = worker.run()
            finally:
                self._current = None
            self.results.append(res)
            if res.parked_only or not res.promoted or res.error:
                break  # released (the job is over, the service gone) or broken
            if self.max_leases and sum(1 for r in self.results if r.promoted) >= self.max_leases:
                break
        return self.results

    def start_thread(self) -> threading.Thread:
        """Run the lease loop on a daemon thread."""
        t = threading.Thread(target=self.run, daemon=True, name=f"pooled-{self.task_id}")
        t.start()
        return t
