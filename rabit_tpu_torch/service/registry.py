"""Admission control: which jobs a long-lived service lets in.

The port's own copy of ``rabit_tpu/service/registry.py``.  A
:class:`JobRegistry` is the bookkeeping side of the service: it validates
job keys (``protocol.job_key_error``), derives each job's tenant (the key up
to its first ``.``: ``"teamA.fit17"`` belongs to ``teamA``) and enforces
the quotas that keep one tenant's burst from starving the others:

* ``max_jobs``: concurrent jobs service-wide (0: unlimited);
* ``max_jobs_per_tenant``: concurrent jobs a tenant;
* ``max_ranks``: the sum of the admitted jobs' world sizes, which bounds
  the sockets a bootstrap wave holds at once.

A refusal is a reason string, never an exception: the serving path turns it
into an ``admission_refused`` event and a closed connection, and
``CollectiveService.admit`` raises it.  The registry holds no socket and no
clock.
"""

from __future__ import annotations

import threading

from rabit_tpu_torch.tracker import protocol as P

def tenant_of(key: str) -> str:
    """The tenant a job key belongs to: the key up to its first ``.``, the
    whole key when it has none, "" for the legacy job."""
    return key.split(".", 1)[0]


class JobRegistry:
    """Thread-safe admission bookkeeping (see the module docstring)."""

    def __init__(self, max_jobs: int = 0, max_jobs_per_tenant: int = 0, max_ranks: int = 0):
        self.max_jobs = int(max_jobs)
        self.max_jobs_per_tenant = int(max_jobs_per_tenant)
        self.max_ranks = int(max_ranks)
        self._lock = threading.Lock()
        self.jobs: dict[str, int] = {}  # key -> admitted world size
        self.n_admitted = 0
        self.n_refused = 0
        self.n_completed = 0

    @property
    def ranks_in_use(self) -> int:
        with self._lock:
            return sum(self.jobs.values())

    def check(self, key: str, world: int) -> str | None:
        """The reason ``admit`` would refuse the job, or None when it fits.
        Changes nothing."""
        reason = P.job_key_error(key)
        if reason is not None:
            return reason
        if world < 1:
            return f"invalid world size {world}"
        with self._lock:
            if key in self.jobs:
                return f"job {key!r} already live"
            if self.max_jobs > 0 and len(self.jobs) >= self.max_jobs:
                return f"service full: {len(self.jobs)}/{self.max_jobs} jobs live"
            if self.max_jobs_per_tenant > 0:
                tenant = tenant_of(key)
                mine = sum(1 for k in self.jobs if tenant_of(k) == tenant)
                if mine >= self.max_jobs_per_tenant:
                    return (f"tenant {tenant!r} full: {mine}/"
                            f"{self.max_jobs_per_tenant} jobs live")
            in_use = sum(self.jobs.values())
            if self.max_ranks > 0 and in_use + world > self.max_ranks:
                return f"rank budget exceeded: {in_use}+{world} > {self.max_ranks}"
        return None

    def admit(self, key: str, world: int, force: bool = False) -> str | None:
        """Admit a job, checking the quotas again; None on success, else the
        reason.  ``force`` skips the quotas: a failover restores every
        journaled live job, each inside its quota when it was admitted."""
        if not force:
            reason = self.check(key, world)
            if reason is not None:
                with self._lock:
                    self.n_refused += 1
                return reason
        with self._lock:
            if key in self.jobs:
                return f"job {key!r} already live"
            self.jobs[key] = max(int(world), 1)
            self.n_admitted += 1
        return None

    def release(self, key: str) -> None:
        """Free a finished job's slot and its ranks."""
        with self._lock:
            if self.jobs.pop(key, None) is not None:
                self.n_completed += 1

    def live(self) -> list[str]:
        with self._lock:
            return sorted(self.jobs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "live_jobs": len(self.jobs),
                "ranks_in_use": sum(self.jobs.values()),
                "n_admitted": self.n_admitted,
                "n_refused": self.n_refused,
                "n_completed": self.n_completed,
                "max_jobs": self.max_jobs,
                "max_jobs_per_tenant": self.max_jobs_per_tenant,
                "max_ranks": self.max_ranks,
            }
