"""The multi-tenant collective service: one control plane, many jobs.

The port's own copy of ``rabit_tpu/service/service.py``.  A plain
:class:`~rabit_tpu_torch.tracker.tracker.Tracker` bootstraps one job and
ends with it; a :class:`CollectiveService` keeps serving.  Each job is a
headless tracker partition (``Tracker(headless=True)``: its own membership
line, leases, spares, quorum records and telemetry) served on the
service's one reactor.  The wire does not change: a worker of job ``j``
prefixes its task id (``"j/0"``, ``protocol.join_job``), ``_route_hello``
splits the key off and hands the hello to the job's partition, and a bare
id goes to the "" job through the unrouted base-class code, byte for byte
what a plain tracker answers.

What the service adds to the partitions:

* admission control (:class:`~rabit_tpu_torch.service.registry.JobRegistry`):
  ``admit(key, world)`` checks the key, the service-wide and per-tenant job
  quotas and the rank budget; a refusal is an ``admission_refused`` event
  and, on the wire, a connection closed with no reply.  An unknown key's
  first hello is admitted at ``rabit_service_auto_world`` ranks, or refused
  when that is 0 (the default);
* one journal for every job: each partition's records ride the service's
  :class:`~rabit_tpu_torch.ha.journal.Journal` tagged with the job key
  (:class:`_JobJournal`), its mirror is a
  :class:`~rabit_tpu_torch.service.state.ServiceState`, and a reopened file
  or a standby's takeover (``Standby(service=True)``) restores every live
  job;
* one relay tier for every job: the job key rides in the route key, and
  the batch ACK carries a ``jobs`` map from which a relay answers each
  job's epoch and delivery polls;
* pooled workers: a worker parked as ``pool/<name>`` (``CMD_SPARE``) joins
  the service's pool and is leased into the waves of jobs admitted with
  ``pooled=True`` (``worker_leased``), one fit after another;
* telemetry a job: each partition writes ``telemetry-<job>.json``, the
  service ``telemetry-service.json``.

Partitions share the reactor and the journal's writer thread, nothing
else: a straggler, a kill or a quorum stall in one job moves that job's
waves and leases only.  One monitor pair ticks every partition's leases and
waves, so N jobs cost two threads, not 2N.
"""

from __future__ import annotations

import threading
import time

from rabit_tpu_torch.config import Config
from rabit_tpu_torch.obs import stream as obs_stream
from rabit_tpu_torch.service.registry import JobRegistry, tenant_of
from rabit_tpu_torch.service.state import ServiceState
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import MAX_MESSAGES, Tracker, _aggregate_incidents

#: The route-key prefix of a pooled worker: "pool/<name>".
_POOL_ROUTE = P.POOL_PREFIX + P.JOB_SEP


class AdmissionRefused(RuntimeError):
    """``admit`` hit a quota or an invalid key; the message is the reason,
    which an ``admission_refused`` event also carries."""


class _JobJournal:
    """One partition's view of the service's journal: every record it
    appends carries its job key, so one file holds every job's history in
    one order and :class:`ServiceState` replays each into its partition."""

    def __init__(self, journal, job: str):
        self._journal = journal
        self.job = job
        #: set by the partition's Tracker; the service folds the journal
        #: writer's events into its own timeline, so this one stays unused
        self.on_event = None

    def append(self, kind: str, **fields) -> None:
        self._journal.append(kind, job=self.job, **fields)

    def streamed(self, timeout: float = 5.0) -> bool:
        return self._journal.streamed(timeout)

    def close(self) -> None:
        pass  # the service owns the journal


class CollectiveService(Tracker):
    """One long-lived multi-job tracker (see the module docstring).

    The serving, schedule and quorum keywords are the :class:`Tracker`'s and
    every partition's defaults; ``world_size`` is the "" job's world and
    ``admit``'s default.  The quotas default to the ``rabit_service_*``
    config keys.  ``journal`` is a path (opened with a :class:`ServiceState`
    mirror: an existing file restores every live job) or a ready
    :class:`~rabit_tpu_torch.ha.journal.Journal` whose state is a
    ServiceState; ``resume_from`` is the replayed ServiceState a promoted
    standby restores the jobs from."""

    def __init__(self, world_size: int = 1, host: str = "127.0.0.1", port: int = 0,
                 quiet: bool = False, obs_dir: str | None = None,
                 conn_timeout_sec: float = 60.0, on_suspect=None,
                 shrink_after_sec: float = 0.0, min_world: int = 1,
                 promote_after_sec: float = 0.25, schedule: str = "auto",
                 sched_mesh: str = "", sched_repair: bool = True,
                 sched_wait_share: float = 0.25, quorum: str = "", quorum_flag_after: int = 3,
                 reactor: bool = True, backlog: int | None = None,
                 max_messages: int = MAX_MESSAGES, max_jobs: int | None = None,
                 max_jobs_per_tenant: int | None = None, max_ranks: int | None = None,
                 auto_world: int | None = None,
                 journal=None, resume_from: ServiceState | None = None,
                 listen_sock=None, ha_tick_sec: float | None = None):
        cfg = Config()
        if max_jobs is None:
            max_jobs = cfg.get_int("rabit_service_max_jobs", 0)
        if max_jobs_per_tenant is None:
            max_jobs_per_tenant = cfg.get_int("rabit_service_max_jobs_per_tenant", 0)
        if max_ranks is None:
            max_ranks = cfg.get_int("rabit_service_max_ranks", 0)
        if auto_world is None:
            auto_world = cfg.get_int("rabit_service_auto_world", 0)
        self.registry = JobRegistry(max_jobs=max_jobs, max_jobs_per_tenant=max_jobs_per_tenant,
                                    max_ranks=max_ranks)
        self.auto_world = int(auto_world)
        self._default_world = max(int(world_size), 1)
        # The partitions and the pooled workers' leases, under a lock of
        # their own that is never held across a partition's call.
        self._svc_lock = threading.Lock()
        self._parts: dict[str, Tracker] = {}
        self._pooled: set[str] = set()
        self._admitted_at: dict[str, float] = {}
        #: a pooled worker's whole task id -> the job it is leased to
        self._pool_leases: dict[str, str] = {}
        self._part_kwargs = dict(
            conn_timeout_sec=conn_timeout_sec, shrink_after_sec=shrink_after_sec,
            min_world=min_world, promote_after_sec=promote_after_sec, schedule=schedule,
            sched_mesh=sched_mesh, sched_repair=sched_repair,
            sched_wait_share=sched_wait_share, quorum=quorum,
            quorum_flag_after=quorum_flag_after, max_messages=max_messages)
        # The service serves as the job "service": its telemetry file is
        # telemetry-service.json, its journal records are tagged "service"
        # (ServiceState drops them), and its own waves are never fed a
        # worker (the routing owns every hello).
        super().__init__(self._default_world, host=host, port=port, quiet=quiet,
                         obs_dir=obs_dir, conn_timeout_sec=conn_timeout_sec,
                         on_suspect=on_suspect, schedule=schedule, sched_mesh=sched_mesh,
                         sched_repair=sched_repair, sched_wait_share=sched_wait_share,
                         reactor=reactor, backlog=backlog, max_messages=max_messages,
                         journal=None, listen_sock=listen_sock, ha_tick_sec=ha_tick_sec,
                         job="service")
        if isinstance(journal, str):
            from rabit_tpu_torch.ha.journal import Journal

            journal = Journal(journal,
                              state=resume_from if resume_from is not None else ServiceState(),
                              seeded=resume_from is not None,
                              snapshot_every=cfg.get_int("rabit_ha_snapshot_every", 256))
        self.journal = journal
        if self.journal is not None:
            self.journal.on_event = self._journal_event
            if resume_from is None:
                # a reopened file journal: restore every live job it holds
                snap = self.journal.state_snapshot()
                resume_from = (ServiceState.from_snapshot(snap)
                               if snap.get("jobs") or snap.get("service") else None)
        self._journal("init", base_world=self._default_world)
        if resume_from is not None:
            self._restore_jobs(resume_from)

    def _journal(self, kind: str, **fields) -> None:
        """The service's own records are tagged ``job="service"``; a record
        about one job passes its key."""
        if self.journal is not None:
            fields.setdefault("job", "service")
            self.journal.append(kind, **fields)

    # -- admission -----------------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        with self._lock:
            self.events.append({"ts": round(time.time(), 6), "kind": kind, **fields})

    def admit(self, key: str, world: int | None = None, *, pooled: bool = False) -> Tracker:
        """Admit one job: check the quotas, make its partition, journal the
        admission.  Returns the partition (its ``wait()`` is the job's end);
        raises :class:`AdmissionRefused` after an ``admission_refused``
        event.  ``pooled`` fills the job's waves from the service's pool of
        parked ``pool/`` workers."""
        world = int(world if world is not None else self._default_world)
        reason = self.registry.admit(key, world)
        if reason is not None:
            self._refuse(key, reason)
            raise AdmissionRefused(reason)
        part = self._make_partition(key, world, pooled=pooled)
        self._journal("job_admit", job=key, world=world, pooled=bool(pooled),
                      tenant=tenant_of(key))
        self._event("job_admitted", job=key, world=world, pooled=bool(pooled),
                    tenant=tenant_of(key))
        if not self.quiet:
            print(f"[service] job {key!r} admitted (world {world}"
                  f"{', pooled' if pooled else ''})", flush=True)
        return part

    def _refuse(self, key: str, reason: str) -> None:
        self._event("admission_refused", job=key, tenant=tenant_of(key), reason=reason)
        if not self.quiet:
            print(f"[service] job {key!r} REFUSED: {reason}", flush=True)

    def _wire_admit(self, key: str) -> Tracker | None:
        """A hello of an unknown job key: admit it at ``auto_world`` ranks,
        or refuse it (its connection closes with no reply)."""
        if self.auto_world <= 0:
            self._refuse(key, "unknown job (wire auto-admission is off; set "
                              "rabit_service_auto_world or admit() the job first)")
            return None
        try:
            return self.admit(key, self.auto_world)
        except AdmissionRefused:
            return None

    def _make_partition(self, key: str, world: int, pooled: bool = False,
                        resume=None) -> Tracker:
        part = Tracker(world, host=self.host, port=self.port, quiet=self.quiet,
                       obs_dir=self.obs_dir, on_suspect=self._suspect_cb(key),
                       reactor=self._reactor,
                       journal=(_JobJournal(self.journal, key)
                                if self.journal is not None else None),
                       resume_from=resume, job=key, headless=True, **self._part_kwargs)
        # One content-addressed snapshot store for every partition: tenants
        # that publish the same bytes hold one copy, and a publish's "have"
        # is true whichever job uploaded the digest first.
        part._snaps = self._snaps
        with self._svc_lock:
            self._parts[key] = part
            if pooled:
                self._pooled.add(key)
            self._admitted_at[key] = time.monotonic()
        return part

    def _suspect_cb(self, key: str):
        """A partition's lease expiry reaches the service's ``on_suspect``
        with the whole wire task id, so one callback serves every job."""
        def cb(task_id: str) -> None:
            if self.on_suspect is not None:
                self.on_suspect(task_id if task_id.startswith(_POOL_ROUTE)
                                else P.join_job(key, task_id))
        return cb

    def _restore_jobs(self, state: ServiceState) -> None:
        """Admit every live job of a replayed ServiceState again (a
        standby's takeover, or a reopened journal file): each partition
        resumes its ranks, epochs, quorum records and journaled leases as a
        single-job Tracker resumes from a ControlState."""
        for key in sorted(state.jobs):
            cs = state.jobs[key]
            meta = state.meta.get(key, {})
            world = int(meta.get("world") or cs.base_world or cs.world or 1)
            self.registry.admit(key, world, force=True)
            self._make_partition(key, world, pooled=bool(meta.get("pooled")), resume=cs)
            self._event("job_admitted", job=key, world=world, tenant=tenant_of(key),
                        pooled=bool(meta.get("pooled")), restored=True)
            if not self.quiet:
                print(f"[service] job {key!r} RESTORED from the journal (world {world}, "
                      f"epoch {cs.epoch})", flush=True)

    # -- routing -------------------------------------------------------------

    def partition(self, key: str) -> Tracker | None:
        """The live partition of ``key`` (None once it has finished)."""
        with self._svc_lock:
            return self._parts.get(key)

    def live_jobs(self) -> list[str]:
        with self._svc_lock:
            return sorted(self._parts)

    def _route_hello(self, task_id: str, cmd: int):
        route_id = task_id
        if route_id.startswith(("q#", "s#")):
            # a relayed quorum report (q#) or delivery RPC (s#) prefixes the
            # child's id: route on the id, reply under the whole route key
            route_id = route_id[2:]
        job, rest = P.split_job(route_id)
        if cmd == P.CMD_OBS:
            # A keyed scrape (or a relay's "<job>/#delta" frame) reaches its
            # job's partition; anything else gets the service's view.  A
            # scrape never admits a job.
            if job:
                part = self.partition(job)
                return (part, rest) if part is not None else (self, task_id)
            part = self.partition("") if rest == "#delta" else None
            return (part if part is not None else self), task_id
        if cmd in (P.CMD_SUB, P.CMD_SNAP):
            # A subscriber's poll or fetch reaches its job's partition while
            # the job lives, the service's view after; never admission.  The
            # digest store is shared, so a retired job's digest still
            # answers.
            if job:
                part = self.partition(job)
                return (part, rest) if part is not None else (self, task_id)
            part = self.partition("")
            return (part if part is not None else self), task_id
        if job == P.POOL_PREFIX:
            # A pooled worker: CMD_SPARE parks it in the service's pool (and
            # ends its lease); anything else follows its lease to its job.
            with self._svc_lock:
                if cmd == P.CMD_SPARE:
                    self._pool_leases.pop(route_id, None)
                    return self, task_id
                leased = self._pool_leases.get(route_id)
                part = self._parts.get(leased) if leased is not None else None
            return (part if part is not None else self), task_id
        if not job:
            part = self.partition("")
            if part is not None:
                return part, task_id
            # The first bare-id hello admits the "" job at the constructor's
            # world: the single-job path through a service.
            try:
                return self.admit("", self._default_world), task_id
            except AdmissionRefused:
                return None, "legacy job refused"
        part = self.partition(job)
        if part is None:
            part = self._wire_admit(job)
            if part is None:
                return None, "admission refused"
        return part, rest

    # -- monitors: one thread pair ticks every partition ----------------------

    def _parts_items(self) -> list[tuple[str, Tracker]]:
        with self._svc_lock:
            return sorted(self._parts.items())

    def _lease_tick(self, now: float) -> None:
        super()._lease_tick(now)
        for _key, part in self._parts_items():
            part._lease_tick(now)

    def _wave_tick(self) -> None:
        with self._lock:
            # a dead pooled worker leaves the pool before a lease could hand
            # a job its dead socket
            self._reap_spares_locked()
        for key, part in self._parts_items():
            if part._done.is_set():
                self._retire(key, part)
                continue
            with self._svc_lock:
                pooled = key in self._pooled
            if pooled:
                self._fill_from_pool(key, part)
            part._wave_tick()

    def _pool_parked_locked(self) -> int:
        return sum(1 for s in self._spares if s.task_id.startswith(_POOL_ROUTE))

    def _fill_from_pool(self, key: str, part: Tracker) -> None:
        """Lease parked ``pool/`` workers into a pooled job's forming wave:
        a fresh job's bootstrap wave (no epoch yet) and any later recovery
        wave (survivors pending) fill up to the job's world.  Each lease is a
        ``worker_leased`` event and an entry that routes the worker's RPCs
        to this partition until it parks again or the job ends."""
        with part._lock:
            if part._done.is_set():
                return
            need = part.world_size - len(part._pending)
            forming = part.elastic.epoch < 0 or bool(part._pending)
        if need <= 0 or not forming:
            return
        with self._lock:
            take = [s for s in self._spares if s.task_id.startswith(_POOL_ROUTE)][:need]
            if not take:
                return
            taken = set(map(id, take))
            self._spares = [s for s in self._spares if id(s) not in taken]
            pool_left = self._pool_parked_locked()
            ts = round(time.time(), 6)
            for s in take:
                self.events.append({"ts": ts, "kind": "worker_leased", "task_id": s.task_id,
                                    "job": key, "pool": pool_left})
        with self._svc_lock:
            for s in take:
                self._pool_leases[s.task_id] = key
        if not self.quiet:
            print(f"[service] leased {[s.task_id for s in take]} -> job {key!r} "
                  f"(pool {pool_left})", flush=True)
        with part._lock:
            for s in take:
                s.cmd, s.origin = P.CMD_START, "spare"
                part._pending.append(s)
            if part._wave_started is None:
                part._wave_started = time.monotonic()
            wave = part._close_wave_locked(timer=False)
        if wave is not None:
            part._send_wave(wave)

    def _retire(self, key: str, part: Tracker) -> None:
        """A finished job leaves the service: its quota slot and ranks free
        up, its pooled workers' leases end (they park again on their own),
        and a ``job_retired`` record drops it from the journal's live set."""
        with self._svc_lock:
            if self._parts.get(key) is not part:
                return  # a concurrent tick retired it
            self._parts.pop(key)
            self._pooled.discard(key)
            for tid in [t for t, j in self._pool_leases.items() if j == key]:
                self._pool_leases.pop(tid)
            admitted_at = self._admitted_at.pop(key, None)
        part.stop()  # the telemetry flush (once) and the spares' release
        self.registry.release(key)
        self._journal("job_retired", job=key)
        self._event("job_completed", job=key, world=part.world_size,
                    seconds=(round(time.monotonic() - admitted_at, 6)
                             if admitted_at is not None else -1.0))
        if not self.quiet:
            print(f"[service] job {key!r} completed "
                  f"({self.registry.stats()['live_jobs']} live)", flush=True)

    # -- relays ----------------------------------------------------------------

    def _batch_ack_info(self) -> dict:
        """The base document and a ``jobs`` map, each job's epoch line and
        delivery line, from which one relay answers every job's polls."""
        info = super()._batch_ack_info()
        jobs = {}
        for key, part in self._parts_items():
            jinfo = part._epoch_info()
            with part._lock:
                if part._delivery is not None:
                    jinfo["delivery"] = dict(part._delivery)
            jobs[key] = jinfo
        info["jobs"] = jobs
        return info

    # -- the scrape and telemetry ----------------------------------------------

    def _service_section(self) -> dict:
        with self._lock:
            pool = self._pool_parked_locked()
        return {**self.registry.stats(), "live": self.live_jobs(), "pool_parked": pool,
                "auto_world": self.auto_world}

    def build_scrape(self, opts: dict | None = None) -> dict:
        """The service's ``CMD_OBS`` document: its own section and a
        ``tenants`` map, tenant -> job -> the job's live section, each
        tenant with its wire bytes split by (codec, fused) from its jobs'
        rollups."""
        doc = super().build_scrape(opts)
        doc["service"] = self._service_section()
        tenants: dict[str, dict] = {}
        for key, part in self._parts_items():
            jdoc = part._scrape_job_state()
            tenant = tenants.setdefault(tenant_of(key),
                                        {"jobs": {}, "wire_bytes": {}, "wire_bytes_total": 0})
            tenant["jobs"][key] = jdoc
            for codec, n in obs_stream.wire_bytes_by_codec(jdoc["stream"]["total"]).items():
                tenant["wire_bytes"][codec] = tenant["wire_bytes"].get(codec, 0) + n
                tenant["wire_bytes_total"] += n
        doc["tenants"] = tenants
        # the incidents digest over every job's section, not only the
        # service's own
        all_jobs = dict(doc["jobs"])
        for tenant in tenants.values():
            all_jobs.update(tenant["jobs"])
        doc["incidents"] = _aggregate_incidents(all_jobs)
        return doc

    def build_telemetry(self) -> dict:
        doc = super().build_telemetry()
        doc["service"] = {**self._service_section(),
                          "n_leased": sum(1 for e in doc["events"]
                                          if e["kind"] == "worker_leased")}
        return doc

    # -- lifecycle ---------------------------------------------------------------

    def stop(self) -> None:
        for _key, part in self._parts_items():
            part.stop()
        super().stop()

    def kill(self) -> None:
        for _key, part in self._parts_items():
            part.kill()
        super().kill()
