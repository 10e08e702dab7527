"""Layered ``key=value`` configuration of the port's engine layer.

The port's own copy of what it needs from ``rabit_tpu/config.py`` (the port
imports nothing of the JAX package): built-in defaults, then the
environment (the ``DMLC_*`` spellings every rabit launcher hands a worker,
then ``RABIT_TPU_*``, which wins over them), then argv ``k=v`` pairs in
order (the last one wins), then keyword overrides.
"""

from __future__ import annotations

import os
from typing import Iterable, Mapping

# Environment variables of the rabit launchers, and the config key each
# sets (rabit_tpu/config.py's table; RABIT_TPU_* spellings win over them).
_ENV_TO_KEY = {
    "DMLC_TRACKER_URI": "rabit_tracker_uri",
    "DMLC_TRACKER_PORT": "rabit_tracker_port",
    "DMLC_TASK_ID": "rabit_task_id",
    "DMLC_ROLE": "rabit_role",
    "DMLC_NUM_ATTEMPT": "rabit_num_trial",
    "DMLC_WORKER_CONNECT_RETRY": "rabit_connect_retry",
    "RABIT_OBS_DIR": "rabit_obs_dir",
    "rabit_global_replica": "rabit_global_replica",
    "rabit_local_replica": "rabit_local_replica",
}

DEFAULTS: dict[str, str] = {
    # auto | torch | empty | native | robust | base | mock (engine/__init__.py)
    "rabit_engine": "auto",
    # The native engine (engine.native) and its tracker: the tracker's
    # address (NULL: none), this worker's task id and restart count (the
    # launcher sets them through DMLC_*), and the connect retries before a
    # missing tracker is an error.
    "rabit_tracker_uri": "NULL",
    "rabit_tracker_port": "9091",
    "rabit_task_id": "NULL",
    "rabit_num_trial": "0",
    "rabit_connect_retry": "5",
    # The native engine's performance envelope, with the reference's
    # defaults (allreduce_base.cc, allreduce_robust.cc): the element count
    # from which an allreduce takes the ring, the byte size from which a
    # tree reduce pipelines, the reduce buffer, the robust engine's global
    # and local replica counts, its watchdog (rabit_timeout on, after
    # rabit_timeout_sec), the bootstrap cache, debug prints, and TCP_NODELAY
    # on its sockets (on: with Nagle, a cold header write waits on the
    # peer's delayed ACK).  rabit_stall_timeout_sec has no default here: the
    # native library's own depends on the engine, and a value here would go
    # into its argv and override it.
    "rabit_reduce_ring_mincount": str(32 << 10),
    "rabit_tree_reduce_minsize": str(1 << 20),
    "rabit_reduce_buffer": "256M",
    "rabit_global_replica": "5",
    "rabit_local_replica": "2",
    "rabit_timeout": "1",
    "rabit_timeout_sec": "1800",
    "rabit_bootstrap_cache": "0",
    "rabit_debug": "0",
    "rabit_enable_tcp_no_delay": "1",
    # TorchEngine: "cuda" stages arrays on the card and uses NCCL, "cpu"
    # uses gloo.  The torch.distributed bootstrap falls back to the
    # standard MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK variables
    # where these are empty.
    "rabit_torch_device": "cuda",
    "rabit_torch_master_addr": "",
    "rabit_torch_master_port": "",
    "rabit_torch_world_size": "",
    "rabit_torch_rank": "",
    # Compressed collectives (compress): the default codec of api.allreduce
    # (identity|bf16|bf16x2|i8|i8x2; empty: exact), applied to float32
    # non-BITOR payloads of at least rabit_compress_min_bytes (a codec=
    # argument always wins); the lossless deflate stage of the host
    # transport's wire bytes; the byte codec (zlib) of api.broadcast.
    "rabit_compress_allreduce": "",
    "rabit_compress_min_bytes": "1024",
    "rabit_compress_wire_deflate": "1",
    "rabit_compress_broadcast": "",
    # The durable checkpoint spill (store): the directory every committed
    # checkpoint is also written to, and a fresh job resumes from (empty or
    # NULL: off); the byte codec of its frames.
    "rabit_checkpoint_dir": "",
    "rabit_checkpoint_compress": "zlib",
    # The fused quantized ring of TorchEngine (engine.fused): auto (on) | 1
    # | 0 (the host transport), and the most KiB a hop sends at once (0:
    # one send a hop).
    "rabit_fused_allreduce": "auto",
    "rabit_fused_chunk_kib": "256",
    # The ring order of the fused ring and the tracker's plans (sched):
    # auto|tree|ring|swing, the mesh model's dims "RxC[:nowrap]" (empty:
    # near-square), whether degraded-link reports trigger a repair replan
    # at the next epoch boundary, and the executor's wait-share threshold
    # for indicting its incoming link.
    "rabit_schedule": "auto",
    "rabit_sched_mesh": "",
    "rabit_sched_repair": "1",
    "rabit_sched_wait_share": "0.25",
    # Observability (obs): with rabit_obs_dir (or RABIT_OBS_DIR) set, a rank
    # dumps its flight recorder there on SIGTERM or when a collective is
    # stuck past rabit_obs_hang_sec, and the tracker writes telemetry.json
    # there.  rabit_obs_heartbeat_sec > 0 ships metric snapshots to the
    # tracker that often (finalize always ships one); rabit_obs_spill_sec >
    # 0 spills the ring that often; rabit_obs_max_files caps the dir's
    # flight dumps (oldest first; 0: no cap).
    "rabit_obs_dir": "",
    "rabit_obs_capacity": "2048",
    "rabit_obs_hang_sec": "300",
    "rabit_obs_heartbeat_sec": "0",
    "rabit_obs_spill_sec": "0",
    "rabit_obs_max_files": "256",
    # The task id a CMD_OBS scrape client identifies as (obs.top, benches).
    "rabit_obs_scrape": "obs",
    # Liveness: rabit_heartbeat_sec > 0 renews a lease with the tracker
    # that often, and the tracker suspects (the launcher SIGKILLs) a worker
    # silent for LEASE_FACTOR intervals; rabit_hang_abort_sec > 0 makes a
    # rank whose collective is stuck that long dump its ring and exit 11
    # (dump-then-die).
    "rabit_heartbeat_sec": "0",
    "rabit_hang_abort_sec": "0",
    # rabit_trace_exit=1: dump the ring as flight-*-exit.jsonl at finalize;
    # rabit_trace_clock_pings: timestamped round trips to the tracker before
    # the final snapshot, for its clock-offset estimate.
    "rabit_trace_exit": "0",
    "rabit_trace_clock_pings": "2",
    # Elastic worlds (elastic): rabit_spare=1 makes a worker a hot spare that
    # parks in the tracker's pool until it is promoted into a dead rank's
    # slot; rabit_shrink_after_sec > 0 lets a recovery wave close with the
    # survivors when no spare fills it in time (0: wait for a full wave);
    # rabit_min_world floors the shrink; rabit_spare_promote_sec is the
    # grace before a short wave takes a parked spare.
    "rabit_spare": "0",
    "rabit_shrink_after_sec": "0",
    "rabit_min_world": "1",
    "rabit_spare_promote_sec": "0.25",
    # The diagnosis plane (obs.diagnose): rabit_diag_enable runs the
    # tracker's HealthMonitor; rabit_diag_window_sec is its detection
    # window; an incident opens after rabit_diag_open_windows firing windows
    # in a row and resolves after rabit_diag_resolve_windows quiet ones;
    # windows whose total link wait is under rabit_diag_min_wait_sec are
    # noise; rabit_diag_link_share is the degraded-link concentration
    # threshold (the top link's share of the window's wait),
    # rabit_diag_hole_ratio the compute-straggler hole threshold (the quiet
    # link's wait against the mean), rabit_diag_storm_leases the lease
    # expiries over the recent windows that make a preemption storm.
    "rabit_diag_enable": "1",
    "rabit_diag_window_sec": "0.5",
    "rabit_diag_open_windows": "2",
    "rabit_diag_resolve_windows": "4",
    "rabit_diag_min_wait_sec": "0.05",
    "rabit_diag_link_share": "0.5",
    "rabit_diag_hole_ratio": "0.25",
    "rabit_diag_storm_leases": "3",
    # Quorum rounds (quorum): rabit_quorum is a fraction in (0, 1] of the
    # current world or an integer count; a round of an ElasticWorker in
    # quorum mode folds once that many contributions landed, and the late
    # ones fold as corrections later ("" keeps the exact lockstep rounds,
    # "1.0" runs the quorum wire but never excludes).  rabit_quorum_wait_sec
    # is the worker's deadline a round before it reports a partial quorum
    # and dials around a silent predecessor; rabit_quorum_flag_after flags a
    # rank excluded that many rounds in a row for the schedule repair (0:
    # never).
    "rabit_quorum": "",
    "rabit_quorum_wait_sec": "0.35",
    "rabit_quorum_flag_after": "3",
    # The multi-tenant service (service): rabit_job_key is the job this
    # worker belongs to; it prefixes the wire task id ("<job>/<task>"; ""
    # is the legacy single-job namespace, byte-identical on the wire), so a
    # CollectiveService routes the worker to its job's partition.
    # rabit_service_max_jobs, rabit_service_max_jobs_per_tenant and
    # rabit_service_max_ranks are the service's admission quotas (concurrent
    # jobs service-wide, concurrent jobs a tenant, the job key up to its
    # first ".", and the sum of admitted world sizes; 0 = unlimited).
    # rabit_service_auto_world is the world of a job admitted from the wire
    # (an unknown key's first check-in); 0 refuses unknown keys, so jobs are
    # admitted only through CollectiveService.admit.
    "rabit_job_key": "",
    "rabit_service_max_jobs": "0",
    "rabit_service_max_jobs_per_tenant": "0",
    "rabit_service_max_ranks": "0",
    "rabit_service_auto_world": "0",
    # The HA control plane (ha): rabit_tracker_addrs lists the tracker's
    # addresses, "host:port,host:port", the primary first and its warm
    # standby after it (every tracker message rotates through them);
    # rabit_ha_journal is the file the tracker journals every mutation to
    # ("" = journaling off); rabit_ha_snapshot_every is the records between
    # compactions; rabit_ha_takeover_sec the standby's takeover lease (how
    # long the primary may stay silent); rabit_ha_tick_sec the primary's
    # keepalive record cadence.
    "rabit_tracker_addrs": "",
    "rabit_ha_journal": "",
    "rabit_ha_snapshot_every": "256",
    "rabit_ha_takeover_sec": "1.0",
    "rabit_ha_tick_sec": "0.25",
    # Serving (tracker, relay): rabit_tracker_backlog is the tracker's
    # listen(2) backlog (a bootstrap wave is world_size connects at once,
    # and an overflowing backlog turns into SYN-retransmit latency);
    # rabit_relay_cache_bytes is each relay's blob cache budget (least
    # recently used beyond it).
    "rabit_tracker_backlog": "1024",
    "rabit_relay_cache_bytes": "256M",
    # The delivery plane (delivery): rabit_delivery_publish=1 has rank 0
    # publish every checkpoint commit as a content-addressed snapshot
    # through the tracker; rabit_delivery_poll_sec is a subscriber's poll
    # and retry cadence; rabit_checkpoint_keep is the durable store's
    # window of unpinned versions (the published version stays pinned).
    "rabit_delivery_publish": "0",
    "rabit_delivery_poll_sec": "0.5",
    "rabit_checkpoint_keep": "2",
}

_UNIT = {"B": 1, "K": 1 << 10, "M": 1 << 20, "G": 1 << 30}


def parse_unit(value: str) -> int:
    """``"256M"``-style sizes."""
    value = value.strip()
    if value and value[-1].upper() in _UNIT:
        return int(float(value[:-1]) * _UNIT[value[-1].upper()])
    return int(value)


class Config:
    """Merged configuration with typed accessors."""

    def __init__(self, args: Iterable[str] | None = None,
                 overrides: Mapping[str, str] | None = None):
        self._cfg = dict(DEFAULTS)
        for name, key in _ENV_TO_KEY.items():
            if name in os.environ:
                self._cfg[key] = os.environ[name]
        for name, val in os.environ.items():
            if name.startswith("RABIT_TPU_"):
                self._cfg[name[len("RABIT_TPU_"):].lower()] = val
        for arg in args or []:
            if "=" in arg:
                key, val = arg.split("=", 1)
                self._cfg[key] = val
        for key, val in (overrides or {}).items():
            self._cfg[key] = str(val)

    def get(self, key: str, default: str | None = None) -> str | None:
        return self._cfg.get(key, default)

    def get_int(self, key: str, default: int = 0) -> int:
        val = self._cfg.get(key)
        return default if val is None else int(val)

    def get_size(self, key: str, default: int = 0) -> int:
        val = self._cfg.get(key)
        return default if val is None else parse_unit(val)

    def get_bool(self, key: str, default: bool = False) -> bool:
        val = self._cfg.get(key)
        if val is None:
            return default
        return val.strip().lower() not in ("0", "false", "no", "off", "")

    def __getitem__(self, key: str) -> str:
        return self._cfg[key]

    def __contains__(self, key: str) -> bool:
        return key in self._cfg

    def as_dict(self) -> dict[str, str]:
        return dict(self._cfg)

    @property
    def torch_device(self) -> str:
        """``rabit_torch_device``: the device the port's engine and entry
        points run on ("cuda" unless set)."""
        return self.get("rabit_torch_device", "cuda") or "cuda"

    @property
    def timeout_sec(self) -> int:
        """The watchdog's bound in seconds; 0 when the watchdog is off."""
        if not self.get_bool("rabit_timeout"):
            return 0
        return self.get_int("rabit_timeout_sec", 1800)
