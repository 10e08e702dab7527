"""Per-rank observability and liveness: the flight recorder, the metrics
registry, shipping to the tracker, and the hang watchdog.

The port's own copy of ``rabit_tpu/obs/__init__.py``, which owns the
process-wide singletons and the failure paths.  ``api.init`` calls
:func:`configure`; every public collective runs inside
:func:`collective`, which stamps ``op_begin``/``op_end`` with the
cross-rank ``(version, seqno)`` identity, marks the thread in flight for
the watchdog and times the call into the registry.  With an obs dir
(``rabit_obs_dir`` or ``RABIT_OBS_DIR``), a SIGTERM or a collective stuck
past ``rabit_obs_hang_sec`` dumps the ring to
``<dir>/flight-rank<R>-pid<P>-n<seq>-<reason>.jsonl``.

Two liveness escalations ride the same watchdog:

* ``rabit_hang_abort_sec`` > 0: dump-then-die.  After the evidence dump, a
  rank stuck past the bound exits with ``HANG_ABORT_EXIT`` so the launcher
  restarts it;
* ``rabit_heartbeat_sec`` > 0: a lease renewal ticker to the tracker
  (``CMD_HEARTBEAT``).  Renewal is withheld once the watchdog declares this
  process hung, so a stuck worker whose threads still run is suspected by
  the tracker like a frozen one.

The watchdog and the senders are threads beside the program's main thread,
which may be driving the card: they touch no tensor and call no CUDA API,
and the watchdog's ``os._exit`` does not wait on the card.
"""

from __future__ import annotations

import contextlib
import os
import signal
import sys
import threading
import time

from rabit_tpu_torch.obs.events import (  # noqa: F401 (re-exports)
    DEFAULT_CAPACITY,
    Event,
    FlightRecorder,
    event_from_stats_line,
    events_from_lines,
    load_dump,
)
from rabit_tpu_torch.obs.metrics import (  # noqa: F401 (re-exports)
    GLOBAL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    OpStats,
    _Span,
)
from rabit_tpu_torch.obs import ship as _ship
from rabit_tpu_torch.obs import stream as _stream
from rabit_tpu_torch.obs.trace import GLOBAL_CLOCK  # noqa: F401 (re-export)

#: Exit code of the hang-abort escalation (dump-then-die).  Distinct from
#: the native recovery watchdog's exit 10 so launch logs tell the two
#: detectors apart.
HANG_ABORT_EXIT = 11

#: Process-wide flight recorder (engine + api layers record into it).
GLOBAL_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return GLOBAL_RECORDER


def get_registry() -> MetricsRegistry:
    return GLOBAL_REGISTRY


def record_event(kind: str, /, **fields) -> Event:
    """Record one structured event into the process flight recorder."""
    return GLOBAL_RECORDER.record(kind, **fields)


# -- process obs state -------------------------------------------------------

class _ObsState:
    """Mutable per-process configuration filled in by ``configure``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.obs_dir: str = ""
        self.hang_sec: float = 300.0
        self.hang_abort_sec: float = 0.0
        self.heartbeat_sec: float = 0.0
        self.rank: int = -1
        self.task_id: str = ""
        self.tracker: tuple[str, int] | None = None
        self.heartbeat: _ship.Heartbeat | None = None
        self.lease_hb: _ship.Heartbeat | None = None
        # The delta source diffing successive registry states into the
        # bounded windows every CMD_METRICS snapshot carries; the periodic
        # flight-ring spill ticker (rabit_obs_spill_sec); the flight-dump
        # retention cap (rabit_obs_max_files).
        self.delta_source = _stream.DeltaSource()
        self.spill_hb: _ship.Heartbeat | None = None
        self.spill_sec: float = 0.0
        self.max_files: int = 256
        self.watchdog_started = False
        self.sigterm_installed = False
        self.prev_sigterm = None
        # set by the watchdog when it declares this process hung; gates the
        # one-shot dump AND withholds further lease renewals.  Cleared (and
        # a hang_recovered event recorded) when the declared op completes —
        # a slow-but-successful collective must not permanently withhold
        # renewals and get a healthy worker killed.
        self.hang_dumped = False
        # (thread-id, t0, op) of the in-flight entry the declaration was
        # made on, so recovery is detected even if another collective is
        # already in flight by the next watchdog scan
        self.hang_ref: tuple[int, float, str] | None = None
        # thread-id -> (op, cache_key, t0_monotonic, version, seqno) of
        # in-flight collectives
        self.inflight: dict[int, tuple[str, str | None, float, int, int]] = {}
        # dumps written by this process so far — the filename counter that
        # keeps a second same-reason dump (hang, recover, hang again) from
        # overwriting the first
        self.dump_seq = 0
        # cross-rank collective identity: seqno resets on every
        # checkpoint-version change, so a restarted worker resumes the
        # numbering where the survivors' replay serves it
        self.op_version = 0
        self.op_seq = 0
        # rabit_trace_exit, rabit_trace_clock_pings
        self.trace_exit = False
        self.trace_clock_pings = 2
        # the failover list (rabit_tracker_addrs): the tracker addresses
        # every shipped message rotates through after the primary
        self.tracker_addrs: list = []


_STATE = _ObsState()


def _parse_tracker_addrs(spec: str) -> list:
    """``protocol.parse_addrs``, imported at the call: the tracker package
    imports this one."""
    from rabit_tpu_torch.tracker.protocol import parse_addrs

    return parse_addrs(spec)


def configure(config, rank: int = -1) -> None:
    """Wire observability from the engine config.  Called by
    ``api.init`` after the engine is up (and safe to call again on a
    later init: singletons persist, identity/settings are refreshed).

    Keys: ``rabit_obs_dir``
    (also the plain ``RABIT_OBS_DIR`` env var), ``rabit_obs_capacity``,
    ``rabit_obs_hang_sec``, ``rabit_obs_heartbeat_sec``,
    ``rabit_obs_spill_sec``, ``rabit_obs_max_files``,
    ``rabit_hang_abort_sec``, ``rabit_heartbeat_sec``,
    ``rabit_trace_exit``, ``rabit_trace_clock_pings``,
    ``rabit_tracker_addrs``.
    """
    obs_dir = (config.get("rabit_obs_dir", "") or
               os.environ.get("RABIT_OBS_DIR", "") or "")
    if obs_dir == "NULL":
        obs_dir = ""
    capacity = config.get_int("rabit_obs_capacity", DEFAULT_CAPACITY)
    hang_sec = float(config.get("rabit_obs_hang_sec", "300") or "300")
    hang_abort_sec = float(config.get("rabit_hang_abort_sec", "0") or "0")
    heartbeat_sec = float(config.get("rabit_obs_heartbeat_sec", "0") or "0")
    spill_sec = float(config.get("rabit_obs_spill_sec", "0") or "0")
    max_files = config.get_int("rabit_obs_max_files", 256)
    lease_sec = float(config.get("rabit_heartbeat_sec", "0") or "0")
    tracker_uri = config.get("rabit_tracker_uri", "NULL")
    task_id = config.get("rabit_task_id", "NULL") or "NULL"

    trace_exit = (config.get("rabit_trace_exit", "0") or "0") not in (
        "0", "", "false", "no")
    clock_pings = config.get_int("rabit_trace_clock_pings", 2)

    GLOBAL_RECORDER.set_capacity(capacity)
    with _STATE.lock:
        _STATE.obs_dir = obs_dir
        _STATE.hang_sec = hang_sec
        _STATE.hang_abort_sec = hang_abort_sec
        _STATE.heartbeat_sec = lease_sec
        _STATE.rank = rank
        _STATE.task_id = task_id
        _STATE.trace_exit = trace_exit
        _STATE.trace_clock_pings = clock_pings
        _STATE.spill_sec = spill_sec
        _STATE.max_files = max_files
        # Fresh delta baseline: the first window shipped to THIS job's
        # tracker is the full cumulative state, so the tracker-side fold
        # reconciles with the cumulative snapshot even when the process
        # (and its registry) outlives a previous init.
        _STATE.delta_source = _stream.DeltaSource()
        # fresh init: the cross-rank collective numbering restarts at
        # (version 0, seq 0), exactly like every other first-life rank's
        _STATE.op_version = 0
        _STATE.op_seq = 0
        _STATE.tracker = None
        if tracker_uri and tracker_uri != "NULL":
            _STATE.tracker = (
                tracker_uri, config.get_int("rabit_tracker_port", 9091)
            )
        # the primary tuple above stays first in every rotation
        _STATE.tracker_addrs = _parse_tracker_addrs(
            config.get("rabit_tracker_addrs", "") or "")
    # A re-init may point at a different tracker; offset samples against
    # the old one are meaningless on the new timeline.
    GLOBAL_CLOCK.reset()
    if obs_dir:
        os.makedirs(obs_dir, exist_ok=True)
        _install_sigterm_dump()
    # The watchdog serves three consumers: evidence dumps (needs a dir),
    # the hang-abort escalation, and hang-gated lease renewal.  Start it
    # when any of them is live.
    lease_on = lease_sec > 0 and _STATE.tracker is not None
    if ((hang_sec > 0 and (obs_dir or lease_on)) or hang_abort_sec > 0):
        _start_hang_watchdog()
    stop_heartbeat()
    if heartbeat_sec > 0 and _STATE.tracker is not None:
        hb = _ship.Heartbeat(heartbeat_sec, _ship_metrics_snapshot).start()
        with _STATE.lock:
            _STATE.heartbeat = hb
    if lease_on:
        # immediate=True: the lease exists the moment the worker is up, so
        # a worker frozen right after init is still covered.
        lhb = _ship.Heartbeat(lease_sec, _renew_lease, immediate=True).start()
        with _STATE.lock:
            _STATE.lease_hb = lhb
    if spill_sec > 0 and obs_dir:
        # Periodic flight-ring spill; retention keeps the dir bounded.
        shb = _ship.Heartbeat(spill_sec, _spill_tick).start()
        with _STATE.lock:
            _STATE.spill_hb = shb


# -- collective spans --------------------------------------------------------

def collective_epoch(version: int) -> None:
    """Note a checkpoint-version change (commit or recovery load) in the
    cross-rank collective numbering: the per-version seqno resets, so the
    same logical collective carries the same ``(version, seqno)`` on every
    rank — including a restarted worker, whose load_checkpoint lands it on
    exactly the version the survivors' numbering restarted at (a
    cross-rank trace merges dumps on this identity)."""
    with _STATE.lock:
        if version != _STATE.op_version:
            _STATE.op_version = int(version)
            _STATE.op_seq = 0


def collective_seq() -> tuple[int, int]:
    """The (version, next-seqno) the next collective will be stamped with."""
    with _STATE.lock:
        return _STATE.op_version, _STATE.op_seq


@contextlib.contextmanager
def collective(op: str, nbytes: int, cache_key: str | None = None,
               codec: str | None = None, fused: bool = False):
    """The one timing/eventing path for every public collective: records
    ``op_begin``/``op_end`` events stamped with the cross-rank
    ``(version, seqno)`` identity, marks the thread in-flight for the hang
    watchdog, and times into the registry's per-op stats + latency
    histogram.  Yields a span whose ``nbytes`` may be updated inside the
    window (object broadcast learns its length from the wire).

    ``codec`` (a ``compress`` codec name) joins the collective
    identity in both events: ranks must agree on the codec of each logical
    collective exactly as they agree on its (version, seqno), so a config
    skew shows up as differing ``codec`` fields on the same identity in
    the merged cross-rank trace — a detectable error, not silent
    corruption (the wire transport additionally hard-fails on mismatched
    frame ids).

    ``fused=True`` marks a collective the engine runs as the fused ring on
    its device (``engine.fused``): ``fused=1`` joins both events so traces
    tell fused from host-path ops apart."""
    tid = threading.get_ident()
    with _STATE.lock:
        version, seqno = _STATE.op_version, _STATE.op_seq
        _STATE.op_seq += 1
        _STATE.inflight[tid] = (op, cache_key, time.monotonic(), version,
                                seqno)
    extra = {} if codec is None else {"codec": codec}
    if fused:
        extra["fused"] = 1
    record_event("op_begin", op=op, nbytes=nbytes, cache_key=cache_key,
                 version=version, seqno=seqno, **extra)
    t0 = time.perf_counter()
    span = _Span(op, nbytes, cache_key)
    try:
        yield span
    finally:
        dt = time.perf_counter() - t0
        with _STATE.lock:
            _STATE.inflight.pop(tid, None)
        GLOBAL_REGISTRY.observe_op(op, span.nbytes, dt)
        record_event("op_end", op=op, nbytes=span.nbytes,
                     cache_key=cache_key, seconds=round(dt, 6),
                     version=version, seqno=seqno, **extra)


# -- failure-path dumps ------------------------------------------------------

def _evict_flight_dumps(obs_dir: str, max_files: int) -> int:
    """Oldest-first flight-dump eviction down to ``max_files``
    (rabit_obs_max_files): the periodic spill must not fill a disk over a
    long run.  Returns how many files were removed; never raises."""
    if max_files <= 0:
        return 0
    try:
        names = [n for n in os.listdir(obs_dir)
                 if n.startswith("flight-") and n.endswith(".jsonl")]
    except OSError:
        return 0
    excess = len(names) - max_files
    if excess <= 0:
        return 0
    stamped = []
    for n in names:
        path = os.path.join(obs_dir, n)
        try:
            stamped.append((os.path.getmtime(path), path))
        except OSError:
            continue
    stamped.sort()
    evicted = 0
    for _mtime, path in stamped[:excess]:
        try:
            os.remove(path)
            evicted += 1
        except OSError:
            pass
    if evicted:
        record_event("obs_evicted", n=evicted, max_files=max_files)
    return evicted


def _spill_tick() -> None:
    """One periodic flight-ring spill (rabit_obs_spill_sec): the live
    evidence follow-mode trace export tails mid-run."""
    dump_now("spill")


def dump_now(reason: str) -> str | None:
    """Dump the flight recorder to the configured obs dir; returns the path
    (None when no dir is configured).  Never raises.

    The filename carries a per-process dump counter (``-n<seq>-``) so the
    same reason firing twice in one life (hang, recover, hang again) writes
    two files instead of overwriting the first's evidence."""
    with _STATE.lock:
        obs_dir, rank = _STATE.obs_dir, _STATE.rank
        inflight = list(_STATE.inflight.values())
        max_files = _STATE.max_files
    if not obs_dir:
        return None
    try:
        for op, key, t0, version, seqno in inflight:
            record_event("op_inflight", op=op, cache_key=key,
                         stuck_seconds=round(time.monotonic() - t0, 3),
                         version=version, seqno=seqno)
        with _STATE.lock:
            _STATE.dump_seq += 1
            seq = _STATE.dump_seq
        path = os.path.join(
            obs_dir,
            f"flight-rank{rank}-pid{os.getpid()}-n{seq}-{reason}.jsonl",
        )
        out = GLOBAL_RECORDER.dump(
            path, header={"reason": reason, "rank": rank, "dump_seq": seq,
                          "task_id": _STATE.task_id}
        )
        _evict_flight_dumps(obs_dir, max_files)
        return out
    except OSError:
        return None


def _on_sigterm(signum, frame):
    dump_now("sigterm")
    prev = _STATE.prev_sigterm
    if callable(prev):
        prev(signum, frame)
        return
    # restore the previous disposition and re-deliver so the process still
    # dies with the normal SIGTERM exit status
    signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)


def _install_sigterm_dump() -> None:
    with _STATE.lock:
        if _STATE.sigterm_installed:
            return
        _STATE.sigterm_installed = True
    try:
        _STATE.prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        # not the main thread — the watchdog still covers hangs
        with _STATE.lock:
            _STATE.sigterm_installed = False


def _watchdog_loop() -> None:
    while True:
        recovered: tuple[str, float] | None = None
        with _STATE.lock:
            hang_sec = _STATE.hang_sec
            abort_sec = _STATE.hang_abort_sec
            declared = _STATE.hang_dumped
            now = time.monotonic()
            worst: tuple[str, str | None, float, int, float] | None = None
            for tid, (op, key, t0, _v, _s) in _STATE.inflight.items():
                if worst is None or now - t0 > worst[2]:
                    worst = (op, key, now - t0, tid, t0)
            if declared and _STATE.hang_ref is not None:
                # Latch release: the op the declaration was made on is no
                # longer in flight — the "hang" was slow-but-successful.
                # Clear the latch so lease renewals resume (a permanently
                # withheld lease would get this healthy worker killed) and
                # the one-shot dump re-arms for a future real hang.
                ref_tid, ref_t0, ref_op = _STATE.hang_ref
                cur = _STATE.inflight.get(ref_tid)
                if cur is None or cur[2] != ref_t0:
                    _STATE.hang_dumped = False
                    _STATE.hang_ref = None
                    declared = False
                    recovered = (ref_op, now - ref_t0)
        if recovered is not None:
            record_event("hang_recovered", op=recovered[0],
                         stuck_seconds=round(recovered[1], 3))
        # Detection threshold: rabit_obs_hang_sec when set, else the abort
        # bound alone drives it (abort without a separate dump threshold).
        detect_sec = hang_sec if hang_sec > 0 else abort_sec
        if (worst is not None and detect_sec > 0 and worst[2] > detect_sec
                and not declared):
            record_event("hang_detected", op=worst[0], cache_key=worst[1],
                         stuck_seconds=round(worst[2], 3))
            dump_now("hang")  # no-op without an obs dir
            with _STATE.lock:
                _STATE.hang_dumped = True
                _STATE.hang_ref = (worst[3], worst[4], worst[0])
            declared = True
        if worst is not None and abort_sec > 0 and worst[2] > abort_sec:
            # Dump-then-die: evidence is already on disk (the declaration
            # above); a second dump carries the abort decision itself, then
            # the process exits so the launcher can restart it — the
            # worker-side belt to the tracker lease's suspenders.
            record_event("hang_abort", op=worst[0], cache_key=worst[1],
                         stuck_seconds=round(worst[2], 3),
                         exit_code=HANG_ABORT_EXIT)
            dump_now("abort")
            print(f"[rabit_tpu_torch.obs] collective {worst[0]!r} stuck for "
                  f"{worst[2]:.1f}s > rabit_hang_abort_sec={abort_sec}: "
                  f"aborting (exit {HANG_ABORT_EXIT}) so the launcher can "
                  f"restart this worker", flush=True, file=sys.stderr)
            os._exit(HANG_ABORT_EXIT)
        bounds = [b for b in (hang_sec, abort_sec) if b > 0]
        time.sleep(max(min([1.0] + [b / 4.0 for b in bounds]), 0.02))


def _start_hang_watchdog() -> None:
    with _STATE.lock:
        if _STATE.watchdog_started:
            return
        _STATE.watchdog_started = True
    threading.Thread(
        target=_watchdog_loop, name="rabit-obs-watchdog", daemon=True
    ).start()


# -- periodic / shutdown shipping --------------------------------------------

def _make_snapshot() -> dict:
    with _STATE.lock:
        rank, task_id = _STATE.rank, _STATE.task_id
        source = _STATE.delta_source
    extra: dict = {"flight_dropped": GLOBAL_RECORDER.dropped}
    clock = GLOBAL_CLOCK.snapshot()
    if clock is not None:
        # this rank's tracker-clock offset estimate
        extra["clock"] = clock
    # Piggyback the streamed-metrics delta window: the tracker strips it at
    # ingest and folds it into its rollup; the snapshot stays cumulative.
    delta = source.take()
    if delta is not None:
        extra["delta"] = delta
    return _ship.build_snapshot(GLOBAL_REGISTRY, rank, task_id, extra=extra)


def _ship_metrics_snapshot() -> bool:
    """One metrics-heartbeat tick (runs on the heartbeat thread)."""
    with _STATE.lock:
        tracker, task_id = _STATE.tracker, _STATE.task_id
        addrs = list(_STATE.tracker_addrs)
    if tracker is None:
        return False
    return _ship.ship_snapshot(_make_snapshot(), tracker[0], tracker[1],
                               task_id, addrs=addrs)


def _renew_lease() -> bool:
    """One lease-renewal tick (runs on the lease heartbeat thread).

    Withheld once the watchdog has declared this process hung: a worker
    stuck in a collective but still scheduling threads must look exactly as
    dead to the tracker as a frozen one, so the lease detector covers both
    silent-failure shapes."""
    with _STATE.lock:
        tracker = _STATE.tracker
        rank, task_id = _STATE.rank, _STATE.task_id
        interval = _STATE.heartbeat_sec
        hung = _STATE.hang_dumped
        addrs = list(_STATE.tracker_addrs)
    if tracker is None or hung:
        return False
    return _ship.renew_lease(tracker[0], tracker[1], task_id, interval,
                             rank=rank, addrs=addrs)


def stop_heartbeat() -> None:
    """Stop every periodic sender (metric snapshots, lease renewals, and
    the flight-ring spill ticker)."""
    with _STATE.lock:
        hb, _STATE.heartbeat = _STATE.heartbeat, None
        lhb, _STATE.lease_hb = _STATE.lease_hb, None
        shb, _STATE.spill_hb = _STATE.spill_hb, None
    for t in (hb, lhb, shb):
        if t is not None:
            t.stop()


def ship_final_snapshot() -> bool:
    """Ship the shutdown-time snapshot to the tracker (best-effort; False
    when no tracker is configured or the send failed).  Called by
    ``api.finalize`` BEFORE the engine's own shutdown handshake so
    the tracker is still serving when the snapshot arrives."""
    stop_heartbeat()
    with _STATE.lock:
        tracker, task_id = _STATE.tracker, _STATE.task_id
        pings = _STATE.trace_clock_pings
        addrs = list(_STATE.tracker_addrs)
    if tracker is None:
        return False
    # Tighten (or bootstrap — a job that never enabled heartbeats has no
    # samples yet) the clock estimate before it is frozen into the final
    # snapshot: each ping is one timestamped round-trip, no lease effect.
    if pings > 0:
        _ship.clock_ping(tracker[0], tracker[1], task_id, samples=pings,
                         addrs=addrs)
    return _ship.ship_snapshot(_make_snapshot(), tracker[0], tracker[1],
                               task_id, addrs=addrs)


def dump_final() -> str | None:
    """With ``rabit_trace_exit=1``, write this life's flight ring as a
    ``-exit`` dump at finalize, so a CLEAN run leaves the per-rank evidence
    a cross-rank trace joins (hangs and SIGTERMs dump anyway).  Called by
    ``api.finalize`` after
    the engine shutdown handshake."""
    with _STATE.lock:
        want = _STATE.trace_exit and bool(_STATE.obs_dir)
    return dump_now("exit") if want else None
