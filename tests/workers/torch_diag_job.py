"""An elastic job of in-thread workers against an in-process tracker, with
the faults the diagnosis, quorum and HA planes must handle, for the CPU
tests and chip_smoke.py's diagnose, quorum, failover and relay phases.
The seeded campaigns that mix these faults with kills without restart and
spares (``run_elastic_schedule``) are ``rabit_tpu_torch.chaos``'s; this job
keeps the kill-free, spare-free shape those phases measure, with the
caller's contribution ``work`` and the hooks the runner has no argument
for (``watch``, a kill after n frozen quorum records, ``hold_back``, a file
journal, a relay bounce at a set time).

``run_job(world, niter, work, ...)`` starts a tracker and ``world``
``ElasticWorker`` threads.  Each version a worker sleeps ``iter_sleep``
(rank ``straggler[0]`` ``straggler[1]`` seconds more, up to version
``straggler[2]`` when given: a compute straggler that heals) and then
contributes ``work(version, world, rank)``.  ``slow_link=(src, dst, delay)``
puts a ``ChaosProxy`` in front of worker dst's listen socket that delays
only the frames src dials it with (src < dst: the lower rank dials), and
worker dst reports its incoming link past 0.2 of its epoch's wall time.
``watch(host, port)``, when given, runs in a thread of its own while the
workers run; its return value comes back as ``watched``.

Quorum rounds: ``quorum`` (a ``rabit_quorum`` spec) goes to the tracker
and the workers, with ``quorum_wait`` and ``quorum_flag_after``; ``codec``
sends the workers' blocks through a wire codec, and ``fails`` maps task ids
to an ``ElasticWorker`` death (``("die", v)``).

Failover: ``standby=True`` journals the primary (``journal_path``, or in
memory) and runs a ``Standby`` (``takeover_sec``, ``poll_sec``) that tails
the file when there is one, else the primary's CMD_JOURNAL stream; the
workers get both addresses.  ``kill_primary`` kills the primary
(``Tracker.kill``) after that many seconds, or, as ``("freezes", n)``, once
it has journaled n ``quorum_freeze`` records; the ranks of ``hold_back``
start only after the kill.  ``kill_standby`` kills the standby instead,
after that many seconds (the job must not notice).

Serving and relays: ``reactor`` picks the tracker's serving path;
``relays=R`` puts R relays (``relay_flush`` their batch cadence, 0.05 s) in
front of the tracker, worker i dialing relay i % R (with a standby the
relays get the failover list, the workers only their relay).
``relay_bounce=(at_s, down_s)`` stops relay 0 ``at_s`` seconds in and
starts a new one on its port ``down_s`` seconds later.

The tracker, worker, proxy, standby and relay classes default to the port's;
the tests pass ``rabit_tpu``'s to run the same job across the packages.
Imports the port only (numpy and the stdlib besides).
"""

import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch.chaos import ChaosProxy, FaultSpec  # noqa: E402
from rabit_tpu_torch.elastic.client import ElasticWorker  # noqa: E402
from rabit_tpu_torch.ha import ControlState, Journal, Standby, read_journal, replay  # noqa: E402
from rabit_tpu_torch.obs import top  # noqa: E402
from rabit_tpu_torch.obs.trace import ClockSync  # noqa: E402
from rabit_tpu_torch.relay import Relay  # noqa: E402
from rabit_tpu_torch.tracker import protocol as P  # noqa: E402
from rabit_tpu_torch.tracker.tracker import Tracker  # noqa: E402

SLOW_REPORT_SHARE = 0.2
HEARTBEAT_SEC = 0.15


def _freezes(journal) -> int:
    """quorum_freeze records the journal has written, from its mirror."""
    return len(journal.state_snapshot()["q_records"])


def run_job(world: int, niter: int, work, *, seed: int = 0, schedule: str = "auto",
            repair: bool = True, slow_link=None, straggler=None, iter_sleep: float = 0.05,
            deadline_sec: float = 60.0, obs_dir: str | None = None, watch=None,
            quorum: str = "", quorum_wait: float = 0.35, quorum_flag_after: int = 3,
            heartbeat_sec: float = HEARTBEAT_SEC, standby: bool = False,
            takeover_sec: float = 0.5, poll_sec: float = 0.05, kill_primary=None,
            hold_back=(), kill_standby: float | None = None,
            journal_path: str | None = None, codec: str = "",
            fails: dict | None = None, reactor: bool = True, relays: int = 0,
            relay_flush: float = 0.05, relay_bounce=None,
            tracker_cls=Tracker, worker_cls=ElasticWorker, proxy_cls=ChaosProxy,
            spec_cls=FaultSpec, standby_cls=Standby, journal_cls=Journal,
            relay_cls=Relay) -> dict:
    """Run the job to its end (see the module docstring).  Returns each
    task's ``ElasticResult`` (``results``), the tracker's ``events`` (the
    primary's, then the promoted tracker's), its ``incidents`` section,
    ``telemetry`` (the document written at its stop), the planned ``rings``
    in epoch order, ``n_repaired``, the ``final`` scrape taken once every
    worker is done (None for rabit_tpu's tracker or a killed one), ``watched`` and ``elapsed``; with a standby also
    ``primary_events``, ``promoted_events`` (empty when no takeover),
    ``primary_records`` (the primary's frozen quorum records by (epoch,
    version)), ``promoted_answers`` (the promoted tracker's reply to each of
    those rounds), ``promoted_shutdowns`` (the task ids whose shutdown it
    took), ``t_kill`` and ``t_kill_wall`` (time.monotonic() and time.time() of
    the kill); with relays ``relays`` (the relays last up: their ``stats``,
    ``clock_err`` and ``rank_clock``, a relayed rank's clock estimate), and
    with a bounce ``t_bounce_wall`` (time.time() of the stop); and with
    ``journal_path`` ``file_bytes`` (``read_journal`` + ``replay`` of the
    file just after the kill) and ``standby_bytes`` (the standby's state at
    its takeover: the snapshot its promoted journal compacted the file
    under)."""
    s_rank, s_delay = (int(straggler[0]), float(straggler[1])) if straggler else (-1, 0.0)
    s_heal = int(straggler[2]) if straggler and len(straggler) > 2 else None

    def contribution(version: int, w: int, r: int):
        time.sleep(iter_sleep)
        if r == s_rank and (s_heal is None or version <= s_heal):
            time.sleep(s_delay)  # the compute straggler
        return work(version, w, r)

    journal = None
    if standby:
        journal = journal_cls(journal_path)
    tkw = dict(quiet=True, shrink_after_sec=1.5, promote_after_sec=0.1, schedule=schedule,
               sched_repair=repair, reactor=reactor)
    if quorum:
        tkw.update(quorum=quorum, quorum_flag_after=quorum_flag_after)
    if journal is not None:
        tkw.update(ha_tick_sec=0.05)
    tracker = tracker_cls(world, obs_dir=obs_dir, journal=journal, **tkw).start()
    addr = (tracker.host, tracker.port)
    sb = None
    if standby:
        sb = standby_cls(primary=None if journal_path else addr, journal_path=journal_path,
                         takeover_sec=takeover_sec, poll_sec=poll_sec,
                         tracker_kwargs={k: v for k, v in tkw.items()
                                         if k != "ha_tick_sec"}).start()
    addrs = [addr, (sb.host, sb.port)] if sb is not None else addr
    relay_objs = [relay_cls(addrs, relay_id=f"relay{i}", flush_sec=relay_flush, quiet=True)
                  .start() for i in range(relays)]
    dial = ([(r.host, r.port) for r in relay_objs] if relay_objs else None)
    # a degraded hop, or a peer busy computing, stalls frames without a death
    link_timeout = max(1.0, 4 * slow_link[2] if slow_link else 0.0, 4 * s_delay)
    qkw = dict(quorum=quorum, quorum_wait=quorum_wait) if quorum else {}
    if codec:
        qkw["codec"] = codec
    fails = fails or {}
    workers = [worker_cls(dial[i % len(dial)] if dial else addrs, str(i), contribution, niter,
                          heartbeat_sec=heartbeat_sec,
                          wave_timeout=10.0, link_timeout=link_timeout,
                          deadline_sec=deadline_sec, fail=fails.get(str(i)), **qkw)
               for i in range(world)]
    proxy = None
    if slow_link is not None:
        src, dst, delay = slow_link
        if not 0 <= src < dst < world:
            raise ValueError(f"slow_link wants 0 <= src < dst < world, got {slow_link!r}")
        proxy = proxy_cls(("127.0.0.1", workers[dst].listen_port),
                          spec_cls(slow_link=(src, float(delay))), seed=seed).start()
        workers[dst].advertise_port = proxy.port
        workers[dst].slow_report_share = SLOW_REPORT_SHARE
    results: dict = {}
    watched: list = []
    out: dict = {}
    t0 = time.monotonic()
    threads = [threading.Thread(target=lambda w=w: results.__setitem__(w.task_id, w.run()),
                                daemon=True) for w in workers]
    watcher = None
    if watch is not None:
        watcher = threading.Thread(target=lambda: watched.append(watch(*addr)), daemon=True)
    bouncer = None
    if relay_bounce is not None:
        def bounce() -> None:
            time.sleep(float(relay_bounce[0]))
            old = relay_objs[0]
            out["t_bounce_wall"] = time.time()
            old.stop()
            time.sleep(float(relay_bounce[1]))
            for _ in range(30):  # the freed port can lag a beat
                try:
                    relay_objs[0] = relay_cls(addrs, relay_id=old.relay_id, port=old.port,
                                              flush_sec=relay_flush, quiet=True).start()
                    return
                except OSError:
                    time.sleep(0.1)

        bouncer = threading.Thread(target=bounce, daemon=True)
    try:
        for i, th in enumerate(threads):
            if i not in hold_back:
                th.start()
        if watcher is not None:
            watcher.start()
        if bouncer is not None:
            bouncer.start()
        if kill_primary is not None:
            end = t0 + deadline_sec
            if isinstance(kill_primary, tuple):
                while _freezes(journal) < int(kill_primary[1]) and time.monotonic() < end:
                    time.sleep(0.005)
            else:
                time.sleep(float(kill_primary))
            tracker.kill()  # its journal's writer drains before kill() returns
            out["t_kill"], out["t_kill_wall"] = time.monotonic(), time.time()
            if journal_path:
                out["file_bytes"] = replay_file_bytes(journal_path)
            for i in hold_back:
                threads[i].start()
        if kill_standby is not None:
            time.sleep(float(kill_standby))
            sb.kill()
        for th in threads:
            th.join(timeout=max(deadline_sec + 10.0 - (time.monotonic() - t0), 1.0))
            if th.is_alive():
                raise TimeoutError(f"a worker thread ran past the job's {deadline_sec} s")
        if watcher is not None:
            watcher.join(timeout=10.0)
        if bouncer is not None:
            bouncer.join(timeout=10.0)
        live = sb.tracker if sb is not None and sb.promoted.is_set() else tracker
        if relay_objs and not getattr(live, "_killed", False):
            # a relay ACKs a shutdown itself and forwards it at its next
            # flush: the job ends once the tracker has them all
            live.wait(5.0)
        # (rabit_tpu's tracker stops serving at the job's end: no final scrape)
        final = (top.scrape(live.host, live.port, registry=False)
                 if isinstance(live, Tracker) and not live._killed else None)
        if sb is not None:
            out.update(_failover_evidence(tracker, sb, journal_path))
        if relay_objs:
            out["relays"] = [{"relay": r.relay_id, "stats": dict(r.stats),
                              "clock_err": r.clock_err, "rank_clock": _relayed_clock(r)}
                             for r in relay_objs]
    finally:
        for r in relay_objs:
            r.stop()
        if sb is not None:
            sb.stop()
        tracker.stop()
        if proxy is not None:
            proxy.stop()
    promoted = sb.tracker if sb is not None and sb.promoted.is_set() else None
    events = list(tracker.events) + (list(promoted.events) if promoted is not None else [])
    last = promoted if promoted is not None else tracker
    out.update({"results": results, "events": events, "incidents": last._health.render(),
                "telemetry": last.telemetry,
                "rings": [list(e["ring_order"]) for e in events
                          if e["kind"] == "schedule_planned"],
                "n_repaired": sum(1 for e in events if e["kind"] == "schedule_repaired"),
                "final": final, "watched": watched[0] if watched else None,
                "elapsed": time.monotonic() - t0})
    if sb is not None:
        out["primary_events"] = list(tracker.events)
        out["promoted_events"] = list(promoted.events) if promoted is not None else []
    return out


def _failover_evidence(primary, sb, journal_path: str | None) -> dict:
    """What the failover checks read while the promoted tracker still
    serves: the primary's frozen quorum records and the promoted tracker's
    answer to each round, and the standby's state bytes against a replay of
    the journal file."""
    out = {"primary_records": {}, "promoted_answers": {}, "promoted_shutdowns": set(),
           "standby_bytes": None}
    table = getattr(primary, "_quorum", None)
    if table is not None:
        out["primary_records"] = {k: dict(r) for k, r in table._records.items()}
    promoted = sb.tracker if sb.promoted.is_set() else None
    if promoted is None:
        return out
    if journal_path:
        records, _torn = read_journal(journal_path)
        if records and records[0][0] == "snapshot":
            out["standby_bytes"] = ControlState.from_snapshot(
                records[0][1]["state"]).snapshot_bytes()
    # the shutdown's bookkeeping follows its ACK: give it a moment
    end = time.monotonic() + 3.0
    while len(promoted._shutdown_tasks) < len(promoted._ranks) and time.monotonic() < end:
        time.sleep(0.02)
    out["promoted_shutdowns"] = set(promoted._shutdown_tasks)
    for (epoch, version) in sorted(out["primary_records"]):
        msg = f'{{"epoch": {epoch}, "v": {version}, "have": [], "held": []}}'
        out["promoted_answers"][(epoch, version)] = P.tracker_rpc(
            promoted.host, promoted.port, P.CMD_QUORUM, "check", message=msg, timeout=5.0,
            retries=2)
    return out


def _relayed_clock(relay, samples: int = 4):
    """A relayed rank's clock estimate: a ``ClockSync`` fed by clock pings
    (heartbeats of interval 0) through ``relay``, whose ACKs carry its
    projection of the tracker's clock; ``(offset_s, err_s)`` or None."""
    sync = ClockSync()
    for _ in range(samples):
        try:
            reply = P.tracker_rpc(relay.host, relay.port, P.CMD_HEARTBEAT, "clock-probe",
                                  message="0", timeout=2.0, retries=0)
        except P.TrackerUnreachable:
            break
        sync.update(reply.offset, reply.err)
    return sync.estimate()


def replay_file_bytes(path: str) -> bytes:
    """``read_journal`` + ``replay`` of a journal file, as canonical bytes."""
    records, _torn = read_journal(path)
    return replay(records).snapshot_bytes()


def scrape_until_open(host: str, port: int, timeout: float = 30.0, every: float = 0.2):
    """Scrape (``obs.top.scrape``) until the incidents section shows an open
    incident; returns that scrape, or the last one at the timeout."""
    end = time.monotonic() + timeout
    doc = None
    while time.monotonic() < end:
        try:
            doc = top.scrape(host, port, registry=False, timeout=2.0)
        except (ConnectionError, OSError):
            break  # the tracker stopped
        if doc["incidents"]["n_open"]:
            return doc
        time.sleep(every)
    return doc
