"""A cluster of local worker processes under one tracker.

The port's core of ``rabit_tpu/tracker/launcher.py``: ``LocalCluster``
runs a ``Tracker`` in this process and starts ``num_workers`` copies of a
command, each told its tracker and itself through the environment every
rabit launcher sets (``DMLC_TRACKER_URI``, ``DMLC_TRACKER_PORT``,
``DMLC_TASK_ID``, ``DMLC_NUM_ATTEMPT``).  A worker that exits non-zero is
started again with the same task id, within ``max_restarts`` restarts a
task id, and its peers recover it through the tracker's next wave; a
worker's dump-then-die exit (``obs.HANG_ABORT_EXIT``) is such a death.
``run(..., preempt=[(delay_s, task), ...])`` SIGKILLs workers at those
times, wherever they are; ``wedge=[(delay_s, task), ...]`` SIGSTOPs them
instead, a silent hang with no exit and no TCP error.  ``start_when``
(a test of the tracker's events) holds both clocks until it is true, so
a kill can wait for a spare to park or a version to commit.

Self-healing: the tracker's lease monitor calls back into the launcher
when a worker with ``rabit_heartbeat_sec`` goes silent (``on_suspect``),
and the launcher SIGKILLs the suspect, which turns the hang into an
ordinary death that the restart path and the engine's recovery handle.
After ``run`` the tracker's telemetry document is ``telemetry``
(telemetry.json lands in ``RABIT_OBS_DIR`` when that is set).

Elastic worlds (``elastic``): ``spares=K`` (``--spares K``) also starts K
hot spares, task ids ``s0`` .. ``s{K-1}`` (``spare_task_id``), with
``rabit_spare=1`` in their environment; they park in the tracker's pool.
``shrink_after_sec`` (``--shrink-after``) lets a recovery wave close with
the survivors when no spare fills it in time.  A dead spare is not
started again and does not hold the job open; a restarted worker whose
slot a spare took parks as a spare and is released when the job ends.
Bookkeeping is keyed by task id.

High availability (``ha``): ``standby=True`` (``--standby``) journals the
tracker's every mutation (to ``ha_journal`` when set, else in memory,
streamed over ``CMD_JOURNAL``) and runs a warm ``ha.Standby`` in this
process; the workers get both addresses as ``rabit_tracker_addrs``
(``RABIT_TPU_RABIT_TRACKER_ADDRS``).  ``run(kill_tracker_after=SEC)``
(``--kill-tracker-after``) kills the primary tracker abruptly that many
seconds in: the standby takes over within ``takeover_sec``
(``--takeover-sec``), the workers fail over to it, and the launcher's
bookkeeping follows the promoted tracker.

Relays (``relay``): ``relays=R`` (``--relays R``) runs R relays in this
process in front of the tracker (``relay_flush_sec`` their batch cadence),
and worker i dials relay ``i % R`` (a spare ``s<i>`` too; stable per task
id, so a restarted life lands on its relay): the tracker accepts O(R)
connections, not one a worker and message.  With ``standby=True`` the
relays get the failover list and rotate to the standby; the relayed
workers keep their relay's address.  The relays stop when the run ends.

Usage:
    python -m rabit_tpu_torch.tracker.launcher --num-workers 4 \\
        [--max-restarts 20] [--spares K] [--shrink-after SEC] [--relays R] \\
        [--schedule auto|tree|ring|swing] [--sched-mesh RxC[:nowrap]] \\
        [--standby [--ha-journal PATH] [--takeover-sec SEC]] \\
        [--kill-tracker-after SEC] \\
        [--preempt DELAY:TASK] [--wedge DELAY:TASK] \\
        -- python worker.py rabit_heartbeat_sec=0.5 [args...]
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable

from rabit_tpu_torch.config import Config
from rabit_tpu_torch.tracker.tracker import Tracker


#: Seconds a released spare has to leave before the run kills it.
SPARE_EXIT_SEC = 10.0
#: Seconds a relayed run waits, once its workers are gone, for the shutdowns
#: still in its relays to reach the tracker.
RELAY_DRAIN_SEC = 5.0
#: Seconds at most that ``run(linger=)`` keeps the tracker and the relays
#: serving once the workers are gone.
LINGER_SEC = 60.0


def spare_task_id(i: int) -> str:
    """Task id of the i-th hot spare: outside the workers' dense numbering
    ("0".."N-1"), as a spare is outside the ranks until it is promoted."""
    return f"s{i}"


class LocalCluster:
    def __init__(self, num_workers: int, max_restarts: int = 0, quiet: bool = False,
                 extra_env: dict[str, str] | None = None, spares: int = 0,
                 shrink_after_sec: float = 0.0, schedule: str = "auto", sched_mesh: str = "",
                 standby: bool = False, ha_journal: str = "",
                 takeover_sec: float = 1.0, relays: int = 0, relay_flush_sec: float = 0.25,
                 job: str = ""):
        self.num_workers = num_workers
        self.max_restarts = max_restarts
        self.quiet = quiet
        self.extra_env = extra_env or {}
        self.shrink_after_sec = float(shrink_after_sec)
        #: the tracker's schedule algorithm and mesh model (``Tracker``'s
        #: ``schedule`` and ``sched_mesh``)
        self.schedule = schedule
        self.sched_mesh = sched_mesh
        tasks = [str(i) for i in range(num_workers)]
        tasks += [spare_task_id(i) for i in range(int(spares))]
        #: restarts and the last exit code, per task id ("0".."N-1", then
        #: the spares' "s0".."sK-1")
        self.restarts: dict[str, int] = {t: 0 for t in tasks}
        self.returncodes: dict[str, int | None] = {t: None for t in tasks}
        self.messages: list[str] = []  # the tracker's print log of the last run
        self.events: list[dict] = []   # the tracker's waves of the last run
        #: time.time() of each worker death seen, once a death: a preemption
        #: or a suspect at its SIGKILL, another death when it is reaped
        self.death_times: list[float] = []
        #: scheduled preemptions whose SIGKILL landed (a worker that had
        #: already exited is left alone and not counted)
        self.preempts_delivered = 0
        #: scheduled wedges whose SIGSTOP landed, and time.time() at each
        self.wedges_delivered = 0
        self.wedge_times: list[float] = []
        #: the tracker's telemetry document of the last run
        self.telemetry: dict | None = None
        # (task id, time.monotonic()) of each suspicion of the lease monitor,
        # drained (and SIGKILLed) by the run loop: the monitor thread never
        # touches a process
        self._suspects: list[tuple[str, float]] = []
        self._suspect_lock = threading.Lock()
        self._spawned: dict[str, float] = {}  # task id -> time.monotonic() of its life's start
        #: the HA plane: a warm standby beside the tracker (the workers get
        #: both addresses), the journal file ("" = in memory) and the
        #: standby's takeover lease
        self.use_standby = bool(standby)
        self.ha_journal = str(ha_journal or "")
        self.takeover_sec = float(takeover_sec)
        self.standby = None
        self._worker_addrs: list[tuple[str, int]] = []
        #: the relay tier: R relays of this process, the workers spread over
        #: them by task id (the list holds the last run's, stopped)
        self.num_relays = int(relays)
        self.relay_flush_sec = float(relay_flush_sec)
        self.relays: list = []
        #: the job key, exported to the workers as rabit_job_key: they
        #: prefix their wire task ids with it, so a CollectiveService routes
        #: them to the job's partition
        self.job = str(job)

    def _on_suspect(self, task_id: str) -> None:
        """The tracker's lease-expiry callback (on its monitor thread)."""
        with self._suspect_lock:
            self._suspects.append((task_id, time.monotonic()))

    def _target_addr(self, tracker: Tracker, task_id: str) -> tuple[str, int]:
        """The address ``task_id`` dials: the tracker, or relay ``i % R``
        for task "i" or spare "s<i>" (any other id by the sum of its
        bytes)."""
        if not self.relays:
            return tracker.host, tracker.port
        try:
            idx = int(task_id.lstrip("s"))
        except ValueError:
            idx = sum(task_id.encode())
        relay = self.relays[idx % len(self.relays)]
        return relay.host, relay.port

    def _spawn(self, cmd: list[str], tracker: Tracker, task_id: str) -> subprocess.Popen:
        host, port = self._target_addr(tracker, task_id)
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update(DMLC_TRACKER_URI=host, DMLC_TRACKER_PORT=str(port),
                   DMLC_TASK_ID=task_id, DMLC_NUM_ATTEMPT=str(self.restarts[task_id]))
        if not task_id.isdigit():
            env["RABIT_TPU_RABIT_SPARE"] = "1"  # config's environment layer: rabit_spare=1
        if self.job:
            env["RABIT_TPU_RABIT_JOB_KEY"] = self.job
        if self._worker_addrs and not self.relays:
            # the failover list: the primary first, then the standby (a
            # relayed worker keeps its relay's address; the relay rotates)
            env["RABIT_TPU_RABIT_TRACKER_ADDRS"] = ",".join(
                f"{h}:{p}" for h, p in self._worker_addrs)
        self._spawned[task_id] = time.monotonic()
        return subprocess.Popen(cmd, env=env)

    def run(self, cmd: list[str], timeout: float = 300.0,
            preempt: list[tuple[float, int]] | None = None,
            wedge: list[tuple[float, int]] | None = None,
            start_when: Callable[[list[dict]], bool] | None = None,
            kill_tracker_after: float | None = None,
            linger: Callable[[], bool] | None = None) -> int:
        """Run ``cmd`` x num_workers (and the spares) under a fresh
        tracker; returns 0 when every worker has exited cleanly.  Raises
        when a task id's restart budget is spent or ``timeout`` seconds
        pass; every process still running then is killed.  A suspect of the
        lease monitor is SIGKILLed and restarted from the same budget.  The
        delays of ``preempt`` and ``wedge`` count from launch, or from the
        first time ``start_when(events)`` holds for the tracker's events.
        ``kill_tracker_after`` kills the primary tracker (``Tracker.kill``)
        that many seconds after launch; with ``standby=True`` the job fails
        over, and after the run ``events`` are the primary's up to the cut
        and the promoted tracker's after it.  ``linger`` keeps the tracker
        and the relays serving, once every worker has exited, until
        ``linger()`` is true (at most ``LINGER_SEC``): a reader of the job's
        delivery line behind the relays finishes its last fetch first."""
        self._suspects = []
        tracker_kwargs = dict(quiet=self.quiet, on_suspect=self._on_suspect,
                              shrink_after_sec=self.shrink_after_sec,
                              schedule=self.schedule, sched_mesh=self.sched_mesh)
        journal = None
        if self.use_standby:
            from rabit_tpu_torch.ha import Journal

            journal = self.ha_journal or Journal(None)
        tracker = Tracker(self.num_workers, journal=journal, **tracker_kwargs).start()
        self.messages = tracker.messages
        self.events = tracker.events
        self._worker_addrs = []
        if self.use_standby:
            from rabit_tpu_torch.ha import Standby

            self.standby = Standby(primary=(tracker.host, tracker.port),
                                   takeover_sec=self.takeover_sec,
                                   journal=self.ha_journal or None,
                                   tracker_kwargs=tracker_kwargs, quiet=self.quiet).start()
            self._worker_addrs = [(tracker.host, tracker.port),
                                  (self.standby.host, self.standby.port)]
        if self.num_relays > 0:
            from rabit_tpu_torch.relay import Relay

            target = self._worker_addrs or (tracker.host, tracker.port)
            self.relays = [Relay(target, relay_id=f"relay{i}", flush_sec=self.relay_flush_sec,
                                 quiet=self.quiet).start() for i in range(self.num_relays)]
        primary = tracker
        procs: dict[str, subprocess.Popen | None] = {
            t: self._spawn(cmd, tracker, t) for t in self.restarts}
        launched = time.monotonic()
        start = None if start_when is not None else launched
        pending = sorted(preempt or [], key=lambda p: p[0], reverse=True)
        wedges = sorted(wedge or [], key=lambda p: p[0], reverse=True)
        stamped: set[str] = set()  # deaths already in death_times
        done_at = None  # monotonic time the tracker saw the job done
        try:
            while True:
                if time.monotonic() - launched > timeout:
                    raise TimeoutError(f"cluster did not finish within {timeout}s")
                if (kill_tracker_after is not None and not primary._killed
                        and time.monotonic() - launched >= kill_tracker_after):
                    primary.kill()
                    if not self.quiet:
                        print("[launcher] primary tracker killed (abrupt; standby takeover "
                              "pending)", flush=True)
                if (tracker is primary and self.standby is not None
                        and self.standby.promoted.is_set()):
                    # the promoted standby is the job's tracker from here on
                    tracker = self.standby.tracker
                if start is None and start_when(list(tracker.events)):
                    start = time.monotonic()
                elapsed = time.monotonic() - start if start is not None else -1.0
                while pending and start is not None and elapsed >= pending[-1][0]:
                    tid = str(pending[-1][1])
                    proc = procs.get(tid)
                    if proc is not None and proc.poll() is not None:
                        break  # dead, not yet restarted: the kill waits for its next life
                    pending.pop()
                    if proc is None:
                        continue  # finished cleanly: nothing to preempt
                    proc.kill()
                    killed_at = time.time()
                    if proc.wait() == -signal.SIGKILL:
                        self.preempts_delivered += 1
                        self.death_times.append(killed_at)
                        stamped.add(tid)
                    tracker.note_exit(tid)
                    if not self.quiet:
                        print(f"[launcher] preempted worker {tid} (SIGKILL)", flush=True)
                while wedges and start is not None and elapsed >= wedges[-1][0]:
                    tid = str(wedges.pop()[1])
                    proc = procs.get(tid)
                    if proc is None or proc.poll() is not None:
                        continue  # gone: nothing to freeze
                    proc.send_signal(signal.SIGSTOP)
                    self.wedges_delivered += 1
                    self.wedge_times.append(time.time())
                    if not self.quiet:
                        print(f"[launcher] wedged worker {tid} (SIGSTOP)", flush=True)
                with self._suspect_lock:
                    suspects, self._suspects = self._suspects, []
                for tid, at in suspects:
                    proc = procs.get(tid)
                    if proc is None or proc.poll() is not None or self._spawned[tid] > at:
                        continue  # dead, finished, or a later life than the one suspected
                    # SIGKILL works on a stopped process too; its peers get
                    # TCP resets and the restart below takes over.
                    proc.kill()
                    self.death_times.append(time.time())
                    stamped.add(tid)
                    if not self.quiet:
                        print(f"[launcher] worker {tid} suspected by the lease monitor: "
                              "SIGKILL", flush=True)
                alive = spares_alive = 0
                for tid, proc in list(procs.items()):
                    if proc is None:
                        continue
                    spare = not tid.isdigit()
                    ret = proc.poll()
                    if ret is None:
                        if spare:
                            spares_alive += 1
                        else:
                            alive += 1
                    elif ret == 0:
                        self.returncodes[tid] = 0
                        procs[tid] = None
                    elif spare:
                        # A dead spare is not started again: the pool shrank.
                        self.returncodes[tid] = ret
                        procs[tid] = None
                        if tid in stamped:
                            stamped.discard(tid)
                        else:
                            self.death_times.append(time.time())
                        if not self.quiet:
                            print(f"[launcher] spare {tid} died (code {ret}); the pool "
                                  "shrank", flush=True)
                    else:
                        self.returncodes[tid] = ret
                        tracker.note_exit(tid)
                        if self.restarts[tid] >= self.max_restarts:
                            raise RuntimeError(f"worker {tid} died with code {ret}; restart "
                                               f"budget ({self.max_restarts}) exhausted")
                        self.restarts[tid] += 1
                        if tid in stamped:
                            stamped.discard(tid)
                        else:
                            self.death_times.append(time.time())
                        if not self.quiet:
                            print(f"[launcher] worker {tid} died (code {ret}); restart "
                                  f"{self.restarts[tid]}/{self.max_restarts}", flush=True)
                        procs[tid] = self._spawn(cmd, tracker, tid)
                        alive += 1
                if tracker.wait(0) and not tracker._killed and done_at is None:
                    done_at = time.monotonic()
                # A spare holds the run open while it may still be working
                # (promoted) and, once the job is done, while it leaves the
                # pool it was released from (SPARE_EXIT_SEC at most).
                if alive == 0 and (spares_alive == 0 or (
                        done_at is not None and time.monotonic() - done_at > SPARE_EXIT_SEC)):
                    if self.relays and not tracker._killed:
                        # a relay ACKs a shutdown itself and forwards it at
                        # its next flush: let the tracker see the job's end
                        tracker.wait(RELAY_DRAIN_SEC)
                    until = time.monotonic() + LINGER_SEC
                    while linger is not None and not linger() and time.monotonic() < until:
                        time.sleep(0.05)
                    return 0
                time.sleep(0.02)
        finally:
            for proc in procs.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
            for relay in self.relays:
                relay.stop()
            promoted = (self.standby.tracker if self.standby is not None
                        and self.standby.promoted.is_set() else None)
            if self.standby is not None:
                self.standby.stop()  # and the promoted tracker, writing its telemetry
            primary.stop()  # writes telemetry.json if the job's end did not
            if promoted is not None:
                self.telemetry = promoted.telemetry
                self.events = list(primary.events) + list(promoted.events)
            else:
                self.telemetry = primary.telemetry


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-workers", "-n", type=int, required=True)
    ap.add_argument("--max-restarts", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--preempt", action="append", default=[], metavar="DELAY:TASK",
                    help="SIGKILL worker TASK DELAY seconds after launch (repeatable)")
    ap.add_argument("--wedge", action="append", default=[], metavar="DELAY:TASK",
                    help="SIGSTOP worker TASK DELAY seconds after launch, a silent hang "
                         "(repeatable); give the workers rabit_heartbeat_sec so the "
                         "lease monitor suspects it")
    ap.add_argument("--spares", type=int, default=0, metavar="K",
                    help="also start K hot spares (task ids s0..sK-1, rabit_spare=1) "
                         "that park in the tracker's pool until a dead rank's slot "
                         "needs them")
    ap.add_argument("--shrink-after", type=float, default=0.0, metavar="SEC",
                    help="let a recovery wave close with the survivors when no spare "
                         "fills it within SEC seconds (0: wait for a full wave)")
    ap.add_argument("--schedule", default="auto", choices=("auto", "tree", "ring", "swing"),
                    help="the collective schedule the tracker plans each epoch "
                         "(rabit_schedule)")
    ap.add_argument("--sched-mesh", default="", metavar="RxC[:nowrap]",
                    help="the mesh model's dims for the schedule's plan (rabit_sched_mesh; "
                         "empty: near-square)")
    ap.add_argument("--standby", action="store_true",
                    help="run a warm-standby tracker in this process: the primary journals "
                         "every control-plane mutation, the workers get both addresses "
                         "(rabit_tracker_addrs), and a primary's death fails over within "
                         "--takeover-sec")
    ap.add_argument("--ha-journal", default="", metavar="PATH",
                    help="journal file of the HA control plane (default: the "
                         "rabit_ha_journal config key; empty: in memory, streamed to the "
                         "standby over CMD_JOURNAL)")
    ap.add_argument("--takeover-sec", type=float, default=None, metavar="SEC",
                    help="the standby's takeover lease (default: the rabit_ha_takeover_sec "
                         "config key)")
    ap.add_argument("--relays", type=int, default=0, metavar="R",
                    help="run R relays in front of the tracker; worker i dials relay i %% R, "
                         "and the tracker accepts O(R) connections")
    ap.add_argument("--kill-tracker-after", type=float, default=None, metavar="SEC",
                    help="kill the primary tracker abruptly SEC seconds in (with --standby "
                         "the job fails over; without, it is lost)")
    ap.add_argument("--job", default="", metavar="KEY",
                    help="the job key (rabit_job_key): the workers prefix their task ids "
                         "with KEY/, so a CollectiveService routes them to this job's "
                         "partition (default: the rabit_job_key config key)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("worker command required after --")

    def parse_schedule(entries: list[str], flag: str) -> list[tuple[float, int]]:
        out = []
        for s in entries:
            try:
                delay, task = s.split(":")
                out.append((float(delay), int(task)))
            except ValueError:
                ap.error(f"{flag} wants DELAY:TASK pairs, got {s!r}")
        return out

    cfg = Config()
    takeover = (args.takeover_sec if args.takeover_sec is not None
                else float(cfg.get("rabit_ha_takeover_sec", "1.0") or "1.0"))
    cluster = LocalCluster(args.num_workers, args.max_restarts, quiet=args.quiet,
                           spares=args.spares, shrink_after_sec=args.shrink_after,
                           schedule=args.schedule, sched_mesh=args.sched_mesh,
                           standby=args.standby,
                           ha_journal=args.ha_journal or cfg.get("rabit_ha_journal", "") or "",
                           takeover_sec=takeover, relays=args.relays,
                           job=args.job or cfg.get("rabit_job_key", "") or "")
    return cluster.run(cmd, timeout=args.timeout,
                       preempt=parse_schedule(args.preempt, "--preempt"),
                       wedge=parse_schedule(args.wedge, "--wedge"),
                       kill_tracker_after=args.kill_tracker_after)


if __name__ == "__main__":
    sys.exit(main())
