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
instead, a silent hang with no exit and no TCP error.

Self-healing: the tracker's lease monitor calls back into the launcher
when a worker with ``rabit_heartbeat_sec`` goes silent (``on_suspect``),
and the launcher SIGKILLs the suspect, which turns the hang into an
ordinary death that the restart path and the engine's recovery handle.
After ``run`` the tracker's telemetry document is ``telemetry``
(telemetry.json lands in ``RABIT_OBS_DIR`` when that is set).

Usage:
    python -m rabit_tpu_torch.tracker.launcher --num-workers 4 \\
        [--max-restarts 20] [--preempt DELAY:TASK] [--wedge DELAY:TASK] \\
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

from rabit_tpu_torch.tracker.tracker import Tracker


class LocalCluster:
    def __init__(self, num_workers: int, max_restarts: int = 0, quiet: bool = False,
                 extra_env: dict[str, str] | None = None):
        self.num_workers = num_workers
        self.max_restarts = max_restarts
        self.quiet = quiet
        self.extra_env = extra_env or {}
        #: restarts and the last exit code, per task id ("0".."N-1")
        self.restarts: dict[str, int] = {str(i): 0 for i in range(num_workers)}
        self.returncodes: dict[str, int | None] = {str(i): None for i in range(num_workers)}
        self.messages: list[str] = []  # the tracker's print log of the last run
        self.events: list[dict] = []   # the tracker's waves of the last run
        #: time.time() of each worker death seen: a preemption at its
        #: SIGKILL, another death when it is reaped
        self.death_times: list[float] = []
        #: scheduled preemptions whose SIGKILL landed (a worker that had
        #: already exited is left alone and not counted)
        self.preempts_delivered = 0
        #: scheduled wedges whose SIGSTOP landed, and time.time() at each
        self.wedges_delivered = 0
        self.wedge_times: list[float] = []
        #: the tracker's telemetry document of the last run
        self.telemetry: dict | None = None
        # task ids the lease monitor suspected, drained (and SIGKILLed) by
        # the run loop: the monitor thread never touches a process
        self._suspects: list[str] = []
        self._suspect_lock = threading.Lock()

    def _on_suspect(self, task_id: str) -> None:
        """The tracker's lease-expiry callback (on its monitor thread)."""
        with self._suspect_lock:
            self._suspects.append(task_id)

    def _spawn(self, cmd: list[str], tracker: Tracker, task_id: str) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update(DMLC_TRACKER_URI=tracker.host, DMLC_TRACKER_PORT=str(tracker.port),
                   DMLC_TASK_ID=task_id, DMLC_NUM_ATTEMPT=str(self.restarts[task_id]))
        return subprocess.Popen(cmd, env=env)

    def run(self, cmd: list[str], timeout: float = 300.0,
            preempt: list[tuple[float, int]] | None = None,
            wedge: list[tuple[float, int]] | None = None) -> int:
        """Run ``cmd`` x num_workers under a fresh tracker; returns 0 when
        every worker has exited cleanly.  Raises when a task id's restart
        budget is spent or ``timeout`` seconds pass; every worker still
        running then is killed.  A suspect of the lease monitor is SIGKILLed
        and restarted from the same budget."""
        self._suspects = []
        tracker = Tracker(self.num_workers, quiet=self.quiet,
                          on_suspect=self._on_suspect).start()
        self.messages = tracker.messages
        self.events = tracker.events
        procs: dict[str, subprocess.Popen | None] = {
            str(i): self._spawn(cmd, tracker, str(i)) for i in range(self.num_workers)}
        start = time.monotonic()
        pending = sorted(preempt or [], key=lambda p: p[0], reverse=True)
        wedges = sorted(wedge or [], key=lambda p: p[0], reverse=True)
        stamped: set[str] = set()  # deaths already in death_times
        try:
            while True:
                if time.monotonic() - start > timeout:
                    raise TimeoutError(f"cluster did not finish within {timeout}s")
                while pending and time.monotonic() - start >= pending[-1][0]:
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
                    if not self.quiet:
                        print(f"[launcher] preempted worker {tid} (SIGKILL)", flush=True)
                while wedges and time.monotonic() - start >= wedges[-1][0]:
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
                for tid in suspects:
                    proc = procs.get(tid)
                    if proc is None or proc.poll() is not None:
                        continue  # dead or finished: nothing to heal
                    # SIGKILL works on a stopped process too; its peers get
                    # TCP resets and the restart below takes over.
                    proc.kill()
                    self.death_times.append(time.time())
                    stamped.add(tid)
                    if not self.quiet:
                        print(f"[launcher] worker {tid} suspected by the lease monitor: "
                              "SIGKILL", flush=True)
                alive = 0
                for tid, proc in list(procs.items()):
                    if proc is None:
                        continue
                    ret = proc.poll()
                    if ret is None:
                        alive += 1
                    elif ret == 0:
                        self.returncodes[tid] = 0
                        procs[tid] = None
                    else:
                        self.returncodes[tid] = ret
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
                if alive == 0:
                    return 0
                time.sleep(0.02)
        finally:
            for proc in procs.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
            tracker.stop()  # writes telemetry.json if the job's end did not
            self.telemetry = tracker.telemetry


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
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    if not cmd:
        ap.error("worker command required after --")

    def schedule(entries: list[str], flag: str) -> list[tuple[float, int]]:
        out = []
        for s in entries:
            try:
                delay, task = s.split(":")
                out.append((float(delay), int(task)))
            except ValueError:
                ap.error(f"{flag} wants DELAY:TASK pairs, got {s!r}")
        return out

    cluster = LocalCluster(args.num_workers, args.max_restarts, quiet=args.quiet)
    return cluster.run(cmd, timeout=args.timeout, preempt=schedule(args.preempt, "--preempt"),
                       wedge=schedule(args.wedge, "--wedge"))


if __name__ == "__main__":
    sys.exit(main())
