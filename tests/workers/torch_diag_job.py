"""An elastic job of in-thread workers against an in-process tracker, with
the faults the diagnosis plane must name: the port's counterpart of the
slow-link and straggler modes of ``rabit_tpu.chaos.run_elastic_schedule``
(no kills, no spares), for the CPU tests and chip_smoke.py's diagnose
phase.

``run_job(world, niter, work, ...)`` starts a tracker and ``world``
``ElasticWorker`` threads.  Each version a worker sleeps ``iter_sleep``
(rank ``straggler[0]`` ``straggler[1]`` seconds more: a compute straggler)
and then contributes ``work(version, world, rank)``.  ``slow_link=(src,
dst, delay)`` puts a ``ChaosProxy`` in front of worker dst's listen socket
that delays only the frames src dials it with (src < dst: the lower rank
dials), and worker dst reports its incoming link past 0.2 of its epoch's
wall time.  ``watch(host, port)``, when given, runs in a thread of its own
while the workers run; its return value comes back as ``watched``.

The tracker, worker and proxy classes default to the port's; the tests
pass ``rabit_tpu``'s to run the same job across the packages.  Imports the
port only (numpy and the stdlib besides).
"""

import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch.chaos import ChaosProxy, FaultSpec  # noqa: E402
from rabit_tpu_torch.elastic.client import ElasticWorker  # noqa: E402
from rabit_tpu_torch.obs import top  # noqa: E402
from rabit_tpu_torch.tracker.tracker import Tracker  # noqa: E402

SLOW_REPORT_SHARE = 0.2
HEARTBEAT_SEC = 0.15


def run_job(world: int, niter: int, work, *, seed: int = 0, schedule: str = "auto",
            repair: bool = True, slow_link=None, straggler=None, iter_sleep: float = 0.05,
            deadline_sec: float = 60.0, obs_dir: str | None = None, watch=None,
            tracker_cls=Tracker, worker_cls=ElasticWorker, proxy_cls=ChaosProxy,
            spec_cls=FaultSpec) -> dict:
    """Run the job to its end (see the module docstring).  Returns each
    task's ``ElasticResult`` (``results``), the tracker's ``events``, its
    ``incidents`` section, ``telemetry`` (the document written at its stop),
    the planned ``rings`` in epoch order, ``n_repaired``, the ``final``
    scrape taken once every worker is done, ``watched`` and ``elapsed``."""
    s_rank, s_delay = (int(straggler[0]), float(straggler[1])) if straggler else (-1, 0.0)

    def contribution(version: int, w: int, r: int):
        time.sleep(iter_sleep)
        if r == s_rank:
            time.sleep(s_delay)  # the compute straggler
        return work(version, w, r)

    tracker = tracker_cls(world, quiet=True, shrink_after_sec=1.5, promote_after_sec=0.1,
                          schedule=schedule, sched_repair=repair, obs_dir=obs_dir).start()
    addr = (tracker.host, tracker.port)
    # a degraded hop, or a peer busy computing, stalls frames without a death
    link_timeout = max(1.0, 4 * slow_link[2] if slow_link else 0.0, 4 * s_delay)
    workers = [worker_cls(addr, str(i), contribution, niter, heartbeat_sec=HEARTBEAT_SEC,
                          wave_timeout=10.0, link_timeout=link_timeout,
                          deadline_sec=deadline_sec)
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
    t0 = time.monotonic()
    threads = [threading.Thread(target=lambda w=w: results.__setitem__(w.task_id, w.run()),
                                daemon=True) for w in workers]
    watcher = None
    if watch is not None:
        watcher = threading.Thread(target=lambda: watched.append(watch(*addr)), daemon=True)
    try:
        for th in threads:
            th.start()
        if watcher is not None:
            watcher.start()
        for th in threads:
            th.join(timeout=max(deadline_sec + 10.0 - (time.monotonic() - t0), 1.0))
            if th.is_alive():
                raise TimeoutError(f"a worker thread ran past the job's {deadline_sec} s")
        if watcher is not None:
            watcher.join(timeout=10.0)
        final = top.scrape(*addr, registry=False)
    finally:
        tracker.stop()
        if proxy is not None:
            proxy.stop()
    events = list(tracker.events)
    return {"results": results, "events": events, "incidents": tracker._health.render(),
            "telemetry": tracker.telemetry,
            "rings": [list(e["ring_order"]) for e in events if e["kind"] == "schedule_planned"],
            "n_repaired": sum(1 for e in events if e["kind"] == "schedule_repaired"),
            "final": final, "watched": watched[0] if watched else None,
            "elapsed": time.monotonic() - t0}


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
