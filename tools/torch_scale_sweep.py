"""The control plane at scale: a world of simulated workers against the
port's tracker, direct and through relays.

The port's counterpart of ``tools/scale_sweep.py``, with its record keys,
driven against ``rabit_tpu_torch``'s ``Tracker`` and ``Relay``.  One
selectors loop stands in for every worker's tracker side (the bootstrap
check-in, then the Assignment drained to EOF; the heartbeat lease
renewals; one metrics snapshot a worker), so one process plays a world of
thousands and measures what the tracker does under the storm:

* the bootstrap wave: every worker connects at once, first connect to the
  last Assignment delivered;
* the recovery wave: the same with CMD_RECOVER while every worker keeps
  renewing its lease;
* heartbeat and metrics round trips, p50 and p99 (one RPC in flight a
  worker, as the real heartbeat ticker);
* the tracker's accepts and its handler-thread and loop-connection peaks,
  this process's open-fd peak, and the leases that expired.

Three arms a world: ``threaded_direct`` (a thread a connection, listen
backlog 256), ``reactor_direct`` (the selectors loop, backlog
``rabit_tracker_backlog``) and ``relayed`` (the loop behind R relays, the
workers spread over them: the tracker accepts O(R) connections).

    python tools/torch_scale_sweep.py --worlds 256 1024    # one JSON line a (world, arm)
    python tools/torch_scale_sweep.py --quick              # world 256, short liveness

Imports the port only (and the stdlib).
"""

from __future__ import annotations

import argparse
import errno
import json
import os
import random
import selectors
import socket
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rabit_tpu_torch.tracker import protocol as P  # noqa: E402
from rabit_tpu_torch.tracker.tracker import Tracker  # noqa: E402

#: The threaded arm's listen backlog; the loop's arms read
#: rabit_tracker_backlog.
LEGACY_BACKLOG = 256

ARMS = ("threaded_direct", "reactor_direct", "relayed")


def raise_fd_limit(need: int) -> int:
    """Best-effort RLIMIT_NOFILE raise; returns the resulting soft
    limit (the caller clamps worlds that cannot fit — loudly)."""
    try:
        import resource

        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        want = min(hard if hard > 0 else need, max(need, soft))
        if want > soft:
            resource.setrlimit(resource.RLIMIT_NOFILE, (want, hard))
        return resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    except (ImportError, ValueError, OSError):
        return need


class _FdMonitor:
    """Samples the process-wide open-fd count (the sweep process hosts
    the tracker, the relays, AND the simulated workers, so this is the
    whole experiment's fd envelope)."""

    def __init__(self) -> None:
        self.hwm = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def _loop(self) -> None:
        while not self._stop.wait(0.05):
            try:
                self.hwm = max(self.hwm, len(os.listdir("/proc/self/fd")))
            except OSError:
                return

    def __enter__(self) -> "_FdMonitor":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()


class _Sim:
    """Per-connection state of one simulated RPC (bootstrap check-in or
    heartbeat/metrics round-trip)."""

    __slots__ = ("sock", "worker", "role", "out", "t0", "connected",
                 "nread")

    def __init__(self, sock, worker: int, role: str, out: bytes,
                 t0: float):
        self.sock = sock
        self.worker = worker
        self.role = role          # "wave" | "hb" | "metrics"
        self.out = bytearray(out)
        self.t0 = t0
        self.connected = False
        self.nread = 0


def _hello_bytes(cmd: int, task_id: str, prev_rank: int = -1,
                 listen_port: int = 0, message: str = "") -> bytes:
    out = [P.put_u32(P.MAGIC_HELLO), P.put_u32(cmd), P.put_i32(prev_rank),
           P.put_str(task_id)]
    if cmd in (P.CMD_START, P.CMD_RECOVER):
        out.append(P.put_u32(listen_port))
    else:
        out.append(P.put_str(message))
    return b"".join(out)


def drive(world: int, targets: list[tuple[str, int]],
          wave_cmd: int | None = None,
          hb_interval: float = 0.0, hb_beats: int = 0,
          metrics: bool = False,
          hb_sustain: bool = False,
          deadline_sec: float = 120.0,
          seed: int = 0) -> dict:
    """One phase of simulated load (see module docstring).  Every worker
    with ``wave_cmd`` runs exactly one wave RPC (replies drain to EOF —
    the tracker closes after the assignment, so no protocol parse is
    needed); ``hb_interval > 0`` additionally renews each worker's lease
    ``hb_beats`` times (plus one CMD_METRICS snapshot per worker when
    ``metrics``), closed-loop per worker.  ``hb_sustain`` keeps every
    worker renewing until the wave completes — what real Heartbeat
    tickers do while a recovery wave forms, so lease health under a slow
    wave is measured honestly (a finite beat count would let leases
    lapse by construction).  Bounded by ``deadline_sec``; a phase that
    cannot finish reports ``timed_out`` with partial counts — a hung arm
    is evidence, not an error."""
    rng = random.Random(seed)
    sel = selectors.DefaultSelector()
    t_start = time.monotonic()
    deadline = t_start + deadline_sec
    wave_done: set[int] = set()
    wave_bytes = 0
    lat_wave: list[float] = []
    lat_rpc: list[float] = []
    rpc_failures = 0
    # per-worker schedules: wave retries and heartbeat cadences, with at
    # most one in-flight connection per (worker, kind)
    wave_next = {i: t_start + (i % 97) * 1e-4 for i in range(world)} \
        if wave_cmd is not None else {}
    wave_attempt = dict.fromkeys(range(world), 0) if wave_cmd is not None \
        else {}
    hb_next: dict[int, float] = {}
    hb_left: dict[int, int] = {}
    met_left: dict[int, int] = {}
    if hb_interval > 0 and (hb_beats > 0 or hb_sustain):
        for i in range(world):
            hb_next[i] = t_start + (i / max(world, 1)) * hb_interval
            hb_left[i] = (1 << 30) if hb_sustain else hb_beats
            met_left[i] = 1 if metrics else 0
    inflight: dict[tuple[int, str], _Sim] = {}

    def open_conn(worker: int, role: str, payload: bytes) -> None:
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        except OSError:
            # EMFILE under the storm: back off and retry, exactly what a
            # real worker's bounded-retry RPC path would do.
            _fail(_Sim(None, worker, role, b"", time.monotonic()))
            return
        sock.setblocking(False)
        sim = _Sim(sock, worker, role, payload, time.monotonic())
        try:
            rc = sock.connect_ex(targets[worker % len(targets)])
        except OSError:
            sock.close()
            _fail(sim)
            return
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            sock.close()
            _fail(sim)
            return
        try:
            sel.register(sock, selectors.EVENT_WRITE, sim)
        except (OSError, ValueError):
            sock.close()
            _fail(sim)
            return
        inflight[(worker, "wave" if role == "wave" else "rpc")] = sim

    def _fail(sim: _Sim) -> None:
        nonlocal rpc_failures
        inflight.pop((sim.worker, "wave" if sim.role == "wave" else "rpc"),
                     None)
        if sim.role == "wave":
            # retry with tracker_rpc-shaped backoff until the deadline
            wave_attempt[sim.worker] += 1
            delay = min(0.1 * (2 ** min(wave_attempt[sim.worker], 6)), 2.0)
            wave_next[sim.worker] = (time.monotonic()
                                     + delay * (0.5 + 0.5 * rng.random()))
        else:
            rpc_failures += 1
            if sim.role == "hb":
                hb_next[sim.worker] = time.monotonic() + hb_interval

    def _drop(sim: _Sim) -> None:
        try:
            sel.unregister(sim.sock)
        except (KeyError, OSError, ValueError):
            pass
        try:
            sim.sock.close()
        except OSError:
            pass

    def _complete(sim: _Sim) -> None:
        nonlocal wave_bytes
        now = time.monotonic()
        inflight.pop((sim.worker, "wave" if sim.role == "wave" else "rpc"),
                     None)
        if sim.role == "wave":
            if sim.nread < 8:
                _fail(sim)  # EOF before any reply: refused under storm
                return
            wave_done.add(sim.worker)
            wave_bytes += sim.nread
            lat_wave.append(now - sim.t0)
        else:
            if sim.nread < 4:
                _fail(sim)
                return
            lat_rpc.append(now - sim.t0)
            if sim.role == "hb":
                hb_left[sim.worker] -= 1
                if hb_left[sim.worker] > 0:
                    hb_next[sim.worker] = sim.t0 + hb_interval

    while True:
        now = time.monotonic()
        if now > deadline:
            break
        boot_pending = (wave_cmd is not None
                        and len(wave_done) < world)
        if hb_sustain and not boot_pending and hb_left:
            hb_left = dict.fromkeys(hb_left, 0)  # wave done: stop renewing
        hb_pending = any(n > 0 for n in hb_left.values())
        met_pending = any(n > 0 for n in met_left.values())
        if not boot_pending and not hb_pending and not met_pending \
                and not inflight:
            break
        # launch due work (at most one in-flight per worker per lane)
        if wave_cmd is not None:
            for i, due in wave_next.items():
                if (i not in wave_done and now >= due
                        and (i, "wave") not in inflight):
                    open_conn(i, "wave", _hello_bytes(
                        wave_cmd, str(i),
                        prev_rank=(i if wave_cmd == P.CMD_RECOVER else -1),
                        listen_port=20000 + i))
        for i, due in hb_next.items():
            if (i, "rpc") in inflight or now < due:
                continue
            if met_left.get(i):
                met_left[i] = 0
                snap = json.dumps({"rank": i, "task_id": str(i)})
                open_conn(i, "metrics", _hello_bytes(
                    P.CMD_METRICS, str(i), prev_rank=i, message=snap))
            elif hb_left.get(i, 0) > 0:
                open_conn(i, "hb", _hello_bytes(
                    P.CMD_HEARTBEAT, str(i), prev_rank=i,
                    message=f"{hb_interval:.6f}"))
        try:
            events = sel.select(0.02)
        except OSError:
            break
        for key, mask in events:
            sim: _Sim = key.data
            if not sim.connected and mask & selectors.EVENT_WRITE:
                err = sim.sock.getsockopt(socket.SOL_SOCKET,
                                          socket.SO_ERROR)
                if err:
                    _drop(sim)
                    _fail(sim)
                    continue
                sim.connected = True
            if sim.out and mask & selectors.EVENT_WRITE:
                try:
                    n = sim.sock.send(sim.out)
                    del sim.out[:n]
                except (BlockingIOError, InterruptedError):
                    pass
                except OSError:
                    _drop(sim)
                    _fail(sim)
                    continue
                if not sim.out:
                    try:
                        sel.modify(sim.sock, selectors.EVENT_READ, sim)
                    except (KeyError, OSError, ValueError):
                        _drop(sim)
                        _fail(sim)
                continue
            if mask & selectors.EVENT_READ:
                try:
                    data = sim.sock.recv(65536)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    _drop(sim)
                    _fail(sim)
                    continue
                if data:
                    sim.nread += len(data)
                else:
                    _drop(sim)
                    _complete(sim)
    # teardown: anything still in flight is truncated by the deadline
    for sim in list(inflight.values()):
        _drop(sim)
    sel.close()

    def _pct(vals: list[float], q: float) -> float | None:
        if not vals:
            return None
        vals = sorted(vals)
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    out = {
        "elapsed_s": round(time.monotonic() - t_start, 3),
        "timed_out": time.monotonic() > deadline,
    }
    if wave_cmd is not None:
        out.update(
            wave_completed=len(wave_done),
            wave_latency_s=(round(max(lat_wave), 3) if len(wave_done)
                            >= world else None),
            wave_bytes=wave_bytes,
        )
    if hb_interval > 0:
        out.update(
            rpcs=len(lat_rpc),
            rpc_failures=rpc_failures,
            rpc_p50_ms=(round(1e3 * _pct(lat_rpc, 0.50), 2)
                        if lat_rpc else None),
            rpc_p99_ms=(round(1e3 * _pct(lat_rpc, 0.99), 2)
                        if lat_rpc else None),
        )
    return out


def run_arm(arm: str, world: int, relays: int, hb_interval: float,
            hb_beats: int, deadline_sec: float) -> dict:
    """One (world, arm) cell: bootstrap wave -> liveness -> recovery
    wave under liveness load, all against a fresh in-process tracker."""
    assert arm in ARMS, arm
    reactor = arm != "threaded_direct"
    tracker = Tracker(world, quiet=True, reactor=reactor,
                      backlog=(LEGACY_BACKLOG if not reactor else None)).start()
    relay_objs = []
    targets = [(tracker.host, tracker.port)]
    if arm == "relayed":
        from rabit_tpu_torch.relay import Relay

        relay_objs = [Relay((tracker.host, tracker.port),
                            relay_id=f"relay{i}", flush_sec=0.25,
                            quiet=True).start()
                      for i in range(relays)]
        targets = [(r.host, r.port) for r in relay_objs]
    rec = {"bench": "scale_sweep", "world": world, "arm": arm,
           "relays": len(relay_objs), "backlog": tracker.backlog,
           "hb_interval_s": hb_interval}
    try:
        with _FdMonitor() as fds:
            rec["bootstrap"] = drive(world, targets, wave_cmd=P.CMD_START,
                                     deadline_sec=deadline_sec, seed=world)
            rec["liveness"] = drive(world, targets,
                                    hb_interval=hb_interval,
                                    hb_beats=hb_beats, metrics=True,
                                    deadline_sec=deadline_sec,
                                    seed=world + 1)
            # the recovery wave contends with live heartbeat traffic —
            # the shape a real mid-job recovery sees; renewals sustain
            # until the wave closes, so lease_expired counts genuine
            # detector false-positives, not a stopped load generator
            rec["recovery"] = drive(world, targets, wave_cmd=P.CMD_RECOVER,
                                    hb_interval=hb_interval,
                                    hb_sustain=True,
                                    deadline_sec=deadline_sec,
                                    seed=world + 2)
            rec["fd_hwm"] = fds.hwm
        with tracker._stats_lock:
            rec["tracker"] = dict(tracker.serve_stats)
        rec["lease_expired"] = sum(
            1 for e in tracker.events if e["kind"] == "lease_expired")
        rec["snapshots"] = len(tracker.snapshots)
    finally:
        for r in relay_objs:
            r.stop()
        tracker.stop()
    return rec


def scale_sweep(worlds: list[int], arms: list[str] | None = None,
                relays_for=lambda w: min(16, max(2, w // 256)),
                hb_interval: float = 2.0, hb_beats: int = 3,
                deadline_sec: float = 180.0,
                threaded_max_world: int = 4096,
                emit=print) -> list[dict]:
    """The full curve: one record per (world, arm).  Skips (loudly, with
    a skipped record) arms that cannot fit — the threaded arm beyond
    ``threaded_max_world``, any world whose fd needs exceed the rlimit —
    rather than capping silently."""
    arms = list(arms or ARMS)
    out = []
    for world in worlds:
        # Peak fds: one live connection per worker, both ends in this
        # process (2/worker), plus listeners/channels/monitor slack.
        need = 2 * world + 2048
        limit = raise_fd_limit(need)
        for arm in arms:
            if arm == "threaded_direct" and world > threaded_max_world:
                rec = {"bench": "scale_sweep", "world": world, "arm": arm,
                       "skipped": f"world {world} > --threaded-max-world "
                                  f"{threaded_max_world} (thread-per-conn "
                                  f"does not survive it)"}
            elif limit < need:
                rec = {"bench": "scale_sweep", "world": world, "arm": arm,
                       "skipped": f"needs ~{need} fds, rlimit is {limit}"}
            else:
                rec = run_arm(arm, world, relays_for(world), hb_interval,
                              hb_beats, deadline_sec)
            out.append(rec)
            if emit is not None:
                emit(json.dumps(rec))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--worlds", type=int, nargs="*",
                    default=[512, 1024, 2048, 4096])
    ap.add_argument("--arms", nargs="*", default=list(ARMS),
                    choices=list(ARMS))
    ap.add_argument("--relays", type=int, default=0,
                    help="relay count (0 = world//256, clamped to 2..16)")
    ap.add_argument("--hb-interval", type=float, default=2.0)
    ap.add_argument("--hb-beats", type=int, default=3)
    ap.add_argument("--deadline", type=float, default=180.0)
    ap.add_argument("--threaded-max-world", type=int, default=4096)
    ap.add_argument("--quick", action="store_true",
                    help="the CPU test's shape: world 256, short liveness")
    args = ap.parse_args()
    if args.quick:
        scale_sweep([256], args.arms, hb_interval=0.5, hb_beats=2,
                    deadline_sec=60.0)
        return
    relays_for = ((lambda w: args.relays) if args.relays
                  else (lambda w: min(16, max(2, w // 256))))
    scale_sweep(args.worlds, args.arms, relays_for=relays_for,
                hb_interval=args.hb_interval, hb_beats=args.hb_beats,
                deadline_sec=args.deadline,
                threaded_max_world=args.threaded_max_world)


if __name__ == "__main__":
    main()
