"""The delivery plane under load: a writer that publishes a snapshot every
round, a swarm of subscribers polling its version line through relays, the
dedup of identical bytes, and a tracker failover mid-stream.

The port's counterpart of ``tools/delivery_bench.py``, with its record
keys, driven against ``rabit_tpu_torch``'s ``Tracker``, ``Relay``,
``Standby``, ``Publisher`` and ``Subscriber``.

* ``swarm``: N simulated subscribers poll the version line through R relays
  while the writer publishes one snapshot a round; reports the polls, the
  failed polls (a poll still in flight when the window closes counts as
  failed), the propagation p50 and p99 (the writer's publish to a
  subscriber's first poll that sees the version), and the writer's cadence
  with the swarm attached over its cadence alone.  One difference from the
  JAX package's tool: the subscribers run in a spawned child process
  (their results come back through a queue), and only the tracker, the
  relays, the writer and one verifying subscriber stay in the caller.  With
  a thousand pollers in the caller's interpreter the relays wait on the
  pollers for the interpreter lock, and a poll outlives the window.  Both
  processes keep the heap they had before the window out of the cyclic
  collector's passes over it (``gc.freeze``), so that a caller with a large
  heap does not stall its relays at the window's close.
* ``dedup``: T publishers commit identical bytes as T grows; the bytes put
  on the tracker's uplink must stay flat (at most 1.2x one publisher's).
* ``failover``: a journaled primary and a warm standby; the primary dies
  mid-stream, the standby restores the version line from the journal,
  the writer and every subscriber rotate to it and converge on the
  post-failover digest with no errors.

    python tools/torch_delivery_bench.py --arm swarm --subs 1000 --rounds 3 --round-sec 0.4
    python tools/torch_delivery_bench.py --smoke        # every arm, small

One JSON line an arm.  Imports the port only (and the stdlib).
"""

from __future__ import annotations

import argparse
import contextlib
import errno
import gc
import heapq
import importlib
import json
import multiprocessing
import select
import socket
import struct
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from rabit_tpu_torch.delivery import Publisher, Subscriber, digest_of  # noqa: E402
from rabit_tpu_torch.ha import Standby  # noqa: E402
from rabit_tpu_torch.relay import Relay  # noqa: E402
from rabit_tpu_torch.tracker import protocol as P  # noqa: E402
from rabit_tpu_torch.tracker.tracker import Tracker  # noqa: E402
from tools.torch_scale_sweep import raise_fd_limit  # noqa: E402

#: Seconds the caller waits for the swarm's child process to start.
CHILD_START_SEC = 60.0
#: Due polls a shard opens before it reads the replies that are in.  Where
#: the relays serve fewer polls a second than fall due (6667 for 1000
#: subscribers at 0.15 s), a loop that opened every due poll first would add
#: its own delay to every poll.
OPEN_BATCH = 32


def _pct(vals: list[float], q: float) -> float | None:
    if not vals:
        return None
    vals = sorted(vals)
    return vals[min(int(q * (len(vals) - 1)), len(vals) - 1)]


def _sub_poll_bytes(task_id: str) -> bytes:
    return (P.put_u32(P.MAGIC_HELLO) + P.put_u32(P.CMD_SUB) + P.put_i32(-1)
            + P.put_str(task_id) + P.put_str("{}"))


class _Poll:
    """One simulated CMD_SUB poll in flight: connect, write the hello, read
    the reply, parse the version out of it."""

    __slots__ = ("sock", "sub", "out", "buf")

    def __init__(self, sock, sub: int, out: bytes):
        self.sock = sock
        self.sub = sub
        self.out = bytearray(out)
        self.buf = bytearray()


#: SO_LINGER on, 0 s: close() resets the connection.
_LINGER_RESET = struct.pack("ii", 1, 0)


def _reply_whole(buf: bytearray) -> bool:
    """The reply, u32 ACK then a str (u32 length and bytes), is all in."""
    return len(buf) >= 8 and len(buf) >= 8 + int.from_bytes(buf[4:8], "little")


def _drive_shard(targets: list[tuple[str, int]], subs: range, duration_sec: float,
                 poll_sec: float, out: list) -> None:
    """One shard of the swarm: one epoll loop drives a slice of the
    subscribers, each polling every ``poll_sec`` (phases staggered) at its
    round-robin target; a poll falls due no earlier than the subscriber's
    last one ended, and at most ``OPEN_BATCH`` due polls open between two
    reads of the replies.  The first poll of a subscriber that sees a
    version is recorded as ``(version, time.monotonic())``.  Appends the
    shard's polls, failures and observations to ``out``.

    A poll costs as few system calls as the protocol lets: the socket is
    made non-blocking, the hello goes at once on a loopback connect that is
    through already, the poll ends when its whole reply is in, and a closed
    socket leaves the epoll set with its close.  A poll whose reply is in
    closes with a reset (``SO_LINGER`` 0): the relay's side, which closed
    first, is freed at once instead of waiting out TIME_WAIT, so the
    loopback stack of the one host that plays the whole swarm does not
    hold a socket for each of the last minute's polls."""
    ep = select.epoll()
    t0 = time.monotonic()
    deadline = t0 + duration_sec
    # the polls to open, by due time (a heap: the loop touches only the due)
    due = [(t0 + (i % 997) / 997.0 * poll_sec, i) for i in subs]
    heapq.heapify(due)
    overdue: set[int] = set()  # fell due while in flight: open at the close
    seen: dict[int, int] = dict.fromkeys(subs, 0)
    hellos = {i: _sub_poll_bytes(f"sw{i}") for i in subs}
    inflight: dict[int, _Poll] = {}  # by subscriber
    by_fd: dict[int, _Poll] = {}
    observed: list[tuple[int, float]] = []
    polls = failures = 0

    def _open(sub: int) -> None:
        nonlocal failures
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM | socket.SOCK_NONBLOCK)
        except OSError:
            failures += 1
            return
        p = _Poll(sock, sub, hellos[sub])
        rc = sock.connect_ex(targets[sub % len(targets)])
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            sock.close()
            failures += 1
            return
        try:
            del p.out[:sock.send(p.out)]
        except OSError:
            pass  # not connected yet: sent once it is
        try:
            ep.register(sock.fileno(), select.EPOLLOUT if p.out else select.EPOLLIN)
        except OSError:
            sock.close()
            failures += 1
            return
        inflight[sub] = by_fd[sock.fileno()] = p

    def _close(p: _Poll, ok: bool) -> None:
        nonlocal polls, failures
        by_fd.pop(p.sock.fileno(), None)
        if ok:
            p.sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, _LINGER_RESET)
        p.sock.close()
        inflight.pop(p.sub, None)
        if p.sub in overdue:
            overdue.discard(p.sub)
            heapq.heappush(due, (time.monotonic(), p.sub))
        if not ok:
            failures += 1
            return
        polls += 1
        if len(p.buf) >= 8:  # u32 ACK, then the line as a str
            try:
                v = int(json.loads(p.buf[8:].decode()).get("version", 0))
            except (ValueError, UnicodeDecodeError, AttributeError):
                return
            if v > seen[p.sub]:
                seen[p.sub] = v
                observed.append((v, time.monotonic()))

    while time.monotonic() < deadline:
        now = time.monotonic()
        opened = 0
        while due and due[0][0] <= now and opened < OPEN_BATCH:
            opened += 1
            sub = heapq.heappop(due)[1]
            if sub in inflight:
                overdue.add(sub)
                continue
            heapq.heappush(due, (now + poll_sec, sub))
            _open(sub)
        # replies already in are read before more polls open; no wait while
        # polls are still due
        for fd, mask in ep.poll(0 if due and due[0][0] <= now else 0.02):
            p = by_fd.get(fd)
            if p is None:
                continue
            if p.out:
                if mask & (select.EPOLLERR | select.EPOLLHUP):
                    _close(p, ok=False)
                    continue
                try:
                    del p.out[:p.sock.send(p.out)]
                except BlockingIOError:
                    continue
                except OSError:
                    _close(p, ok=False)
                    continue
                if not p.out:
                    try:
                        ep.modify(fd, select.EPOLLIN)
                    except OSError:
                        _close(p, ok=False)
                continue
            while True:
                try:
                    data = p.sock.recv(1 << 16)
                except BlockingIOError:
                    break
                except OSError:
                    _close(p, ok=False)
                    break
                p.buf += data
                if not data or _reply_whole(p.buf):
                    _close(p, ok=True)
                    break
    for p in list(inflight.values()):
        _close(p, ok=False)  # still in flight when the window closed
    ep.close()
    out.append({"polls": polls, "failures": failures, "observed": observed})


def drive_swarm(targets: list[tuple[str, int]], n_subs: int, duration_sec: float,
                poll_sec: float, shards: int = 8) -> dict:
    """``n_subs`` simulated subscribers over ``shards`` epoll threads of
    this process, for ``duration_sec``; returns the polls, the failures and
    every ``(version, time.monotonic())`` first observation."""
    raise_fd_limit(n_subs + 256)
    cpu0 = time.process_time()
    shards = max(1, min(shards, n_subs))
    per = (n_subs + shards - 1) // shards
    out: list[dict] = []
    threads = [threading.Thread(target=_drive_shard,
                                args=(targets, range(lo, min(lo + per, n_subs)), duration_sec,
                                      poll_sec, out), daemon=True)
               for lo in range(0, n_subs, per)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration_sec + 60)
    return {"polls": sum(s["polls"] for s in out),
            "failures": sum(s["failures"] for s in out),
            "observed": [o for s in out for o in s["observed"]],
            "cpu_s": time.process_time() - cpu0}


@contextlib.contextmanager
def _heap_frozen():
    """Keep the objects that exist now out of the cyclic collector's passes
    (``gc.freeze``) until the block ends.  A full pass over a large heap,
    such as a long-lived test process's, holds every thread of the process
    for as long as it runs, and one at the window's close leaves every poll
    in flight.  Objects made inside the block are collected as usual."""
    mine = gc.get_freeze_count() == 0
    if mine:
        gc.freeze()
    try:
        yield
    finally:
        if mine:
            gc.unfreeze()


def _swarm_child(targets, n_subs, duration_sec, poll_sec, shards, ready, go, results) -> None:
    """The swarm's process: signal ``ready``, wait for ``go``, drive the
    swarm, put its record on ``results``."""
    ready.set()
    go.wait(CHILD_START_SEC)
    with _heap_frozen():
        rec = drive_swarm([tuple(t) for t in targets], n_subs, duration_sec, poll_sec,
                          shards=shards)
    results.put(rec)


def latencies(observed: list[tuple[int, float]], publish_ts: dict[int, float]) -> list[float]:
    """Propagation delays, seconds: each first observation of a version
    after the writer's publish of it returned (an observation before that
    moment, or of a version the writer did not stamp, counts no delay).
    Both stamps are ``time.monotonic()``, one clock for every process."""
    return [t - publish_ts[v] for v, t in observed if v in publish_ts and t >= publish_ts[v]]


def _writer(pub: Publisher, rounds: int, round_sec: float, size: int,
            publish_ts: dict[int, float], out: dict, start_version: int = 0) -> None:
    """The writer job: one publish a round at the training cadence, each
    round's bytes distinct."""
    t0 = time.monotonic()
    done = 0
    for r in range(rounds):
        v = start_version + r + 1
        try:
            pub.publish(v, bytes([r & 0xFF]) * size, epoch=1)
        except ConnectionError:
            continue
        publish_ts[v] = time.monotonic()
        done += 1
        time.sleep(max(t0 + (r + 1) * round_sec - time.monotonic(), 0.0))
    out["rounds"] = done
    out["seconds"] = time.monotonic() - t0
    out["rounds_per_sec"] = done / max(out["seconds"], 1e-9)


def run_swarm(n_subs: int, n_relays: int, rounds: int, round_sec: float, size: int,
              poll_sec: float, shards: int = 8) -> dict:
    """The swarm arm (module docstring): the writer alone first, then the
    writer with the swarm (in a spawned child) and one verifying subscriber
    attached."""
    raise_fd_limit(n_subs + 256)
    tr = Tracker(1, quiet=True).start()
    relays = [Relay((tr.host, tr.port), relay_id=f"r{i}",
                    flush_sec=min(poll_sec / 2, 0.25)).start() for i in range(n_relays)]
    targets = [(r.host, r.port) for r in relays]
    duration = rounds * round_sec + 2 * poll_sec
    ctx = multiprocessing.get_context("spawn")
    ready, go, results = ctx.Event(), ctx.Event(), ctx.Queue()
    # by its importable name, so that the child finds it however this
    # module was loaded
    child_fn = importlib.import_module("tools.torch_delivery_bench")._swarm_child
    child = ctx.Process(target=child_fn, daemon=True,
                        args=(targets, n_subs, duration, poll_sec, shards, ready, go, results))
    try:
        base: dict = {}
        _writer(Publisher(tr.host, tr.port, task_id="w-base"), rounds, round_sec, size, {},
                base)
        child.start()
        if not ready.wait(CHILD_START_SEC):
            raise RuntimeError("the swarm's process did not start")
        publish_ts: dict[int, float] = {}
        obs: dict = {}
        stop = threading.Event()
        fetch_errors = [0]
        fetched = [0]

        def _verify():
            sub = Subscriber(targets[0][0], targets[0][1], task_id="verify", poll_sec=poll_sec)
            while not stop.is_set():
                try:
                    line = sub.poll()
                    if int(line.get("version", 0)) > sub.seen_version:
                        _l, blob = sub.fetch(line, deadline_sec=duration)
                        if digest_of(blob) != line["digest"]:
                            fetch_errors[0] += 1
                        else:
                            fetched[0] += 1
                except (ConnectionError, LookupError, TimeoutError):
                    fetch_errors[0] += 1
                time.sleep(poll_sec)

        wt = threading.Thread(target=_writer,
                              args=(Publisher(tr.host, tr.port, task_id="w-obs"), rounds,
                                    round_sec, size, publish_ts, obs),
                              kwargs={"start_version": rounds}, daemon=True)
        vt = threading.Thread(target=_verify, daemon=True)
        with _heap_frozen():
            cpu0 = time.process_time()
            go.set()
            wt.start()
            vt.start()
            swarm = results.get(timeout=duration + 120)
            serving_cpu = time.process_time() - cpu0
        wt.join(duration + 30)
        stop.set()
        vt.join(5)
        child.join(30)
        lat = latencies(swarm["observed"], publish_ts)
        cadence = (obs.get("rounds_per_sec", 0.0)
                   / max(base.get("rounds_per_sec", 1e-9), 1e-9))
        return {
            "bench": "delivery", "arm": "swarm", "subs": n_subs, "relays": n_relays,
            "rounds": rounds, "round_sec": round_sec, "snapshot_bytes": size,
            "polls": swarm["polls"], "failures": swarm["failures"], "n_lat": len(lat),
            "prop_p50_ms": (_pct(lat, 0.50) or 0.0) * 1e3,
            "prop_p99_ms": (_pct(lat, 0.99) or 0.0) * 1e3,
            "fetches_verified": fetched[0], "fetch_errors": fetch_errors[0],
            "writer_rounds_per_sec": round(obs.get("rounds_per_sec", 0.0), 3),
            "unobserved_rounds_per_sec": round(base.get("rounds_per_sec", 0.0), 3),
            "writer_cadence_ratio": round(cadence, 4),
            "round_ms": round_sec * 1e3,
            "swarm_process": "spawned child",
            # CPU seconds over the observed window: the swarm's process, and
            # this one (the tracker, the relays, the writer, the verifier)
            "swarm_cpu_s": round(swarm["cpu_s"], 3), "serving_cpu_s": round(serving_cpu, 3),
        }
    finally:
        if child.is_alive():
            child.kill()
            child.join(5)
        for r in relays:
            r.stop()
        tr.stop()


def run_dedup(size: int, tenant_counts: tuple[int, ...] = (1, 2, 4, 8)) -> dict:
    """The tracker's uplink bytes as the publishers of one identical
    snapshot grow: only the first publisher of a digest uploads, so the
    uplink stays flat (at most 1.2x one publisher's)."""
    rows = []
    blob = b"\xa5" * size
    for t in tenant_counts:
        tr = Tracker(1, quiet=True).start()
        try:
            uplink = 0
            for i in range(t):
                pub = Publisher(tr.host, tr.port, task_id=f"tenant{i}")
                reply = pub.publish(i + 1, blob, epoch=1)
                # the line RPC always, the bytes only on a digest miss
                uplink += 256 + pub.uploads * size
                if reply["digest"] != digest_of(blob):
                    raise RuntimeError(f"tracker line names {reply['digest']}")
            rows.append({"tenants": t, "uplink_bytes": uplink, "snaps_held": len(tr._snaps)})
        finally:
            tr.stop()
    worst = max(r["uplink_bytes"] / rows[0]["uplink_bytes"] for r in rows)
    return {"bench": "delivery", "arm": "dedup", "snapshot_bytes": size, "rows": rows,
            "worst_uplink_ratio": round(worst, 4), "dedup_ok": worst <= 1.2}


def run_failover(n_subs: int, rounds: int, round_sec: float, size: int,
                 poll_sec: float) -> dict:
    """Kill the primary mid-stream: the standby restores the version line
    from the journal, the writer and the subscribers rotate to it, and every
    subscriber converges on the post-failover digest with no errors."""
    del round_sec  # the writer publishes back to back here
    journal = str(Path(tempfile.mkdtemp(prefix="delivery_ha_")) / "journal.bin")
    tr = Tracker(1, quiet=True, journal=journal, ha_tick_sec=0.05).start()
    standby = Standby(journal_path=journal, takeover_sec=0.6, poll_sec=0.05,
                      standby_id="delivery-standby").start()
    addrs = [(tr.host, tr.port), (standby.host, standby.port)]
    subs = [Subscriber(tr.host, tr.port, task_id=f"ha-sub{i}", addrs=addrs, timeout=2.0,
                       retries=8, poll_sec=poll_sec) for i in range(n_subs)]
    errors = 0
    try:
        pub = Publisher(tr.host, tr.port, task_id="ha-writer", addrs=addrs, timeout=2.0,
                        retries=8)
        pre_blob = b"\x01" * size
        pub.publish(1, pre_blob, epoch=1)
        for s in subs:
            if s.fetch(deadline_sec=10.0)[1] != pre_blob:
                errors += 1
        tr.journal.flush(5.0)
        t_kill = time.monotonic()
        tr.kill()
        if not standby.wait_promoted(10.0):
            raise RuntimeError("standby never promoted")
        t_takeover = time.monotonic() - t_kill
        restored = dict(standby.tracker._delivery or {})
        line_restored = restored.get("version") == 1
        # the bytes are process state: the writer's next publishes re-feed them
        post_blob = b"\x02" * size
        for r in range(rounds):
            pub.publish(2 + r, post_blob if r == rounds - 1 else b"\x03" * size, epoch=1)
        want = digest_of(post_blob)
        converged = 0
        for s in subs:
            try:
                line = s.wait_for(rounds + 1, deadline_sec=15.0)
                _l, blob = s.fetch(line, deadline_sec=15.0)
                if line["digest"] == want and blob == post_blob:
                    converged += 1
                else:
                    errors += 1
            except (ConnectionError, TimeoutError, LookupError):
                errors += 1
        return {"bench": "delivery", "arm": "failover", "subs": n_subs,
                "takeover_sec": round(t_takeover, 3), "line_restored": line_restored,
                "converged": converged, "subscriber_errors": errors,
                "failover_ok": line_restored and errors == 0 and converged == n_subs}
    finally:
        standby.stop()
        tr.stop()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_delivery_bench.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arm", default="all", choices=["all", "swarm", "dedup", "failover"])
    ap.add_argument("--subs", type=int, default=10_000, help="simulated subscribers (swarm)")
    ap.add_argument("--relays", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=6, help="writer publishes an arm")
    ap.add_argument("--round-sec", type=float, default=5.0, help="the writer's cadence")
    ap.add_argument("--size", type=int, default=1 << 20, help="snapshot bytes a publish")
    ap.add_argument("--poll-sec", type=float, default=2.0)
    ap.add_argument("--shards", type=int, default=8, help="the swarm's epoll threads")
    ap.add_argument("--ha-subs", type=int, default=8,
                    help="full-fetch subscribers of the failover arm")
    ap.add_argument("--smoke", action="store_true", help="small: 200 subscribers, short rounds")
    args = ap.parse_args(argv)
    if args.smoke:
        args.subs = min(args.subs, 200)
        args.rounds = min(args.rounds, 4)
        args.round_sec = min(args.round_sec, 0.4)
        args.size = min(args.size, 64 << 10)
        args.poll_sec = min(args.poll_sec, 0.15)
        args.ha_subs = min(args.ha_subs, 4)
    ok = True
    if args.arm in ("all", "swarm"):
        rec = run_swarm(args.subs, args.relays, args.rounds, args.round_sec, args.size,
                        args.poll_sec, shards=args.shards)
        rec["prop_ok"] = rec["prop_p99_ms"] < args.round_sec * 1e3
        rec["cadence_ok"] = rec["writer_cadence_ratio"] >= 0.95
        ok &= rec["prop_ok"] and rec["cadence_ok"]
        print(json.dumps(rec), flush=True)
    if args.arm in ("all", "dedup"):
        rec = run_dedup(args.size)
        ok &= rec["dedup_ok"]
        print(json.dumps(rec), flush=True)
    if args.arm in ("all", "failover"):
        rec = run_failover(args.ha_subs, args.rounds, args.round_sec, args.size,
                           args.poll_sec)
        ok &= rec["failover_ok"]
        print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
