"""The chaos proxy and the fuzz schedule runners: scriptable TCP fault
injection, and seeded fault campaigns against the port's control plane.

The port's own copy of ``rabit_tpu/chaos.py``.  A :class:`ChaosProxy` sits
between workers and the tracker, or between peers, forwards the byte
streams and injects the network faults of real incidents:

* **refuse**: a new connection is accepted and closed at once;
* **delay**: every forwarded chunk waits a sampled latency first;
* **truncate**: the client-to-upstream stream is cut after a sampled
  prefix, mid-message;
* **blackhole**: the connection stays open but nothing is forwarded;
* **partition**: a switch; while on, new connections are refused and
  every established one is cut;
* **slow_link**: one direction of one peer link is slow: only the
  client-to-upstream direction is delayed, and, when the proxy fronts a
  worker's listen socket, only for the dialer whose MAGIC_LINK hello names
  a chosen source rank.  This is the fault the schedule's degraded-link
  repair routes around: an ``ElasticWorker`` that advertises the proxy's
  port (``advertise_port``) gets its incoming link from that rank slowed.

All randomness comes from one seeded ``random.Random``, so a failing
schedule replays.  Pure stdlib and threads: a connection costs two pump
threads.

:func:`run_schedule` drives bootstrap and recovery waves of thread-workers
(``tracker_rpc`` check-ins) through a proxy against the port's
:class:`Tracker`, heals the network after ``faulty_rounds`` rounds and
requires the job to converge: one epoch, dense stable ranks, no thread
alive past its RPC bound.

:func:`run_elastic_schedule` is its elastic sibling: seeded shrink and
grow scenarios (kills without restart, spares that park late, die parked
or die the moment they are promoted), optionally with a slow link, a
compute straggler under quorum rounds, relays and their faults
(``FaultSpec.relay_death`` / ``relay_partition``) or a warm standby and a
tracker death (``FaultSpec.tracker_death`` / ``standby_death``), driven
through :class:`~rabit_tpu_torch.elastic.client.ElasticWorker` threads,
with bitwise asserts at every intermediate world size.  A seed names the
same scenario here as in ``rabit_tpu.chaos``: the draws come from
``random.Random(seed)`` in the same order.  Each contribution is the
histogram of the rank's shard computed by ``ops.hist.node_histograms_kernel``
on ``device`` (the card by default; on CPU tensors, its plain twin).  The
runner's multi-job mode (``run_elastic_schedule(job=)``) is refused:
ROADMAP.md Queue 1 item 10g (``protocol.tracker_rpc(job=)`` itself only
joins the key into the wire task id, which a tracker of one job serves as
any other task id).
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker

#: recv chunk size of the pump loops; also the granularity of delay faults.
_CHUNK = 4096

#: link-hello field codecs (same layout as protocol.py's MAGIC_LINK frame)
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")


@dataclass
class FaultSpec:
    """Probabilities/ranges of the injected faults.  Mutable at runtime:
    assigning a fresh spec to ``proxy.spec`` re-scripts the proxy live
    (e.g. heavy faults during bootstrap, then heal)."""

    p_refuse: float = 0.0
    p_truncate: float = 0.0
    truncate_bytes: tuple[int, int] = (0, 64)
    p_blackhole: float = 0.0
    delay: tuple[float, float] = (0.0, 0.0)
    #: asymmetric per-link slowness: ``(src_rank, delay_s)`` delays every
    #: client->upstream chunk of connections whose MAGIC_LINK hello names
    #: ``src_rank`` as the dialer (``src_rank=None`` delays the c2u
    #: direction of EVERY connection — the one-way-congested tracker
    #: path).  A proxy with slow_link set is a dedicated link proxy: the
    #: sampled faults above do not apply to it.
    slow_link: tuple[int | None, float] | None = None
    #: relay-tier faults (consumed by :func:`run_elastic_schedule`'s
    #: ``relays=`` mode, not by the proxy): ``relay_death=(at_s, down_s)``
    #: stops relay 0 ``at_s`` seconds into the run and starts a new one on
    #: the same port ``down_s`` later (children reconnect; their padded
    #: upstream leases must ride it out with no spurious lease_expired);
    #: ``relay_partition=(at_s, dur_s)`` cuts relay 0's upstream channel for
    #: ``dur_s`` while it keeps serving its children locally.
    relay_death: tuple[float, float] | None = None
    relay_partition: tuple[float, float] | None = None
    #: HA faults (consumed by :func:`run_elastic_schedule`'s ``failover=``
    #: mode): ``tracker_death=at_s`` kills the primary tracker
    #: (``Tracker.kill``: every socket drops with no goodbye) ``at_s``
    #: seconds into the run, wherever the job is; the warm standby must take
    #: over and the job converge bitwise.  ``standby_death=at_s`` kills the
    #: standby instead, and the job must ride on the primary.
    tracker_death: float | None = None
    standby_death: float | None = None

    def clear(self) -> "FaultSpec":
        return FaultSpec()


@dataclass
class ChaosStats:
    connections: int = 0
    refused: int = 0
    truncated: int = 0
    blackholed: int = 0
    severed_by_partition: int = 0
    bytes_forwarded: int = 0
    slowed: int = 0  # connections whose c2u direction got the slow_link


@dataclass
class _Conn:
    client: socket.socket
    upstream: socket.socket
    closed: bool = False
    lock: threading.Lock = field(default_factory=threading.Lock)

    def sever(self) -> None:
        with self.lock:
            if self.closed:
                return
            self.closed = True
        for s in (self.client, self.upstream):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class ChaosProxy:
    """TCP proxy with scriptable fault injection (see module docstring).

    Usage::

        proxy = ChaosProxy((tracker.host, tracker.port),
                           FaultSpec(p_refuse=0.3), seed=7).start()
        ...point workers at (proxy.host, proxy.port)...
        proxy.spec = FaultSpec()        # heal mid-run
        proxy.set_partition(True)       # or cut everything
        proxy.stop()
    """

    def __init__(self, upstream: tuple[str, int],
                 spec: FaultSpec | None = None, seed: int = 0,
                 listen_host: str = "127.0.0.1", listen_port: int = 0):
        self.upstream = (upstream[0], int(upstream[1]))
        self.spec = spec if spec is not None else FaultSpec()
        self.stats = ChaosStats()
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        self._partitioned = False
        self._stopped = threading.Event()
        self._conns: list[_Conn] = []
        self._conns_lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((listen_host, listen_port))
        self._srv.listen(128)
        self.host, self.port = self._srv.getsockname()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ChaosProxy":
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="chaos-accept").start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._conns_lock:
            conns, self._conns = self._conns, []
        for c in conns:
            c.sever()

    def set_partition(self, on: bool) -> None:
        """While partitioned, refuse new connections and sever live ones."""
        self._partitioned = bool(on)
        if on:
            with self._conns_lock:
                conns, self._conns = self._conns, []
            for c in conns:
                self.stats.severed_by_partition += 1
                c.sever()

    # -- internals ---------------------------------------------------------

    def _roll(self) -> random.Random:
        # One shared seeded stream; per-decision access is serialized so a
        # given seed yields a reproducible fault sequence for a (mostly)
        # deterministic connection order.
        return self._rng

    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                client, _ = self._srv.accept()
            except OSError:
                return
            self.stats.connections += 1
            with self._rng_lock:
                refuse = (self._partitioned or
                          self._roll().random() < self.spec.p_refuse)
            if refuse:
                self.stats.refused += 1
                try:
                    client.close()
                except OSError:
                    pass
                continue
            threading.Thread(target=self._serve_conn, args=(client,),
                             daemon=True, name="chaos-conn").start()

    @staticmethod
    def _peek_link_hello(client: socket.socket) -> tuple[bytes, int | None]:
        """Read the 12-byte MAGIC_LINK hello (magic, rank, epoch) off a
        fresh peer-link connection.  Returns (bytes read, dialer rank or
        None); the bytes are forwarded upstream by the caller, so the
        handshake is observed, never consumed."""
        head = b""
        try:
            client.settimeout(5.0)
            while len(head) < 12:
                chunk = client.recv(12 - len(head))
                if not chunk:
                    break
                head += chunk
        except OSError:
            return head, None
        if len(head) < 8:
            return head, None
        magic = _U32.unpack_from(head, 0)[0]
        if magic != P.MAGIC_LINK:
            return head, None
        return head, _I32.unpack_from(head, 4)[0]

    def _serve_conn(self, client: socket.socket) -> None:
        spec = self.spec
        head = b""
        c2u_delay: tuple[float, float] | None = None
        if spec.slow_link is not None:
            # Dedicated link proxy: identify the dialer from the link
            # hello, delay only the matching client->upstream direction.
            src_rank, slow_s = spec.slow_link
            dialer = None
            if src_rank is not None:
                head, dialer = self._peek_link_hello(client)
            if src_rank is None or dialer == src_rank:
                c2u_delay = (float(slow_s), float(slow_s))
                self.stats.slowed += 1
        try:
            up = socket.create_connection(self.upstream, timeout=5.0)
        except OSError:
            try:
                client.close()
            except OSError:
                pass
            return
        conn = _Conn(client, up)
        with self._conns_lock:
            self._conns.append(conn)
        if spec.slow_link is not None:
            if head:
                try:
                    up.sendall(head)
                    self.stats.bytes_forwarded += len(head)
                except OSError:
                    conn.sever()
                    return
            threading.Thread(
                target=self._pump,
                args=(conn, client, up, None, c2u_delay or (0.0, 0.0)),
                daemon=True, name="chaos-pump-c2u").start()
            threading.Thread(
                target=self._pump, args=(conn, up, client, None, (0.0, 0.0)),
                daemon=True, name="chaos-pump-u2c").start()
            return
        with self._rng_lock:
            rng = self._roll()
            blackhole = rng.random() < spec.p_blackhole
            truncate_at = None
            if rng.random() < spec.p_truncate:
                truncate_at = rng.randint(*spec.truncate_bytes)
            delays = spec.delay
        if blackhole:
            # Forward nothing, close nothing: the silent-partition shape.
            # The conn stays registered so stop()/partition() reap it, and
            # both endpoints see only their own deadlines.
            self.stats.blackholed += 1
            return
        if truncate_at is not None:
            self.stats.truncated += 1
        threading.Thread(
            target=self._pump, args=(conn, client, up, truncate_at, delays),
            daemon=True, name="chaos-pump-c2u").start()
        threading.Thread(
            target=self._pump, args=(conn, up, client, None, delays),
            daemon=True, name="chaos-pump-u2c").start()

    def _pump(self, conn: _Conn, src: socket.socket, dst: socket.socket,
              truncate_at: int | None, delays: tuple[float, float]) -> None:
        budget = truncate_at
        try:
            try:
                src.settimeout(0.2)  # poll the stop/partition flags
            except OSError:
                return  # the sibling pump already severed this conn
            while not self._stopped.is_set() and not conn.closed:
                try:
                    data = src.recv(_CHUNK)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                if delays[1] > 0:
                    with self._rng_lock:
                        pause = self._roll().uniform(*delays)
                    if pause > 0:
                        time.sleep(pause)
                if budget is not None:
                    data = data[:budget]
                    budget -= len(data)
                try:
                    if data:
                        dst.sendall(data)
                        self.stats.bytes_forwarded += len(data)
                except OSError:
                    break
                if budget == 0:
                    break  # prefix forwarded; sever mid-message
        finally:
            conn.sever()


# -- the bootstrap and recovery schedule runner -------------------------------------

@dataclass
class ScheduleResult:
    seed: int
    world: int
    rounds: int
    completed: bool
    epoch: int
    rank_of: dict[str, int]
    elapsed: float
    stats: ChaosStats
    outcome: str  # "completed" | "failed_fast"


def _random_spec(rng: random.Random) -> FaultSpec:
    """A sampled fault mix: always at least one fault family active."""
    spec = FaultSpec(
        p_refuse=rng.choice([0.0, 0.2, 0.5]),
        p_truncate=rng.choice([0.0, 0.2, 0.5]),
        p_blackhole=rng.choice([0.0, 0.15]),
        delay=rng.choice([(0.0, 0.0), (0.0, 0.02), (0.01, 0.05)]),
    )
    if (spec.p_refuse == spec.p_truncate == spec.p_blackhole == 0.0
            and spec.delay[1] == 0.0):
        spec.p_refuse = 0.3
    return spec


def run_schedule(seed: int, world: int | None = None,
                 faulty_rounds: int = 2, deadline_sec: float = 20.0,
                 quiet: bool = True,
                 slow_one_way: float | None = None) -> ScheduleResult:
    """One fuzzed bootstrap/recovery scenario (deterministic per seed).

    Thread-workers check in through a freshly scripted :class:`ChaosProxy`
    against the port's :class:`Tracker`, in rounds that mirror the native
    engine's re-wave loop: every worker checks in and waits for its
    assignment; a round where anyone failed or the epochs disagree is
    retried, the survivors sending CMD_RECOVER (the failed-wave contract).
    One sampled worker "dies" after its first successful check-in and
    re-enters as a restart (a fresh CMD_START, the same task id), which
    fuzzes the replacement of a stale check-in.  After ``faulty_rounds``
    rounds the proxy heals, so every schedule must then converge: all
    workers agree on one epoch with stable, distinct ranks.  Every socket
    operation is bounded, and the schedule deadline turns "stuck" into a
    failure.  ``slow_one_way`` swaps the sampled faults for a delay of only
    the worker-to-tracker direction, until the heal.
    """
    rng = random.Random(seed)
    world = world if world is not None else rng.choice([2, 3, 4])
    tracker = Tracker(world, quiet=True, conn_timeout_sec=1.0).start()
    spec = (FaultSpec(slow_link=(None, float(slow_one_way)))
            if slow_one_way is not None else _random_spec(rng))
    proxy = ChaosProxy((tracker.host, tracker.port), spec, seed=seed).start()
    t0 = time.monotonic()
    deadline = t0 + deadline_sec
    tasks = [str(i) for i in range(world)]
    cmd = {t: P.CMD_START for t in tasks}
    rank_of: dict[str, int] = {}
    die_once = rng.choice(tasks) if rng.random() < 0.5 else None
    rounds = 0
    completed = False
    epoch = -1
    try:
        while time.monotonic() < deadline:
            rounds += 1
            if rounds > faulty_rounds:
                proxy.spec = FaultSpec()  # heal: convergence now mandatory
            results: dict[str, object] = {}

            # Every RPC is bounded: retries+1 attempts x (connect timeout +
            # reply timeout) + backoff.  A thread alive past that sum is a
            # hang, not a slow retry.
            retries, timeout, reply_timeout = 4, 0.25, 0.5
            worst_thread = (retries + 1) * (timeout + reply_timeout) + 2.0

            def boot(task_id: str) -> None:
                try:
                    results[task_id] = P.tracker_rpc(
                        proxy.host, proxy.port, cmd[task_id], task_id,
                        prev_rank=rank_of.get(task_id, -1),
                        listen_port=40000 + int(task_id),
                        timeout=timeout, reply_timeout=reply_timeout,
                        retries=retries, backoff=0.02, backoff_cap=0.2,
                        rng=random.Random(f"{seed}:{task_id}:{rounds}"),
                    )
                except P.TrackerUnreachable as exc:
                    results[task_id] = exc

            threads = [threading.Thread(target=boot, args=(t,), daemon=True)
                       for t in tasks]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=worst_thread)
                if th.is_alive():
                    raise TimeoutError(
                        f"schedule seed={seed}: worker thread hung past its "
                        f"RPC bound ({worst_thread:.0f}s, round {rounds})")
            asgs = {t: r for t, r in results.items() if isinstance(r, P.Assignment)}
            for t, asg in asgs.items():
                prev = rank_of.get(t)
                if prev is not None and prev != asg.rank:
                    raise AssertionError(
                        f"seed={seed}: task {t} rank changed {prev} -> "
                        f"{asg.rank} (stable re-admission violated)")
                rank_of[t] = asg.rank
            if len(asgs) == world:
                epochs = {a.epoch for a in asgs.values()}
                ranks = sorted(a.rank for a in asgs.values())
                if len(epochs) == 1 and ranks == list(range(world)):
                    epoch = epochs.pop()
                    completed = True
                    break
            # A failed wave: survivors re-enter as recover, failures keep
            # sending CMD_START.
            for t in tasks:
                cmd[t] = P.CMD_RECOVER if t in asgs else P.CMD_START
            if die_once is not None and die_once in asgs:
                cmd[die_once] = P.CMD_START  # its "restart" re-enters fresh
                die_once = None
        if not completed and time.monotonic() >= deadline:
            raise TimeoutError(
                f"schedule seed={seed}: no convergence within "
                f"{deadline_sec}s ({rounds} rounds)")
    finally:
        proxy.stop()
        tracker.stop()
    return ScheduleResult(
        seed=seed, world=world, rounds=rounds, completed=completed,
        epoch=epoch, rank_of=dict(rank_of),
        elapsed=time.monotonic() - t0, stats=proxy.stats,
        outcome="completed" if completed else "failed_fast",
    )


# -- the elastic schedule runner -----------------------------------------------------

#: The schedule's workers are threads of one process: their histogram
#: launches go one at a time, so the kernels' launch counters stay exact.
_LAUNCH_LOCK = threading.Lock()


def _shard_counter(data: np.ndarray, n_bins: int, device: str):
    """The elastic schedule's one piece of arithmetic on ``device``:
    ``counts(rows)`` is ``np.bincount(data[rows], minlength=n_bins)`` as
    int64, computed by ``node_histograms_kernel`` over the rows as an
    ``[n, 1]`` bin matrix with every node id 0 and g = h = 1.  The g plane
    of the ``[1, 1, n_bins, 2]`` histogram is the count: 1 is exact in the
    hi/lo bf16 planes, and f32 sums integers exactly below 2^24.  Each call
    is held against ``np.bincount`` (and, on the card, the first against
    ``node_histograms_kernel_plain``) exactly.  ``counts.n_calls`` is the
    number of kernel calls."""
    import torch

    from rabit_tpu_torch.ops import hist

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_elastic_schedule: device='cuda' but no CUDA device is "
                           "available (pass device='cpu')")
    xb = torch.as_tensor(data.astype(np.int32).reshape(-1, 1), device=dev)
    ones = torch.ones(len(data), dtype=torch.float32, device=dev)
    node = torch.zeros(len(data), dtype=torch.int32, device=dev)

    def counts(rows: slice) -> np.ndarray:
        args = (xb[rows], ones[rows], ones[rows], node[rows], 1, n_bins)
        with _LAUNCH_LOCK:
            got = hist.node_histograms_kernel(*args)[0, 0, :, 0].cpu().numpy()
            counts.n_calls += 1
            first = counts.n_calls == 1
        want = np.bincount(data[rows], minlength=n_bins)
        if not np.array_equal(got, want):
            raise AssertionError(f"node_histograms_kernel counts {got!r} != "
                                 f"np.bincount {want!r} (rows {rows})")
        if first and dev.type == "cuda":
            plain = hist.node_histograms_kernel_plain(*args)[0, 0, :, 0].cpu().numpy()
            if not np.array_equal(got, plain):
                raise AssertionError(f"node_histograms_kernel counts {got!r} != "
                                     f"node_histograms_kernel_plain {plain!r}")
        return got.astype(np.int64)

    counts.n_calls = 0
    return counts


@dataclass
class ElasticScheduleResult:
    seed: int
    world: int
    n_spares: int
    niter: int
    n_completed: int
    n_died: int
    worlds_seen: list[int]
    epochs: list[dict]
    elapsed: float
    outcome: str  # "completed" | "failed"
    schedule: str = "auto"    # the rabit_schedule value this run planned
    n_repaired: int = 0       # schedule_repaired waves committed
    dst_wait_s: float = 0.0   # slow_link runs: dst's cumulative link wait
    dst_slow_reports: int = 0
    # quorum runs
    quorum: str = ""                  # the rabit_quorum spec this run used
    straggler: tuple | None = None    # (rank, delay_s, heal_version)
    n_quorum_met: int = 0             # rounds decided with exclusions
    n_corrections_folded: int = 0
    n_corrections_dropped: int = 0    # epoch boundaries settling by drop
    #: task "0"'s mean inter-commit gap over the steady rounds (a straggler
    #: shows here under exact rounds, and must not under quorum)
    cadence_s: float = 0.0
    # relay-tier runs
    relays: int = 0                   # relay nodes interposed (0 = direct)
    n_relay_lost: int = 0             # relay channel drops the tracker saw
    n_batches_folded: int = 0         # non-empty CMD_BATCH envelopes folded
    n_spurious_expired: int = 0       # lease_expired for tasks that never
    #                                   died (must stay 0 across a bounce)
    # HA failover runs
    standby: bool = False             # a warm standby rode along
    n_failover: int = 0               # tracker_failover promotions
    n_journal_gap: int = 0            # replay divergences (must stay 0)
    primary_killed: bool = False      # the tracker_death fault landed
    #: the active tracker's HealthMonitor exposition at the schedule's end:
    #: open and recent incidents and the lifetime counters
    incidents: dict = field(default_factory=dict)
    #: contributions computed (one node_histograms_kernel call each): a run
    #: on the card launches the kernel exactly this often
    n_contributions: int = 0


def run_elastic_schedule(seed: int, world: int | None = None,
                         deadline_sec: float = 30.0,
                         quiet: bool = True,
                         schedule: str | None = None,
                         slow_link: tuple[int, int, float] | None = None,
                         repair: bool = True,
                         niter: int | None = None,
                         straggler: tuple | None = None,
                         quorum: str = "",
                         quorum_wait: float = 0.15,
                         quorum_flag_after: int = 0,
                         codec: str = "",
                         mix_faults: bool = False,
                         iter_sleep: float | None = None,
                         relays: int = 0,
                         relay_fault: FaultSpec | None = None,
                         relay_flush: float = 0.1,
                         heartbeat_sec: float = 0.15,
                         failover: FaultSpec | None = None,
                         takeover_sec: float = 0.5,
                         job: str = "",
                         device: str = "cuda") -> ElasticScheduleResult:
    """One fuzzed shrink/grow scenario (deterministic per seed), the
    counterpart of ``rabit_tpu.chaos.run_elastic_schedule``.

    A seeded mix of elastic failure shapes against the port's tracker:
    workers die silently at a sampled version and nothing relaunches them;
    hot spares park a sampled delay after launch, so promotions race
    shrinks and grow-backs race completion; a spare's warm socket dies in
    the pool, or the instant its promotion lands.  Every worker histograms
    its dense shard of one shared dataset (re-cut at every world size), so
    the rank-order int64 fold must give the exact closed-form totals.  Task
    "0" is never killed.  Raises on a hang (every socket operation is
    bounded; the deadline turns "stuck" into a failure) or a wrong bit.

    Asserts: every never-killed worker completes; every completed state is
    bitwise identical across ranks and equals the closed form (with
    ``quorum``: the closed form less exactly the contributions the
    exclusion records name as never folded in a single epoch, sandwiched
    between the two across waves; with ``codec``: close to it); every
    committed wave has dense ranks; epochs rise strictly.

    ``schedule`` pins the tracker's ``rabit_schedule`` (None samples one).
    ``slow_link=(src, dst, delay_s)`` puts a :class:`ChaosProxy` in front of
    worker dst's listen socket that delays only src's frames (src < dst),
    with ``repair`` the tracker's schedule repair; the sampled kills and
    spares are off.  ``straggler=(rank, delay_s[, heal_version])`` makes that
    rank's contribution slower up to ``heal_version``; with ``quorum`` (a
    ``rabit_quorum`` spec, with ``quorum_wait``, ``quorum_flag_after`` and
    ``codec``) the K-of-N rounds run; the sampled faults are off unless
    ``mix_faults``.  ``relays=R`` interposes R :class:`Relay` nodes (workers
    round-robin, ``relay_flush`` their cadence), ``relay_fault`` applies
    ``relay_death`` / ``relay_partition`` to relay 0, and no live task may
    see a ``lease_expired``.  ``failover=FaultSpec(tracker_death=...)`` (or
    ``standby_death``) journals the primary in memory, runs a warm
    :class:`Standby` (``takeover_sec``), gives the workers and relays both
    addresses, and applies the same no-spurious-expiry assert across the
    merged primary and standby timeline.

    ``device`` is where the contributions' histograms run (``"cuda"``, the
    default, launches ``node_histograms_kernel``; ``"cpu"`` takes its plain
    twin); asking for CUDA without a card raises.  ``job`` (the multi-job
    key) is refused: ROADMAP.md Queue 1 item 10g.
    """
    if job:
        raise NotImplementedError("run_elastic_schedule(job=) is not ported yet "
                                  "(ROADMAP.md Queue 1 item 10g)")
    from rabit_tpu_torch.elastic.client import ElasticWorker
    from rabit_tpu_torch.elastic.rebalance import shard_slice

    rng = random.Random(seed)
    world = world if world is not None else rng.choice([2, 3, 4])
    n_spares = rng.choice([0, 1, 2])
    drawn_niter = rng.choice([3, 4, 5])
    niter = int(niter) if niter is not None else drawn_niter
    drawn_sleep = rng.choice([0.05, 0.1])
    iter_sleep = float(iter_sleep) if iter_sleep is not None else drawn_sleep
    if schedule is None:
        schedule = rng.choice(["auto", "tree", "ring", "swing"])
    if slow_link is not None:
        n_spares = 0  # a clean A/B: no confounding resize traffic
    s_rank, s_delay, s_heal = -1, 0.0, 0
    if straggler is not None:
        s_rank, s_delay = int(straggler[0]), float(straggler[1])
        s_heal = int(straggler[2]) if len(straggler) > 2 else niter + 1
        if not (0 <= s_rank < world) or s_delay < 0:
            raise ValueError(f"bad straggler {straggler!r} for world {world}")
        if not mix_faults:
            n_spares = 0  # a clean quorum arm: only the compute fault
    n_rows, n_bins = 8 * world, 8
    data = np.array([rng.randrange(n_bins) for _ in range(n_rows)])
    # codec runs fold float32 (the compress contract); exact runs keep the
    # int64 bitwise closed form
    fold_dtype = np.float32 if codec else np.int64
    counts = _shard_counter(data, n_bins, device)

    def contribution(version: int, w: int, r: int) -> np.ndarray:
        time.sleep(iter_sleep)
        if r == s_rank and version <= s_heal:
            time.sleep(s_delay)  # the compute-side straggler fault
        return counts(shard_slice(n_rows, w, r)).astype(fold_dtype) * version

    def per_contribution(version: int, w: int, r: int) -> np.ndarray:
        """One rank's contribution without the fault sleeps: the exact term
        the quorum accounting subtracts for a never-folded block."""
        rows = data[shard_slice(n_rows, w, r)]
        return np.bincount(rows, minlength=n_bins).astype(fold_dtype) * version

    expected = sum(np.bincount(data, minlength=n_bins).astype(fold_dtype) * v
                   for v in range(1, niter + 1))

    n_kills = rng.randint(0, min(world - 1, 2))
    pool = [str(i) for i in range(1, world) if i != s_rank]
    victims = rng.sample(pool, min(n_kills, len(pool)))
    kill_at = {t: rng.randint(2, max(niter, 2)) for t in victims}
    if slow_link is not None or (straggler is not None and not mix_faults):
        kill_at = {}
    spare_specs = []
    for i in range(n_spares):
        roll = rng.random()
        fail = (("die_parked",) if roll < 0.15
                else ("die_promoted",) if roll < 0.3 else None)
        spare_specs.append((f"s{i}", rng.uniform(0.0, 0.8), fail))

    # shrink_after must outlast the workers' link timeout: a survivor that
    # detects a death slowly re-enters only after link_timeout, and a
    # shorter shrink deadline would close the wave without it.
    tracker_kwargs = dict(quiet=quiet, conn_timeout_sec=1.0,
                          shrink_after_sec=1.5, promote_after_sec=0.1,
                          schedule=schedule, sched_repair=repair,
                          quorum=quorum, quorum_flag_after=quorum_flag_after)
    journal = None
    standby = None
    if failover is not None:
        from rabit_tpu_torch.ha import Journal

        journal = Journal(None)  # in memory: the CMD_JOURNAL stream syncs
    tracker = Tracker(world, journal=journal, **tracker_kwargs).start()
    addr = (tracker.host, tracker.port)
    worker_addrs: list = [addr]
    if failover is not None:
        from rabit_tpu_torch.ha import Standby

        standby = Standby(primary=addr, takeover_sec=takeover_sec, poll_sec=0.05,
                          quiet=quiet, tracker_kwargs=tracker_kwargs).start()
        worker_addrs.append((standby.host, standby.port))
    # The relay tier: workers shard round-robin across R in-process relays;
    # relay 0 is the fault target.
    relay_objs: list = []
    relay_lock = threading.Lock()
    if relays > 0:
        from rabit_tpu_torch.relay import Relay

        # relays carry the whole failover list: children never re-dial
        # across a root failover, the relay channel rotates for them
        relay_objs = [Relay(worker_addrs, relay_id=f"relay{i}", flush_sec=relay_flush,
                            quiet=True).start()
                      for i in range(int(relays))]

    def task_addr(tid: str):
        if not relay_objs:
            return worker_addrs if len(worker_addrs) > 1 else addr
        try:
            idx = int(tid.lstrip("s"))
        except ValueError:
            idx = sum(tid.encode())
        with relay_lock:
            r = relay_objs[idx % len(relay_objs)]
        return (r.host, r.port)

    stop_fault = threading.Event()
    fault_threads: list[threading.Thread] = []
    if relay_objs and relay_fault is not None:
        from rabit_tpu_torch.relay import Relay

        def bounce_relay() -> None:
            at_s, down_s = relay_fault.relay_death
            if stop_fault.wait(at_s):
                return
            with relay_lock:
                old = relay_objs[0]
            port = old.port
            old.stop()
            if stop_fault.wait(down_s):
                return
            for _ in range(30):  # the freed port can lag a beat
                try:
                    fresh = Relay(addr, relay_id="relay0", port=port, flush_sec=relay_flush,
                                  quiet=True).start()
                    break
                except OSError:
                    if stop_fault.wait(0.1):
                        return
            else:
                return
            with relay_lock:
                relay_objs[0] = fresh

        def partition_relay() -> None:
            at_s, dur_s = relay_fault.relay_partition
            if stop_fault.wait(at_s):
                return
            with relay_lock:
                r0 = relay_objs[0]
            r0.set_partition(True)
            stop_fault.wait(dur_s)
            r0.set_partition(False)

        if relay_fault.relay_death is not None:
            fault_threads.append(threading.Thread(target=bounce_relay, daemon=True))
        if relay_fault.relay_partition is not None:
            fault_threads.append(threading.Thread(target=partition_relay, daemon=True))
    if failover is not None:
        # The HA faults: kill the primary (or the standby) wherever the job
        # happens to be.  Tracker.kill() drops every socket with no goodbye.
        def kill_primary() -> None:
            if stop_fault.wait(failover.tracker_death):
                return
            tracker.kill()

        def kill_standby() -> None:
            if stop_fault.wait(failover.standby_death):
                return
            standby.kill()

        if failover.tracker_death is not None:
            fault_threads.append(threading.Thread(target=kill_primary, daemon=True))
        if failover.standby_death is not None:
            fault_threads.append(threading.Thread(target=kill_standby, daemon=True))
    t0 = time.monotonic()
    results: dict[str, object] = {}
    lock = threading.Lock()

    def run_worker(w: "ElasticWorker") -> None:
        res = w.run()
        with lock:
            results[w.task_id] = res

    threads = []
    workers: list["ElasticWorker"] = []
    for i in range(world):
        tid = str(i)
        fail = ("die", kill_at[tid]) if tid in kill_at else None
        # slow-link and straggler runs need a longer link patience: a
        # degraded hop, or a recv blocked on a computing straggler, stalls
        # frames without the peer dying
        link_to = 1.0 if slow_link is None else max(1.0, 4 * slow_link[2])
        if straggler is not None:
            link_to = max(link_to, 4 * s_delay)
        w = ElasticWorker(task_addr(tid), tid, contribution, niter,
                          heartbeat_sec=heartbeat_sec, rpc_timeout=2.0,
                          wave_timeout=10.0, link_timeout=link_to,
                          deadline_sec=deadline_sec, fail=fail,
                          quorum=quorum, quorum_wait=quorum_wait, codec=codec)
        workers.append(w)
        threads.append(threading.Thread(target=run_worker, args=(w,), daemon=True))
    link_proxy: ChaosProxy | None = None
    if slow_link is not None:
        src, dst, slow_s = slow_link
        if not (0 <= src < world and 0 <= dst < world and src != dst):
            raise ValueError(f"bad slow_link {slow_link!r} for world {world}")
        if src > dst:
            # peer links are dialed by the lower rank, and only in-dials
            # cross a listen-side proxy
            raise ValueError(f"slow_link wants src < dst, got {slow_link!r}")
        link_proxy = ChaosProxy(("127.0.0.1", workers[dst].listen_port),
                                FaultSpec(slow_link=(src, float(slow_s))), seed=seed).start()
        workers[dst].advertise_port = link_proxy.port
        workers[dst].slow_report_share = 0.2

    spare_workers: list["ElasticWorker"] = []

    def run_spare(tid: str, delay: float, fail: tuple | None) -> None:
        time.sleep(delay)
        if time.monotonic() - t0 > deadline_sec:
            return
        w = ElasticWorker(task_addr(tid), tid, contribution, niter, spare=True,
                          heartbeat_sec=heartbeat_sec, rpc_timeout=2.0,
                          wave_timeout=10.0, link_timeout=1.0,
                          deadline_sec=max(deadline_sec - (time.monotonic() - t0), 1.0),
                          fail=fail, quorum=quorum, quorum_wait=quorum_wait, codec=codec)
        with lock:
            spare_workers.append(w)
        run_worker(w)

    spare_threads = [threading.Thread(target=run_spare, args=(tid, delay, fail), daemon=True)
                     for tid, delay, fail in spare_specs]
    try:
        for th in threads + spare_threads + fault_threads:
            th.start()
        for th in threads:
            th.join(timeout=deadline_sec + 10.0 - (time.monotonic() - t0))
            if th.is_alive():
                raise TimeoutError(
                    f"elastic schedule seed={seed}: worker thread hung past "
                    f"the schedule deadline ({deadline_sec}s)")
    finally:
        stop_fault.set()
        # The primaries are done (or the schedule failed): stop() releases
        # the pool, so spares never promoted leave their park.
        tracker.stop()
        if link_proxy is not None:
            link_proxy.stop()
        # the fault threads before the relays: a bounce mid-restart would
        # otherwise install a fresh relay after the stop loop ran
        for th in fault_threads:
            th.join(timeout=8.0)
        # the standby after the faults settle: a promoted one's stop() ends
        # the job's tracker too, else it ends the tail loop
        if standby is not None:
            standby.stop()
        with relay_lock:
            for r in relay_objs:
                r.stop()
        # a promoted spare mid-recovery would spin its bounded re-check-in
        # loop against the stopped tracker: stop() ends it at once
        with lock:
            for w in spare_workers:
                w.stop()
        for th in spare_threads:
            th.join(timeout=10.0)
    for th in spare_threads:
        if th.is_alive():
            raise TimeoutError(f"elastic schedule seed={seed}: spare thread hung after "
                               f"tracker stop")

    # HA runs: the job's timeline spans both trackers (the primary's events
    # up to its death, the promoted standby's from the takeover).
    promoted_tracker = (standby.tracker
                        if standby is not None and standby.promoted.is_set() else None)
    all_events = list(tracker.events)
    if promoted_tracker is not None:
        all_events += list(promoted_tracker.events)
    elif standby is not None:
        all_events += list(standby.events)
    active_tracker = promoted_tracker if promoted_tracker is not None else tracker
    completed = [r for r in results.values() if r.completed]
    died = [r for r in results.values() if r.died]
    # convergence: every never-killed primary completes with the exact
    # closed-form totals, whichever world sizes it passed through
    for i in range(world):
        tid = str(i)
        if tid in kill_at:
            continue
        res = results.get(tid)
        if res is None or not res.completed:
            raise AssertionError(
                f"seed={seed}: surviving worker {tid} did not complete: "
                f"{getattr(res, 'error', 'no result')!r}")
    for res in completed:
        if res.final_version != niter:
            raise AssertionError(
                f"seed={seed}: task {res.task_id} completed at version "
                f"{res.final_version}, wanted {niter}")
    # cross-rank determinism: every completed worker has the same bits
    ref = completed[0].state if completed else None
    for res in completed[1:]:
        if not np.array_equal(res.state, ref):
            raise AssertionError(
                f"seed={seed}: task {res.task_id} state diverges bitwise "
                f"from task {completed[0].task_id}")
    # value correctness against the closed form
    qm = [e for e in all_events if e["kind"] == "quorum_met"]
    folded = {(e["src_version"], e["rank"])
              for e in all_events if e["kind"] == "correction_folded"}
    missing = {(e["version"], r, e["world"]) for e in qm for r in e["excluded"]}
    missing = {(sv, r, w) for (sv, r, w) in missing if (sv, r) not in folded}
    n_epochs = len(active_tracker.elastic.history)
    if ref is not None:
        if not quorum:
            if not np.array_equal(ref, expected):
                raise AssertionError(f"seed={seed}: state {ref!r} != expected {expected!r}")
        elif codec:
            # a lossy wire: the bitwise contract is cross-rank identity; the
            # value must be close to the quorum-adjusted closed form
            adjusted = expected.copy()
            for sv, r, w in missing:
                adjusted = adjusted - per_contribution(sv, w, r)
            tol = 0.05 * float(np.max(np.abs(expected))) + 1.0
            if n_epochs <= 1:
                close = np.allclose(ref, adjusted, atol=tol)
            else:
                close = bool(np.all(ref <= expected + tol) and np.all(ref >= adjusted - tol))
            if not close:
                raise AssertionError(f"seed={seed}: codec state {ref!r} too far from "
                                     f"quorum-adjusted {adjusted!r} (tol {tol})")
        elif n_epochs <= 1:
            # one epoch: the exclusion records account exactly for every
            # never-folded contribution
            adjusted = expected.copy()
            for sv, r, w in missing:
                adjusted = adjusted - per_contribution(sv, w, r)
            if not np.array_equal(ref, adjusted):
                raise AssertionError(f"seed={seed}: state {ref!r} != quorum-adjusted "
                                     f"{adjusted!r} (missing {sorted(missing)})")
        else:
            # recovery waves redo rounds, so a record of an aborted epoch
            # may name a round that then folded fully: sandwich instead
            # (contributions are non-negative, nothing folds twice)
            floor = expected.copy()
            for sv, r, w in missing:
                floor = floor - per_contribution(sv, w, r)
            if not (np.all(ref <= expected) and np.all(ref >= floor)):
                raise AssertionError(f"seed={seed}: state {ref!r} outside "
                                     f"[{floor!r}, {expected!r}]")
    # membership sanity on the committed timeline
    waves = [e for e in all_events if e["kind"] == "wave"]
    epochs = [e["epoch"] for e in waves]
    if epochs != sorted(set(epochs)):
        raise AssertionError(f"seed={seed}: epochs not strictly increasing: {epochs}")
    for e in waves:
        ranks = sorted(e["assignments"].values())
        if ranks != list(range(e["world"])):
            raise AssertionError(f"seed={seed}: wave epoch {e['epoch']} ranks {ranks} not "
                                 f"dense for world {e['world']}")
    worlds_seen = sorted({e["world"] for e in waves})
    # relays and failover: a relay bounce or a tracker death is no
    # membership event, so no task that stayed alive may see its lease
    # expire
    died_tasks = {tid for tid, r in results.items() if getattr(r, "died", False)}
    expired_tasks = {e.get("task_id") for e in all_events if e["kind"] == "lease_expired"}
    spurious = expired_tasks - died_tasks - set(kill_at)
    if (relays or failover is not None) and spurious:
        raise AssertionError(
            f"seed={seed}: spurious lease_expired for live tasks {sorted(spurious)} (a relay "
            f"bounce or tracker failover must not kill children)")
    dst_res = results.get(str(slow_link[1])) if slow_link is not None else None
    cadence = 0.0
    ct = getattr(results.get("0"), "commit_times", None) or {}
    if niter >= 3 and 1 in ct and (niter - 1) in ct:
        cadence = (ct[niter - 1] - ct[1]) / (niter - 2)
    return ElasticScheduleResult(
        seed=seed, world=world, n_spares=n_spares, niter=niter,
        n_completed=len(completed), n_died=len(died),
        worlds_seen=worlds_seen,
        epochs=[{"epoch": we.epoch, "world": we.world_size}
                for we in active_tracker.elastic.history],
        elapsed=time.monotonic() - t0,
        outcome="completed",
        schedule=schedule,
        n_repaired=sum(1 for e in all_events if e["kind"] == "schedule_repaired"),
        dst_wait_s=getattr(dst_res, "wait_prev_s", 0.0),
        dst_slow_reports=getattr(dst_res, "slow_reports", 0),
        quorum=quorum,
        straggler=(s_rank, s_delay, s_heal) if straggler is not None else None,
        n_quorum_met=len(qm),
        n_corrections_folded=sum(1 for e in all_events if e["kind"] == "correction_folded"),
        n_corrections_dropped=sum(1 for e in all_events if e["kind"] == "correction_dropped"),
        cadence_s=round(cadence, 6),
        relays=int(relays),
        n_relay_lost=sum(1 for e in all_events if e["kind"] == "relay_lost"),
        n_batches_folded=sum(1 for e in all_events if e["kind"] == "batch_folded"),
        n_spurious_expired=len(spurious),
        standby=standby is not None,
        n_failover=sum(1 for e in all_events if e["kind"] == "tracker_failover"),
        n_journal_gap=sum(1 for e in all_events if e["kind"] == "journal_gap"),
        primary_killed=bool(getattr(tracker, "_killed", False)),
        incidents=active_tracker._health.render(),
        n_contributions=counts.n_calls,
    )
