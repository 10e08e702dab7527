"""Metrics registry: counters, gauges, latency histograms, per-op stats.

The port's own copy of ``rabit_tpu/obs/metrics.py`` (the port imports
nothing of the JAX package): the same names, the same ``DEFAULT_BUCKETS``
and percentile rule, and the same ``snapshot()`` document, so a snapshot
the port ships is read by either package's tracker.  ``profile``'s
``CollectiveStats`` is a facade over a registry.

Everything is thread-safe: the native engine calls back from its own
threads, and the heartbeat shipper snapshots while collectives run.
"""

from __future__ import annotations

import contextlib
import math
import threading
import time
from bisect import bisect_left
from dataclasses import dataclass


@dataclass
class OpStats:
    """Per-operation accumulated timing — the Python-layer analogue of the
    mock engine's tsum_allreduce/tsum_allgather counters."""

    calls: int = 0
    nbytes: int = 0
    seconds: float = 0.0
    max_seconds: float = 0.0

    def add(self, nbytes: int, seconds: float) -> None:
        self.calls += 1
        self.nbytes += nbytes
        self.seconds += seconds
        self.max_seconds = max(self.max_seconds, seconds)


class Counter:
    """Monotonic counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


#: Default latency buckets: geometric, 1 µs .. ~67 s (factor 2, 27 bounds)
#: plus an implicit overflow bucket.  Fine enough that a bucket-upper-bound
#: percentile is within 2x of the true value across the whole range.
DEFAULT_BUCKETS: tuple[float, ...] = tuple(1e-6 * 2 ** i for i in range(27))


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    ``observe`` counts into the first bucket whose upper bound >= value
    (an implicit +inf overflow bucket catches the rest); ``percentile``
    returns the upper bound of the bucket holding the p-th observation,
    clamped into [min, max] of what was actually observed — deterministic
    and cheap, precise to one bucket width.
    """

    def __init__(self, buckets: tuple[float, ...] | list[float] | None = None):
        bounds = tuple(buckets) if buckets else DEFAULT_BUCKETS
        if list(bounds) != sorted(bounds):
            raise ValueError("histogram buckets must be sorted ascending")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: overflow
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        idx = bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += value
            self.vmin = min(self.vmin, value)
            self.vmax = max(self.vmax, value)

    def percentile(self, p: float) -> float:
        """p in [0, 100]."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = max(1, math.ceil(p / 100.0 * self.count))
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= target:
                    bound = (self._bounds[i] if i < len(self._bounds)
                             else self.vmax)
                    return min(max(bound, self.vmin), self.vmax)
            return self.vmax  # unreachable (cum == count >= target)

    def snapshot(self) -> dict:
        with self._lock:
            if self.count == 0:
                return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": round(self.total, 9),
            "min": round(self.vmin, 9),
            "max": round(self.vmax, 9),
            "p50": round(self.percentile(50), 9),
            "p90": round(self.percentile(90), 9),
            "p99": round(self.percentile(99), 9),
        }

    def raw(self) -> dict:
        """Mergeable full state (raw bucket counts, not percentile
        summaries): what the delta stream subtracts and re-adds
        (``obs.stream``).  ``bounds`` ride
        along so a receiver can merge histograms it never constructed."""
        with self._lock:
            return {
                "bounds": list(self._bounds),
                "counts": list(self._counts),
                "count": self.count,
                "sum": self.total,
                "min": self.vmin if self.count else None,
                "max": self.vmax if self.count else None,
            }


class _Span:
    """Mutable handle yielded by ``MetricsRegistry.timed`` so callers whose
    byte count is only known after the operation (object broadcast: the
    non-root learns the payload length from the wire) can set it before the
    window closes."""

    __slots__ = ("op", "nbytes", "cache_key")

    def __init__(self, op: str, nbytes: int, cache_key: str | None = None):
        self.op = op
        self.nbytes = nbytes
        self.cache_key = cache_key


class MetricsRegistry:
    """Named counters/gauges/histograms plus per-op collective stats, all
    under one re-entrant lock.  Metric names are flat strings; per-op
    latency histograms are auto-named ``{op}_latency_seconds``."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._ops: dict[str, OpStats] = {}

    # -- metric handles (create-or-get) -----------------------------------

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str,
                  buckets: tuple[float, ...] | None = None) -> Histogram:
        with self._lock:
            hist = self._histograms.get(name)
            if hist is None:
                hist = self._histograms[name] = Histogram(buckets)
            return hist

    # -- collective timing -------------------------------------------------

    @property
    def ops(self) -> dict[str, OpStats]:
        """Live per-op aggregates.  Read-mostly; mutate via ``timed`` /
        ``observe_op`` so updates stay under the registry lock."""
        with self._lock:
            return self._ops

    def observe_op(self, op: str, nbytes: int, seconds: float) -> None:
        with self._lock:
            self._ops.setdefault(op, OpStats()).add(nbytes, seconds)
        self.histogram(f"{op}_latency_seconds").observe(seconds)

    @contextlib.contextmanager
    def timed(self, op: str, nbytes: int, cache_key: str | None = None):
        """Time one collective into the per-op stats + latency histogram.
        Yields a span whose ``nbytes`` may be updated inside the window."""
        span = _Span(op, nbytes, cache_key)
        t0 = time.perf_counter()
        try:
            yield span
        finally:
            self.observe_op(op, span.nbytes, time.perf_counter() - t0)

    # -- lifecycle / output ------------------------------------------------

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._ops.clear()

    def report(self) -> str:
        """One line per op: count, volume, mean/max latency, bandwidth —
        the historical CollectiveStats.report format, plus p50/p99 from the
        latency histogram."""
        with self._lock:
            ops = {k: OpStats(v.calls, v.nbytes, v.seconds, v.max_seconds)
                   for k, v in self._ops.items()}
            hists = dict(self._histograms)
        lines = []
        for op in sorted(ops):
            s = ops[op]
            mean_ms = 1e3 * s.seconds / max(s.calls, 1)
            bw = s.nbytes / s.seconds / 2**20 if s.seconds > 0 else 0.0
            line = (
                f"{op}: {s.calls} calls, {s.nbytes / 2**20:.2f} MiB, "
                f"mean {mean_ms:.3f} ms, max {1e3 * s.max_seconds:.3f} ms, "
                f"{bw:.1f} MiB/s"
            )
            hist = hists.get(f"{op}_latency_seconds")
            if hist is not None and hist.count:
                line += (f", p50 {1e3 * hist.percentile(50):.3f} ms, "
                         f"p99 {1e3 * hist.percentile(99):.3f} ms")
            lines.append(line)
        return "\n".join(lines) if lines else "(no collectives recorded)"

    def raw_state(self) -> dict:
        """Mergeable counter/histogram state for the delta stream
        (``obs.stream``): raw bucket counts instead of the
        percentile summaries :meth:`snapshot` emits, so two states can be
        subtracted into a bounded delta and deltas re-summed losslessly."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            hists = {k: h.raw() for k, h in self._histograms.items()}
        return {"counters": counters, "histograms": hists}

    def snapshot(self) -> dict:
        """JSON-able full state — what workers ship to the tracker."""
        with self._lock:
            counters = {k: c.value for k, c in self._counters.items()}
            gauges = {k: g.value for k, g in self._gauges.items()}
            hists = {k: h.snapshot() for k, h in self._histograms.items()}
            ops = {
                k: {"calls": v.calls, "nbytes": v.nbytes,
                    "seconds": round(v.seconds, 9),
                    "max_seconds": round(v.max_seconds, 9)}
                for k, v in self._ops.items()
            }
        return {"counters": counters, "gauges": gauges,
                "histograms": hists, "ops": ops}


#: Process-wide registry (``api`` times every collective into it).
GLOBAL_REGISTRY = MetricsRegistry()
