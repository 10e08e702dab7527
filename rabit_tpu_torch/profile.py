"""Device traces of the port's rounds.

The port's counterpart of ``rabit_tpu/profile.py`` ``xla_trace``:
:func:`device_trace` records ``torch.profiler`` activity (the host's ops
and, on a card, its kernels, copies and fills) and writes a Chrome trace
under ``logdir`` that TensorBoard and Perfetto open.  :func:`split` reads
where the device time of a window went: the port's own kernels by name,
every other kernel by the top aten op that launched it, and the time the
device sat idle.

``CollectiveStats`` is the per-collective view (calls, bytes, latency and
its percentiles) over a metrics registry (``obs.metrics``);
``GLOBAL_STATS`` reads the process registry that ``api`` times every
collective into.
"""

from __future__ import annotations

import contextlib
import os
import re

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from rabit_tpu_torch.config import Config
from rabit_tpu_torch.obs.metrics import GLOBAL_REGISTRY, MetricsRegistry, OpStats



class CollectiveStats:
    """Per-operation accumulated timing, a facade over a thread-safe
    :class:`~rabit_tpu_torch.obs.metrics.MetricsRegistry`.  A bare
    ``CollectiveStats()`` gets a private registry; ``GLOBAL_STATS`` shares
    the process registry."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self._registry = registry if registry is not None else MetricsRegistry()

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    @property
    def ops(self) -> dict[str, OpStats]:
        return self._registry.ops

    def timed(self, op: str, nbytes: int):
        """Context manager timing one collective into the per-op stats and
        its latency histogram."""
        return self._registry.timed(op, nbytes)

    def reset(self) -> None:
        self._registry.reset()

    def report(self) -> str:
        """One line per op: count, volume, mean and max latency, bandwidth,
        and latency percentiles."""
        return self._registry.report()


#: The process-wide view ``api`` times into.
GLOBAL_STATS = CollectiveStats(registry=GLOBAL_REGISTRY)


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """Trace the block: yields the ``torch.profiler.profile``, and writes
    its Chrome trace (``*.pt.trace.json``) under ``logdir`` when the block
    ends.  ``device`` (default: ``rabit_torch_device``, ``cuda`` unless
    configured) is where the traced work runs: ``cuda`` records the host
    and the card, and raises without a card; ``cpu`` records the host
    alone."""
    dev = torch.device(device or Config().torch_device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_trace on cuda but no CUDA device is "
                               "available; pass device='cpu' to trace the host")
        activities.append(ProfilerActivity.CUDA)
    elif dev.type != "cpu":
        raise ValueError(f"device_trace on {dev}: the port runs on cpu and cuda")
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _merged_ms(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) spans (us), in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def split(events, port_kernels, window: str | None = None) -> dict:
    """Where the device time of a trace went.

    ``events`` are a profile's ``events()``; ``port_kernels`` the names of
    the port's own kernels (a device kernel counts as the port's when its
    name holds one of them as a word; ``_build.kernel_names()``).
    ``window`` names a host span (``torch.profiler.record_function``) whose
    extent bounds the reading; None: from the first to the last event.
    Returns, in ms: ``window_ms``; ``port_ms`` by kernel name; ``other_ms``
    by the top op (below the window's span) whose subtree launched each
    other kernel, copy or fill (the profiler lists them under the op that
    launched them), and under ``"(no op)"`` what no op launched; ``busy_ms``,
    the union of every device interval; ``idle_ms = window_ms - busy_ms``;
    and ``launches``, the count of device kernels, copies and fills.  Under
    the profiler the host runs slower, so ``window_ms`` and ``idle_ms`` are
    those of the traced run; the device times are not."""
    events = list(events)
    host = [e for e in events if e.device_type.name == "CPU"]
    # a host span (record_function) is also drawn on the device's timeline
    # under its own name, over the kernels it launched: not device work
    spans = {e.name for e in host}
    device = [e for e in events if e.device_type.name == "CUDA" and e.name not in spans]
    if window is not None:
        spans = [e.time_range for e in host if e.name == window]
        if not spans:
            raise ValueError(f"no host span named {window!r} in the trace")
        lo, hi = min(s.start for s in spans), max(s.end for s in spans)
    else:
        lo = min((e.time_range.start for e in events), default=0.0)
        hi = max((e.time_range.end for e in events), default=0.0)
    def port_name(name: str) -> str | None:
        return next((p for p in port_kernels if re.search(rf"\b{re.escape(p)}\b", name)),
                    None)

    port_ms: dict[str, float] = {}
    busy, other_total = [], 0.0
    for k in device:
        a, b = max(k.time_range.start, lo), min(k.time_range.end, hi)
        if b <= a:
            continue
        busy.append((a, b))
        mine = port_name(k.name)
        if mine:
            port_ms[mine] = port_ms.get(mine, 0.0) + (b - a) / 1e3
        else:
            other_total += (b - a) / 1e3
    other_ms: dict[str, float] = {}
    for op in host:
        if (not getattr(op, "kernels", None) or not lo <= op.time_range.start < hi
                or re.match(r"cu[A-Z]|cuda[A-Z]", op.name)):
            continue  # a runtime call's kernels are its op's (or no op's)
        top = op
        while top.cpu_parent is not None and top.cpu_parent.name != window:
            top = top.cpu_parent
        for k in op.kernels:
            if port_name(k.name) is None:
                other_ms[top.name] = other_ms.get(top.name, 0.0) + k.duration / 1e3
    rest = other_total - sum(other_ms.values())
    if rest > 1e-6:
        other_ms["(no op)"] = rest
    window_ms = (hi - lo) / 1e3
    busy_ms = _merged_ms(busy)
    return {"window_ms": window_ms, "port_ms": port_ms, "other_ms": other_ms,
            "busy_ms": busy_ms, "idle_ms": window_ms - busy_ms,
            "launches": len(busy)}
