"""Streamed metric deltas and the tracker's live rollup.

The port's own copy of the delta half of ``rabit_tpu/obs/stream.py``:
workers diff successive registry states into bounded windows
(:class:`DeltaSource`) that ride every ``CMD_METRICS`` snapshot as its
``delta``; the tracker strips the window at ingest and folds it into a
per-rank and job-wide rollup (:class:`StreamRollup`, telemetry.json's
``stream``).  Counters sum and histogram buckets add (:func:`merge_state`),
so the fold of every window equals the cumulative counters.

Streamed metric names are declared in :data:`STREAM_METRICS`, and
:func:`stream_count` / :func:`stream_observe` refuse any other name: a
typo'd producer would silently starve every consumer (the tracker's fold,
the diagnosis plane, ``top``).  ``rabit_tpu`` holds its producers to the
same table with a static lint; the port checks at the call.

Labeled series are flat registry names, ``wire_bytes{codec=i8,fused=1}``
(:func:`series_name`).  :func:`delta_doc` / :func:`merge_delta_doc` are the
per-job delta envelope a relay coalesces (the relays themselves are not
ported); :func:`wire_bytes_by_codec` reads the codec split out of a
rendered rollup, as the ``CMD_OBS`` scrape's readers do.
"""

from __future__ import annotations

import math
import threading

from rabit_tpu_torch.obs.metrics import GLOBAL_REGISTRY, MetricsRegistry

#: Version stamp of the delta documents, the rollups and the scrape.
STREAM_SCHEMA = 1

#: Every metric name the delta stream carries, with its producer and
#: meaning (``rabit_tpu``'s table; the delivery plane's names are kept so
#: that either package's producers and readers agree).
STREAM_METRICS: dict[str, str] = {
    "wire_bytes": "post-codec bytes put on the wire, labeled "
                  "codec=<name>,fused=<0|1> (compress/transport.observe; "
                  "the per-tenant accounting the QoS loop meters)",
    "raw_bytes": "pre-codec payload bytes for the same events, same "
                 "labels — wire_bytes/raw_bytes is the live ratio",
    "link_wait_seconds": "per-planned-link receive wait, labeled "
                         "src=<rank>,dst=<rank> (ElasticWorker ring "
                         "timers; the route-around loop's health signal)",
    "delivery_bytes_served": "snapshot bytes the tracker served over "
                             "CMD_SNAP, labeled job=<job>,digest=<hex>",
    "delivery_subscribers": "distinct subscriber task ids seen on the "
                            "CMD_SUB poll path, labeled job=<job>",
    "delivery_cache_hits": "relay-local CMD_SNAP fetches answered from "
                           "the digest cache, labeled relay=<id>",
    "delivery_cache_misses": "CMD_SNAP fetches the relay had to proxy "
                             "upstream, labeled relay=<id>",
}


def series_name(name: str, **labels) -> str:
    """The flat registry name of one labeled series:
    ``name{k1=v1,k2=v2}`` with keys sorted (no labels: the bare name)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def parse_series(series: str) -> tuple[str, dict[str, str]]:
    """Split one flat series name back into ``(base, labels)``."""
    if not series.endswith("}") or "{" not in series:
        return series, {}
    base, _, inner = series[:-1].partition("{")
    labels: dict[str, str] = {}
    for part in inner.split(","):
        k, sep, v = part.partition("=")
        if sep:
            labels[k] = v
    return base, labels


def _declared(name: str) -> None:
    if name not in STREAM_METRICS:
        raise KeyError(f"streamed metric {name!r} is not declared in STREAM_METRICS")


def stream_count(name: str, n: int, registry: MetricsRegistry | None = None,
                 **labels) -> None:
    """Count ``n`` into the streamed counter ``name`` (declared in
    :data:`STREAM_METRICS`) under the given labels.  Writes into the
    process registry, so the cumulative value also rides every snapshot:
    the delta stream is a view of the registry, not a fork."""
    _declared(name)
    reg = registry if registry is not None else GLOBAL_REGISTRY
    reg.counter(series_name(name, **labels)).inc(int(n))


def stream_observe(name: str, value: float,
                   registry: MetricsRegistry | None = None,
                   **labels) -> None:
    """Observe ``value`` into the streamed histogram ``name`` (declared in
    :data:`STREAM_METRICS`) under the given labels."""
    _declared(name)
    reg = registry if registry is not None else GLOBAL_REGISTRY
    reg.histogram(series_name(name, **labels)).observe(float(value))


# -- delta math --------------------------------------------------------------
#
# A "state" is MetricsRegistry.raw_state() shape: {"counters": {name: int},
# "histograms": {name: {"bounds", "counts", "count", "sum", "min", "max"}}}.
# A delta is the same shape holding window differences (min/max stay
# cumulative — they are monotone, so idempotent re-folds are harmless).

def empty_state() -> dict:
    return {"counters": {}, "histograms": {}}


def _hist_delta(cur: dict, prev: dict | None) -> dict | None:
    if prev is None:
        d_counts = list(cur["counts"])
        d_count = int(cur["count"])
        d_sum = float(cur["sum"])
    else:
        pc = prev["counts"]
        d_counts = [int(c) - int(pc[i]) if i < len(pc) else int(c)
                    for i, c in enumerate(cur["counts"])]
        d_count = int(cur["count"]) - int(prev["count"])
        d_sum = float(cur["sum"]) - float(prev["sum"])
    if d_count <= 0:
        return None
    return {"bounds": list(cur["bounds"]), "counts": d_counts,
            "count": d_count, "sum": d_sum,
            "min": cur.get("min"), "max": cur.get("max")}


def diff_state(cur: dict, prev: dict | None) -> dict | None:
    """The bounded delta taking ``prev`` to ``cur`` (both raw states), or
    None when nothing changed.  Counters that did not move are omitted —
    the frame size is proportional to the window's activity, not the
    metric vocabulary."""
    prev = prev or empty_state()
    delta = empty_state()
    for name, value in cur.get("counters", {}).items():
        d = int(value) - int(prev.get("counters", {}).get(name, 0))
        if d:
            delta["counters"][name] = d
    for name, hist in cur.get("histograms", {}).items():
        d = _hist_delta(hist, prev.get("histograms", {}).get(name))
        if d is not None:
            delta["histograms"][name] = d
    if not delta["counters"] and not delta["histograms"]:
        return None
    return delta


def merge_state(acc: dict, delta: dict) -> dict:
    """Fold ``delta`` into ``acc`` IN PLACE (and return it): counters
    sum; histogram buckets add elementwise (count/sum likewise), min/max
    fold monotonically: the tracker's rollup step."""
    for name, d in delta.get("counters", {}).items():
        acc["counters"][name] = acc["counters"].get(name, 0) + int(d)
    for name, dh in delta.get("histograms", {}).items():
        ah = acc["histograms"].get(name)
        if ah is None:
            acc["histograms"][name] = {
                "bounds": list(dh.get("bounds", [])),
                "counts": list(dh.get("counts", [])),
                "count": int(dh.get("count", 0)),
                "sum": float(dh.get("sum", 0.0)),
                "min": dh.get("min"), "max": dh.get("max"),
            }
            continue
        dc = dh.get("counts", [])
        if len(ah["counts"]) == len(dc):
            ah["counts"] = [a + int(b) for a, b in zip(ah["counts"], dc)]
        ah["count"] += int(dh.get("count", 0))
        ah["sum"] += float(dh.get("sum", 0.0))
        for key, fold in (("min", min), ("max", max)):
            v = dh.get(key)
            if v is not None:
                ah[key] = v if ah.get(key) is None else fold(ah[key], v)
    return acc


def summarize_histogram(h: dict) -> dict:
    """Percentile summary of one merged raw histogram (the rollup's
    rendering: the fields of ``Histogram.snapshot``)."""
    count = int(h.get("count", 0))
    if count <= 0:
        return {"count": 0, "sum": 0.0}
    bounds, counts = h.get("bounds", []), h.get("counts", [])
    vmin = h.get("min")
    vmax = h.get("max")

    def pctl(p: float) -> float:
        target = max(1, math.ceil(p / 100.0 * count))
        cum = 0
        for i, c in enumerate(counts):
            cum += int(c)
            if cum >= target:
                bound = bounds[i] if i < len(bounds) else (vmax or 0.0)
                lo = vmin if vmin is not None else bound
                hi = vmax if vmax is not None else bound
                return min(max(bound, lo), hi)
        return vmax if vmax is not None else 0.0

    out = {"count": count, "sum": round(float(h.get("sum", 0.0)), 9)}
    if vmin is not None:
        out["min"] = round(float(vmin), 9)
    if vmax is not None:
        out["max"] = round(float(vmax), 9)
    if counts:
        out.update(p50=round(pctl(50), 9), p90=round(pctl(90), 9),
                   p99=round(pctl(99), 9))
    return out


# -- worker side: delta extraction -------------------------------------------

class DeltaSource:
    """Extracts successive bounded deltas from one registry.  ``take()``
    diffs the current raw state against the last taken baseline and
    advances it — each activity window is emitted exactly once, so the
    tracker-side fold of every delta equals the cumulative counters (the
    byte-for-byte reconciliation bar against telemetry.json)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self._registry = registry if registry is not None else GLOBAL_REGISTRY
        self._lock = threading.Lock()
        self._baseline: dict | None = None

    def take(self) -> dict | None:
        """The delta since the previous ``take`` (None when idle)."""
        cur = self._registry.raw_state()
        with self._lock:
            delta = diff_state(cur, self._baseline)
            if delta is not None:
                self._baseline = cur
        return delta


def delta_doc(job: str, rank: int, delta: dict) -> dict:
    """One rank's delta in the wire envelope a relay batch carries: schema
    stamp, job key, and a per-rank section map (a relay merges several
    workers' docs into one per-job doc by merging the ``ranks`` maps)."""
    return {"schema": STREAM_SCHEMA, "job": job, "ranks": {str(rank): delta}}


def merge_delta_doc(acc: dict | None, doc: dict) -> dict:
    """Coalesce one delta doc into a per-job accumulator doc: same-rank
    sections fold with :func:`merge_state`."""
    if acc is None:
        acc = {"schema": STREAM_SCHEMA, "job": doc.get("job", ""), "ranks": {}}
    for rank, delta in doc.get("ranks", {}).items():
        held = acc["ranks"].get(rank)
        if held is None:
            acc["ranks"][rank] = merge_state(empty_state(), delta)
        else:
            merge_state(held, delta)
    return acc


# -- tracker side: live rollups ----------------------------------------------

class StreamRollup:
    """Per-job fold target of every streamed delta: per-rank accumulated
    states plus the job total, all under one lock; pure dict math."""

    def __init__(self):
        self._lock = threading.Lock()
        self._per_rank: dict[str, dict] = {}
        self._total = empty_state()
        self.n_folds = 0
        self.last_fold_ts = 0.0

    def fold(self, rank: int | str, delta: dict, ts: float = 0.0) -> None:
        rank = str(rank)
        with self._lock:
            held = self._per_rank.get(rank)
            if held is None:
                self._per_rank[rank] = merge_state(empty_state(), delta)
            else:
                merge_state(held, delta)
            merge_state(self._total, delta)
            self.n_folds += 1
            if ts:
                self.last_fold_ts = ts

    def render(self) -> dict:
        """The JSON rollup a scrape and telemetry.json embed: cumulative
        counters verbatim (reconcilable against the snapshots), histograms as
        percentile summaries, plus the per-link health table parsed out
        of the ``link_wait_seconds`` series labels."""
        with self._lock:
            per_rank = {r: _render_state(s)
                        for r, s in sorted(self._per_rank.items())}
            total = _render_state(self._total)
            links = _render_links(self._total)
            n_folds, last_ts = self.n_folds, self.last_fold_ts
        return {"schema": STREAM_SCHEMA, "n_folds": n_folds,
                "last_fold_ts": round(last_ts, 6), "total": total,
                "links": links, "per_rank": per_rank}


def _render_state(state: dict) -> dict:
    return {
        "counters": dict(sorted(state["counters"].items())),
        "histograms": {name: summarize_histogram(h)
                       for name, h in sorted(state["histograms"].items())},
    }


def _render_links(state: dict) -> list[dict]:
    """The per-planned-link wait table: one row per
    ``link_wait_seconds{src=...,dst=...}`` series in the rollup."""
    rows = []
    for name, h in sorted(state["histograms"].items()):
        base, labels = parse_series(name)
        if base != "link_wait_seconds" or "src" not in labels:
            continue
        row = {"src": labels.get("src", "?"), "dst": labels.get("dst", "?")}
        row.update(summarize_histogram(h))
        rows.append(row)
    return rows


def wire_bytes_by_codec(rendered: dict) -> dict[str, int]:
    """``{codec[:fused] -> wire bytes}`` from one rendered state's counters
    (``fused=1`` series render as ``<codec>:fused``)."""
    out: dict[str, int] = {}
    for name, value in rendered.get("counters", {}).items():
        base, labels = parse_series(name)
        if base != "wire_bytes":
            continue
        key = labels.get("codec", "?")
        if labels.get("fused") in ("1", "True", "true"):
            key += ":fused"
        out[key] = out.get(key, 0) + int(value)
    return out
