"""The port's topology-aware rank assignment: the counterpart of
tests/test_topology.py, with the same asserts against
``rabit_tpu_torch.tracker.tracker``, and a seeded property test that the
port's ``assign_ranks`` equals ``rabit_tpu``'s for random waves, previous
ranks and host orders.  ``assign_ranks`` groups new workers by host so the
ring (rank +- 1) crosses hosts as rarely as possible; ``host_order`` (given,
or ``tpu_slice_host_order`` from ``TPU_WORKER_HOSTNAMES``) orders the host
groups."""

from __future__ import annotations

import numpy as np
import pytest

from rabit_tpu.tracker.tracker import assign_ranks as jax_assign_ranks
from rabit_tpu_torch.tracker.tracker import Tracker, assign_ranks, tpu_slice_host_order


def ring_cross_host_edges(ranks: dict[str, int], hosts: dict[str, str]) -> int:
    n = len(ranks)
    by_rank = {r: hosts[t] for t, r in ranks.items()}
    return sum(1 for r in range(n) if by_rank[r] != by_rank[(r + 1) % n])


def test_host_grouping_minimizes_ring_crossings():
    # check-in order interleaves two hosts; grouped assignment must give
    # each host a contiguous rank block => exactly 2 cross-host ring edges.
    wave = [("w0", "hostB"), ("w1", "hostA"), ("w2", "hostB"), ("w3", "hostA")]
    ranks = assign_ranks(wave, 4, {})
    hosts = dict(wave)
    assert ring_cross_host_edges(ranks, hosts) == 2
    # within a host, ranks are contiguous
    ra = sorted(r for t, r in ranks.items() if hosts[t] == "hostA")
    rb = sorted(r for t, r in ranks.items() if hosts[t] == "hostB")
    assert ra == list(range(ra[0], ra[0] + 2))
    assert rb == list(range(rb[0], rb[0] + 2))


def test_stale_rank_collision_resolves():
    # wave1 {a,b}->{0,1}; b died and c inherited rank 1; now a is gone and
    # b rejoins: prev_ranks holds rank 1 for BOTH b and c.  One keeps it,
    # the other gets the free slot — never a duplicate assignment.
    prev = {"a": 0, "b": 1, "c": 1}
    ranks = assign_ranks([("b", "h"), ("c", "h")], 2, prev)
    assert sorted(ranks.values()) == [0, 1]
    assert ranks["b"] == 1  # first in wave wins its old rank


def test_stable_readmission_beats_grouping():
    wave = [("a", "h1"), ("b", "h2"), ("c", "h1")]
    prev = {"b": 0}
    ranks = assign_ranks(wave, 3, prev)
    assert ranks["b"] == 0  # re-admitted worker keeps its rank
    assert sorted(ranks.values()) == [0, 1, 2]


def test_launcher_numbered_ids_keep_their_rank():
    wave = [("1", "h1"), ("0", "h2"), ("2", "h1")]
    ranks = assign_ranks(wave, 3, {})
    assert ranks == {"0": 0, "1": 1, "2": 2}


def test_host_order_ranks_slice_neighbors_first():
    # physical slice order says hostZ comes before hostA: hostZ's workers
    # must get the lower (earlier-in-ring) ranks despite name/check-in order.
    wave = [("wa", "hostA"), ("wz", "hostZ"), ("wa2", "hostA"), ("wz2", "hostZ")]
    ranks = assign_ranks(wave, 4, {}, host_order=["hostZ", "hostA"])
    assert {ranks["wz"], ranks["wz2"]} == {0, 1}
    assert {ranks["wa"], ranks["wa2"]} == {2, 3}


def test_tpu_slice_host_order_env(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "t1k-0, t1k-1 ,t1k-2")
    assert tpu_slice_host_order() == ["t1k-0", "t1k-1", "t1k-2"]
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES")
    assert tpu_slice_host_order() is None


def test_tracker_tpu_mode(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "h0,h1")
    t = Tracker(world_size=2, quiet=True, topology="tpu")
    assert t.host_order == ["h0", "h1"]
    t.stop()
    monkeypatch.delenv("TPU_WORKER_HOSTNAMES")
    try:
        Tracker(world_size=2, quiet=True, topology="tpu")
        raise AssertionError("topology='tpu' without metadata must raise")
    except RuntimeError:
        pass


def test_tracker_host_order_wins_over_env(monkeypatch):
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "h0,h1")
    t = Tracker(world_size=2, quiet=True, topology="auto", host_order=["x", "y"])
    assert t.host_order == ["x", "y"]
    t.stop()
    t = Tracker(world_size=2, quiet=True, topology="auto")
    assert t.host_order == ["h0", "h1"]
    t.stop()
    t = Tracker(world_size=2, quiet=True, topology="flat")
    assert t.host_order is None
    t.stop()


@pytest.mark.parametrize("seed", range(40))
def test_assign_ranks_equals_jax(seed):
    rng = np.random.RandomState(seed)
    world = int(rng.randint(1, 9))
    hosts = [f"h{i}" for i in range(int(rng.randint(1, 5)))]
    ids = [str(i) if rng.rand() < 0.4 else f"w{i}" for i in range(world + 2)]
    wave = [(t, hosts[rng.randint(len(hosts))])
            for t in rng.permutation(ids)[:int(rng.randint(1, world + 1))]]
    prev = {t: int(rng.randint(-1, world + 1)) for t in ids if rng.rand() < 0.4}
    order = None
    if rng.rand() < 0.7:
        order = [str(h) for h in rng.permutation(hosts + ["elsewhere"])[:int(rng.randint(0, 4))]]
    assert (assign_ranks(wave, world, prev, host_order=order)
            == jax_assign_ranks(wave, world, prev, host_order=order))
