"""The fault planes under the port's schedule runner: the port's
counterpart of every test of ``rabit_tpu``'s planes that drives
``rabit_tpu.chaos.run_elastic_schedule`` (tests/test_relay.py,
tests/test_ha.py, tests/test_quorum.py, tests/test_sched.py and
tests/test_diagnose.py), with the same seeds, arguments and asserts,
through ``rabit_tpu_torch.chaos.run_elastic_schedule`` on the CPU
(``device="cpu"``: each contribution is ``node_histograms_kernel``'s plain
twin).  The bitwise and accounting asserts live inside the runner; the
campaigns are parametrised by seed, and the ``slow`` ones stay ``slow``.
The checks that read the incident monitor or a link's wait run up to three
times until every assertion holds at once, as tests/test_torch_diagnose.py
runs the same scenarios: a host busy with other tests can starve a worker
thread long enough for either package's monitor to see a straggler that
is not there.
tests/test_service.py's runner case needs the multi-job key (ROADMAP.md
Queue 1 item 10g) and is not here.
"""

from __future__ import annotations

import functools
import random

import pytest

from rabit_tpu_torch.chaos import FaultSpec
from rabit_tpu_torch.chaos import run_elastic_schedule as _run_elastic_schedule

run_elastic_schedule = functools.partial(_run_elastic_schedule, device="cpu")

TIMING_ATTEMPTS = 3


def on_one_attempt(check) -> None:
    """Run the timing-driven ``check`` until all of its assertions hold in
    one attempt, at most TIMING_ATTEMPTS times."""
    for attempt in range(1, TIMING_ATTEMPTS + 1):
        try:
            check()
            return
        except AssertionError:
            if attempt == TIMING_ATTEMPTS:
                raise


# -- relays: tests/test_relay.py ------------------------------------------------

def test_relay_bounce_leases_survive():
    """A relay bounce is no membership event: the children's leases ride
    it out with no spurious lease_expired."""
    r = run_elastic_schedule(7101, world=3, relays=2, heartbeat_sec=0.3, niter=8,
                             iter_sleep=0.15, deadline_sec=60.0,
                             relay_fault=FaultSpec(relay_death=(0.8, 0.4)))
    assert r.outcome == "completed"
    assert r.n_spurious_expired == 0
    assert r.n_relay_lost >= 1  # the bounce was delivered


def test_relay_partition_heals_and_converges():
    r = run_elastic_schedule(7102, world=3, relays=2, heartbeat_sec=0.3, niter=8,
                             iter_sleep=0.15, deadline_sec=60.0,
                             relay_fault=FaultSpec(relay_partition=(0.6, 0.5)))
    assert r.outcome == "completed"
    assert r.n_spurious_expired == 0


_RELAY_FAULTS = [None, FaultSpec(relay_death=(0.6, 0.3)),
                 FaultSpec(relay_partition=(0.5, 0.4))]


@pytest.mark.parametrize("i,seed", list(enumerate(range(7200, 7206))))
def test_relay_fuzz_fast_campaign(i, seed):
    """Seeded relayed shrink/grow schedules with bounces and partitions
    mixed in: zero spurious expiries throughout."""
    r = run_elastic_schedule(seed, relays=2, heartbeat_sec=0.3, deadline_sec=60.0,
                             relay_fault=_RELAY_FAULTS[i % len(_RELAY_FAULTS)])
    assert r.outcome == "completed", seed
    assert r.n_spurious_expired == 0, seed
    assert r.relays == 2


@pytest.mark.slow
def test_relay_fuzz_full_campaign():
    faults = [None,
              FaultSpec(relay_death=(0.6, 0.3)),
              FaultSpec(relay_death=(1.2, 0.5)),
              FaultSpec(relay_partition=(0.5, 0.4)),
              FaultSpec(relay_death=(0.4, 0.3), relay_partition=(1.5, 0.4))]
    for i, seed in enumerate(range(7300, 7320)):
        r = run_elastic_schedule(seed, relays=(1 + i % 3), heartbeat_sec=0.3,
                                 deadline_sec=75.0, relay_fault=faults[i % len(faults)])
        assert r.outcome == "completed", seed
        assert r.n_spurious_expired == 0, seed


# -- the HA control plane: tests/test_ha.py ----------------------------------------

def test_standby_death_leaves_job_unbothered():
    res = run_elastic_schedule(9101, world=3, niter=4,
                               failover=FaultSpec(standby_death=0.2), deadline_sec=30.0)
    assert res.outcome == "completed"
    assert res.n_failover == 0 and not res.primary_killed


#: (seed, kwargs): the primary killed mid-bootstrap, mid-run, mid-quorum-
#: round, mid-shrink-wave and behind a relay (tests/test_ha.py's list)
FAILOVER_SCENARIOS = [
    (9301, dict(world=3, niter=5, iter_sleep=0.1,
                failover=FaultSpec(tracker_death=0.05))),   # mid-bootstrap
    (9302, dict(world=3, niter=6, iter_sleep=0.15,
                failover=FaultSpec(tracker_death=0.5))),    # mid-run
    (9303, dict(world=3, niter=5, quorum="0.67", straggler=(1, 0.5),
                quorum_wait=0.15, deadline_sec=45.0,
                failover=FaultSpec(tracker_death=0.8))),    # mid-quorum
    (9304, dict(world=3, niter=8, iter_sleep=0.15, deadline_sec=45.0,
                failover=FaultSpec(tracker_death=0.6))),    # mid-shrink
    (9305, dict(world=4, niter=6, iter_sleep=0.12, relays=1, deadline_sec=45.0,
                failover=FaultSpec(tracker_death=0.4))),    # behind relays
]


@pytest.mark.parametrize("seed,kw", FAILOVER_SCENARIOS)
def test_chaos_failover_campaign(seed, kw):
    """The tracker itself as the casualty: whatever phase the kill lands
    in, the job completes with the exact bits and no live rank is
    suspected."""
    res = run_elastic_schedule(seed, **kw)
    assert res.outcome == "completed"
    assert res.n_spurious_expired == 0
    assert res.n_journal_gap == 0
    if res.primary_killed:
        assert res.n_failover <= 1


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(9400, 9420))
def test_chaos_failover_campaign_slow(seed):
    rng = random.Random(seed)
    kw = dict(world=rng.choice([2, 3, 4]), niter=rng.choice([5, 6, 8]),
              iter_sleep=rng.choice([0.08, 0.12, 0.15]), relays=rng.choice([0, 0, 1]),
              deadline_sec=50.0,
              failover=FaultSpec(tracker_death=rng.choice([0.05, 0.3, 0.6, 1.0])))
    if rng.random() < 0.3:
        kw.update(quorum="0.67", straggler=(1, 0.4), quorum_wait=0.15)
    res = run_elastic_schedule(seed, **kw)
    assert res.outcome == "completed"
    assert res.n_spurious_expired == 0
    assert res.n_journal_gap == 0


# -- quorum rounds: tests/test_quorum.py -----------------------------------------

def test_chaos_straggler_fault_clean_arm():
    r = run_elastic_schedule(901, world=3, straggler=(2, 0.3, 3), quorum="0.6", niter=6,
                             deadline_sec=40.0)
    assert r.outcome == "completed"
    assert r.quorum == "0.6" and r.straggler == (2, 0.3, 3)
    assert r.n_quorum_met >= 1


def test_chaos_straggler_without_quorum_still_converges():
    """The compute fault alone: every round waits out the straggler, and
    the bits stay the exact closed form."""
    r = run_elastic_schedule(910, world=3, straggler=(1, 0.2, 2), niter=4, deadline_sec=40.0)
    assert r.outcome == "completed" and r.n_quorum_met == 0


@pytest.mark.parametrize("seed", range(9300, 9305))
def test_fuzz_straggler_quorum_kill_campaign(seed):
    """Straggler, quorum and kill faults mixed: the cross-rank identity
    and the correction accounting are asserted inside the runner."""
    r = run_elastic_schedule(seed, world=4, straggler=(2, 0.25, 3), quorum="0.5", niter=5,
                             mix_faults=True, deadline_sec=45.0)
    assert r.outcome == "completed", f"seed {seed}: {r}"


@pytest.mark.slow
def test_fuzz_straggler_quorum_kill_campaign_slow():
    for i, seed in enumerate(range(9400, 9420)):
        world = 3 + (i % 2)
        spec = ("0.5", "0.6", "2")[i % 3]
        r = run_elastic_schedule(seed, world=world,
                                 straggler=(world - 1, 0.2 + 0.1 * (i % 2), 3),
                                 quorum=spec, niter=5, mix_faults=True, deadline_sec=60.0)
        assert r.outcome == "completed", f"seed {seed}: {r}"


# -- schedules: tests/test_sched.py ------------------------------------------------

def test_e2e_slow_link_repair_drops_wait():
    """The same slow-link schedule with the repair off, then on: with it
    the link is reported, confirmed by the monitor, routed around at the
    next epoch boundary, and the dst's link wait drops."""
    link = (1, 2, 0.15)

    def check():
        off = run_elastic_schedule(11, world=3, schedule="ring", slow_link=link, repair=False,
                                   niter=12, deadline_sec=60.0)
        on = run_elastic_schedule(11, world=3, schedule="ring", slow_link=link, repair=True,
                                  niter=12, deadline_sec=60.0)
        assert off.outcome == on.outcome == "completed"
        assert off.n_repaired == 0
        assert on.n_repaired >= 1
        assert on.dst_slow_reports >= 1
        assert on.dst_wait_s < 0.75 * off.dst_wait_s, (on.dst_wait_s, off.dst_wait_s)

    on_one_attempt(check)


def test_e2e_repair_disabled_still_records_evidence():
    r = run_elastic_schedule(11, world=3, schedule="ring", slow_link=(1, 2, 0.1),
                             repair=False, niter=5, deadline_sec=45.0)
    assert r.dst_slow_reports >= 1
    assert r.n_repaired == 0


@pytest.mark.parametrize("algo", ["auto", "tree", "ring", "swing"])
def test_fuzz_schedule_value_keeps_closed_form(algo):
    """One seeded shrink/grow schedule per rabit_schedule value."""
    r = run_elastic_schedule(7321, world=3, schedule=algo, deadline_sec=30.0)
    assert r.outcome == "completed"
    assert r.schedule == algo


@pytest.mark.slow
def test_fuzz_schedule_campaign_slow():
    for seed in range(7400, 7410):
        for algo in ("auto", "tree", "ring", "swing"):
            r = run_elastic_schedule(seed, schedule=algo, deadline_sec=40.0)
            assert r.outcome == "completed", f"{algo} seed {seed}: {r}"


# -- the diagnosis plane: tests/test_diagnose.py ----------------------------------

def test_chaos_slow_link_one_incident_names_link_and_repairs():
    def check():
        r = run_elastic_schedule(11, world=3, schedule="ring", slow_link=(1, 2, 0.15),
                                 repair=True, niter=12, deadline_sec=60.0)
        assert r.outcome == "completed"
        inc = r.incidents
        assert inc["n_opened"] == 1
        every = inc["open"] + inc["recent"]
        assert len(every) == 1
        assert every[0]["class"] == "degraded-link"
        assert every[0]["subject"] == {"src": 1, "dst": 2}
        assert any(e["rule"] == "link-wait-attributed" for e in every[0]["evidence"])
        assert r.n_repaired >= 1  # the rewave fired from the incident feed

    on_one_attempt(check)


def test_chaos_straggler_one_incident_names_rank():
    def check():
        r = run_elastic_schedule(903, world=4, straggler=(2, 0.4), niter=10, deadline_sec=60.0)
        assert r.outcome == "completed"
        inc = r.incidents
        assert inc["n_opened"] == 1
        every = inc["open"] + inc["recent"]
        assert every[0]["class"] == "compute-straggler"
        assert every[0]["subject"] == {"rank": 2}

    on_one_attempt(check)


def test_chaos_clean_run_opens_zero_incidents():
    def check():
        r = run_elastic_schedule(4242, world=3, niter=4, deadline_sec=40.0)
        assert r.outcome == "completed"
        assert r.incidents["n_opened"] == 0
        assert r.incidents["open"] == []

    on_one_attempt(check)
