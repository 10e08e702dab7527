"""The port's schedule runners (``rabit_tpu_torch.chaos``) against
``rabit_tpu.chaos``'s, on the CPU.

* ``run_schedule``: seeded bootstrap and recovery schedules through a
  ``ChaosProxy`` against the port's tracker converge with dense, stable
  ranks (tests/test_chaos.py's fast subset, seeds 0-29; the 200-seed sweep
  is ``slow`` as there);
* ``run_elastic_schedule``: the shrink/grow fuzz campaign, seeds 7000-7029
  on the reactor serving path and 7000-7009 again on the threaded one (the
  120-seed campaign is ``slow`` as in tests/test_elastic.py), every
  contribution ``node_histograms_kernel``'s plain twin (``device="cpu"``);
* the same seed draws the same scenario in both packages (world, spares,
  versions, schedule), and both runs complete;
* the contribution: the kernel wrapper's g plane at the runner's shapes
  ([n, 1] bins, one node, 8 bins, n < 128) equals ``np.bincount`` and the
  Pallas kernel run in the interpreter, exactly;
* the pieces the runners need: ``tracker_rpc`` check-ins (fail fast on a
  dead port), the tracker's ``conn_timeout_sec`` on both serving paths,
  ``ElasticWorker(rpc_timeout=)``, and the refusals of ``job=``.
"""

from __future__ import annotations

import functools
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu import chaos as jchaos
from rabit_tpu.ops import hist as jhist
from rabit_tpu_torch import chaos
from rabit_tpu_torch.elastic.client import ElasticWorker
from rabit_tpu_torch.ops import hist as thist
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker


# -- run_schedule: tests/test_chaos.py ----------------------------------------------

def _assert_schedule(seed: int) -> None:
    r = chaos.run_schedule(seed)
    assert r.completed, f"seed {seed} did not converge: {r}"
    assert sorted(r.rank_of.values()) == list(range(r.world)), r
    assert r.epoch >= 0


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_bootstrap_recovery_fast_subset(seed):
    """Fuzzed schedules converge with no hang: every RPC is bounded, and a
    stuck thread fails the schedule."""
    _assert_schedule(seed)


@pytest.mark.slow
def test_fuzz_bootstrap_recovery_full():
    for seed in range(200):
        _assert_schedule(seed)


def _dead_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_tracker_rpc_fails_fast_when_tracker_gone():
    port = _dead_port()
    t0 = time.monotonic()
    with pytest.raises(P.TrackerUnreachable) as ei:
        P.tracker_rpc("127.0.0.1", port, P.CMD_START, "0", listen_port=41000,
                      timeout=0.5, retries=3, backoff=0.05)
    assert time.monotonic() - t0 < 5.0  # bounded, never blocking
    assert "4 attempt(s)" in str(ei.value)
    assert f"127.0.0.1:{port}" in str(ei.value)


@pytest.mark.parametrize("reactor", [True, False])
def test_tracker_rpc_checkins_close_a_wave(reactor):
    """START check-ins through ``tracker_rpc`` return the wave's
    Assignments; a RECOVER after a failed wave keeps the rank."""
    import threading

    tracker = Tracker(2, quiet=True, reactor=reactor).start()
    try:
        out = {}

        def boot(tid, cmd, prev):
            out[tid] = P.tracker_rpc(tracker.host, tracker.port, cmd, tid, prev_rank=prev,
                                     listen_port=42000 + int(tid), timeout=2.0,
                                     reply_timeout=5.0)

        for cmd in (P.CMD_START, P.CMD_RECOVER):
            ths = [threading.Thread(target=boot, args=(t, cmd, out[t].rank if out else -1))
                   for t in ("0", "1")]
            for th in ths:
                th.start()
            for th in ths:
                th.join(10.0)
            assert {t: a.rank for t, a in out.items()} == {"0": 0, "1": 1}
            assert {a.world_size for a in out.values()} == {2}
        assert [e["epoch"] for e in tracker.events if e["kind"] == "wave"] == [0, 1]
    finally:
        tracker.stop()


@pytest.mark.parametrize("reactor", [True, False])
def test_torn_hello_dropped_after_conn_timeout(reactor):
    """A hello cut short is dropped about ``conn_timeout_sec`` after its
    accept on both serving paths, and the wave still closes."""
    tracker = Tracker(1, quiet=True, conn_timeout_sec=1.0, reactor=reactor).start()
    try:
        torn = socket.create_connection((tracker.host, tracker.port), timeout=5.0)
        torn.sendall(P.put_u32(P.MAGIC_HELLO)[:3])
        t0 = time.monotonic()
        torn.settimeout(5.0)
        try:
            got = torn.recv(1)
        except ConnectionResetError:
            got = b""
        held = time.monotonic() - t0
        assert got == b"" and 0.8 <= held <= 2.5, held
        torn.close()
        asg = P.tracker_rpc(tracker.host, tracker.port, P.CMD_START, "0", listen_port=1,
                            timeout=2.0)
        assert (asg.rank, asg.world_size) == (0, 1)
    finally:
        tracker.stop()


def test_elastic_worker_rpc_timeout():
    w = ElasticWorker(("127.0.0.1", 1), "0", lambda v, w, r: np.zeros(1), 1, rpc_timeout=0.7)
    try:
        assert w.rpc_timeout == 0.7
    finally:
        w._listen.close()
    w = ElasticWorker(("127.0.0.1", 1), "0", lambda v, w, r: np.zeros(1), 1)
    try:
        assert w.rpc_timeout == 2.0
    finally:
        w._listen.close()


def test_job_key_refused():
    """The runner's job mode waits for item 10g; ``tracker_rpc(job=)`` joins the
    key into the wire task id, which a live port tracker sees as
    ``tenant/0``."""
    with pytest.raises(NotImplementedError, match="10g"):
        chaos.run_elastic_schedule(7000, job="tenant", device="cpu")
    tr = Tracker(1, quiet=True).start()
    try:
        ack = P.tracker_rpc(tr.host, tr.port, P.CMD_HEARTBEAT, "0", message="30", job="tenant")
        assert ack == P.ACK and tr.live_tasks() == ["tenant/0"]
    finally:
        tr.stop()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos.run_elastic_schedule(7000)


# -- the contribution --------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 12, 24, 32, 127, 200])
def test_contribution_is_the_bincount(n):
    """The runner's counts: node_histograms_kernel's g plane over an [n, 1]
    bin matrix, one node, g = h = 1, equals np.bincount and JAX's Pallas
    kernel (interpreted) bit for bit, whole and on a shard."""
    rng = np.random.RandomState(n)
    data = rng.randint(0, 8, size=n)
    counts = chaos._shard_counter(data, 8, "cpu")
    whole = counts(slice(0, n))
    assert whole.dtype == np.int64
    assert np.array_equal(whole, np.bincount(data, minlength=8))
    lo = n // 3
    assert np.array_equal(counts(slice(lo, n)), np.bincount(data[lo:], minlength=8))
    assert counts.n_calls == 2
    ones = np.ones(n, np.float32)
    ref = jhist.node_histograms_pallas(jnp.asarray(data.astype(np.int32).reshape(n, 1)),
                                       jnp.asarray(ones), jnp.asarray(ones),
                                       jnp.zeros(n, jnp.int32), 1, 8, interpret=True)
    assert np.array_equal(np.asarray(ref)[0, 0, :, 0], whole)
    got = thist.node_histograms_kernel(torch.as_tensor(data.astype(np.int32).reshape(n, 1)),
                                       torch.ones(n), torch.ones(n),
                                       torch.zeros(n, dtype=torch.int32), 1, 8)
    assert np.array_equal(got[0, 0, :, 1].numpy(), whole)  # h = 1 too


# -- run_elastic_schedule: tests/test_elastic.py ------------------------------------

def _assert_elastic_schedule(seed: int) -> None:
    r = chaos.run_elastic_schedule(seed, device="cpu")
    assert r.outcome == "completed", f"seed {seed}: {r}"
    assert r.n_completed >= 1, f"seed {seed}: {r}"
    # epochs committed strictly increasing, worlds within bounds
    epochs = [e["epoch"] for e in r.epochs]
    assert epochs == sorted(set(epochs)), f"seed {seed}: {r}"
    assert all(1 <= e["world"] <= r.world for e in r.epochs), f"seed {seed}: {r}"
    assert r.n_contributions >= r.niter


@pytest.mark.parametrize("seed", range(7000, 7030))
def test_fuzz_shrink_grow_fast_campaign(seed):
    """Seeded shrink/grow schedules (kills without restart, late spares,
    spares dying parked or mid-promotion) converge, with the rank and
    bitwise asserts inside the runner, and no hang."""
    _assert_elastic_schedule(seed)


@pytest.mark.parametrize("seed", range(7000, 7010))
def test_fuzz_shrink_grow_threaded_serving(seed, monkeypatch):
    """The same schedules on the tracker's threaded serving path."""
    monkeypatch.setattr(chaos, "Tracker", functools.partial(Tracker, reactor=False))
    _assert_elastic_schedule(seed)


@pytest.mark.slow
def test_fuzz_shrink_grow_full_campaign():
    for seed in range(7000, 7120):
        _assert_elastic_schedule(seed)


# -- one seed, one scenario, in both packages ----------------------------------------

@pytest.mark.parametrize("seed", range(7000, 7010))
def test_elastic_seed_draws_the_same_scenario(seed):
    ref = jchaos.run_elastic_schedule(seed)
    got = chaos.run_elastic_schedule(seed, device="cpu")
    assert ((got.world, got.n_spares, got.niter, got.schedule)
            == (ref.world, ref.n_spares, ref.niter, ref.schedule))
    assert got.outcome == ref.outcome == "completed"


@pytest.mark.parametrize("seed", range(10))
def test_bootstrap_seed_draws_the_same_scenario(seed):
    ref = jchaos.run_schedule(seed)
    got = chaos.run_schedule(seed)
    assert got.world == ref.world
    assert got.outcome == ref.outcome == "completed"
