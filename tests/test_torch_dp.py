"""The port's hook-based and data-parallel rounds against the JAX package's,
on the CPU.

Inputs are made with numpy from seeds and go through both packages.  The
multi-process scenarios run once, in one group of four gloo processes
(tests/workers/torch_dp_worker.py), and each test reads its scenario's
result.  As in tests/test_gbdt.py, split tables must be equal and leaves
and margins agree within rtol = 1e-4 (the ranks' partial histograms are
summed in another order than one device's); the fused dp round matches the
hook-based one within rtol = 1e-3, atol = 1e-5 (bf16 hi/lo leaf sums).
"""

import functools
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu.elastic import rebalance as jrebalance
from rabit_tpu.models import gbdt as jgbdt
from rabit_tpu.ops import hist as jhist
from rabit_tpu_torch import elastic as telastic
from rabit_tpu_torch.models import gbdt as tgbdt
from rabit_tpu_torch.ops import hist as thist

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4


def make_synth(n, f, seed):
    """tests/test_gbdt.py's generator."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    logits = X[:, 0] * X[:, 1] + np.sin(X[:, 2] * 2) + 0.5 * (X[:, 3] > 0.3)
    return X, (logits > 0).astype(np.float32)


def _binned(n=1024, f=8, n_bins=32, seed=3):
    X, y = make_synth(n, f, seed)
    edges = jgbdt.compute_bin_edges(X, n_bins)
    return np.array(jgbdt.quantize(jnp.asarray(X), jnp.asarray(edges))), y


def _data5():
    """tests/test_gbdt.py:294's data: 2 row blocks of 128 per rank."""
    rng = np.random.RandomState(5)
    n = 128 * 2 * WORLD
    return (rng.randint(0, 16, size=(n, 5)).astype(np.int32),
            rng.randint(0, 2, size=n).astype(np.float32))


def _data11():
    """tests/test_gbdt.py:345's data: one row block of 128 per rank."""
    rng = np.random.RandomState(11)
    n = 128 * WORLD
    return (rng.randint(0, 16, size=(n, 4)).astype(np.int32),
            rng.randint(0, 2, size=n).astype(np.float32))


def _jax_rounds(cfg, xb, y):
    state = jgbdt.init_state(cfg, len(y))
    step = jax.jit(functools.partial(jgbdt.train_round, cfg=cfg))
    for _ in range(cfg.n_trees):
        state = step(state, jnp.asarray(xb), jnp.asarray(y))
    return jax.tree.map(np.asarray, state)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Every multi-process scenario, in one group of WORLD gloo processes;
    returns each rank's results."""
    tmp = tmp_path_factory.mktemp("torch_dp")
    xb, y = _binned()
    xb5, y5 = _data5()
    xb11, y11 = _data11()
    np.savez(tmp / "in.npz", xb=xb, y=y, xb5=xb5, y5=y5, xb11=xb11, y11=y11)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    worker = ROOT / "tests" / "workers" / "torch_dp_worker.py"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(WORLD), str(tmp / "store"),
         str(tmp / "in.npz"), str(tmp / f"rank{r}.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def _forest(run, key):
    return [run[f"{key}_{k}"] for k in ("feature", "threshold", "leaf")]


def _assert_ranks_agree(runs, key):
    for run in runs[1:]:
        for a, b in zip(_forest(run, key), _forest(runs[0], key)):
            np.testing.assert_array_equal(a, b)


def _assert_matches(got, ref_forest, rtol, atol=0.0):
    feature, threshold, leaf = got
    np.testing.assert_array_equal(feature, ref_forest.feature)
    np.testing.assert_array_equal(threshold, ref_forest.threshold)
    np.testing.assert_allclose(leaf, ref_forest.leaf, rtol=rtol, atol=atol)


def test_train_round_dp_matches_single_device(dp_runs):
    """W = 4 ranks, dp only, vs JAX's single-device train_round."""
    xb, y = _binned()
    ref = _jax_rounds(jgbdt.GBDTConfig(n_features=8, n_trees=3, depth=4,
                                       n_bins=32), xb, y)
    _assert_ranks_agree(dp_runs, "dp")
    _assert_matches(_forest(dp_runs[0], "dp"), ref.forest, rtol=1e-4)
    margin = np.concatenate([run["dp_margin"] for run in dp_runs])
    np.testing.assert_allclose(margin, ref.margin, rtol=1e-4)


def test_train_round_dp_fp_matches_single_device(dp_runs):
    """2 x 2 dp x fp vs JAX's single-device train_round."""
    xb, y = _binned()
    ref = _jax_rounds(jgbdt.GBDTConfig(n_features=8, n_trees=3, depth=4,
                                       n_bins=32), xb, y)
    _assert_ranks_agree(dp_runs, "fp")
    _assert_matches(_forest(dp_runs[0], "fp"), ref.forest, rtol=1e-4)
    # ranks 0 and 2 (fp index 0) hold dp shards 0 and 1
    margin = np.concatenate([dp_runs[0]["fp_margin"], dp_runs[2]["fp_margin"]])
    np.testing.assert_allclose(margin, ref.margin, rtol=1e-4)
    np.testing.assert_array_equal(dp_runs[1]["fp_margin"], dp_runs[0]["fp_margin"])


def test_train_round_dp_fused_matches_dp(dp_runs):
    """tests/test_gbdt.py:294 across processes: the fused dp round grows the
    hook-based dp round's trees, and both grow JAX's single-device ones."""
    _assert_ranks_agree(dp_runs, "fused5")
    fused = _forest(dp_runs[0], "fused5")
    dp = tgbdt.Forest(*_forest(dp_runs[0], "dp5"))
    _assert_matches(fused, dp, rtol=1e-3, atol=1e-5)
    xb5, y5 = _data5()
    ref = _jax_rounds(jgbdt.GBDTConfig(n_features=5, n_trees=2, depth=3,
                                       n_bins=16), xb5, y5)
    _assert_matches(_forest(dp_runs[0], "dp5"), ref.forest, rtol=1e-4)


def test_train_round_dp_fused_wire_i8_close_to_exact(dp_runs):
    """tests/test_gbdt.py:345 across processes: the int8-wire histogram
    ring grows, on every rank, the same forest bit for bit, with the exact
    fused dp round's split tables and leaves within rtol = atol = 1e-3; and
    JAX's wire_i8 round at the same world grows the same split tables."""
    _assert_ranks_agree(dp_runs, "wire11")
    exact = tgbdt.Forest(*_forest(dp_runs[0], "exact11"))
    _assert_matches(_forest(dp_runs[0], "wire11"), exact, rtol=1e-3, atol=1e-3)
    from jax.sharding import PartitionSpec as P

    from rabit_tpu import parallel as rp
    from rabit_tpu.ops import boost as jboost

    xb, y = _data11()
    cfg = jgbdt.GBDTConfig(n_features=4, n_trees=2, depth=3, n_bins=16)
    mesh = rp.create_mesh(("dp",), devices=jax.devices()[:WORLD])
    state_spec = jgbdt.TrainState(forest=jgbdt.Forest(P(), P(), P()), margin=P("dp"),
                                  round=P())
    wired = jax.jit(jax.shard_map(
        functools.partial(jgbdt.train_round_dp_fused, cfg=cfg, interpret=True,
                          wire_i8=True, wire_block=16),
        mesh=mesh, in_specs=(state_spec, P("dp", None, None), P("dp")),
        out_specs=state_spec, check_vma=False))
    xb3, _ = jboost.block_rows(jnp.asarray(xb), 128)
    state = jgbdt.init_state(cfg, len(y))
    for _ in range(cfg.n_trees):
        state = wired(state, xb3, jnp.asarray(y))
    ref = jax.tree.map(np.asarray, state.forest)
    feature, threshold, leaf = _forest(dp_runs[0], "wire11")
    np.testing.assert_array_equal(feature, ref.feature)
    np.testing.assert_array_equal(threshold, ref.threshold)
    np.testing.assert_allclose(leaf, ref.leaf, rtol=1e-3, atol=1e-3)


def test_train_round_dp_refusals(dp_runs):
    # the worker's level-0 histogram, 5 * 16 * 2 = 160 floats, is no whole
    # number of 256-float wire blocks a rank, and every rank refuses it as
    # JAX refuses it
    for run in dp_runs:
        assert "not divisible by block 256" in str(run["refusal"])
    cfg = tgbdt.GBDTConfig(n_features=5, n_trees=1, depth=2, n_bins=16)
    state = tgbdt.init_state(cfg, 256, "cpu")
    xb3 = torch.zeros((1, 256, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs its dp_group"):
        tgbdt.train_round_dp(state, xb3[0], torch.zeros(256), cfg,
                             fp_group=object())


def test_train_round_hook_matches_jax():
    """The same hooks in both packages: every histogram and the leaf masses
    doubled, as two workers holding the same shard would sum them."""
    xb, y = _binned(n=600, f=5, n_bins=16, seed=7)
    cfg_j = jgbdt.GBDTConfig(n_features=5, n_trees=3, depth=3, n_bins=16)
    cfg_t = tgbdt.GBDTConfig(n_features=5, n_trees=3, depth=3, n_bins=16)
    jhook = lambda xb_, g, h, node, nn, nb: 2.0 * jhist.node_histograms(
        xb_, g, h, node, nn, nb)
    thook = lambda xb_, g, h, node, nn, nb: 2.0 * thist.node_histograms(
        xb_, g, h, node, nn, nb)
    sj = jgbdt.init_state(cfg_j, len(y))
    st = tgbdt.init_state(cfg_t, len(y), "cpu")
    jstep = jax.jit(functools.partial(jgbdt.train_round, cfg=cfg_j, hist_fn=jhook,
                                      combine_leaf=lambda gh: 2.0 * gh))
    for _ in range(3):
        sj = jstep(sj, jnp.asarray(xb), jnp.asarray(y))
        st = tgbdt.train_round(st, torch.as_tensor(xb), torch.as_tensor(y), cfg_t,
                               thook, lambda gh: 2.0 * gh)
    _assert_matches(tgbdt.forest_to_numpy(st.forest), sj.forest, rtol=1e-4,
                    atol=1e-5)
    np.testing.assert_allclose(st.margin.numpy(), np.asarray(sj.margin),
                               rtol=1e-4, atol=1e-5)


def _counting(calls):
    def fake_allreduce(arr):
        calls.append(arr.shape)
        return arr
    return fake_allreduce


def test_gbdt_engine_allreduce_matches_jax():
    """tests/test_gbdt.py:85 in both packages: depth + 1 hook calls per
    tree, the same histogram shapes in the same order, the same forest."""
    X, y = make_synth(300, 4, seed=0)
    hyper = dict(n_trees=2, depth=3, n_bins=32)
    jcalls, tcalls = [], []
    jm = jgbdt.GBDT(engine_allreduce=_counting(jcalls), **hyper).fit(X, y)
    tm = tgbdt.GBDT(engine_allreduce=_counting(tcalls), device="cpu",
                    **hyper).fit(X, y)
    assert len(tcalls) == 2 * (3 + 1)
    assert tcalls == jcalls
    _assert_matches(tgbdt.forest_to_numpy(tm.forest), jm.forest, rtol=1e-4,
                    atol=1e-5)
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))


def test_fit_shard_matches_jax():
    world, rank = 3, 2
    X, y = make_synth(301, 4, seed=2)
    hyper = dict(n_trees=1, depth=3, n_bins=16)
    jm = jgbdt.GBDT(engine_allreduce=lambda a: a, **hyper).fit_shard(
        X, y, world, rank)
    tm = tgbdt.GBDT(engine_allreduce=lambda a: a, device="cpu",
                    **hyper).fit_shard(X, y, world, rank)
    _assert_matches(tgbdt.forest_to_numpy(tm.forest), jm.forest, rtol=1e-4,
                    atol=1e-5)


def test_elastic_shard_matches_jax():
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 1000, 1003):
        X = rng.randn(n, 3).astype(np.float32)
        y = rng.rand(n).astype(np.float32)
        for world in (1, 2, 3, 4, 7):
            assert telastic.shard_bounds(n, world) == jrebalance.shard_bounds(n, world)
            for rank in range(world):
                got, want = tgbdt.elastic_shard(X, y, world, rank), \
                    jgbdt.elastic_shard(X, y, world, rank)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
    for bad in ((10, 0, 0), (10, 2, 2), (10, 2, -1)):
        with pytest.raises(ValueError):
            telastic.shard_slice(*bad)
