"""The port's hybrid round (rabit_tpu_torch.models.gbdt.train_round_hybrid)
against the JAX package's, on the CPU.

The same seeded numpy data go through both: solo, and with a deterministic
host hook that doubles its input (as two workers holding the same shard
would sum).  Split tables must be equal and leaves and margins agree
within rtol = 1e-4, as in test_torch_dp.py.  A worker of two gloo
processes (tests/workers/torch_hybrid_local_worker.py) holds the local
sums, the leader-only hop and the leaf masses' local sum against
train_round_dp over the same group, bit for bit.
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

from rabit_tpu.models import gbdt as jgbdt
from rabit_tpu_torch.models import gbdt as tgbdt

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEPTH, N_TREES = 3, 3


def _binned(n=600, f=5, n_bins=16, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] + np.sin(X[:, 2] * 2)) > 0).astype(np.float32)
    edges = jgbdt.compute_bin_edges(X, n_bins)
    return np.array(jgbdt.quantize(jnp.asarray(X), jnp.asarray(edges))), y


def _double(calls):
    def hook(a):
        calls.append(a.shape)
        return 2.0 * np.asarray(a)
    return hook


@pytest.mark.parametrize("hooked", [False, True], ids=["solo", "hook"])
def test_train_round_hybrid_matches_jax(hooked):
    xb, y = _binned()
    kw = dict(n_features=xb.shape[1], n_trees=N_TREES, depth=DEPTH, n_bins=16)
    jcalls, tcalls = [], []
    jstep = jax.jit(functools.partial(
        jgbdt.train_round_hybrid, cfg=jgbdt.GBDTConfig(**kw),
        engine_allreduce=_double(jcalls) if hooked else None))
    sj = jgbdt.init_state(jgbdt.GBDTConfig(**kw), len(y))
    cfg = tgbdt.GBDTConfig(**kw)
    st = tgbdt.init_state(cfg, len(y), "cpu")
    for _ in range(N_TREES):
        sj = jstep(sj, jnp.asarray(xb), jnp.asarray(y))
        st = tgbdt.train_round_hybrid(st, torch.as_tensor(xb), torch.as_tensor(y), cfg,
                                      engine_allreduce=_double(tcalls) if hooked else None)
    got = tgbdt.forest_to_numpy(st.forest)
    np.testing.assert_array_equal(got.feature, np.asarray(sj.forest.feature))
    np.testing.assert_array_equal(got.threshold, np.asarray(sj.forest.threshold))
    np.testing.assert_allclose(got.leaf, np.asarray(sj.forest.leaf), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(st.margin.numpy(), np.asarray(sj.margin), rtol=1e-4,
                               atol=1e-5)
    # depth + 1 hops a tree: the levels in order, then the leaf masses
    want = [(2 ** d, xb.shape[1], 16, 2) for d in range(DEPTH)] + [(2 ** DEPTH, 2)]
    assert tcalls == (want * N_TREES if hooked else [])
    assert len(jcalls) == len(tcalls)


def test_hop_sequence_holds_when_levels_repeat():
    """All rows in bin 0: no split is valid, every row stays in node 0, and
    each level's histogram holds the same sums; every level still makes its
    own hop, in order, then the leaf masses."""
    n = 256
    xb = torch.zeros((n, 4), dtype=torch.int32)
    y = torch.as_tensor((np.arange(n) % 2).astype(np.float32))
    cfg = tgbdt.GBDTConfig(n_features=4, n_trees=2, depth=4, n_bins=8)
    calls, sums = [], []

    def hook(a):
        calls.append(a.shape)
        sums.append(float(a[0].sum()) if a.ndim == 4 else None)
        return a

    s = tgbdt.init_state(cfg, n, "cpu")
    for _ in range(cfg.n_trees):
        s = tgbdt.train_round_hybrid(s, xb, y, cfg, engine_allreduce=hook)
    assert calls == ([(2 ** d, 4, 8, 2) for d in range(4)] + [(16, 2)]) * 2
    assert len(set(sums[:4])) == 1  # the levels' node-0 sums are equal


@pytest.fixture(scope="module")
def local_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_hybrid_local")
    xb, y = _binned(n=1000)
    np.savez(tmp / "in.npz", xb=xb, y=y)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    worker = ROOT / "tests" / "workers" / "torch_hybrid_local_worker.py"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(tmp / "store"), str(tmp / "in.npz"),
         str(tmp / f"rank{r}.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
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
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _same(run, a, b):
    for k in ("feature", "threshold", "leaf", "margin"):
        np.testing.assert_array_equal(run[f"{a}_{k}"], run[f"{b}_{k}"], err_msg=k)


@pytest.mark.parametrize("scenario,reference", [("solo", "dp"), ("hop", "dp2")])
def test_local_group_matches_train_round_dp(local_runs, scenario, reference):
    """Two processes, one worker: the local all_reduce (leaf masses too)
    gives train_round_dp's round bit for bit, with no hop or with the
    doubling hop; both ranks grow the same forest."""
    for run in local_runs:
        _same(run, scenario, reference)
    for k in ("feature", "threshold", "leaf"):
        np.testing.assert_array_equal(local_runs[0][f"{scenario}_{k}"],
                                      local_runs[1][f"{scenario}_{k}"])


def test_local_group_hops_once_a_worker(local_runs):
    """Only the group's lowest rank crosses the engine: depth + 1 calls a
    tree there, none on the other process."""
    want = [2 ** d for d in range(DEPTH)] + [2 ** DEPTH]
    assert local_runs[0]["hop_shapes"].tolist() == want * N_TREES
    assert local_runs[0]["hop_calls"].tolist() == ([4] * DEPTH + [2]) * N_TREES
    assert local_runs[1]["hop_shapes"].size == 0
