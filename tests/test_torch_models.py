"""The port's linear and k-means models (rabit_tpu_torch.models.linear,
.kmeans) against the JAX package's (rabit_tpu.models) on the same seeded
numpy inputs.

In process: every piece (local_grad, apply_grad, train_step, assign,
local_stats, update, inertia) and the numpy-in trainers, both objectives.
Across processes: one spawned gloo group of W processes per world
(tests/workers/torch_models_worker.py) runs the dp steps over the group
and the rabit-classic engine-hook fits through ``api.allreduce``; JAX's dp
steps run here under ``shard_map`` over the first W virtual CPU devices.

Tolerances are tests/test_models.py's: linear rtol 2e-4, atol 2e-5 (dp vs
single there; here every port-vs-JAX linear comparison), engine hook vs
single rtol 2e-3, atol 2e-4; k-means rtol = atol = 1e-5 (dp vs single),
engine hook vs single 1e-4.  Assignments computed in two sum orders may
differ only at near ties (``assign_flips``).
"""

import functools
import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rabit_tpu import models as jmodels
from rabit_tpu import parallel as rp
from rabit_tpu.models import kmeans as jkmeans
from rabit_tpu.models import linear as jlinear
from rabit_tpu_torch import models as tmodels
from rabit_tpu_torch.models import kmeans, linear

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_models_worker.py"
WORLDS = (2, 4)
LIN = dict(rtol=2e-4, atol=2e-5)
LIN_HOOK = dict(rtol=2e-3, atol=2e-4)
KM = dict(rtol=1e-5, atol=1e-5)
KM_HOOK = dict(rtol=1e-4, atol=1e-4)


def _worker_module():
    spec = importlib.util.spec_from_file_location("torch_models_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _worker_module()
t = torch.as_tensor


def spawn(world: int, tmp) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(tmp / "store"),
         str(tmp / f"rank{r}.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
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
        assert p.returncode == 0, f"rank {r}/{world} exited {p.returncode}:\n{logs[r]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: spawn(w, tmp_path_factory.mktemp(f"models{w}")) for w in WORLDS}


def every_rank(ranks, key):
    """The key's value, required identical on every rank."""
    out = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], out, err_msg=key)
    return out


def test_models_exports_match_jax():
    assert tmodels.__all__ == jmodels.__all__
    for name in tmodels.__all__:
        assert callable(getattr(tmodels, name)), name


# -- linear ----------------------------------------------------------------------


@pytest.mark.parametrize("objective", W.OBJECTIVES)
def test_linear_pieces_match_jax(objective):
    X, y = W.make_classif()
    cfg_j = jlinear.LinearConfig(n_features=X.shape[1], objective=objective)
    cfg_t = linear.LinearConfig(n_features=X.shape[1], objective=objective)
    w = np.random.RandomState(3).randn(X.shape[1] + 1).astype(np.float32) * 0.3
    gj = np.asarray(jlinear.local_grad(jnp.asarray(w), jnp.asarray(X), jnp.asarray(y), cfg_j))
    gt = linear.local_grad(t(w), t(X), t(y), cfg_t).numpy()
    assert gt.shape == (X.shape[1] + 2,) and gt.dtype == np.float32
    np.testing.assert_allclose(gt, gj, **LIN)
    assert gt[-1] == len(X)

    sj = jlinear.apply_grad(jlinear.LinearState(jnp.asarray(w), jnp.asarray(4, jnp.int32)),
                            jnp.asarray(gj), cfg_j)
    st = linear.apply_grad(linear.state_from_numpy(w, 4, "cpu"), t(gj), cfg_t)
    np.testing.assert_allclose(st.w.numpy(), np.asarray(sj.w), **LIN)
    assert int(st.step) == int(sj.step) == 5 and st.step.dtype == torch.int32

    sj = jlinear.train_step(jlinear.LinearState(jnp.asarray(w), jnp.asarray(0, jnp.int32)),
                            jnp.asarray(X), jnp.asarray(y), cfg_j)
    st = linear.train_step(linear.state_from_numpy(w, 0, "cpu"), t(X), t(y), cfg_t)
    np.testing.assert_allclose(st.w.numpy(), np.asarray(sj.w), **LIN)
    np.testing.assert_allclose(linear.predict_margin(st.w, t(X)).numpy(),
                               np.asarray(jlinear.predict_margin(sj.w, jnp.asarray(X))), **LIN)


def test_linear_apply_grad_leaves_the_bias_unpenalized():
    cfg = linear.LinearConfig(n_features=2, learning_rate=1.0, reg_lambda=0.5)
    state = linear.state_from_numpy([2.0, 2.0, 2.0], 0, "cpu")
    out = linear.apply_grad(state, t(np.array([0, 0, 0, 1], np.float32)), cfg)
    np.testing.assert_array_equal(out.w.numpy(), [1.0, 1.0, 2.0])


@pytest.mark.parametrize("objective", W.OBJECTIVES)
def test_linear_fit_matches_jax(objective):
    X, y = W.make_classif()
    jm = jlinear.LinearModel(n_steps=40, objective=objective).fit(X, y)
    tm = linear.LinearModel(device="cpu", n_steps=40, objective=objective).fit(X, y)
    np.testing.assert_allclose(tm.w, jm.w, **LIN)
    np.testing.assert_allclose(tm.predict_margin(X), jm.predict_margin(X), **LIN)
    if objective == "logistic":
        assert (tm.predict(X) == y).mean() > 0.95  # tests/test_models.py's bar
        assert (tm.predict(X) != jm.predict(X)).sum() <= 1
    # resuming from JAX's state after 20 steps ends where JAX ends
    mid = jlinear.LinearModel(n_steps=20, objective=objective).fit(X, y).state
    start = linear.state_from_numpy(np.asarray(mid.w), int(mid.step), "cpu")
    tr = linear.LinearModel(device="cpu", n_steps=40, objective=objective).fit(
        X, y, start=start, start_step=20)
    np.testing.assert_allclose(tr.w, jm.w, **LIN)
    assert int(tr.state.step) == 40


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("objective", W.OBJECTIVES)
def test_linear_dp_matches_jax(runs, world, objective):
    X, y = W.make_classif()
    cfg = jlinear.LinearConfig(n_features=X.shape[1], objective=objective,
                               n_steps=W.DP_STEPS)
    mesh = rp.create_mesh(("dp",), devices=jax.devices()[:world])
    dstep = jax.jit(jax.shard_map(
        functools.partial(jlinear.train_step_dp, cfg=cfg), mesh=mesh,
        in_specs=(jlinear.LinearState(P(), P()), P("dp", None), P("dp")),
        out_specs=jlinear.LinearState(P(), P()), check_vma=False))
    state = jlinear.init_state(cfg)
    for _ in range(cfg.n_steps):
        state = dstep(state, jnp.asarray(X), jnp.asarray(y))
    got = every_rank(runs[world], f"linear_dp/{objective}")
    np.testing.assert_allclose(got, np.asarray(state.w), **LIN)
    assert int(every_rank(runs[world], f"linear_dp_step/{objective}")) == W.DP_STEPS


@pytest.mark.parametrize("world", WORLDS)
def test_linear_engine_hook_matches_single(runs, world):
    X, y = W.make_classif(n=1200)
    single = linear.LinearModel(device="cpu", n_steps=W.HOOK_STEPS).fit(X, y)
    np.testing.assert_allclose(every_rank(runs[world], "linear_hook"), single.w, **LIN_HOOK)


# -- k-means -----------------------------------------------------------------------


def test_kmeans_pieces_match_jax():
    X, _ = W.make_blobs()
    C = X[[3, 200, 700, 900, 1400]].copy()
    C[4] = 1e3  # a cluster no row is nearest to: update keeps it
    aj = np.asarray(jkmeans.assign(jnp.asarray(X), jnp.asarray(C)))
    at = kmeans.assign(t(X), t(C)).numpy()
    assert at.dtype == np.int32 and at.shape == (len(X),)
    W.assign_flips(X, C, at, aj)
    assert (at == 4).sum() == 0

    sj = np.asarray(jkmeans.local_stats(jnp.asarray(X), jnp.asarray(C)))
    st = kmeans.local_stats(t(X), t(C)).numpy()
    assert st.shape == (5, X.shape[1] + 1)
    if (at == aj).all():
        np.testing.assert_allclose(st, sj, **KM)
    np.testing.assert_array_equal(st[:, -1], np.bincount(at, minlength=5))
    np.testing.assert_allclose(kmeans.update(t(C), t(sj)).numpy(),
                               np.asarray(jkmeans.update(jnp.asarray(C), jnp.asarray(sj))), **KM)
    assert (kmeans.update(t(C), t(sj)).numpy()[4] == C[4]).all()
    np.testing.assert_allclose(float(kmeans.inertia(t(X), t(C))),
                               float(jkmeans.inertia(jnp.asarray(X), jnp.asarray(C))), **KM)


def test_kmeans_assign_breaks_exact_ties_to_the_first():
    X = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    C = np.array([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0]], np.float32)
    np.testing.assert_array_equal(kmeans.assign(t(X), t(C)).numpy(),
                                  np.asarray(jkmeans.assign(jnp.asarray(X), jnp.asarray(C))))
    assert kmeans.assign(t(X), t(C)).tolist() == [0, 0]


def test_kmeans_fit_matches_jax():
    X, true_centers = W.make_blobs()
    jm = jkmeans.KMeans(n_clusters=5, n_iters=30, seed=3).fit(X)
    tm = kmeans.KMeans(n_clusters=5, n_iters=30, seed=3, device="cpu").fit(X)
    np.testing.assert_allclose(tm.centers, jm.centers, **KM)
    W.assign_flips(X, tm.centers, tm.predict(X), jm.predict(X))
    np.testing.assert_allclose(tm.inertia(X), jm.inertia(X), **KM)
    # tests/test_models.py's bar: every true center has a learned one nearby
    d = np.linalg.norm(true_centers[:, None, :] - tm.centers[None, :, :], axis=-1)
    assert d.min(axis=1).max() < 1.0
    # a resumed fit ends where the whole one does
    mid = kmeans.KMeans(n_clusters=5, n_iters=12, seed=3, device="cpu").fit(X).centers
    rest = kmeans.KMeans(n_clusters=5, n_iters=30, device="cpu").fit(
        X, init_centers=mid, start_iter=12)
    np.testing.assert_array_equal(rest.centers, tm.centers)


@pytest.mark.parametrize("world", WORLDS)
def test_kmeans_dp_matches_jax(runs, world):
    X, _ = W.make_blobs(n=1600)
    mesh = rp.create_mesh(("dp",), devices=jax.devices()[:world])
    dit = jax.jit(jax.shard_map(jkmeans.train_iter_dp, mesh=mesh,
                                in_specs=(P(), P("dp", None)), out_specs=P(),
                                check_vma=False))
    centers = jnp.asarray(X[:6])
    for _ in range(W.DP_ITERS):
        centers = dit(centers, jnp.asarray(X))
    np.testing.assert_allclose(every_rank(runs[world], "kmeans_dp"), np.asarray(centers), **KM)


@pytest.mark.parametrize("world", WORLDS)
def test_kmeans_engine_hook_matches_single(runs, world):
    X, _ = W.make_blobs(n=1200)
    single = kmeans.KMeans(4, W.HOOK_ITERS, device="cpu").fit(X, init_centers=X[:4])
    np.testing.assert_allclose(every_rank(runs[world], "kmeans_hook"), single.centers,
                               **KM_HOOK)


def test_kmeans_distributed_fit_needs_agreed_init():
    X, _ = W.make_blobs(n=200)
    hook = lambda v: v
    with pytest.raises(ValueError) as jerr:
        jkmeans.KMeans(3, engine_allreduce=hook).fit(X)
    with pytest.raises(ValueError) as terr:
        kmeans.KMeans(3, engine_allreduce=hook, device="cpu").fit(X)
    assert str(terr.value) == str(jerr.value)


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = W.make_classif(n=64)
    cfg = linear.LinearConfig(n_features=X.shape[1])
    for call in (lambda: linear.init_state(cfg),
                 lambda: linear.state_from_numpy(np.zeros(7), 0),
                 lambda: linear.LinearModel().fit(X, y),
                 lambda: kmeans.KMeans(3).fit(X)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- tests/test_models.py's learning checks, on the port ---------------------------------

def test_linear_learns():
    rng = np.random.RandomState(0)
    X = rng.randn(1600, 6).astype(np.float32)
    w = rng.randn(6).astype(np.float32)
    y = (X @ w + 0.3 > 0).astype(np.float32)
    m = linear.LinearModel(n_steps=80, device="cpu").fit(X, y)
    assert (m.predict(X) == y).mean() > 0.95


def test_kmeans_recovers_blobs():
    rng = np.random.RandomState(1)
    centers = rng.randn(5, 4).astype(np.float32) * 6
    X = centers[rng.randint(0, 5, size=1500)] + rng.randn(1500, 4).astype(np.float32)
    km = kmeans.KMeans(n_clusters=5, n_iters=30, seed=3, device="cpu").fit(X)
    d = np.linalg.norm(centers[:, None, :] - km.centers[None, :, :], axis=-1)
    assert d.min(axis=1).max() < 1.0, d.min(axis=1)  # a centroid near every center
    assert km.predict(X).shape == (len(X),)
    assert km.inertia(X) / len(X) < 2 * X.shape[1]
