"""The port's GBDT (rabit_tpu_torch.models.gbdt) against the JAX package's.

Inputs come from numpy seeds and go through both packages; the JAX fused
round runs its Pallas kernels in the interpreter.  Split tables must be
equal.  Leaves and margins agree within rtol=1e-4, atol=1e-5 in bf16 mode
and rtol=1e-3, atol=1e-4 in i8 mode: torch's and XLA's sigmoid may differ
by an ulp, which can move an i8 plane by one fixed-point step.
"""

import functools
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu.models import gbdt as jgbdt
from rabit_tpu.ops import boost as jboost
from rabit_tpu_torch.models import gbdt as tgbdt
from rabit_tpu_torch.ops import boost as tboost
from rabit_tpu_torch.ops import hist as thist

N, F, B, BLOCK = 600, 5, 16, 256


def _data(seed=3):
    rng = np.random.RandomState(seed)
    xb = rng.randint(0, B, size=(N, F)).astype(np.int32)
    y = rng.randint(0, 2, size=N).astype(np.float32)
    return xb, y


def _tol(mxu_i8):
    return dict(rtol=1e-3, atol=1e-4) if mxu_i8 else dict(rtol=1e-4, atol=1e-5)


def _assert_same_forest(got, ref, mxu_i8):
    np.testing.assert_array_equal(got.feature, np.asarray(ref.feature))
    np.testing.assert_array_equal(got.threshold, np.asarray(ref.threshold))
    np.testing.assert_allclose(got.leaf, np.asarray(ref.leaf), **_tol(mxu_i8))


@functools.lru_cache(maxsize=None)
def _jax_fused(mxu_i8, fused_final):
    """Three JAX fused rounds (cached: several tests compare against them)."""
    xb, y = _data()
    cfg = jgbdt.GBDTConfig(n_features=F, n_trees=3, depth=3, n_bins=B,
                           mxu_i8=mxu_i8, fused_final=fused_final)
    xb3, _ = jboost.block_rows(jnp.asarray(xb), BLOCK)
    s = jgbdt.init_state(cfg, N)
    step = functools.partial(jgbdt.train_round_fused, cfg=cfg, interpret=True)
    for _ in range(cfg.n_trees):
        s = step(s, xb3, jnp.asarray(y))
    return jax.tree.map(np.asarray, s)


@pytest.mark.parametrize("fused_final", [False, True])
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_train_round_fused_matches_jax(mxu_i8, fused_final):
    xb, y = _data()
    cfg = tgbdt.GBDTConfig(n_features=F, n_trees=3, depth=3, n_bins=B,
                           mxu_i8=mxu_i8, fused_final=fused_final)
    xb3, _ = tboost.block_rows(torch.as_tensor(xb), BLOCK)
    s = tgbdt.init_state(cfg, N, "cpu")
    for _ in range(cfg.n_trees):
        s = tgbdt.train_round_fused(s, xb3, torch.as_tensor(y), cfg)
    ref = _jax_fused(mxu_i8, fused_final)
    assert s.round == 3
    _assert_same_forest(tgbdt.forest_to_numpy(s.forest), ref.forest, mxu_i8)
    np.testing.assert_allclose(s.margin.numpy(), ref.margin, **_tol(mxu_i8))


def _depth14_data():
    rng = np.random.RandomState(14)
    n, n_feat = 512, 3
    xb = rng.randint(0, B, size=(n, n_feat)).astype(np.int32)
    y = rng.randint(0, 2, size=n).astype(np.float32)
    return xb, y


@functools.lru_cache(maxsize=None)
def _jax_depth14():
    """JAX's exact-f32 train_round at depth 14 from a zero margin (cached:
    five cases compare against it)."""
    xb, y = _depth14_data()
    cfg = jgbdt.GBDTConfig(n_features=xb.shape[1], n_trees=1, depth=14, n_bins=B)
    step = jax.jit(functools.partial(jgbdt.train_round, cfg=cfg))
    s = step(jgbdt.init_state(cfg, xb.shape[0]), jnp.asarray(xb), jnp.asarray(y))
    return jax.tree.map(np.asarray, s)


@pytest.mark.parametrize("fused,mxu_i8,fused_final", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, False, True), (True, True, True)],
    ids=["exact", "fused-bf16", "fused-i8", "fused_final-bf16", "fused_final-i8"])
def test_depth14_round_matches_jax(fused, mxu_i8, fused_final):
    """A depth-14 round (a last histogram of 8192 nodes, more than the
    card's shared-memory partition holds) on the CPU, the port's fused
    round in both encodings and both final passes and its exact
    train_round, against JAX's exact train_round.  One round from a zero
    margin: g = +-0.5 and h = 0.25 are exact in both encodings and sum
    exactly in any order, so the forest and the margin are equal."""
    xb, y = _depth14_data()
    n, n_feat = xb.shape
    cfg = tgbdt.GBDTConfig(n_features=n_feat, n_trees=1, depth=14, n_bins=B,
                           mxu_i8=mxu_i8, fused_final=fused_final)
    xt, yt = torch.as_tensor(xb), torch.as_tensor(y)
    s0 = tgbdt.init_state(cfg, n, "cpu")
    got = (tgbdt.train_round_fused(s0, tboost.block_rows(xt, BLOCK)[0], yt, cfg)
           if fused else tgbdt.train_round(s0, xt, yt, cfg))
    ref = _jax_depth14()
    for a, b in zip(tgbdt.forest_to_numpy(got.forest), ref.forest):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got.margin.numpy(), ref.margin)


def test_train_round_matches_jax():
    xb, y = _data(7)
    cfg_j = jgbdt.GBDTConfig(n_features=F, n_trees=3, depth=3, n_bins=B)
    cfg_t = tgbdt.GBDTConfig(n_features=F, n_trees=3, depth=3, n_bins=B)
    sj = jgbdt.init_state(cfg_j, N)
    st = tgbdt.init_state(cfg_t, N, "cpu")
    step = jax.jit(functools.partial(jgbdt.train_round, cfg=cfg_j))
    for _ in range(3):
        sj = step(sj, jnp.asarray(xb), jnp.asarray(y))
        st = tgbdt.train_round(st, torch.as_tensor(xb), torch.as_tensor(y), cfg_t)
    _assert_same_forest(tgbdt.forest_to_numpy(st.forest), sj.forest, False)
    np.testing.assert_allclose(st.margin.numpy(), np.asarray(sj.margin),
                               rtol=1e-4, atol=1e-5)


def test_gbdt_fit_predict_matches_jax():
    rng = np.random.RandomState(0)
    X = rng.randn(N, F).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + 0.5 * (X[:, 2] > 0.3) > 0).astype(np.float32)
    hyper = dict(n_trees=3, depth=3, n_bins=B)
    jm = jgbdt.GBDT(**hyper).fit(X, y)
    tm = tgbdt.GBDT(device="cpu", **hyper).fit(X, y)
    np.testing.assert_array_equal(tm.edges, jm.edges)
    _assert_same_forest(tgbdt.forest_to_numpy(tm.forest), jm.forest, False)
    np.testing.assert_allclose(tm.predict_margin(X), jm.predict_margin(X),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
    np.testing.assert_allclose(tm.predict_proba(X), jm.predict_proba(X),
                               rtol=1e-4, atol=1e-5)


def test_quantize_matches_jax():
    rng = np.random.RandomState(4)
    X = rng.randn(N, F).astype(np.float32)
    edges = tgbdt.compute_bin_edges(X, B)
    np.testing.assert_array_equal(edges, jgbdt.compute_bin_edges(X, B))
    ref = np.asarray(jgbdt.quantize(jnp.asarray(X), jnp.asarray(edges)))
    got = tgbdt.quantize(torch.as_tensor(X), torch.as_tensor(edges))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_forest_carries_across():
    """A JAX-trained forest predicts the same in the port, and a JAX
    training state continues for one more fused round in both packages."""
    ref = _jax_fused(False, False)
    xb, y = _data()
    cfg_t = tgbdt.GBDTConfig(n_features=F, n_trees=3, depth=3, n_bins=B)
    forest = tgbdt.forest_from_numpy(ref.forest, "cpu")
    got = tgbdt.predict_margin(forest, torch.as_tensor(xb), cfg_t)
    cfg_j = jgbdt.GBDTConfig(n_features=F, n_trees=3, depth=3, n_bins=B)
    want = jgbdt.predict_margin(jax.tree.map(jnp.asarray, ref.forest),
                                jnp.asarray(xb), cfg_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tgbdt.forest_to_numpy(forest).leaf, ref.forest.leaf)

    # continue a warm state (2 of 4 trees built) for one more round
    cfg_j4, cfg_t4 = cfg_j._replace(n_trees=4), cfg_t._replace(n_trees=4)
    warm = jgbdt.init_state(cfg_j4, N)
    xb3j, _ = jboost.block_rows(jnp.asarray(xb), BLOCK)
    step = functools.partial(jgbdt.train_round_fused, cfg=cfg_j4, interpret=True)
    for _ in range(2):
        warm = step(warm, xb3j, jnp.asarray(y))
    warm_np = jax.tree.map(np.asarray, warm)
    sj = step(warm, xb3j, jnp.asarray(y))
    st = tgbdt.state_from_numpy(warm_np, "cpu")
    assert st.round == 2
    xb3t, _ = tboost.block_rows(torch.as_tensor(xb), BLOCK)
    st = tgbdt.train_round_fused(st, xb3t, torch.as_tensor(y), cfg_t4)
    _assert_same_forest(tgbdt.forest_to_numpy(st.forest), sj.forest, False)
    np.testing.assert_allclose(st.margin.numpy(), np.asarray(sj.margin),
                               rtol=1e-4, atol=1e-5)


def test_no_valid_split_picks_index_zero():
    """All gains -inf (min_child_weight above every hessian mass): both
    argmaxes take index 0."""
    rng = np.random.RandomState(8)
    hist = rng.rand(2, F, B, 2).astype(np.float32)
    cfg_j = jgbdt.GBDTConfig(n_features=F, n_bins=B, min_child_weight=1e9)
    cfg_t = tgbdt.GBDTConfig(n_features=F, n_bins=B, min_child_weight=1e9)
    fj, tj, gj = jgbdt.best_splits(jnp.asarray(hist), cfg_j)
    ft, tt, gt = tgbdt.best_splits(torch.as_tensor(hist), cfg_t)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    assert ft.tolist() == [0, 0] and tt.tolist() == [0, 0]
    assert np.isneginf(gt.numpy()).all() and np.isneginf(np.asarray(gj)).all()


def test_split_child_masses_matches_jax():
    rng = np.random.RandomState(9)
    hist = rng.randn(4, F, B, 2).astype(np.float32)
    feat = rng.randint(0, F, size=4).astype(np.int32)
    thr = rng.randint(0, B, size=4).astype(np.int32)
    ref = jgbdt.split_child_masses(jnp.asarray(hist), jnp.asarray(feat), jnp.asarray(thr))
    got = tgbdt.split_child_masses(torch.as_tensor(hist), torch.as_tensor(feat),
                                   torch.as_tensor(thr))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_scatter_histogram_matches_jax():
    from rabit_tpu.ops import hist as jhist

    rng = np.random.RandomState(1)
    n, nn = 500, 4
    xb = rng.randint(0, B, size=(n, F)).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    h = rng.rand(n).astype(np.float32)
    node = rng.randint(0, nn, size=n).astype(np.int32)
    ref = jhist.node_histograms_scatter(*map(jnp.asarray, (xb, g, h, node)), nn, B)
    got = thist.node_histograms(*map(torch.as_tensor, (xb, g, h, node)), nn, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_hist_dispatcher_refuses_other_devices():
    meta = torch.empty((4, F), dtype=torch.int32, device="meta")
    v = torch.empty(4, device="meta")
    with pytest.raises(NotImplementedError, match="no histogram for device meta"):
        thist.node_histograms(meta, v, v, v.int(), 1, B)


def test_cuda_without_a_card_raises():
    """No silent CPU: asking for CUDA where there is no card raises."""
    if torch.cuda.is_available():
        assert tgbdt.GBDT(device="cuda").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgbdt.GBDT(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgbdt.GBDT()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgbdt.init_state(tgbdt.GBDTConfig(n_features=F), N)


def test_port_imports_no_jax():
    """Importing the port and every module of it, chip_smoke.py, the
    workers of the port's own engine, tools/torch_trace_tool.py,
    tools/torch_scale_sweep.py, tools/torch_delivery_bench.py and
    tools/torch_service_bench.py leaves jax and rabit_tpu out of sys.modules
    (rabit_tpu_torch itself shares the prefix)."""
    code = (
        "import sys, pkgutil, importlib, rabit_tpu_torch\n"
        "for m in pkgutil.walk_packages(rabit_tpu_torch.__path__, 'rabit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import importlib.util\n"
        "for w in ('workers/torch_recover_worker', 'workers/torch_gbdt_native_worker',\n"
        "          'workers/torch_elastic_worker', 'workers/torch_diag_job',\n"
        "          '../tools/torch_trace_tool', '../tools/torch_scale_sweep',\n"
        "          '../tools/torch_delivery_bench', '../tools/torch_service_bench'):\n"
        "    spec = importlib.util.spec_from_file_location(w.split('/')[-1], f'tests/{w}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'rabit_tpu' or m.startswith('rabit_tpu.')]\n"
        "for m in ('rabit_tpu_torch.models.gbdt', 'rabit_tpu_torch.ops.hist',\n"
        "          'rabit_tpu_torch.elastic', 'rabit_tpu_torch.api',\n"
        "          'rabit_tpu_torch.engine.torch_dist', 'torch.distributed',\n"
        "          'rabit_tpu_torch.compress', 'rabit_tpu_torch.compress.codecs',\n"
        "          'rabit_tpu_torch.compress.transport', 'rabit_tpu_torch.sched',\n"
        "          'rabit_tpu_torch.parallel', 'rabit_tpu_torch.parallel.collectives',\n"
        "          'rabit_tpu_torch.engine.fused', 'rabit_tpu_torch.profile',\n"
        "          'rabit_tpu_torch.models.linear', 'rabit_tpu_torch.models.kmeans',\n"
        "          'rabit_tpu_torch.parallel.ring', 'rabit_tpu_torch.fusion',\n"
        "          'rabit_tpu_torch.store', 'rabit_tpu_torch.engine.native',\n"
        "          'rabit_tpu_torch.tracker.protocol', 'rabit_tpu_torch.tracker.tracker',\n"
        "          'rabit_tpu_torch.tracker.launcher', 'rabit_tpu_torch.obs',\n"
        "          'rabit_tpu_torch.obs.events', 'rabit_tpu_torch.obs.metrics',\n"
        "          'rabit_tpu_torch.obs.ship', 'rabit_tpu_torch.obs.stream',\n"
        "          'rabit_tpu_torch.obs.trace', 'rabit_tpu_torch.elastic.client',\n"
        "          'rabit_tpu_torch.elastic.membership',\n"
        "          'rabit_tpu_torch.elastic.rebalance', 'rabit_tpu_torch.obs.critical',\n"
        "          'rabit_tpu_torch.obs.diagnose', 'rabit_tpu_torch.obs.top',\n"
        "          'rabit_tpu_torch.sched.repair', 'rabit_tpu_torch.chaos',\n"
        "          'rabit_tpu_torch.quorum', 'rabit_tpu_torch.quorum.policy',\n"
        "          'rabit_tpu_torch.quorum.table', 'rabit_tpu_torch.ha',\n"
        "          'rabit_tpu_torch.ha.state', 'rabit_tpu_torch.ha.journal',\n"
        "          'rabit_tpu_torch.ha.standby', 'rabit_tpu_torch.ha.__main__',\n"
        "          'rabit_tpu_torch.relay', 'rabit_tpu_torch.relay.__main__',\n"
        "          'rabit_tpu_torch.delivery', 'rabit_tpu_torch.service',\n"
        "          'rabit_tpu_torch.service.service', 'rabit_tpu_torch.service.registry',\n"
        "          'rabit_tpu_torch.service.state', 'rabit_tpu_torch.service.pool'):\n"
        "    assert m in sys.modules, m\n"
        "from rabit_tpu_torch.models import gbdt\n"
        "assert callable(gbdt.train_round_dp) and callable(gbdt.train_round_dp_fused)\n"
        "assert callable(gbdt.train_round_hybrid)\n"
        "print(bad)\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=root)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


# -- tests/test_gbdt.py's learning checks, on the port ----------------------------------

def _synth(n=2000, f=10, seed=0):
    """tests/test_gbdt.py's make_synth: interactions and a threshold."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    logits = X[:, 0] * X[:, 1] + np.sin(X[:, 2] * 2) + 0.5 * (X[:, 3] > 0.3)
    return X, (logits > 0).astype(np.float32)


def test_gbdt_learns():
    X, y = _synth()
    model = tgbdt.GBDT(n_trees=15, depth=4, n_bins=64, learning_rate=0.4,
                       device="cpu").fit(X, y)
    acc = (model.predict(X) == y).mean()
    assert acc > 0.93, f"train accuracy {acc}"


def test_gbdt_squared_objective():
    rng = np.random.RandomState(1)
    X = rng.randn(500, 5).astype(np.float32)
    y = (2 * X[:, 0] - X[:, 1]).astype(np.float32)
    model = tgbdt.GBDT(n_trees=20, depth=3, n_bins=64, objective="squared",
                       learning_rate=0.5, device="cpu").fit(X, y)
    mse = float(np.mean((model.predict(X) - y) ** 2))
    assert mse < 0.4, f"mse {mse}"


def test_predict_mid_training_zero_trees():
    cfg = tgbdt.GBDTConfig(n_features=4, n_trees=3, depth=3)
    forest = tgbdt.init_forest(cfg, device="cpu")
    out = tgbdt.predict_margin(forest, torch.zeros((7, 4), dtype=torch.int32), cfg)
    np.testing.assert_array_equal(out.numpy(), np.zeros(7))
