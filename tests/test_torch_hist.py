"""The port's histograms and leaf fit (rabit_tpu_torch.ops.hist,
ops.boost.leaf_fit) against the JAX package's, on the CPU.

The same numpy inputs go through both.  The kernels' plain twins are held
against the Pallas kernels run in the interpreter at rtol = atol = 1e-5:
the encodings are the same, only the f32 summation order may differ.  The
one-hot contractions and the dispatchers use tests/test_gbdt.py's
tolerances (1e-5; bf16 1e-4 and i8 2e-2 against the exact scatter).  The
CUDA kernels are held against these plain twins in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu.ops import boost as jboost
from rabit_tpu.ops import hist as jhist
from rabit_tpu_torch.ops import boost as tboost
from rabit_tpu_torch.ops import hist as thist

F, B = 5, 16


def _inputs(n, n_nodes, seed):
    rng = np.random.RandomState(seed)
    return dict(xb=rng.randint(0, B, size=(n, F)).astype(np.int32),
                g=rng.randn(n).astype(np.float32),
                h=rng.rand(n).astype(np.float32),
                node=rng.randint(0, n_nodes, size=n).astype(np.int32))


def _args(x, lib):
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return [conv(x[k]) for k in ("xb", "g", "h", "node")]


@pytest.mark.parametrize("n,n_nodes", [(512, 4), (600, 4), (300, 7)])
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_node_histograms_kernel_plain_matches_pallas(mxu_i8, n, n_nodes):
    """600 and 300 rows leave a short last block of 256 (JAX pads it)."""
    x = _inputs(n, n_nodes, seed=n + n_nodes)
    ref = jhist.node_histograms_pallas(*_args(x, "jax"), n_nodes, B,
                                       block_rows=256, interpret=True,
                                       mxu_i8=mxu_i8)
    got = thist.node_histograms_kernel_plain(*_args(x, "torch"), n_nodes, B,
                                             block_rows=256, mxu_i8=mxu_i8)
    assert got.shape == (n_nodes, F, B, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # on a CPU tensor the kernel's wrapper is its plain twin
    same = thist.node_histograms_kernel(*_args(x, "torch"), n_nodes, B,
                                        block_rows=256, mxu_i8=mxu_i8)
    assert torch.equal(same, got)


@pytest.mark.parametrize("mxu_i8", [False, True])
def test_node_histograms_kernel_plain_ignores_foreign_node_ids(mxu_i8):
    """Node ids outside [0, n_nodes) add nothing, as in the Pallas kernel's
    gradient matrix, and (i8) leave the block scale alone: the largest |g|
    belongs to a foreign row."""
    x = _inputs(600, 3, seed=5)
    x["node"][::7] = 3
    x["node"][::11] = -1
    x["g"][::7] *= 4.0
    ref = jhist.node_histograms_pallas(*_args(x, "jax"), 3, B, block_rows=256,
                                       interpret=True, mxu_i8=mxu_i8)
    got = thist.node_histograms_kernel_plain(*_args(x, "torch"), 3, B,
                                             block_rows=256, mxu_i8=mxu_i8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_node_histograms_onehot_matches_jax():
    x = _inputs(500, 4, seed=1)
    ref = jhist.node_histograms_onehot(*_args(x, "jax"), 4, B, block_rows=256)
    got = thist.node_histograms_onehot(*_args(x, "torch"), 4, B, block_rows=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,segs", [(500, 4), (1000, 16)])
def test_segment_sum_matmul_matches_jax(n, segs):
    rng = np.random.RandomState(n)
    vals = rng.randn(n, 2).astype(np.float32)
    seg = rng.randint(0, segs, size=n).astype(np.int32)
    ref = jhist.segment_sum_matmul(jnp.asarray(vals), jnp.asarray(seg), segs,
                                   block_rows=256)
    got = thist.segment_sum_matmul(torch.as_tensor(vals), torch.as_tensor(seg),
                                   segs, block_rows=256)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl,tol", [(None, 0.0), ("scatter", 0.0),
                                      ("onehot", 1e-5), ("pallas", 1e-4),
                                      ("pallas_i8", 2e-2)])
def test_hist_dispatcher_matches_jax(impl, tol):
    """Each impl against the JAX package's same impl (the default is the
    exact scatter on the CPU in both; JAX's Pallas kernels run in the
    interpreter), and against the exact scatter at tests/test_gbdt.py's
    tolerance."""
    x = _inputs(500, 4, seed=1)
    if impl in ("pallas", "pallas_i8"):
        ref = jhist.node_histograms_pallas(*_args(x, "jax"), 4, B, interpret=True,
                                           mxu_i8=impl == "pallas_i8")
    else:
        ref = jhist.node_histograms(*_args(x, "jax"), 4, B, impl=impl or "scatter")
    ref = np.asarray(ref)
    got = thist.node_histograms(*_args(x, "torch"), 4, B, impl=impl).numpy()
    exact = np.asarray(jhist.node_histograms_scatter(*_args(x, "jax"), 4, B))
    if tol == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, exact, rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", [None, "scatter", "matmul"])
def test_segment_sum_dispatcher_matches_jax(impl):
    rng = np.random.RandomState(2)
    vals = rng.randn(500, 2).astype(np.float32)
    seg = rng.randint(0, 8, size=500).astype(np.int32)
    ref = jhist.segment_sum(jnp.asarray(vals), jnp.asarray(seg), 8,
                            impl=impl or "scatter")
    got = thist.segment_sum(torch.as_tensor(vals), torch.as_tensor(seg), 8,
                            impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_dispatchers_refuse_unknown_impl_and_device():
    x = _inputs(64, 2, seed=0)
    with pytest.raises(ValueError, match="unknown hist impl"):
        thist.node_histograms(*_args(x, "torch"), 2, B, impl="mxu")
    v = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="unknown segment_sum impl"):
        thist.segment_sum(v, torch.zeros(4, dtype=torch.int32), 2, impl="mxu")
    with pytest.raises(NotImplementedError, match="no histogram for device meta"):
        thist.segment_sum(v.to("meta"), torch.zeros(4, dtype=torch.int32,
                                                    device="meta"), 2)


@pytest.mark.parametrize("depth", [1, 2, 3, 8, 13])
def test_leaf_fit_plain_matches_jax(depth):
    rng = np.random.RandomState(30 + depth)
    n, R = 600, 256
    xb3, _ = jboost.block_rows(jnp.asarray(rng.randint(0, B, size=(n, F)),
                                           jnp.int32), R)
    g3, _ = jboost.block_rows(jnp.asarray(rng.randn(n), jnp.float32), R)
    h3, _ = jboost.block_rows(jnp.asarray(rng.rand(n), jnp.float32), R)
    n_prev = 2 ** (depth - 1)
    node3 = rng.randint(0, n_prev, size=g3.shape).astype(np.int32)
    feat = rng.randint(0, F, size=n_prev).astype(np.int32)
    thr = rng.randint(0, B, size=n_prev).astype(np.int32)
    arrs = [np.array(a) for a in (xb3, node3, g3, h3, feat, thr)]
    ref_gh, ref_node = jboost.leaf_fit(*map(jnp.asarray, arrs), depth=depth,
                                       interpret=True)
    got_gh, got_node = tboost.leaf_fit(*map(torch.as_tensor, arrs), depth=depth)
    assert got_gh.shape == (2 ** depth, 2) and got_node.dtype == torch.int32
    np.testing.assert_array_equal(got_node.numpy(), np.asarray(ref_node))
    np.testing.assert_allclose(got_gh.numpy(), np.asarray(ref_gh), rtol=1e-5,
                               atol=1e-5)
    # the leaf masses are the routed rows' (g, h) sums
    leaf = got_node.numpy().reshape(-1)
    direct = np.zeros((2 ** depth, 2))
    np.add.at(direct[:, 0], leaf, np.asarray(g3).reshape(-1))
    np.add.at(direct[:, 1], leaf, np.asarray(h3).reshape(-1))
    np.testing.assert_allclose(got_gh.numpy(), direct, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("depth", [3, 9])
def test_leaf_fit_plain_at_128_row_blocks_matches_jax(depth):
    """Row blocks of 128 rows (the card's block kernels then leave half
    their threads without a row): the plain version against JAX's leaf_fit
    in the interpreter."""
    rng = np.random.RandomState(128 + depth)
    nb, R, n_prev = 5, 128, 2 ** (depth - 1)
    arrs = [rng.randint(0, B, size=(nb, R, F)).astype(np.int32),
            rng.randint(0, n_prev, size=(nb, R, 1)).astype(np.int32),
            rng.randn(nb, R, 1).astype(np.float32),
            rng.rand(nb, R, 1).astype(np.float32),
            rng.randint(0, F, size=n_prev).astype(np.int32),
            rng.randint(0, B, size=n_prev).astype(np.int32)]
    ref_gh, ref_node = jboost.leaf_fit(*map(jnp.asarray, arrs), depth=depth,
                                       interpret=True)
    got_gh, got_node = tboost.leaf_fit(*map(torch.as_tensor, arrs), depth=depth)
    np.testing.assert_array_equal(got_node.numpy(), np.asarray(ref_node))
    np.testing.assert_allclose(got_gh.numpy(), np.asarray(ref_gh), rtol=1e-5, atol=1e-5)
