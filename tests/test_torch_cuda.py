"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports no JAX (the machine with the card has none), so it runs
there on its own (the native engine's tests run its workers under the
port's launcher; the unfused compressed path's test spawns two gloo
processes sharing the card):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu

The plain versions themselves are held against the JAX package on the CPU
in test_torch_boost.py, test_torch_gbdt.py, test_torch_hist.py and
test_torch_dp.py.  Tolerances: histograms and leaf masses rtol=1e-5,
atol=1e-5 against the plain twins (the kernel sums in another order); node
ids and margins exact; rounds on the card against the CPU's exact-f32
round as tests/test_gbdt.py holds the fused rounds.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rabit_tpu_torch.models import gbdt
from rabit_tpu_torch.ops import boost

N, F, B, BLOCK = 600, 5, 16, 256


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(seed, d, device):
    rng = np.random.RandomState(seed)
    n_prev = max(1, 2 ** (d - 1))
    blk = lambda a: boost.block_rows(torch.as_tensor(a, device=device), BLOCK)[0]
    xb3 = blk(rng.randint(0, B, size=(N, F)).astype(np.int32))
    g3 = blk(rng.randn(N).astype(np.float32))
    h3 = blk(rng.rand(N).astype(np.float32))
    t = lambda a: torch.as_tensor(a, device=device)
    return dict(
        xb3=xb3, g3=g3, h3=h3,
        node3=t(rng.randint(0, n_prev, size=tuple(g3.shape)).astype(np.int32)),
        feat=t(rng.randint(0, F, size=n_prev).astype(np.int32)),
        thr=t(rng.randint(0, B, size=n_prev).astype(np.int32)),
        leaf=t(rng.randn(2 ** max(d, 1)).astype(np.float32)),
        margin3=t(rng.randn(*g3.shape).astype(np.float32)))


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_hist_kernels_match_plain(cuda, mxu_i8):
    for d in range(0, 4):
        c = _inputs(20 + d, d, cuda)
        if d == 0:
            got = boost.hist_level0(c["xb3"], c["g3"], c["h3"], n_bins=B, mxu_i8=mxu_i8)
            ref = boost.hist_level0_plain(c["xb3"], c["g3"], c["h3"], n_bins=B,
                                          mxu_i8=mxu_i8)
        else:
            args = [c[k] for k in ("xb3", "node3", "g3", "h3", "feat", "thr")]
            got, gn = boost.hist_level(*args, depth=d, n_bins=B, mxu_i8=mxu_i8)
            ref, rn = boost.hist_level_plain(*args, depth=d, n_bins=B, mxu_i8=mxu_i8)
            assert torch.equal(gn, rn)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_hist_kernel_is_deterministic(cuda):
    c = _inputs(40, 3, cuda)
    args = [c[k] for k in ("xb3", "node3", "g3", "h3", "feat", "thr")]
    a = boost.hist_level(*args, depth=3, n_bins=B)[0]
    b = boost.hist_level(*args, depth=3, n_bins=B)[0]
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_route_kernels_match_plain(cuda):
    c = _inputs(30, 3, cuda)
    args = [c[k] for k in ("xb3", "node3", "feat", "thr")]
    assert torch.equal(boost.route_level(*args, depth=3),
                       boost.route_level_plain(*args, depth=3))
    keys = ("xb3", "node3", "margin3", "feat", "thr", "leaf")
    gm, gn = boost.route_margin_level(*(c[k] for k in keys), depth=3)
    rm, rn = boost.route_margin_level_plain(*(c[k] for k in keys), depth=3)
    assert torch.equal(gn, rn) and torch.equal(gm, rm)


def _route_inputs(seed, depth, nb, R, n_feat, device):
    """Final-pass inputs: node ids over all 2**(depth-1) parents, 256 bins."""
    rng = np.random.RandomState(seed)
    n_prev = 2 ** (depth - 1)
    t = lambda a: torch.as_tensor(a, device=device)
    return dict(
        xb3=t(rng.randint(0, 256, size=(nb, R, n_feat)).astype(np.int32)),
        node3=t(rng.randint(0, n_prev, size=(nb, R, 1)).astype(np.int32)),
        margin3=t(rng.randn(nb, R, 1).astype(np.float32)),
        feat=t(rng.randint(0, n_feat, size=n_prev).astype(np.int32)),
        thr=t(rng.randint(0, 256, size=n_prev).astype(np.int32)),
        leaf=t(rng.randn(2 * n_prev).astype(np.float32)))


def _check_route_kernels(c, depth):
    """Both route kernels, bit for bit against their plain versions."""
    keys = ("xb3", "node3", "margin3", "feat", "thr", "leaf")
    boost.launches.clear()
    got = boost.route_level(c["xb3"], c["node3"], c["feat"], c["thr"], depth=depth)
    gm, gn = boost.route_margin_level(*(c[k] for k in keys), depth=depth)
    assert dict(boost.launches) == {"route_level": 1, "route_margin_level": 1}
    ref = boost.route_level_plain(c["xb3"], c["node3"], c["feat"], c["thr"],
                                  depth=depth)
    rm, rn = boost.route_margin_level_plain(*(c[k] for k in keys), depth=depth)
    assert torch.equal(got, ref) and torch.equal(gn, rn)
    assert torch.equal(gm.view(torch.int32), rm.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 6, 8, 13, 16])
def test_route_kernels_match_plain_at_depth(cuda, depth):
    """Up to depth 16 (32,768 parents): the split and leaf tables are read
    from device memory, so no depth overflows a block's shared memory
    (tables staged there refused depth 13 with the margin)."""
    _check_route_kernels(_route_inputs(70 + depth, depth, 7, 1024, 28, cuda), depth)


@pytest.mark.gpu
def test_route_kernels_refuse_depths_past_int32_leaf_ids(cuda):
    c = _route_inputs(71, 1, 1, 256, 5, cuda)
    keys = ("xb3", "node3", "margin3", "feat", "thr", "leaf")
    with pytest.raises(ValueError, match="depths 1 to 31"):
        boost.route_level(c["xb3"], c["node3"], c["feat"], c["thr"], depth=32)
    with pytest.raises(ValueError, match="depths 1 to 31"):
        boost.route_margin_level(*(c[k] for k in keys), depth=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_feat", [1, 3, 28, 33])
@pytest.mark.parametrize("nb", [1, 2, 3])
def test_route_kernels_odd_shapes_match_plain(cuda, nb, n_feat):
    """nb x 333 rows (n_rows % 4 = 1, 2, 3: the last tile partly empty),
    odd feature counts, and node/margin tensors whose data start 4 bytes
    past a 16-byte boundary."""
    c = _route_inputs(90 + nb, 6, nb, 333, n_feat, cuda)
    _check_route_kernels(c, 6)
    for k in ("node3", "margin3"):
        buf = torch.empty(c[k].numel() + 1, dtype=c[k].dtype, device=cuda)
        shifted = buf[1:].view(c[k].shape)
        shifted.copy_(c[k])
        assert shifted.data_ptr() % 16 == 4
        c[k] = shifted
    _check_route_kernels(c, 6)


@pytest.mark.gpu
def test_route_kernels_bitwise_on_repeat(cuda):
    c = _route_inputs(95, 8, 300, 1024, 28, cuda)
    keys = ("xb3", "node3", "margin3", "feat", "thr", "leaf")
    first = boost.route_margin_level(*(c[k] for k in keys), depth=8)
    nodes = boost.route_level(c["xb3"], c["node3"], c["feat"], c["thr"], depth=8)
    for _ in range(3):
        m, n = boost.route_margin_level(*(c[k] for k in keys), depth=8)
        assert torch.equal(m.view(torch.int32), first[0].view(torch.int32))
        assert torch.equal(n, first[1])
        assert torch.equal(boost.route_level(c["xb3"], c["node3"], c["feat"],
                                             c["thr"], depth=8), nodes)


@pytest.mark.gpu
def test_depth13_fused_final_round_on_card_matches_cpu(cuda):
    """A depth-13 fused_final round (a last histogram of 4096 nodes, then
    route_margin_level over 4096 parents) on the card against the same
    round on the CPU.  One round from a zero margin: g = +-0.5 and h = 0.25
    sum exactly in any order, so the trees are equal."""
    rng = np.random.RandomState(13)
    n, n_feat, n_bins = 3000, 3, 8
    xb = rng.randint(0, n_bins, size=(n, n_feat)).astype(np.int32)
    y = rng.randint(0, 2, size=n).astype(np.float32)
    cfg = gbdt.GBDTConfig(n_features=n_feat, n_trees=1, depth=13, n_bins=n_bins,
                          fused_final=True)
    states = {}
    boost.launches.clear()
    for dev in ("cpu", cuda):
        xb3, _ = boost.block_rows(torch.as_tensor(xb, device=dev), BLOCK)
        s = gbdt.init_state(cfg, n, dev)
        states[str(dev)] = gbdt.train_round_fused(s, xb3, torch.as_tensor(y, device=dev),
                                                  cfg)
    assert dict(boost.launches) == {"hist_level0": 1, "hist_level": 12,
                                    "route_margin_level": 1}
    got, ref = states["cuda"], states["cpu"]
    for a, b in zip(gbdt.forest_to_numpy(got.forest), gbdt.forest_to_numpy(ref.forest)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.margin.cpu().numpy(), ref.margin.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("fused_final", [False, True])
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_fused_round_on_card_matches_cpu(cuda, mxu_i8, fused_final):
    """Three rounds on the card grow the trees the same round grows on the
    CPU through the plain versions."""
    rng = np.random.RandomState(3)
    xb = rng.randint(0, B, size=(N, F)).astype(np.int32)
    y = rng.randint(0, 2, size=N).astype(np.float32)
    cfg = gbdt.GBDTConfig(n_features=F, n_trees=3, depth=3, n_bins=B,
                          mxu_i8=mxu_i8, fused_final=fused_final)
    states = {}
    boost.launches.clear()
    for dev in ("cpu", cuda):
        xb3, _ = boost.block_rows(torch.as_tensor(xb, device=dev), BLOCK)
        s = gbdt.init_state(cfg, N, dev)
        for _ in range(cfg.n_trees):
            s = gbdt.train_round_fused(s, xb3, torch.as_tensor(y, device=dev), cfg)
        states[str(dev)] = gbdt.forest_to_numpy(s.forest)
    final = "route_margin_level" if fused_final else "route_level"
    assert dict(boost.launches) == {"hist_level0": 3, "hist_level": 6, final: 3}
    got, ref = states["cuda"], states["cpu"]
    np.testing.assert_array_equal(got.feature, ref.feature)
    np.testing.assert_array_equal(got.threshold, ref.threshold)
    np.testing.assert_allclose(got.leaf, ref.leaf, rtol=1e-4, atol=1e-5)


def _node_inputs(seed, n, n_nodes, n_bins, device):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(a, device=device)
    return (t(rng.randint(0, n_bins, size=(n, F)).astype(np.int32)),
            t(rng.randn(n).astype(np.float32)), t(rng.rand(n).astype(np.float32)),
            t(rng.randint(0, n_nodes, size=n).astype(np.int32)))


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_node_histograms_kernel_matches_plain(cuda, mxu_i8):
    """Given node ids, a short last row block (600 = 2 x 256 + 88), node
    counts from one to several groups of the grid (64 and 128 nodes of 256
    bins need more than one block's shared memory), and foreign ids."""
    from rabit_tpu_torch.ops import hist

    for seed, n_nodes, n_bins in ((1, 1, B), (2, 7, B), (3, 64, 256), (4, 128, 256)):
        xb, g, h, node = _node_inputs(seed, N, n_nodes, n_bins, cuda)
        node[::13] = n_nodes  # out of range: adds nothing
        boost.launches.clear()
        got = hist.node_histograms_kernel(xb, g, h, node, n_nodes, n_bins,
                                          block_rows=BLOCK, mxu_i8=mxu_i8)
        assert boost.launches["node_histograms_kernel"] == 1
        ref = hist.node_histograms_kernel_plain(xb, g, h, node, n_nodes, n_bins,
                                                block_rows=BLOCK, mxu_i8=mxu_i8)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_node_histograms_kernel_is_deterministic(cuda, mxu_i8):
    from rabit_tpu_torch.ops import hist

    xb, g, h, node = _node_inputs(5, 5000, 8, 256, cuda)
    a = hist.node_histograms_kernel(xb, g, h, node, 8, 256, mxu_i8=mxu_i8)
    b = hist.node_histograms_kernel(xb, g, h, node, 8, 256, mxu_i8=mxu_i8)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 3, 6, 8, 13, 16])
def test_leaf_fit_matches_plain(cuda, depth):
    """Depths 1-8 take the dense partial, 13 and 16 the compact records
    (2**depth > 2 x 256); the leaf ids exactly, the masses within the
    tolerance, and bitwise the same on repeat."""
    c = _inputs(50 + depth, depth, cuda)
    args = [c[k] for k in ("xb3", "node3", "g3", "h3", "feat", "thr")]
    boost.launches.clear()
    gk, nk = boost.leaf_fit(*args, depth=depth)
    assert boost.launches["leaf_fit"] == 1
    gp, npl = boost.leaf_fit_plain(*args, depth=depth)
    assert torch.equal(nk, npl)
    assert torch.equal(nk, boost.route_level(*args[:2], *args[4:], depth=depth))
    torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-5)
    again, n2 = boost.leaf_fit(*args, depth=depth)
    assert torch.equal(again.view(torch.int32), gk.view(torch.int32)) and torch.equal(n2, nk)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [256, 1024])
@pytest.mark.parametrize("depth", [2, 6, 9, 12, 13])
def test_leaf_fit_across_merge_groups_matches_plain(cuda, depth, R):
    """70 row blocks, so both merges add three groups of 32 row blocks;
    skewed leaves (60% of the rows on one parent, so runs span many
    threads).  Every path: the accumulators (depths 2, 6), the sort into
    the dense partial (9) and into the compact records (12, 13: 2**depth >
    2R).  Leaf ids exactly, masses within the tolerance, bitwise the same
    on repeat."""
    rng = np.random.RandomState(depth + R)
    nb, n_prev = 70, 2 ** (depth - 1)
    t = lambda a: torch.as_tensor(a, device=cuda)
    node = np.where(rng.rand(nb, R, 1) < 0.6, n_prev // 3, rng.randint(0, n_prev, (nb, R, 1)))
    args = (t(rng.randint(0, 256, size=(nb, R, 7)).astype(np.int32)),
            t(node.astype(np.int32)),
            t(rng.randn(nb, R, 1).astype(np.float32)),
            t(rng.rand(nb, R, 1).astype(np.float32)),
            t(rng.randint(0, 7, size=n_prev).astype(np.int32)),
            t(rng.randint(0, 256, size=n_prev).astype(np.int32)))
    gk, nk = boost.leaf_fit(*args, depth=depth)
    gp, npl = boost.leaf_fit_plain(*args, depth=depth)
    assert torch.equal(nk, npl)
    torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-5)
    again, n2 = boost.leaf_fit(*args, depth=depth)
    assert torch.equal(again.view(torch.int32), gk.view(torch.int32)) and torch.equal(n2, nk)


@pytest.mark.gpu
def test_hist_level_deeper_than_six_matches_plain(cuda):
    """Levels of 64 and 128 nodes at 256 bins (more nodes than PR 2's
    shared-memory accumulators held)."""
    rng = np.random.RandomState(60)
    blk = lambda a: boost.block_rows(torch.as_tensor(a, device=cuda), BLOCK)[0]
    xb3 = blk(rng.randint(0, 256, size=(N, F)).astype(np.int32))
    g3 = blk(rng.randn(N).astype(np.float32))
    h3 = blk(rng.rand(N).astype(np.float32))
    for d in (6, 7):
        n_prev = 2 ** (d - 1)
        t = lambda a: torch.as_tensor(a, device=cuda)
        node3 = t(rng.randint(0, n_prev, size=tuple(g3.shape)).astype(np.int32))
        feat = t(rng.randint(0, F, size=n_prev).astype(np.int32))
        thr = t(rng.randint(0, 256, size=n_prev).astype(np.int32))
        for mxu_i8 in (False, True):
            args = (xb3, node3, g3, h3, feat, thr)
            got, gn = boost.hist_level(*args, depth=d, n_bins=256, mxu_i8=mxu_i8)
            ref, rn = boost.hist_level_plain(*args, depth=d, n_bins=256,
                                             mxu_i8=mxu_i8)
            assert torch.equal(gn, rn)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _kernel_splits(hk, hp, cfg):
    """Split tables from the kernel's histogram.  Where one differs from
    the best split of the plain histogram, the two are a near tie there:
    gains within 1e-4 of the larger (the sums run in another order)."""
    fk, tk, _ = gbdt.best_splits(hk, cfg)
    fp, tp, _ = gbdt.best_splits(hp, cfg)
    gains = gbdt.split_gains(hp, cfg)
    n_bins = hk.shape[2]
    for nd in torch.nonzero((fk != fp) | (tk != tp)).flatten().tolist():
        a = float(gains[nd, int(fk[nd]) * n_bins + int(tk[nd])])
        b = float(gains[nd, int(fp[nd]) * n_bins + int(tp[nd])])
        assert abs(a - b) <= 1e-4 * max(abs(a), abs(b)), (nd, a, b)
    return fk, tk


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_depth8_fused_round_on_card_matches_plain(cuda, mxu_i8):
    """A depth-8 fused round (levels of up to 128 nodes x 256 bins) on the
    card, teacher-forced: each level's histogram and
    node ids match the plain path's on the same inputs, a differing split
    is a near tie, and train_round_fused grows the teacher-forced tree."""
    rng = np.random.RandomState(8)
    n, n_bins, depth = 4000, 256, 8
    xb = rng.randint(0, n_bins, size=(n, F)).astype(np.int32)
    y = (xb[:, 0] + rng.randint(0, 64, size=n) > 160).astype(np.float32)
    cfg = gbdt.GBDTConfig(n_features=F, n_trees=1, depth=depth, n_bins=n_bins,
                          mxu_i8=mxu_i8, min_child_weight=0.5)
    xb3, _ = boost.block_rows(torch.as_tensor(xb, device=cuda), BLOCK)
    yt = torch.as_tensor(y, device=cuda)
    state = gbdt.init_state(cfg, n, cuda)
    g, h = gbdt.gradients(cfg, state.margin, yt)
    g3, _ = boost.block_rows(g, BLOCK)
    h3, _ = boost.block_rows(h, BLOCK)
    kw = dict(n_bins=n_bins, mxu_i8=mxu_i8)
    hk = boost.hist_level0(xb3, g3, h3, **kw)
    hp = boost.hist_level0_plain(xb3, g3, h3, **kw)
    torch.testing.assert_close(hk, hp, rtol=1e-5, atol=1e-5)
    feat, thr = _kernel_splits(hk, hp, cfg)
    feats, thrs = [feat], [thr]
    node3 = torch.zeros(g3.shape, dtype=torch.int32, device=cuda)
    for d in range(1, depth):
        args = (xb3, node3, g3, h3, feat, thr)
        hk, nk = boost.hist_level(*args, depth=d, **kw)
        hp, npl = boost.hist_level_plain(*args, depth=d, **kw)
        assert torch.equal(nk, npl)
        torch.testing.assert_close(hk, hp, rtol=1e-5, atol=1e-5)
        feat, thr = _kernel_splits(hk, hp, cfg)
        feats.append(feat)
        thrs.append(thr)
        node3 = nk
    s = gbdt.train_round_fused(state, xb3, yt, cfg)
    for d in range(depth):
        assert torch.equal(s.forest.feature[0, d, :2 ** d], feats[d])
        assert torch.equal(s.forest.threshold[0, d, :2 ** d], thrs[d])


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_train_round_on_card_matches_cpu(cuda, mxu_i8):
    """The hook-based round on the card (the histogram kernel, the one-hot
    leaf sums) grows the CPU's exact-f32 round's trees; leaves within the
    encodings' tolerance (tests/test_gbdt.py's fused-round gates)."""
    rng = np.random.RandomState(3)
    xb = rng.randint(0, B, size=(N, F)).astype(np.int32)
    y = rng.randint(0, 2, size=N).astype(np.float32)
    cfg = gbdt.GBDTConfig(n_features=F, n_trees=3, depth=3, n_bins=B,
                          mxu_i8=mxu_i8)
    states = {}
    boost.launches.clear()
    for dev in ("cpu", cuda):
        s = gbdt.init_state(cfg, N, dev)
        for _ in range(cfg.n_trees):
            s = gbdt.train_round(s, torch.as_tensor(xb, device=dev),
                                 torch.as_tensor(y, device=dev), cfg)
        states[str(dev)] = gbdt.forest_to_numpy(s.forest)
    assert dict(boost.launches) == {"node_histograms_kernel": 3 * 3}
    got, ref = states["cuda"], states["cpu"]
    np.testing.assert_array_equal(got.feature, ref.feature)
    np.testing.assert_array_equal(got.threshold, ref.threshold)
    tol = dict(rtol=5e-3, atol=5e-3) if mxu_i8 else dict(rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.leaf, ref.leaf, **tol)


@pytest.mark.gpu
def test_gbdt_engine_hook_on_card(cuda):
    """GBDT(engine_allreduce=...) on the card: depth + 1 hook calls per tree,
    histograms from the kernel, the CPU hook run's forest."""
    rng = np.random.RandomState(0)
    X = rng.randn(N, F).astype(np.float32)
    y = (X[:, 0] * X[:, 1] > 0).astype(np.float32)
    calls = []

    def hook(a):
        calls.append(a.shape)
        return a

    hyper = dict(n_trees=2, depth=3, n_bins=B)
    boost.launches.clear()
    gm = gbdt.GBDT(engine_allreduce=hook, device=cuda, **hyper).fit(X, y)
    assert len(calls) == 2 * (3 + 1)
    assert boost.launches["node_histograms_kernel"] == 2 * 3
    cm = gbdt.GBDT(engine_allreduce=lambda a: a, device="cpu", **hyper).fit(X, y)
    got, ref = gbdt.forest_to_numpy(gm.forest), gbdt.forest_to_numpy(cm.forest)
    np.testing.assert_array_equal(got.feature, ref.feature)
    np.testing.assert_array_equal(got.threshold, ref.threshold)
    np.testing.assert_allclose(got.leaf, ref.leaf, rtol=1e-3, atol=1e-5)


def _edge_nodes(name, n, n_nodes, rng):
    """Node ids of the edge cases: 90% of rows on one node, empty nodes,
    foreign ids (outside [0, n_nodes))."""
    node = rng.randint(0, n_nodes, size=n)
    if name == "skewed":
        node = np.where(rng.rand(n) < 0.9, n_nodes // 2, node)
    elif name == "empty":
        node = np.where(node % 3 == 1, 0, node)
    elif name == "foreign":
        node[::7] = n_nodes
        node[3::11] = -1
    return node.astype(np.int32)


EDGE = [("skewed", 8), ("empty", 16), ("foreign", 8), ("uniform", 64), ("uniform", 128),
        ("empty", 1024),  # past 256 nodes: the sorting partition
        ("uniform", 8192), ("skewed", 16384)]  # past the shared-memory path's 4096


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_partition_kernels_match_plain(cuda, mxu_i8):
    """hist_prep, hist_partition and hist_accumulate against their plain
    twins, exactly: node ids, counts, scales, the stable order, the planes,
    the chunk table, and the histogram over the partition (i8 exactly,
    bf16 within tolerance); a short last row block, skewed and empty
    nodes, foreign ids, 64, 128, 1024, 8192 and 16384 nodes."""
    rng = np.random.RandomState(80)
    n, n_bins = 5000, 256  # 5000 = 19 x 256 + 136
    for name, n_nodes in EDGE:
        t = lambda a: torch.as_tensor(a, device=cuda)
        xb = t(rng.randint(0, n_bins, size=(n, F)).astype(np.int32))
        g, h = t(rng.randn(n).astype(np.float32)), t(rng.rand(n).astype(np.float32))
        node = t(_edge_nodes(name, n, n_nodes, rng))
        kw = dict(n_rows=n, block=BLOCK, n_nodes=n_nodes, i8=mxu_i8)
        boost.helper_launches.clear()
        key, counts, scale = boost.hist_prep("nodes", xb, node, g, h, None, None, **kw)
        part = boost.hist_partition(key, g, h, counts, scale, chunk_rows=700, **kw)
        assert dict(boost.helper_launches) == {"hist_prep": 1, "hist_partition": 1}
        cpu = lambda a: None if a is None else a.cpu()
        rk, rc, rs = boost.hist_prep_plain("nodes", *map(cpu, (xb, node, g, h)),
                                           None, None, **kw)
        rp = boost.hist_partition_plain(rk, g.cpu(), h.cpu(), rc, rs,
                                        chunk_rows=700, **kw)
        assert torch.equal(counts.cpu(), rc)
        assert (scale is None and rs is None) or torch.equal(scale.cpu(), rs)
        n_listed, n_chunks = int(rp.node_base[-1]), int(rp.node_chunk0[-1])
        assert torch.equal(part.node_base.cpu(), rp.node_base)
        assert torch.equal(part.node_chunk0.cpu(), rp.node_chunk0)
        assert torch.equal(part.chunk_begin[:n_chunks].cpu(), rp.chunk_begin)
        assert torch.equal(part.perm[:n_listed].cpu(), rp.perm)
        assert torch.equal(part.planes[:n_listed].cpu(), rp.planes)
        # the histogram over the partition against its plain twin: bit for
        # bit in i8 (exact sums, decoded in the same order), within the
        # histogram tolerance in bf16 (f32 sums in another order)
        kw2 = dict(block=BLOCK, n_nodes=n_nodes, n_bins=n_bins, i8=mxu_i8)
        got = boost.hist_accumulate(xb, part, scale, name="node_histograms_kernel", **kw2)
        ref = boost.hist_accumulate_plain(xb.cpu(), rp, rs, **kw2)
        if mxu_i8:
            assert torch.equal(got.cpu(), ref)
        else:
            torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)
    # the route mode: node ids one level down, written once
    c = _inputs(81, 4, cuda)
    args = [c[k] for k in ("xb3", "node3", "g3", "h3", "feat", "thr")]
    kw = dict(n_rows=c["g3"].numel(), block=BLOCK, n_nodes=16, i8=mxu_i8)
    key, counts, scale = boost.hist_prep("route", args[0], args[1], args[2], args[3],
                                         args[4], args[5], **kw)
    rk, rc, rs = boost.hist_prep_plain("route", *[a.cpu() for a in args], **kw)
    assert torch.equal(key.cpu().reshape(-1), rk) and torch.equal(counts.cpu(), rc)


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_node_histograms_kernel_edge_cases_match_plain(cuda, mxu_i8):
    """The partitioned kernel on skewed and empty nodes, foreign ids, a
    short last row block, and 64 and 128 nodes (256 bins), against its
    plain twin."""
    from rabit_tpu_torch.ops import hist

    rng = np.random.RandomState(82)
    n = 5000
    for name, n_nodes in EDGE:
        t = lambda a: torch.as_tensor(a, device=cuda)
        xb = t(rng.randint(0, 256, size=(n, F)).astype(np.int32))
        g, h = t(rng.randn(n).astype(np.float32)), t(rng.rand(n).astype(np.float32))
        node = t(_edge_nodes(name, n, n_nodes, rng))
        got = hist.node_histograms_kernel(xb, g, h, node, n_nodes, 256,
                                          block_rows=BLOCK, mxu_i8=mxu_i8)
        ref = hist.node_histograms_kernel_plain(xb, g, h, node, n_nodes, 256,
                                                block_rows=BLOCK, mxu_i8=mxu_i8)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_hist_level_skewed_matches_plain(cuda, mxu_i8):
    """Route mode with 90% of the rows on one parent, d = 1..7, and a
    feature count whose tile slice is not 16-byte aligned (F = 5) beside
    one whose slice is (F = 8)."""
    rng = np.random.RandomState(83)
    n = 4096
    for n_feat in (5, 8):
        blk = lambda a: boost.block_rows(torch.as_tensor(a, device=cuda), BLOCK)[0]
        xb3 = blk(rng.randint(0, 256, size=(n, n_feat)).astype(np.int32))
        g3 = blk(rng.randn(n).astype(np.float32))
        h3 = blk(rng.rand(n).astype(np.float32))
        for d in range(1, 8):
            n_prev = 2 ** (d - 1)
            t = lambda a: torch.as_tensor(a, device=cuda)
            node = np.where(rng.rand(n) < 0.9, 0, rng.randint(0, n_prev, size=n))
            node3 = blk(node.astype(np.int32))
            feat = t(rng.randint(0, n_feat, size=n_prev).astype(np.int32))
            thr = t(rng.randint(0, 256, size=n_prev).astype(np.int32))
            args = (xb3, node3, g3, h3, feat, thr)
            got, gn = boost.hist_level(*args, depth=d, n_bins=256, mxu_i8=mxu_i8)
            ref, rn = boost.hist_level_plain(*args, depth=d, n_bins=256, mxu_i8=mxu_i8)
            assert torch.equal(gn, rn)
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_hist_kernels_bitwise_on_repeat_at_1m_rows(cuda, mxu_i8):
    """hist_level (d = 5, 7) and node_histograms_kernel (d = 5) at 1M rows x
    28 features x 256 bins: bitwise the same on repeat."""
    from rabit_tpu_torch.ops import hist

    rng = np.random.RandomState(84)
    n, n_feat = 1 << 20, 28
    t = lambda a: torch.as_tensor(a, device=cuda)
    xb = t(rng.randint(0, 256, size=(n, n_feat)).astype(np.int32))
    g, h = t(rng.randn(n).astype(np.float32)), t(rng.rand(n).astype(np.float32))
    xb3, g3, h3 = (boost.block_rows(a)[0] for a in (xb, g, h))
    for d in (5, 7):
        n_prev = 2 ** (d - 1)
        node3 = boost.block_rows(t(rng.randint(0, n_prev, size=n).astype(np.int32)))[0]
        feat = t(rng.randint(0, n_feat, size=n_prev).astype(np.int32))
        thr = t(rng.randint(0, 256, size=n_prev).astype(np.int32))
        args = (xb3, node3, g3, h3, feat, thr)
        a, na = boost.hist_level(*args, depth=d, n_bins=256, mxu_i8=mxu_i8)
        b, nb_ = boost.hist_level(*args, depth=d, n_bins=256, mxu_i8=mxu_i8)
        assert torch.equal(a, b) and torch.equal(na, nb_)
    node = t(rng.randint(0, 32, size=n).astype(np.int32))
    a = hist.node_histograms_kernel(xb, g, h, node, 32, 256, mxu_i8=mxu_i8)
    b = hist.node_histograms_kernel(xb, g, h, node, 32, 256, mxu_i8=mxu_i8)
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("mode,n_nodes", [("nodes", 2), ("nodes", 64), ("route", 64),
                                          ("nodes", 4096)])
def test_sorting_partition_path_is_bitwise_the_shared_memory_path(cuda, monkeypatch, mode,
                                                                  n_nodes, mxu_i8):
    """Up to 256 nodes the wrapper takes the shared-memory path (which
    holds up to 4096), past that the sorting path; each, forced where the
    other runs (by moving ``_SORT_NODES``), gives the same counts,
    partition and histogram bit for bit."""
    rng = np.random.RandomState(n_nodes)
    n = 5000 if mode == "nodes" else 20 * BLOCK
    t = lambda a: torch.as_tensor(a, device=cuda)
    xb = t(rng.randint(0, 256, size=(n, F)).astype(np.int32))
    g, h = t(rng.randn(n).astype(np.float32)), t(rng.rand(n).astype(np.float32))
    if mode == "nodes":
        node, feat, thr = t(_edge_nodes("foreign", n, n_nodes, rng)), None, None
    else:
        n_prev = n_nodes // 2
        node = t(rng.randint(0, n_prev, size=n).astype(np.int32))
        feat = t(rng.randint(0, F, size=n_prev).astype(np.int32))
        thr = t(rng.randint(0, 256, size=n_prev).astype(np.int32))
    kw = dict(n_rows=n, block=BLOCK, n_nodes=n_nodes, i8=mxu_i8)
    outs = []
    for sort_nodes in (4096, 0):  # the shared-memory path, then the sorting one
        monkeypatch.setattr(boost, "_SORT_NODES", sort_nodes)
        key, counts, scale = boost.hist_prep(mode, xb, node, g, h, feat, thr, **kw)
        part = boost.hist_partition(key, g, h, counts, scale, chunk_rows=700, **kw)
        hist, node_out = boost.hist_launch(mode, xb, node, g, h, feat, thr, n_bins=256,
                                           name="node_histograms_kernel", **kw)
        n_listed, n_chunks = int(part.node_base[-1]), int(part.node_chunk0[-1])
        outs.append([counts, part.node_base, part.node_chunk0,
                     part.chunk_begin[:n_chunks], part.perm[:n_listed],
                     part.planes[:n_listed], hist.view(torch.int32)]
                    + ([key, node_out] if mode == "route" else [])
                    + ([scale] if mxu_i8 else []))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _zero_margin_round(depth, fused_final, mxu_i8, dev, entry):
    """One round from a zero margin (g = +-0.5 and h = 0.25 sum exactly in
    any order, in bf16 and i8 alike, so the trees and leaves are exact)."""
    rng = np.random.RandomState(depth)
    n, n_feat, n_bins = 3000, 3, 8
    xb = torch.as_tensor(rng.randint(0, n_bins, size=(n, n_feat)).astype(np.int32), device=dev)
    y = torch.as_tensor(rng.randint(0, 2, size=n).astype(np.float32), device=dev)
    cfg = gbdt.GBDTConfig(n_features=n_feat, n_trees=1, depth=depth, n_bins=n_bins,
                          mxu_i8=mxu_i8, fused_final=fused_final)
    s = gbdt.init_state(cfg, n, dev)
    if entry == "fused":
        return gbdt.train_round_fused(s, boost.block_rows(xb, BLOCK)[0], y, cfg)
    if entry == "hook":
        return gbdt.train_round(s, xb, y, cfg)
    return gbdt.train_round_dp(s, xb, y, cfg)


def _assert_same_round(got, ref):
    for a, b in zip(gbdt.forest_to_numpy(got.forest), gbdt.forest_to_numpy(ref.forest)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.margin.cpu().numpy(), ref.margin.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("fused_final", [False, True])
@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("depth", [14, 15])
def test_deep_fused_round_on_card_matches_cpu(cuda, depth, mxu_i8, fused_final):
    """Depth 14 and 15: last histograms of 8192 and 16384 nodes (the
    sorting partition), then the final pass; the card's round equals the
    CPU's."""
    boost.launches.clear()
    got = _zero_margin_round(depth, fused_final, mxu_i8, cuda, "fused")
    final = "route_margin_level" if fused_final else "route_level"
    assert dict(boost.launches) == {"hist_level0": 1, "hist_level": depth - 1, final: 1}
    _assert_same_round(got, _zero_margin_round(depth, fused_final, mxu_i8, "cpu", "fused"))


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["hook", "dp"])
@pytest.mark.parametrize("depth", [14, 15])
def test_deep_hook_and_dp_rounds_on_card_match_cpu(cuda, depth, entry, tmp_path):
    """train_round and train_round_dp (an NCCL group of one) at depth 14
    and 15 on the card against train_round on the CPU."""
    import torch.distributed as dist

    if entry == "dp":
        dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                                rank=0, world_size=1)
    try:
        boost.launches.clear()
        got = _zero_margin_round(depth, False, False, cuda, entry)
        assert dict(boost.launches) == {"node_histograms_kernel": depth}
    finally:
        if entry == "dp":
            dist.destroy_process_group()
    _assert_same_round(got, _zero_margin_round(depth, False, False, "cpu", "hook"))


@pytest.mark.gpu
def test_node_histograms_kernel_past_the_grid_row_limit(cuda):
    """70,000 nodes: more than a grid's 65,535 rows, which once held the
    node-per-row sum of the chunk partials and the chunk-per-row feature
    tiles; against the plain twin."""
    from rabit_tpu_torch.ops import hist

    n, n_nodes = 3000, 70000
    xb, g, h, node = _node_inputs(86, n, n_nodes, B, cuda)
    node[:1000] = n_nodes - 1  # one node far up holds a third of the rows
    got = hist.node_histograms_kernel(xb, g, h, node, n_nodes, B, block_rows=BLOCK)
    ref = hist.node_histograms_kernel_plain(xb, g, h, node, n_nodes, B, block_rows=BLOCK)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def _hist_modes(rng, n, n_nodes, n_bins, block, device):
    """hist_launch's three modes on seeded rows (n a multiple of block for
    root and route; nodes: foreign ids, and n + 100 rows, a short last
    block): [(mode, args, kw)]."""
    t = lambda a: torch.as_tensor(a, device=device)
    xb = rng.randint(0, n_bins, size=(n + 100, F)).astype(np.int32)
    g, h = rng.randn(n + 100).astype(np.float32), rng.rand(n + 100).astype(np.float32)
    node = rng.randint(0, n_nodes, size=n + 100).astype(np.int32)
    node[::13] = n_nodes  # out of range: adds nothing
    n_prev = max(1, n_nodes // 2)
    feat = t(rng.randint(0, F, size=n_prev).astype(np.int32))
    thr = t(rng.randint(0, n_bins, size=n_prev).astype(np.int32))
    parent = t(rng.randint(0, n_prev, size=n).astype(np.int32))
    kw = dict(block=block, n_bins=n_bins, name="node_histograms_kernel")
    return [("root", (t(xb[:n]), None, t(g[:n]), t(h[:n]), None, None),
             dict(kw, n_rows=n, n_nodes=1)),
            ("route", (t(xb[:n]), parent, t(g[:n]), t(h[:n]), feat, thr),
             dict(kw, n_rows=n, n_nodes=2 * n_prev)),
            ("nodes", (t(xb), t(node), t(g), t(h), None, None),
             dict(kw, n_rows=n + 100, n_nodes=n_nodes))]


def _check_hist_modes(cases, mxu_i8):
    """Each mode on the card against its plain twins on the CPU: the node
    ids, the i8 block scales and the partition exactly, the histogram
    within the tolerance; bitwise the same on repeat."""
    cpu = lambda a: None if a is None else a.cpu()
    for mode, args, kw in cases:
        boost.launches.clear()
        got, node_out = boost.hist_launch(mode, *args, i8=mxu_i8, **kw)
        again, node_again = boost.hist_launch(mode, *args, i8=mxu_i8, **kw)
        assert boost.launches["node_histograms_kernel"] == 2
        ref, ref_node = boost.hist_launch(mode, *map(cpu, args), i8=mxu_i8, **kw)
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(got.view(torch.int32), again.view(torch.int32))
        if mode == "route":
            assert torch.equal(node_out.cpu(), ref_node) and torch.equal(node_out, node_again)
        pk = dict(n_rows=kw["n_rows"], block=kw["block"], n_nodes=kw["n_nodes"], i8=mxu_i8)
        key, counts, scale = boost.hist_prep(mode, *args, **pk)
        rk, rc, rs = boost.hist_prep_plain(mode, *map(cpu, args), **pk)
        assert torch.equal(counts.cpu(), rc)
        assert scale is None or torch.equal(scale.cpu(), rs)
        part = boost.hist_partition(key, args[2], args[3], counts, scale, **pk)
        rp = boost.hist_partition_plain(rk, args[2].cpu(), args[3].cpu(), rc, rs, **pk)
        n_listed, n_chunks = int(rp.node_base[-1]), int(rp.node_chunk0[-1])
        assert torch.equal(part.node_chunk0.cpu(), rp.node_chunk0)
        assert torch.equal(part.chunk_begin[:n_chunks].cpu(), rp.chunk_begin)
        assert torch.equal(part.planes[:n_listed].cpu(), rp.planes)
        if mode != "root":
            assert torch.equal(part.perm[:n_listed].cpu(), rp.perm)


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("n_bins", [300, 512, 4096])
def test_hist_kernels_past_256_bins_match_plain(cuda, n_bins, mxu_i8):
    """More bins than one 256-bin window of the tile kernel: 2, 2 and 16
    windows, every mode, 8 nodes (the shared-memory partition) and 512
    (the sorting one), against the plain twins."""
    rng = np.random.RandomState(n_bins)
    for n_nodes in (8, 512):
        _check_hist_modes(_hist_modes(rng, 6 * BLOCK, n_nodes, n_bins, BLOCK, cuda),
                          mxu_i8)


@pytest.mark.gpu
@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("block", [128, 384, 16384])
def test_hist_kernels_at_row_blocks_match_plain(cuda, block, mxu_i8):
    """Row blocks that are not a multiple of 256 (128, 384: the scatter's
    and the sort's warps past the block hold no row) and of 16384 rows
    (more than the scatter held before), every mode, both partition paths;
    the i8 scale is per row block, and the plain twins block alike."""
    rng = np.random.RandomState(block)
    n = 2 * block if block > 1024 else 9 * block
    for n_nodes in (8, 512):
        _check_hist_modes(_hist_modes(rng, n, n_nodes, 256, block, cuda), mxu_i8)


@pytest.mark.gpu
@pytest.mark.parametrize("R", [128, 384, 16384])
@pytest.mark.parametrize("depth", [3, 9, 13])
def test_leaf_fit_at_row_blocks_matches_plain(cuda, depth, R):
    """leaf_fit at row blocks of 128, 384 and 16384 rows, by the
    accumulators (depth 3), the sort into the dense partial (9; the dense
    partial past 2R at 128 rows) and the compact records (13).  At 16384
    rows and depth >= 9 the sort would outgrow shared memory, and the
    kernel sums the block in two halves.  Leaf ids exactly, masses within
    the tolerance, bitwise on repeat."""
    rng = np.random.RandomState(depth * R)
    nb, n_prev = (3 if R > 1024 else 40), 2 ** (depth - 1)
    t = lambda a: torch.as_tensor(a, device=cuda)
    args = (t(rng.randint(0, 256, size=(nb, R, 7)).astype(np.int32)),
            t(rng.randint(0, n_prev, size=(nb, R, 1)).astype(np.int32)),
            t(rng.randn(nb, R, 1).astype(np.float32)),
            t(rng.rand(nb, R, 1).astype(np.float32)),
            t(rng.randint(0, 7, size=n_prev).astype(np.int32)),
            t(rng.randint(0, 256, size=n_prev).astype(np.int32)))
    gk, nk = boost.leaf_fit(*args, depth=depth)
    gp, npl = boost.leaf_fit_plain(*args, depth=depth)
    assert torch.equal(nk, npl)
    torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-5)
    again, n2 = boost.leaf_fit(*args, depth=depth)
    assert torch.equal(again.view(torch.int32), gk.view(torch.int32)) and torch.equal(n2, nk)


def _rounds_512(entry, mxu_i8, fused_final, dev, tmp_path=None):
    """Three rounds of one entry point at 512 bins (3000 rows, depth 3)."""
    rng = np.random.RandomState(512)
    n, n_bins = 3000, 512
    X = rng.randn(n, F).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] + 0.5 * X[:, 2]) > 0).astype(np.float32)
    hyper = dict(n_trees=3, depth=3, n_bins=n_bins, mxu_i8=mxu_i8, fused_final=fused_final)
    if entry == "fit":
        return gbdt.forest_to_numpy(gbdt.GBDT(device=dev, **hyper).fit(X, y).forest)
    cfg = gbdt.GBDTConfig(n_features=F, **hyper)
    edges = torch.as_tensor(gbdt.compute_bin_edges(X, n_bins), device=dev)
    xb = gbdt.quantize(torch.as_tensor(X, device=dev), edges)
    yt = torch.as_tensor(y, device=dev)
    s = gbdt.init_state(cfg, n, dev)
    for _ in range(cfg.n_trees):
        if entry == "fused":
            s = gbdt.train_round_fused(s, boost.block_rows(xb)[0], yt, cfg)
        elif entry == "dp":
            s = gbdt.train_round_dp(s, xb, yt, cfg)
        else:
            s = gbdt.train_round(s, xb, yt, cfg)
    return gbdt.forest_to_numpy(s.forest)


@pytest.mark.gpu
@pytest.mark.parametrize("entry,mxu_i8,fused_final", [
    ("fused", False, False), ("fused", True, False), ("fused", False, True),
    ("fused", True, True), ("hook", False, False), ("hook", True, False),
    ("dp", False, False), ("fit", False, False)])
def test_rounds_at_512_bins_on_card_match_cpu(cuda, entry, mxu_i8, fused_final, tmp_path):
    """train_round_fused, train_round, train_round_dp (an NCCL group of one)
    and GBDT.fit at n_bins = 512 on the card against the same entry on the
    CPU (GBDT.fit: the exact train_round there); leaves within the fused
    rounds' tolerances of tests/test_gbdt.py."""
    import torch.distributed as dist

    if entry == "dp":
        dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                                rank=0, world_size=1)
    try:
        boost.launches.clear()
        got = _rounds_512(entry, mxu_i8, fused_final, cuda)
        assert boost.launches, "no kernel launched"
    finally:
        if entry == "dp":
            dist.destroy_process_group()
    ref = _rounds_512("hook" if entry == "dp" else entry, mxu_i8, fused_final, "cpu")
    np.testing.assert_array_equal(got.feature, ref.feature)
    np.testing.assert_array_equal(got.threshold, ref.threshold)
    tol = dict(rtol=5e-3, atol=5e-3) if mxu_i8 else dict(rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.leaf, ref.leaf, **tol)


@pytest.mark.gpu
def test_torch_engine_nccl_world_one(cuda):
    """The engine matrix of tests/workers/torch_basic_worker.py through
    TorchEngine on NCCL (arrays staged on the card) at world 1, the one
    world a machine with one card can hold."""
    import importlib.util
    import pathlib
    import socket

    import torch.distributed as dist

    from rabit_tpu_torch import api

    path = pathlib.Path(__file__).parent / "workers" / "torch_basic_worker.py"
    spec = importlib.util.spec_from_file_location("torch_basic_worker", path)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    api.init(["rabit_engine=torch", "rabit_torch_device=cuda",
              "rabit_torch_master_addr=127.0.0.1", f"rabit_torch_master_port={port}",
              "rabit_torch_world_size=1", "rabit_torch_rank=0"])
    try:
        assert dist.get_backend() == "nccl" and api.get_engine()._stage.type == "cuda"
        worker.run_matrix(256)
    finally:
        api.finalize()
    assert not dist.is_initialized()


# -- compressed collectives on the card -------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["identity", "bf16", "bf16x2", "i8", "i8x2"])
def test_codecs_on_card_match_numpy(cuda, name):
    """torch_encode of a CUDA tensor gives numpy encode's bytes bit for bit,
    torch_decode on the card its values (NaN where it has NaN), with and
    without an inf, a -inf and a NaN in one block, and at a depth-5 level
    histogram's size."""
    from rabit_tpu_torch.compress import get_codec

    c = get_codec(name)
    for n in (5, 256, 1000, 32 * 28 * 256 * 2):
        for nonfinite in (False, True):
            x = (np.random.RandomState(n).randn(n) * 10).astype(np.float32)
            if nonfinite:
                x[1], x[3], x[4] = np.inf, np.nan, -np.inf
            enc = c.encode(x)
            got = c.torch_encode(torch.as_tensor(x, device=cuda))
            assert got.device.type == "cuda"
            assert got.cpu().numpy().tobytes() == enc, (name, n, nonfinite)
            packed = torch.as_tensor(np.frombuffer(enc, np.uint8).copy(), device=cuda)
            np.testing.assert_array_equal(c.torch_decode(packed, n).cpu().numpy(),
                                          c.decode(enc, n))


@pytest.mark.gpu
def test_quantized_ring_and_fused_ring_at_world_one_match_cpu(cuda, tmp_path):
    """On an NCCL group of one: ring_allreduce_quantized of a CUDA tensor
    (still one quantization) equals the CPU's bit for bit; the fused ring
    on the card equals reference_allreduce bit for bit."""
    import torch.distributed as dist

    from rabit_tpu_torch.compress import get_codec, reference_allreduce
    from rabit_tpu_torch.engine import fused
    from rabit_tpu_torch.engine.base import MAX, SUM
    from rabit_tpu_torch.parallel import ring_allreduce_quantized

    x = (np.random.RandomState(5).randn(32 * 28 * 256 * 2) * 50).astype(np.float32)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        for planes in (1, 2):
            got = ring_allreduce_quantized(torch.as_tensor(x, device=cuda), planes=planes)
            want = ring_allreduce_quantized(torch.as_tensor(x), planes=planes)
            assert got.device.type == "cuda"
            assert got.cpu().numpy().tobytes() == want.numpy().tobytes(), planes
        for name in ("bf16", "bf16x2", "i8", "i8x2"):
            for op in (SUM, MAX):
                fn = fused.build_fused_allreduce(None, (0,), op, get_codec(name), x.size,
                                                 device=cuda)
                got = fn(torch.as_tensor(x, device=cuda)).cpu().numpy()
                assert got.tobytes() == reference_allreduce([x], op, name).tobytes()
    finally:
        dist.destroy_process_group()


def _wire_run(tmp_path, device: str, world: int = 2) -> list[dict]:
    """tests/workers/torch_wire_worker.py on ``world`` gloo processes."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    worker = root / "tests" / "workers" / "torch_wire_worker.py"
    tmp = tmp_path / device
    tmp.mkdir()
    env = dict(os.environ, PYTHONPATH=str(root))
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(world),
                               str(tmp / "store"), str(tmp / f"rank{r}.npz"), device],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.mark.gpu
def test_wire_i8_round_of_two_gloo_processes_on_one_card_matches_cpu(cuda, tmp_path):
    """train_round_dp_fused(wire_i8=True) on two gloo processes sharing the
    card: the ranks' forests bitwise identical, and the split tables of the
    same two processes' run on the CPU, leaves within rtol = atol = 1e-3
    (the histogram kernel sums in another order than the plain version)."""
    card, cpu = _wire_run(tmp_path, "cuda"), _wire_run(tmp_path, "cpu")
    for key in ("wire", "exact"):
        for k in ("feature", "threshold", "leaf"):
            np.testing.assert_array_equal(card[1][f"{key}_{k}"], card[0][f"{key}_{k}"])
        np.testing.assert_array_equal(card[0][f"{key}_feature"], cpu[0][f"{key}_feature"])
        np.testing.assert_array_equal(card[0][f"{key}_threshold"],
                                      cpu[0][f"{key}_threshold"])
        np.testing.assert_allclose(card[0][f"{key}_leaf"], cpu[0][f"{key}_leaf"],
                                   rtol=1e-3, atol=1e-3)


# -- the linear and k-means models, attention and run_local on the card ---------
#
# TF32 stays off (torch's default for matmuls, asserted here): the card's
# products are then exact-f32 like the CPU's, in another order of summation.


def _models_worker():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parent / "workers" / "torch_models_worker.py"
    spec = importlib.util.spec_from_file_location("torch_models_worker", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("objective", ["logistic", "squared"])
def test_linear_on_card_matches_cpu(cuda, objective):
    """LinearModel on cuda against the same fit on the CPU, at
    tests/test_models.py's rtol 2e-4, atol 2e-5."""
    from rabit_tpu_torch.models import linear

    assert not torch.backends.cuda.matmul.allow_tf32
    X, y = _models_worker().make_classif(n=20000, f=28)
    got = linear.LinearModel(n_steps=50, objective=objective).fit(X, y)
    want = linear.LinearModel(device="cpu", n_steps=50, objective=objective).fit(X, y)
    assert got.state.w.device.type == "cuda"
    np.testing.assert_allclose(got.w, want.w, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.predict_margin(X), want.predict_margin(X),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.gpu
def test_kmeans_on_card_matches_cpu(cuda):
    """assign on the card against the CPU's but for near ties (the worker's
    assign_flips, c = 2F); local_stats' counts exactly where the
    assignments agree; KMeans.fit on blobs within rtol = atol = 1e-4 (the
    CPU sums a cluster's rows in f32 in row order, the card in f64 rounded
    once: they differ by the CPU's rounding, under 1500 * 2^-24 < 1e-4 of
    the sum for these clusters)."""
    from rabit_tpu_torch.models import kmeans

    assert not torch.backends.cuda.matmul.allow_tf32
    W = _models_worker()
    rng = np.random.RandomState(8)
    X = rng.rand(50000, 28).astype(np.float32)
    C = X[rng.choice(len(X), 64, replace=False)]
    got = kmeans.assign(torch.as_tensor(X, device=cuda), torch.as_tensor(C, device=cuda))
    want = kmeans.assign(torch.as_tensor(X), torch.as_tensor(C))
    W.assign_flips(X, C, got.cpu().numpy(), want.numpy())
    stats = kmeans.local_stats(torch.as_tensor(X, device=cuda), torch.as_tensor(C, device=cuda))
    np.testing.assert_array_equal(stats[:, -1].cpu().numpy(),
                                  np.bincount(got.cpu().numpy(), minlength=64))
    B, _ = W.make_blobs()
    card = kmeans.KMeans(5, 30, seed=3).fit(B)
    cpu = kmeans.KMeans(5, 30, seed=3, device="cpu").fit(B)
    np.testing.assert_allclose(card.centers, cpu.centers, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_at_world_one_on_card_matches_reference(cuda, tmp_path, causal, dtype):
    """ring_attention and ulysses_attention on an NCCL group of one against
    reference_attention of the f32-cast inputs on the card: rtol 2e-4,
    atol 2e-5 (tests/test_parallel.py's) in f32; bf16 adds the output's
    rounding, half an ulp: rtol 2^-8 + 2e-4."""
    import torch.distributed as dist

    from rabit_tpu_torch.parallel import ring

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.RandomState(9)
    q, k, v = (torch.as_tensor(rng.randn(256, 8, 64).astype(np.float32), device=cuda)
               .to(dtype) for _ in range(3))
    want = ring.reference_attention(q.float(), k.float(), v.float(), causal=causal)
    tol = dict(rtol=2e-4, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=2.0 ** -8 + 2e-4, atol=2e-5)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        for fn in (ring.ring_attention, ring.ulysses_attention):
            got = fn(q, k, v, causal=causal)
            assert got.dtype == dtype and got.device.type == "cuda"
            torch.testing.assert_close(got.float(), want, **tol)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_run_local_on_card_matches_reference(cuda, tmp_path):
    """engine.fused.run_local on its default device, the card, on an NCCL
    group of one: bit for bit reference_allreduce."""
    import torch.distributed as dist

    from rabit_tpu_torch.compress import reference_allreduce
    from rabit_tpu_torch.engine import fused
    from rabit_tpu_torch.engine.base import MAX, SUM

    x = (np.random.RandomState(6).randn(3000) * 20).astype(np.float32)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        for name in ("bf16", "bf16x2", "i8", "i8x2"):
            for op in (SUM, MAX):
                got = fused.run_local([x], op, name)
                assert got.tobytes() == reference_allreduce([x], op, name).tobytes()
    finally:
        dist.destroy_process_group()


# -- the native engine on the card --------------------------------------------------

WORKERS = Path(__file__).parent / "workers"


def _cluster(world, args, worker, max_restarts=0):
    from rabit_tpu_torch.engine import native
    from rabit_tpu_torch.tracker.launcher import LocalCluster

    native.build_lib()
    cluster = LocalCluster(world, max_restarts=max_restarts, quiet=True)
    assert cluster.run([sys.executable, str(WORKERS / worker), *args], timeout=300) == 0
    assert all(rc == 0 for rc in cluster.returncodes.values())
    return cluster


@pytest.mark.gpu
def test_native_engine_matrix_with_card_tensors(cuda):
    """The engine matrix through the native engine at world 2 under the
    port's launcher, its tensor case sent from the card."""
    cluster = _cluster(2, ["64", "rabit_engine=native", "lazy=0", "tensor_device=cuda"],
                       "torch_basic_worker.py")
    assert sorted(cluster.messages) == ["worker 0/2 ok", "worker 1/2 ok"]


@pytest.mark.gpu
def test_native_mock_kill_with_a_round_on_the_card(cuda, tmp_path):
    """Two hybrid workers on the card (each an NCCL group of one, the hop the
    native engine): a mock kill mid-tree recovers to the clean run's forest
    bit for bit."""
    args = ["rabit_engine=mock", "mode=hybrid", "device=cuda", "ntrees=3"]
    _cluster(2, [*args, f"out={tmp_path / 'clean'}"], "torch_gbdt_native_worker.py")
    cluster = _cluster(2, [*args, f"out={tmp_path / 'kill'}", "mock=1,1,1,0"],
                       "torch_gbdt_native_worker.py", max_restarts=2)
    assert cluster.restarts == {"0": 0, "1": 1}
    np.testing.assert_array_equal(np.load(tmp_path / "kill.npy"),
                                  np.load(tmp_path / "clean.npy"))


# -- observability and liveness on the card -----------------------------------------

@pytest.mark.gpu
def test_obs_collective_counts_a_card_tensors_bytes(cuda):
    """obs.collective around api.allreduce of a card tensor records the
    tensor's bytes, and the result stays on the card."""
    from rabit_tpu_torch import api, obs

    api.init(["rabit_engine=empty"])
    try:
        obs.get_recorder().clear()
        t = torch.arange(1000, dtype=torch.float32, device=cuda)
        out = api.allreduce(t, api.SUM)
        assert out.device.type == "cuda" and torch.equal(out, t)
        ops = [e for e in obs.get_recorder().snapshot() if e.kind in ("op_begin", "op_end")]
        assert [(e.kind, e.fields["op"], e.fields["nbytes"]) for e in ops] == [
            ("op_begin", "allreduce", 4000), ("op_end", "allreduce", 4000)]
    finally:
        api.finalize()


@pytest.mark.gpu
def test_leases_of_two_workers_on_the_card(cuda, tmp_path, monkeypatch):
    """Two GBDT workers on the card (rows small) with heartbeat leases under
    the port's launcher: no lease expires, and telemetry.json holds both
    ranks' snapshots, each with its allreduce stats."""
    import json

    monkeypatch.setenv("RABIT_OBS_DIR", str(tmp_path / "obs"))
    _cluster(2, ["rabit_engine=robust", "mode=gbdt", "device=cuda", "ntrees=3",
                 "rabit_heartbeat_sec=0.5", f"out={tmp_path / 'forest'}"],
             "torch_gbdt_native_worker.py")
    t = json.loads((tmp_path / "obs" / "telemetry.json").read_text())
    assert t["n_lease_expired"] == 0 and t["restarts"] == {}
    assert set(t["ranks"]) == {"0", "1"}
    for snap in t["ranks"].values():
        assert snap["metrics"]["ops"]["allreduce"]["calls"] == 3 * (3 + 1) + 1


# -- the elastic plane and the unfused compressed path on the card ----------------


def _worker_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, WORKERS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_elastic_contribution_on_card_matches_plain_and_world_one(cuda):
    """tests/workers/torch_elastic_worker.py's contribution on the card
    (node_histograms_kernel, 64 nodes x 28 features x 256 bins, integer g):
    exact, equal to the plain version and to numpy's bincount, and the
    rank-order fold of the shards at worlds 2 and 3 bitwise the world-1
    histogram."""
    from rabit_tpu_torch.elastic import refold
    from rabit_tpu_torch.ops.hist import node_histograms_kernel_plain

    ew = _worker_module("torch_elastic_worker")
    rows, nodes, bins = 6000, 64, 256
    xb, node = ew.make_bins(rows, bins), ew.row_nodes(rows, nodes)
    work, _ = ew.card_contribution(xb, node, nodes, bins)
    for v in (1, 5):
        whole = work(v, 1, 0)
        g = torch.as_tensor(ew.row_grads(0, rows, v), device=cuda)
        plain = node_histograms_kernel_plain(
            torch.as_tensor(xb, device=cuda), g, torch.ones_like(g),
            torch.as_tensor(node, device=cuda), nodes, bins)
        np.testing.assert_array_equal(whole, plain.to(torch.int64).cpu().numpy())
        np.testing.assert_array_equal(whole, ew.numpy_hist(xb, node, ew.row_grads(0, rows, v),
                                                           nodes, bins))
        for world in (2, 3):
            np.testing.assert_array_equal(refold([work(v, world, r) for r in range(world)]),
                                          whole)


@pytest.mark.gpu
def test_unfused_compressed_path_on_card_matches_host_transport(cuda, tmp_path):
    """rabit_fused_allreduce=0 with the codec work on the card (two gloo
    processes sharing it, tests/workers/torch_compressed_device_worker.py):
    every codec under SUM, MAX and MIN bitwise reference_allreduce, SUM
    bitwise the host transport's result, and no run of the host transport
    but the host-only codec's."""
    import subprocess

    from rabit_tpu_torch.compress import reference_allreduce
    from rabit_tpu_torch.engine.base import MAX, MIN, SUM

    cw = _worker_module("torch_compressed_device_worker")
    root = Path(__file__).resolve().parents[1]
    env = dict(__import__("os").environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(WORKERS / "torch_compressed_device_worker.py"),
                               str(r), "2", str(tmp_path / "store"),
                               str(tmp_path / f"rank{r}.npz"), "cuda"],
                              env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    xs = cw.contribs(2)
    for r in range(2):
        res = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert int(res["host_calls"]) == 2 and not res["fused_flags"].any()
        assert res["unfused_counted"].all()
        for cname in cw.CODECS:
            for oname, op in (("sum", SUM), ("max", MAX), ("min", MIN)):
                want = reference_allreduce(xs, op, cname)
                assert res[f"dev/{cname}/{oname}"].tobytes() == want.tobytes(), (cname, oname)
        for cname in ("bf16", "i8"):
            assert res[f"dev/{cname}/sum"].tobytes() == res[f"host/{cname}"].tobytes()


# -- the diagnosis plane on the card ------------------------------------------------

@pytest.mark.gpu
def test_straggler_incident_with_card_contributions(cuda):
    """Four ElasticWorker threads (tests/workers/torch_diag_job.py), each
    contribution node_histograms_kernel on card tensors; rank 2 0.4 s late
    to each version: exactly one compute-straggler incident, naming rank 2,
    and every state bitwise the world-1 totals."""
    import threading

    ew, dj = _worker_module("torch_elastic_worker"), _worker_module("torch_diag_job")
    rows, nodes, bins, niter = 4000, 4, 16, 10
    xb, node = ew.make_bins(rows, bins), ew.row_nodes(rows, nodes)
    card, _ = ew.card_contribution(xb, node, nodes, bins)
    lock = threading.Lock()

    def work(v, world, rank):
        with lock:  # the worker threads launch one at a time
            return card(v, world, rank)

    out = dj.run_job(4, niter, work, straggler=(2, 0.4), iter_sleep=0.1, deadline_sec=90.0)
    inc = out["incidents"]
    assert [(i["class"], i["subject"]) for i in inc["open"] + inc["recent"]] == [
        ("compute-straggler", {"rank": 2})]
    want = ew.expected_totals(xb, node, niter, nodes, bins)
    for res in out["results"].values():
        assert res.completed and np.array_equal(res.state, want)


@pytest.mark.gpu
def test_trace_of_a_native_gbdt_job_on_the_card(cuda, tmp_path, monkeypatch):
    """Two GBDT workers on the card under the native engine with flight
    dumps at exit, rank 0 0.3 s late to each tree: the job's obs dir exports
    to one valid trace, every rank has a clock estimate, and rank 0 tops
    the straggler report and the critical path's gating ranks."""
    from rabit_tpu_torch.obs import critical, trace

    monkeypatch.setenv("RABIT_OBS_DIR", str(tmp_path / "obs"))
    _cluster(2, ["rabit_engine=mock", "mode=gbdt", "device=cuda", "ntrees=3", "straggler=0",
                 "straggler_sleep=0.3", "rabit_trace_exit=1"], "torch_gbdt_native_worker.py")
    obs = str(tmp_path / "obs")
    doc, _, report = trace.export_job(obs)
    assert trace.validate_chrome_trace(doc) == []
    job = trace.load_job(obs)
    assert set(job.clocks) == {0, 1} and job.max_clock_err() < 0.5
    assert report["top_stragglers"][0]["rank"] == 0
    assert critical.critical_path_report(job)["top_gating_ranks"][0]["rank"] == 0


# -- quorum rounds and the HA control plane on the card --------------------------

def _card_job_work(ew, rows, nodes, bins):
    """The card's contribution (node_histograms_kernel, one launch at a time
    across the worker threads, counted), and the plain per-contribution
    histogram in numpy for the accounting."""
    import threading

    from rabit_tpu_torch.elastic import shard_slice

    xb, node = ew.make_bins(rows, bins), ew.row_nodes(rows, nodes)
    card, boost_mod = ew.card_contribution(xb, node, nodes, bins)
    lock = threading.Lock()

    def work(v, world, rank):
        with lock:
            return card(v, world, rank)

    def per(v, world, rank):
        sl = shard_slice(rows, world, rank)
        return ew.numpy_hist(xb[sl], node[sl], ew.row_grads(sl.start, sl.stop, v), nodes, bins)

    return work, per, (lambda n: ew.expected_totals(xb, node, n, nodes, bins)), boost_mod


@pytest.mark.gpu
def test_quorum_healing_straggler_with_card_contributions(cuda):
    """chip_smoke.py's quorum run (b) at a small size: world 3, quorum 0.6,
    rank 2 0.4 s late up to version 3; every contribution launches
    node_histograms_kernel on card tensors (skipped ones do not); every
    quorum_met excludes [2], a late block folds as a correction, and the
    states are bitwise equal and equal the record-adjusted totals."""
    ew, dj = _worker_module("torch_elastic_worker"), _worker_module("torch_diag_job")
    work, per, totals, boost_mod = _card_job_work(ew, 4000, 4, 16)
    boost_mod.launches.clear()
    niter = 8
    out = dj.run_job(3, niter, work, quorum="0.6", quorum_wait=0.12, quorum_flag_after=0,
                     straggler=(2, 0.4, 3), iter_sleep=0.05, deadline_sec=90.0)
    res = out["results"]
    states = [res[t].state for t in sorted(res)]
    assert all(r.completed for r in res.values()), {t: r.error for t, r in res.items()}
    assert all(np.array_equal(states[0], s) for s in states[1:])
    qm = [e for e in out["events"] if e["kind"] == "quorum_met"]
    assert qm and all(e["excluded"] == [2] for e in qm) and max(e["version"] for e in qm) < niter
    folded = {(e["src_version"], e["rank"]) for e in out["events"]
              if e["kind"] == "correction_folded"}
    assert folded and any(e["kind"] == "contribution_late" for e in out["events"])
    want = totals(niter)
    for e in qm:
        for r in e["excluded"]:
            if (e["version"], r) not in folded:
                want = want - per(e["version"], e["world"], r)
    assert np.array_equal(states[0], want)
    skipped = sum(r.skipped_contributions for r in res.values())
    assert boost_mod.launches.get("node_histograms_kernel", 0) == 3 * niter - skipped


@pytest.mark.gpu
def test_failover_mid_wave_with_card_contributions(cuda):
    """chip_smoke.py's failover run (a) at a small size: workers 0 and 1
    check in, the primary dies after 0.3 s, worker 2 starts; the wave closes
    on the promoted standby (one tracker_failover, no lease_expired) and
    every state is bitwise the world-1 totals of the card's histograms."""
    ew, dj = _worker_module("torch_elastic_worker"), _worker_module("torch_diag_job")
    work, _per, totals, boost_mod = _card_job_work(ew, 4000, 4, 16)
    boost_mod.launches.clear()
    niter = 4
    out = dj.run_job(3, niter, work, standby=True, kill_primary=0.3, hold_back=(2,),
                     iter_sleep=0.05, deadline_sec=90.0)
    want = totals(niter)
    for res in out["results"].values():
        assert res.completed and np.array_equal(res.state, want), res.error
    kinds = [e["kind"] for e in out["promoted_events"]]
    assert kinds.count("tracker_failover") == 1 and "wave" in kinds
    assert not any(e["kind"] == "lease_expired" for e in out["events"])
    assert boost_mod.launches.get("node_histograms_kernel", 0) == 3 * niter


# -- the relay tier on the card ---------------------------------------------------

@pytest.mark.gpu
def test_relayed_job_with_card_contributions(cuda):
    """chip_smoke.py's relay run (b) at a small size: world 3 behind 2 port
    relays, heartbeats every 0.3 s, quorum 1.0 (the reports ride the
    batches); every contribution launches node_histograms_kernel on card
    tensors; the states are bitwise the world-1 totals, both relays' channels
    came up, the batches carried the quorum reports, the root accepted the
    channels and rank 0's blob uploads only, and no lease expired."""
    ew, dj = _worker_module("torch_elastic_worker"), _worker_module("torch_diag_job")
    work, _per, totals, boost_mod = _card_job_work(ew, 4000, 4, 16)
    boost_mod.launches.clear()
    niter = 6
    out = dj.run_job(3, niter, work, relays=2, heartbeat_sec=0.3, quorum="1.0",
                     iter_sleep=0.05, deadline_sec=90.0)
    want = totals(niter)
    for res in out["results"].values():
        assert res.completed and np.array_equal(res.state, want), res.error
    tel = out["telemetry"]
    assert tel["n_relays_up"] == 2 and tel["n_lease_expired"] == 0
    assert tel["serving"]["batch_msgs"] >= 3 * niter
    assert tel["serving"]["accepts"] <= 2 + niter
    assert boost_mod.launches.get("node_histograms_kernel", 0) == 3 * niter


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 8, 24, 32, 127, 129])
def test_node_histograms_kernel_at_chaos_shapes(cuda, n):
    """The schedule runners' contribution: an [n, 1] bin matrix, every node
    id 0, g = h = 1, 8 bins, n below and past a 128-row block; the kernel
    equals its plain version and np.bincount exactly."""
    from rabit_tpu_torch.ops import hist

    data = np.random.RandomState(n).randint(0, 8, size=n)
    xb = torch.as_tensor(data.astype(np.int32).reshape(n, 1), device=cuda)
    ones = torch.ones(n, device=cuda)
    node = torch.zeros(n, dtype=torch.int32, device=cuda)
    got = hist.node_histograms_kernel(xb, ones, ones, node, 1, 8)
    assert torch.equal(got, hist.node_histograms_kernel_plain(xb, ones, ones, node, 1, 8))
    assert np.array_equal(got[0, 0, :, 0].cpu().numpy(), np.bincount(data, minlength=8))


@pytest.mark.gpu
def test_elastic_schedule_with_card_contributions(cuda):
    """A seeded shrink/grow schedule (seed 7003: a kill without restart, a
    shrink to 3 and a grow-back to 4) with every contribution
    node_histograms_kernel on the card: it converges bitwise (asserted inside
    the runner), and the kernel launched exactly once a contribution."""
    from rabit_tpu_torch import chaos

    boost.launches.clear()
    r = chaos.run_elastic_schedule(7003, device="cuda")
    assert r.outcome == "completed" and r.n_completed >= 1
    assert dict(boost.launches) == {"node_histograms_kernel": r.n_contributions}


# -- the delivery plane on the card -------------------------------------------------

def _card_forest(cuda, n_trees=2):
    """A small forest trained on the card (node_histograms_kernel a level),
    as the tuple of numpy arrays the GBDT worker checkpoints."""
    from rabit_tpu_torch.ops import hist

    rng = np.random.RandomState(17)
    xb = torch.as_tensor(rng.randint(0, B, size=(N, F)).astype(np.int32), device=cuda)
    y = torch.as_tensor((rng.rand(N) > 0.5).astype(np.float32), device=cuda)
    cfg = gbdt.GBDTConfig(n_features=F, n_trees=n_trees, depth=3, n_bins=B)
    state = gbdt.init_state(cfg, N, cuda)
    boost.launches.clear()
    for _ in range(n_trees):
        state = gbdt.train_round(state, xb, y, cfg, lambda *a: hist.node_histograms(*a))
    assert boost.launches.get("node_histograms_kernel", 0) == n_trees * cfg.depth
    return tuple(gbdt.forest_to_numpy(state.forest))


@pytest.fixture
def delivery_api(tmp_path):
    """The api's publishing state pointed at a port tracker behind one port
    relay, restored afterwards."""
    from rabit_tpu_torch import api
    from rabit_tpu_torch.delivery import Publisher
    from rabit_tpu_torch.relay import Relay
    from rabit_tpu_torch.store import CheckpointStore
    from rabit_tpu_torch.tracker.tracker import Tracker

    old = (api._engine, api._publisher, api._ckpt_store, api._ckpt_base)
    tr = Tracker(1, quiet=True).start()
    relay = Relay((tr.host, tr.port), relay_id="r0", flush_sec=0.05).start()
    api._engine = None  # a fresh solo engine at version 0
    api._publisher = Publisher(relay.host, relay.port, task_id="pub-0")
    api._ckpt_store = CheckpointStore(str(tmp_path), 0)
    api._ckpt_base = 0
    try:
        yield api, tr, relay
    finally:
        api._engine, api._publisher, api._ckpt_store, api._ckpt_base = old
        relay.stop()
        tr.stop()


@pytest.mark.gpu
def test_delivery_of_a_card_trained_forest_through_a_relay(cuda, delivery_api):
    """A forest trained on the card, committed through api.checkpoint (store
    on, publishing on): its line and bytes go through a port relay, and a
    subscriber behind the relay fetches the committed blob byte for byte,
    which decodes to the forest."""
    import pickle

    from rabit_tpu_torch.delivery import Subscriber, digest_of

    api, tr, relay = delivery_api
    forest = _card_forest(cuda)
    api.checkpoint(forest)
    committed = api._ckpt_store.load_global(1)
    sub = Subscriber(relay.host, relay.port, task_id="s0", chunk_bytes=4096, poll_sec=0.05)
    line, blob = sub.fetch(sub.wait_for(1, deadline_sec=10.0))
    assert blob == committed and line["digest"] == digest_of(blob) == tr._delivery["digest"]
    _base, inner = api._unwrap(blob)
    for got, want in zip(pickle.loads(inner), forest):
        assert np.array_equal(got, want)


@pytest.mark.gpu
def test_publish_commit_pins_a_card_forest(cuda, delivery_api):
    """api._publish_commit with a card-trained forest's blob pins the
    published version in the store and registers its line."""
    import pickle

    api, tr, _relay = delivery_api

    class Eng:
        def version_number(self):
            return 3

        def obs_event(self, kind, /, **fields):
            pass

    blob = pickle.dumps(_card_forest(cuda, n_trees=1))
    api._publish_commit(Eng(), blob)
    assert api._ckpt_store._pinned == {3}
    assert tr._delivery["version"] == 3 and tr._delivery["size"] == len(blob)
