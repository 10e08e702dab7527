"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``gpu`` and skips where there is no CUDA device.
The file imports no JAX (the machine with the card has none), so it runs
there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m gpu

The plain versions themselves are held against the JAX package on the CPU
in test_torch_boost.py and test_torch_gbdt.py.  Tolerances: histograms
rtol=1e-5, atol=1e-5 (the kernel sums in another order); node ids and
margins exact.
"""

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
