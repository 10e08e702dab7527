"""The port's fused row passes (rabit_tpu_torch.ops.boost) against the JAX
package's Pallas kernels, run in the Pallas interpreter on the CPU.

The same numpy inputs go through both.  Histograms agree within rtol=1e-5,
atol=1e-5 (the encodings are the same; only the f32 summation order may
differ); node ids and margins are integer routing and one f32 add, so they
agree exactly.  The CUDA kernels are held against these plain versions
in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu.ops import boost as jboost
from rabit_tpu_torch.ops import boost as tboost

N, F, B, BLOCK = 600, 5, 16, 256   # 600 rows: the last block has 168 pad rows


def _inputs(seed, d):
    """Blocked numpy inputs for level d (d=0: the root)."""
    rng = np.random.RandomState(seed)
    xb = rng.randint(0, B, size=(N, F)).astype(np.int32)
    g = rng.randn(N).astype(np.float32)
    h = rng.rand(N).astype(np.float32)
    xb3, _ = jboost.block_rows(jnp.asarray(xb), BLOCK)
    g3, _ = jboost.block_rows(jnp.asarray(g), BLOCK)
    h3, _ = jboost.block_rows(jnp.asarray(h), BLOCK)
    n_prev = max(1, 2 ** (d - 1))
    node3 = rng.randint(0, n_prev, size=g3.shape).astype(np.int32)
    feat = rng.randint(0, F, size=n_prev).astype(np.int32)
    thr = rng.randint(0, B, size=n_prev).astype(np.int32)
    leaf = rng.randn(2 ** max(d, 1)).astype(np.float32)
    margin3 = rng.randn(*g3.shape).astype(np.float32)
    return {k: np.asarray(v) for k, v in dict(
        xb3=xb3, g3=g3, h3=h3, node3=node3, feat=feat, thr=thr, leaf=leaf,
        margin3=margin3).items()}


def _t(a, device="cpu"):
    return torch.as_tensor(np.array(a), device=device)


@pytest.mark.parametrize("r_split", [1, 2])
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_hist_level0_matches_jax(mxu_i8, r_split):
    x = _inputs(0, 0)
    ref = jboost.hist_level0(jnp.asarray(x["xb3"]), jnp.asarray(x["g3"]),
                             jnp.asarray(x["h3"]), n_bins=B, interpret=True,
                             mxu_i8=mxu_i8, r_split=r_split)
    got = tboost.hist_level0(_t(x["xb3"]), _t(x["g3"]), _t(x["h3"]), n_bins=B,
                             mxu_i8=mxu_i8, r_split=r_split)
    assert got.shape == (1, F, B, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,r_split", [(1, 1), (2, 1), (2, 2), (3, 1), (13, 1)])
@pytest.mark.parametrize("mxu_i8", [False, True])
def test_hist_level_matches_jax(mxu_i8, d, r_split):
    x = _inputs(11 + d, d)
    jargs = [jnp.asarray(x[k]) for k in ("xb3", "node3", "g3", "h3", "feat", "thr")]
    ref_h, ref_n = jboost.hist_level(*jargs, depth=d, n_bins=B, interpret=True,
                                     mxu_i8=mxu_i8, r_split=r_split)
    targs = [_t(x[k]) for k in ("xb3", "node3", "g3", "h3", "feat", "thr")]
    got_h, got_n = tboost.hist_level(*targs, depth=d, n_bins=B, mxu_i8=mxu_i8,
                                     r_split=r_split)
    assert got_h.shape == (2 ** d, F, B, 2) and got_n.shape == x["node3"].shape
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), rtol=1e-5, atol=1e-5)


def test_r_split_must_divide_the_block():
    x = _inputs(1, 2)
    targs = [_t(x[k]) for k in ("xb3", "node3", "g3", "h3", "feat", "thr")]
    with pytest.raises(ValueError, match="divide the row block"):
        tboost.hist_level(*targs, depth=2, n_bins=B, r_split=3)
    with pytest.raises(ValueError, match="divide the row block"):
        tboost.hist_level0(targs[0], targs[2], targs[3], n_bins=B, r_split=0)


@pytest.mark.parametrize("depth", [1, 3, 13])
def test_route_level_matches_jax(depth):
    x = _inputs(5, depth)
    ref = jboost.route_level(*(jnp.asarray(x[k]) for k in ("xb3", "node3", "feat", "thr")),
                             depth=depth, interpret=True)
    got = tboost.route_level(*(_t(x[k]) for k in ("xb3", "node3", "feat", "thr")),
                             depth=depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("depth", [1, 3, 13])
def test_route_margin_level_matches_jax(depth):
    keys = ("xb3", "node3", "margin3", "feat", "thr", "leaf")
    x = _inputs(6, depth)
    ref_m, ref_n = jboost.route_margin_level(*(jnp.asarray(x[k]) for k in keys),
                                             depth=depth, interpret=True)
    got_m, got_n = tboost.route_margin_level(*(_t(x[k]) for k in keys), depth=depth)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))


def _bad_route_inputs(case):
    x = {k: _t(v) for k, v in _inputs(7, 3).items()}
    if case == "feat":
        x["feat"] = x["feat"][:2]
    elif case == "node3":
        x["node3"] = x["node3"].float()
    elif case == "xb3":
        x["xb3"] = x["xb3"].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "no feature":
        x["xb3"] = x["xb3"][..., :0]
    elif case == "margin3":
        x["margin3"] = x["margin3"].double()
    elif case == "leaf":
        x["leaf"] = x["leaf"][:4]
    return x


@pytest.mark.parametrize("case,depth,match", [
    ("feat", 3, "feat: expected"), ("node3", 3, "node3: expected"),
    ("xb3", 3, "xb3 must be contiguous"), ("no feature", 3, "no feature"),
    ("margin3", 3, "margin3: expected"), ("leaf", 3, "leaf: expected"),
    ("none", 0, "depths 1 to 31"), ("none", 32, "depths 1 to 31")])
def test_route_checks_refuse_what_the_kernels_do_not_take(case, depth, match):
    """The checks the route wrappers run before a launch (on CPU tensors
    here: they read only shapes, dtypes and layout)."""
    x = _bad_route_inputs(case)
    with pytest.raises(ValueError, match=match):
        tboost._route_checks(x["xb3"], x["node3"], x["feat"], x["thr"], depth,
                             x["margin3"], x["leaf"])


def test_route_checks_pass_good_inputs():
    x = _bad_route_inputs("none")
    nb, R, F = x["xb3"].shape
    assert tboost._route_checks(x["xb3"], x["node3"], x["feat"], x["thr"], 3,
                                x["margin3"], x["leaf"]) == (nb * R, F)
    assert tboost._route_checks(x["xb3"], x["node3"], x["feat"], x["thr"], 3) == (nb * R, F)


def test_block_rows_pads_like_jax():
    rng = np.random.RandomState(2)
    for a in (rng.randn(N).astype(np.float32),
              rng.randint(0, B, size=(N, F)).astype(np.int32)):
        ref, n_ref = jboost.block_rows(jnp.asarray(a), BLOCK)
        got, n = tboost.block_rows(torch.as_tensor(a), BLOCK)
        assert n == n_ref == N
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(tboost.unblock_rows(got, n).numpy(),
                                      np.asarray(jboost.unblock_rows(ref, n)))


@pytest.mark.parametrize("mxu_i8", [False, True])
def test_padded_rows_add_nothing(mxu_i8):
    """Zero-padded rows are routed (their ids match JAX above) but carry
    g = h = 0: whatever bins they hold, the histogram is the same."""
    x = _inputs(3, 0)
    xb3 = _t(x["xb3"])
    moved = xb3.clone()
    moved.reshape(-1, F)[N:] = 7
    got = [tboost.hist_level0(a, _t(x["g3"]), _t(x["h3"]), n_bins=B, mxu_i8=mxu_i8)
           for a in (xb3, moved)]
    assert torch.equal(got[0], got[1])


def test_no_kernel_for_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused, never moved."""
    x = _inputs(4, 0)
    meta = lambda k: torch.empty(x[k].shape, dtype=_t(x[k]).dtype, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tboost.hist_level0(meta("xb3"), meta("g3"), meta("h3"), n_bins=B)
    with pytest.raises(ValueError, match="tensors on"):
        tboost.hist_level0(_t(x["xb3"]), meta("g3"), meta("h3"), n_bins=B)
