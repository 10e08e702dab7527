"""The histogram path's helpers (rabit_tpu_torch.ops.boost hist_prep,
hist_partition, hist_accumulate) through their plain twins on the CPU.

The partition is held against numpy's stable argsort and the chunk rules;
the histogram summed through the partitioned order against the plain
twins of the whole kernels (``hist_level_plain``,
``node_histograms_kernel_plain``) and against the JAX package's Pallas
kernels in the interpreter, at rtol = atol = 1e-5 (the encodings are the
same; only the f32 summation order differs).  The CUDA kernels are held
against these twins in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu.ops import boost as jboost
from rabit_tpu.ops import hist as jhist
from rabit_tpu_torch.ops import boost
from rabit_tpu_torch.ops import hist

F, B, R, C = 5, 16, 256, 300   # 300-row chunks: several a node, cut mid-node


def _case(name, seed=0):
    """Seeded rows for the "nodes" mode: (n, n_nodes, xb, g, h, node)."""
    rng = np.random.RandomState(seed + len(name))
    n, n_nodes = {"nodes64": (1500, 64), "nodes128": (2000, 128),
                  "nodes8192": (1500, 8192)}.get(name, (1500, 6))
    node = rng.randint(0, n_nodes, size=n)
    if name == "skewed":       # one node holds about 90% of the rows
        node = np.where(rng.rand(n) < 0.9, 2, node)
    elif name == "empty":      # nodes 1 and 4 hold no row
        node = np.where(np.isin(node, [1, 4]), 0, node)
    elif name == "foreign":    # ids outside [0, n_nodes) add nothing
        node[::7] = n_nodes
        node[3::11] = -1
    elif name == "aligned":    # whole row blocks (1500 rows elsewhere: short last)
        n = 1280
        node = node[:n]
    g = rng.randn(n).astype(np.float32)
    if name == "outlier":      # one |g| 1e4 times the rest: the i8 scale of
        g[5] = 3.0e4           # its row block is set by it
    return (n, n_nodes, rng.randint(0, B, size=(n, F)).astype(np.int32), g,
            rng.rand(n).astype(np.float32), node.astype(np.int32))


CASES = ["uniform", "skewed", "empty", "foreign", "aligned", "outlier", "nodes64",
         "nodes128", "nodes8192"]  # 8192: past the card's shared-memory partition


def _partition(name, i8):
    n, n_nodes, xb, g, h, node = _case(name)
    t = [torch.as_tensor(a) for a in (xb, g, h, node)]
    kw = dict(n_rows=n, block=R, n_nodes=n_nodes, i8=i8)
    key, counts, scale = boost.hist_prep("nodes", t[0], t[3], t[1], t[2], None,
                                         None, **kw)
    part = boost.hist_partition(key, t[1], t[2], counts, scale, chunk_rows=C, **kw)
    return (n, n_nodes, xb, g, h, node), t, counts, scale, part


@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_partition_plain_matches_stable_argsort(name, mxu_i8):
    (n, n_nodes, xb, g, h, node), _, counts, scale, part = _partition(name, mxu_i8)
    ok = (node >= 0) & (node < n_nodes)
    order = np.argsort(np.where(ok, node, n_nodes), kind="stable")[:ok.sum()]
    np.testing.assert_array_equal(part.perm.numpy(), order)
    blk = np.arange(n) // R
    want = np.zeros((-(-n // R), n_nodes), np.int64)
    np.add.at(want, (blk[ok], node[ok]), 1)
    np.testing.assert_array_equal(counts.numpy(), want)
    np.testing.assert_array_equal(part.node_base.numpy(),
                                  np.concatenate([[0], np.cumsum(want.sum(0))]))
    # the i8 block scales: max |g|, |h| over the block's counted rows
    if mxu_i8:
        m = np.where(ok, np.maximum(np.abs(g), np.abs(h)), 0.0)
        want_scale = np.maximum([m[blk == b].max() for b in range(len(want))],
                                np.float32(1.1754944e-38)).astype(np.float32)
        np.testing.assert_array_equal(scale.numpy(), want_scale)
    else:
        assert scale is None
    # the planes are each listed row's encoding, at its row block's scale
    gv, hv = torch.as_tensor(g[order]), torch.as_tensor(h[order])
    if mxu_i8:
        inv = 1.0 / scale[torch.as_tensor(order // R)]
        for col, v in ((0, gv), (2, hv)):
            x = v * inv
            a = torch.round(x * 64.0)
            b = torch.round((x - a / 64.0) * 8192.0)
            assert torch.equal(part.planes[:, col].float(), a)
            assert torch.equal(part.planes[:, col + 1].float(), b)
    else:
        for col, v in ((0, gv), (2, hv)):
            hi = v.to(torch.bfloat16)
            assert torch.equal(part.planes[:, col], hi)
            assert torch.equal(part.planes[:, col + 1], (v - hi.float()).to(torch.bfloat16))


@pytest.mark.parametrize("name", CASES)
def test_chunks_cut_on_row_blocks_inside_one_node(name):
    (n, n_nodes, _, _, _, node), _, _, _, part = _partition(name, False)
    perm = part.perm.numpy()
    n_chunks, n_listed = int(part.node_chunk0[-1]), int(part.node_base[-1])
    assert n_chunks <= -(-n // C) + n_nodes
    bounds = part.chunk_begin.numpy().tolist() + [n_listed]
    assert bounds == sorted(bounds) and len(bounds) == n_chunks + 1
    c0 = part.node_chunk0.numpy()
    for c in range(n_chunks):
        lo, hi = bounds[c], bounds[c + 1]
        assert hi > lo
        nodes = np.unique(node[perm[lo:hi]])
        assert len(nodes) == 1  # inside one node ...
        m = int(nodes[0])
        assert c0[m] <= c < c0[m + 1]
        # ... and on a row-block boundary: the previous listed row of the
        # node lies in an earlier row block
        if lo > part.node_base[m]:
            assert perm[lo] // R > perm[lo - 1] // R
        # a chunk holds the rows from one multiple of C of its node's
        # positions to the next, rounded out to whole row-block runs
        assert hi - lo < C + 2 * R
    # an empty node has no chunk; every other node at least one
    sizes = np.bincount(node[(node >= 0) & (node < n_nodes)], minlength=n_nodes)
    np.testing.assert_array_equal(np.diff(c0) > 0, sizes > 0)


@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("name", CASES)
def test_partitioned_histogram_matches_plain_twin(name, mxu_i8):
    (n, n_nodes, *_), t, _, scale, part = _partition(name, mxu_i8)
    got = boost.hist_accumulate(t[0], part, scale, block=R, n_nodes=n_nodes,
                                n_bins=B, i8=mxu_i8, name="node_histograms_kernel")
    ref = hist.node_histograms_kernel_plain(t[0], t[1], t[2], t[3], n_nodes, B,
                                            block_rows=R, mxu_i8=mxu_i8)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("name", ["skewed", "foreign", "nodes64"])
def test_partitioned_histogram_matches_pallas(name, mxu_i8):
    n, n_nodes, xb, g, h, node = _case(name)
    ref = jhist.node_histograms_pallas(*map(jnp.asarray, (xb, g, h, node)),
                                       n_nodes, B, block_rows=R, interpret=True,
                                       mxu_i8=mxu_i8)
    got = boost.hist_launch("nodes", *map(torch.as_tensor, (xb, node, g, h)),
                            None, None, n_rows=n, block=R, n_nodes=n_nodes,
                            n_bins=B, i8=mxu_i8, name="node_histograms_kernel")
    assert got[1] is None
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("d", [0, 2, 6, 7])
def test_routed_partition_matches_hist_level(d, mxu_i8):
    """The route and root modes: prep routes once, the partition lists the
    rows by their new node, the histogram through it matches
    hist_level_plain / hist_level0_plain and, at d <= 2, the Pallas
    kernels in the interpreter."""
    rng = np.random.RandomState(70 + d)
    n = 1536
    n_prev = max(1, 2 ** (d - 1))
    xb3 = rng.randint(0, B, size=(n // R, R, F)).astype(np.int32)
    g3 = rng.randn(n // R, R, 1).astype(np.float32)
    h3 = rng.rand(n // R, R, 1).astype(np.float32)
    node3 = rng.randint(0, n_prev, size=g3.shape).astype(np.int32)
    node3[:, :200] = 0  # a heavy node
    feat = rng.randint(0, F, size=n_prev).astype(np.int32)
    thr = rng.randint(0, B, size=n_prev).astype(np.int32)
    arrs = (xb3, node3, g3, h3, feat, thr)
    t = [torch.as_tensor(a) for a in arrs]
    kw = dict(n_rows=n, block=R, n_nodes=2 ** d, n_bins=B, i8=mxu_i8, name="hist_level")
    if d == 0:
        got, node_out = boost.hist_launch("root", t[0], None, t[2], t[3], None, None, **kw)
        ref = boost.hist_level0_plain(t[0], t[2], t[3], n_bins=B, mxu_i8=mxu_i8)
        assert node_out is None
    else:
        got, node_out = boost.hist_launch("route", *t[:4], t[4], t[5], **kw)
        ref, ref_node = boost.hist_level_plain(*t, depth=d, n_bins=B, mxu_i8=mxu_i8)
        assert torch.equal(node_out, ref_node)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    if d > 2:
        return
    j = list(map(jnp.asarray, arrs))
    if d == 0:
        jref = jboost.hist_level0(j[0], j[2], j[3], n_bins=B, interpret=True,
                                  mxu_i8=mxu_i8)
    else:
        jref, jnode = jboost.hist_level(*j, depth=d, n_bins=B, interpret=True,
                                        mxu_i8=mxu_i8)
        np.testing.assert_array_equal(node_out.numpy(), np.asarray(jnode))
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), rtol=1e-5, atol=1e-5)


def test_chunk_table_plain_on_hand_made_counts():
    """Two row blocks, three nodes, chunks of 4 rows.  Node 0 holds 3 + 6
    rows: both runs hold a multiple of 4 (positions 0-2 and 3-8), so two
    chunks.  Node 1 holds none.  Node 2 holds 0 + 5 rows: one run, one
    chunk, though it holds positions 0 and 4."""
    counts = torch.tensor([[3, 0, 0], [6, 0, 5]], dtype=torch.int32)
    begin, chunk0, base = boost.chunk_table_plain(counts, 4)
    assert base.tolist() == [0, 9, 9, 14]
    assert chunk0.tolist() == [0, 2, 2, 3]
    assert begin.tolist() == [0, 3, 9]


@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("n_nodes", [8192, 16384])
def test_hist_launch_past_4096_nodes_matches_pallas(n_nodes, mxu_i8):
    """More nodes than the card's shared-memory partition holds (the card
    takes its sorting path there): hist_launch on CPU tensors equals the
    Pallas kernel in the interpreter at 8192 and 16384 nodes."""
    rng = np.random.RandomState(n_nodes)
    n = 512
    xb = rng.randint(0, B, size=(n, F)).astype(np.int32)
    g, h = rng.randn(n).astype(np.float32), rng.rand(n).astype(np.float32)
    node = rng.randint(0, n_nodes, size=n).astype(np.int32)
    node[::5] = rng.randint(0, 4, size=len(node[::5]))  # a few nodes hold several rows
    ref = jhist.node_histograms_pallas(*map(jnp.asarray, (xb, g, h, node)),
                                       n_nodes, B, block_rows=R, interpret=True,
                                       mxu_i8=mxu_i8)
    got, node_out = boost.hist_launch("nodes", *map(torch.as_tensor, (xb, node, g, h)),
                                      None, None, n_rows=n, block=R, n_nodes=n_nodes,
                                      n_bins=B, i8=mxu_i8, name="node_histograms_kernel")
    assert node_out is None and got.shape == (n_nodes, F, B, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mxu_i8", [False, True])
@pytest.mark.parametrize("mode", ["root", "route", "nodes"])
@pytest.mark.parametrize("n_bins,block", [(300, 256), (512, 256), (16, 128), (16, 16384)],
                         ids=["300bins", "512bins", "block128", "block16384"])
def test_hist_launch_bins_and_row_blocks_match_pallas(n_bins, block, mode, mxu_i8):
    """Past 256 bins (the card's tile kernel then takes bin windows) and at
    row blocks of 128 and 16384 rows: hist_launch on CPU tensors, in every
    mode, equals the Pallas kernels in the interpreter, which pad the bins
    to a multiple of 128 and take those blocks.  Two row blocks each, so the
    i8 scale is taken per block; the nodes mode's last block is short."""
    rng = np.random.RandomState(n_bins + block)
    n, n_feat, d = 2 * block if block > 256 else 1024, 3, 2
    n_prev, n_nodes = 2 ** (d - 1), 2 ** d
    xb = rng.randint(0, n_bins, size=(n, n_feat)).astype(np.int32)
    g, h = rng.randn(n).astype(np.float32), rng.rand(n).astype(np.float32)
    kw = dict(block=block, n_bins=n_bins, i8=mxu_i8, name="hist_level")
    if mode == "nodes":
        n -= 100
        xb, g, h = xb[:n], g[:n], h[:n]
        node = rng.randint(0, n_nodes + 1, size=n).astype(np.int32)  # n_nodes: foreign
        ref = jhist.node_histograms_pallas(*map(jnp.asarray, (xb, g, h, node)), n_nodes,
                                           n_bins, block_rows=block, interpret=True,
                                           mxu_i8=mxu_i8)
        got, _ = boost.hist_launch("nodes", *map(torch.as_tensor, (xb, node, g, h)),
                                   None, None, n_rows=n, n_nodes=n_nodes, **kw)
    else:
        blk = lambda a: a.reshape(n // block, block, -1)
        xb3, g3, h3 = blk(xb), blk(g), blk(h)
        node3 = rng.randint(0, n_prev, size=g3.shape).astype(np.int32)
        feat = rng.randint(0, n_feat, size=n_prev).astype(np.int32)
        thr = rng.randint(0, n_bins, size=n_prev).astype(np.int32)
        j = [jnp.asarray(a) for a in (xb3, node3, g3, h3, feat, thr)]
        t = [torch.as_tensor(a) for a in (xb3, node3, g3, h3, feat, thr)]
        if mode == "root":
            ref = jboost.hist_level0(j[0], j[2], j[3], n_bins=n_bins, interpret=True,
                                     mxu_i8=mxu_i8)
            got, _ = boost.hist_launch("root", t[0], None, t[2], t[3], None, None,
                                       n_rows=n, n_nodes=1, **kw)
        else:
            ref, jnode = jboost.hist_level(*j, depth=d, n_bins=n_bins, interpret=True,
                                           mxu_i8=mxu_i8)
            got, node_out = boost.hist_launch("route", *t, n_rows=n, n_nodes=n_nodes, **kw)
            np.testing.assert_array_equal(node_out.numpy(), np.asarray(jnode))
    assert got.shape == (1 if mode == "root" else n_nodes, n_feat, n_bins, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block", [64, 200, 16384 + 128])
def test_hist_launch_refuses_row_blocks_the_kernels_do_not_take(block):
    x = torch.zeros((block, F), dtype=torch.int32)
    v = torch.zeros(block)
    with pytest.raises(ValueError, match="multiple of 128 from 128 to 16384"):
        boost.hist_launch("root", x, None, v, v, None, None, n_rows=block, block=block,
                          n_nodes=1, n_bins=B, i8=False, name="hist_level0")
