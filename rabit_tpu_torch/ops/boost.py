"""One GBDT boosting round's fused row passes, as hand-written CUDA kernels.

The counterpart of ``rabit_tpu/ops/boost.py``:

* ``hist_level0``        -- histogram at the root.
* ``hist_level``         -- route rows one level down through the parent
  split tables and histogram the new nodes in the same pass, returning the
  new node ids too.
* ``route_level``        -- route rows to their leaves (final pass).
* ``route_margin_level`` -- route to the leaves and add ``leaf[node]`` to
  the margin (the fused final pass).
* ``leaf_fit``           -- route to the leaves and sum (g, h) per leaf.

Each wrapper takes pre-blocked ``(nb, R, .)`` tensors (``block_rows``),
as the JAX wrappers do.  On a CUDA tensor it launches its kernel from
``csrc/`` (built at first use by ``rabit_tpu_torch._build``) and counts the
launch in ``launches``; on a CPU tensor it runs the plain PyTorch version
beside it (``*_plain``), which repeats the TPU kernel's arithmetic per row
block in block order: the same encodings, ``r_split`` sub-contractions and
decode.  No other device is taken, and nothing falls back.

The plain versions contract in f32: the bf16 hi/lo planes, the i8 planes
(|a|, |b| <= 65) and the 0/1 indicators are exact in f32 (and in TF32),
and an i8 plane's block sum stays below R * 65 < 2**24, so the products
are those of the TPU's bf16 and s8 x s8 -> s32 matmuls.
"""

from __future__ import annotations

import collections
import ctypes

import torch

# Kernel name -> launches, counted where each wrapper launches its kernel.
launches: collections.Counter = collections.Counter()

_TINY = 1.1754944e-38   # smallest normal f32: the i8 scale's floor
_MAX_BINS = 256         # the histogram kernel's threads own one bin each
_MAX_GROUP = 255        # nodes a histogram block holds: ids staged as bytes
_SMEM_LIMIT = 232448    # shared memory one H100 block may use (bytes)
_SMEM_PER_SM = 233472   # an H100 SM's shared memory; a block reserves 1 KB
_SMS = 132              # H100 SXM multiprocessors: sizes the grid from shapes
                        # alone, so the summation order never depends on the card


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_r_split(R: int, r_split: int) -> None:
    if r_split < 1 or R % r_split:
        raise ValueError(
            f"r_split={r_split} must be >= 1 and divide the row block {R}")


# -- blocking helpers ----------------------------------------------------------


def block_rows(x: torch.Tensor, block: int = 1024):
    """Pad a [n, ...] tensor with zeros to a block multiple and reshape to
    (nb, block, k) for the fused kernels.  Returns (blocked, n)."""
    n = x.shape[0]
    n_pad = _round_up(n, block)
    if x.ndim == 1:
        x = x[:, None]
    if n_pad != n:
        x = torch.cat([x, x.new_zeros((n_pad - n, x.shape[1]))])
    return x.reshape(n_pad // block, block, x.shape[1]), n


def unblock_rows(x3: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of block_rows for [nb, R, 1] -> [n]."""
    if x3.shape[-1] == 1:
        return x3.reshape(-1)[:n]
    return x3.reshape(-1, x3.shape[-1])[:n]


# -- plain versions of the kernels' device functions ----------------------------


def _encode_bf16(L: torch.Tensor):
    """Hi/lo-bf16 split of the f32 gradient matrix, stacked along M; the
    planes come back as f32 (exact) so the contraction cannot round."""
    lhi = L.to(torch.bfloat16)
    llo = (L - lhi.float()).to(torch.bfloat16)
    l2 = torch.cat([lhi, llo], 1).float()
    m = L.shape[1]
    return l2, lambda acc2: acc2[:m] + acc2[m:]


def _encode_i8(L: torch.Tensor):
    """Two-plane int8 fixed-point split against the block max (planes as
    exact f32 integers); decode (hi/64 + lo/8192) * scale."""
    m = L.shape[1]
    scale = torch.maximum(L.abs().max(), L.new_tensor(_TINY))
    x = L * (1.0 / scale)
    a = torch.round(x * 64.0)                       # half to even, |a| <= 64
    b = torch.round((x - a * (1.0 / 64.0)) * 8192.0)  # |b| <= 65
    l2 = torch.cat([a, b], 1)

    def decode(acc2):
        return (acc2[:m] * (1.0 / 64.0) + acc2[m:] * (1.0 / 8192.0)) * scale

    return l2, decode


def _gradient_matrix(node, g, h, *, n_nodes: int) -> torch.Tensor:
    """L[r, m]: g_r at column node_r, h_r at column n_nodes+node_r."""
    sel = node[:, None] == torch.arange(n_nodes, device=node.device)
    zero = g.new_zeros(())
    return torch.cat([torch.where(sel, g[:, None], zero),
                      torch.where(sel, h[:, None], zero)], 1)


def _route(xb_blk, node, feat, thr) -> torch.Tensor:
    """node' = 2*node + [x[feat[node]] > thr[node]]."""
    p = node.long()
    xv = xb_blk.gather(1, feat.long()[p][:, None])[:, 0]
    return (node * 2 + (xv > thr[p]).to(node.dtype)).to(torch.int32)


def _accum(xb_blk, L, *, n_bins: int, i8: bool, r_split: int = 1):
    """sum_r L[r, m] * [xb_blk[r, f] == b] -> [m, F*n_bins] for one row
    block: ``r_split`` raw sub-contractions, summed, decoded once."""
    l2, decode = (_encode_i8 if i8 else _encode_bf16)(L)
    R, F = xb_blk.shape
    rs = R // r_split
    bins = torch.arange(n_bins, device=xb_blk.device, dtype=xb_blk.dtype)
    acc2 = None
    for s in range(r_split):
        sl = slice(s * rs, (s + 1) * rs)
        onehot = (xb_blk[sl, :, None] == bins).reshape(rs, F * n_bins).float()
        part = l2[sl].T @ onehot
        acc2 = part if acc2 is None else acc2 + part
    return decode(acc2)


def _hist_plain(xb3, node3, g3, h3, feat, thr, *, n_nodes, n_bins, i8,
                r_split):
    """Plain histogram pass, row block by row block in block order (the
    TPU kernel's sequential grid).  ``node3`` None means the root."""
    nb, R, F = xb3.shape
    out = torch.zeros(2 * n_nodes, F * n_bins, device=xb3.device)
    node_out = torch.empty_like(g3, dtype=torch.int32)
    for i in range(nb):
        if node3 is None:
            node = torch.zeros(R, dtype=torch.int32, device=xb3.device)
        else:
            node = _route(xb3[i], node3[i, :, 0], feat, thr)
        node_out[i, :, 0] = node
        L = _gradient_matrix(node, g3[i, :, 0], h3[i, :, 0], n_nodes=n_nodes)
        out += _accum(xb3[i], L, n_bins=n_bins, i8=i8, r_split=r_split)
    out = out.reshape(2 * n_nodes, F, n_bins)
    return torch.stack([out[:n_nodes], out[n_nodes:]], -1), node_out


def hist_level0_plain(xb3, g3, h3, *, n_bins: int, mxu_i8: bool = False,
                      r_split: int = 1) -> torch.Tensor:
    _check_r_split(xb3.shape[1], r_split)
    return _hist_plain(xb3, None, g3, h3, None, None, n_nodes=1,
                       n_bins=n_bins, i8=mxu_i8, r_split=r_split)[0]


def hist_level_plain(xb3, node3, g3, h3, feat, thr, *, depth: int,
                     n_bins: int, mxu_i8: bool = False, r_split: int = 1):
    _check_r_split(xb3.shape[1], r_split)
    return _hist_plain(xb3, node3, g3, h3, feat, thr, n_nodes=2 ** depth,
                       n_bins=n_bins, i8=mxu_i8, r_split=r_split)


def route_level_plain(xb3, node3, feat, thr, *, depth: int) -> torch.Tensor:
    nb, R, F = xb3.shape
    node = _route(xb3.reshape(nb * R, F), node3.reshape(-1), feat, thr)
    return node.reshape(nb, R, 1)


def route_margin_level_plain(xb3, node3, margin3, feat, thr, leaf, *,
                             depth: int):
    node3 = route_level_plain(xb3, node3, feat, thr, depth=depth)
    return margin3 + leaf[node3.long()], node3


def leaf_fit_plain(xb3, node3, g3, h3, feat, thr, *, depth: int):
    """Plain leaf fit, row block by row block in block order: the hi/lo-bf16
    planes of the leaf gradient matrix summed over the block in f32, hi + lo,
    added into the total."""
    nb = xb3.shape[0]
    n_leaves = 2 ** depth
    total = torch.zeros(2 * n_leaves, device=xb3.device)
    node_out = torch.empty_like(node3)
    for i in range(nb):
        node = _route(xb3[i], node3[i, :, 0], feat, thr)
        node_out[i, :, 0] = node
        L = _gradient_matrix(node, g3[i, :, 0], h3[i, :, 0], n_nodes=n_leaves)
        l2, decode = _encode_bf16(L)
        total += decode(l2.sum(0))
    return torch.stack([total[:n_leaves], total[n_leaves:]], -1), node_out


# -- kernel wrappers ---------------------------------------------------------------


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors (all on one card), False for CPU tensors;
    anything else raises."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _expect(t: torch.Tensor, name: str, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, "
                         f"got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


_bound: dict = {}  # csrc name -> its library with argtypes declared


def _lib(name: str):
    if name in _bound:
        return _bound[name]
    from rabit_tpu_torch import _build

    lib = _build.lib(name)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "hist":
        lib.hist_build.argtypes = [I] + [P] * 10 + [LL] + [I] * 8 + [P]
        lib.hist_build.restype = I
        lib.hist_smem_bytes.argtypes = [I] * 5
        lib.hist_smem_bytes.restype = LL
    else:
        lib.route_level.argtypes = [P] * 5 + [LL, I, I, P]
        lib.route_level.restype = I
        lib.route_margin_level.argtypes = [P] * 8 + [LL, I, I, I, P]
        lib.route_margin_level.restype = I
        lib.leaf_fit.argtypes = [P] * 9 + [I] * 6 + [P]
        lib.leaf_fit.restype = I
        lib.leaf_smem_bytes.argtypes = [I] * 3
        lib.leaf_smem_bytes.restype = LL
    _bound[name] = lib
    return lib


def _hist_chunks(nb: int, cols: int, smem: int) -> int:
    """Row-block chunks of the histogram grid (``cols`` = features x node
    groups blocks per chunk): at most two full waves of the blocks that fit
    on the card's SMs at this shared-memory size (at most 4 a SM, the
    kernel's launch bound), so no third wave runs nearly empty; and no empty
    chunk."""
    per_sm = max(1, min(4, _SMEM_PER_SM // (smem + 1024)))
    target = max(1, min(nb, 2 * _SMS * per_sm // cols))
    per = -(-nb // target)
    return -(-nb // per)


def _hist_groups(lib, i8: bool, n_nodes: int, n_bins: int, R: int,
                 n_prev: int):
    """Nodes per block of the histogram grid: the most whose accumulators
    fit in one block's shared memory beside the staged rows and split
    tables (at most ``_MAX_GROUP``), spread evenly over the fewest groups.
    Returns (group_nodes, n_groups, smem bytes)."""
    smem = lambda k: lib.hist_smem_bytes(int(i8), k, n_bins, R, n_prev)
    if smem(1) > _SMEM_LIMIT:
        raise ValueError(f"one node x {n_bins} bins at row block {R} with "
                         f"{n_prev}-entry split tables needs {smem(1)} B of "
                         f"shared memory, over {_SMEM_LIMIT}")
    lo, hi = 1, min(n_nodes, _MAX_GROUP)
    while lo < hi:  # the largest group that fits
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if smem(mid) <= _SMEM_LIMIT else (lo, mid - 1)
    n_groups = -(-n_nodes // lo)
    group = -(-n_nodes // n_groups)
    return group, n_groups, smem(group)


_MODE = {"root": 0, "route": 1, "nodes": 2}  # csrc/hist.cu hist_build modes


def hist_launch(mode: str, xb, node, g, h, feat, thr, node_out, *,
                n_rows: int, block: int, n_nodes: int, n_bins: int, i8: bool,
                name: str) -> torch.Tensor:
    """Launch csrc/hist.cu on checked, contiguous CUDA tensors: xb holds
    ``n_rows`` rows of F bins in row blocks of ``block`` rows (pre-blocked
    or not: the same bytes), the last one possibly short in the "nodes"
    mode.  Returns the [n_nodes, F, n_bins, 2] histogram and counts the
    launch under ``name``."""
    F = xb.shape[-1]
    if n_bins > _MAX_BINS or block % 256 or block > 65536:
        raise ValueError(f"histogram kernel needs n_bins <= {_MAX_BINS} and a "
                         f"row block that is a multiple of 256 up to 65536 "
                         f"(got {n_bins}, {block})")
    if mode != "nodes" and n_rows % block:
        raise ValueError(f"{mode} mode takes whole row blocks ({n_rows} rows, "
                         f"block {block})")
    dev = xb.device
    if n_rows == 0 or F == 0:
        return torch.zeros((n_nodes, F, n_bins, 2), device=dev)
    out = torch.empty((n_nodes, F, n_bins, 2), device=dev)
    lib = _lib("hist")
    n_prev = 0 if feat is None else feat.shape[0]
    group, n_groups, smem = _hist_groups(lib, i8, n_nodes, n_bins, block, n_prev)
    nb = -(-n_rows // block)
    n_chunks = _hist_chunks(nb, F * n_groups, smem)
    scale = torch.empty(nb, device=dev) if i8 else None
    partial = torch.empty((n_chunks, n_nodes, F, n_bins, 2), device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hist_build(_MODE[mode], _ptr(xb), _ptr(node), _ptr(g), _ptr(h),
                            _ptr(feat), _ptr(thr), _ptr(node_out), _ptr(scale),
                            _ptr(partial), _ptr(out), n_rows, block, F, n_bins,
                            n_nodes, n_prev, group, n_chunks, int(i8), stream)
    _check(rc, name)
    launches[name] += 1
    return out


def _hist_cuda(xb3, node3, g3, h3, feat, thr, *, n_nodes, n_bins, i8, name):
    nb, R, F = xb3.shape
    _expect(xb3, "xb3", (nb, R, F), torch.int32)
    _expect(g3, "g3", (nb, R, 1), torch.float32)
    _expect(h3, "h3", (nb, R, 1), torch.float32)
    node_out = None
    if node3 is not None:
        n_prev = n_nodes // 2
        _expect(node3, "node3", (nb, R, 1), torch.int32)
        _expect(feat, "feat", (n_prev,), torch.int32)
        _expect(thr, "thr", (n_prev,), torch.int32)
        node_out = torch.empty_like(node3)
    out = hist_launch("root" if node3 is None else "route", xb3, node3, g3, h3,
                      feat, thr, node_out, n_rows=nb * R, block=R,
                      n_nodes=n_nodes, n_bins=n_bins, i8=i8, name=name)
    return out, node_out


def hist_level0(xb3, g3, h3, *, n_bins: int, mxu_i8: bool = False,
                r_split: int = 1) -> torch.Tensor:
    """Root histogram; [1, F, B, 2].  ``r_split`` shapes only the plain
    version's sub-contractions (the kernel's result does not depend on it).

    Replaces rabit_tpu/ops/boost.py hist_level0 (_level0_kernel).  Bound on
    an H100 by device memory (xb, g, h read once); csrc/hist.cu says how its
    design keeps the sum in a fixed order without atomics."""
    _check_r_split(xb3.shape[1], r_split)
    if not _on_cuda(xb3, g3, h3):
        return hist_level0_plain(xb3, g3, h3, n_bins=n_bins, mxu_i8=mxu_i8,
                                 r_split=r_split)
    return _hist_cuda(xb3, None, g3, h3, None, None, n_nodes=1, n_bins=n_bins,
                      i8=mxu_i8, name="hist_level0")[0]


def hist_level(xb3, node3, g3, h3, feat, thr, *, depth: int, n_bins: int,
               mxu_i8: bool = False, r_split: int = 1):
    """Route one level down and histogram; returns ([2**depth, F, B, 2],
    node3').  ``feat``/``thr`` are the level-(depth-1) split tables, shape
    [2**(depth-1)].  ``r_split``: see hist_level0.

    Replaces rabit_tpu/ops/boost.py hist_level (_level_kernel).  Bound on an
    H100 by device memory (xb, node, g, h read once, node' written once);
    design in csrc/hist.cu."""
    _check_r_split(xb3.shape[1], r_split)
    if not _on_cuda(xb3, node3, g3, h3, feat, thr):
        return hist_level_plain(xb3, node3, g3, h3, feat, thr, depth=depth,
                                n_bins=n_bins, mxu_i8=mxu_i8, r_split=r_split)
    return _hist_cuda(xb3, node3, g3, h3, feat, thr, n_nodes=2 ** depth,
                      n_bins=n_bins, i8=mxu_i8, name="hist_level")


def _route_checks(xb3, node3, feat, thr, depth):
    nb, R, F = xb3.shape
    n_prev = 2 ** (depth - 1)
    _expect(xb3, "xb3", (nb, R, F), torch.int32)
    _expect(node3, "node3", (nb, R, 1), torch.int32)
    _expect(feat, "feat", (n_prev,), torch.int32)
    _expect(thr, "thr", (n_prev,), torch.int32)
    return nb * R, F, n_prev


def route_level(xb3, node3, feat, thr, *, depth: int) -> torch.Tensor:
    """Route rows one level down through the level-(depth-1) split tables
    (no histogram); returns node3'.

    Replaces rabit_tpu/ops/boost.py route_level (_route_kernel).  Bound on
    an H100 by device memory: one bin per row, node in and out; design in
    csrc/route.cu."""
    if not _on_cuda(xb3, node3, feat, thr):
        return route_level_plain(xb3, node3, feat, thr, depth=depth)
    n_rows, F, n_prev = _route_checks(xb3, node3, feat, thr, depth)
    lib = _lib("route")
    node_out = torch.empty_like(node3)
    with torch.cuda.device(xb3.device):
        stream = torch.cuda.current_stream(xb3.device).cuda_stream
        rc = lib.route_level(_ptr(xb3), _ptr(node3), _ptr(feat), _ptr(thr),
                             _ptr(node_out), n_rows, F, n_prev, stream)
    _check(rc, "route_level")
    launches["route_level"] += 1
    return node_out


def route_margin_level(xb3, node3, margin3, feat, thr, leaf, *, depth: int):
    """Route rows to their leaves and apply ``margin += leaf[node]`` in the
    same pass; returns (margin3', leaf_node3).

    Replaces rabit_tpu/ops/boost.py route_margin_level
    (_route_margin_kernel).  Bound on an H100 by device memory: one bin per
    row, node and margin in and out; design in csrc/route.cu."""
    if not _on_cuda(xb3, node3, margin3, feat, thr, leaf):
        return route_margin_level_plain(xb3, node3, margin3, feat, thr, leaf,
                                        depth=depth)
    n_rows, F, n_prev = _route_checks(xb3, node3, feat, thr, depth)
    _expect(margin3, "margin3", tuple(node3.shape), torch.float32)
    _expect(leaf, "leaf", (2 ** depth,), torch.float32)
    lib = _lib("route")
    node_out = torch.empty_like(node3)
    margin_out = torch.empty_like(margin3)
    with torch.cuda.device(xb3.device):
        stream = torch.cuda.current_stream(xb3.device).cuda_stream
        rc = lib.route_margin_level(
            _ptr(xb3), _ptr(node3), _ptr(margin3), _ptr(feat), _ptr(thr),
            _ptr(leaf), _ptr(margin_out), _ptr(node_out), n_rows, F, n_prev,
            2 ** depth, stream)
    _check(rc, "route_margin_level")
    launches["route_margin_level"] += 1
    return margin_out, node_out


def leaf_fit(xb3, node3, g3, h3, feat, thr, *, depth: int):
    """Route rows to their leaves and sum (g, h) per leaf in the hi/lo-bf16
    planes; returns ([2**depth, 2], leaf_node3).  ``feat``/``thr`` are the
    level-(depth-1) split tables.  No training round calls it: the rounds
    read leaf masses off the last histogram (``split_child_masses``).

    Replaces rabit_tpu/ops/boost.py leaf_fit (_leaf_kernel).  Bound on an
    H100 by device memory: one bin per row, node, g and h in, leaf id out;
    design in csrc/route.cu."""
    if not _on_cuda(xb3, node3, g3, h3, feat, thr):
        return leaf_fit_plain(xb3, node3, g3, h3, feat, thr, depth=depth)
    nb, R, F = xb3.shape
    n_leaves = 2 ** depth
    _route_checks(xb3, node3, feat, thr, depth)
    _expect(g3, "g3", (nb, R, 1), torch.float32)
    _expect(h3, "h3", (nb, R, 1), torch.float32)
    if R % 256:
        raise ValueError(f"leaf_fit needs a row block that is a multiple of "
                         f"256 (got {R})")
    lib = _lib("route")
    acc_warps = next((w for w in (8, 4, 2, 1)
                      if lib.leaf_smem_bytes(R, n_leaves, w) <= _SMEM_LIMIT), 0)
    if not acc_warps:
        raise ValueError(f"leaf_fit: {n_leaves} leaves at row block {R} need "
                         f"{lib.leaf_smem_bytes(R, n_leaves, 1)} B of shared "
                         f"memory, over {_SMEM_LIMIT}")
    dev = xb3.device
    node_out = torch.empty_like(node3)
    if nb == 0:
        return torch.zeros((n_leaves, 2), device=dev), node_out
    out = torch.empty((n_leaves, 2), device=dev)
    per = -(-nb // min(nb, 2 * _SMS))  # chunks from the shapes alone
    n_chunks = -(-nb // per)
    partial = torch.empty((n_chunks, n_leaves, 2), device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.leaf_fit(_ptr(xb3), _ptr(node3), _ptr(g3), _ptr(h3), _ptr(feat),
                          _ptr(thr), _ptr(node_out), _ptr(partial), _ptr(out),
                          nb, R, F, n_leaves, acc_warps, n_chunks, stream)
    _check(rc, "leaf_fit")
    launches["leaf_fit"] += 1
    return out, node_out
