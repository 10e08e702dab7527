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

The three histogram kernels (these two and ``ops.hist``'s
``node_histograms_kernel``) share one path on the card (``hist_launch``):
``hist_prep`` routes once and counts rows per node, ``hist_partition``
lists the rows by node with their encoded gradients, and
``hist_accumulate`` histograms that list in feature tiles.  The helpers'
launches are counted in ``helper_launches``; each has a plain twin.

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
from typing import NamedTuple

import torch

# Kernel name -> launches, counted where each wrapper launches its kernel.
launches: collections.Counter = collections.Counter()
# The histogram path's helper kernels (hist_prep, hist_partition) -> launches,
# apart from ``launches``, which counts the histogram kernels themselves.
helper_launches: collections.Counter = collections.Counter()

_TINY = 1.1754944e-38   # smallest normal f32: the i8 scale's floor
_SORT_NODES = 256       # past this many nodes the partition takes its sorting
                        # path (faster there, slower below: PERF.md §6)
_BLOCK_STEP = 128       # row blocks the kernels take: multiples of 128 ...
_MAX_BLOCK = 16384      # ... up to 16384 rows, as the JAX kernels take
_CHUNK_ROWS = 4096      # rows of the partitioned order a histogram block takes
                        # (about): a constant, so the sum order depends on the
                        # shapes and the data alone
_SMEM_LIMIT = 232448    # shared memory one H100 block may use (bytes)
_MAX_ROUTE_DEPTH = 31   # route kernels: leaf ids 2*node + 1 stay below 2**31


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _check_block(block: int, what: str) -> None:
    if block % _BLOCK_STEP or not _BLOCK_STEP <= block <= _MAX_BLOCK:
        raise ValueError(f"{what} takes row blocks that are a multiple of "
                         f"{_BLOCK_STEP} from {_BLOCK_STEP} to {_MAX_BLOCK} "
                         f"rows (got {block})")


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


# -- plain versions of the histogram path's helper kernels -----------------------


class Partition(NamedTuple):
    """The rows of a histogram pass in node order (csrc/hist.cu partition).

    ``perm`` lists the counted rows (id in [0, n_nodes), below n_rows),
    node by node, each node's rows in row order (None at the root, where
    the order is the identity); ``planes[k]`` holds the encoded (g, h) of
    the k-th listed row: [.., 4] bfloat16 (g hi, g lo, h hi, h lo) or int8
    (g a, g b, h a, h b).  ``node_base[m]`` is node m's first position
    (``node_base[n_nodes]``: the rows listed); ``node_chunk0[m]`` its first
    chunk (``node_chunk0[n_nodes]``: the chunks); chunk c covers positions
    [chunk_begin[c], chunk_begin[c + 1]) (the last one up to the rows
    listed).  On the card the tensors are sized from the shapes: entries
    past the counts are undefined."""
    perm: torch.Tensor | None
    planes: torch.Tensor
    chunk_begin: torch.Tensor
    node_chunk0: torch.Tensor
    node_base: torch.Tensor


def hist_prep_plain(mode: str, xb, node, g, h, feat, thr, *, n_rows: int,
                    block: int, n_nodes: int, i8: bool):
    """Plain twin of csrc/hist.cu prep.  ``xb`` holds ``n_rows`` rows of F
    bins in row blocks of ``block`` rows (blocked or not; the last block may
    be short).  Returns (key, counts, scale): each row's node id ([n_rows]
    int32: routed one level down in the "route" mode, the ids given in
    "nodes", None at the root, where it is 0), the rows per (row block,
    node) ([nb, n_nodes] int32; a row counts when its id is in [0,
    n_nodes)) and the i8 scale per row block (max |g|, |h| over its counted
    rows, floored at the smallest normal f32; None in bf16)."""
    F = xb.shape[-1]
    dev = xb.device
    nb = -(-n_rows // block)
    key = None
    if mode == "route":
        key = _route(xb.reshape(-1, F)[:n_rows], node.reshape(-1)[:n_rows],
                     feat, thr)
    elif mode == "nodes":
        key = node.reshape(-1)[:n_rows]
    k = torch.zeros(n_rows, dtype=torch.long, device=dev) if key is None else key.long()
    ok = (k >= 0) & (k < n_nodes)
    blk = torch.arange(n_rows, device=dev) // block
    counts = torch.bincount((blk * n_nodes + k)[ok], minlength=nb * n_nodes)
    scale = None
    if i8:
        gv, hv = g.reshape(-1)[:n_rows], h.reshape(-1)[:n_rows]
        v = torch.where(ok, torch.maximum(gv.abs(), hv.abs()), gv.new_zeros(()))
        scale = gv.new_zeros(nb).scatter_reduce_(0, blk, v, "amax").clamp_min(_TINY)
    return key, counts.to(torch.int32).reshape(nb, n_nodes), scale


def _planes(gv, hv, inv):
    """Encoded (g, h) per row: bf16 hi/lo (``inv`` None) or the i8 planes
    at the rows' 1/scale, as in ``_encode_bf16`` / ``_encode_i8``."""
    if inv is None:
        out = []
        for v in (gv, hv):
            hi = v.to(torch.bfloat16)
            out += [hi, (v - hi.float()).to(torch.bfloat16)]
        return torch.stack(out, 1)
    out = []
    for v in (gv, hv):
        x = v * inv
        a = torch.round(x * 64.0)
        out += [a, torch.round((x - a * (1.0 / 64.0)) * 8192.0)]
    return torch.stack(out, 1).to(torch.int8)


def chunk_table_plain(counts, chunk_rows: int):
    """The chunk table of csrc/hist.cu partition from the (row block, node)
    counts: (chunk_begin, node_chunk0, node_base), int32.  A run of a node's
    rows in one row block opens a chunk when it holds a row whose position
    inside the node's segment is a multiple of ``chunk_rows``; chunks are
    numbered node by node, runs in row-block order."""
    c = counts.long()                                  # [nb, n_nodes]
    s = c.cumsum(0) - c                                # start inside the node
    head = (c > 0) & ((s + chunk_rows - 1) // chunk_rows * chunk_rows < s + c)
    zero = c.new_zeros(1)
    node_base = torch.cat([zero, c.sum(0).cumsum(0)])
    node_chunk0 = torch.cat([zero, head.sum(0).cumsum(0)])
    m, b = head.T.nonzero(as_tuple=True)               # node-major order
    chunk_begin = node_base[m] + s[b, m]
    return (chunk_begin.to(torch.int32), node_chunk0.to(torch.int32),
            node_base.to(torch.int32))


def hist_partition_plain(key, g, h, counts, scale, *, n_rows: int, block: int,
                         n_nodes: int, i8: bool, chunk_rows: int = _CHUNK_ROWS
                         ) -> Partition:
    """Plain twin of csrc/hist.cu partition: a stable sort of the counted
    rows by node id (``key`` None: the root, every row node 0), their
    encoded planes, and the chunk table (``chunk_table_plain``)."""
    dev = g.device
    k = (torch.zeros(n_rows, dtype=torch.long, device=dev) if key is None
         else key.reshape(-1)[:n_rows].long())
    ok = (k >= 0) & (k < n_nodes)
    rows = torch.argsort(torch.where(ok, k, n_nodes), stable=True)
    rows = rows[:int(ok.sum())]
    inv = 1.0 / scale[rows // block] if i8 else None
    planes = _planes(g.reshape(-1)[rows], h.reshape(-1)[rows], inv)
    chunk_begin, node_chunk0, node_base = chunk_table_plain(counts, chunk_rows)
    perm = None if key is None else rows.to(torch.int32)
    return Partition(perm, planes, chunk_begin, node_chunk0, node_base)


def _int_sums(bins, vals, n_bins: int):
    """sum_k [bins[k, f] == b] * vals[k, p] -> [F, n_bins, P], exact int64."""
    F = bins.shape[1]
    idx = (torch.arange(F, device=bins.device) * n_bins + bins.long()).reshape(-1)
    v = vals.long()[:, None, :].expand(-1, F, -1).reshape(-1, vals.shape[1])
    out = torch.zeros(F * n_bins, vals.shape[1], dtype=torch.long, device=bins.device)
    return out.index_add_(0, idx, v).reshape(F, n_bins, -1)


def hist_accumulate_plain(xb, part: Partition, scale, *, block: int,
                          n_nodes: int, n_bins: int, i8: bool) -> torch.Tensor:
    """Plain twin of csrc/hist.cu tile_hist + sum_chunks: chunk by chunk,
    the chunk's rows in the partitioned order.  bf16: the four planes
    summed in f32 (in the matmul's order, not the kernel's), hi + lo; i8:
    the planes' exact sums per row-block run, decoded at the block's scale
    into an f32 total in run order, as the kernel does.  Each node's chunk
    partials are added in f32 in chunk order.  [n_nodes, F, n_bins, 2]."""
    F = xb.shape[-1]
    xb2 = xb.reshape(-1, F)
    n_chunks, n_listed = int(part.node_chunk0[n_nodes]), int(part.node_base[n_nodes])
    bounds = part.chunk_begin[:n_chunks].tolist() + [n_listed]
    rows_all = (torch.arange(n_listed, device=xb.device) if part.perm is None
                else part.perm[:n_listed].long())
    partial = []
    for c in range(n_chunks):
        sl = slice(bounds[c], bounds[c + 1])
        rows, planes = rows_all[sl], part.planes[sl]
        bins = xb2[rows]
        if not i8:
            onehot = bins[:, :, None] == torch.arange(n_bins, device=bins.device)
            acc = torch.einsum("kfb,kp->fbp", onehot.float(), planes.float())
            partial.append(torch.stack([acc[..., 0] + acc[..., 1],
                                        acc[..., 2] + acc[..., 3]], -1))
            continue
        total = xb.new_zeros((F, n_bins, 2), dtype=torch.float32)
        blk = rows // block
        for b in torch.unique_consecutive(blk).tolist():
            sel = blk == b
            ab = _int_sums(bins[sel], planes[sel], n_bins).float()
            dec = ab[..., 0::2] * (1.0 / 64.0) + ab[..., 1::2] * (1.0 / 8192.0)
            total = total + dec * scale[b]
        partial.append(total)
    out = xb.new_zeros((n_nodes, F, n_bins, 2), dtype=torch.float32)
    c0 = part.node_chunk0.tolist()
    for m in range(n_nodes):
        for c in range(c0[m], c0[m + 1]):
            out[m] = partial[c] if c == c0[m] else out[m] + partial[c]
    return out


# -- kernel wrappers ---------------------------------------------------------------


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors (all on one card), False for CPU tensors;
    anything else raises.  It runs before every launch, so tensors on one
    card cost one cheap test each."""
    idx = ts[0].get_device()
    for t in ts:
        if not t.is_cuda or t.get_device() != idx:
            break
    else:
        return True
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _launch_on(idx: int, fn, *args) -> int:
    """Call a C entry point with card ``idx``'s current stream, making the
    card current only where it is not: entering ``torch.cuda.device`` and
    asking for the stream object cost more host time than a route kernel
    takes on the card."""
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)


def _expect(t: torch.Tensor, name: str, shape: tuple, dtype) -> None:
    if t.shape != shape or t.dtype != dtype:
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
        lib.hist_prep.argtypes = [I] + [P] * 9 + [LL] + [I] * 6 + [P]
        lib.hist_partition.argtypes = [P] * 14 + [LL] + [I] * 5 + [P]
        lib.hist_accumulate.argtypes = [P] * 9 + [I] * 7 + [P]
        lib.hist_build.argtypes = [I] + [P] * 9 + [LL] + [I] * 9 + [P]
        for fn in (lib.hist_prep, lib.hist_partition, lib.hist_accumulate,
                   lib.hist_build):
            fn.restype = I
        lib.hist_workspace_bytes.argtypes = [LL] + [I] * 6
        lib.hist_workspace_bytes.restype = LL
    else:
        lib.route_level.argtypes = [P] * 5 + [LL, I, P]
        lib.route_level.restype = I
        lib.route_margin_level.argtypes = [P] * 8 + [LL, I, P]
        lib.route_margin_level.restype = I
        lib.leaf_fit.argtypes = [P] * 9 + [I] * 4 + [P]
        lib.leaf_fit.restype = I
        lib.leaf_smem_bytes.argtypes = [I] * 2
        lib.leaf_smem_bytes.restype = LL
        lib.leaf_workspace_bytes.argtypes = [I] * 3
        lib.leaf_workspace_bytes.restype = LL
    _bound[name] = lib
    return lib


_MODE = {"root": 0, "route": 1, "nodes": 2}  # csrc/hist.cu hist_prep modes


def _large(n_nodes: int) -> int:
    """The partition path, from the shapes alone: shared-memory counters up
    to _SORT_NODES nodes, the sorting path past that (the two give the same
    partition)."""
    return int(n_nodes > _SORT_NODES)


def hist_prep(mode: str, xb, node, g, h, feat, thr, *, n_rows: int,
              block: int, n_nodes: int, i8: bool):
    """The histogram path's pre-pass: route once, count the rows per (row
    block, node), take the i8 block scales.  Returns (key, counts, scale)
    as ``hist_prep_plain``; in the "route" mode ``key`` is the new node ids
    shaped like ``node``.

    Part of the ports of rabit_tpu/ops/boost.py hist_level0 / hist_level
    and rabit_tpu/ops/hist.py node_histograms_pallas (their in-kernel
    routing and block scale).  Bound on an H100 by device memory (the node
    id and one 32-byte sector of each row's bins read, g and h too in i8;
    node' and the counts written); one block per row block, design in
    csrc/hist.cu."""
    if not _on_cuda(xb, g, h):
        key, counts, scale = hist_prep_plain(
            mode, xb, node, g, h, feat, thr, n_rows=n_rows, block=block,
            n_nodes=n_nodes, i8=i8)
        if mode == "route":
            key = key.reshape(node.shape)
        return key, counts, scale
    dev = xb.device
    nb = -(-n_rows // block)
    counts = torch.empty((nb, n_nodes), dtype=torch.int32, device=dev)
    scale = torch.empty(nb, device=dev) if i8 else None
    key = (torch.empty_like(node) if mode == "route" else
           node if mode == "nodes" else None)
    n_prev = 0 if feat is None else feat.shape[0]
    rc = _launch_on(
        dev.index, _lib("hist").hist_prep, _MODE[mode], _ptr(xb), _ptr(node),
        _ptr(g), _ptr(h), _ptr(feat), _ptr(thr),
        _ptr(key) if mode == "route" else None, _ptr(counts), _ptr(scale),
        n_rows, block, xb.shape[-1], n_nodes, n_prev, int(i8), _large(n_nodes))
    _check(rc, "hist_prep")
    helper_launches["hist_prep"] += 1
    return key, counts, scale


def hist_partition(key, g, h, counts, scale, *, n_rows: int, block: int,
                   n_nodes: int, i8: bool, chunk_rows: int = _CHUNK_ROWS) -> Partition:
    """The histogram path's partition: the counted rows stably by node, with
    their encoded planes, and the chunk table; ``key`` None is the root
    (the identity order).  See ``Partition`` and ``hist_partition_plain``.

    Part of the same ports as ``hist_prep`` (the TPU kernels encode in
    VMEM and need no partition: their histogram stays resident).  Bound on
    an H100 by device memory (key, g, h read, perm and planes written);
    three kernels (a counts scan per node, a scan over nodes, a scatter
    per row block), design in csrc/hist.cu.  Sized from the shapes: no
    value is read back to the host."""
    if not _on_cuda(g, h, counts):
        return hist_partition_plain(key, g, h, counts, scale, n_rows=n_rows,
                                    block=block, n_nodes=n_nodes, i8=i8,
                                    chunk_rows=chunk_rows)
    _check_block(block, "hist_partition")
    dev = g.device
    nb = counts.shape[0]
    i32 = dict(dtype=torch.int32, device=dev)
    runs = torch.empty((2, nb, n_nodes), **i32)          # rel, hid
    nodes = torch.empty((4, n_nodes + 1), **i32)  # total, heads, base, chunk0
    chunk_begin = torch.empty(-(-n_rows // chunk_rows) + n_nodes, **i32)
    perm = None if key is None else torch.empty(n_rows, **i32)
    planes = torch.empty((n_rows, 4), device=dev,
                         dtype=torch.int8 if i8 else torch.bfloat16)
    rc = _launch_on(
        dev.index, _lib("hist").hist_partition, _ptr(key), _ptr(g), _ptr(h),
        _ptr(scale), _ptr(counts), _ptr(runs[0]), _ptr(runs[1]),
        _ptr(nodes[0]), _ptr(nodes[1]), _ptr(nodes[2]), _ptr(nodes[3]),
        _ptr(chunk_begin), _ptr(perm), _ptr(planes), n_rows, block, n_nodes,
        chunk_rows, int(i8), _large(n_nodes))
    _check(rc, "hist_partition")
    helper_launches["hist_partition"] += 1
    return Partition(perm, planes, chunk_begin, nodes[3], nodes[2])


def hist_accumulate(xb, part: Partition, scale, *, block: int, n_nodes: int,
                    n_bins: int, i8: bool, name: str) -> torch.Tensor:
    """The histogram over a partition: [n_nodes, F, n_bins, 2], counted in
    ``launches`` under ``name`` (the kernel whose port this pass is)."""
    if not _on_cuda(xb, part.planes):
        return hist_accumulate_plain(xb, part, scale, block=block,
                                     n_nodes=n_nodes, n_bins=n_bins, i8=i8)
    dev = xb.device
    F = xb.shape[-1]
    max_chunks = part.chunk_begin.shape[0]
    partial = torch.empty((max_chunks, F, n_bins, 2), device=dev)
    out = torch.empty((n_nodes, F, n_bins, 2), device=dev)
    vec = F % 4 == 0 and xb.data_ptr() % 16 == 0  # one 16-byte copy a tile row
    rc = _launch_on(
        dev.index, _lib("hist").hist_accumulate, _ptr(xb), _ptr(part.perm),
        _ptr(part.planes), _ptr(scale), _ptr(part.chunk_begin),
        _ptr(part.node_base), _ptr(part.node_chunk0), _ptr(partial), _ptr(out),
        block, F, n_bins, n_nodes, max_chunks, int(vec), int(i8))
    _check(rc, name)
    launches[name] += 1
    return out


def hist_launch(mode: str, xb, node, g, h, feat, thr, *, n_rows: int,
                block: int, n_nodes: int, n_bins: int, i8: bool, name: str):
    """The histogram path: ``hist_prep``, ``hist_partition`` (no perm at the
    root) and ``hist_accumulate``.  xb holds ``n_rows`` rows of F bins in
    row blocks of ``block`` rows (pre-blocked or not: the same bytes), the
    last one possibly short in the "nodes" mode.  Returns the [n_nodes, F,
    n_bins, 2] histogram and, in the "route" mode, the new node ids (shaped
    like ``node``; else None).  On CUDA tensors (checked, contiguous) the
    three run as one C call into one workspace (csrc/hist.cu hist_build),
    which keeps the host's share of a launch small; on CPU tensors their
    plain twins run.  Any node and bin count whose histogram and scratch
    fit in the card's memory, and row blocks of any multiple of 128 rows up
    to 16384."""
    F = xb.shape[-1]
    _check_block(block, "the histogram kernel")
    if mode != "nodes" and n_rows % block:
        raise ValueError(f"{mode} mode takes whole row blocks ({n_rows} rows, "
                         f"block {block})")
    dev = xb.device
    if n_rows == 0 or F == 0:
        node_out = torch.empty_like(node) if mode == "route" else None
        return torch.zeros((n_nodes, F, n_bins, 2), device=dev), node_out
    if not _on_cuda(xb, g, h):
        kw = dict(n_rows=n_rows, block=block, n_nodes=n_nodes, i8=i8)
        key, counts, scale = hist_prep(mode, xb, node, g, h, feat, thr, **kw)
        part = hist_partition(None if mode == "root" else key, g, h, counts,
                              scale, **kw)
        out = hist_accumulate(xb, part, scale, block=block, n_nodes=n_nodes,
                              n_bins=n_bins, i8=i8, name=name)
        return out, key if mode == "route" else None
    lib = _lib("hist")
    node_out = torch.empty_like(node) if mode == "route" else None
    out = torch.empty((n_nodes, F, n_bins, 2), device=dev)
    ws = torch.empty(lib.hist_workspace_bytes(n_rows, block, F, n_bins, n_nodes,
                                              _CHUNK_ROWS, int(i8)),
                     dtype=torch.uint8, device=dev)
    vec = F % 4 == 0 and xb.data_ptr() % 16 == 0  # one 16-byte copy a tile row
    rc = _launch_on(
        dev.index, lib.hist_build, _MODE[mode], _ptr(xb), _ptr(node), _ptr(g),
        _ptr(h), _ptr(feat), _ptr(thr), _ptr(node_out), _ptr(ws), _ptr(out),
        n_rows, block, F, n_bins, n_nodes, 0 if feat is None else feat.shape[0],
        _CHUNK_ROWS, int(vec), int(i8), _large(n_nodes))
    _check(rc, name)
    helper_launches["hist_prep"] += 1
    helper_launches["hist_partition"] += 1
    launches[name] += 1
    return out, node_out


def _hist_cuda(xb3, node3, g3, h3, feat, thr, *, n_nodes, n_bins, i8, name):
    nb, R, F = xb3.shape
    _expect(xb3, "xb3", (nb, R, F), torch.int32)
    _expect(g3, "g3", (nb, R, 1), torch.float32)
    _expect(h3, "h3", (nb, R, 1), torch.float32)
    if node3 is not None:
        n_prev = n_nodes // 2
        _expect(node3, "node3", (nb, R, 1), torch.int32)
        _expect(feat, "feat", (n_prev,), torch.int32)
        _expect(thr, "thr", (n_prev,), torch.int32)
    return hist_launch("root" if node3 is None else "route", xb3, node3, g3, h3,
                       feat, thr, n_rows=nb * R, block=R, n_nodes=n_nodes,
                       n_bins=n_bins, i8=i8, name=name)


def hist_level0(xb3, g3, h3, *, n_bins: int, mxu_i8: bool = False,
                r_split: int = 1) -> torch.Tensor:
    """Root histogram; [1, F, B, 2].  ``r_split`` shapes only the plain
    version's sub-contractions (the kernel's result does not depend on it).

    Replaces rabit_tpu/ops/boost.py hist_level0 (_level0_kernel).  Bound on
    an H100 by device memory (xb, g, h read once).  On the card: the
    encoding pre-pass, then the feature-tile histogram over the rows in
    their own order (one segment, no partition); csrc/hist.cu says how the
    sum keeps a fixed order without atomics."""
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
    H100 by device memory (xb, node, g, h read once, node' written once).
    On the card the rows are routed once (``hist_prep``), partitioned by
    their new node (``hist_partition``) and histogrammed chunk by chunk in
    feature tiles (``hist_accumulate``), whatever the depth; design in
    csrc/hist.cu."""
    _check_r_split(xb3.shape[1], r_split)
    if not _on_cuda(xb3, node3, g3, h3, feat, thr):
        return hist_level_plain(xb3, node3, g3, h3, feat, thr, depth=depth,
                                n_bins=n_bins, mxu_i8=mxu_i8, r_split=r_split)
    return _hist_cuda(xb3, node3, g3, h3, feat, thr, n_nodes=2 ** depth,
                      n_bins=n_bins, i8=mxu_i8, name="hist_level")


def _route_checks(xb3, node3, feat, thr, depth, margin3=None, leaf=None):
    """(rows, F) of a final pass; raises on a depth, shape, dtype or layout
    that the route kernels do not take."""
    if not 1 <= depth <= _MAX_ROUTE_DEPTH:
        raise ValueError(f"depth={depth}: the route kernels take depths 1 to "
                         f"{_MAX_ROUTE_DEPTH} (int32 leaf ids)")
    nb, R, F = xb3.shape
    if F < 1:
        raise ValueError("xb3 holds no feature to route on")
    n_prev = 1 << (depth - 1)
    _expect(xb3, "xb3", (nb, R, F), torch.int32)
    _expect(node3, "node3", (nb, R, 1), torch.int32)
    _expect(feat, "feat", (n_prev,), torch.int32)
    _expect(thr, "thr", (n_prev,), torch.int32)
    if margin3 is not None:
        _expect(margin3, "margin3", (nb, R, 1), torch.float32)
        _expect(leaf, "leaf", (2 * n_prev,), torch.float32)
    return nb * R, F


def route_level(xb3, node3, feat, thr, *, depth: int) -> torch.Tensor:
    """Route rows one level down through the level-(depth-1) split tables
    (no histogram); returns node3'.

    Replaces rabit_tpu/ops/boost.py route_level (_route_kernel).  Bound on
    an H100 by device memory: one bin per row, node in and out; design in
    csrc/route.cu."""
    if not _on_cuda(xb3, node3, feat, thr):
        return route_level_plain(xb3, node3, feat, thr, depth=depth)
    n_rows, F = _route_checks(xb3, node3, feat, thr, depth)
    node_out = torch.empty_like(node3)
    rc = _launch_on(xb3.get_device(), _lib("route").route_level, xb3.data_ptr(),
                    node3.data_ptr(), feat.data_ptr(), thr.data_ptr(),
                    node_out.data_ptr(), n_rows, F)
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
    n_rows, F = _route_checks(xb3, node3, feat, thr, depth, margin3, leaf)
    node_out = torch.empty_like(node3)
    margin_out = torch.empty_like(margin3)
    rc = _launch_on(xb3.get_device(), _lib("route").route_margin_level,
                    xb3.data_ptr(), node3.data_ptr(), margin3.data_ptr(),
                    feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
                    margin_out.data_ptr(), node_out.data_ptr(), n_rows, F)
    _check(rc, "route_margin_level")
    launches["route_margin_level"] += 1
    return margin_out, node_out


def _leaf_part(lib, R: int, depth: int) -> int:
    """Rows of the parts a leaf_fit kernel block sums: the whole row block,
    or, where its shared memory would pass the card's, the largest multiple
    of 128 that divides R and fits (128 rows always do)."""
    k = R // _BLOCK_STEP
    for d in range(k, 0, -1):
        if k % d == 0 and lib.leaf_smem_bytes(_BLOCK_STEP * d, depth) <= _SMEM_LIMIT:
            return _BLOCK_STEP * d
    raise ValueError(f"leaf_fit: no part of a {R}-row block fits in "
                     f"{_SMEM_LIMIT} B of shared memory")


def leaf_fit(xb3, node3, g3, h3, feat, thr, *, depth: int):
    """Route rows to their leaves and sum (g, h) per leaf in the hi/lo-bf16
    planes; returns ([2**depth, 2], leaf_node3).  ``feat``/``thr`` are the
    level-(depth-1) split tables.  No training round calls it: the rounds
    read leaf masses off the last histogram (``split_child_masses``).

    Replaces rabit_tpu/ops/boost.py leaf_fit (_leaf_kernel).  Bound on an
    H100 by device memory: one bin per row, node, g and h in, leaf id out.
    On the card one block per row block sums its rows per leaf (per-warp
    accumulators up to depth 8, a stable sort by leaf deeper); the row
    blocks' sums are merged per leaf through a dense [nb, 2**depth] partial
    while that takes at most 2R entries a row block, else through compact
    records sorted by leaf (both give the same sums; chosen from the shapes
    in csrc/route.cu).  Shared memory grows with the row block alone, so
    every depth of the route kernels is taken whose output and scratch fit
    in the card's memory; design in csrc/route.cu.  Row blocks of any
    multiple of 128 rows up to 16384; where the sort (depth 9 and deeper)
    would outgrow a block's shared memory (past 11008 rows), the kernel sums
    the row block in equal parts and adds them in order, so its masses
    differ from the plain version's by f32 rounding alone."""
    if not _on_cuda(xb3, node3, g3, h3, feat, thr):
        return leaf_fit_plain(xb3, node3, g3, h3, feat, thr, depth=depth)
    nb, R, F = xb3.shape
    n_leaves = 2 ** depth
    _route_checks(xb3, node3, feat, thr, depth)
    _expect(g3, "g3", (nb, R, 1), torch.float32)
    _expect(h3, "h3", (nb, R, 1), torch.float32)
    _check_block(R, "leaf_fit")
    lib = _lib("route")
    part = _leaf_part(lib, R, depth)
    nb, R = nb * (R // part), part
    dev = xb3.device
    node_out = torch.empty_like(node3)
    if nb == 0:
        return torch.zeros((n_leaves, 2), device=dev), node_out
    out = torch.empty((n_leaves, 2), device=dev)
    ws = torch.empty(lib.leaf_workspace_bytes(nb, R, depth),
                     dtype=torch.uint8, device=dev)
    rc = _launch_on(dev.index, lib.leaf_fit, _ptr(xb3), _ptr(node3), _ptr(g3),
                    _ptr(h3), _ptr(feat), _ptr(thr), _ptr(node_out), _ptr(ws),
                    _ptr(out), nb, R, F, depth)
    _check(rc, "leaf_fit")
    launches["leaf_fit"] += 1
    return out, node_out
