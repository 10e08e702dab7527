"""Gradient histograms for given node ids.

``hist[node, f, b] = sum_i [node_i == node][xb_i[f] == b] * (g_i, h_i)``

The counterpart of ``rabit_tpu/ops/hist.py``.  Implementations of the same
contract:

* ``node_histograms_scatter`` -- exact f32, summed in row order
  (``index_add_`` on the CPU runs through the indices in order, as XLA's
  segment_sum does on the CPU).  CPU only: CUDA's float ``index_add_`` adds
  with atomics, in no fixed order.
* ``node_histograms_onehot`` -- chunked one-hot contractions, as the JAX
  package's pure-XLA path.
* ``node_histograms_kernel`` -- the hand-written CUDA kernel
  (``csrc/hist.cu``, nodes mode) that replaces the TPU's ``_hist_kernel``
  (``node_histograms_pallas``): the same hi/lo-bf16 or two-plane-i8
  encoding per row block, summed in a fixed order.  On a CPU tensor it
  runs its plain twin ``node_histograms_kernel_plain``.

``node_histograms`` and ``segment_sum`` dispatch by device, with the JAX
package's ``impl`` names: the kernel (``"pallas"``/``"pallas_i8"``) and the
matmul on CUDA, the exact scatter on the CPU.  No other device is taken.

The one-hot contractions run in f64 and round once to f32: JAX asks for
``Precision.HIGHEST``, and an f64 product cannot be cut to TF32 by the
caller's global matmul setting.
"""

from __future__ import annotations

import torch

from rabit_tpu_torch.ops import boost


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(
            f"no histogram for device {t.device}: the port runs on cpu and cuda")
    return t.device.type


def _cpu_only(t: torch.Tensor, what: str) -> None:
    if _device(t) != "cpu":
        raise NotImplementedError(
            f"{what} on {t.device}: the exact scatter runs on the CPU only "
            "(CUDA's float index_add_ adds with atomics, in no fixed order); "
            "on CUDA use the kernel or the matmul")


def _pad_rows(n: int, block_rows: int):
    """Rows of each chunk (JAX: min(block_rows, round_up(n, 128))) and the
    padded row count."""
    R = min(block_rows, boost._round_up(max(n, 1), 128))
    return R, boost._round_up(n, R)


# -- exact scatter (CPU reference) ------------------------------------------------


def _segment_sum_scatter(values, seg, num_segments: int) -> torch.Tensor:
    _cpu_only(values, "segment_sum(impl='scatter')")
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add_(0, seg.long(), values)


def node_histograms_scatter(xb, g, h, node, n_nodes: int,
                            n_bins: int) -> torch.Tensor:
    """Exact-f32 segment-sum histogram; [n_nodes, F, B, 2]."""
    _cpu_only(xb, "node_histograms(impl='scatter')")
    n, F = xb.shape
    seg = (node.long()[:, None] * F + torch.arange(F)) * n_bins + xb.long()
    gh = torch.stack([g[:, None].expand(n, F), h[:, None].expand(n, F)], -1)
    hist = _segment_sum_scatter(gh.reshape(-1, 2), seg.reshape(-1),
                                n_nodes * F * n_bins)
    return hist.reshape(n_nodes, F, n_bins, 2)


# -- one-hot contractions ----------------------------------------------------------


def node_histograms_onehot(xb, g, h, node, n_nodes: int, n_bins: int,
                           block_rows: int = 8192) -> torch.Tensor:
    """One-hot-contraction histogram; [n_nodes, F, B, 2].  Per chunk of
    rows, L[r, m] holds g (m < n_nodes) / h (m >= n_nodes) in the column of
    the row's node; the chunk's histogram L^T @ onehot(bins) is added into
    the total in chunk order."""
    n, F = xb.shape
    R, _ = _pad_rows(n, block_rows)
    dev = xb.device
    nodes = torch.arange(n_nodes, device=dev)
    bins = torch.arange(n_bins, device=dev)
    acc = torch.zeros(2 * n_nodes, F * n_bins, dtype=torch.float64, device=dev)
    for lo in range(0, n, R):  # the zero rows of JAX's pad would add 0
        sl = slice(lo, min(n, lo + R))
        onehot_n = (node[sl, None] == nodes).double()
        L = torch.cat([onehot_n * g[sl, None].double(),
                       onehot_n * h[sl, None].double()], 1)
        onehot_b = (xb[sl, :, None] == bins).reshape(-1, F * n_bins).double()
        acc += L.T @ onehot_b
    acc = acc.float().reshape(2, n_nodes, F, n_bins)
    return torch.stack([acc[0], acc[1]], -1)


def segment_sum_matmul(values, seg, num_segments: int,
                       block_rows: int = 8192) -> torch.Tensor:
    """``segment_sum(values, seg)`` as one-hot contractions over chunks of
    rows; values [n, C] f32, seg [n] int -> [num_segments, C] f32.  Chunks
    are contracted in batches (bounded one-hot size) and added in chunk
    order within a batch's sum, batch after batch."""
    n, C = values.shape
    R, n_pad = _pad_rows(n, block_rows)
    dev = values.device
    if n_pad != n:  # padded rows land in segment 0 with zero value
        values = torch.cat([values, values.new_zeros((n_pad - n, C))])
        seg = torch.cat([seg, seg.new_zeros(n_pad - n)])
    nb = n_pad // R
    v3 = values.double().reshape(nb, R, C)
    s3 = seg.reshape(nb, R)
    segs = torch.arange(num_segments, device=dev)
    per = max(1, (1 << 24) // (R * max(num_segments, 1)))  # chunks per batch
    acc = torch.zeros(num_segments, C, dtype=torch.float64, device=dev)
    for lo in range(0, nb, per):
        onehot = (s3[lo:lo + per, :, None] == segs).double()  # [k, R, S]
        acc += torch.bmm(onehot.transpose(1, 2), v3[lo:lo + per]).sum(0)
    return acc.float()


# -- the CUDA kernel and its plain twin --------------------------------------------


def node_histograms_kernel_plain(xb, g, h, node, n_nodes: int, n_bins: int,
                                 block_rows: int = 1024,
                                 mxu_i8: bool = False) -> torch.Tensor:
    """Plain twin of the kernel: ``ops.boost``'s gradient matrix and
    encoded contraction, row block by row block in block order.  The last
    block may be short: the JAX wrapper's zero pad rows add nothing, and
    its i8 scale (max |g|, |h| over the block) is the same without them."""
    n, F = xb.shape
    out = torch.zeros(2 * n_nodes, F * n_bins, device=xb.device)
    for lo in range(0, n, block_rows):
        sl = slice(lo, min(n, lo + block_rows))
        L = boost._gradient_matrix(node[sl], g[sl], h[sl], n_nodes=n_nodes)
        out += boost._accum(xb[sl], L, n_bins=n_bins, i8=mxu_i8)
    out = out.reshape(2 * n_nodes, F, n_bins)
    return torch.stack([out[:n_nodes], out[n_nodes:]], -1)


def node_histograms_kernel(xb, g, h, node, n_nodes: int, n_bins: int,
                           block_rows: int = 1024,
                           mxu_i8: bool = False) -> torch.Tensor:
    """Histogram for given node ids, [n_nodes, F, B, 2], in the hi/lo-bf16
    or (``mxu_i8``) two-plane-i8 encoding per row block of ``block_rows``.
    ``xb`` is the unblocked [n, F] bin matrix; the last row block may be
    short.

    Replaces rabit_tpu/ops/hist.py node_histograms_pallas (_hist_kernel).
    Bound on an H100 by device memory (xb, node, g, h read once).  On the
    card the rows are partitioned by node id (ids outside [0, n_nodes) are
    left out) and histogrammed chunk by chunk in feature tiles
    (``ops.boost.hist_launch``); design in csrc/hist.cu."""
    if not boost._on_cuda(xb, g, h, node):
        return node_histograms_kernel_plain(xb, g, h, node, n_nodes, n_bins,
                                            block_rows, mxu_i8)
    n, F = xb.shape
    boost._expect(xb, "xb", (n, F), torch.int32)
    boost._expect(g, "g", (n,), torch.float32)
    boost._expect(h, "h", (n,), torch.float32)
    boost._expect(node, "node", (n,), torch.int32)
    return boost.hist_launch("nodes", xb, node, g, h, None, None, n_rows=n,
                             block=block_rows, n_nodes=n_nodes, n_bins=n_bins,
                             i8=mxu_i8, name="node_histograms_kernel")[0]


# -- dispatchers ---------------------------------------------------------------------


def node_histograms(xb, g, h, node, n_nodes: int, n_bins: int,
                    impl: str | None = None,
                    mxu_i8: bool = False) -> torch.Tensor:
    """Histogram for given node ids; [n_nodes, F, B, 2].  By default the
    kernel on CUDA (i8 with ``mxu_i8``) and the exact scatter on the CPU
    (which, as in JAX, ignores ``mxu_i8``); an explicit ``impl`` wins."""
    if impl is None:
        on_cuda = _device(xb) == "cuda"
        impl = ("pallas_i8" if mxu_i8 else "pallas") if on_cuda else "scatter"
    if impl == "pallas":
        return node_histograms_kernel(xb, g, h, node, n_nodes, n_bins)
    if impl == "pallas_i8":
        return node_histograms_kernel(xb, g, h, node, n_nodes, n_bins,
                                      mxu_i8=True)
    if impl == "onehot":
        return node_histograms_onehot(xb, g, h, node, n_nodes, n_bins)
    if impl == "scatter":
        return node_histograms_scatter(xb, g, h, node, n_nodes, n_bins)
    raise ValueError(f"unknown hist impl {impl!r}")


def segment_sum(values, seg, num_segments: int,
                impl: str | None = None) -> torch.Tensor:
    """Segment sum for small segment counts (leaf fit): the one-hot matmul
    on CUDA, the exact row-order scatter on the CPU."""
    if impl is None:
        impl = "matmul" if _device(values) == "cuda" else "scatter"
    if impl == "matmul":
        return segment_sum_matmul(values, seg, num_segments)
    if impl == "scatter":
        return _segment_sum_scatter(values, seg, num_segments)
    raise ValueError(f"unknown segment_sum impl {impl!r}")
