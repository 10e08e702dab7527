"""Gradient histograms for given node ids: the exact-f32 reference.

``hist[node, f, b] = sum_i [node_i == node][xb_i[f] == b] * (g_i, h_i)``

The counterpart of ``rabit_tpu/ops/hist.py``'s scatter path.  It sums in
row order (``index_add_`` on the CPU runs through the indices in order),
as XLA's segment_sum does on the CPU, and it runs on the CPU only: CUDA's
float ``index_add_`` adds with atomics, in no fixed order.  The CUDA
histogram for given node ids is the port of the TPU's ``_hist_kernel``
(``rabit_tpu/ops/hist.py`` ``node_histograms_pallas``), which comes in a
later slice; until then ``node_histograms`` raises for CUDA tensors.
"""

from __future__ import annotations

import torch


def _cpu_only(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"{what} on {t.device}: the CUDA histogram for given node ids "
            "(the port of rabit_tpu/ops/hist.py _hist_kernel) is not ported "
            "yet; the fused round (models.gbdt.train_round_fused) runs on CUDA")


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Row-order f32 segment sum: values [n, ...] by seg [n] ->
    [num_segments, ...]."""
    _cpu_only(values, "segment_sum")
    out = values.new_zeros((num_segments, *values.shape[1:]))
    return out.index_add_(0, seg.long(), values)


def node_histograms_scatter(xb, g, h, node, n_nodes: int,
                            n_bins: int) -> torch.Tensor:
    """Exact-f32 segment-sum histogram; [n_nodes, F, B, 2]."""
    n, F = xb.shape
    seg = (node.long()[:, None] * F + torch.arange(F)) * n_bins + xb.long()
    gh = torch.stack([g[:, None].expand(n, F), h[:, None].expand(n, F)], -1)
    hist = segment_sum(gh.reshape(-1, 2), seg.reshape(-1),
                       n_nodes * F * n_bins)
    return hist.reshape(n_nodes, F, n_bins, 2)


def node_histograms(xb, g, h, node, n_nodes: int, n_bins: int,
                    mxu_i8: bool = False) -> torch.Tensor:
    """Histogram for given node ids; [n_nodes, F, B, 2].  The exact scatter
    path on the CPU (which, as in JAX, ignores ``mxu_i8``); raises on CUDA
    until the ``_hist_kernel`` port lands."""
    _cpu_only(xb, "node_histograms")
    return node_histograms_scatter(xb, g, h, node, n_nodes, n_bins)
