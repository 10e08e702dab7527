"""Sequence-parallel attention over a process group: ring attention and
all-to-all (Ulysses) attention.

The port's counterpart of ``rabit_tpu/parallel/ring.py``.  The sequence
is sharded over the ranks of a group (a group is what
``mesh.get_group(axis)`` returns; None is the default group): rank i holds
contiguous sequence block i of q, k and v, each ``[block, heads, dim]``,
and gets back its block of the attention output.  ``ring_attention``
rotates the k/v blocks around the ring with ``collectives.ring_shift``
while an f32 online softmax folds each arriving block in, so a rank holds
O(seq / n) of the sequence; ``ulysses_attention`` reshards to whole
sequences of heads / n heads with one all-to-all, attends locally, and
reshards back with a second.  Both stage their hops through
``collectives.wire_device`` (host memory when the group is gloo and the
tensors lie on a card).  Scores and weighted sums are einsums, in f32 as
JAX computes them: the merge needs each block's row max and sum of
exponentials, which a fused attention call does not return.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rabit_tpu_torch.parallel.collectives import ring_shift, wire_device

_NEG_INF = -1e30


def _block_attend(q, k, v, scale, q_pos, k_pos, causal):
    """Scores of the q block against one k/v block, causally masked when
    asked.  Returns (unnormalized out [q, h, d], row max [h, q], row sum of
    exponentials [h, q]); fully masked rows give zeros."""
    dt = torch.promote_types(q.dtype, k.dtype)
    s = torch.einsum("qhd,khd->hqk", q.to(dt), k.to(dt)) * scale
    if causal:
        mask = k_pos[None, None, :] <= q_pos[None, :, None]
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(-1)                                       # [h, q]
    p = torch.exp(s - m[..., None])                      # [h, q, k]
    p = torch.where(m[..., None] <= _NEG_INF / 2, 0.0, p)
    o = torch.einsum("hqk,khd->qhd", p, v.to(p.dtype))   # [q, h, d]
    return o, m, p.sum(-1)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = False) -> torch.Tensor:
    """Blockwise ring attention over sequence shards.

    Each of the n ranks holds contiguous sequence block i; k/v (as f32)
    rotate n - 1 times around the ring after the local block is folded in;
    the online-softmax accumulator merges each visiting block.  Returns
    this rank's attention block ``[block, heads, dim]`` in q's dtype."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    block, heads, dim = q.shape
    scale = 1.0 / (dim ** 0.5)
    ar = torch.arange(block, device=q.device)
    q_pos = idx * block + ar

    def merge(carry, kb, vb, s):
        o, m, l = carry
        # The k/v block in hand after s hops originated s positions back.
        k_pos = ((idx - s) % n) * block + ar
        bo, bm, bl = _block_attend(q, kb, vb, scale, q_pos, k_pos, causal)
        m_new = torch.maximum(m, bm)
        alpha = torch.exp(m - m_new)  # rescale the old accumulator
        beta = torch.exp(bm - m_new)  # rescale the new block
        alpha = torch.where(m <= _NEG_INF / 2, 0.0, alpha)
        beta = torch.where(bm <= _NEG_INF / 2, 0.0, beta)
        o = o * alpha.T[..., None] + bo * beta.T[..., None]
        return o, m_new, l * alpha + bl * beta

    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((heads, block), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((heads, block), dtype=torch.float32, device=q.device)
    kb, vb = k.float(), v.float()
    o, m, l = merge((o, m, l), kb, vb, 0)
    for s in range(1, n):
        kb, vb = ring_shift((kb, vb), group)
        o, m, l = merge((o, m, l), kb, vb, s)
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l.T[..., None]).to(q.dtype)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x[j]`` to group rank j; returns ``out`` with ``out[j]`` from group
    rank j.  ``x``'s leading dim is the group size."""
    if dist.get_world_size(group) == 1:
        return x
    w = x.to(wire_device(group, x.device)).contiguous()
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return out.to(x.device)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group=None, causal: bool = False) -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style), the other
    long-context mechanism beside ring_attention.

    One all-to-all reshards the seq-sharded q/k/v to head-sharded (each rank
    holds the full sequence for heads/n heads), full attention runs locally
    in f32, and a second all-to-all reshards back.  Two all-to-alls against
    the ring's n - 1 hops: cheaper when heads >= ranks and the
    full-sequence scores fit memory; ring_attention holds O(seq / n).
    Per-rank shapes ``[block, heads, dim]`` with ``heads % n == 0``."""
    n = dist.get_world_size(group)
    block, heads, dim = q.shape
    if heads % n != 0:
        raise ValueError(
            f"ulysses_attention needs heads ({heads}) divisible by the "
            f"group size ({n}); use ring_attention otherwise"
        )

    def to_heads(x):  # [block, h, d] -> [n*block, h/n, d]
        parts = x.reshape(block, n, heads // n, dim).transpose(0, 1)
        return _all_to_all(parts, group).reshape(n * block, heads // n, dim)

    o = reference_attention(to_heads(q).float(), to_heads(k).float(),
                            to_heads(v).float(), causal=causal).to(q.dtype)
    back = _all_to_all(o.reshape(n, block, heads // n, dim), group)  # [n, block, h/n, d]
    return back.transpose(0, 1).reshape(block, heads, dim)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False) -> torch.Tensor:
    """Unsharded full attention, ``[seq, heads, dim]``, in the inputs'
    dtype: the oracle of ring_attention AND the local per-head-slice core
    of ulysses_attention (which feeds it f32 inputs)."""
    seq, heads, dim = q.shape
    s = torch.einsum("qhd,khd->hqk", q, k) / (dim ** 0.5)
    if causal:
        pos = torch.arange(seq, device=q.device)
        s = torch.where((pos[None, :] <= pos[:, None])[None], s, _NEG_INF)
    p = torch.softmax(s, -1)
    return torch.einsum("hqk,khd->qhd", p, v).to(q.dtype)
