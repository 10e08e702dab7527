"""Collectives over a torch.distributed process group: the port's data plane.

The port's counterpart of ``rabit_tpu/parallel/collectives.py``.  Each
function takes ``(x, group, ...)`` where the JAX one takes ``(x,
axis_name, ...)`` (a group is what ``mesh.get_group(axis)`` returns; None
is the default group), is called by every rank of the group, and returns
what the JAX function returns on this rank.  Positions on a ring are the
ranks of the group, in order (``ring_perm``).

* ``allreduce``, ``broadcast``, ``allgather``, ``reduce_scatter`` and
  ``fused_allreduce`` are the backend's collectives; BITOR is lowered to
  MAX over bit planes, as the JAX package lowers it.
* ``ring_shift`` and the explicit rings (``ring_reduce_scatter``,
  ``ring_allgather``, ``ring_allreduce``, ``ring_allreduce_quantized``)
  keep the JAX package's chunk schedules.  Each hop posts its sends and
  its receives together (``dist.batch_isend_irecv``): a blocking send
  before a receive deadlocks a ring.

Where the hops' bytes live is :func:`wire_device`'s one decision: on the
tensor's device, except where the group's backend is gloo and the tensor
lies on a card, whose bytes gloo moves through host memory.  The
arithmetic (sums, quantization, decode) stays on the tensor's device.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from rabit_tpu_torch.engine.base import BITOR, MAX, MIN, SUM
from rabit_tpu_torch.parallel.mesh import ring_perm

_REDUCE = {SUM: dist.ReduceOp.SUM, MAX: dist.ReduceOp.MAX, MIN: dist.ReduceOp.MIN}
_INV127 = 0.007874015718698502    # f32(1/127), exactly
_INV254 = 0.003937007859349251    # f32(1/254), exactly


def wire_device(group, device) -> torch.device:
    """The device a collective's bytes cross from: the host when the
    group's backend is gloo and ``device`` is a card, else ``device``
    itself.  Every collective of this module stages through it."""
    device = torch.device(device)
    if device.type == "cuda" and dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return device


def _size_rank(group) -> tuple[int, int]:
    return dist.get_world_size(group), dist.get_rank(group)


def _global(group, rank: int) -> int:
    """The default group's rank of ``group``'s rank ``rank``."""
    if group is None or group is dist.group.WORLD:
        return rank
    return dist.get_global_rank(group, rank)


def _exchange(tensors: list[torch.Tensor], group, dst: int,
              src: int) -> list[torch.Tensor]:
    """One hop: send each tensor to group rank ``dst`` and receive one of
    the same shape and dtype from group rank ``src``, every send and
    receive posted together.  Returns the received tensors on the
    senders' device."""
    if dist.get_world_size(group) == 1:
        return [t.clone() for t in tensors]
    device = tensors[0].device
    wire = wire_device(group, device)
    sends = [t.contiguous().to(wire) for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, _global(group, dst), group) for t in sends]
           + [dist.P2POp(dist.irecv, t, _global(group, src), group) for t in recvs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [t.to(device) for t in recvs]


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    w = x.to(wire_device(group, x.device), copy=True)
    dist.all_reduce(w, op=op, group=group)
    return w.to(x.device)


def allreduce(x: torch.Tensor, group=None, op: int = SUM) -> torch.Tensor:
    """Allreduce with a rabit op enum (MAX/MIN/SUM/BITOR)."""
    if op in _REDUCE:
        return _all_reduce(x, group, _REDUCE[op])
    if op == BITOR:
        if x.is_floating_point() or x.dtype == torch.bool:
            raise TypeError(f"BITOR of {x.dtype}")
        # No bitwise-or collective: one byte a bit, 0 or 1, ORed by MAX
        # (a | b == max(a, b) per bit).
        shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
        planes = (x.contiguous().view(torch.uint8).unsqueeze(-1) >> shifts) & 1
        ored = _all_reduce(planes, group, dist.ReduceOp.MAX)
        return (ored << shifts).sum(-1, dtype=torch.uint8).view(x.dtype)
    raise ValueError(f"unknown reduction op {op}")


def broadcast(x: torch.Tensor, group=None, root: int = 0) -> torch.Tensor:
    """``x`` of the group's rank ``root``, on every rank."""
    w = x.to(wire_device(group, x.device), copy=True)
    if w.dtype == torch.bool:
        w = w.to(torch.uint8)
    dist.broadcast(w, src=_global(group, root), group=group)
    return w.to(device=x.device, dtype=x.dtype)


def allgather(x: torch.Tensor, group=None, axis: int = 0,
              tiled: bool = False) -> torch.Tensor:
    """Every rank's ``x`` in rank order: stacked along a new dimension
    ``axis``, or with ``tiled`` concatenated along ``axis``."""
    n, _ = _size_rank(group)
    w = x.to(wire_device(group, x.device)).contiguous()
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    out = torch.cat(parts, dim=axis) if tiled else torch.stack(parts, dim=axis)
    return out.to(x.device)


def reduce_scatter(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """Sum-reduce, then this rank's slice of dimension ``axis`` (which the
    group size must divide; tiled)."""
    n, idx = _size_rank(group)
    if x.shape[axis] % n:
        raise ValueError(f"reduce_scatter: dimension {axis} of size "
                         f"{x.shape[axis]} not divisible by the group size {n}")
    total = _all_reduce(x, group, dist.ReduceOp.SUM)
    size = x.shape[axis] // n
    return total.narrow(axis, idx * size, size).contiguous()


def ring_shift(x: Any, group=None, shift: int = 1) -> Any:
    """Send this rank's ``x`` (a tensor or a pytree of them) to the ring
    successor ``shift`` positions away; returns the predecessor's."""
    n, idx = _size_rank(group)
    leaves, spec = pytree.tree_flatten(x)
    got = _exchange(leaves, group, (idx + shift) % n, (idx - shift) % n)
    return pytree.tree_unflatten(got, spec)


def _chunks(x: torch.Tensor, n: int, what: str) -> torch.Tensor:
    if x.shape[0] % n:
        raise ValueError(f"{what}: leading dim {x.shape[0]} not divisible by "
                         f"the group size {n}")
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _hop(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """One step of the ring of ``ring_perm``: to the successor, from the
    predecessor."""
    n, idx = _size_rank(group)
    return _exchange(tensors, group, dict(ring_perm(n))[idx], (idx - 1) % n)


def ring_reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Explicit n-1-step ring reduce-scatter.

    ``x``'s leading dim must be divisible by the group size; rank i ends up
    holding chunk i of the sum.  At step s each rank forwards the partial
    sum of chunk (i-1-s) mod n to its successor and folds its own copy into
    the chunk arriving from its predecessor."""
    n, idx = _size_rank(group)
    chunks = _chunks(x, n, "ring_reduce_scatter")
    held = chunks[(idx - 1) % n]
    for s in range(n - 1):
        (recv,) = _hop([held], group)
        held = recv + chunks[(idx - 2 - s) % n]
    return held


def ring_allgather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Explicit n-1-step ring allgather: input is this rank's slice, output
    is ``(n,) + x.shape`` with slice j from rank j."""
    n, idx = _size_rank(group)
    out = x.new_zeros((n,) + tuple(x.shape))
    out[idx] = x
    cur = x
    for s in range(n - 1):
        (cur,) = _hop([cur], group)
        # after s+1 hops the block in hand originated s+1 positions back
        out[(idx - s - 1) % n] = cur
    return out


def ring_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Ring reduce-scatter + ring allgather.  Leading dim must be
    divisible by the group size."""
    owned = ring_reduce_scatter(x, group)
    return ring_allgather(owned, group).reshape(x.shape)


def _quantize_i8(v: torch.Tensor, block: int, planes: int):
    """Per-block symmetric int8 quantization: returns (q[planes, m, block]
    int8, scales[m, 1] f32).  planes=1 is plain int8 (~2^-8 of the block
    max); planes=2 adds a residual plane (~2^-16 of the block max).  ``v``
    is 1-D, its length a multiple of ``block``."""
    vb = v.reshape(-1, block)
    scale = torch.clamp_min(vb.abs().amax(1, keepdim=True), 1e-30) * _INV127
    a = torch.clip(torch.round(vb / scale), -127, 127)
    if planes == 1:
        return a.to(torch.int8)[None], scale
    # |resid| <= s/2 => |b| <= 127 analytically, but the bound has only
    # ~1e-5 of f32 headroom and an int8 cast wraps (as it does on
    # non-finite input), so clip like the primary plane.
    b = torch.clip(torch.round((vb - a * scale) * (254.0 / scale)), -127, 127)
    return torch.stack((a, b)).to(torch.int8), scale


def _dequantize_i8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    v = q[0].to(torch.float32) * scale
    if q.shape[0] == 2:
        v = v + q[1].to(torch.float32) * (scale * _INV254)
    return v.reshape(-1)


def ring_allreduce_quantized(x: torch.Tensor, group=None, *, block: int = 256,
                             planes: int = 2) -> torch.Tensor:
    """Bandwidth-compressed ring allreduce (SUM): every hop ships int8
    payloads with per-``block`` f32 scales, and all arithmetic stays f32 on
    ``x``'s device.  ``planes=2`` (the default) sends a hi/lo int8 pair
    (~2x fewer wire bytes than f32 at ~2^-16 of the block max a hop);
    ``planes=1`` one plane (~3.9x at ~2^-8).  Reduce-scatter hops
    re-quantize the running partial sum (errors accumulate over the n-1
    hops); the allgather quantizes each owner's final chunk ONCE and
    forwards the identical payload.

    LOSSY but rank-consistent: the value of chunk j on every rank is the
    decode of owner j's one int8+scale payload, by the same ops on every
    rank, the owner's own chunk included (the allgather writes, then hops,
    for n steps; the last step's hop would carry nothing new and is not
    made), so the output is bitwise identical across ranks and argmax
    decisions downstream (GBDT split selection) cannot diverge.  Paths
    that must equal a serial replay bit for bit keep the exact
    collectives.  f32 input, leading dim divisible by the group size,
    chunk elements divisible by ``block``."""
    if planes not in (1, 2):
        raise ValueError(f"ring_allreduce_quantized: planes must be 1 or 2, "
                         f"got {planes}")
    if x.dtype != torch.float32:
        raise ValueError(
            f"ring_allreduce_quantized: f32 input required (got {x.dtype}); "
            "cast first, accumulation runs in f32 regardless")
    n, idx = _size_rank(group)
    chunks = _chunks(x, n, "ring_allreduce_quantized")
    csize = chunks[0].numel()
    if csize % block:
        raise ValueError(
            f"ring_allreduce_quantized: chunk size {csize} not divisible by "
            f"block {block} (pad the payload or pick a divisor block)")

    held = chunks[(idx - 1) % n]
    for s in range(n - 1):
        q, sc = _hop(list(_quantize_i8(held.reshape(-1), block, planes)), group)
        mine = chunks[(idx - 2 - s) % n]
        held = _dequantize_i8(q, sc).reshape(mine.shape) + mine

    q, sc = _quantize_i8(held.reshape(-1), block, planes)
    out = torch.zeros((n, csize), dtype=torch.float32, device=x.device)
    for s in range(n):
        out[(idx - s) % n] = _dequantize_i8(q, sc)
        if s < n - 1:
            q, sc = _hop([q, sc], group)
    return out.reshape(x.shape)


def fused_allreduce(tree: Any, group=None, op: int = SUM) -> Any:
    """Allreduce a whole pytree as ONE collective per dtype group: the
    leaves are raveled, concatenated by dtype, reduced once and split
    back."""
    leaves, spec = pytree.tree_flatten(tree)
    leaves = [torch.as_tensor(leaf) for leaf in leaves]
    groups: dict[torch.dtype, list[int]] = {}
    for i, leaf in enumerate(leaves):
        groups.setdefault(leaf.dtype, []).append(i)
    out: list[Any] = [None] * len(leaves)
    for idxs in groups.values():
        fused = allreduce(torch.cat([leaves[i].reshape(-1) for i in idxs]), group, op)
        for i, part in zip(idxs, fused.split([leaves[i].numel() for i in idxs])):
            out[i] = part.reshape(leaves[i].shape)
    return pytree.tree_unflatten(out, spec)
