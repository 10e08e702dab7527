"""The fused quantized ring: encode -> planned-ring hops -> rank-order
decode-fold -> allgather, on the device of the contribution.

The port's counterpart of ``rabit_tpu/engine/fused.py``, behind
``TorchEngine.allreduce_compressed`` when ``rabit_fused_allreduce`` is on
and the world has more than one rank.  The hops run along the planned ring
order of ``sched`` (``rabit_schedule`` / ``rabit_sched_mesh``), and carry
the codec's quantized planes, never f32, until the fold:

1. **encode**: the local f32 contribution is zero-padded to ``world *
   slice_blocks`` scale blocks (every ring position owns an equal block
   range) and quantized with the codec's torch path (``torch_encode``,
   the numpy reference's bytes);
2. **reduce-scatter phase**: W-1 hops along the ring.  A chunk is the
   block-range slice of every wire segment with its scales, a
   self-contained mini-wire.  Hop s carries the W-s chunks still in
   transit: each position receives its own slice's chunk from the origin
   s positions back and forwards the rest.  Every origin's chunk of this
   rank's slice is buffered by origin **rank**;
3. **decode-fold**: the W chunks are decoded, then folded **in rank order**
   (never in arrival order), so the fold is the closed form of
   :func:`rabit_tpu_torch.compress.transport.reference_allreduce` and the
   result is bitwise identical for every ring order.  Decode and fold are
   separate eager ops (each its own kernel on a card), so no multiply of
   the decode is contracted into an add of the fold;
4. **allgather phase**: W-1 hops circulate the folded f32 slices.

Each hop is split into sends of at most ``rabit_fused_chunk_kib`` KiB; the
result does not depend on the split (bytes are split, never re-encoded).
The hops go through ``parallel.collectives``' hop, so their bytes live
where ``wire_device`` says (host memory for gloo with CUDA tensors).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from rabit_tpu_torch.compress import fused_setting
from rabit_tpu_torch.compress.codecs import BLOCK, Codec, _BlockI8, get_codec
from rabit_tpu_torch.engine.base import MAX, MIN, SUM
from rabit_tpu_torch.parallel.collectives import _exchange

#: Default most KiB a hop sends at once (``rabit_fused_chunk_kib``; 0: one
#: send a hop).
DEFAULT_CHUNK_KIB = 256

#: Ops the fused fold covers (BITOR payloads are never codec-compressed).
FUSED_OPS = (SUM, MAX, MIN)


def chunk_bytes_from_config(config) -> int:
    """Resolve ``rabit_fused_chunk_kib`` into bytes."""
    return max(config.get_int("rabit_fused_chunk_kib", DEFAULT_CHUNK_KIB),
               0) * 1024


#: rabit_fused_allreduce spellings that turn the ring on (``auto``, the
#: default, means on); the others of ``compress.FUSED_MODES`` turn it off
_FUSED_ON = ("auto", "1", "on", "true", "yes")


def fused_mode(config) -> bool:
    """Resolve ``rabit_fused_allreduce``: ``auto`` (the default) means on;
    ``0`` keeps the codec work on the device without the ring.  Any other
    value is refused."""
    return fused_setting(config) in _FUSED_ON


def segment_widths(codec: Codec) -> tuple[int, ...]:
    """Per-BLOCK byte width of each contiguous segment of the codec's wire
    layout (plane-major, scales last).  Chunking by scale-block ranges keeps
    every chunk a self-contained mini-wire."""
    if isinstance(codec, _BlockI8):
        return tuple([BLOCK] * codec.planes + [4])
    widths = {"identity": (4 * BLOCK,), "bf16": (2 * BLOCK,),
              "bf16x2": (2 * BLOCK, 2 * BLOCK)}.get(codec.name)
    if widths is None:
        raise ValueError(
            f"codec {codec.name!r} has no fused wire layout (host-only?)")
    return widths


def plan_ring_order(world: int, config) -> tuple[int, ...]:
    """The hops' ring: the planner's ring ORDER for this world under the
    job's ``rabit_schedule`` / ``rabit_sched_mesh``.  The planner is a pure
    function of its inputs, so every process derives the same order."""
    from rabit_tpu_torch import sched

    knobs = sched.resolve(config)
    mesh = sched.mesh_for_world(world, knobs["mesh"])
    return sched.plan(world, knobs["schedule"], mesh).ring_order


def fold_fn(op: int):
    """The elementwise fold of ``op``, as the host transport's numpy fold."""
    if op == SUM:
        return torch.add
    if op == MAX:
        return torch.maximum
    if op == MIN:
        return torch.minimum
    raise ValueError(f"unsupported fused op {op} (want one of {FUSED_OPS})")


def build_fused_allreduce(group, ring_order, op: int, codec: Codec, n: int,
                          chunk_bytes: int = DEFAULT_CHUNK_KIB * 1024,
                          device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The fused ring for one (group, ring, op, codec, n) shape.

    ``ring_order[i]`` is the group rank at ring position ``i`` (a
    :class:`rabit_tpu_torch.sched.Plan` ``ring_order``, or any
    permutation).  Returns a callable that every rank of ``group`` calls
    with its flat f32 contribution of ``n`` elements (moved to ``device``,
    default its own) and that returns, on every rank, the identical
    rank-order fold: bit-equal to ``reference_allreduce`` of the ranks'
    contributions."""
    world, me = dist.get_world_size(group), dist.get_rank(group)
    order = tuple(int(r) for r in ring_order)
    if sorted(order) != list(range(world)):
        raise ValueError(f"ring_order {order!r} is not a permutation of "
                         f"0..{world - 1}")
    if n < 1:
        raise ValueError(f"fused allreduce needs n >= 1, got {n}")
    fold = fold_fn(op)

    # Equal-slice geometry: pad to world * slice_blocks scale blocks so the
    # ring moves identically-shaped chunks.  Zero padding is block-local in
    # every codec, so the first n decoded elements are unaffected.
    nb = -(-n // BLOCK)
    slice_blocks = -(-nb // world)
    nb_pad = slice_blocks * world
    n_pad = nb_pad * BLOCK
    widths = segment_widths(codec)
    seg_offs = np.cumsum([0] + [w * nb_pad for w in widths])[:-1]
    chunk_elems = slice_blocks * BLOCK
    my_pos = order.index(me)
    nxt, prev = order[(my_pos + 1) % world], order[(my_pos - 1) % world]

    def hop(x: torch.Tensor) -> torch.Tensor:
        """One planned-ring hop, split into sends of <= chunk_bytes."""
        total = x.numel() * x.element_size()
        if chunk_bytes <= 0 or total <= chunk_bytes:
            return _exchange([x], group, nxt, prev)[0]
        nsplit = min(-(-total // chunk_bytes), x.shape[-1])
        parts = torch.tensor_split(x, nsplit, dim=-1)
        return torch.cat(_exchange(list(parts), group, nxt, prev), dim=-1)

    def extract(wire: torch.Tensor, p: int) -> torch.Tensor:
        """Chunk for ring position ``p``: the block-range slice of every
        wire segment, concatenated."""
        return torch.cat([wire[int(o) + p * slice_blocks * w:
                               int(o) + (p + 1) * slice_blocks * w]
                          for o, w in zip(seg_offs, widths)])

    def run(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device or x.device, torch.float32).reshape(-1)
        if x.numel() != n:
            raise ValueError(f"fused allreduce built for {n} elements, got {x.numel()}")
        wire = codec.torch_encode(torch.nn.functional.pad(x, (0, n_pad - n)))
        chunks = [extract(wire, p) for p in range(world)]
        buf: list[torch.Tensor | None] = [None] * world
        buf[me] = chunks[my_pos]
        if world > 1:
            # I inject my foreign chunks ordered by ring distance; each
            # received list's head is addressed to me (from the origin s
            # positions back) and its tail forwards onward.
            send = torch.stack([chunks[(my_pos + d) % world] for d in range(1, world)])
            for s in range(1, world):
                recv = hop(send)
                buf[order[(my_pos - s) % world]] = recv[0]
                send = recv[1:]
        dec = [codec.torch_decode(b, chunk_elems) for b in buf]
        acc = dec[0]
        for part in dec[1:]:
            acc = fold(acc, part)
        # Allgather: the slice of ring position p lands at block range
        # [p * slice_blocks, (p + 1) * slice_blocks).
        out = torch.empty((world, chunk_elems), dtype=torch.float32, device=acc.device)
        out[my_pos] = acc
        cur = acc
        for s in range(1, world):
            cur = hop(cur)
            out[(my_pos - s) % world] = cur
        return out.reshape(-1)[:n]

    return run


def run_local(contribs, op: int, codec, ring_order=None,
              chunk_bytes: int = DEFAULT_CHUNK_KIB * 1024, group=None,
              device="cuda") -> np.ndarray:
    """Build and run the fused ring on this rank's contribution
    (``contribs[rank]`` of every rank's, all given) over ``group``; checks
    that every rank got the identical bits and returns them.  Each rank of
    a spawned test world calls it.  Runs on the card unless ``device`` is
    ``"cpu"``; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    c = codec if isinstance(codec, Codec) else get_codec(codec)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if len(contribs) != world:
        raise ValueError(f"{len(contribs)} contributions for a world of {world}")
    order = tuple(ring_order) if ring_order is not None else tuple(range(world))
    mine = np.ascontiguousarray(contribs[rank], np.float32).reshape(-1)
    fn = build_fused_allreduce(group, order, op, c, mine.size, chunk_bytes, device)
    out = fn(torch.from_numpy(mine).to(device))
    from rabit_tpu_torch.parallel.collectives import allgather

    every = allgather(out.view(torch.int32), group)
    if not bool((every == every[0]).all()):
        raise AssertionError(f"fused allreduce diverged across ranks (rank {rank})")
    return out.cpu().numpy().reshape(np.shape(contribs[rank]))
