"""Process meshes and the collectives over their groups.

The port's counterpart of ``rabit_tpu/parallel``: ``mesh`` lays the ranks
of the default process group on a ``DeviceMesh`` (a collective takes the
group of one of its dimensions where JAX takes an axis name), and
``collectives`` holds the collectives, the explicit rings and the
quantized int8-wire ring, and ``ring`` the sequence-parallel attention
(``ring_attention``, ``ulysses_attention`` and their oracle
``reference_attention``) over a group.
"""

from rabit_tpu_torch.parallel.collectives import (
    allgather,
    allreduce,
    broadcast,
    fused_allreduce,
    reduce_scatter,
    ring_allgather,
    ring_allreduce,
    ring_allreduce_quantized,
    ring_reduce_scatter,
    ring_shift,
    wire_device,
)
from rabit_tpu_torch.parallel.mesh import (
    create_mesh,
    replicated,
    resize_ring,
    ring_perm,
    sharded_along,
    snake_order,
)
from rabit_tpu_torch.parallel.ring import (
    reference_attention,
    ring_attention,
    ulysses_attention,
)

__all__ = [
    "create_mesh",
    "resize_ring",
    "ring_perm",
    "replicated",
    "sharded_along",
    "snake_order",
    "allreduce",
    "broadcast",
    "allgather",
    "reduce_scatter",
    "ring_shift",
    "ring_reduce_scatter",
    "ring_allgather",
    "ring_allreduce",
    "ring_allreduce_quantized",
    "fused_allreduce",
    "wire_device",
    "ring_attention",
    "ulysses_attention",
    "reference_attention",
]
