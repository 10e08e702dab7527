"""Process meshes over torch.distributed ranks.

The port's counterpart of ``rabit_tpu/parallel/mesh.py``.  Where JAX lays
devices on a ``Mesh`` and a collective names an axis, here the ranks of the
default process group are laid on a ``DeviceMesh`` and a collective takes
the process group of one of its dimensions (``mesh.get_group(axis)``).
Ranks are snake-ordered as the JAX package orders devices: items with
torus ``coords`` boustrophedon, everything else by id (a rank is its own
id).  ``ring_perm`` and ``resize_ring`` are the JAX package's, verbatim.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _id(d) -> int:
    return d.id if hasattr(d, "id") else int(d)


def snake_order(devices: Sequence) -> list:
    """Order devices (or ranks) so consecutive entries are torus neighbours.

    Items with ``coords`` are sorted boustrophedon: even rows
    left-to-right, odd rows right-to-left, recursively over the outer
    dimensions.  Items without coords (ranks, CPU devices) keep id order.
    """
    devs = list(devices)
    if not devs or getattr(devs[0], "coords", None) is None:
        return sorted(devs, key=_id)

    def key(d):
        # coords are (x, y, z); snake along x within y rows, along y within
        # z planes.
        x, y, z = (list(d.coords) + [0, 0, 0])[:3]
        sx = x if (y + z) % 2 == 0 else -x
        sy = y if z % 2 == 0 else -y
        return (z, sy, sx)

    return sorted(devs, key=key)


def create_mesh(axis_names: Sequence[str] = ("dp",),
                shape: Sequence[int] | None = None,
                ranks: Sequence[int] | None = None,
                device_type: str = "cuda"):
    """A ``DeviceMesh`` over ``ranks`` (default: every rank of the default
    process group, which must be initialized), snake-ordered, with
    ``mesh_dim_names=axis_names``.  ``shape`` defaults to every rank on
    the first axis and 1 on the rest.  Every rank of the default group must
    call it with the same arguments (it makes each dimension's groups)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("create_mesh(device_type='cuda') but no CUDA device "
                           "is available; pass device_type='cpu' for gloo")
    order = snake_order(range(dist.get_world_size()) if ranks is None else ranks)
    if shape is None:
        shape = [len(order)] + [1] * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    if n > len(order):
        raise ValueError(f"mesh shape {shape} needs {n} ranks, have {len(order)}")
    grid = torch.tensor([_id(r) for r in order[:n]], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axis_names))


def ring_perm(n: int, shift: int = 1) -> list[tuple[int, int]]:
    """Permutation sending mesh position i to i+shift (mod n)."""
    return [(i, (i + shift) % n) for i in range(n)]


def resize_ring(n_old: int, n_new: int, shift: int = 1) -> dict:
    """Ring-topology rebuild for an elastic resize: the new permutation for
    ``n_new`` positions plus the link delta against the ``n_old`` ring
    (the links a shrink or grow has to establish; every other hop
    persists)."""
    if n_old < 1 or n_new < 1:
        raise ValueError(f"ring sizes must be >= 1, got {n_old}->{n_new}")
    old = set(ring_perm(n_old, shift))
    new = ring_perm(n_new, shift)
    return {"perm": new,
            "added": sorted(set(new) - old),
            "removed": sorted(old - set(new))}


def replicated(mesh) -> tuple:
    """DTensor placements replicating a tensor on every mesh dimension."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in range(mesh.ndim))


def sharded_along(mesh, axis_name: str, ndim: int = 1, dim: int = 0) -> tuple:
    """DTensor placements (in the mesh's dimension order) sharding tensor
    dimension ``dim`` over the mesh dimension ``axis_name`` and replicating
    over the others."""
    from torch.distributed.tensor import Replicate, Shard

    if not 0 <= dim < ndim:
        raise ValueError(f"dim {dim} outside a {ndim}-d tensor")
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise ValueError(f"mesh has no dimension {axis_name!r} (has {names})")
    return tuple(Shard(dim) if name == axis_name else Replicate() for name in names)
