"""Topology-aware ring orders for the fused collectives.

The port's own copy of what ``engine.fused`` needs from
``rabit_tpu/sched``: the mesh model (``mesh``), the planner (``planner``)
and :func:`resolve` of the two config keys the ring order reads.  The
telemetry-driven repair of degraded links (the JAX package's
``sched/repair.py``) and its settings wait for the port's observability
layer.
"""

from rabit_tpu_torch.sched.mesh import (  # noqa: F401 (re-exports)
    MeshModel,
    auto_dims,
    mesh_for_world,
    parse_mesh_spec,
)
from rabit_tpu_torch.sched.planner import (  # noqa: F401 (re-exports)
    ALGOS,
    Plan,
    plan,
    repair_ring,
    ring_cost,
    serpentine_order,
    tree_cost,
)


def resolve(cfg) -> dict:
    """Resolve ``rabit_schedule`` and ``rabit_sched_mesh`` into the
    planner's knobs: the algorithm name and the mesh spec."""
    algo = (cfg.get("rabit_schedule", "auto") or "auto").strip().lower()
    if algo not in ALGOS:
        raise ValueError(
            f"rabit_schedule={algo!r} is not one of {'|'.join(ALGOS)}")
    return {
        "schedule": algo,
        "mesh": (cfg.get("rabit_sched_mesh", "") or "").strip(),
    }
