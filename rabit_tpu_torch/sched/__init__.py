"""Topology-aware collective schedules.

The port's own copy of ``rabit_tpu/sched``: the mesh model (``mesh``),
the planner (``planner``: ring orders, and a repair pass that routes a
ring around flagged degraded links), the telemetry consumers that turn
``link_degraded`` reports and straggler analytics into the planner's
avoid set (``repair``), and :func:`resolve` of the schedule config keys.
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
from rabit_tpu_torch.sched.repair import (  # noqa: F401 (re-exports)
    flags_to_tasks,
    links_from_events,
    links_from_stragglers,
    tasks_to_flags,
)


def resolve(cfg) -> dict:
    """Resolve ``rabit_schedule``, ``rabit_sched_mesh``,
    ``rabit_sched_repair`` and ``rabit_sched_wait_share`` into the planner's
    knobs: the algorithm name, the mesh spec, whether degraded-link reports
    trigger a repair replan, and the executor's slow-link report
    threshold."""
    algo = (cfg.get("rabit_schedule", "auto") or "auto").strip().lower()
    if algo not in ALGOS:
        raise ValueError(
            f"rabit_schedule={algo!r} is not one of {'|'.join(ALGOS)}")
    return {
        "schedule": algo,
        "mesh": (cfg.get("rabit_sched_mesh", "") or "").strip(),
        "repair": cfg.get_bool("rabit_sched_repair", True),
        "wait_share": float(cfg.get("rabit_sched_wait_share", "0.25") or "0.25"),
    }
