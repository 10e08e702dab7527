"""Schedule planner: pure, seed-free, deterministic ring orders.

The port's own copy of ``rabit_tpu/sched/planner.py``.  Given a world
size, an algorithm name, a :class:`~rabit_tpu_torch.sched.mesh.MeshModel`
and a set of degraded links to avoid, :func:`plan` emits a :class:`Plan`
every rank can execute:

* ``tree``/``ring``: the identity ring ``0-1-...-W-1-0``;
* ``swing``: the ring laid as a **boustrophedon Hamiltonian cycle** over
  the mesh model, so every hop is (near-)nearest-neighbour;
* ``auto``: ``swing`` when the mesh model has >= 2 rows, else ``ring``.

A plan is a RING ORDER (a permutation of ranks), never a different
reduction: the fused ring of ``engine.fused`` folds **in rank order**, so
its result is bitwise identical for every ``rabit_schedule`` value.  The
planner is a pure function of ``(world, algo, mesh, avoid)``.  The repair
pass (:func:`repair_ring`) rewrites a ring so flagged directed links
``(src, dst)`` are no longer adjacencies.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from rabit_tpu_torch.sched.mesh import MeshModel, mesh_for_world

#: The rabit_schedule vocabulary.
ALGOS = ("auto", "tree", "ring", "swing")


@dataclass(frozen=True)
class Plan:
    """One epoch's executable schedule.

    ``ring_order[i]`` is the rank at ring position ``i``; position
    ``i`` sends to position ``i+1 (mod W)``.  ``tree``/``ring`` plans
    carry the identity order.  ``avoided`` lists the degraded links the
    ring was rewritten around; ``residual`` the requested avoids that
    could not be removed (e.g. a 2-world has exactly one ring)."""

    algo: str
    world: int
    ring_order: tuple[int, ...]
    avoided: tuple[tuple[int, int], ...] = field(default_factory=tuple)
    residual: tuple[tuple[int, int], ...] = field(default_factory=tuple)

    @property
    def repaired(self) -> bool:
        """True when the repair pass actually rewrote the ring."""
        return bool(self.avoided)

    def position(self, rank: int) -> int:
        return self.ring_order.index(rank)

    def ring_neighbors(self, rank: int) -> tuple[int, int]:
        """(ring_prev, ring_next) of ``rank`` under the planned order."""
        pos = self.position(rank)
        w = self.world
        return self.ring_order[(pos - 1) % w], self.ring_order[(pos + 1) % w]

    def links(self) -> list[tuple[int, int]]:
        """The W directed ring adjacencies (src, dst) in position order."""
        w = self.world
        return [(self.ring_order[i], self.ring_order[(i + 1) % w])
                for i in range(w)]


def serpentine_order(mesh: MeshModel) -> list[int]:
    """Boustrophedon Hamiltonian cycle over the mesh placement: even rows
    left-to-right, odd rows right-to-left — every intra-row hop is one
    link, every row transition stays in one column, and the closing edge
    is one wrap hop on a torus.  Partial last rows just truncate."""
    order: list[int] = []
    for row in range((mesh.world + mesh.cols - 1) // mesh.cols):
        cols = range(mesh.cols) if row % 2 == 0 else reversed(range(mesh.cols))
        for col in cols:
            rank = row * mesh.cols + col
            if rank < mesh.world:
                order.append(rank)
    return order


def repair_ring(order: list[int] | tuple[int, ...],
                avoid: set[tuple[int, int]]) -> tuple[list[int],
                                                      list[tuple[int, int]]]:
    """Rewrite ``order`` so no directed adjacency is in ``avoid``.

    Deterministic greedy: take the first violating adjacency ``(a, b)``
    and swap ``b`` with the first other position that strictly reduces
    the violation count; repeat up to ``W`` passes.  Returns the repaired
    order and the residual violations (empty when fully repaired —
    always achievable for ``W >= 3`` with a single flagged link; a
    2-world has exactly one ring and cannot reroute)."""
    order = list(order)
    w = len(order)
    avoid = {(int(a), int(b)) for a, b in avoid}

    def violations(o: list[int]) -> list[int]:
        return [i for i in range(w) if (o[i], o[(i + 1) % w]) in avoid]

    for _ in range(w):
        viol = violations(order)
        if not viol:
            break
        i = viol[0]
        j_bad = (i + 1) % w
        fixed = False
        for j in range(w):
            if j in (i, j_bad):
                continue
            cand = list(order)
            cand[j_bad], cand[j] = cand[j], cand[j_bad]
            if len(violations(cand)) < len(viol):
                order = cand
                fixed = True
                break
        if not fixed:
            break  # no single swap helps; report the residual honestly
    residual = [(order[i], order[(i + 1) % w]) for i in violations(order)]
    return order, residual


def plan(world: int, algo: str = "auto", mesh: MeshModel | None = None,
         avoid: set[tuple[int, int]] | frozenset | None = None) -> Plan:
    """The one planning entry point.

    ``avoid`` is a set of degraded directed links ``(src_rank,
    dst_rank)``; the repair pass runs for every algorithm (the identity
    ring reroutes too — a degraded link is a fault, not a layout
    preference)."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if algo not in ALGOS:
        raise ValueError(f"unknown schedule {algo!r} (want one of {ALGOS})")
    if mesh is None:
        mesh = mesh_for_world(world)
    if mesh.world != world:
        raise ValueError(f"mesh models world {mesh.world}, planning {world}")
    resolved = algo
    if algo == "auto":
        resolved = "swing" if mesh.rows >= 2 else "ring"
    if resolved == "swing":
        base = serpentine_order(mesh)
    else:  # tree | ring: the reference's identity ring
        base = list(range(world))
    avoid = {(int(a), int(b)) for a, b in (avoid or ())
             if 0 <= int(a) < world and 0 <= int(b) < world
             and int(a) != int(b)}
    if avoid:
        order, residual = repair_ring(base, avoid)
    else:
        order, residual = base, []
    base_links = {(base[i], base[(i + 1) % world]) for i in range(world)}
    final_links = {(order[i], order[(i + 1) % world]) for i in range(world)}
    avoided = sorted((avoid & base_links) - final_links)
    return Plan(
        algo=resolved,
        world=world,
        ring_order=tuple(order),
        avoided=tuple(avoided),
        residual=tuple(sorted(residual)),
    )


# -- cost model (hop counts of a lockstep ring) ------------------------------

def ring_cost(order: list[int] | tuple[int, ...], mesh: MeshModel,
              slow: dict[tuple[int, int], float] | None = None) -> dict:
    """Per-step cost of a lockstep ring schedule under the mesh model.

    Every ring step uses ALL W links simultaneously (each position sends
    to the next), so the step time is gated by the slowest link:
    ``max_hops`` (times any ``slow`` multiplier on degraded links).  One
    allreduce round runs ``W - 1`` steps -> ``round_cost = (W - 1) *
    max_link_cost``; ``total_hops`` tracks aggregate wire occupancy."""
    w = len(order)
    slow = slow or {}
    link_costs = []
    for i in range(w):
        src, dst = order[i], order[(i + 1) % w]
        link_costs.append(mesh.hops(src, dst) * float(slow.get((src, dst),
                                                               1.0)))
    max_cost = max(link_costs) if link_costs else 0.0
    return {
        "total_hops": sum(mesh.hops(order[i], order[(i + 1) % w])
                          for i in range(w)),
        "max_link_cost": max_cost,
        "round_cost": (w - 1) * max_cost if w > 1 else 0.0,
    }


def tree_cost(world: int, mesh: MeshModel) -> dict:
    """Cost of the fixed binary-heap tree on the mesh: per-edge hop
    distances (parent ``(r-1)//2``), the tree depth, and the critical
    path a depth-pipelined reduce pays (``depth * max_edge_hops``).  The
    heap tree is placement-blind — edge ``(r, 2r+1)`` spans ~r cells of
    the row-major layout, which is exactly why its mesh cost explodes
    with world size while the planned rings stay flat."""
    edges = [(r, (r - 1) // 2) for r in range(1, world)]
    hops = [mesh.hops(a, b) for a, b in edges]
    depth = 0
    n = world
    while n > 1:
        depth += 1
        n //= 2
    return {
        "depth": depth,
        "max_edge_hops": max(hops) if hops else 0,
        "total_hops": sum(hops),
        "critical_path": depth * (max(hops) if hops else 0),
    }
