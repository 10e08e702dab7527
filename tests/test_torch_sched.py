"""Topology-aware collective schedules on the port: the counterpart of
tests/test_sched.py, the same asserts against ``rabit_tpu_torch``'s sched,
protocol, tracker, ``ElasticWorker`` and tools/torch_consensus_bench.py:
the mesh model and the pure planner, the telemetry consumers, the
Assignment's trailing schedule frame and the native prefix contract, a
swing-planned world on ``sched_mesh="2x2"`` end to end with its evidence,
and the consensus bench's tier-1 gates (``run_smoke`` on the CPU, whose
contributions take ``node_histograms_kernel``'s plain twin, and the
ablation curve).

tests/test_sched.py's slow-link pair and per-algorithm fuzz have their
counterparts in tests/test_torch_chaos_planes.py under the same names.
"""

import json
import socket
import threading
import time

import numpy as np
import pytest

from rabit_tpu_torch import sched
from rabit_tpu_torch.elastic.client import ElasticWorker
from rabit_tpu_torch.elastic.rebalance import shard_slice
from rabit_tpu_torch.obs.events import event_from_stats_line
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.tracker import Tracker


# -- mesh model ---------------------------------------------------------------

def test_auto_dims_near_square():
    assert sched.auto_dims(16) == (4, 4)
    assert sched.auto_dims(512) == (16, 32)
    assert sched.auto_dims(12) == (3, 4)
    assert sched.auto_dims(7) == (1, 7)  # prime: degenerate 1 x W
    assert sched.auto_dims(1) == (1, 1)


def test_parse_mesh_spec():
    assert sched.parse_mesh_spec("") is None
    assert sched.parse_mesh_spec("8x8") == (8, 8, True)
    assert sched.parse_mesh_spec("4X8:nowrap") == (4, 8, False)
    with pytest.raises(ValueError):
        sched.parse_mesh_spec("8by8")
    with pytest.raises(ValueError):
        sched.parse_mesh_spec("0x4")


def test_mesh_hops_wrap_and_open():
    torus = sched.MeshModel(16, 4, 4, wrap=True)
    grid = sched.MeshModel(16, 4, 4, wrap=False)
    assert torus.coords(5) == (1, 1)
    assert torus.hops(0, 1) == 1
    assert torus.hops(0, 3) == 1   # column wrap
    assert grid.hops(0, 3) == 3    # no wrap: full row walk
    assert torus.hops(0, 12) == 1  # row wrap
    assert grid.hops(0, 12) == 3
    with pytest.raises(ValueError):
        torus.coords(16)
    with pytest.raises(ValueError):
        sched.MeshModel(17, 4, 4)  # too small


def test_mesh_for_world_spec_and_fallback():
    m = sched.mesh_for_world(12, "3x4")
    assert (m.rows, m.cols, m.wrap) == (3, 4, True)
    # a spec the world outgrew falls back to auto dims, not an error
    m2 = sched.mesh_for_world(64, "2x2")
    assert m2.rows * m2.cols >= 64


# -- planner ------------------------------------------------------------------

def test_serpentine_is_hamiltonian_and_single_hop():
    mesh = sched.mesh_for_world(16, "4x4")
    order = sched.serpentine_order(mesh)
    assert sorted(order) == list(range(16))
    # every hop, including the closing torus edge, is one mesh link
    for i in range(16):
        assert mesh.hops(order[i], order[(i + 1) % 16]) == 1


def test_plan_resolution_and_validation():
    assert sched.plan(8, "tree").algo == "tree"
    assert sched.plan(8, "ring").ring_order == tuple(range(8))
    assert sched.plan(8, "auto").algo == "swing"     # 2x4 mesh: real extent
    assert sched.plan(7, "auto").algo == "ring"      # 1x7: no mesh to exploit
    with pytest.raises(ValueError):
        sched.plan(8, "fastest")
    with pytest.raises(ValueError):
        sched.plan(0, "ring")
    # determinism: same inputs, same plan (no RNG, no clock)
    assert sched.plan(64, "swing") == sched.plan(64, "swing")
    p = sched.plan(6, "swing")
    assert p.ring_neighbors(p.ring_order[0]) == (p.ring_order[-1],
                                                 p.ring_order[1])


def test_repair_removes_any_single_link_at_world_3_plus():
    for world in (3, 4, 5, 8):
        base = sched.plan(world, "ring").ring_order
        for i in range(world):
            bad = (base[i], base[(i + 1) % world])
            plan = sched.plan(world, "ring", avoid={bad})
            assert bad not in plan.links(), (world, bad, plan)
            assert plan.avoided == (bad,)
            assert plan.residual == ()
            assert sorted(plan.ring_order) == list(range(world))


def test_repair_two_world_is_infeasible_and_honest():
    plan = sched.plan(2, "ring", avoid={(0, 1)})
    assert plan.residual == ((0, 1),)
    assert plan.avoided == ()


def test_repair_ignores_out_of_world_flags():
    plan = sched.plan(3, "ring", avoid={(7, 9), (1, 1), (-1, 0)})
    assert plan.ring_order == (0, 1, 2)
    assert plan.avoided == () and plan.residual == ()


def test_cost_model_swing_beats_fixed_ring_at_scale():
    """The ablation acceptance shape: on the simulated torus the Swing
    serpentine ring halves the identity ring's lockstep round cost at
    world >= 256 (and everywhere else)."""
    for world in (64, 256, 512):
        mesh = sched.mesh_for_world(world)
        ring = sched.ring_cost(sched.plan(world, "ring").ring_order, mesh)
        swing = sched.ring_cost(sched.plan(world, "swing").ring_order, mesh)
        assert swing["round_cost"] < ring["round_cost"]
        assert swing["max_link_cost"] == 1.0
    assert sched.tree_cost(512, sched.mesh_for_world(512))["depth"] == 9


# -- telemetry consumers ------------------------------------------------------

def test_links_from_events_thresholds():
    events = [{"kind": "link_degraded", "src": 1, "dst": 2},
              {"kind": "link_degraded", "src": 1, "dst": 2},
              {"kind": "link_degraded", "src": 0, "dst": 3},
              {"kind": "wave", "src": 9, "dst": 9},
              {"kind": "link_degraded", "src": "x", "dst": 2},
              {"kind": "link_degraded", "src": 2, "dst": 2}]
    assert sched.links_from_events(events) == {(1, 2), (0, 3)}
    assert sched.links_from_events(events, min_reports=2) == {(1, 2)}


def test_links_from_stragglers_flags_incoming_link():
    report = {"per_rank": {"0": {"lateness_share": 0.05},
                           "1": {"lateness_share": 0.1},
                           "2": {"lateness_share": 0.8}}}
    assert sched.links_from_stragglers(report, [0, 1, 2]) == {(1, 2)}
    # permuted ring: the incoming link follows the ORDER, not rank-1
    assert sched.links_from_stragglers(report, [0, 2, 1]) == {(0, 2)}
    assert sched.links_from_stragglers(report, [0]) == set()


def test_link_flags_survive_rank_remap():
    rank_map_a = {"0": 0, "1": 1, "2": 2}
    tasks = sched.flags_to_tasks({(1, 2)}, rank_map_a)
    assert tasks == {("1", "2")}
    # after a shrink, task "1" left and "2" moved to rank 1
    rank_map_b = {"0": 0, "2": 1}
    assert sched.tasks_to_flags(tasks, rank_map_b) == set()
    rank_map_c = {"0": 0, "2": 1, "1": 2}  # both back, moved
    assert sched.tasks_to_flags(tasks, rank_map_c) == {(2, 1)}


def test_slow_link_print_becomes_link_degraded_event():
    ev = event_from_stats_line(
        "[2] slow_link src=1 dst=2 wait=0.512 share=0.43")
    assert ev is not None and ev.kind == "link_degraded"
    assert ev.fields["src"] == 1 and ev.fields["dst"] == 2
    assert ev.fields["share"] == pytest.approx(0.43)
    assert ev.fields["rank"] == 2


# -- wire ---------------------------------------------------------------------

def test_sched_frame_roundtrip():
    a, b = socket.socketpair()
    try:
        a.sendall(P.put_sched_frame("swing", [0, 2, 1]))
        assert P.read_sched_frame(b) == ("swing", [0, 2, 1])
        a.sendall(P.put_sched_frame("", []))
        assert P.read_sched_frame(b) == ("", [])
    finally:
        a.close()
        b.close()


def test_assignment_schedule_roundtrip():
    asg = P.Assignment(rank=1, world_size=3, parent=0, children=[],
                       ring_prev=0, ring_next=2,
                       peers={r: ("127.0.0.1", 1000 + r) for r in range(3)},
                       epoch=4, rank_map={"0": 0, "1": 1, "2": 2},
                       algo="swing", ring_order=[0, 2, 1])
    a, b = socket.socketpair()
    try:
        a.sendall(asg.encode())
        got = P.Assignment.recv(b)
    finally:
        a.close()
        b.close()
    assert got == asg
    assert got.algo == "swing" and got.ring_order == [0, 2, 1]


def test_native_prefix_contract_leaves_trailing_bytes_unread():
    """A legacy reader consuming exactly the native prefix (through the
    epoch) must see the PRE-schedule values — the planned ring rides
    only in the trailing section, which stays unread on the socket."""
    asg = P.Assignment(rank=2, world_size=4, parent=0, children=[],
                       ring_prev=1, ring_next=3,
                       peers={r: ("h", 1) for r in range(4)},
                       epoch=9, rank_map={str(r): r for r in range(4)},
                       algo="swing", ring_order=[0, 1, 3, 2])
    a, b = socket.socketpair()
    try:
        a.sendall(asg.encode())
        # comm.cc RecvAssignment, field for field:
        assert P.get_u32(b) == P.MAGIC_ASSIGN
        assert P.get_i32(b) == 2          # rank
        assert P.get_u32(b) == 4          # world
        P.get_i32(b)                      # parent
        for _ in range(P.get_u32(b)):
            P.get_i32(b)                  # children
        assert P.get_i32(b) == 1          # ring_prev: LEGACY rank-1
        assert P.get_i32(b) == 3          # ring_next: LEGACY rank+1
        for _ in range(P.get_u32(b)):
            P.get_i32(b), P.get_str(b), P.get_u32(b)
        assert P.get_u32(b) == 9          # epoch — the native client stops
        b.setblocking(False)
        remaining = b.recv(65536)         # ...and the trailing bytes exist
        assert len(remaining) > 0
    finally:
        a.close()
        b.close()


# -- tracker e2e --------------------------------------------------------------

def _histogram_job(world, n_bins=8, iter_sleep=0.02):
    n_rows = 8 * world
    data = np.arange(n_rows, dtype=np.int64) % n_bins

    def contribution(version, w, r):
        time.sleep(iter_sleep)
        shard = data[shard_slice(n_rows, w, r)]
        return np.bincount(shard, minlength=n_bins).astype(np.int64) * version

    def expected(niter):
        return sum(np.bincount(data, minlength=n_bins).astype(np.int64) * v
                   for v in range(1, niter + 1))

    return contribution, expected


def _run_workers(tracker, world, contribution, niter, **kw):
    results, lock = {}, threading.Lock()

    def run_one(w):
        res = w.run()
        with lock:
            results[w.task_id] = res

    workers = [ElasticWorker((tracker.host, tracker.port), str(i),
                             contribution, niter, wave_timeout=10.0,
                             link_timeout=5.0, deadline_sec=30.0, **kw)
               for i in range(world)]
    threads = [threading.Thread(target=run_one, args=(w,), daemon=True)
               for w in workers]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=40.0)
        assert not th.is_alive(), "worker thread hung"
    return results


def test_e2e_swing_plan_executes_bitwise(tmp_path):
    """A swing-planned world: the Assignment carries the serpentine
    ring, the executors run it, bits match the closed form, and the
    evidence (schedule_planned, telemetry, Perfetto instant) is
    there."""
    world, niter = 4, 3
    contribution, expected = _histogram_job(world)
    obs_dir = tmp_path / "obs"
    tracker = Tracker(world, quiet=True, obs_dir=str(obs_dir),
                      schedule="swing", sched_mesh="2x2").start()
    try:
        results = _run_workers(tracker, world, contribution, niter)
    finally:
        tracker.stop()
    assert len(results) == world
    for tid, res in results.items():
        assert res.completed, f"{tid}: {res.error}"
        assert np.array_equal(res.state, expected(niter))
    planned = [e for e in tracker.events if e["kind"] == "schedule_planned"]
    assert planned and planned[0]["algo"] == "swing"
    # 2x2 serpentine: 0,1 then 3,2
    assert planned[0]["ring_order"] == [0, 1, 3, 2]
    tele = json.loads((obs_dir / "telemetry.json").read_text())
    assert tele["schedule"] == "swing"
    assert tele["n_schedule_repaired"] == 0
    # Perfetto rendering: the plan shows on the tracker track
    from rabit_tpu_torch.obs import trace

    doc, _path, _report = trace.export_job(str(obs_dir))
    instants = [e for e in doc["traceEvents"] if e.get("ph") == "i"]
    assert any(e["name"] == "schedule_planned" for e in instants)


# -- the consensus bench's tier-1 gates ----------------------------------------

def test_consensus_bench_smoke_all_schedules_bitwise():
    from tools.torch_consensus_bench import run_smoke

    out = run_smoke(world=3, niter=3, device="cpu")
    assert out["bitwise_identical"] is True
    assert set(out["modes"]) == {"auto", "tree", "ring", "swing"}
    assert out["modes"]["swing"]["resolved"] == "swing"
    # one histogram a contribution: four schedules x three ranks x three rounds
    assert out["n_contributions"] == 4 * 3 * 3 and out["device"] == "cpu"


def test_consensus_bench_schedule_ablation_curve():
    from tools.torch_consensus_bench import schedule_ablation

    lines = schedule_ablation(worlds=(64, 256, 512))
    by_world = {l["world"]: l for l in lines}
    for world in (256, 512):
        l = by_world[world]
        # the acceptance bar: swing beats the fixed tree+ring data plane
        # on the simulated mesh at world >= 256
        assert l["swing_round_cost"] < l["ring_round_cost"]
        assert l["swing_vs_fixed_ring"] >= 2.0
        # repairing the degraded link recovers the slow factor
        assert l["degraded_repaired_cost"] < l["degraded_unrepaired_cost"]
        assert l["repaired_avoided"] == [l["degraded_link"]]
    assert by_world[512]["tree_depth"] == 9
