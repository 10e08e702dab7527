"""The port's user surface against ``rabit_tpu``'s, function by function.

* ``test_signature_covers_jax``: every public function, class and method of
  a ``rabit_tpu`` module that has a counterpart module in
  ``rabit_tpu_torch`` exists in the port, with every parameter, except
  those on ``ALLOWED`` (the JAX-only ones, each with its reason).
* The tracker plans on its ``sched_mesh`` (F12): the port's tracker and
  ``rabit_tpu``'s, given the same check-ins with ``schedule="swing"`` and a
  mesh spec, send byte-identical Assignments, and ``sched.resolve`` carries
  ``wait_share``.
* The config's keys and defaults are ``rabit_tpu``'s (F13), bar the
  engine-specific ones listed.
* ``Tracker(max_messages=)`` drops with one event, as ``rabit_tpu``'s does;
  ``JobRegistry.live()`` / ``ranks_in_use``; ``Engine.allreduce_fn`` on the
  solo engine, on ``TorchEngine`` over gloo at world 2 and on the native
  engine under the port's launcher gives what ``rabit_tpu``'s base
  ``allreduce_fn`` gives for a max-by-key reducer (F15).
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from rabit_tpu.engine.base import Engine as JaxEngine
from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu_torch import sched
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.tracker.tracker import Tracker

ROOT = pathlib.Path(__file__).resolve().parents[1]
REDUCER = ROOT / "tests" / "workers" / "torch_reducer_worker.py"

#: Modules of rabit_tpu with no counterpart, and why.
NO_COUNTERPART = {
    "_platform": "pins JAX's virtual CPU platform; the port has no JAX",
    "engine.xla": "XlaEngine runs collectives inside XLA graphs; the port's "
                  "TorchEngine (engine/torch_dist.py) stands in its place",
}

#: JAX-only names and parameters the port leaves out, and why.  A key is a
#: parameter name (left out wherever it appears) or a qualified name.
ALLOWED = {
    "interpret": "runs a Pallas kernel in interpret mode; a port kernel's "
                 "CPU twin is chosen by the tensor's device",
    "axis_name": "names a shard_map mesh axis; the port passes a process group",
    "axis": "names a shard_map mesh axis; the port passes a process group",
    "mesh": "a jax.sharding.Mesh; the port's groups come from torch.distributed",
    "dp_axis": "names a shard_map mesh axis; the port passes a process group",
    "fp_axis": "names a shard_map mesh axis; the port passes a process group",
    "devices": "a list of JAX devices for the mesh; the port takes one device",
    "jax_encode": "the codec in a JAX graph; the port's encode runs on torch",
    "jax_decode": "the codec in a JAX graph; the port's decode runs on torch",
    "xla_trace": "captures an XLA profile; profile.device_trace traces the card",
    "node_histograms_pallas": "the Pallas kernel itself; its port is "
                              "node_histograms_kernel (csrc/hist.cu)",
    "local_mesh": "builds a JAX device mesh for the fused ring; the port's "
                  "ring runs on a process group",
    "place_contributions": "shards contributions onto a JAX mesh; the port's "
                           "contributions are tensors of each rank",
    "cpu_worker_env": "pins XLA's CPU platform in worker environments; the "
                      "port's workers pick their device by rabit_torch_device",
}


def _modules() -> list[str]:
    out = []
    for path in sorted((ROOT / "rabit_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "rabit_tpu").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        if parts[-1:] == ["__main__"]:
            continue
        out.append(".".join(parts))
    return out


def _public(mod) -> dict[str, object]:
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_"):
            continue
        if inspect.isclass(obj) and obj.__module__ == mod.__name__:
            out[name] = obj
            for mname, meth in vars(obj).items():
                if mname.startswith("_") and mname != "__init__":
                    continue
                if isinstance(meth, (staticmethod, classmethod)):
                    meth = meth.__func__
                if inspect.isfunction(meth) or isinstance(meth, property):
                    out[f"{name}.{mname}"] = meth
        elif callable(obj) and getattr(obj, "__module__", None) == mod.__name__:
            out[name] = obj  # functions, and jitted or wrapped ones
    return out


def _params(obj):
    if isinstance(obj, property) or inspect.isclass(obj):
        return None
    try:
        return inspect.signature(inspect.unwrap(obj)).parameters
    except (TypeError, ValueError):
        return None


def test_signature_covers_jax():
    mods = _modules()
    assert len(mods) > 50
    gaps = []
    for rel in mods:
        suffix = f".{rel}" if rel else ""
        port_path = ROOT / "rabit_tpu_torch" / rel.replace(".", "/")
        if not (port_path.with_suffix(".py").exists() or (port_path / "__init__.py").exists()):
            assert rel in NO_COUNTERPART, f"rabit_tpu.{rel} has no counterpart and no reason"
            continue
        jm = importlib.import_module("rabit_tpu" + suffix)
        tm = importlib.import_module("rabit_tpu_torch" + suffix)
        for qual, obj in _public(jm).items():
            if qual.split(".")[-1] in ALLOWED or qual in ALLOWED:
                continue
            target = tm
            try:
                for part in qual.split("."):
                    target = getattr(target, part)
            except AttributeError:
                gaps.append(f"rabit_tpu{suffix}.{qual} is missing")
                continue
            theirs, mine = _params(obj), _params(target)
            if theirs is None or mine is None:
                continue
            kinds = {p.kind for p in mine.values()}
            for name, p in theirs.items():
                if name in ("self", "cls") or name in ALLOWED:
                    continue
                if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
                    if p.kind not in kinds:
                        gaps.append(f"rabit_tpu{suffix}.{qual} lacks *{name}")
                elif name not in mine and p.VAR_KEYWORD not in kinds:
                    gaps.append(f"rabit_tpu{suffix}.{qual} lacks {name}=")
    assert not gaps, "\n".join(gaps)


# -- F12: the schedule's mesh ------------------------------------------------

def _check_in(tracker, task_id: str, port: int, last: bool) -> socket.socket:
    s = socket.create_connection((tracker.host, tracker.port))
    JP.send_hello(s, JP.CMD_START, task_id, prev_rank=-1, listen_port=port)
    if not last:  # hold the check-in order: the tracker has this one pending
        deadline = time.monotonic() + 10
        while not any(p.task_id == task_id for p in list(tracker._pending)):
            assert time.monotonic() < deadline, "check-in not registered"
            time.sleep(0.005)
    return s


def _read_all(s: socket.socket) -> bytes:
    s.settimeout(10)
    out = bytearray()
    while chunk := s.recv(65536):
        out += chunk
    s.close()
    return bytes(out)


@pytest.mark.parametrize("mesh,world,ring", [
    ("2x2", 4, [0, 1, 3, 2]),
    ("3x2", 6, [0, 1, 3, 2, 4, 5]),
    ("4x2", 8, [0, 1, 3, 2, 4, 5, 7, 6]),
    ("6x1:nowrap", 6, None),
])
def test_tracker_plans_on_sched_mesh_as_jax(mesh, world, ring):
    ids = [str(i) for i in range(world)]
    got = []
    for cls in (Tracker, JaxTracker):
        tracker = cls(world, quiet=True, schedule="swing", sched_mesh=mesh).start()
        try:
            socks = [(t, _check_in(tracker, t, 41000 + int(t), i == world - 1))
                     for i, t in enumerate(reversed(ids))]
            got.append({t: _read_all(s) for t, s in socks})
            planned = [e for e in tracker.events if e["kind"] == "schedule_planned"]
        finally:
            tracker.stop()
        assert len(planned) == 1 and planned[0]["algo"] == "swing"
        if ring is not None:
            assert planned[0]["ring_order"] == ring
    assert got[0] == got[1]
    # the ring order rides in the Assignment's trailing section
    auto = list(sched.plan(world, "swing", mesh=sched.mesh_for_world(world)).ring_order)
    plan = list(sched.plan(world, "swing", mesh=sched.mesh_for_world(world, mesh)).ring_order)
    tail = JP.put_sched_frame("swing", plan)
    assert all(raw.endswith(tail) for raw in got[0].values())
    if ring is not None:
        assert plan == ring
    if mesh in ("3x2", "4x2"):  # the near-square mesh plans another ring
        assert plan != auto


def test_schedule_job_plans_on_sched_mesh(tmp_path):
    """tools/torch_consensus_bench.py's schedule_job at world 6 on a 3x2
    mesh: the plan in the events and in telemetry.json."""
    from tools.torch_consensus_bench import schedule_job

    job = schedule_job(6, 2, "swing", "3x2", device="cpu", obs_dir=str(tmp_path))
    assert [e["ring_order"] for e in job["planned"]] == [[0, 1, 3, 2, 4, 5]]
    tele = json.loads((tmp_path / "telemetry.json").read_text())
    assert tele["schedule"] == "swing"
    assert [e["ring_order"] for e in tele["events"]
            if e["kind"] == "schedule_planned"] == [[0, 1, 3, 2, 4, 5]]
    assert job["n_contributions"] == 6 * 2


def test_launcher_cli_schedule_and_mesh_reach_the_tracker(tmp_path):
    """``--schedule swing --sched-mesh 3x2`` on the port's launcher: the
    world-6 job's plan is the 3x2 mesh's ring, not the near-square one's."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), RABIT_OBS_DIR=str(tmp_path))
    res = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.launcher", "-n", "6", "--quiet",
         "--schedule", "swing", "--sched-mesh", "3x2", "--", sys.executable,
         str(ROOT / "tests" / "workers" / "torch_recover_worker.py"), "rabit_engine=robust",
         "niter=1"], env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    tele = json.loads((tmp_path / "telemetry.json").read_text())
    assert tele["schedule"] == "swing"
    planned = [e for e in tele["events"] if e["kind"] == "schedule_planned"]
    assert planned and all(e["ring_order"] == [0, 1, 3, 2, 4, 5] for e in planned)


def test_launcher_takes_schedule_and_mesh():
    from rabit_tpu_torch.tracker.launcher import LocalCluster

    c = LocalCluster(2, schedule="swing", sched_mesh="2x2")
    assert (c.schedule, c.sched_mesh) == ("swing", "2x2")


def test_sched_resolve_carries_wait_share():
    from rabit_tpu import sched as jsched
    from rabit_tpu.config import Config as JaxConfig

    for args in ([], ["rabit_sched_wait_share=0.4", "rabit_sched_mesh=2x2",
                      "rabit_schedule=swing"]):
        assert sched.resolve(Config(args)) == jsched.resolve(JaxConfig(args))


# -- F13: the config ---------------------------------------------------------

#: Keys of one package only: the engine-specific bootstraps.
JAX_ONLY_KEYS = {"rabit_xla_coordinator", "rabit_xla_num_processes", "rabit_xla_process_id"}
PORT_ONLY_KEYS = {"rabit_torch_device", "rabit_torch_master_addr", "rabit_torch_master_port",
                  "rabit_torch_world_size", "rabit_torch_rank"}


def test_config_defaults_equal_jax(monkeypatch):
    from rabit_tpu.config import Config as JaxConfig

    for name in list(os.environ):
        if name.startswith(("RABIT_TPU_", "DMLC_")) or name == "RABIT_OBS_DIR":
            monkeypatch.delenv(name)
    theirs, mine = JaxConfig([]).as_dict(), Config([]).as_dict()
    assert set(theirs) - set(mine) == JAX_ONLY_KEYS
    assert set(mine) - set(theirs) == PORT_ONLY_KEYS
    assert {k: mine[k] for k in theirs if k in mine} == {
        k: v for k, v in theirs.items() if k not in JAX_ONLY_KEYS}
    for args in ([], ["rabit_timeout=0"], ["rabit_timeout_sec=30"]):
        assert Config(args).timeout_sec == JaxConfig(args).timeout_sec
    assert Config([]).get_size("rabit_reduce_buffer") == 256 << 20
    assert "rabit_debug" in Config([]) and Config([])["rabit_obs_scrape"] == "obs"


# -- F15: the entry points' missing arguments ---------------------------------

def test_max_messages_drops_with_one_event_as_jax():
    docs = []
    for cls in (Tracker, JaxTracker):
        t = cls(1, quiet=True, max_messages=2)
        try:
            for i in range(5):
                t._log_print(f"line {i}")
            drops = [e for e in t.events if e["kind"] == "messages_dropped"]
            docs.append((list(t.messages), t.messages_dropped,
                         [{k: v for k, v in e.items() if k != "ts"} for e in drops]))
        finally:
            t.stop()
    assert docs[0] == docs[1]
    assert docs[0] == (["line 3", "line 4"], 3, [{"kind": "messages_dropped", "cap": 2}])


def test_service_takes_the_tracker_knobs():
    from rabit_tpu_torch.service import CollectiveService

    svc = CollectiveService(4, quiet=True, schedule="swing", sched_mesh="2x2",
                            sched_wait_share=0.4, max_messages=3)
    try:
        assert (svc.sched_mesh, svc.sched_wait_share, svc.messages.maxlen) == ("2x2", 0.4, 3)
        part = svc.admit("a", 4)
        assert (part.schedule, part.sched_mesh, part.sched_wait_share,
                part.messages.maxlen) == ("swing", "2x2", 0.4, 3)
        assert svc.registry.live() == ["a"] and svc.registry.ranks_in_use == 4
    finally:
        svc.stop()


def test_registry_live_and_ranks_in_use_as_jax():
    from rabit_tpu.service.registry import JobRegistry as JaxRegistry
    from rabit_tpu_torch.service.registry import JobRegistry

    regs = [JobRegistry(max_ranks=10), JaxRegistry(max_ranks=10)]
    for reg in regs:
        for key, world in (("b", 3), ("a", 4), ("c", 5)):
            reg.admit(key, world)
        reg.release("b")
    assert [(r.live(), r.ranks_in_use) for r in regs] == [(["a"], 4)] * 2


def _reducer_module():
    sys.path.insert(0, str(REDUCER.parent))
    try:
        return importlib.import_module("torch_reducer_worker")
    finally:
        sys.path.remove(str(REDUCER.parent))


class _GatherEngine(JaxEngine):
    """rabit_tpu's base engine over a fixed set of rank inputs: its
    ``allgather`` returns them all, so ``allreduce_fn`` is rabit_tpu's fold."""

    def __init__(self, parts):
        self.parts = parts

    def get_rank(self):
        return 0

    def get_world_size(self):
        return len(self.parts)

    def allgather(self, data, cache_key=None):
        return np.concatenate(self.parts)

    allreduce = broadcast = load_checkpoint = checkpoint = version_number = None


def _expected(world: int) -> bytes:
    w = _reducer_module()
    parts = [w.rank_input(r) for r in range(world)]
    return _GatherEngine(parts).allreduce_fn(parts[0], w.max_by_key).tobytes()


def test_allreduce_fn_solo_is_identity_as_jax():
    from rabit_tpu.engine.empty import SoloEngine as JaxSolo
    from rabit_tpu_torch.engine.empty import SoloEngine

    w = _reducer_module()
    x = w.rank_input(0)
    calls = []
    for eng in (SoloEngine(Config([])), JaxSolo(None)):
        out = eng.allreduce_fn(x.copy(), w.max_by_key, prepare_fun=lambda a: calls.append(1))
        assert out.tobytes() == x.tobytes()
    assert calls == [1, 1]


def test_engine_surface_extras():
    from rabit_tpu_torch.engine.base import ShutdownSignal
    from rabit_tpu_torch.engine.empty import SoloEngine
    from rabit_tpu_torch.obs.events import is_recovery_stats_line
    from rabit_tpu.obs.events import is_recovery_stats_line as jax_is_recovery
    from rabit_tpu_torch.tracker import protocol as P

    with pytest.raises(RuntimeError, match="cannot recover"):
        SoloEngine(Config([])).init_after_exception()
    assert issubclass(ShutdownSignal, Exception)
    for line in ("[1] recover_stats version=3 n=2 ", "[1] recover_stats version=0 n=2 ",
                 "[0] recover_stats_final version=4 ", "plain"):
        assert is_recovery_stats_line(line) == jax_is_recovery(line)
    a, b = socket.socketpair()
    try:
        P.send_all(a, b"abc")
        assert P.recv_exact(b, 3) == b"abc"
    finally:
        a.close()
        b.close()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_allreduce_fn_torch_engine_gloo_world2(tmp_path):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(REDUCER), str(tmp_path / "out"), "rabit_engine=torch",
             "rabit_torch_device=cpu"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate(timeout=120)[0]
        assert p.returncode == 0, out
    want = _expected(2)
    for rank in range(2):
        assert (tmp_path / f"out.{rank}").read_bytes() == want


def test_allreduce_fn_native_engine(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.launcher", "-n", "3", "--quiet", "--",
         sys.executable, str(REDUCER), str(tmp_path / "out"), "rabit_engine=native"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    want = _expected(3)
    for rank in range(3):
        assert (tmp_path / f"out.{rank}").read_bytes() == want


def test_guide_programs_and_tools_import_no_jax():
    """Importing each of the port's guide programs and its new tools (and
    the reducer worker) leaves jax and rabit_tpu out of sys.modules."""
    files = ["guide/torch_basic.py", "guide/torch_broadcast.py",
             "guide/torch_lazy_allreduce.py", "guide/torch_durable_resume.py",
             "guide/torch_hybrid_gbdt.py", "tools/torch_consensus_bench.py",
             "tools/torch_chaos_bench.py", "tools/torch_speed_runner.py",
             "tools/torch_obs_top.py", "tests/workers/torch_reducer_worker.py"]
    code = (
        "import sys, importlib.util\n"
        f"for f in {files!r}:\n"
        "    spec = importlib.util.spec_from_file_location(f.split('/')[-1][:-3], f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import torch, rabit_tpu_torch.models.gbdt, rabit_tpu_torch.chaos\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'rabit_tpu' or m.startswith('rabit_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr
