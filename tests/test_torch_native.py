"""The port's bridge to rabit's C++ engine, its tracker and its launcher.

* ``engine.native.build_lib`` builds the library from ``native/src`` into
  the port's build directory and writes nothing beside the sources (run on
  a copy of ``native/``, so a concurrent build of the JAX package's own
  library in ``native/`` cannot disturb the comparison); a failed build
  raises.
* The engine matrix (tests/workers/torch_basic_worker.py) under the port's
  ``LocalCluster`` at worlds 1, 2 and 4 with ``rabit_engine=native``, and at
  world 2 with no engine named, where the worker finds its tracker through
  the ``DMLC_*`` environment alone (F2) and ``auto`` picks the native engine.
* The port's tracker hands out byte for byte the assignments
  ``rabit_tpu``'s tracker does for the same seeded check-in sequences,
  recovery waves included, and its protocol encoders equal JAX's.
* An unreachable tracker is an error naming its address and the retry
  budget, in a process of its own (the test process never loads the
  library: the JAX package's copy may live in it).
"""

from __future__ import annotations

import os
import shutil
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from rabit_tpu.tracker import protocol as JP
from rabit_tpu.tracker.tracker import Tracker as JaxTracker
from rabit_tpu.tracker.tracker import assign_ranks as jax_assign_ranks
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.engine import create_engine, native
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.launcher import LocalCluster
from rabit_tpu_torch.tracker.tracker import Tracker, assign_ranks

ROOT = Path(__file__).resolve().parents[1]
BASIC = str(ROOT / "tests" / "workers" / "torch_basic_worker.py")
BOOT = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@pytest.fixture(scope="module")
def built():
    """The port's library, built once before the workers load it."""
    return native.build_lib()


def snapshot(d: Path) -> dict[str, tuple[int, int]]:
    return {str(p.relative_to(d)): (p.stat().st_mtime_ns, p.stat().st_size)
            for p in sorted(d.rglob("*"))}


@pytest.fixture
def native_copy(tmp_path, monkeypatch):
    """The sources of native/ in a temp dir, and a temp build dir."""
    src = tmp_path / "native"
    shutil.copytree(native.NATIVE_DIR / "src", src / "src",
                    ignore=shutil.ignore_patterns("*.o"))
    shutil.copytree(native.NATIVE_DIR / "include", src / "include")
    monkeypatch.setattr(native, "NATIVE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    return src


def test_build_writes_only_the_build_dir(built, native_copy, tmp_path):
    assert built.parent == ROOT / "rabit_tpu_torch" / "_build" and built.exists()
    before = snapshot(native_copy)
    out = native.build_lib()
    assert snapshot(native_copy) == before
    assert out.parent == tmp_path / "_build" and out.name.startswith("libtpurabit-")
    assert {p.name for p in out.parent.iterdir()} == {out.name, "libtpurabit.lock"}
    mtime = out.stat().st_mtime_ns
    assert native.build_lib() == out and out.stat().st_mtime_ns == mtime  # reused
    # an edited source is another library
    (native_copy / "src" / "comm.cc").write_text(
        (native_copy / "src" / "comm.cc").read_text() + "\n// edited\n")
    assert native.lib_path() != out


def test_failed_build_raises(native_copy):
    (native_copy / "src" / "socket.cc").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native library build failed"):
        native.build_lib()


def run_matrix(world: int, args: list[str], monkeypatch, n: int = 64) -> LocalCluster:
    for k in BOOT:  # nothing of torch.distributed's bootstrap reaches the workers
        monkeypatch.delenv(k, raising=False)
    cluster = LocalCluster(world, quiet=True, extra_env={"OMP_NUM_THREADS": "1"})
    assert cluster.run([sys.executable, BASIC, str(n), *args], timeout=120) == 0
    assert sorted(cluster.messages) == [f"worker {r}/{world} ok" for r in range(world)]
    return cluster


@pytest.mark.parametrize("world", [1, 2, 4])
def test_engine_matrix_native(built, world, monkeypatch):
    cluster = run_matrix(world, ["rabit_engine=native", "lazy=0"], monkeypatch)
    assert all(rc == 0 for rc in cluster.returncodes.values())
    assert [e["epoch"] for e in cluster.events if e["kind"] == "wave"] == [0]


@pytest.mark.parametrize("world", [2, 3, 5, 8])
def test_cluster_collectives(built, world, monkeypatch):
    """tests/test_native.py's cluster worlds on the base engine: trees and
    rings of odd and larger worlds than the matrix above runs."""
    run_matrix(world, ["rabit_engine=base"], monkeypatch)


def test_cluster_large_payload_ring_path(built, monkeypatch):
    """Counts past rabit_reduce_ring_mincount take the ring allreduce."""
    run_matrix(4, ["rabit_engine=base"], monkeypatch, n=100_000)


def test_cluster_reduce_buffer_budget(built, monkeypatch):
    """A tiny rabit_reduce_buffer stages the tree and ring paths in
    sub-chunks without changing any result."""
    run_matrix(4, ["rabit_engine=base", "rabit_reduce_buffer=4K", "rabit_reduce_ring_mincount=1"],
               monkeypatch, n=100_000)
    run_matrix(3, ["rabit_engine=base", "rabit_reduce_buffer=1K"], monkeypatch, n=50_000)


def test_native_solo_roundtrip(built):
    """No tracker: the native engine runs solo through the C ABI (its C++
    empty engine), in a process of its own."""
    code = ("import numpy as np\n"
            "from rabit_tpu_torch import api as rt\n"
            "rt.init(['rabit_engine=native'])\n"
            "assert type(rt.get_engine()).__name__ == 'NativeEngine'\n"
            "assert rt.get_rank() == 0 and rt.get_world_size() == 1\n"
            "x = np.arange(8, dtype=np.float32)\n"
            "assert np.array_equal(rt.allreduce(x, rt.SUM), x)\n"
            "assert rt.broadcast({'k': 1}, 0) == {'k': 1}\n"
            "rt.checkpoint({'model': [1, 2]})\n"
            "assert rt.version_number() == 1\n"
            "assert rt.load_checkpoint() == (1, {'model': [1, 2]})\n"
            "rt.tracker_print('native solo ok')\n"
            "rt.finalize()\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "RABIT_TPU_")) and k not in BOOT}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr
    assert "native solo ok" in out.stdout + out.stderr


def test_worker_finds_its_tracker_through_dmlc_alone(built, monkeypatch):
    """F2: no rabit_* argument and no RABIT_TPU_* variable; auto reads
    DMLC_TRACKER_URI and takes the native engine at world 2."""
    for k in [k for k in os.environ if k.startswith("RABIT_TPU_")]:
        monkeypatch.delenv(k)
    run_matrix(2, ["lazy=0"], monkeypatch)


def test_config_precedence(monkeypatch):
    """argv over RABIT_TPU_* over DMLC_* over the defaults."""
    for k in [k for k in os.environ if k.startswith(("RABIT_TPU_", "DMLC_"))]:
        monkeypatch.delenv(k)
    assert Config().get("rabit_tracker_uri") == "NULL"
    monkeypatch.setenv("DMLC_TRACKER_URI", "10.0.0.1")
    monkeypatch.setenv("DMLC_TRACKER_PORT", "9000")
    monkeypatch.setenv("DMLC_TASK_ID", "7")
    monkeypatch.setenv("DMLC_NUM_ATTEMPT", "2")
    cfg = Config()
    assert (cfg.get("rabit_tracker_uri"), cfg.get_int("rabit_tracker_port"),
            cfg.get("rabit_task_id"), cfg.get_int("rabit_num_trial")) == \
        ("10.0.0.1", 9000, "7", 2)
    monkeypatch.setenv("RABIT_TPU_RABIT_TRACKER_URI", "10.0.0.2")
    assert Config().get("rabit_tracker_uri") == "10.0.0.2"
    assert Config(["rabit_tracker_uri=10.0.0.3"]).get("rabit_tracker_uri") == "10.0.0.3"


def test_auto_takes_the_native_engine_under_a_tracker(monkeypatch):
    for k in [k for k in os.environ if k.startswith(("RABIT_TPU_", "DMLC_"))] + list(BOOT):
        monkeypatch.delenv(k, raising=False)
    made = []
    monkeypatch.setattr(native, "NativeEngine", lambda cfg, kind: made.append(kind))
    create_engine(Config(["rabit_tracker_uri=127.0.0.1"]))
    for kind in native.KINDS:
        create_engine(Config([f"rabit_engine={kind}"]))
    assert made == ["native", *native.KINDS]
    assert type(create_engine(Config())).__name__ == "SoloEngine"
    with pytest.raises(ValueError, match="unknown rabit_engine 'bogus'"):
        create_engine(Config(["rabit_engine=bogus"]))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_unreachable_tracker_raises(built):
    port = free_port()
    code = ("from rabit_tpu_torch import api\n"
            f"api.init(['rabit_engine=native', 'rabit_tracker_uri=127.0.0.1',"
            f" 'rabit_tracker_port={port}', 'rabit_connect_retry=1'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, cwd=ROOT)
    assert out.returncode != 0
    assert (f"tracker at 127.0.0.1:{port} unreachable after 2 backed-off connect "
            "attempts (rabit_connect_retry=1)") in out.stderr, out.stderr


# -- the tracker's bytes against rabit_tpu's -----------------------------------------


def test_protocol_encoders_equal_jax():
    rng = np.random.RandomState(0)
    for _ in range(50):
        world = int(rng.randint(1, 9))
        rank = int(rng.randint(world))
        parent, children = P.tree_topology(rank, world)
        assert (parent, children) == JP.tree_topology(rank, world)
        args = (rank, world, parent, children, (rank - 1) % world, (rank + 1) % world)
        assert P.assignment_head_bytes(*args) == JP.assignment_head_bytes(*args)
        peers = {int(r): (f"10.0.0.{rng.randint(256)}", int(rng.randint(1, 65536)))
                 for r in rng.permutation(world)}
        rank_map = {f"t{rng.randint(1000)}": r for r in range(world)}
        order = [int(r) for r in rng.permutation(world)]
        tail = (peers, int(rng.randint(100)), rank_map, "swing", order)
        assert P.assignment_tail_bytes(*tail) == JP.assignment_tail_bytes(*tail)
        wave = [(t, f"h{rng.randint(3)}") for t in rank_map]
        prev = {t: int(rng.randint(-1, world + 1)) for t in rank_map if rng.rand() < 0.5}
        assert assign_ranks(wave, world, prev) == jax_assign_ranks(wave, world, prev)


def _check_in(tracker, cmd: int, task_id: str, prev_rank: int, port: int,
              last: bool) -> socket.socket:
    s = socket.create_connection((tracker.host, tracker.port))
    JP.send_hello(s, cmd, task_id, prev_rank=prev_rank, listen_port=port)
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


def _waves(tracker, waves) -> list[dict[str, bytes]]:
    """Each wave's check-ins in order; the assignment bytes each got."""
    got = []
    for wave in waves:
        socks = [(t, _check_in(tracker, cmd, t, prev, port, i == len(wave) - 1))
                 for i, (cmd, t, prev, port) in enumerate(wave)]
        got.append({t: _read_all(s) for t, s in socks})
    return got


@pytest.mark.parametrize("seed", range(4))
def test_tracker_assignments_equal_jax(seed):
    """Seeded waves of mixed task ids (launcher numbers and names), a start
    wave and two recovery waves in which survivors recover in a shuffled
    order and one task id starts again."""
    rng = np.random.RandomState(seed)
    world = int(rng.randint(2, 7))
    ids = [str(i) if rng.rand() < 0.5 else f"w{i}" for i in range(world)]
    ports = {t: 40000 + i for i, t in enumerate(ids)}
    waves = [[(JP.CMD_START, t, -1, ports[t]) for t in rng.permutation(ids)]]
    for _ in range(2):
        dead = ids[rng.randint(world)]
        waves.append([(JP.CMD_START if t == dead else JP.CMD_RECOVER, t,
                       -1 if t == dead else 0, ports[t]) for t in rng.permutation(ids)])
    trackers = [Tracker(world, quiet=True).start(), JaxTracker(world, quiet=True).start()]
    try:
        mine, theirs = (_waves(t, waves) for t in trackers)
    finally:
        for t in trackers:
            t.stop()
    assert mine == theirs
    # and what the C++ client reads of it: rank, world, neighbours, epoch
    for wave in mine:
        ranks = set()
        for raw in wave.values():
            magic, rank, w = struct.unpack_from("<Iii", raw)
            assert magic == P.MAGIC_ASSIGN and w == world
            ranks.add(rank)
        assert ranks == set(range(world))
    assert [e["epoch"] for e in trackers[0].events if e["kind"] == "wave"] == [0, 1, 2]
