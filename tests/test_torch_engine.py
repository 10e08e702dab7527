"""The port's engine layer (rabit_tpu_torch.api, engine.torch_dist) on the CPU.

The multi-process matrix runs tests/workers/torch_basic_worker.py, which
checks every result against numpy_reduce of the ranks' inputs, over gloo at
world 2 and 4 (the analogue of tests/test_xla_engine.py).  The rest runs in
this process: the solo paths (tests/test_parallel.py's
test_xla_engine_solo_paths), BITOR on every integer dtype, rebuild() on a
world change, and a half-set bootstrap.
"""

import os
import pathlib
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rabit_tpu import compress as jcompress
from rabit_tpu_torch import api, compress
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.engine import create_engine
from rabit_tpu_torch.engine.base import DTYPE_ENUM
from rabit_tpu_torch.engine.empty import SoloEngine
from rabit_tpu_torch.engine.torch_dist import TorchEngine, bootstrap_settings

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_basic_worker.py"
CPU = ["rabit_engine=torch", "rabit_torch_device=cpu"]
BOOT = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(autouse=True)
def no_bootstrap_env(monkeypatch):
    """Each test starts with no torch.distributed settings in the
    environment and leaves the api uninitialized."""
    for k in BOOT:
        monkeypatch.delenv(k, raising=False)
    yield
    api.finalize()
    if dist.is_initialized():
        dist.destroy_process_group()


def run_world(world: int, timeout: float = 120.0):
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(world), RANK=str(rank))
        procs.append(subprocess.Popen([sys.executable, str(WORKER), "64", *CPU], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}/{world} exited {p.returncode}:\n{out}"
        assert f"worker {rank}/{world} ok" in out, out
    return outs


@pytest.mark.parametrize("world", [2, 4])
def test_torch_engine_matrix_over_gloo(world):
    run_world(world)


def test_torch_engine_solo_paths():
    """No bootstrap settings: the torch engine runs solo, every collective
    an identity and the checkpoints in memory."""
    api.init(CPU)
    assert isinstance(api.get_engine(), TorchEngine)
    assert api.get_rank() == 0 and api.get_world_size() == 1 and not api.is_distributed()
    x = np.arange(4, dtype=np.float64)
    np.testing.assert_array_equal(api.allreduce(x, api.SUM), x)
    assert api.broadcast([1, 2], 0) == [1, 2]
    np.testing.assert_array_equal(api.allgather(x), x[None])
    api.checkpoint({"m": 1})
    assert api.load_checkpoint() == (1, {"m": 1})
    api.lazy_checkpoint({"m": 2})
    assert api.load_checkpoint() == (2, {"m": 2})
    assert api.version_number() == 2
    # solo, a codec still makes its round trip (the host transport: the
    # fused ring needs more than one rank)
    y = (np.random.RandomState(0).randn(2000) * 40).astype(np.float32)
    codec = compress.get_codec("i8")
    assert not api.get_engine().fused_active(codec, api.SUM)
    got = api.get_engine().allreduce_compressed(y, api.SUM, codec)
    assert got.tobytes() == compress.reference_allreduce([y], api.SUM, "i8").tobytes()


def test_torch_engine_refuses_unknown_fused_mode():
    """rabit_fused_allreduce has one parser, engine.fused's, which the
    engine runs when it is made: a value it does not know is refused there,
    with the JAX package's message."""
    with pytest.raises(ValueError, match="want auto, 1/on, or 0/off"):
        TorchEngine(Config(CPU + ["rabit_fused_allreduce=maybe"]))
    assert TorchEngine(Config(CPU + ["rabit_fused_allreduce=off"]))._fused_on is False
    assert TorchEngine(Config(CPU + ["rabit_fused_chunk_kib=64"]))._fused_chunk == 64 * 1024


def test_uninitialized_api_runs_solo_and_registry_picks_engines():
    assert isinstance(api.get_engine(), SoloEngine) and api.get_world_size() == 1
    api.init(["rabit_engine=empty"])
    assert isinstance(api.get_engine(), SoloEngine)
    api.finalize()
    assert isinstance(create_engine(Config(["rabit_engine=auto"])), SoloEngine)
    assert isinstance(create_engine(Config(["rabit_engine=auto", "rabit_torch_rank=0"])),
                      TorchEngine)
    # argv pairs: the last one wins; keyword overrides win over argv
    cfg = Config(["rabit_engine=empty", "rabit_engine=torch", "rabit_torch_rank=1"],
                 {"rabit_torch_rank": 3})
    assert cfg.get("rabit_engine") == "torch" and bootstrap_settings(cfg)[3] == "3"
    with pytest.raises(ValueError, match="unknown rabit_engine"):
        create_engine(Config(["rabit_engine=xla"]))


@pytest.mark.parametrize("missing", BOOT)
def test_half_set_bootstrap_raises(monkeypatch, missing):
    """Three of the four settings: init fails loudly rather than running at
    world 1 while the peers wait."""
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), WORLD_SIZE="2",
               RANK="0")
    for k, v in env.items():
        if k != missing:
            monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="incomplete torch.distributed settings"):
        api.init(CPU)
    assert not dist.is_initialized()


def test_cuda_engine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init(["rabit_engine=torch"])


def _group_of_one(tmp_path, name):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / name), 1),
                            rank=0, world_size=1, timeout=timedelta(seconds=60))


@pytest.mark.parametrize("dtype", [d for d in DTYPE_ENUM if d.kind in "iu"])
def test_bitor_on_every_integer_dtype(tmp_path, dtype):
    """BITOR crosses gloo as bit planes under MAX; at world 1 the result
    must be the input's bits, for patterns that set every bit position."""
    _group_of_one(tmp_path, "store")
    api.init(CPU)
    assert api.get_engine().get_world_size() == 1 and dist.is_initialized()
    bits = 8 * dtype.itemsize
    x = (np.uint64(1) << (np.arange(bits, dtype=np.uint64))).astype(dtype)
    x = np.concatenate([x, np.array([0, -1 if dtype.kind == "i" else np.iinfo(dtype).max],
                                    dtype)])
    got = api.allreduce(x, api.BITOR)
    np.testing.assert_array_equal(got, np.bitwise_or(x, np.zeros_like(x)))
    assert got.dtype == dtype
    with pytest.raises(TypeError, match="BITOR"):
        api.allreduce(np.ones(3, np.float32), api.BITOR)


def test_rebuild_follows_the_world(tmp_path):
    """rebuild() re-reads rank and world from torch.distributed: solo, then
    a group the program made, then solo again; checkpoints survive."""
    api.init(CPU)
    engine = api.get_engine()
    assert engine.get_world_size() == 1 and engine._stage is None
    api.checkpoint({"v": 1})
    _group_of_one(tmp_path, "store")
    engine.rebuild()
    assert engine._stage == torch.device("cpu") and engine.get_rank() == 0
    got = api.allreduce(np.array([5, 7], np.uint32), api.MIN)  # through gloo
    np.testing.assert_array_equal(got, [5, 7])
    assert api.broadcast("x", 0) == "x"
    dist.destroy_process_group()
    engine.rebuild()
    assert engine._stage is None and engine.get_world_size() == 1
    assert api.load_checkpoint() == (1, {"v": 1})


@pytest.mark.parametrize("engine", ["empty", "torch"])
def test_solo_allreduce_codec_matches_reference(engine):
    """tests/test_compress.py's solo case on the solo engine and on a solo
    TorchEngine: api.allreduce(codec=...) equals both packages'
    reference_allreduce bit for bit; the policy compresses a float32 SUM
    over its floor, and a broadcast under rabit_compress_broadcast=zlib
    returns the root's object; finalize resets the policy."""
    api.init([f"rabit_engine={engine}", "rabit_torch_device=cpu",
              "rabit_compress_allreduce=bf16x2", "rabit_compress_min_bytes=1K",
              "rabit_compress_broadcast=zlib"])
    x = (np.random.RandomState(0).randn(2000) * 40).astype(np.float32)
    for name in ("bf16", "bf16x2", "i8", "i8x2"):
        for op in (api.SUM, api.MAX):
            got = api.allreduce(x, op, codec=name)
            want = compress.reference_allreduce([x], op, name)
            assert got.tobytes() == want.tobytes()
            assert want.tobytes() == jcompress.reference_allreduce([x], op, name).tobytes()
    got = api.allreduce(torch.from_numpy(x), api.SUM, codec="i8")
    assert isinstance(got, torch.Tensor)
    assert got.numpy().tobytes() == compress.reference_allreduce([x], api.SUM, "i8").tobytes()
    assert api.allreduce(x, api.SUM).tobytes() == \
        compress.reference_allreduce([x], api.SUM, "bf16x2").tobytes()
    np.testing.assert_array_equal(api.allreduce(x[:10], api.SUM), x[:10])
    np.testing.assert_array_equal(api.allreduce(x, api.SUM, codec="identity"), x)
    assert api.broadcast({"w": list(range(2000))}, 0) == {"w": list(range(2000))}
    with pytest.raises(TypeError, match="float32"):
        api.allreduce(x.astype(np.float64), api.SUM, codec="i8")
    with pytest.raises(ValueError, match="BITOR"):
        api.allreduce(np.ones(4, np.float32), api.BITOR, codec="i8")
    api.finalize()
    assert compress.policy() == compress.Policy()
    with pytest.raises(ValueError, match="unknown codec"):
        api.init(["rabit_engine=empty", "rabit_compress_allreduce=lz4"])
