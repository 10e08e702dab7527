"""The port's world epoch, ``rebootstrap`` and the epoch-stamped durable
frames, against tests/test_elastic.py's seams of the JAX package.

* ``store.CheckpointStore`` writes RTC3 frames (a nonzero world epoch)
  byte for byte as ``rabit_tpu/store.py`` does, for each codec, and epoch 0
  keeps RTC1/RTC2; the epoch reads back.
* ``api.world_epoch`` / ``register_rebalance`` / ``notify_world_change`` /
  ``rebootstrap`` as in ``rabit_tpu/api.py`` (solo: the epoch only moves),
  with the events on the engine's hook, and a checkpoint after a
  rebootstrap stamps the adopted epoch into its frame; on ``TorchEngine``
  ``rebootstrap`` is ``rebuild``.
* ``NativeEngine.rebootstrap`` is finalize then init, and a failed
  finalize does not check in again (a scripted library: nothing is
  loaded).
"""

from __future__ import annotations

import pytest

from rabit_tpu.store import CheckpointStore as JaxStore
from rabit_tpu_torch import api
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.engine.base import Engine
from rabit_tpu_torch.engine.native import NativeEngine, NativeError
from rabit_tpu_torch.store import CheckpointStore


@pytest.fixture(autouse=True)
def solo():
    api.finalize()
    yield
    api.finalize()


@pytest.mark.parametrize("codec", ["zlib", ""])
@pytest.mark.parametrize("epoch", [0, 3])
def test_frames_equal_jax(tmp_path, codec, epoch):
    blob = bytes(range(256)) * 40
    mine = CheckpointStore(str(tmp_path / "port"), rank=1, codec=codec)
    theirs = JaxStore(str(tmp_path / "jax"), rank=1, codec=codec)
    for store in (mine, theirs):
        store.save(4, blob, b"local" * 9, epoch=epoch)
    for name in ("global_r1_v4.bin", "local_r1_v4.bin"):
        raw = (tmp_path / "port" / name).read_bytes()
        assert raw == (tmp_path / "jax" / name).read_bytes()
        assert raw[:4] == (b"RTC3" if epoch else b"RTC2" if codec else b"RTC1")
    fresh = CheckpointStore(str(tmp_path / "jax"), rank=1)
    assert fresh.load_global(4) == blob and fresh.epoch_of(4) == epoch


def test_store_epoch_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path), rank=0)
    store.save(1, b"epoch-zero", None)
    store.save(2, b"epoch-three", None, epoch=3)
    assert (store.epoch_of(1), store.epoch_of(2), store.epoch_of(99)) == (0, 3, 0)
    fresh = CheckpointStore(str(tmp_path), rank=0)
    assert fresh.load_global(1) == b"epoch-zero"
    assert fresh.load_global(2) == b"epoch-three" and fresh.epoch_of(2) == 3


def test_world_epoch_and_rebalance_callbacks():
    api.init(["rabit_engine=empty"])
    seen, events = [], []
    api.get_engine().obs_event = lambda kind, **f: events.append(kind)
    cb = lambda old, new: seen.append((old["world_size"], new["world_size"]))
    try:
        api.register_rebalance(cb)
        api.register_rebalance(cb)  # registers once
        assert api.world_epoch() == {"epoch": 0, "world_size": 1}
        api.notify_world_change(1, 3)
        assert api.world_epoch() == {"epoch": 1, "world_size": 3}
        api.notify_world_change(1, 3)  # the same epoch: nothing
        assert seen == [(1, 3)]
        assert events == ["epoch_changed", "shard_rebalanced"]
        api.unregister_rebalance(cb)
        api.notify_world_change(2, 2)
        assert seen == [(1, 3)] and events[-1] == "epoch_changed"
    finally:
        api.unregister_rebalance(cb)
    api.finalize()
    assert api.world_epoch() == {"epoch": 0, "world_size": 1}


def test_rebootstrap_solo_moves_the_epoch_and_stamps_frames(tmp_path):
    api.init(["rabit_engine=empty", f"rabit_checkpoint_dir={tmp_path}"])
    assert api.world_epoch()["epoch"] == 0
    api.checkpoint({"w": 1})
    assert api.rebootstrap() == {"epoch": 1, "world_size": 1}
    api.checkpoint({"w": 2})
    store = CheckpointStore(str(tmp_path), rank=0)
    assert (store.epoch_of(1), store.epoch_of(2)) == (0, 1)
    assert (tmp_path / "global_r0_v2.bin").read_bytes()[:4] == b"RTC3"


def test_rebootstrap_rebuilds_the_torch_engine(monkeypatch):
    import torch.distributed as dist

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        api.init(["rabit_engine=torch", "rabit_torch_device=cpu"])
        rebuilt = []
        engine = api.get_engine()
        monkeypatch.setattr(engine, "rebuild", lambda: rebuilt.append(engine.get_rank()))
        assert api.rebootstrap() == {"epoch": 1, "world_size": 1} and rebuilt == [0]
    finally:
        api.finalize()
        dist.destroy_process_group()


class _ScriptedLib:
    """Stands in for the native library: records the call order."""

    def __init__(self, fail_finalize: bool = False):
        self.calls: list[str] = []
        self.fail_finalize = fail_finalize

    def RabitInit(self, n, arr):
        self.calls.append("init")
        return 0

    def RabitFinalize(self):
        self.calls.append("finalize")
        return 1 if self.fail_finalize else 0

    def RabitGetRank(self):
        return 0

    def RabitGetWorldSize(self):
        return 2

    def TrtGetLastError(self):
        return b"scripted failure"


def _engine(lib) -> NativeEngine:
    eng = NativeEngine.__new__(NativeEngine)  # no library loaded
    Engine.__init__(eng, Config(["rabit_tracker_uri=NULL"]))
    eng._kind, eng._lib = "native", lib
    return eng


def test_native_rebootstrap_is_finalize_then_init():
    lib = _ScriptedLib()
    eng = _engine(lib)
    eng.rebootstrap()
    assert lib.calls == ["finalize", "init"] and eng.get_world_size() == 2


def test_native_rebootstrap_failed_finalize_does_not_init_again():
    lib = _ScriptedLib(fail_finalize=True)
    with pytest.raises(NativeError, match="finalize failed"):
        _engine(lib).rebootstrap()
    assert lib.calls == ["finalize"]
