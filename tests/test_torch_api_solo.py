"""The port's solo-mode API: the counterpart of tests/test_api_solo.py,
with the same calls and asserts against ``rabit_tpu_torch``.  An
uninitialized process acts as rank 0 of world 1, every collective is an
identity, and the checkpoints are versioned in memory."""

import numpy as np
import pytest

import rabit_tpu_torch as rt
import rabit_tpu_torch.api


@pytest.fixture(autouse=True)
def _fresh_port_engine():
    """Each test starts with the port's engine singleton unset."""
    yield
    rabit_tpu_torch.api._engine = None


def test_uninitialized_defaults_to_solo():
    assert rt.get_rank() == 0
    assert rt.get_world_size() == 1
    assert not rt.is_distributed()


def test_init_finalize_solo():
    rt.init([])
    assert rt.get_rank() == 0
    assert rt.get_world_size() == 1
    rt.finalize()


def test_double_init_warns():
    rt.init([])
    with pytest.warns(UserWarning):
        rt.init([])
    rt.finalize()


def test_allreduce_identity_solo():
    rt.init([])
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    out = rt.allreduce(x, rt.SUM)
    np.testing.assert_array_equal(out, x)
    assert out.shape == (3, 4)
    rt.finalize()


def test_allreduce_ops_and_dtypes():
    rt.init([])
    for dtype in ["int8", "uint8", "int32", "uint32", "int64", "uint64", "float32", "float64"]:
        x = np.arange(5, dtype=dtype)
        for op in [rt.MAX, rt.MIN, rt.SUM, rt.BITOR]:
            if op == rt.BITOR and np.dtype(dtype).kind == "f":
                continue
            out = rt.allreduce(x, op)
            np.testing.assert_array_equal(out, x)
    rt.finalize()


def test_allreduce_rejects_bad_input():
    rt.init([])
    with pytest.raises(TypeError):
        rt.allreduce([1, 2, 3], rt.SUM)
    with pytest.raises(TypeError):
        rt.allreduce(np.array(["a"]), rt.SUM)
    rt.finalize()


def test_allreduce_prepare_fun_called():
    rt.init([])
    x = np.zeros(4, dtype=np.float64)
    called = []

    def prep(arr):
        called.append(True)
        arr[:] = 7.0

    out = rt.allreduce(x, rt.SUM, prepare_fun=prep)
    assert called == [True]
    np.testing.assert_array_equal(out, np.full(4, 7.0))
    rt.finalize()


def test_broadcast_object_solo():
    rt.init([])
    obj = {"s": "hello", "v": [1, 2, 3]}
    assert rt.broadcast(obj, 0) == obj
    with pytest.raises(ValueError):
        rt.broadcast(None, 0)
    rt.finalize()


def test_allgather_solo():
    rt.init([])
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    out = rt.allgather(x)
    assert out.shape == (1, 2, 3)
    np.testing.assert_array_equal(out[0], x)
    rt.finalize()


def test_checkpoint_roundtrip():
    rt.init([])
    version, model = rt.load_checkpoint()
    assert version == 0 and model is None

    rt.checkpoint({"weights": [1.0, 2.0]})
    assert rt.version_number() == 1
    version, model = rt.load_checkpoint()
    assert version == 1
    assert model == {"weights": [1.0, 2.0]}

    rt.checkpoint({"weights": [3.0]}, local_model={"rank_state": 42})
    version, gmodel, lmodel = rt.load_checkpoint(with_local=True)
    assert version == 2
    assert gmodel == {"weights": [3.0]}
    assert lmodel == {"rank_state": 42}
    rt.finalize()


def test_lazy_checkpoint():
    rt.init([])
    model = {"w": 1}
    rt.lazy_checkpoint(model)
    assert rt.version_number() == 1
    model["w"] = 2  # mutating before load is visible — lazy contract
    version, got = rt.load_checkpoint()
    assert version == 1 and got == {"w": 2}
    rt.finalize()


def test_tracker_print_solo(capsys):
    rt.init([])
    rt.tracker_print("hello tracker")
    assert "hello tracker" in capsys.readouterr().out
    rt.finalize()


def test_config_layering():
    from rabit_tpu_torch.config import Config, parse_unit

    cfg = Config(["rabit_reduce_ring_mincount=1", "rabit_debug=1"])
    assert cfg.get_int("rabit_reduce_ring_mincount") == 1
    assert cfg.get_bool("rabit_debug")
    assert cfg.get_size("rabit_reduce_buffer") == 256 << 20
    assert parse_unit("1K") == 1024
    assert parse_unit("2M") == 2 << 20
    assert parse_unit("512") == 512
    # Watchdog is armed by default since round 3 (1800s); rabit_timeout=0
    # disables it.
    assert cfg.timeout_sec == 1800
    cfg2 = Config(["rabit_timeout=1", "rabit_timeout_sec=300"])
    assert cfg2.timeout_sec == 300
    assert Config(["rabit_timeout=0"]).timeout_sec == 0


def test_config_env_layering(monkeypatch):
    from rabit_tpu_torch.config import Config

    monkeypatch.setenv("DMLC_TRACKER_URI", "10.0.0.1")
    monkeypatch.setenv("DMLC_TASK_ID", "7")
    monkeypatch.setenv("RABIT_TPU_RABIT_DEBUG", "1")
    cfg = Config([])
    assert cfg.get("rabit_tracker_uri") == "10.0.0.1"
    assert cfg.get("rabit_task_id") == "7"
    assert cfg.get_bool("rabit_debug")
    # argv overrides env
    cfg = Config(["rabit_tracker_uri=NULL"])
    assert cfg.get("rabit_tracker_uri") == "NULL"
