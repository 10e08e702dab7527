"""The port's trace (rabit_tpu_torch.profile) on the CPU: device_trace
around a CPU round writes a Chrome trace that holds the round's ops, and
split() attributes device time as the card's phase reads it (checked here
on synthetic events: a CPU trace has no device events)."""

import glob
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from rabit_tpu_torch import _build, profile
from rabit_tpu_torch.models import gbdt
from rabit_tpu_torch.ops import boost


def test_device_trace_of_a_cpu_round_holds_its_ops(tmp_path):
    rng = np.random.RandomState(0)
    cfg = gbdt.GBDTConfig(n_features=4, n_trees=1, depth=3, n_bins=16)
    xb = torch.as_tensor(rng.randint(0, 16, size=(512, 4)).astype(np.int32))
    y = torch.as_tensor(rng.randint(0, 2, size=512).astype(np.float32))
    xb3, _ = boost.block_rows(xb, 128)
    state = gbdt.init_state(cfg, 512, "cpu")
    with profile.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        with record_function("round"):
            gbdt.train_round_fused(state, xb3, y, cfg)
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert {"round", "aten::argmax"} <= names, sorted(n for n in names if n)[:40]
    got = profile.split(prof.events(), _build.kernel_names(), window="round")
    assert got["window_ms"] > 0 and got["busy_ms"] == 0 and got["launches"] == 0
    assert got["idle_ms"] == got["window_ms"] and not got["port_ms"] and not got["other_ms"]


def test_device_trace_on_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile.device_trace(str(tmp_path), device="cuda"):
            pass


def _ev(name, dev, start, end, parent=None, kernels=()):
    return SimpleNamespace(name=name, device_type=SimpleNamespace(name=dev),
                           time_range=SimpleNamespace(start=start, end=end),
                           cpu_parent=parent,
                           kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels])


def test_split_attributes_device_time():
    """Port kernels by name (as whole words); other kernels by the top op
    below the window's span whose subtree launched them (the profiler
    lists a kernel under the op that launched it); the rest as "(no op)";
    idle is the window less the union of the device intervals."""
    window = _ev("round", "CPU", 0.0, 1000.0)
    top = _ev("aten::index", "CPU", 10.0, 100.0, parent=window)
    inner = _ev("aten::nonzero", "CPU", 20.0, 50.0, parent=top,
                kernels=[("void at::native::elementwise_kernel<...>", 50.0)])
    launch = _ev("cudaLaunchKernel", "CPU", 30.0, 31.0, parent=inner,
                 kernels=[("void at::native::elementwise_kernel<...>", 50.0)])
    events = [
        window, top, inner, launch,
        _ev("void digit_scatter_kernel<4>(int*)", "CUDA", 100.0, 200.0),
        _ev("scatter_kernel(int const*)", "CUDA", 150.0, 300.0),
        _ev("void at::native::elementwise_kernel<...>", "CUDA", 400.0, 450.0),
        _ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 440.0, 500.0),
        _ev("void late_kernel()", "CUDA", 990.0, 1100.0),
        _ev("round", "CUDA", 100.0, 990.0),  # the span drawn on the device's timeline
    ]
    got = profile.split(events, ("digit_scatter_kernel", "scatter_kernel"), window="round")
    assert got["window_ms"] == pytest.approx(1.0)
    assert got["port_ms"] == pytest.approx({"digit_scatter_kernel": 0.1,
                                            "scatter_kernel": 0.15})
    assert got["other_ms"] == pytest.approx({"aten::index": 0.05, "(no op)": 0.07})
    # union: [100, 300) + [400, 500) + [990, 1000)
    assert got["busy_ms"] == pytest.approx(0.31)
    assert got["idle_ms"] == pytest.approx(0.69)
    assert got["launches"] == 5
    with pytest.raises(ValueError, match="no host span"):
        profile.split(events, (), window="step")


# -- per-collective stats (tests/test_profile.py) --------------------------------------

def test_stats_accumulate_solo():
    from rabit_tpu_torch import api

    api.reset_collective_stats()
    api.init()
    api.allreduce(np.arange(10, dtype=np.float32), api.SUM)
    api.allreduce(np.arange(4, dtype=np.float32), api.MAX)
    api.broadcast({"x": 1}, 0)
    api.finalize()
    s = api.collective_stats()
    assert s.ops["allreduce"].calls == 2
    assert s.ops["allreduce"].nbytes == 10 * 4 + 4 * 4
    assert s.ops["broadcast"].calls == 1
    rep = s.report()
    assert "allreduce" in rep and "MiB" in rep


def test_stats_report_empty():
    assert "no collectives" in profile.CollectiveStats().report()


def test_timed_context():
    s = profile.CollectiveStats()
    with s.timed("allgather", 128):
        pass
    assert s.ops["allgather"].calls == 1
    assert s.ops["allgather"].max_seconds >= 0


def test_stats_line_parsers_live_in_obs_events():
    """The stdout parsers are obs.events', not profile's (rabit_tpu removed
    its profile facade): a recovery stats line splits on the first '='."""
    from rabit_tpu_torch.obs.events import is_recovery_stats_line, parse_stats_line

    assert not hasattr(profile, "parse_stats_line")
    assert not hasattr(profile, "is_recovery_stats_line")
    line = ("[3] recover_stats version=2 summary_rounds=4 table_rounds=2 "
            "serve_bytes=1048576 summary_depth=8 table_hops=14")
    kv = parse_stats_line(line)
    assert kv["version"] == "2" and int(kv["summary_depth"]) == 8 and int(kv["table_hops"]) == 14
    assert parse_stats_line("k=a=b x")["k"] == "a=b"
    assert is_recovery_stats_line(line)
