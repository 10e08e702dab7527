"""The port's fused quantized ring (rabit_tpu_torch.engine.fused) and
compressed ``api.allreduce`` over gloo, against both packages'
``reference_allreduce``.

One spawned group of W gloo processes per world
(tests/workers/torch_compress_worker.py, every case inside it).  The
analogue of tests/test_fused.py's gate: every fused codec x {SUM, MAX} x
{identity, swing, repaired} ring must equal the port's
``compress.reference_allreduce`` and ``rabit_tpu.compress.reference_allreduce``
**bit for bit**, the same on every rank, whatever the hop split, and again
after ``TorchEngine.rebuild()``; ``api.allreduce(codec=...)`` too, with the
fused ring on and off.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from rabit_tpu import compress as jcompress
from rabit_tpu import sched as jsched
from rabit_tpu_torch import compress as tcompress
from rabit_tpu_torch.engine.base import SUM

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_compress_worker.py"
WORLDS = (2, 4)


def _worker_module():
    spec = importlib.util.spec_from_file_location("torch_compress_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _worker_module()


def spawn(world: int, tmp) -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(tmp / "store"),
         str(tmp / f"rank{r}.npz")], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}/{world} exited {p.returncode}:\n{logs[r]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {w: spawn(w, tmp_path_factory.mktemp(f"fused{w}")) for w in WORLDS}


def same_everywhere(ranks, key):
    out = ranks[0][key]
    for r in ranks[1:]:
        assert r[key].tobytes() == out.tobytes(), key
    return out


def bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes(), np.abs(got - want).max()


def references(parts, op, codec):
    """Both packages' reference folds, which must agree."""
    ref = tcompress.reference_allreduce(parts, op, codec)
    bitwise(jcompress.reference_allreduce(parts, op, codec), ref)
    return ref


@pytest.mark.parametrize("world", WORLDS)
def test_ring_orders_match_jax_planner(runs, world):
    """The port's planner lays the gate's rings as rabit_tpu.sched does."""
    want = {"identity": tuple(range(world)),
            "swing": jsched.plan(world, "swing", jsched.mesh_for_world(world)).ring_order,
            "repaired": jsched.plan(world, "ring", avoid={(0, 1)}).ring_order}
    for name, order in want.items():
        assert tuple(same_everywhere(runs[world], f"order/{name}")) == order
        assert W.schedules(world)[name] == order


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("ring", ["identity", "swing", "repaired"])
def test_fused_parity_gate(runs, world, ring):
    """fused == reference host fold, bitwise, across codecs x ops on this
    ring, the same bits on every rank."""
    parts = W.contribs(world, 700, seed=world)
    for cname in W.CODECS:
        for oname, op in W.OPS.items():
            got = same_everywhere(runs[world], f"fused/{ring}/{cname}/{oname}")
            bitwise(got, references(parts, op, cname))


@pytest.mark.parametrize("world", WORLDS)
def test_fused_chunk_knob_parity(runs, world):
    """Hops split into sends of 64 B, 1 KiB and 4 MiB give the same bits."""
    ref = references(W.contribs(world, 5000, seed=3), SUM, "i8x2")
    for chunk in W.CHUNKS:
        bitwise(same_everywhere(runs[world], f"chunk/{chunk}"), ref)


@pytest.mark.parametrize("world", WORLDS)
def test_api_allreduce_codec_fused_on_and_off(runs, world):
    """api.allreduce(codec=...) through TorchEngine over gloo: the fused
    ring (rabit_fused_allreduce=1) and the host transport (0) both equal
    the reference bit for bit, and the ring again after rebuild()."""
    parts = W.contribs(world, 1000, seed=11)
    for cname in W.CODECS:
        for oname, op in W.OPS.items():
            ref = references(parts, op, cname)
            for mode in ("1", "0"):
                bitwise(same_everywhere(runs[world], f"api/{mode}/{cname}/{oname}"), ref)
        bitwise(same_everywhere(runs[world], f"rebuilt/{cname}"),
                references(parts, SUM, cname))


@pytest.mark.parametrize("world", WORLDS)
def test_api_compress_policy_and_broadcast(runs, world):
    """rabit_compress_allreduce=i8 compresses a float32 SUM of at least
    rabit_compress_min_bytes, leaves a smaller one exact; a broadcast under
    rabit_compress_broadcast=zlib delivers the root's object."""
    parts = W.contribs(world, 1000, seed=11)
    bitwise(same_everywhere(runs[world], "policy"), references(parts, SUM, "i8"))
    small = same_everywhere(runs[world], "small")
    np.testing.assert_allclose(small, np.sum([p[:100] for p in parts], axis=0), rtol=1e-6)
    for r in runs[world]:
        np.testing.assert_array_equal(r["bcast"], np.arange(3000) * 2)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_run_local_without_a_card_raises(monkeypatch, device):
    """run_local runs on the card unless given device="cpu": with no card,
    the default and an explicit "cuda" raise before any collective, and
    nothing falls back to the CPU."""
    from rabit_tpu_torch.engine import fused

    monkeypatch.setattr(fused.torch.cuda, "is_available", lambda: False)
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused.run_local([np.ones(4, np.float32)], SUM, "i8", **kw)


# -- in-process units of tests/test_fused.py --------------------------------------------

def test_fused_active_gating():
    """``fused_active`` mirrors ``allreduce_compressed``'s routing: on for a
    device codec and a fused op at world > 1, off at world 1, for a
    host-only codec, for BITOR and under ``rabit_fused_allreduce=0``; the
    solo engine always answers False."""
    from rabit_tpu_torch.config import Config
    from rabit_tpu_torch.engine.base import BITOR, MAX
    from rabit_tpu_torch.engine.empty import SoloEngine
    from rabit_tpu_torch.engine.torch_dist import TorchEngine

    eng = TorchEngine(Config(["rabit_torch_device=cpu"]))
    eng._rank, eng._world = 0, 4
    assert eng.fused_active(tcompress.get_codec("i8"), SUM)
    assert eng.fused_active(tcompress.get_codec("bf16x2"), MAX)
    assert not eng.fused_active(tcompress.get_codec("zlib"), SUM)  # host-only codec
    assert not eng.fused_active(tcompress.get_codec("i8"), BITOR)
    eng._world = 1
    assert not eng.fused_active(tcompress.get_codec("i8"), SUM)
    off = TorchEngine(Config(["rabit_torch_device=cpu", "rabit_fused_allreduce=0"]))
    off._rank, off._world = 0, 4
    assert not off.fused_active(tcompress.get_codec("i8"), SUM)
    assert not SoloEngine(Config([])).fused_active(tcompress.get_codec("i8"), SUM)


def test_collective_events_carry_fused_identity():
    """A fused collective's op_begin/op_end carry fused=1, a host-path op
    none, and the trace merger's spans keep the flag."""
    from rabit_tpu_torch import api, obs
    from rabit_tpu_torch.obs import trace

    api.init([], rabit_compress_min_bytes=1)
    try:
        obs.get_recorder().clear()
        with obs.collective("allreduce", 64, cache_key="k", codec="i8", fused=True):
            pass
        api.allreduce(np.arange(600, dtype=np.float32), api.SUM, codec="i8")  # host path
        evs = [e for e in obs.get_recorder().snapshot() if e.kind in ("op_begin", "op_end")]
        assert len([e for e in evs if e.fields.get("fused") == 1]) == 2
        assert len([e for e in evs if "fused" not in e.fields]) == 2
        assert [s.fused for s in trace.pair_ops(evs)] == [True, False]
    finally:
        api.finalize()


def test_build_fused_allreduce_refuses_bad_input(tmp_path):
    """build_fused_allreduce refuses a ring order that is no permutation of the
    group's ranks and an empty contribution, before any hop."""
    import torch.distributed as dist

    from rabit_tpu_torch.engine import fused

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            world_size=1, rank=0)
    try:
        c = tcompress.get_codec("i8")
        with pytest.raises(ValueError, match="permutation"):
            fused.build_fused_allreduce(None, (0, 0), SUM, c, 64)
        with pytest.raises(ValueError, match="permutation"):
            fused.build_fused_allreduce(None, (0, 1), SUM, c, 64)
        with pytest.raises(ValueError, match="n >= 1"):
            fused.build_fused_allreduce(None, (0,), SUM, c, 0)
    finally:
        dist.destroy_process_group()
