"""The port's durable checkpoint spill (rabit_tpu_torch.store and the api's
``rabit_checkpoint_dir``) and its LazyAllreduce (rabit_tpu_torch.fusion).

The store against ``rabit_tpu.store.CheckpointStore``: the same blobs give
byte-identical files, and each package reads the other's.  The scenarios of
tests/test_durable_ckpt.py over spawned gloo processes (the port has no
tracker; tests/workers/torch_durable_worker.py fits the linear model with a
checkpoint a step): a whole-job stop at version 3 of 6 and a fresh job
resuming it, with rank-local models, with either rank's global files
deleted (served by the other's broadcast; its local model is rebuilt),
with one rank's newest file torn, and a solo job.  Every resumed job must
end with the weights of a job that never stopped, bit for bit.
LazyAllreduce: the cases of tests/test_parallel.py and
tests/test_compress.py against the port's api and both packages'
``reference_allreduce``.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from rabit_tpu import compress as jcompress
from rabit_tpu import store as jstore
from rabit_tpu_torch import api, compress, store
from rabit_tpu_torch.fusion import LazyAllreduce

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_durable_worker.py"


# -- the store against JAX's ----------------------------------------------------------


def _files(d: pathlib.Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize("epoch", [0, 7])
@pytest.mark.parametrize("codec", ["zlib", "identity"])
def test_store_frames_match_jax(tmp_path, codec, epoch):
    """At epoch 0 both stores write byte-identical RTC1/RTC2 frames and each
    reads the other's.  The port writes no world epoch yet, so at epoch 7
    JAX writes its RTC3 frames and the port reads them (blobs and epoch)."""
    blobs = [(3, b"forest " * 4096, b"rank-local"), (4, os.urandom(3000), None),
             (5, b"", b"x" * 70000)]
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    js = jstore.CheckpointStore(str(jdir), 1, codec=codec)
    for v, g, lb in blobs:
        js.save(v, g, lb, epoch=epoch)
    pairs = [(store.CheckpointStore, jdir)]
    if epoch == 0:
        ts = store.CheckpointStore(str(tdir), 1, codec=codec)
        for v, g, lb in blobs:
            ts.save(v, g, lb)
        assert _files(tdir) == _files(jdir)
        assert ts.versions() == [4, 5]
        pairs.append((jstore.CheckpointStore, tdir))
    magic = b"RTC3" if epoch else (b"RTC1" if codec == "identity" else b"RTC2")
    assert (jdir / "global_r1_v5.bin").read_bytes()[:4] == magic
    assert js.versions() == [4, 5]
    # each package reads the other's files
    for reader, d in pairs:
        s = reader(str(d), 1)
        assert s.versions() == [4, 5] and s.latest_valid() == 5
        assert s.load_global(4) == blobs[1][1] and s.load_local(4) is None
        assert s.load_global(5) == b"" and s.load_local(5) == b"x" * 70000
        assert s.epoch_of(5) == epoch and not s.has(3)


def test_store_retention_pin_and_tmp_sweep_match_jax(tmp_path):
    def ops(cls, d):
        (d / "global_r0_v9.tmp").parent.mkdir(parents=True)
        (d / "global_r0_v9.tmp").write_bytes(b"crashed save")
        (d / "global_r1_v9.tmp").write_bytes(b"another rank's")
        s = cls(str(d), 0, keep=2)
        for v in range(1, 5):
            s.save(v, bytes([v]) * 100, None)
        s.pin(3)
        s.save(5, b"five", b"l5")
        s.save(6, b"six", None)
        return s.versions(), _files(d)

    assert ops(store.CheckpointStore, tmp_path / "port") == \
        ops(jstore.CheckpointStore, tmp_path / "jax")
    versions, files = ops(store.CheckpointStore, tmp_path / "again")
    assert versions == [3, 5, 6]
    assert "global_r0_v9.tmp" not in files and "global_r1_v9.tmp" in files


@pytest.mark.parametrize("damage", ["torn", "unknown_codec", "numeric_codec", "crc"])
def test_store_damaged_frame_reads_as_absent(tmp_path, damage):
    s = store.CheckpointStore(str(tmp_path), 0)
    s.save(3, b"x" * 5000, None)
    s.save(4, b"y" * 50000, None)
    path = tmp_path / "global_r0_v4.bin"
    raw = bytearray(path.read_bytes())
    if damage == "torn":
        raw = raw[: len(raw) // 2]
    elif damage == "unknown_codec":
        raw[4] = 200
    elif damage == "numeric_codec":
        raw[4] = compress.get_codec("bf16").codec_id
    else:
        raw[-1] ^= 0xFF
    path.write_bytes(bytes(raw))
    fresh = store.CheckpointStore(str(tmp_path), 0)
    assert not fresh.has(4) and fresh.latest_valid() == 3
    with pytest.raises(RuntimeError, match="missing or corrupt"):
        fresh.load_global(4)


# -- whole-job stop and resume over gloo ------------------------------------------------


def run_jobs(tmp, specs: dict) -> dict:
    """Every job of ``specs`` (name -> (world, checkpoint dir, worker args))
    at once, each rank a process; returns name -> (the ranks' outputs, the
    ranks' logs).  Fails unless every process exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = {}
    for name, (world, ckpt, args) in specs.items():
        procs[name] = [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(tmp / f"{name}.store"),
             str(tmp / f"{name}{r}.npz"), str(ckpt), *args], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    logs = {}
    try:
        for name, ps in procs.items():
            logs[name] = [p.communicate(timeout=120)[0] for p in ps]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for name, ps in procs.items():
        for r, p in enumerate(ps):
            assert p.returncode == 0, f"{name} rank {r} exited {p.returncode}:\n{logs[name][r]}"
    return {name: ([dict(np.load(tmp / f"{name}{r}.npz")) for r in range(len(ps))],
                   logs[name]) for name, ps in procs.items()}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("durable")
    d = {k: tmp / k for k in ("clean", "stop", "solo_clean", "solo")}
    out = run_jobs(tmp, {
        "clean": (2, d["clean"], ["niter=6", "local=1"]),
        "stopped": (2, d["stop"], ["niter=6", "stop_at=3", "local=1"]),
        "solo_clean": (1, d["solo_clean"], ["niter=4"]),
        "solo_stopped": (1, d["solo"], ["niter=4", "stop_at=2"]),
    })
    resume = {}
    lost = ("missing0", "missing1", "corrupt1")
    for name in ("resumed",) + lost:
        shutil.copytree(d["stop"], tmp / name)
        resume[name] = (2, tmp / name, ["niter=6", "local=1"])
    for r in (0, 1):
        for p in (tmp / f"missing{r}").glob(f"global_r{r}_*.bin"):
            p.unlink()
    victim = tmp / "corrupt1" / "global_r1_v3.bin"
    victim.write_bytes(victim.read_bytes()[: victim.stat().st_size // 2])
    resume["solo_resumed"] = (1, d["solo"], ["niter=4"])
    out.update(run_jobs(tmp, resume))
    out["dirs"] = {"resumed": tmp / "resumed", "solo": d["solo"]}
    return out


def test_whole_job_stop_and_resume(jobs):
    (clean, _), (stopped, _), (resumed, _) = jobs["clean"], jobs["stopped"], jobs["resumed"]
    for r in range(2):
        assert clean[r]["resumed_from"] == 0 and clean[r]["version"] == 6
        assert stopped[r]["stopped"] == 1 and stopped[r]["version"] == 3
        assert resumed[r]["resumed_from"] == 3 and resumed[r]["version"] == 6
        assert resumed[r]["w"].tobytes() == clean[0]["w"].tobytes()
        assert clean[r]["w"].tobytes() == clean[0]["w"].tobytes()
    names = sorted(p.name for p in jobs["dirs"]["resumed"].iterdir())
    assert names == [f"{k}_r{r}_v{v}.bin" for k in ("global", "local")
                     for r in range(2) for v in (5, 6)]


def test_resume_with_local_models(jobs):
    # the worker checks each resumed local model against {rank, iter}
    assert [r["rebuilt"] for r in jobs["resumed"][0]] == [0, 0]


@pytest.mark.parametrize("scenario", ["missing0", "missing1", "corrupt1"])
def test_lost_rank_file_served_by_broadcast(jobs, scenario):
    """Rank 0's or rank 1's global files deleted, or rank 1's newest one
    torn: the other rank's broadcast serves the global blob, the rank that
    lost it rebuilds its local model (with the warning), and the job ends
    bit for bit where the clean one did."""
    ranks, logs = jobs[scenario]
    lost = int(scenario[-1])
    for r in range(2):
        assert ranks[r]["resumed_from"] == 3 and ranks[r]["version"] == 6
        assert ranks[r]["w"].tobytes() == jobs["clean"][0][0]["w"].tobytes()
        assert ranks[r]["rebuilt"] == int(r == lost)
        assert ("rank-local model is LOST" in logs[r]) == (r == lost)
    if scenario.startswith("corrupt"):
        assert "ignoring unreadable blob" in logs[lost]


def test_solo_resume(jobs):
    (clean, _), (stopped, _), (resumed, _) = \
        jobs["solo_clean"], jobs["solo_stopped"], jobs["solo_resumed"]
    assert stopped[0]["version"] == 2 and resumed[0]["resumed_from"] == 2
    assert resumed[0]["w"].tobytes() == clean[0]["w"].tobytes()
    versions = sorted(int(p.name.split("_v")[1].split(".")[0])
                      for p in jobs["dirs"]["solo"].glob("global_r0_*.bin"))
    assert versions == [3, 4]  # keep-2 retention, resumed through v4


def test_checkpoint_dir_off_and_solo_api(tmp_path):
    """Without rabit_checkpoint_dir nothing is written; with it a solo
    checkpoint lands as a compressed frame, and a lazy checkpoint is
    eager."""
    api.init([])
    try:
        api.checkpoint({"a": 1})
        assert api.version_number() == 1 and api._ckpt_store is None
    finally:
        api.finalize()
    api.init([f"rabit_checkpoint_dir={tmp_path}"])
    try:
        assert api.load_checkpoint() == (0, None)
        api.checkpoint({"a": 1})
        api.lazy_checkpoint({"a": 2})
        assert api.version_number() == 2
        assert (tmp_path / "global_r0_v2.bin").read_bytes()[:4] == b"RTC2"
    finally:
        api.finalize()
    api.init([f"rabit_checkpoint_dir={tmp_path}"])
    try:
        assert api.load_checkpoint() == (2, {"a": 2})
        assert api.version_number() == 2
    finally:
        api.finalize()


# -- LazyAllreduce -------------------------------------------------------------------


def test_lazy_allreduce_fusion_solo():
    calls = []

    def fake_allreduce(buf, op):
        calls.append((buf.size, op))
        return buf * 2

    lazy = LazyAllreduce(fake_allreduce)
    h1 = lazy.add(np.ones(3, np.float32))
    h2 = lazy.add(np.full((2, 2), 2.0, np.float32))
    h3 = lazy.add(np.arange(4, dtype=np.int32), api.MAX)
    assert len(lazy) == 3
    with pytest.raises(RuntimeError):
        h1.get()
    lazy.flush()
    # one fused call for the two f32 SUM buffers, one for the int MAX buffer
    assert sorted(calls) == [(4, api.MAX), (7, api.SUM)]
    np.testing.assert_allclose(h1.get(), np.full(3, 2.0))
    np.testing.assert_allclose(h2.get(), np.full((2, 2), 4.0))
    np.testing.assert_array_equal(h3.get(), np.arange(4) * 2)
    assert h3.get().dtype == np.int32 and len(lazy) == 0


@pytest.mark.parametrize("spy", [True, False])
def test_lazy_allreduce_codec_grouping(spy):
    """One fused collective per (dtype, op, codec) group, in first-queued
    order, through the port's api.allreduce (a spy, or the default); the
    fused compressed buffer equals both packages' reference fold over the
    concatenation."""
    calls: list[tuple[int, int, str | None]] = []

    def spy_fn(buf, op, codec=None):
        calls.append((buf.size, op, codec))
        return api.allreduce(buf, op, codec=codec)

    api.init([], rabit_compress_min_bytes=1)
    try:
        x = (np.random.RandomState(1).randn(900) * 30).astype(np.float32)
        lz = LazyAllreduce(spy_fn if spy else None)
        h1 = lz.add(x[:400], api.SUM, codec="i8x2")
        h2 = lz.add(x[400:], api.SUM, codec="i8x2")
        h3 = lz.add(np.arange(8, dtype=np.float32), api.SUM)
        h4 = lz.add(np.arange(8, dtype=np.float32), api.MAX, codec="bf16")
        lz.flush()
        if spy:
            assert calls == [(900, api.SUM, "i8x2"), (8, api.SUM, None),
                             (8, api.MAX, "bf16")]
        fused = compress.reference_allreduce([x], api.SUM, "i8x2")
        assert fused.tobytes() == jcompress.reference_allreduce([x], api.SUM, "i8x2").tobytes()
        assert np.concatenate([h1.get(), h2.get()]).tobytes() == fused.tobytes()
        assert np.array_equal(h3.get(), np.arange(8, dtype=np.float32))
        assert np.array_equal(h4.get(), compress.reference_allreduce(
            [np.arange(8, dtype=np.float32)], api.MAX, "bf16"))
    finally:
        api.finalize()
