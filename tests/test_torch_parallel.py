"""The port's collectives (rabit_tpu_torch.parallel) against the JAX
package's (rabit_tpu.parallel) on the same per-rank inputs.

The port runs in one spawned group of W gloo processes per world
(tests/workers/torch_parallel_worker.py, every case inside it); JAX runs
here, under shard_map over a mesh of the first W devices of the 8-device
virtual CPU platform, as tests/test_parallel.py runs it.  Integer ops,
BITOR, the max/min, the gathers and the ring schedules must be exact; f32
sums agree within rtol = 1e-6 (the two sum orders may differ).  The int8
ring is held to tests/test_parallel.py's envelope, bitwise across ranks,
and within one quantization step a hop of JAX's output (XLA may contract
the residual's multiply-add, so the two need not be bitwise equal).
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from rabit_tpu import parallel as rp
from rabit_tpu_torch import parallel as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_parallel_worker.py"
WORLDS = (2, 4)
RTOL = 1e-6


def _worker_module():
    spec = importlib.util.spec_from_file_location("torch_parallel_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = _worker_module().cases


def spawn(world: int, tmp) -> list[dict]:
    """The worker on ``world`` gloo processes; each rank's outputs."""
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
    return {w: spawn(w, tmp_path_factory.mktemp(f"par{w}")) for w in WORLDS}


def port_out(runs, world, name):
    """The case's outputs of every rank, stacked (a dict for a pytree)."""
    ranks = runs[world]
    keys = [k for k in ranks[0] if k == name or k.startswith(name + "/")]
    if keys == [name]:
        return np.stack([r[name] for r in ranks])
    return {k.split("/", 1)[1]: np.stack([r[k] for r in ranks]) for k in keys}


def jax_out(world, name):
    """The JAX function on the case's inputs, one row a device."""
    fn, x, kw = CASES(world)[name]
    mesh = rp.create_mesh(("dp",), devices=jax.devices()[:world])
    body = lambda v: jax.tree.map(lambda o: o[None],
                                  getattr(rp, fn)(jax.tree.map(lambda a: a[0], v), "dp", **kw))
    out = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("dp"), out_specs=P("dp")))(x)
    return jax.tree.map(np.asarray, out)


EXACT = ("max", "min", "bitor_i32", "bitor_u8", "bitor_i16", "bcast_f32", "bcast_bool",
         "ag0", "ag1_tiled", "shift", "shift_back", "ring_ag")
SUMS = ("sum", "rs0", "rs1", "ring_rs", "ring_ar", "fused_tree")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", EXACT)
def test_collective_matches_jax_exactly(runs, world, name):
    got, want = port_out(runs, world, name), jax_out(world, name)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", SUMS)
def test_collective_sum_matches_jax(runs, world, name):
    got, want = port_out(runs, world, name), jax_out(world, name)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL)
        else:
            np.testing.assert_array_equal(g, w)
    # every rank holds its own rows of the same sum
    fn, x, kw = CASES(world)[name]
    if fn == "allreduce":
        np.testing.assert_array_equal(got, np.broadcast_to(got[0], got.shape))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("planes", [1, 2])
def test_ring_allreduce_quantized_envelope_and_jax(runs, world, planes):
    """tests/test_parallel.py's accuracy envelope, the output bitwise equal
    across ranks, and within one quantization step a hop of JAX's."""
    _, x, _ = CASES(world)[f"rq{planes}"]
    got = port_out(runs, world, f"rq{planes}")
    for r in range(1, world):
        np.testing.assert_array_equal(got[r], got[0])
    exact = x.sum(0)
    scale = np.abs(x).sum(0).max()
    err = np.max(np.abs(got[0] - exact))
    assert err <= scale * (world + 1) / 128, (planes, err, scale)
    rel_rms = {2: 1e-4, 1: 0.05}[planes]
    rms = np.sqrt(np.mean((got[0] - exact) ** 2))
    assert rms < rel_rms * np.sqrt(np.mean(exact ** 2)), (planes, rms)
    want = jax_out(world, f"rq{planes}")
    diff = np.abs(got[0] - want[0])
    step = np.abs(x).sum(0).reshape(-1, 256).max(1).max() / 127 / (254 if planes == 2 else 1)
    print(f"world {world} planes {planes}: max |port - JAX| {diff.max():.3e} "
          f"({int((diff > 0).sum())} of {diff.size} elements differ); "
          f"one step a hop allows {(world + 1) * step:.3e}")
    assert diff.max() <= (world + 1) * step


@pytest.mark.parametrize("world", WORLDS)
def test_ring_allreduce_quantized_nonfinite_and_small_blocks(runs, world):
    """An inf poisons only its own 256-element block (the planes are
    clipped before the int8 cast); other blocks keep the envelope.  A
    block of 16 runs the same ring."""
    _, x, _ = CASES(world)["rq_nonfinite"]
    got = port_out(runs, world, "rq_nonfinite")
    for r in range(1, world):
        np.testing.assert_array_equal(got[r], got[0])
    exact = x.sum(0)
    clean = np.ones_like(exact, bool)
    clean[:256] = False
    scale = np.abs(x).sum(0)[clean].max()
    assert np.all(np.isfinite(got[0][clean]))
    assert np.max(np.abs(got[0][clean] - exact[clean])) <= scale * (world + 1) / 128
    _, x16, _ = CASES(world)["rq_block16"]
    got16 = port_out(runs, world, "rq_block16")
    np.testing.assert_allclose(got16[0], jax_out(world, "rq_block16")[0], atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_allreduce_quantized_refusals_match_jax(runs, world):
    """The ragged-block and planes refusals carry JAX's messages; non-f32
    input is refused as JAX refuses it."""
    ranks = runs[world]
    for name in ("rq_ragged", "rq_planes3"):
        with pytest.raises(ValueError) as e:
            jax_out(world, name)
        assert all(str(r[name]) == str(e.value) for r in ranks), (name, str(e.value))
    assert all("f32 input required" in str(r["rq_f64"]) for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_meshes_and_their_groups(runs, world):
    """create_mesh's groups carry collectives; the placements follow the
    mesh's dimensions; a 2 x 2 mesh's "fp" group sums the ranks of one dp
    row, as JAX's psum over "fp" does."""
    ranks = runs[world]
    assert [int(r["mesh_dp"][0]) for r in ranks] == [world * (world + 1) // 2] * world
    assert str(ranks[0]["mesh_placements"]) == "((Replicate(),), (Shard(dim=1),))"
    if world == 4:
        mesh = rp.create_mesh(("dp", "fp"), shape=(2, 2), devices=jax.devices()[:4])
        x = (10 ** np.arange(4)).reshape(2, 2)
        want = np.asarray(jax.shard_map(lambda v: jax.lax.psum(v, "fp"), mesh=mesh,
                                        in_specs=P("dp", "fp"), out_specs=P("dp", "fp"))(x))
        got = np.array([int(r["mesh_fp"][0]) for r in ranks]).reshape(2, 2)
        np.testing.assert_array_equal(got, want)
        assert str(ranks[0]["mesh2_placements"]) == "(Replicate(), Shard(dim=0))"


def test_ring_perm_resize_ring_and_snake_order_match_jax():
    for n in (1, 2, 3, 8):
        for shift in (1, -1, 3):
            assert tp.ring_perm(n, shift) == rp.ring_perm(n, shift)
    for a, b in ((4, 4), (4, 3), (3, 7), (1, 5)):
        assert tp.resize_ring(a, b) == rp.resize_ring(a, b)
    with pytest.raises(ValueError):
        tp.resize_ring(0, 2)

    class FakeDev:
        def __init__(self, id, coords):
            self.id, self.coords = id, coords

    devs = [FakeDev(z * 16 + y * 4 + x, (x, y, z)) for z in range(2) for y in range(4)
            for x in range(4)]
    np.random.RandomState(0).shuffle(devs)
    assert [d.id for d in tp.snake_order(devs)] == [d.id for d in rp.snake_order(devs)]
    cpus = list(jax.devices())[::-1]
    assert [d.id for d in tp.snake_order(cpus)] == [d.id for d in rp.snake_order(cpus)]
    assert tp.snake_order([3, 0, 2, 1]) == [0, 1, 2, 3]
