"""The port's sequence-parallel attention (rabit_tpu_torch.parallel.ring)
against the JAX package's (rabit_tpu.parallel.ring) on the same inputs.

The port runs in one spawned gloo group per world W = 1, 2, 4
(tests/workers/torch_ring_worker.py, every case inside it); JAX runs here
under ``shard_map`` over the first W virtual CPU devices, as
tests/test_parallel.py runs it.  Tolerances:

* f32: rtol 2e-4, atol 2e-5, tests/test_parallel.py's, against JAX's
  sharded output and ``reference_attention``.
* bf16 against JAX's sharded output: one bf16 ulp (rtol 2^-7, atol 2e-5).
  Both compute in f32 from the same bf16 inputs (ring: q promoted, k and v
  cast; Ulysses: all cast) and round once to bf16; f32 results within the
  f32 tolerance can round to neighbouring bf16 values, one ulp apart, at
  most 2^-7 of the value.
* bf16 against JAX's ``reference_attention`` of the f32-cast inputs (the
  exact-f32 answer to the same bf16 question): the final rounding, half an
  ulp (2^-8 of the value), on top of the f32 tolerance: rtol 2^-8 + 2e-4,
  atol 2e-5.
* The port's bf16 ``reference_attention`` (computed in bf16, as JAX's)
  against JAX's: each rounds the scores, the probabilities and the output
  to bf16 in its own order, so neither is the other's bits.  Both are held
  to the exact answer, the f64 attention of the same bf16-rounded inputs:
  the port's largest error may be at most 1.5 times JAX's.  Read on the
  test's inputs (seq 32, 4 heads, dim 8): JAX's error 0.0076 (causal
  0.0084), the port's 0.0074 (0.0080), where a mean |output| is 0.20
  (0.30).  Scaling q by 1.01 before the call already gives 0.018 (0.015),
  past the 0.011 (0.013) limit.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rabit_tpu import parallel as rp
from rabit_tpu_torch.parallel import ring

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_ring_worker.py"
WORLDS = (1, 2, 4)
F32 = dict(rtol=2e-4, atol=2e-5)
BF16_VS_JAX = dict(rtol=2.0 ** -7, atol=2e-5)
BF16_VS_F32 = dict(rtol=2.0 ** -8 + 2e-4, atol=2e-5)


def _worker_module():
    spec = importlib.util.spec_from_file_location("torch_ring_worker", WORKER)
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
    return {w: spawn(w, tmp_path_factory.mktemp(f"ring{w}")) for w in WORLDS}


def jax_inputs(world, dname):
    cast = jnp.bfloat16 if dname == "bf16" else jnp.float32
    return [jnp.asarray(a).astype(cast) for a in W.inputs(world)]


def jax_sharded(fn, world, dname, causal):
    mesh = rp.create_mesh(("dp",), devices=jax.devices()[:world])
    f = jax.jit(jax.shard_map(
        lambda q, k, v: getattr(rp, fn)(q, k, v, "dp", causal=causal), mesh=mesh,
        in_specs=(P("dp", None, None),) * 3, out_specs=P("dp", None, None)))
    return np.asarray(f(*jax_inputs(world, dname)).astype(jnp.float32))


def port_out(runs, world, key):
    """The ranks' output blocks in rank order: the whole sequence."""
    return np.concatenate([r[key] for r in runs[world]])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fn", W.FNS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dname", list(W.DTYPES))
def test_attention_matches_jax(runs, world, fn, causal, dname):
    got = port_out(runs, world, f"{fn}/{dname}/{causal}")
    want = jax_sharded(fn, world, dname, causal)
    f32_ref = np.asarray(rp.reference_attention(
        *[a.astype(jnp.float32) for a in jax_inputs(world, dname)], causal=causal))
    if dname == "f32":
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(got, f32_ref, **F32)
    else:
        np.testing.assert_allclose(got, want, **BF16_VS_JAX)
        np.testing.assert_allclose(got, f32_ref, **BF16_VS_F32)


def f64_attention(q, k, v, causal):
    """Full attention of ``[seq, heads, dim]`` f64 inputs, in f64."""
    s = np.einsum("qhd,khd->hqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        s = np.where(np.tril(np.ones((len(q), len(q)), bool))[None], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("hqk,khd->qhd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dname", list(W.DTYPES))
def test_reference_attention_matches_jax(causal, dname):
    q, k, v = W.inputs(4)
    tdt = W.DTYPES[dname]
    got = ring.reference_attention(*[torch.as_tensor(a).to(tdt) for a in (q, k, v)],
                                   causal=causal)
    assert got.dtype == tdt
    want = np.asarray(rp.reference_attention(*jax_inputs(4, dname), causal=causal)
                      .astype(jnp.float32))
    if dname == "f32":
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        exact = f64_attention(*(np.asarray(a.astype(jnp.float32), np.float64)
                                for a in jax_inputs(4, dname)), causal=causal)
        port_err = np.abs(got.float().numpy() - exact).max()
        jax_err = np.abs(want - exact).max()
        assert port_err <= 1.5 * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("world", [2, 4])
def test_ulysses_refuses_heads_not_divisible(runs, world):
    for r in runs[world]:
        msg = str(r["refused"])
        assert f"needs heads ({world + 1}) divisible by the group size ({world})" in msg
        assert msg.endswith("use ring_attention otherwise")
