"""The compressed allreduce with the fused ring off, and the compress
policy's event.

* ``rabit_fused_allreduce=0`` on ``TorchEngine``: ``rabit_tpu``'s unfused
  device path (``XlaEngine._compressed_fns``): the codec's encode on the
  engine's device, one ``all_gather`` of the encoded planes, the rank-order
  decode-fold.  On gloo groups of 2 and 4 processes
  (tests/workers/torch_compressed_device_worker.py) every codec with a
  device path under SUM, MAX and MIN must equal both packages'
  ``reference_allreduce`` bit for bit on every rank, with ``fused_active``
  False, the wire bytes counted under ``fused=0`` and no run of the
  numpy host transport; a codec without a device path takes the host
  transport, as in ``rabit_tpu``.
* ``api.init`` records ``fused`` (``rabit_tpu``'s spelling of
  ``rabit_fused_allreduce``) and ``fused_chunk_kib`` in its
  ``compress_policy`` event, as tests/test_fused.py holds ``rabit_tpu`` to.
"""

import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from rabit_tpu import compress as jcompress
from rabit_tpu.config import Config as JaxConfig
from rabit_tpu_torch import api, compress as tcompress, obs
from rabit_tpu_torch.engine.base import MAX, MIN, SUM

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_compressed_device_worker.py"
OPS = {"sum": SUM, "max": MAX, "min": MIN}


def _worker_module():
    spec = importlib.util.spec_from_file_location("torch_compressed_device_worker", WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _worker_module()


def spawn(world: int, tmp, device: str = "cpu") -> list[dict]:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world), str(tmp / "store"),
         str(tmp / f"rank{r}.npz"), device], env=env, cwd=ROOT, stdout=subprocess.PIPE,
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


@pytest.fixture(scope="module", params=(2, 4), ids=lambda w: f"world{w}")
def world_results(request, tmp_path_factory):
    world = request.param
    return world, spawn(world, tmp_path_factory.mktemp(f"dev{world}"))


@pytest.mark.parametrize("cname", W.CODECS)
@pytest.mark.parametrize("oname", sorted(OPS))
def test_device_path_bitwise_reference(world_results, cname, oname):
    world, results = world_results
    xs = W.contribs(world)
    want = tcompress.reference_allreduce(xs, OPS[oname], cname)
    jwant = jcompress.reference_allreduce(xs, OPS[oname], cname)
    np.testing.assert_array_equal(want.view(np.uint32), jwant.view(np.uint32))
    for r, res in enumerate(results):
        got = res[f"dev/{cname}/{oname}"]
        assert got.dtype == np.float32 and got.shape == (W.N,)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), (
            f"rank {r} of {world}: {cname} {oname} differs from reference_allreduce")


def test_device_path_stamps_unfused_and_skips_host(world_results):
    world, results = world_results
    for res in results:
        assert not res["fused_flags"].any() and res["unfused_counted"].all()


@pytest.mark.parametrize("cname", ("bf16", "i8"))
def test_host_only_codec_takes_host_transport(world_results, cname):
    world, results = world_results
    want = tcompress.reference_allreduce(W.contribs(world), SUM, cname)
    for res in results:
        assert int(res["host_calls"]) == 2
        assert np.array_equal(res[f"host/{cname}"].view(np.uint32), want.view(np.uint32))
        # the device path and the host transport give the same bits
        assert np.array_equal(res[f"dev/{cname}/sum"].view(np.uint32),
                              res[f"host/{cname}"].view(np.uint32))


@pytest.mark.parametrize("value", ["1", "0", "ON", "auto", ""])
def test_compress_policy_event_records_fused_keys(value):
    api.finalize()
    api.init(["rabit_engine=empty", f"rabit_fused_allreduce={value}",
              "rabit_fused_chunk_kib=128"])
    try:
        pol = [e for e in obs.get_recorder().snapshot() if e.kind == "compress_policy"]
        want = jcompress.configure(JaxConfig([f"rabit_fused_allreduce={value}"]))
        assert pol and pol[-1].fields["fused"] == want.fused
        assert pol[-1].fields["fused_chunk_kib"] == 128
    finally:
        api.finalize()
        jcompress.reset()


def test_compress_policy_refuses_bad_fused_spelling():
    api.finalize()
    with pytest.raises(ValueError, match="rabit_fused_allreduce"):
        api.init(["rabit_engine=empty", "rabit_fused_allreduce=maybe"])
    api.finalize()
