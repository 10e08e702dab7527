"""The port's wire codecs, transport and policy (rabit_tpu_torch.compress)
against the JAX package's (rabit_tpu.compress), on the CPU.

The analogue of tests/test_compress.py:67: for every codec with a device
path, ``torch_encode`` gives the bytes of JAX's ``jax_encode`` and of the
numpy ``encode``, bit for bit, and ``torch_decode`` the values of both
decodes (NaN where they have NaN), at n in {5, 256, 1000} and with an inf,
a -inf and a NaN in one block.  The numpy references and the registry are
the JAX package's, byte for byte; the policy resolves as
``rabit_tpu.compress.resolve`` does, loud errors included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu import compress as jcompress
from rabit_tpu.compress import transport as jtransport
from rabit_tpu.config import Config as JConfig
from rabit_tpu.engine import fused as jfused
from rabit_tpu.engine.base import BITOR, MIN, SUM
from rabit_tpu_torch import compress as tcompress
from rabit_tpu_torch.compress import transport as ttransport
from rabit_tpu_torch.engine import fused as tfused
from rabit_tpu_torch.config import Config as TConfig

DEVICE_CODECS = ["identity", "bf16", "bf16x2", "i8", "i8x2"]


def _input(n: int, nonfinite: bool) -> np.ndarray:
    x = (np.random.RandomState(n).randn(n) * 10).astype(np.float32)
    if nonfinite:
        x[1], x[3], x[4] = np.inf, np.nan, -np.inf
    return x


@pytest.mark.parametrize("name", DEVICE_CODECS)
@pytest.mark.parametrize("n", [5, 256, 1000])
@pytest.mark.parametrize("nonfinite", [False, True])
def test_torch_codec_matches_jax_and_numpy(name, n, nonfinite):
    tc, jc = tcompress.get_codec(name), jcompress.get_codec(name)
    x = _input(n, nonfinite)
    enc = jc.encode(x)
    assert tc.encode(x) == enc and len(enc) == tc.wire_len(n) == jc.wire_len(n)
    got = tc.torch_encode(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and got.shape == (len(enc),)
    assert got.numpy().tobytes() == enc, f"{name}: torch encode differs from numpy at n={n}"
    je = np.asarray(jax.jit(jc.jax_encode)(jnp.asarray(x)))
    assert je.tobytes() == enc, f"{name}: jax encode differs from numpy at n={n}"
    packed = np.frombuffer(enc, np.uint8)
    dec = tc.torch_decode(torch.from_numpy(packed.copy()), n)
    assert dec.dtype == torch.float32 and dec.shape == (n,)
    want = jc.decode(enc, n)
    np.testing.assert_array_equal(dec.numpy(), want)
    jd = np.asarray(jax.jit(lambda p: jc.jax_decode(p, n))(jnp.asarray(packed)))
    np.testing.assert_array_equal(dec.numpy(), jd)
    np.testing.assert_array_equal(tc.decode(enc, n), want)


@pytest.mark.parametrize("name", DEVICE_CODECS)
def test_torch_decode_reads_unaligned_slices(name):
    """A chunk cut from a longer wire at any byte offset decodes as the
    bytes it holds (the fused ring decodes such slices)."""
    tc = tcompress.get_codec(name)
    x = _input(300, False)
    wire = torch.cat([torch.zeros(3, dtype=torch.uint8),
                      tc.torch_encode(torch.from_numpy(x))])
    np.testing.assert_array_equal(tc.torch_decode(wire[3:], 300).numpy(),
                                  tc.decode(tc.encode(x), 300))


def test_zlib_byte_codec_and_registry_match_jax():
    z = tcompress.get_codec("zlib")
    blob = b"the quick brown fox " * 512
    assert z.decode_bytes(z.encode_bytes(blob)) == blob
    assert z.encode_bytes(blob) == jcompress.get_codec("zlib").encode_bytes(blob)
    assert not z.has_torch and len(z.encode_bytes(blob)) < len(blob)
    assert {n: (c.codec_id, c.kind, c.lossless, c.error_bound)
            for n, c in tcompress.CODECS.items()} == \
        {n: (c.codec_id, c.kind, c.lossless, c.error_bound)
         for n, c in jcompress.CODECS.items()}
    for c in tcompress.CODECS.values():
        assert tcompress.get_codec_by_id(c.codec_id) is c
    with pytest.raises(ValueError, match="unknown codec"):
        tcompress.get_codec("snappy")
    with pytest.raises(ValueError, match="unknown codec id"):
        tcompress.get_codec_by_id(250)


@pytest.mark.parametrize("deflate", [False, True])
def test_wire_frames_match_jax(deflate):
    x = np.arange(300, dtype=np.float32)
    for name in ("i8x2", "bf16"):
        wire = ttransport.encode_wire(tcompress.get_codec(name), x, deflate=deflate)
        assert wire == jtransport.encode_wire(jcompress.get_codec(name), x, deflate=deflate)
        dec = ttransport.decode_wire(tcompress.get_codec(name), wire, x.size, rank=0)
        np.testing.assert_array_equal(dec, jtransport.decode_wire(
            jcompress.get_codec(name), wire, x.size, rank=0))
    wire = ttransport.encode_wire(tcompress.get_codec("i8x2"), x, deflate=deflate)
    with pytest.raises(tcompress.CodecMismatchError, match="disagree"):
        ttransport.decode_wire(tcompress.get_codec("bf16"), wire, x.size, rank=3)


def test_reference_allreduce_matches_jax():
    rng = np.random.RandomState(0)
    parts = [(rng.randn(700) * 50).astype(np.float32) for _ in range(3)]
    for name in ("bf16", "bf16x2", "i8", "i8x2"):
        for op in (SUM, MIN):
            got = tcompress.reference_allreduce(parts, op, name)
            assert got.tobytes() == jcompress.reference_allreduce(parts, op, name).tobytes()


POLICY_CASES = [
    (None, "float32", SUM, 4096),
    (None, "float32", SUM, 512),
    (None, "float64", SUM, 4096),
    (None, "float32", BITOR, 4096),
    ("bf16", "float32", MIN, 4),
    ("identity", "float32", SUM, 4096),
    ("i8", "float32", SUM, 4096),
    ("i8x2", "float64", SUM, 4096),
    ("i8x2", "float32", BITOR, 4096),
    ("zlib", "float32", SUM, 4096),
    ("lz4", "float32", SUM, 4096),
]


@pytest.mark.parametrize("codec,dtype,op,nbytes", POLICY_CASES)
def test_policy_resolves_as_jax(codec, dtype, op, nbytes):
    """Under rabit_compress_allreduce=i8x2 (floor 1024 B): the same codec,
    or the same exception type and message, as rabit_tpu.compress.resolve."""
    args = ["rabit_compress_allreduce=i8x2", "rabit_compress_min_bytes=1024"]
    tcompress.configure(TConfig(args))
    jcompress.configure(JConfig(args))
    try:
        outcomes = []
        for mod in (tcompress, jcompress):
            try:
                c = mod.resolve(codec, np.dtype(dtype), op, nbytes)
                outcomes.append(None if c is None else c.name)
            except (TypeError, ValueError) as e:
                outcomes.append((type(e), str(e)))
        assert outcomes[0] == outcomes[1]
    finally:
        tcompress.reset()
        jcompress.reset()


@pytest.mark.parametrize("args", [
    ["rabit_compress_allreduce=lz4"], ["rabit_compress_allreduce=zlib"],
    ["rabit_compress_broadcast=i8"], ["rabit_fused_allreduce=maybe"],
    ["rabit_compress_allreduce=bf16", "rabit_compress_min_bytes=4K",
     "rabit_compress_wire_deflate=0", "rabit_compress_broadcast=zlib",
     "rabit_fused_allreduce=off", "rabit_fused_chunk_kib=64"],
])
def test_configure_matches_jax(args):
    """The same policy and fused-ring settings, or the same loud refusal, as
    the JAX package's.  The port's Policy leaves out the fused ring's two
    keys, which its engine reads through ``engine.fused``'s parsers; the
    JAX package parses them into its Policy as well."""
    outcomes = []
    for mod, fused, cfg in ((tcompress, tfused, TConfig), (jcompress, jfused, JConfig)):
        try:
            p = mod.configure(cfg(args))
            outcomes.append(tuple(getattr(p, f) for f in tcompress.Policy._fields)
                            + (fused.fused_mode(cfg(args)),
                               fused.chunk_bytes_from_config(cfg(args))))
        except ValueError as e:
            outcomes.append(str(e))
        finally:
            mod.reset()
    assert outcomes[0] == outcomes[1]


def _higgs_shaped(n_rows, n_features, n_bins, seed=0):
    """tests/test_compress.py's Higgs-shaped synthetic."""
    rng = np.random.RandomState(seed)
    xb = rng.randint(0, n_bins, size=(n_rows, n_features), dtype=np.int32)
    logits = (xb[:, 0] > n_bins // 2).astype(np.float32) + 0.01 * xb[:, 1]
    y = (logits + rng.randn(n_rows) > 1.5).astype(np.float32)
    return xb.astype(np.float32), y


def test_gbdt_i8x2_matches_f32_within_bound():
    """tests/test_compress.py:325 on the port: its GBDT (on the CPU) with an
    i8x2 histogram allreduce through the port's api at world 1.  Every
    compressed histogram lies within the 2^-14 block-relative bound of the
    payload it encoded, the eval accuracy is the exact run's within 0.01,
    and the codec paid fewer wire bytes than it was given."""
    from rabit_tpu_torch import api
    from rabit_tpu_torch.compress.codecs import BLOCK
    from rabit_tpu_torch.models.gbdt import GBDT

    X, y = _higgs_shaped(20000, 12, 64)
    api.init([], rabit_compress_min_bytes=1)
    try:
        captured = []

        def hook_exact(hist):
            return api.allreduce(np.asarray(hist), api.SUM)

        def hook_i8x2(hist):
            a = np.asarray(hist)
            out = api.allreduce(a, api.SUM, codec="i8x2")
            captured.append((a, out))
            return out

        hyper = dict(n_trees=5, depth=4, n_bins=64, learning_rate=0.3)
        m_exact = GBDT(engine_allreduce=hook_exact, device="cpu", **hyper).fit(X, y)
        m_i8 = GBDT(engine_allreduce=hook_i8x2, device="cpu", **hyper).fit(X, y)
        assert captured
        for raw, out in captured:
            flat = raw.reshape(-1).astype(np.float32)
            pad = np.zeros(-(-flat.size // BLOCK) * BLOCK, np.float32)
            pad[:flat.size] = flat
            maxes = np.repeat(np.abs(pad.reshape(-1, BLOCK)).max(axis=1), BLOCK)[:flat.size]
            assert np.all(np.abs(np.asarray(out).reshape(-1) - flat) <= 2.0 ** -14 * maxes * 1.001)
        acc_exact = float(np.mean(m_exact.predict(X) == y))
        acc_i8 = float(np.mean(m_i8.predict(X) == y))
        assert abs(acc_exact - acc_i8) <= 0.01, (acc_exact, acc_i8)
        counters = api.collective_stats().registry.snapshot()["counters"]
        assert counters["compress_wire_bytes_total"] < counters["compress_raw_bytes_total"]
    finally:
        api.finalize()
