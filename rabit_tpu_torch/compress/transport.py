"""Host-side compressed-allreduce transport.

The port's own copy of ``rabit_tpu/compress/transport.py``: the pure-numpy
path every engine gets for free (``TorchEngine`` takes the fused ring of
``engine.fused`` in its place when ``rabit_fused_allreduce`` is on and the
world has more than one rank):

1. the local contribution -> ``codec.encode`` -> optional deflate stage ->
   an 8-byte frame header (codec id + flags + payload length);
2. ONE engine allgather of the framed wire bytes (plus, only when the
   deflate stage makes sizes rank-dependent, one tiny int64 MAX allreduce
   agreeing on the padded slice size first);
3. every rank decodes all ranks' planes and folds them in rank order with
   the exact same numpy ops, so the result is **bitwise identical on every
   rank**, and :func:`reference_allreduce` reproduces it in closed form.

A cross-rank codec mismatch is caught by the frame header
(``CodecMismatchError`` naming the ranks).  The compression metrics go to
the process metrics registry (``obs``) and, as a ``compress`` event, to
the engine's ``obs_event`` hook.
"""

from __future__ import annotations

import struct
import time
import zlib

import numpy as np

from rabit_tpu_torch.compress.codecs import DEFLATE_LEVEL, Codec, get_codec
from rabit_tpu_torch.engine.base import MAX, numpy_reduce
from rabit_tpu_torch.obs import stream as obs_stream
from rabit_tpu_torch.obs.metrics import GLOBAL_REGISTRY

#: Wire frame prepended to every rank's allgather slice:
#: codec id, flags, reserved, encoded payload length.
FRAME = struct.Struct("<BBxxI")

FLAG_DEFLATE = 0x01


class CodecMismatchError(RuntimeError):
    """Peers disagree on the collective's codec: config skew, not data."""


def observe(engine, codec_name: str, raw: int, wire: int,
            encode_s: float | None = None, decode_s: float | None = None,
            fused: bool = False) -> None:
    """Record one compression event: raw and wire byte counters, the
    labeled ``wire_bytes``/``raw_bytes`` series (``fused=1`` where the fused
    device ring moved the bytes) and the per-codec ratio and latency
    histograms into the process registry, as ``rabit_tpu``'s ``observe``
    does; and a ``compress`` event to the engine's ``obs_event`` hook."""
    reg = GLOBAL_REGISTRY
    reg.counter("compress_raw_bytes_total").inc(int(raw))
    reg.counter("compress_wire_bytes_total").inc(int(wire))
    obs_stream.stream_count("wire_bytes", wire, codec=codec_name, fused=int(bool(fused)))
    obs_stream.stream_count("raw_bytes", raw, codec=codec_name, fused=int(bool(fused)))
    if wire > 0:
        reg.histogram(f"compress_ratio_{codec_name}").observe(raw / wire)
    if encode_s is not None:
        reg.histogram(f"compress_encode_seconds_{codec_name}").observe(encode_s)
    if decode_s is not None:
        reg.histogram(f"compress_decode_seconds_{codec_name}").observe(decode_s)
    engine.obs_event("compress", codec=codec_name, raw=int(raw), wire=int(wire),
                     encode_s=encode_s, decode_s=decode_s, fused=bool(fused))


def encode_wire(codec: Codec, buf: np.ndarray, deflate: bool) -> bytes:
    """Frame one rank's contribution: header + encoded planes, with the
    lossless deflate stage applied when requested."""
    enc = codec.encode(buf)
    flags = 0
    if deflate:
        enc = zlib.compress(enc, DEFLATE_LEVEL)
        flags |= FLAG_DEFLATE
    return FRAME.pack(codec.codec_id, flags, len(enc)) + enc


def decode_wire(codec: Codec, slice_bytes: bytes, n: int,
                rank: int) -> np.ndarray:
    """Inverse of :func:`encode_wire` for one rank's (possibly padded)
    allgather slice; validates the frame's codec id."""
    codec_id, flags, enc_len = FRAME.unpack_from(slice_bytes)
    if codec_id != codec.codec_id:
        raise CodecMismatchError(
            f"compressed allreduce: rank {rank} sent codec id {codec_id}, "
            f"this rank expects {codec.codec_id} ({codec.name!r}) — ranks "
            f"disagree on rabit_compress_allreduce / the codec= argument"
        )
    enc = slice_bytes[FRAME.size:FRAME.size + enc_len]
    if flags & FLAG_DEFLATE:
        enc = zlib.decompress(enc)
    return codec.decode(enc, n)


def _fold(op: int, acc: np.ndarray | None, part: np.ndarray) -> np.ndarray:
    if acc is None:
        return np.array(part, copy=True)
    return numpy_reduce(op, acc, part)


def host_allreduce(engine, buf: np.ndarray, op: int, codec: Codec,
                   cache_key: str | None = None,
                   deflate: bool = True) -> np.ndarray:
    """The default (numpy) compressed allreduce over any engine's
    primitives; see the module docstring for the wire shape."""
    n = buf.size
    t0 = time.perf_counter()
    payload = encode_wire(codec, buf, deflate)
    enc_s = time.perf_counter() - t0
    world = engine.get_world_size()
    key = lambda suffix: None if cache_key is None else cache_key + suffix
    if deflate and world > 1:
        # Deflate makes wire sizes data-dependent; agree on the padded
        # slice size first (same fixed two-op sequence on every rank).
        nmax = int(engine.allreduce(
            np.array([len(payload)], np.int64), MAX,
            cache_key=key("#wiresz"))[0])
    else:
        nmax = len(payload)
    wire = np.zeros(nmax, np.uint8)
    wire[:len(payload)] = np.frombuffer(payload, np.uint8)
    gathered = np.asarray(engine.allgather(wire, cache_key=key("#wire")))
    parts = gathered.reshape(world, nmax)
    t1 = time.perf_counter()
    out: np.ndarray | None = None
    for r in range(world):
        out = _fold(op, out, decode_wire(codec, parts[r].tobytes(), n, r))
    observe(engine, codec.name, raw=buf.nbytes, wire=len(payload), encode_s=enc_s,
            decode_s=time.perf_counter() - t1)
    return out.astype(buf.dtype, copy=False)


def reference_allreduce(contribs: list[np.ndarray], op: int,
                        codec: str | Codec) -> np.ndarray:
    """Closed-form mirror of :func:`host_allreduce`: fold every rank's
    lossy round trip in rank order with the same numpy ops.  A compressed
    collective, host or fused, must match it **bitwise**."""
    c = codec if isinstance(codec, Codec) else get_codec(codec)
    out: np.ndarray | None = None
    for contrib in contribs:
        flat = np.ascontiguousarray(contrib, np.float32).reshape(-1)
        out = _fold(op, out, c.decode(c.encode(flat), flat.size))
    return out.reshape(np.shape(contribs[0]))
