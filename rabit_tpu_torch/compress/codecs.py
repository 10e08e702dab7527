"""Wire codecs: the numeric plane codecs and the byte-blob codec.

The port's own copy of ``rabit_tpu/compress/codecs.py`` (the port imports
nothing of the JAX package): the pure-numpy reference (``encode`` /
``decode``, the registry, the wire ids) as it is there, and in place of its
in-graph JAX path a PyTorch one, ``torch_encode`` / ``torch_decode``, which
runs on the tensor's device (the card for the fused ring of
``engine.fused`` and the quantized collectives).

Every numeric codec obeys one contract:

* ``encode`` is **deterministic** (same bytes for the same input, every
  time, on every rank) and **rank-symmetric**;
* ``decode(encode(x))`` error is **bounded and documented** per codec (the
  ``error_bound`` field);
* ``torch_encode`` gives the bytes ``encode`` gives, bit for bit, on any
  device, and ``torch_decode`` the values ``decode`` gives.  The torch
  path mirrors the numpy ops one for one: ``x * (1/scale)``, never
  ``x / scale``; ``torch.round`` (half to even, as ``np.round``); a clip
  before every int8 cast; the bf16 rounding done on the f32 bits with
  integer ops, as numpy does it (``Tensor.to(torch.bfloat16)`` writes
  other bits for a NaN); bit casts as ``Tensor.view`` of the bytes.

Plane layouts (the byte strings ``encode`` returns, before the host
transport's optional deflate stage):

* ``identity`` -- the raw f32 bytes.
* ``bf16``     -- one uint16 plane: the top 16 bits of each f32, rounded to
  nearest-even (error ~2^-8 relative per element).
* ``bf16x2``   -- two uint16 planes hi/lo with ``lo = x - f32(hi)`` (the
  hi/lo split of the bf16 histogram encoding; error ~2^-16 relative).
* ``i8``       -- one int8 plane + one f32 scale per 256-element block:
  ``a = round(clip(x) * 127)`` against the block max (error ~2^-8 of the
  block max; ~3.9x fewer bytes than f32).
* ``i8x2``     -- two int8 planes + f32 block scales, the exact fixed-point
  split of the i8 histogram encoding: ``a = round(x*64)``,
  ``b = round((x - a/64) * 8192)`` (error ~2^-14 of the block max).

Two-plane codecs concatenate their planes into ONE byte string (plane 0,
plane 1, scales).  Non-finite inputs of the int8 codecs are saturated
deterministically before quantization (``nan -> 0``, ``+-inf -> +-block
max``).  The bf16 codecs carry them: a NaN's bits are those numpy gives on
an x86 host (a NaN operand is quieted, ``inf - inf`` is ``0xFFC00000``),
which the torch path writes on every device.
"""

from __future__ import annotations

import importlib
import zlib

import numpy as np


class _Torch:
    """``torch``, imported at its first use: the numpy codecs, and the api
    and the native engine over them, load no torch."""

    def __getattr__(self, name):
        return getattr(importlib.import_module("torch"), name)


torch = _Torch()

#: Elements per scale block of the block-scaled int8 codecs.
BLOCK = 256

#: Smallest normal f32: the all-zero-block guard (1/tiny stays finite,
#: tiny-but-nonzero blocks survive).
_TINY = np.float32(1.1754944e-38)

#: Pinned deflate level for every zlib use in this package: the level is
#: part of the determinism contract (all ranks must produce identical
#: bytes for identical input).
DEFLATE_LEVEL = 1

# f32 constants of the decodes, as Python floats that hold the f32 values
_INV127 = float(np.float32(1.0 / 127.0))
_INV64 = float(np.float32(1.0 / 64.0))
_INV8192 = float(np.float32(1.0 / 8192.0))
_QUIET = 0x00400000        # the quiet bit of an f32 NaN
_INF_MINUS_INF = -0x400000  # 0xFFC00000, x86's default NaN, as int32


def _blocks(n: int) -> int:
    return -(-n // BLOCK)


def _pad_blocks_np(v: np.ndarray) -> np.ndarray:
    """[n] f32 -> [nblocks, BLOCK] f32, zero padded."""
    n = v.size
    npad = _blocks(n) * BLOCK
    if npad != n:
        out = np.zeros(npad, np.float32)
        out[:n] = v
        v = out
    return v.reshape(-1, BLOCK)


def _block_scale_np(vb: np.ndarray) -> np.ndarray:
    amax = np.max(np.abs(np.where(np.isfinite(vb), vb, 0.0)), axis=1,
                  keepdims=True).astype(np.float32)
    return np.maximum(amax, _TINY)


def _saturate_np(x: np.ndarray) -> np.ndarray:
    return np.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0).astype(np.float32)


def _f32_to_bf16_np(arr: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even truncation to the top 16 bits (numpy has no
    bfloat16; the plane is carried as uint16)."""
    u = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    bias = np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))
    return ((u + bias) >> np.uint32(16)).astype(np.uint16)


def _bf16_to_f32_np(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


# -- torch mirrors of the numpy helpers -----------------------------------------


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _view(packed: torch.Tensor, offset: int, count: int,
          dtype: torch.dtype) -> torch.Tensor:
    """``count`` elements of ``dtype`` at byte ``offset`` of a uint8 tensor
    (a copy where the offset is not aligned to the element)."""
    size = torch.empty((), dtype=dtype).element_size()
    seg = packed.reshape(-1)[offset:offset + count * size]
    if seg.storage_offset() % size:
        seg = seg.clone()
    return seg.view(dtype)


def _pad_blocks_torch(v: torch.Tensor) -> torch.Tensor:
    n = v.numel()
    npad = _blocks(n) * BLOCK
    if npad != n:
        v = torch.nn.functional.pad(v, (0, npad - n))
    return v.reshape(-1, BLOCK)


def _f32_to_bf16_torch(x: torch.Tensor) -> torch.Tensor:
    """``_f32_to_bf16_np`` on the f32 bits: int16 tensor of the uint16
    plane.  The sum runs in int64, so the wrap of numpy's uint32 sum is
    the mask of the shifted value."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF
    return (r - ((r >> 15) << 16)).to(torch.int16)


def _bf16_to_f32_torch(bits: torch.Tensor) -> torch.Tensor:
    """int16 bf16 plane -> f32: the bits become the high half of each
    f32 (a little-endian reinterpretation, no arithmetic)."""
    pair = torch.stack((torch.zeros_like(bits), bits), dim=-1)
    return pair.view(torch.float32).reshape(bits.shape)


def _x86_nan_bits(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """``d = x - hi`` with the NaN bits numpy computes on an x86 host: a
    NaN ``x`` comes out quieted, an infinite ``x`` (``inf - inf``) as
    ``0xFFC00000``.  Every finite ``x`` keeps ``d``."""
    xb = x.contiguous().view(torch.int32)
    bits = torch.where(torch.isnan(x), xb | _QUIET,
                       torch.where(torch.isinf(x), _INF_MINUS_INF,
                                   d.contiguous().view(torch.int32)))
    return bits.view(torch.float32)


class Codec:
    """Base class; also the registry row (name, wire id, error bound)."""

    #: registry name
    name: str = ""
    #: stable 1-byte wire/frame id (transport headers, broadcast frames)
    codec_id: int = -1
    #: "numeric" (f32 arrays) or "bytes" (opaque blobs)
    kind: str = "numeric"
    #: True when decode(encode(x)) == x exactly
    lossless: bool = False
    #: documented decode(encode(x)) error bound
    error_bound: str = ""
    #: True when encode output length depends only on the input length
    fixed_size: bool = True

    # -- numeric path (f32 arrays) -----------------------------------------

    def encode(self, arr: np.ndarray) -> bytes:
        raise NotImplementedError

    def decode(self, blob: bytes, n: int) -> np.ndarray:
        raise NotImplementedError

    def roundtrip(self, arr: np.ndarray) -> np.ndarray:
        """decode(encode(arr)), reshaped like ``arr``."""
        flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
        return self.decode(self.encode(flat), flat.size).reshape(arr.shape)

    def wire_len(self, n: int) -> int:
        """Encoded byte count for an n-element f32 input (fixed-size
        codecs only)."""
        raise NotImplementedError

    # -- device path (False => host-only codec) ----------------------------

    #: set False on codecs without a torch path
    has_torch: bool = True

    def torch_encode(self, x: torch.Tensor) -> torch.Tensor:
        """f32 [n] tensor -> uint8 [wire_len(n)] tensor on its device, the
        bytes of ``encode``."""
        raise NotImplementedError

    def torch_decode(self, packed: torch.Tensor, n: int) -> torch.Tensor:
        """uint8 [wire_len(n)] tensor -> f32 [n] on its device, the values
        of ``decode``."""
        raise NotImplementedError

    # -- byte path (blobs) -------------------------------------------------

    def encode_bytes(self, blob: bytes) -> bytes:
        raise NotImplementedError(f"codec {self.name!r} is not a byte codec")

    def decode_bytes(self, blob: bytes) -> bytes:
        raise NotImplementedError(f"codec {self.name!r} is not a byte codec")


class IdentityCodec(Codec):
    name = "identity"
    codec_id = 0
    lossless = True
    error_bound = "exact"

    def encode(self, arr):
        return np.ascontiguousarray(arr, np.float32).tobytes()

    def decode(self, blob, n):
        return np.frombuffer(blob, np.float32, count=n).copy()

    def wire_len(self, n):
        return 4 * n

    def torch_encode(self, x):
        return _as_bytes(x.to(torch.float32))

    def torch_decode(self, packed, n):
        return _view(packed, 0, n, torch.float32)

    def encode_bytes(self, blob):
        return bytes(blob)

    def decode_bytes(self, blob):
        return bytes(blob)


class ZlibCodec(Codec):
    """Lossless byte-blob codec (broadcast payloads).  Deterministic at the
    pinned :data:`DEFLATE_LEVEL`."""

    name = "zlib"
    codec_id = 1
    kind = "bytes"
    lossless = True
    error_bound = "exact"
    fixed_size = False
    has_torch = False

    def encode_bytes(self, blob):
        return zlib.compress(bytes(blob), DEFLATE_LEVEL)

    def decode_bytes(self, blob):
        return zlib.decompress(bytes(blob))


class Bf16Codec(Codec):
    name = "bf16"
    codec_id = 2
    error_bound = "~2^-8 relative per element"

    def encode(self, arr):
        return _f32_to_bf16_np(np.ascontiguousarray(arr, np.float32)).tobytes()

    def decode(self, blob, n):
        return _bf16_to_f32_np(np.frombuffer(blob, np.uint16, count=n))

    def wire_len(self, n):
        return 2 * n

    def torch_encode(self, x):
        return _as_bytes(_f32_to_bf16_torch(x.to(torch.float32)))

    def torch_decode(self, packed, n):
        return _bf16_to_f32_torch(_view(packed, 0, n, torch.int16))


class Bf16x2Codec(Codec):
    """Hi/lo two-plane bf16: same byte count as f32, near-exact; the
    deflate stage recovers real bytes from the low-entropy hi plane."""

    name = "bf16x2"
    codec_id = 3
    error_bound = "~2^-16 relative per element"

    def encode(self, arr):
        x = np.ascontiguousarray(arr, np.float32)
        hi = _f32_to_bf16_np(x)
        with np.errstate(invalid="ignore"):  # inf - inf: nan rides the lo plane
            lo = _f32_to_bf16_np(x - _bf16_to_f32_np(hi))
        return hi.tobytes() + lo.tobytes()

    def decode(self, blob, n):
        hi = np.frombuffer(blob, np.uint16, count=n)
        lo = np.frombuffer(blob, np.uint16, count=n, offset=2 * n)
        return _bf16_to_f32_np(hi) + _bf16_to_f32_np(lo)

    def wire_len(self, n):
        return 4 * n

    def torch_encode(self, x):
        x = x.to(torch.float32).contiguous()
        hi = _f32_to_bf16_torch(x)
        lo = _f32_to_bf16_torch(_x86_nan_bits(x, x - _bf16_to_f32_torch(hi)))
        return torch.cat((_as_bytes(hi), _as_bytes(lo)))

    def torch_decode(self, packed, n):
        hi = _bf16_to_f32_torch(_view(packed, 0, n, torch.int16))
        lo = _bf16_to_f32_torch(_view(packed, 2 * n, n, torch.int16))
        return hi + lo


class _BlockI8(Codec):
    """Shared machinery of the block-scaled int8 codecs: planes are laid
    out plane-major (plane 0 bytes, [plane 1 bytes,] f32 scales)."""

    planes: int = 1

    def wire_len(self, n):
        nb = _blocks(n)
        return self.planes * nb * BLOCK + 4 * nb

    def _encode_planes_np(self, x: np.ndarray) -> list[np.ndarray]:
        raise NotImplementedError

    def _decode_planes_np(self, planes: list[np.ndarray],
                          scale: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def encode(self, arr):
        vb = _pad_blocks_np(np.ascontiguousarray(arr, np.float32).reshape(-1))
        scale = _block_scale_np(vb)
        x = _saturate_np(vb * (np.float32(1.0) / scale))
        planes = self._encode_planes_np(x)
        return (b"".join(p.astype(np.int8).tobytes() for p in planes)
                + scale.astype(np.float32).tobytes())

    def decode(self, blob, n):
        nb = _blocks(n)
        npad = nb * BLOCK
        planes = [
            np.frombuffer(blob, np.int8, count=npad, offset=i * npad)
            .reshape(nb, BLOCK).astype(np.float32)
            for i in range(self.planes)
        ]
        scale = np.frombuffer(blob, np.float32, count=nb,
                              offset=self.planes * npad).reshape(nb, 1)
        return self._decode_planes_np(planes, scale).reshape(-1)[:n]

    # torch mirrors of the numpy ops

    def _encode_planes_torch(self, x: torch.Tensor) -> list[torch.Tensor]:
        raise NotImplementedError

    def _decode_planes_torch(self, planes: list[torch.Tensor],
                             scale: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def torch_encode(self, x):
        vb = _pad_blocks_torch(x.to(torch.float32).reshape(-1))
        amax = torch.where(torch.isfinite(vb), vb, 0.0).abs().amax(1, keepdim=True)
        scale = torch.clamp_min(amax, float(_TINY))
        xs = torch.nan_to_num(vb * scale.reciprocal(), nan=0.0, posinf=1.0,
                              neginf=-1.0)
        parts = [_as_bytes(p.clamp(-127, 127).to(torch.int8))
                 for p in self._encode_planes_torch(xs)]
        parts.append(_as_bytes(scale))
        return torch.cat(parts)

    def torch_decode(self, packed, n):
        nb = _blocks(n)
        npad = nb * BLOCK
        planes = [_view(packed, i * npad, npad, torch.int8).reshape(nb, BLOCK)
                  .to(torch.float32) for i in range(self.planes)]
        scale = _view(packed, self.planes * npad, nb, torch.float32).reshape(nb, 1)
        return self._decode_planes_torch(planes, scale).reshape(-1)[:n]


class I8Codec(_BlockI8):
    name = "i8"
    codec_id = 4
    planes = 1
    error_bound = "~2^-8 of the block max (256-element blocks)"

    def _encode_planes_np(self, x):
        return [np.clip(np.round(x * np.float32(127.0)), -127, 127)]

    def _decode_planes_np(self, planes, scale):
        return planes[0] * (scale * np.float32(1.0 / 127.0))

    def _encode_planes_torch(self, x):
        return [torch.round(x * 127.0).clamp(-127, 127)]

    def _decode_planes_torch(self, planes, scale):
        return planes[0] * (scale * _INV127)


class I8x2Codec(_BlockI8):
    """The exact two-plane fixed-point split: ``a = round(x*64)``
    (|a| <= 64), residual plane ``b = round((x - a/64) * 8192)``
    (|b| <= 65): 14-bit fixed point, error ~2^-14 of the block max."""

    name = "i8x2"
    codec_id = 5
    planes = 2
    error_bound = "~2^-14 of the block max (256-element blocks)"

    def _encode_planes_np(self, x):
        a = np.round(x * np.float32(64.0))
        b = np.round((x - a * np.float32(1.0 / 64.0)) * np.float32(8192.0))
        return [a, b]

    def _decode_planes_np(self, planes, scale):
        hi, lo = planes
        return (hi * np.float32(1.0 / 64.0)
                + lo * np.float32(1.0 / 8192.0)) * scale

    def _encode_planes_torch(self, x):
        a = torch.round(x * 64.0)
        b = torch.round((x - a * _INV64) * 8192.0)
        return [a, b]

    def _decode_planes_torch(self, planes, scale):
        hi, lo = planes
        return (hi * _INV64 + lo * _INV8192) * scale


#: The registry: name -> singleton codec instance.
CODECS: dict[str, Codec] = {
    c.name: c
    for c in (IdentityCodec(), ZlibCodec(), Bf16Codec(), Bf16x2Codec(),
              I8Codec(), I8x2Codec())
}

_BY_ID: dict[int, Codec] = {c.codec_id: c for c in CODECS.values()}


def get_codec(name: str) -> Codec:
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {sorted(CODECS)}"
        ) from None


def get_codec_by_id(codec_id: int) -> Codec:
    try:
        return _BY_ID[codec_id]
    except KeyError:
        raise ValueError(
            f"unknown codec id {codec_id}; registered: "
            f"{sorted((c.codec_id, c.name) for c in CODECS.values())}"
        ) from None
