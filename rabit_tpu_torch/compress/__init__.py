"""The port's codec subsystem: one registry of wire codecs and the policy
that decides which collectives are compressed.

The port's own copy of ``rabit_tpu/compress/__init__.py``.  Every codec
has a deterministic, rank-symmetric encode, a documented decode(encode(x))
error bound, a pure-numpy reference and a PyTorch path that gives its bytes
on any device (``codecs``).  They reach the data plane through:

* ``api.allreduce(..., codec=...)``: a per-call codec, with a policy
  default (``rabit_compress_allreduce``) and a size floor
  (``rabit_compress_min_bytes``).  ``TorchEngine`` keeps the codec work
  on its device: the fused quantized ring (``engine.fused``) or, with
  ``rabit_fused_allreduce=0``, one all_gather of the encoded planes; every
  other engine gets the numpy transport (``transport``);
* ``api.broadcast``: a byte codec in a one-byte frame
  (``rabit_compress_broadcast``).

Policy resolution (:func:`resolve`): an explicit ``codec=`` argument is
validated loudly (a wrong dtype or a BITOR op raises); the config policy is
applied quietly only where it is sound (float32 payloads, non-BITOR ops, at
least ``rabit_compress_min_bytes`` bytes) and everything else stays exact,
so turning the knob on can never corrupt an exact path.  The ``checkpoint``
field is the byte codec of the durable store's frames (``store``, built by
``api.init`` when ``rabit_checkpoint_dir`` is set).  The fused ring's keys (``rabit_fused_allreduce``,
``rabit_fused_chunk_kib``) are not policy: ``TorchEngine``, the one engine
that reads them, resolves them with ``engine.fused``'s parsers, which read
``fused_setting``; ``api.init`` records its spelling as ``rabit_tpu`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from rabit_tpu_torch.compress.codecs import (  # noqa: F401 (re-exports)
    BLOCK,
    CODECS,
    DEFLATE_LEVEL,
    Codec,
    get_codec,
    get_codec_by_id,
)
from rabit_tpu_torch.compress.transport import (  # noqa: F401 (re-exports)
    CodecMismatchError,
    host_allreduce,
    observe,
    reference_allreduce,
)

#: codec names accepted as "no compression"
_OFF = ("", "identity", "off", "none", "0")


class Policy(NamedTuple):
    """Resolved ``rabit_compress_*`` configuration (one per init)."""

    allreduce: str = ""        # default codec for api.allreduce ("" = off)
    min_bytes: int = 1024      # policy floor: smaller payloads stay exact
    wire_deflate: bool = True  # lossless deflate stage on host wire bytes
    broadcast: str = ""        # byte codec for api.broadcast payloads
    checkpoint: str = "zlib"   # byte codec for durable store frames


_POLICY = Policy()


def policy() -> Policy:
    return _POLICY


def _numeric(name: str, what: str) -> str:
    if name in _OFF:
        return ""
    c = get_codec(name)  # raises on unknown names — a typo'd policy is loud
    if c.kind != "numeric":
        raise ValueError(f"{what}: codec {name!r} is a byte codec, not a "
                         f"numeric array codec")
    return name


def _bytes_codec(name: str, what: str) -> str:
    if name in _OFF:
        return ""
    c = get_codec(name)
    if c.kind != "bytes" and not c.lossless:
        raise ValueError(f"{what}: codec {name!r} is lossy — byte blobs "
                         f"(checkpoints, broadcasts) need lossless codecs")
    return name


#: rabit_fused_allreduce spellings, as rabit_tpu's policy accepts them
FUSED_MODES = ("auto", "1", "0", "on", "off", "true", "false", "yes", "no", "")


def fused_setting(config) -> str:
    """The normalised ``rabit_fused_allreduce`` spelling (``auto`` for an
    empty value), as ``rabit_tpu``'s policy records it; any other value is
    refused."""
    value = config.get("rabit_fused_allreduce", "auto") or "auto"
    mode = value.strip().lower()
    if mode not in FUSED_MODES:
        raise ValueError(
            f"rabit_fused_allreduce={value!r}: want auto, 1/on, or 0/off")
    return mode or "auto"


def configure(config) -> Policy:
    """Resolve the ``rabit_compress_*`` keys into the process policy
    (called by ``api.init``)."""
    global _POLICY
    _POLICY = Policy(
        allreduce=_numeric(
            config.get("rabit_compress_allreduce", "") or "",
            "rabit_compress_allreduce"),
        min_bytes=config.get_size("rabit_compress_min_bytes", 1024),
        wire_deflate=config.get_bool("rabit_compress_wire_deflate", True),
        broadcast=_bytes_codec(
            config.get("rabit_compress_broadcast", "") or "",
            "rabit_compress_broadcast"),
        checkpoint=_bytes_codec(
            config.get("rabit_checkpoint_compress", "zlib") or "",
            "rabit_checkpoint_compress"),
    )
    return _POLICY


def reset() -> None:
    """Back to built-in defaults (used by tests and finalize)."""
    global _POLICY
    _POLICY = Policy()


def resolve(codec, dtype, op: int, nbytes: int) -> Codec | None:
    """The one gate deciding whether a collective is compressed.

    ``codec`` is the per-call argument (str | Codec | None).  Explicit
    requests are validated loudly; the policy default applies quietly only
    to float32, non-BITOR payloads of at least ``min_bytes`` bytes.
    Returns the codec to use, or None for the exact path."""
    from rabit_tpu_torch.engine.base import BITOR

    if codec is not None:
        name = codec.name if isinstance(codec, Codec) else str(codec)
        if name in _OFF:
            return None
        c = get_codec(name)
        if c.kind != "numeric":
            raise ValueError(
                f"allreduce codec {name!r} is a byte codec; numeric "
                f"payloads take identity/bf16/bf16x2/i8/i8x2")
        if np.dtype(dtype) != np.float32:
            raise TypeError(
                f"codec {name!r} compresses float32 payloads only, got "
                f"{np.dtype(dtype)} — cast first or drop the codec")
        if op == BITOR and not c.lossless:
            raise ValueError(
                f"codec {name!r} is lossy; BITOR needs exact bits")
        return None if c.lossless else c
    p = _POLICY
    if not p.allreduce:
        return None
    if (np.dtype(dtype) != np.float32 or op == BITOR
            or nbytes < p.min_bytes):
        return None
    c = get_codec(p.allreduce)
    return None if c.lossless else c
