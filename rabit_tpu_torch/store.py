"""Durable checkpoint spill: surviving the loss of the whole job.

The port's own copy of ``rabit_tpu/store.py``.  With
``rabit_checkpoint_dir`` set, every committed checkpoint is also written
to disk (atomic rename + directory fsync, the newest two versions kept),
and a fresh job (engine version 0) agrees on the newest version every rank
can serve and resumes from it (``api._disk_resume``), a rank whose copy is
missing or corrupt being served the global blob by a broadcast.

File format, one file per (kind, rank, version) in the directory:
``global_r{rank}_v{version}.bin`` holds the global blob,
``local_r{rank}_v{version}.bin`` the rank-local one.  Each is a header and
a payload, all integers little-endian:

* ``RTC1``: magic, crc32 of the payload (u32), payload length (u32); the
  payload is the blob.  Written when the store is configured uncompressed.
* ``RTC2``: magic, codec id (u8, ``compress`` ids: 1 is zlib), three pad
  bytes, crc32 of the encoded payload (u32), its length (u32); the payload
  is the encoded blob.  Written by a compressing store (the default,
  ``rabit_checkpoint_compress=zlib``).
* ``RTC3``: RTC2 plus the world epoch (u32) of the committing membership
  generation (``api.world_epoch``), written for a nonzero epoch (codec id 0,
  identity, when the store is uncompressed); ``epoch_of`` reads it back.
  Epoch 0 keeps writing RTC1 or RTC2.

The crc covers the bytes on disk, so integrity is checked before any
decode touches them.  A file that fails the check (torn by a crash the
rename could not cover, or bit-rotted) reads as absent, so a resume falls
back to an older version or to the holder's broadcast.  The bytes are
those ``rabit_tpu/store.py`` writes for the same blobs, and each package
reads the other's files.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from pathlib import Path

from rabit_tpu_torch.compress import get_codec, get_codec_by_id, observe

_GLOBAL_RE = re.compile(r"^global_r(\d+)_v(\d+)\.bin$")
_KEEP = 2  # the commit barrier skews live ranks by at most one version
_MAGIC = b"RTC1"
_HDR = struct.Struct("<4sII")
_MAGIC2 = b"RTC2"
_HDR2 = struct.Struct("<4sBxxxII")  # magic, codec id, pad, crc, enc len
_MAGIC3 = b"RTC3"
_HDR3 = struct.Struct("<4sBxxxIII")  # ..., crc, enc len, world epoch


class CheckpointStore:
    """One rank's spilled checkpoints in ``directory``.  ``codec`` is the
    byte codec of its frames ("" or "identity": uncompressed RTC1);
    ``keep`` how many unpinned versions survive a commit.  Compression
    events go to
    ``engine``'s ``obs_event`` hook when one is given."""

    def __init__(self, directory: str, rank: int, codec: str = "zlib",
                 keep: int = _KEEP, engine=None):
        self.dir = Path(directory)
        self.rank = rank
        self._codec = None if codec in ("", "identity") else get_codec(codec)
        self._keep = max(int(keep), 1)
        self._engine = engine
        # Pinned versions survive pruning regardless of age.
        self._pinned: set[int] = set()
        self.dir.mkdir(parents=True, exist_ok=True)
        # One directory scan at startup seeds the version list (and sweeps
        # tmp leftovers of crashed saves); after that save() maintains it
        # in memory, so a commit never lists the shared directory.
        self._versions: list[int] = []
        self._cache: dict[Path, bytes] = {}  # verified payloads by path
        for p in self.dir.iterdir():
            if p.suffix == ".tmp" and f"_r{rank}_" in p.name:
                p.unlink(missing_ok=True)
            m = _GLOBAL_RE.match(p.name)
            if m and int(m.group(1)) == rank:
                self._versions.append(int(m.group(2)))
        self._versions.sort()

    # -- paths --------------------------------------------------------------

    def _gpath(self, version: int) -> Path:
        return self.dir / f"global_r{self.rank}_v{version}.bin"

    def _lpath(self, version: int) -> Path:
        return self.dir / f"local_r{self.rank}_v{version}.bin"

    # -- writes -------------------------------------------------------------

    def save(self, version: int, gblob: bytes, lblob: bytes | None,
             epoch: int = 0) -> None:
        """Persist one committed checkpoint atomically; prune old versions.
        A nonzero ``epoch`` is recorded in the frames (RTC3)."""
        self._write(self._gpath(version), gblob, epoch)
        if lblob is not None:
            self._write(self._lpath(version), lblob, epoch)
        if version not in self._versions:
            self._versions.append(version)
            self._versions.sort()
        self._prune()

    def pin(self, version: int) -> None:
        """Exempt ``version`` from pruning (and release every older pin)."""
        self._pinned = {v for v in self._pinned if v > version}
        self._pinned.add(version)
        self._prune()

    def _prune(self) -> None:
        unpinned = [v for v in self._versions if v not in self._pinned]
        while len(unpinned) > self._keep:
            v = unpinned.pop(0)
            self._versions.remove(v)
            for p in (self._gpath(v), self._lpath(v)):
                p.unlink(missing_ok=True)
                self._cache.pop(p, None)

    def _encode(self, blob: bytes) -> bytes:
        payload = self._codec.encode_bytes(blob)
        if self._engine is not None:
            observe(self._engine, self._codec.name, raw=len(blob), wire=len(payload))
        return payload

    def _write(self, path: Path, blob: bytes, epoch: int = 0) -> None:
        if epoch > 0:
            codec_id, payload = 0, blob
            if self._codec is not None:
                codec_id, payload = self._codec.codec_id, self._encode(blob)
            header = _HDR3.pack(_MAGIC3, codec_id, zlib.crc32(payload), len(payload),
                                epoch)
        elif self._codec is None:
            header, payload = _HDR.pack(_MAGIC, zlib.crc32(blob), len(blob)), blob
        else:
            payload = self._encode(blob)
            header = _HDR2.pack(_MAGIC2, self._codec.codec_id,
                                zlib.crc32(payload), len(payload))
        tmp = path.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic: readers see old or new, never torn
        self._cache[path] = blob
        # The rename itself must survive a host crash too: fsync the
        # directory entry, or the newest version can vanish on power loss
        # while the prune of the older one persisted.
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    # -- reads --------------------------------------------------------------

    def versions(self) -> list[int]:
        """This rank's persisted versions, ascending."""
        return list(self._versions)

    def latest_valid(self) -> int:
        """Newest version whose global blob passes the integrity check: what
        this rank may truthfully advertise to the resume consensus."""
        for v in reversed(self._versions):
            if self.has(v):
                return v
        return 0

    @staticmethod
    def _decode(codec_id: int, enc: bytes) -> bytes | None:
        try:
            return get_codec_by_id(codec_id).decode_bytes(enc)
        except (ValueError, NotImplementedError, zlib.error):
            # an unknown or non-byte codec id, or a stream the crc cannot
            # vouch for
            return None

    def _read_checked(self, path: Path) -> bytes | None:
        """The decoded payload, or None when missing, torn or corrupt.
        Verified reads are memoized; writes and prunes keep the memo
        fresh."""
        if path in self._cache:
            return self._cache[path]
        try:
            raw = path.read_bytes()
        except FileNotFoundError:
            return None
        blob: bytes | None = None
        if len(raw) >= _HDR3.size and raw[:4] == _MAGIC3:
            _magic, codec_id, crc, n, _epoch = _HDR3.unpack_from(raw)
            enc = raw[_HDR3.size:]
            if len(enc) == n and zlib.crc32(enc) == crc:
                blob = self._decode(codec_id, enc)
        elif len(raw) >= _HDR2.size and raw[:4] == _MAGIC2:
            _magic, codec_id, crc, n = _HDR2.unpack_from(raw)
            enc = raw[_HDR2.size:]
            if len(enc) == n and zlib.crc32(enc) == crc:
                blob = self._decode(codec_id, enc)
        elif len(raw) >= _HDR.size and raw[:4] == _MAGIC:
            _magic, crc, n = _HDR.unpack_from(raw)
            payload = raw[_HDR.size:]
            if len(payload) == n and zlib.crc32(payload) == crc:
                blob = payload
        if blob is None:
            print(f"[rabit_tpu_torch] checkpoint store: ignoring unreadable blob "
                  f"{path} (missing/invalid RTC1/RTC2/RTC3 header or crc "
                  f"mismatch)", flush=True)
            return None
        self._cache[path] = blob
        return blob

    def epoch_of(self, version: int) -> int:
        """World epoch recorded in the version's global frame (RTC3); 0 for
        RTC1/RTC2 frames and missing or torn files."""
        try:
            with open(self._gpath(version), "rb") as f:
                head = f.read(_HDR3.size)
        except OSError:
            return 0
        if len(head) >= _HDR3.size and head[:4] == _MAGIC3:
            return _HDR3.unpack_from(head)[4]
        return 0

    def has(self, version: int) -> bool:
        """True only for a version whose global blob passes the integrity
        check: the resume consensus must not promise bytes it cannot
        serve."""
        return version > 0 and self._read_checked(self._gpath(version)) is not None

    def load_global(self, version: int) -> bytes:
        blob = self._read_checked(self._gpath(version))
        if blob is None:
            raise RuntimeError(
                f"checkpoint store: global v{version} for rank {self.rank} "
                f"is missing or corrupt ({self._gpath(version)})"
            )
        return blob

    def load_local(self, version: int) -> bytes | None:
        return self._read_checked(self._lpath(version))
