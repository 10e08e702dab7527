"""The model-delivery plane: the checkpoint line as a content-addressed
snapshot store that readers fetch from.

The port's own copy of ``rabit_tpu/delivery``.

* :class:`Publisher`, the writer's side, rides the checkpoint commit
  (``api.checkpoint`` with ``rabit_delivery_publish=1``): each commit
  registers ``(version, epoch, digest, size)`` with the tracker
  (``CMD_SUB`` publish, journaled as ``snapshot_published``, so a standby
  restores the version line) and uploads the bytes (``CMD_BLOB``) only
  when the reply says the tracker does not hold that digest yet: N
  publishers of identical bytes ship them once.
* :class:`Subscriber`, the reader: polls the version line (``CMD_SUB``,
  answered by a relay from the line its batch ACKs carry), fetches the
  snapshot in chunks (``CMD_SNAP``, served from the relay's digest-keyed
  cache after the first fetch), checks the content digest end to end, and
  rotates through the failover list across a tracker failover.  A missed
  version is no error: the subscriber converges on the newest line, and an
  empty snap frame (bytes not landed yet, or not re-pushed yet after a
  failover) is a race it retries past.

The wire is the tracker's own, so a subscriber points at a relay as a
worker does.
"""

from __future__ import annotations

import hashlib
import json
import socket
import time

from rabit_tpu_torch.config import Config
from rabit_tpu_torch.tracker import protocol as P

#: The fetch window: large enough to amortize the RPC, small enough that a
#: slow subscriber never pins a relay's reply buffer.
CHUNK_BYTES = 1 << 20

_EMPTY_LINE = {"version": 0, "epoch": 0, "digest": "", "size": 0}


def digest_of(blob: bytes) -> str:
    """A snapshot's content address: the sha256 hex of its bytes.  The
    tracker computes it again from an upload, so nobody can register bytes
    under a digest that does not match them."""
    return hashlib.sha256(blob).hexdigest()


def _candidates(host: str, port: int, addrs: list[tuple[str, int]]) -> list[tuple[str, int]]:
    cands = [(host, port)]
    for a in addrs:
        if a not in cands:
            cands.append(a)
    return cands


class Publisher:
    """The write side: ``publish`` registers the line first and uploads the
    bytes only on a digest miss.  Between the two the line is ahead of the
    bytes, which subscribers read as an empty, retryable fetch."""

    def __init__(self, host: str, port: int, job: str = "", task_id: str = "pub0",
                 addrs: list[tuple[str, int]] | None = None, timeout: float = 10.0,
                 retries: int = 5):
        self.host, self.port = host, int(port)
        self.job = job
        self.task_id = task_id
        self.addrs = [(a[0], int(a[1])) for a in (addrs or [])]
        self.timeout = float(timeout)
        self.retries = max(int(retries), 0)
        #: the last line this publisher registered
        self.published: dict | None = None
        self.uploads = 0      # uploads shipped
        self.dedup_skips = 0  # uploads skipped: the tracker held the digest

    def publish(self, version: int, blob: bytes, epoch: int = 0) -> dict:
        """Register one committed snapshot; returns the tracker's line reply
        with its ``have`` bit.  Raises ``protocol.TrackerUnreachable`` when
        no address answers."""
        line = {"version": int(version), "epoch": int(epoch), "digest": digest_of(blob),
                "size": len(blob)}
        reply = P.tracker_rpc(self.host, self.port, P.CMD_SUB, self.task_id,
                              message=json.dumps({"publish": line}), timeout=self.timeout,
                              retries=self.retries, addrs=self.addrs, job=self.job)
        if not isinstance(reply, dict):
            reply = dict(line, have=False)
        if reply.get("have"):
            self.dedup_skips += 1
        else:
            self._upload(line["version"], blob)
            self.uploads += 1
        self.published = line
        return reply

    def _upload(self, version: int, blob: bytes) -> None:
        """Ship the bytes over ``CMD_BLOB`` (proxied and cached by a relay;
        the tracker keeps them by digest), rotating through the failover
        list as every client RPC does."""
        cands = _candidates(self.host, self.port, self.addrs)
        last: Exception | None = None
        for attempt in range(self.retries + 1):
            host, port = cands[attempt % len(cands)]
            try:
                with socket.create_connection((host, port), timeout=self.timeout) as sock:
                    sock.settimeout(self.timeout)
                    P.send_hello(sock, P.CMD_BLOB, P.join_job(self.job, self.task_id),
                                 blob=blob, blob_version=int(version))
                    if P.get_u32(sock) == P.ACK:
                        return
            except (ConnectionError, OSError, ValueError) as exc:
                last = exc
            if attempt < self.retries:
                time.sleep(min(0.1 * (2 ** attempt), 1.0))
        raise P.TrackerUnreachable(f"snapshot upload v{version} failed after "
                                   f"{self.retries + 1} attempt(s); last error: {last!r}")


class Subscriber:
    """The read side (module docstring).  ``poll_sec`` defaults to
    ``rabit_delivery_poll_sec``."""

    def __init__(self, host: str, port: int, job: str = "", task_id: str = "sub0",
                 addrs: list[tuple[str, int]] | None = None, timeout: float = 10.0,
                 retries: int = 5, chunk_bytes: int = CHUNK_BYTES,
                 poll_sec: float | None = None):
        self.host, self.port = host, int(port)
        self.job = job
        self.task_id = task_id
        self.addrs = [(a[0], int(a[1])) for a in (addrs or [])]
        self.timeout = float(timeout)
        self.retries = max(int(retries), 0)
        self.chunk_bytes = max(int(chunk_bytes), 1)
        if poll_sec is None:
            poll_sec = float(Config().get("rabit_delivery_poll_sec", "0.5") or "0.5")
        self.poll_sec = max(float(poll_sec), 0.01)
        #: the newest version this subscriber has fetched whole
        self.seen_version = 0

    def poll(self) -> dict:
        """The current version line (version 0: nothing published yet)."""
        reply = P.tracker_rpc(self.host, self.port, P.CMD_SUB, self.task_id, message="{}",
                              timeout=self.timeout, retries=self.retries, addrs=self.addrs,
                              job=self.job)
        return reply if isinstance(reply, dict) else dict(_EMPTY_LINE)

    def wait_for(self, min_version: int | None = None, deadline_sec: float = 30.0) -> dict:
        """Poll at ``poll_sec`` until the line reaches ``min_version``
        (default: past ``seen_version``).  A subscriber that slept through
        versions 5..9 wakes to the line naming 10: versions in between are
        not replayed.  TimeoutError past the deadline."""
        target = int(min_version) if min_version is not None else self.seen_version + 1
        deadline = time.monotonic() + float(deadline_sec)
        while True:
            line = self.poll()
            if int(line.get("version", 0)) >= target:
                return line
            if time.monotonic() >= deadline:
                raise TimeoutError(f"delivery line never reached v{target} "
                                   f"(currently v{line.get('version', 0)})")
            time.sleep(self.poll_sec)

    def fetch(self, line: dict | None = None,
              deadline_sec: float = 30.0) -> tuple[dict, bytes]:
        """Fetch the snapshot ``line`` names (default: the current line)
        chunk by chunk and check its digest; an empty frame or a torn
        sequence is retried until the deadline.  Returns ``(line, blob)``;
        LookupError when nothing is published, TimeoutError past the
        deadline."""
        if line is None:
            line = self.poll()
        digest = str(line.get("digest", ""))
        if not digest:
            raise LookupError("nothing published yet (empty digest)")
        deadline = time.monotonic() + float(deadline_sec)
        while True:
            blob = self._fetch_once(digest)
            if blob is not None and digest_of(blob) == digest:
                self.seen_version = max(self.seen_version, int(line.get("version", 0)))
                return dict(line), blob
            if time.monotonic() >= deadline:
                raise TimeoutError(f"snapshot {digest[:12]} not served within "
                                   f"{deadline_sec:.1f}s")
            time.sleep(self.poll_sec)

    def _fetch_once(self, digest: str) -> bytes | None:
        """One whole-blob fetch; None on an absent digest or a torn window
        sequence (the caller retries: absence is a race, not an error)."""
        buf = bytearray()
        off = 0
        total: int | None = None
        while True:
            try:
                got, tot, goff, chunk = P.tracker_rpc(
                    self.host, self.port, P.CMD_SNAP, self.task_id,
                    message=json.dumps({"digest": digest, "off": off, "len": self.chunk_bytes}),
                    timeout=self.timeout, retries=self.retries, addrs=self.addrs,
                    job=self.job)
            except P.TrackerUnreachable:
                return None
            if got != digest or goff != off:
                return None  # absent, or the holder changed mid-fetch
            if total is None:
                total = tot
            elif tot != total:
                return None
            buf += chunk
            off += len(chunk)
            if off >= total:
                return bytes(buf)
            if not chunk:
                return None  # a short frame with bytes still owed
