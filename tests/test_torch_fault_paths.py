"""Fault paths of the port that no other port test holds, each the
counterpart of a ``rabit_tpu`` test on the port's own classes:

* tests/test_chaos.py's ``ChaosProxy`` fault shapes (pass-through, refuse,
  truncate, blackhole, partition) against a TCP echo upstream, and a native
  bootstrap through a flaky tracker path: the port's ``Tracker`` behind the
  port's ``ChaosProxy``, which comes up late and then delays every chunk,
  with native workers of tests/workers/torch_basic_worker.py;
* tests/test_durable_ckpt.py::test_resume_then_worker_death: a worker
  killed during a job resumed from the durable spill recovers through the
  peer path (tests/workers/torch_recover_worker.py);
* tests/test_liveness.py::test_worker_death_between_hello_and_reply_does_not_stall_wave:
  both paths, the stale entry replaced by the restart and the dead
  connection purged when the wave fills.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from rabit_tpu_torch.chaos import ChaosProxy, FaultSpec
from rabit_tpu_torch.engine import native
from rabit_tpu_torch.tracker import protocol as P
from rabit_tpu_torch.tracker.launcher import LocalCluster
from rabit_tpu_torch.tracker.tracker import Tracker

ROOT = Path(__file__).resolve().parents[1]
BASIC = str(ROOT / "tests" / "workers" / "torch_basic_worker.py")
RECOVER = str(ROOT / "tests" / "workers" / "torch_recover_worker.py")


@pytest.fixture(scope="module")
def built():
    """The port's library, built once before the workers load it."""
    return native.build_lib()


# -- tests/test_chaos.py: the proxy's fault shapes ------------------------------------

class _Echo:
    """A TCP echo upstream, a thread a connection."""

    def __init__(self):
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.addr = self.srv.getsockname()
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    @staticmethod
    def _serve(conn):
        try:
            while True:
                data = conn.recv(4096)
                if not data:
                    return
                conn.sendall(data)
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        try:
            self.srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.srv.close()


def test_proxy_passthrough_no_faults():
    echo = _Echo()
    proxy = ChaosProxy(echo.addr).start()
    try:
        with socket.create_connection((proxy.host, proxy.port), 5) as s:
            s.settimeout(5)
            payload = bytes(range(256)) * 64
            s.sendall(payload)
            got = b""
            while len(got) < len(payload):
                got += s.recv(4096)
            assert got == payload
        # the pumps count a chunk after forwarding it
        deadline = time.time() + 2
        while proxy.stats.bytes_forwarded < 2 * len(payload) and time.time() < deadline:
            time.sleep(0.01)
        assert proxy.stats.bytes_forwarded >= 2 * len(payload)
        assert proxy.stats.refused == 0
    finally:
        proxy.stop()
        echo.close()


def test_proxy_refuse_and_truncate():
    echo = _Echo()
    proxy = ChaosProxy(echo.addr, FaultSpec(p_refuse=1.0)).start()
    try:
        with socket.create_connection((proxy.host, proxy.port), 5) as s:
            s.settimeout(5)
            assert s.recv(1) == b""  # accepted, then closed at once
        assert proxy.stats.refused == 1
    finally:
        proxy.stop()

    proxy = ChaosProxy(echo.addr, FaultSpec(p_truncate=1.0, truncate_bytes=(8, 8))).start()
    try:
        with socket.create_connection((proxy.host, proxy.port), 5) as s:
            s.settimeout(5)
            s.sendall(b"x" * 64)
            got = b""
            try:
                while True:
                    chunk = s.recv(4096)
                    if not chunk:
                        break
                    got += chunk
            except OSError:
                pass  # a cut mid-stream may read as a reset
            assert len(got) <= 8  # only the prefix crossed
        assert proxy.stats.truncated == 1
    finally:
        proxy.stop()
        echo.close()


def test_proxy_blackhole_and_partition():
    echo = _Echo()
    proxy = ChaosProxy(echo.addr, FaultSpec(p_blackhole=1.0)).start()
    try:
        with socket.create_connection((proxy.host, proxy.port), 5) as s:
            s.settimeout(0.4)
            s.sendall(b"hello?")
            with pytest.raises(socket.timeout):
                s.recv(1)  # open but silent: only a deadline catches it
        assert proxy.stats.blackholed == 1
    finally:
        proxy.stop()

    proxy = ChaosProxy(echo.addr).start()
    try:
        s = socket.create_connection((proxy.host, proxy.port), 5)
        s.settimeout(5)
        s.sendall(b"ping")
        assert s.recv(4) == b"ping"
        proxy.set_partition(True)
        assert s.recv(1) == b""  # the open connection is cut
        s.close()
        with socket.create_connection((proxy.host, proxy.port), 5) as s2:
            s2.settimeout(5)
            assert s2.recv(1) == b""  # and new ones refused while partitioned
        proxy.set_partition(False)
        with socket.create_connection((proxy.host, proxy.port), 5) as s3:
            s3.settimeout(5)
            s3.sendall(b"back")
            assert s3.recv(4) == b"back"
    finally:
        proxy.stop()
        echo.close()


def test_native_bootstrap_through_flaky_tracker_path(built):
    """Native workers bootstrap and finish their matrix with the tracker
    behind a proxy that comes up late (their early dials are refused: the
    C++ connect retry and backoff) and then delays every chunk."""
    tracker = Tracker(2, quiet=True).start()
    # the proxy's port, reserved and released: the workers dial a dead
    # address first
    hold = socket.socket()
    hold.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    hold.bind(("127.0.0.1", 0))
    proxy_port = hold.getsockname()[1]
    hold.close()
    procs = []
    for i in range(2):
        env = dict(os.environ, DMLC_TRACKER_URI="127.0.0.1", DMLC_TRACKER_PORT=str(proxy_port),
                   DMLC_TASK_ID=str(i))
        procs.append(subprocess.Popen(
            [sys.executable, BASIC, "rabit_engine=native", "lazy=0", "rabit_connect_retry=8",
             "200"], env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    proxy = None
    try:
        time.sleep(2.0)  # the workers import torch, then burn connect retries
        proxy = ChaosProxy((tracker.host, tracker.port), FaultSpec(delay=(0.0, 0.02)), seed=3,
                           listen_port=proxy_port).start()
        deadline = time.time() + 90
        while time.time() < deadline and any(p.poll() is None for p in procs):
            time.sleep(0.1)
        rcs = [p.poll() for p in procs]
        errs = [p.stderr.read() if p.stderr else "" for p in procs]
        assert rcs == [0, 0], f"exit codes {rcs}\n" + "\n".join(errs)
        assert proxy.stats.connections > 0
        assert [e["epoch"] for e in tracker.events if e["kind"] == "wave"] == [0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if proxy is not None:
            proxy.stop()
        tracker.stop()


# -- tests/test_durable_ckpt.py ---------------------------------------------------------

def run_recover(world: int, args: list[str], max_restarts: int = 0) -> LocalCluster:
    cluster = LocalCluster(world, max_restarts=max_restarts, quiet=True)
    rc = cluster.run([sys.executable, RECOVER, "rabit_engine=robust", "ndata=2000", *args],
                     timeout=120.0)
    assert rc == 0
    assert all(r == 0 for r in cluster.returncodes.values())
    return cluster


def test_resume_then_worker_death(built, tmp_path):
    """A worker killed during the resumed job recovers through the peer
    path, re-entering the disk-resume collectives when it restarts before
    the resumed job's first checkpoint."""
    d = f"rabit_checkpoint_dir={tmp_path}"
    c1 = run_recover(4, ["niter=6", "stop_at=2", d])
    assert any("stopping at version 2" in m for m in c1.messages)
    c2 = run_recover(4, ["niter=6", "rabit_engine=mock", "mock=1,0,3,0", d], max_restarts=3)
    assert c2.restarts["1"] == 1
    assert any(e["kind"] == "disk_resume" and e["version"] == 2 for e in c2.events)
    assert any("all 6 iterations verified" in m for m in c2.messages)


# -- tests/test_liveness.py: a death between the hello and the reply -------------------

def _boot_thread(tracker, task_id, results, cmd=P.CMD_START):
    def run():
        results[task_id] = P.tracker_rpc(
            tracker.host, tracker.port, cmd, task_id, listen_port=41000 + int(task_id),
            timeout=2.0, reply_timeout=20.0, retries=0)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


def _dead_hello(tracker) -> None:
    """Task "0" checks in and dies before its assignment can be read."""
    s = socket.create_connection((tracker.host, tracker.port), timeout=5)
    P.send_hello(s, P.CMD_START, "0", listen_port=41000)
    s.close()


@pytest.mark.parametrize("path", ["restart_replaces_stale_entry", "fill_purges_dead_conn"])
def test_worker_death_between_hello_and_reply_does_not_stall_wave(path):
    """The wave completes as soon as the dead worker's restart checks in:
    by replacing the stale entry when the restart comes while the wave is
    filling, by purging the dead connection when the wave would otherwise
    fire into it."""
    tracker = Tracker(3, quiet=True).start()
    try:
        _dead_hello(tracker)
        results: dict[str, P.Assignment] = {}
        if path == "restart_replaces_stale_entry":
            threads = [_boot_thread(tracker, t, results) for t in ("0", "1", "2")]
        else:
            threads = [_boot_thread(tracker, t, results) for t in ("1", "2")]
            deadline = time.time() + 10
            while time.time() < deadline and not any(
                    e["kind"] == "wave_purged" for e in tracker.events):
                time.sleep(0.02)
            assert any(e["kind"] == "wave_purged" and e["dropped"] == ["0"]
                       for e in tracker.events), tracker.events
            threads.append(_boot_thread(tracker, "0", results))  # the restart
        for th in threads:
            th.join(timeout=25)
            assert not th.is_alive(), "wave stalled past the restart"
        assert sorted(a.rank for a in results.values()) == [0, 1, 2]
        if path == "restart_replaces_stale_entry":
            assert results["0"].rank == 0  # the launcher's numbering kept
        else:
            assert {a.epoch for a in results.values()} == {0}
    finally:
        tracker.stop()
