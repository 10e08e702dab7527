"""ctypes bridge to rabit's fault-tolerant C++ engine (``native/src``).

The port's own copy of ``rabit_tpu/engine/native.py``.  One library hosts
every backend of the C ABI (``native/include/tpurabit/c_api.h``), and
``rabit_engine=native|robust|base|mock`` picks one when ``init`` runs:
``robust`` (what ``native`` resolves to under a tracker) survives the death
of a worker by replaying its collectives and serving it the last
checkpoint from its peers, and ``mock`` is the robust engine with the
deterministic kill points ``mock=rank,version,seqno,trial``.

The library is built from ``native/src/*.cc`` with ``g++`` at first use
(never at import) into ``rabit_tpu_torch/_build/``, under a name that
carries a hash of the sources, the headers and the flags; nothing is
written under ``native/``.  Processes that build at once (a launcher's
workers starting together) take an ``flock`` on one lock file, and each build goes
to a temporary file that ``os.replace`` moves into place, so a loader sees
the whole library or none.  A failed build raises.

Arrays cross as numpy buffers; the compressed collectives come from the
host transport of ``engine.base`` over this engine's ``allgather``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np

from rabit_tpu_torch._build import BUILD_DIR
from rabit_tpu_torch.engine.base import DTYPE_ENUM, Engine

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCES = ("socket", "comm", "engine", "robust", "c_api")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
KINDS = ("native", "robust", "base", "mock")

_lib = None
_lib_lock = threading.Lock()

_PREPARE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
_REDUCE_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p)
_SERIALIZE_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p,
    ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint64))


def lib_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    files = [NATIVE_DIR / "src" / f"{s}.cc" for s in SOURCES]
    files += sorted((NATIVE_DIR / "src").glob("*.h"))
    files += sorted((NATIVE_DIR / "include" / "tpurabit").glob("*.h"))
    for f in files:
        digest.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libtpurabit-{digest.hexdigest()[:16]}.so"


def build_lib() -> Path:
    """Build the library unless it is built; returns its path."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtpurabit.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *CXX_FLAGS, "-I", str(NATIVE_DIR / "include"),
               *(str(NATIVE_DIR / "src" / f"{s}.cc") for s in SOURCES), "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(f"native library build failed: {e}") from e
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(f"native library build failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def build_program(source: Path) -> Path:
    """Build a C++ program of the native API (``native/tests/speed_test.cc``,
    ``guide/*.cc``) against the port's library, into the build directory
    under a name that carries a hash of the program and the library; returns
    its path.  Nothing is written beside the source."""
    lib = build_lib()
    source = Path(source)
    digest = hashlib.sha256(lib.name.encode() + b"\0" + source.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{digest}.run"
    if out.exists():
        return out
    with open(BUILD_DIR / "libtpurabit.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        fd, tmp = tempfile.mkstemp(suffix=".run", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-O2", "-std=c++17", "-pthread", "-I", str(NATIVE_DIR / "include"),
               "-o", tmp, str(source), str(lib), f"-Wl,-rpath,{BUILD_DIR}"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(f"build of {source.name} failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_lib()))
        lib.TrtGetLastError.restype = ctypes.c_char_p
        lib.RabitInit.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
        lib.RabitAllreduceKeyed.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            _PREPARE_CB, ctypes.c_void_p, ctypes.c_char_p]
        lib.RabitBroadcastKeyed.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                            ctypes.c_int, ctypes.c_char_p]
        lib.RabitAllgatherKeyed.argtypes = [ctypes.c_void_p] + [ctypes.c_uint64] * 3 + [
            ctypes.c_char_p]
        lib.RabitCheckPoint.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                        ctypes.c_char_p, ctypes.c_uint64]
        lib.TrtLazyCheckPointFn.argtypes = [_SERIALIZE_CB, ctypes.c_void_p]
        lib.RabitLoadCheckPoint.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_char)), ctypes.POINTER(ctypes.c_uint64)]
        lib.TrtAllreduceCustom.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64, _REDUCE_CB, ctypes.c_void_p,
            _PREPARE_CB, ctypes.c_void_p, ctypes.c_char_p]
        lib.RabitTrackerPrint.argtypes = [ctypes.c_char_p]
        lib.RabitGetProcessorName.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
        _lib = lib
        return lib


class NativeError(RuntimeError):
    pass


class NativeEngine(Engine):
    """Engine backed by the native library (TCP tree and ring collectives,
    robust recovery, mock fault injection)."""

    def __init__(self, config, kind: str = "native"):
        super().__init__(config)
        self._kind = kind
        self._lib = load_lib()

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self._lib.TrtGetLastError().decode()
            self.obs_event("engine_error", what=what, error=msg)
            raise NativeError(f"{what} failed: {msg}")

    # -- lifecycle -----------------------------------------------------------

    def init(self) -> None:
        cfg = self.config.as_dict()
        if self._kind != "native":
            cfg["rabit_engine"] = self._kind
        args = [f"{k}={v}".encode() for k, v in cfg.items()]
        arr = (ctypes.c_char_p * len(args))(*args)
        self.obs_event("engine_init", backend=self._kind)
        t0 = time.time()
        try:
            self._check(self._lib.RabitInit(len(args), arr), "init")
        except NativeError as exc:
            # A dead tracker surfaces as a connect failure after the native
            # bootstrap's bounded backoff: name the address and the budget.
            if "connect to" in str(exc):
                uri = self.config.get("rabit_tracker_uri", "NULL")
                port = self.config.get("rabit_tracker_port", "9091")
                retry = self.config.get_int("rabit_connect_retry", 5)
                raise NativeError(
                    f"{exc}: tracker at {uri}:{port} unreachable after {retry + 1} "
                    f"backed-off connect attempts (rabit_connect_retry={retry}); is "
                    "the tracker running?") from exc
            raise
        self.obs_event("bootstrap_done", rank=self.get_rank(), world=self.get_world_size(),
                       attempt=self.config.get_int("rabit_num_trial", 0),
                       seconds=round(time.time() - t0, 6))

    def shutdown(self) -> None:
        self.obs_event("engine_shutdown", backend=self._kind)
        self._check(self._lib.RabitFinalize(), "finalize")

    def init_after_exception(self) -> None:
        self.obs_event("init_after_exception", backend=self._kind)
        self._check(self._lib.RabitInitAfterException(), "init_after_exception")

    def rebootstrap(self) -> None:
        """Re-enter the tracker after a world-epoch change: finalize, then
        check in again and adopt whatever assignment (rank, world,
        topology) the tracker's current epoch hands out.  The in-memory
        checkpoints do not survive; state comes back from the durable
        store or the program, as in a whole-job resume.  A failed finalize
        raises before any new check-in.  Called by ``api.rebootstrap``."""
        self.obs_event("epoch_changed", backend=self._kind, world=self.get_world_size())
        self._check(self._lib.RabitFinalize(), "finalize")
        self.init()

    # -- topology ------------------------------------------------------------

    def get_rank(self) -> int:
        return self._lib.RabitGetRank()

    def get_world_size(self) -> int:
        return self._lib.RabitGetWorldSize()

    def is_distributed(self) -> bool:
        return bool(self._lib.RabitIsDistributed())

    def get_ring_prev_rank(self) -> int:
        return self._lib.RabitGetRingPrevRank()

    def get_host(self) -> str:
        buf = ctypes.create_string_buffer(256)
        length = ctypes.c_uint64()
        self._check(self._lib.RabitGetProcessorName(buf, ctypes.byref(length), 256),
                    "get_processor_name")
        return buf.value.decode()

    def tracker_print(self, msg: str) -> None:
        self._check(self._lib.RabitTrackerPrint(msg.encode()), "tracker_print")

    # -- collectives ---------------------------------------------------------
    # Every callback handed to the library is held in a local (or on self)
    # until the C call that may run it has returned.

    def allreduce(self, data, op, prepare_fun=None, cache_key=None):
        buf = np.ascontiguousarray(data)
        cb = _PREPARE_CB()
        if prepare_fun is not None:
            cb = _PREPARE_CB(lambda _arg: prepare_fun(buf))
        rc = self._lib.RabitAllreduceKeyed(
            buf.ctypes.data_as(ctypes.c_void_p), buf.size, DTYPE_ENUM[buf.dtype], op,
            cb, None, (cache_key or "").encode())
        self._check(rc, "allreduce")
        return buf

    def allreduce_fn(self, data, reduce_fn, prepare_fun=None, cache_key=None):
        """Allreduce with a Python reducer ``reduce_fn(dst, src) -> array``
        over this rank's and a peer's elements."""
        buf = np.ascontiguousarray(data)
        itemsize = buf.dtype.itemsize

        def c_reduce(dst, src, n, _ctx):
            d = np.ctypeslib.as_array(ctypes.cast(dst, ctypes.POINTER(ctypes.c_uint8)),
                                      shape=(n * itemsize,)).view(buf.dtype)
            s = np.ctypeslib.as_array(ctypes.cast(src, ctypes.POINTER(ctypes.c_uint8)),
                                      shape=(n * itemsize,)).view(buf.dtype)
            d[...] = reduce_fn(d.copy(), s)

        rcb = _REDUCE_CB(c_reduce)
        pcb = _PREPARE_CB()
        if prepare_fun is not None:
            pcb = _PREPARE_CB(lambda _arg: prepare_fun(buf))
        rc = self._lib.TrtAllreduceCustom(
            buf.ctypes.data_as(ctypes.c_void_p), itemsize, buf.size, rcb, None, pcb, None,
            (cache_key or "").encode())
        self._check(rc, "allreduce_custom")
        return buf

    def broadcast(self, data, root, cache_key=None):
        rank = self.get_rank()
        key = (cache_key or "").encode()
        # two phases: the length, then the payload
        length = np.array([len(data) if rank == root and data is not None else 0],
                          np.uint64)
        self._check(self._lib.RabitBroadcastKeyed(
            length.ctypes.data_as(ctypes.c_void_p), 8, root, key), "broadcast")
        n = int(length[0])
        buf = np.zeros(n, np.uint8)
        if rank == root:
            buf[:] = np.frombuffer(data, np.uint8)
        if n > 0:
            self._check(self._lib.RabitBroadcastKeyed(
                buf.ctypes.data_as(ctypes.c_void_p), n, root, key), "broadcast")
        return buf.tobytes()

    def allgather(self, data, cache_key=None):
        flat = np.ascontiguousarray(data).reshape(-1)
        world, rank = self.get_world_size(), self.get_rank()
        out = np.zeros(world * flat.size, flat.dtype)
        out[rank * flat.size:(rank + 1) * flat.size] = flat
        self._check(self._lib.RabitAllgatherKeyed(
            out.ctypes.data_as(ctypes.c_void_p), out.nbytes, rank * flat.nbytes,
            (rank + 1) * flat.nbytes, (cache_key or "").encode()), "allgather")
        return out

    # -- checkpoints ---------------------------------------------------------

    def load_checkpoint(self):
        gptr = ctypes.POINTER(ctypes.c_char)()
        lptr = ctypes.POINTER(ctypes.c_char)()
        glen, llen = ctypes.c_uint64(), ctypes.c_uint64()
        version = self._lib.RabitLoadCheckPoint(ctypes.byref(gptr), ctypes.byref(glen),
                                                ctypes.byref(lptr), ctypes.byref(llen))
        if version < 0:
            raise NativeError(f"load_checkpoint failed: "
                              f"{self._lib.TrtGetLastError().decode()}")
        if version == 0:
            return 0, None, None
        gblob = ctypes.string_at(gptr, glen.value) if glen.value else None
        lblob = ctypes.string_at(lptr, llen.value) if llen.value else None
        self.obs_event("checkpoint_loaded", version=version, global_bytes=glen.value,
                       local_bytes=llen.value)
        return version, gblob, lblob

    def checkpoint(self, global_blob, local_blob=None):
        self._check(self._lib.RabitCheckPoint(
            global_blob, len(global_blob),
            local_blob, 0 if local_blob is None else len(local_blob)), "checkpoint")
        self.obs_event("version_bump", version=self.version_number())

    def lazy_checkpoint(self, get_global_blob: Callable[[], bytes]) -> None:
        """A checkpoint whose blob is made only when a recovering peer asks
        for it: the model behind ``get_global_blob`` must stay unchanged
        until the next checkpoint (the callback may run any time until
        then, also while the next checkpoint's consensus still serves this
        version)."""
        def _serialize(ctx, out_data, out_len):
            try:
                self._lazy_blob = get_global_blob()
                out_data[0] = self._lazy_blob
                out_len[0] = len(self._lazy_blob)
                return 0
            except Exception:  # noqa: BLE001 (reported to the engine as a failure)
                return -1

        cb = _SERIALIZE_CB(_serialize)
        # The previous callback stays alive until this registration has
        # replaced it inside the engine, and both if the call fails.
        self._lazy_keepalive = getattr(self, "_lazy_keepalive", []) + [cb]
        self._check(self._lib.TrtLazyCheckPointFn(cb, None), "lazy_checkpoint")
        self._lazy_keepalive = [cb]

    def version_number(self) -> int:
        return self._lib.RabitVersionNumber()
