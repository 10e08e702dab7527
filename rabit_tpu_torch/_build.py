"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries land in ``rabit_tpu_torch/_build/`` under a name
that carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is (the hash covers the
shared ``csrc/*.cuh`` headers too).  ``build_all`` starts one
``nvcc`` per source, all at once.

Nothing here runs at import: the CPU test suite imports every module of
the package on machines that have no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("hist", "route")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
ptxas_log: dict[str, str] = {}  # name -> nvcc's -Xptxas -v report


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's default install
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))  # included headers
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str):
    """Start nvcc for one source; returns (target, process, temp output),
    the last two None when the target is already built."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, proc, tmp


def _finish(name: str, out: Path, proc, tmp) -> None:
    if proc is not None:
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    _libs[name] = ctypes.CDLL(str(out))


def build_all() -> dict[str, ctypes.CDLL]:
    """Build (in parallel) and load every source; returns name -> library."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        started = [(n, *_start(n)) for n in todo]
        errors = []
        for n, out, proc, tmp in started:  # reap every nvcc before raising
            try:
                _finish(n, out, proc, tmp)
            except (RuntimeError, OSError) as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return dict(_libs)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        build_all()
    return _libs[name]


def kernel_names() -> tuple[str, ...]:
    """The ``__global__`` functions of every source (the names the card's
    profiler shows the port's kernels under)."""
    names = set()
    for name in SOURCES:
        text = (SRC_DIR / f"{name}.cu").read_text()
        names.update(re.findall(
            r"__global__\s+(?:void\s+|__launch_bounds__\([^)]*\)\s*)*(\w+)\s*\(", text))
    return tuple(sorted(names))
