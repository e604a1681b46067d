"""Build and load the port's CUDA kernels on first use.

Each ``csrc/<name>.cu`` has a plain C interface and may include the shared
headers ``csrc/*.cuh``.  :func:`load` compiles it with ``nvcc`` for
``sm_90a`` into a shared library under ``build/`` at the repository root
(one directory per hash of the source, the headers and the flags, so an
edited source or header rebuilds and a stale library is never loaded) and
opens it with :mod:`ctypes`.  Nothing is built at import time: the CPU tests import
every module, and the CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_root", "find_nvcc", "library_path", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}
_LOADED: dict[str, ctypes.CDLL] = {}


def build_root() -> Path:
    """``build/kernels`` at the repository root (listed in ``.gitignore``)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin``
    (default ``/usr/local/cuda``).  Raises ``RuntimeError`` if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin): the CUDA "
        "kernels build on first use on a machine with the CUDA toolkit; "
        "CPU tensors take the plain PyTorch versions instead")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives.  The hash
    covers the source, every header of ``csrc/`` (``*.cuh``, by name and
    content) and the flags, so a changed shared header rebuilds every
    library and a stale one is never loaded."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_root() / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and open the library of ``csrc/<name>.cu``.

    Thread-safe; threads that load different names build at once."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if not out.is_file():
            nvcc = find_nvcc()
            out.parent.mkdir(parents=True, exist_ok=True)
            # build under a temporary name, then rename: processes that
            # build at once (several test workers) never load a half-written
            # file
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {name}.cu:\n{proc.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
        _LOADED[name] = lib
        return lib
