"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``petr_tpu_torch/csrc/<name>.cu`` becomes a shared library with a plain
C interface, ``build/<name>-<hash>.so`` at the repository root, where the
hash is that of the source and of the headers beside it (``csrc/*.cuh``):
an edited source builds anew, an unchanged one loads the library already
there. A build writes to a temporary name and
renames it into place, so two processes building at once cannot leave a
half-written library behind. Nothing is built when the package is imported:
the first call of a kernel's wrapper on a CUDA tensor builds it.
``library`` binds a library's C functions (each returns its launch's error
code) and ``check`` raises on a code that is not 0, with the library's
``petr_cuda_error_string`` for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    sha = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        sha.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{sha.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns its path.

    The compiler's report (registers, shared memory, spills per kernel) is
    kept beside the library as ``<library>.log``.
    """
    target = library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    target.with_name(target.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, target)
    return target


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """``load(name)`` with each C function of ``signatures`` given its
    argument types and an int result (the launch's error code), and the
    library's ``petr_cuda_error_string``."""
    lib = load(name)
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.petr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.petr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a code that is not 0."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed ({err}): " + lib.petr_cuda_error_string(err).decode())
