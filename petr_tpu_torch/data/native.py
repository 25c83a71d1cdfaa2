"""ctypes binding and build of the native C++ data-loader core (``csrc/dataload.cpp``).

Counterpart of `petr_tpu/data/native.py` and `native/dataload/`. The native
path fuses JPEG decode + PIL-compatible antialiased bicubic resize +
crop/flip + BGR normalize + pad into one multithreaded C++ call. The
dataset takes it when the library is built (``available()``) and the
augmentation allows it (``NuScenesDataset._load_and_transform``); else it
decodes through PIL. Nothing is built on import or on first use: build it
once with

    python -m petr_tpu_torch.data.native

(``build()``: g++ with libjpeg's headers, the flags of
`native/dataload/Makefile`), into ``build/libpetrdata-<hash>.so`` at the
repository root, the hash that of the source and the command.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dataload.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LD_FLAGS = ("-ljpeg", "-lpthread")

_LIB = None
_TRIED = False


class _ImageJob(ctypes.Structure):
    _fields_ = [
        ("jpeg", ctypes.c_void_p),
        ("jpeg_len", ctypes.c_int64),
        ("resize_w", ctypes.c_int),
        ("resize_h", ctypes.c_int),
        ("crop_x", ctypes.c_int),
        ("crop_y", ctypes.c_int),
        ("crop_w", ctypes.c_int),
        ("crop_h", ctypes.c_int),
        ("flip", ctypes.c_int),
        ("out_h", ctypes.c_int),
        ("out_w", ctypes.c_int),
        ("mean", ctypes.c_float * 3),
        ("std", ctypes.c_float * 3),
        ("to_bgr", ctypes.c_int),
        ("out", ctypes.c_void_p),
    ]


def compile_command(source: Path, target: Path) -> List[str]:
    """The g++ command that builds ``source`` into the shared library ``target``."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    return [cxx, *CXX_FLAGS, str(source), "-o", str(target), *LD_FLAGS]


def library_path(build_dir: Optional[Path] = None) -> Path:
    sha = hashlib.sha256(SOURCE.read_bytes())
    sha.update(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    return Path(build_dir or BUILD_DIR) / f"libpetrdata-{sha.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile ``csrc/dataload.cpp`` into ``build_dir`` (``build/`` by default)
    unless its library is there, and bind it: from then on ``available()``.
    Returns its path. Raises RuntimeError with the compiler's output when the
    build fails (no g++, or no libjpeg headers: ``jpeglib.h``)."""
    global _LIB, _TRIED
    target = library_path(build_dir)
    if not target.exists():
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        try:
            proc = subprocess.run(compile_command(SOURCE, tmp), capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"the native loader needs g++: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, target)  # two builders at once cannot leave half a library
    _LIB, _TRIED = _load(target), True
    return target


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.petr_process_batch.restype = ctypes.c_int
    lib.petr_process_batch.argtypes = [ctypes.POINTER(_ImageJob), ctypes.c_int, ctypes.c_int]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The built library of the current source in ``build/``, or None (a
    missing library is looked for once per process; ``build()`` binds)."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = library_path()
    if path.exists():
        try:
            _LIB = _load(path)
        except OSError:
            _LIB = None
    return _LIB


def available() -> bool:
    return get_lib() is not None


def process_images(
    jpeg_buffers: Sequence[bytes],
    *,
    resize_wh: Tuple[int, int],
    crop: Tuple[int, int, int, int],  # (left, top, right, bottom)
    flip: bool,
    out_hw: Tuple[int, int],
    mean: Sequence[float],
    std: Sequence[float],
    to_bgr: bool = True,
    n_threads: int = 0,
) -> np.ndarray:
    """Run the fused pipeline on a list of encoded JPEGs.

    Returns (N, out_h, out_w, 3) float32, normalized, zero-padded.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native dataload library not built: python -m petr_tpu_torch.data.native")
    n = len(jpeg_buffers)
    out_h, out_w = out_hw
    out = np.zeros((n, out_h, out_w, 3), np.float32)
    jobs = (_ImageJob * n)()
    # keep buffers alive
    bufs = [np.frombuffer(b, np.uint8) for b in jpeg_buffers]
    l, t, r, b_ = crop
    for i in range(n):
        j = jobs[i]
        j.jpeg = bufs[i].ctypes.data
        j.jpeg_len = len(jpeg_buffers[i])
        j.resize_w, j.resize_h = resize_wh
        j.crop_x, j.crop_y = l, t
        j.crop_w, j.crop_h = r - l, b_ - t
        j.flip = int(flip)
        j.out_h, j.out_w = out_h, out_w
        for c in range(3):
            j.mean[c] = float(mean[c])
            j.std[c] = float(std[c])
        j.to_bgr = int(to_bgr)
        j.out = out[i].ctypes.data
    failures = lib.petr_process_batch(jobs, n, n_threads)
    if failures:
        raise RuntimeError(f"native dataload: {failures} image(s) failed to decode")
    return out


if __name__ == "__main__":
    print(f"built {build()}")
