"""Build and bind the port's CUDA kernels.

Every ``imagekit_tpu_torch/csrc/*.cu`` is compiled at first use, with
``nvcc`` into one shared library with a plain C interface
(``build/imagekit_tpu_torch/libik_torch_kernels.so`` under the checkout,
a directory ``.gitignore`` lists), and bound with ctypes. The library is
rebuilt when a source is newer than it. Nothing here runs at import time:
the CPU tests import every module on a machine with no ``nvcc``.

The same pattern as ``imagekit_tpu/codecs/native/loader.py``, except that a
failed build raises with the compiler's output instead of returning None:
a CUDA tensor reaches a kernel or an error, never a silent fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "imagekit_tpu_torch"
_LIB = BUILD_DIR / "libik_torch_kernels.so"
_LOG = BUILD_DIR / "nvcc.log"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _stale() -> bool:
    if not _LIB.exists():
        return True
    built = _LIB.stat().st_mtime
    return any(s.stat().st_mtime > built for s in _sources())


def _compile() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [
        _nvcc(),
        "-gencode=arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-Xptxas",
        "-v",
        "-o",
        str(tmp),
        *[str(s) for s in sorted(_CSRC.glob("*.cu"))],
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    _LOG.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}"
        )
    os.replace(tmp, _LIB)  # atomic: a concurrent loader sees old or new


def _configure(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    ci = ctypes.c_int
    lib.ik_jpeg8_folded_plane.argtypes = [vp] * 7 + [ci] * 11 + [vp]
    lib.ik_jpeg8_folded_plane.restype = ci


def load() -> ctypes.CDLL:
    """Build (if stale) and load the kernel library; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                _compile()
            lib = ctypes.CDLL(str(_LIB))
            _configure(lib)
            _lib = lib
        return _lib


def build_log() -> str:
    """What nvcc printed for the last build (ptxas register/smem report)."""
    return _LOG.read_text() if _LOG.exists() else ""
