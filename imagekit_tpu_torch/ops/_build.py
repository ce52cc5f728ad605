"""Build and bind the port's CUDA kernels.

Every ``imagekit_tpu_torch/csrc/*.cu`` is compiled at first use, one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface
(``build/imagekit_tpu_torch/libik_torch_kernels.so`` under the checkout,
a directory ``.gitignore`` lists), bound with ctypes. The library is
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


def _run(cmds):
    """Run the commands concurrently; raise with the output of the first
    that fails. Every command's output goes to the build log."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    with _LOG.open("a") as log:
        for c, o in zip(cmds, outs):
            log.write(" ".join(c) + "\n" + o)
    for p, o in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{o[-8000:]}")


def _compile() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    _LOG.write_text("")
    nvcc = _nvcc()
    arch = "-gencode=arch=compute_90a,code=sm_90a"
    tag = f"{os.getpid()}.tmp"
    objs = []
    cmds = []
    for src in sorted(_CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        objs.append(obj)
        cmds.append([nvcc, arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", "-c", str(src), "-o", str(obj)])
    tmp = _LIB.with_suffix(f".{tag}.so")
    try:
        _run(cmds)
        _run([[nvcc, arch, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, _LIB)  # atomic: a concurrent loader sees old or new
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


class IkPlane(ctypes.Structure):
    """One plane of a K2/K3/K4 launch: ``IkPlane`` in
    ``csrc/resize_band.cuh``, field for field. Pointers are device
    addresses (``data_ptr()``); strides are in elements. The last four
    fields are the plane's own u8 epilogue, ``(acc + pre) * scale + post``
    where ``affine`` is set."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("x", "wv", "band_v", "start_h",
                                         "taps_h", "vidx", "hidx", "out")]
        + [(n, ctypes.c_longlong) for n in ("sb", "sh", "osb", "osc")]
        + [(n, ctypes.c_int) for n in ("IH", "IW", "OH", "OW", "U", "U2",
                                        "T", "C")]
        + [(n, ctypes.c_float) for n in ("scale", "pre", "post")]
        + [(n, ctypes.c_int) for n in ("affine", "strip")]
    )


class BandInfo(ctypes.Structure):
    """What a K2/K3/K4 launch took: its tile height and the column strips
    a row tile took (0: whole rows)."""

    _fields_ = [("tr", ctypes.c_int), ("strips", ctypes.c_int)]


def launch_band(fn, planes, B: int, *args) -> BandInfo:
    """Call a K2/K3/K4 entry with ``planes`` (a list of :class:`IkPlane`)
    and its trailing arguments (the stream last); raise on a refused
    launch, else return what it took."""
    arr = (IkPlane * len(planes))(*planes)
    info = BandInfo()
    rc = fn(ctypes.addressof(arr), len(planes), B, *args, ctypes.byref(info))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError_t {rc}")
    return info


def _configure(lib: ctypes.CDLL) -> None:
    configure_folded(lib)
    configure_band(lib)


def configure_folded(lib: ctypes.CDLL) -> None:
    """argtypes of K1's two entries (also used by the CPU build of its
    source in the tests)."""
    vp = ctypes.c_void_p
    ci = ctypes.c_int
    for fn in (lib.ik_jpeg8_folded_planes, lib.ik_jpeg8_folded_planes_i16):
        fn.argtypes = [
            ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_longlong), vp, vp,
            ci, ci, ci, ci, vp,
        ]
        fn.restype = ci


def configure_band(lib: ctypes.CDLL) -> None:
    """argtypes of the K2/K3/K4 entries (also used by the CPU build of
    their source in the tests)."""
    vp = ctypes.c_void_p
    ci = ctypes.c_int
    info = ctypes.POINTER(BandInfo)
    lib.ik_resize_strip.argtypes = [vp, ci, ci, ci, vp, info]
    lib.ik_resize_strip.restype = ci
    for fn in (lib.ik_resize_planes_u8, lib.ik_resize_planes_f32,
               lib.ik_resize_planes_u8_f32, lib.ik_resize_strip_f32):
        fn.argtypes = [vp, ci, ci, vp, info]
        fn.restype = ci


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
