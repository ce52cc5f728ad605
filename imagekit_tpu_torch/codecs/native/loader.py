"""Builder and loader of the port's native codec library (ctypes).

The port's copies of the reference's C++ codecs (``jpeg_entropy.cpp``,
``vp8_encode.cpp``, ``vp8_decode.cpp``, ``vp8l_decode.cpp``,
``png_decode.cpp``, ``misc_decode.cpp``, ``tiff_decode.cpp`` and the AV1
encoder's entropy engine and leaf evaluation ``av1_enc.cpp``, beside this
file) and its own decoders of what the reference hands to Pillow
(``raster_decode.cpp``: QOI and BCn; ``jpeg4_decode.cpp``: CMYK and YCCK
JPEGs) are compiled at first use, one ``g++ -c`` a source, all started
together, then linked:

    g++ -O3 -march=native -fPIC -c <source> -o <source>.o   (each)
    g++ -shared <objects> -o libik_native.so -lz

into ``build/imagekit_tpu_torch/`` under the checkout (a directory
``.gitignore`` lists), never into the package, and rebuilt when a source
is newer than the library. Concurrent processes serialise on a lock file
there, so one builds and the others load its result. Where the library
cannot be built or loaded, :func:`load` raises with the compiler's
message: the port has no host-library codec to fall back to.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

_HERE = Path(__file__).resolve().parent
_SOURCES = ("jpeg_entropy.cpp", "vp8_encode.cpp", "vp8_decode.cpp",
            "vp8l_decode.cpp", "png_decode.cpp", "misc_decode.cpp",
            "tiff_decode.cpp", "av1_enc.cpp", "raster_decode.cpp",
            "jpeg4_decode.cpp")
_HEADERS = ("vp8_common.h", "vp8_tables.h")
BUILD_DIR = _HERE.parents[2] / "build" / "imagekit_tpu_torch"
_LIB = BUILD_DIR / "libik_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _stale() -> bool:
    if not _LIB.exists():
        return True
    built = _LIB.stat().st_mtime
    return any((_HERE / s).stat().st_mtime > built
               for s in _SOURCES + _HEADERS)


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libik_native.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)  # released when the file closes
        if not _stale():
            return  # another process built it while this one waited
        tag = f"{os.getpid()}.tmp"
        tmp = _LIB.with_suffix(f".{tag}.so")
        objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in _SOURCES]
        flags = ["-O3", "-march=native", "-funroll-loops", "-std=c++17",
                 "-fPIC", "-fvisibility=hidden"]
        try:
            _run([["g++", *flags, "-c", str(_HERE / s), "-o", str(o)]
                  for s, o in zip(_SOURCES, objs)])
            # png_decode.cpp and tiff_decode.cpp inflate via zlib
            _run([["g++", "-shared", *map(str, objs), "-o", str(tmp),
                   "-lz"]])
            os.replace(tmp, _LIB)  # atomic: a loader sees old or new
        finally:
            tmp.unlink(missing_ok=True)
            for o in objs:
                o.unlink(missing_ok=True)


def _run(cmds) -> None:
    """Run the commands concurrently; raise with the compiler's message of
    the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=_HERE)
             for c in cmds]
    outs = [p.communicate(timeout=300)[1] for p in procs]
    for c, p, err in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"native codec build failed ({p.returncode}): "
                f"{' '.join(c)}\n{err[-8000:]}")


def load() -> ctypes.CDLL:
    """Build (if stale) and load the codec library; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                _build()
            lib = ctypes.CDLL(str(_LIB))
            _configure(lib)
            _lib = lib
        return _lib


def _configure(lib: ctypes.CDLL) -> None:
    from imagekit_tpu_torch.codecs.native import jpeg_abi

    jpeg_abi.configure(lib)
    # raster_decode.cpp: (data, len, w, h, channels | BCn kind, out)
    for fn in (lib.ik_qoi_decode, lib.ik_bcn_decode):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int


def decode_jpeg(data: bytes):
    from imagekit_tpu_torch.codecs.native import jpeg_abi

    return jpeg_abi.decode(load(), data)


def encode_jpeg(planes, qtabs, width: int, height: int,
                samp: Tuple[int, int] = (2, 2)) -> bytes:
    """Baseline JFIF of quantised planes; ``samp`` is the luma's (h, v)
    sampling factors, the chroma's are 1 (4:2:0 by default)."""
    from imagekit_tpu_torch.codecs.native import jpeg_abi

    return jpeg_abi.encode(load(), planes, qtabs, width, height,
                           (samp, (1, 1), (1, 1)))
