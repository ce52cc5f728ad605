"""Builder and loader of the port's native codec library (ctypes).

The port's copies of the reference's C++ codecs (``jpeg_entropy.cpp``,
``vp8_encode.cpp``, ``vp8_decode.cpp``, ``vp8l_decode.cpp``,
``png_decode.cpp``, ``misc_decode.cpp``, ``tiff_decode.cpp`` and the AV1
encoder's entropy engine and leaf evaluation ``av1_enc.cpp``, beside this
file) and its own decoders of what the reference hands to Pillow
(``raster_decode.cpp`` and ``bcn_ext_decode.cpp``: QOI and BCn;
``jpeg4_decode.cpp``: CMYK and YCCK JPEGs, baseline and progressive,
baseline frames in several scans, arithmetic-coded and lossless frames;
``bmp_ext_decode.cpp`` and
``tiff_ext_decode.cpp``: the BMP and TIFF layouts the copies refuse;
``av1_decode.cpp``: AV1 intra frames, where the reference calls libdav1d;
``avif_yuv_rgb.cpp``: the YUV -> RGB of the AVIFs the reference hands to
Pillow's libavif, in libavif's and libyuv's arithmetic; ``avif_scale.cpp``:
libyuv's plane scaling of the items libavif rescales to their ``ispe``) are
compiled at first use, one ``g++ -c`` a source, all started
together, then linked:

    g++ -O3 -march=native -fPIC -c <source> -o <source>.o   (each;
                                  -ffp-contract=off for avif_yuv_rgb.cpp)
    g++ -shared <objects> -o libik_native.so -lz

into ``build/imagekit_tpu_torch/`` under the checkout (a directory
``.gitignore`` lists), never into the package, and rebuilt when a source
is newer than the library. Concurrent processes serialise on a lock file
there, so one builds and the others load its result. The library links
no liblzma: LZMA TIFF strips go through Python's ``lzma``, which it calls
back (:func:`_xz_strip`, registered at load). Where the library
cannot be built or loaded, :func:`load` raises with the compiler's
message: the port has no host-library codec to fall back to.
"""

from __future__ import annotations

import ctypes
import fcntl
import lzma
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

_HERE = Path(__file__).resolve().parent
_SOURCES = ("jpeg_entropy.cpp", "vp8_encode.cpp", "vp8_decode.cpp",
            "vp8l_decode.cpp", "png_decode.cpp", "misc_decode.cpp",
            "tiff_decode.cpp", "av1_enc.cpp", "raster_decode.cpp",
            "jpeg4_decode.cpp", "bmp_ext_decode.cpp", "tiff_ext_decode.cpp",
            "bcn_ext_decode.cpp", "av1_decode.cpp", "avif_yuv_rgb.cpp",
            "avif_scale.cpp")
#: flags of one source beside the common ones: libavif's float path rounds
#: every product on its own (no fused multiply-add)
_SOURCE_FLAGS = {"avif_yuv_rgb.cpp": ["-ffp-contract=off"]}
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
            _run([["g++", *flags, *_SOURCE_FLAGS.get(s, []), "-c",
                   str(_HERE / s), "-o", str(o)]
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


_XZ_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
                          ctypes.c_void_p, ctypes.c_size_t)


@_XZ_FN
def _xz_strip(src, n, dst, want):
    """``tiff_ext_decode.cpp``'s LZMA strip decoder (``ik_tiffx_set_xz``):
    liblzma's stream decoder, which libtiff's LZMA codec runs, through
    Python's ``lzma``. Writes the first ``want`` bytes of the .xz stream
    ``src[0, n)`` to ``dst`` and returns 0; -1 where the stream ends first,
    -4 where it does not decode (no exception crosses the C caller)."""
    try:
        out = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(
            ctypes.string_at(src, n), want)
    except Exception:  # LZMAError, MemoryError: the strip fails
        return -4
    if len(out) < want:
        return -1
    ctypes.memmove(dst, out, want)
    return 0


def load() -> ctypes.CDLL:
    """Build (if stale) and load the codec library; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                _build()
            lib = ctypes.CDLL(str(_LIB))
            lib.ik_tiffx_set_xz(_xz_strip)
            _configure(lib)
            _lib = lib
        return _lib


def _configure(lib: ctypes.CDLL) -> None:
    from imagekit_tpu_torch.codecs import tiff
    from imagekit_tpu_torch.codecs.native import jpeg_abi

    jpeg_abi.configure(lib)
    tiff.configure(lib)
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
