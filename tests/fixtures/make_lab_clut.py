"""Write ``imagekit_tpu_torch/ops/lab_srgb_clut.npy``: the lattice through
which Pillow converts CIELab to RGB.

Pillow's ``Image.convert("RGB")`` of a ``LAB`` image goes through
littleCMS (``ImageCms.buildTransform`` from its built-in Lab profile, a V2
Lab identity on D50, to its built-in sRGB profile, perceptual intent, no
flags). littleCMS optimises that 8-bit transform into one 33 x 33 x 33
lattice of 16-bit RGB nodes (``OptimizeByResampling``), each node the
transform's float pipeline at the node's Lab words, which it then
interpolates tetrahedrally in 16-bit fixed point
(``ops/color.py::lab_to_rgb``). This script asks the littleCMS library
that Pillow's wheel carries for the nodes: a transform of the same
profiles and intent with its optimisation off, from Lab to RGB words,
evaluated at the lattice's inputs (``_cmsQuantizeVal(i, 33)``), is the
pipeline the lattice samples. ``tests/test_torch_tiff_lab_ycbcr.py``
holds the table and the interpolation to Pillow's conversion on all 2^24
inputs.

Run from the repository root: ``python tests/fixtures/make_lab_clut.py``.
"""

import ctypes
import glob
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "imagekit_tpu_torch", "ops", "lab_srgb_clut.npy")
GRID = 33

_PT_RGB, _PT_LAB = 4, 10
_NOOPTIMIZE = 0x0100


def _fmt(space: int) -> int:
    """A littleCMS pixel type: three 16-bit channels of ``space``."""
    return space << 16 | 3 << 3 | 2


def _lcms() -> ctypes.CDLL:
    """littleCMS as Pillow's wheel carries it (``pillow.libs``)."""
    import PIL

    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                        "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "liblcms2-*.so*"))[0])
    lib.cmsCreateLab2Profile.restype = ctypes.c_void_p
    lib.cmsCreateLab2Profile.argtypes = [ctypes.c_void_p]
    lib.cmsCreate_sRGBProfile.restype = ctypes.c_void_p
    lib.cmsCreateTransform.restype = ctypes.c_void_p
    lib.cmsCreateTransform.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_void_p, ctypes.c_uint32,
                                       ctypes.c_uint32, ctypes.c_uint32]
    lib.cmsDoTransform.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_uint32]
    for name in ("cmsDeleteTransform", "cmsCloseProfile"):
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    return lib


def clut() -> np.ndarray:
    """The (33, 33, 33, 3) u16 nodes, indexed by the L, a and b nodes."""
    lib = _lcms()
    lab, srgb = lib.cmsCreateLab2Profile(None), lib.cmsCreate_sRGBProfile()
    xform = lib.cmsCreateTransform(lab, _fmt(_PT_LAB), srgb, _fmt(_PT_RGB),
                                   0, _NOOPTIMIZE)
    q = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5)
    nodes = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(
        -1, 3).astype(np.uint16)
    out = np.zeros_like(nodes)
    lib.cmsDoTransform(xform, nodes.ctypes.data, out.ctypes.data, len(nodes))
    lib.cmsDeleteTransform(xform)
    lib.cmsCloseProfile(lab)
    lib.cmsCloseProfile(srgb)
    return out.reshape(GRID, GRID, GRID, 3)


if __name__ == "__main__":
    np.save(OUT, clut())
    print(f"wrote {OUT}", file=sys.stderr)
