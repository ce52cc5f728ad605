"""Write the AVIF sources of ``chip_smoke.py``'s phase 27 into
``tests/fixtures/avif/``, with the SHA-256 of libdav1d's planes of each
(``avif_planes.json``).

The card's machine has neither Pillow's AVIF writer nor libdav1d, so the
files and the planes the port's AV1 decoder must reproduce there are
made here: seven 1920x1080 pictures (``chip_smoke.synth_image``, its mild
noise included) written at quality 60 by Pillow (libavif with libaom) as the writer's users
would: 4:2:0 at its default speed; 4:4:4; 4:2:2; RGBA with
``chip_smoke.ramp_alpha``'s plane (an alpha with flat opaque rectangles,
``chip_smoke.with_alpha``'s, makes libaom code palette blocks in the alpha
item, which the port's decoder answers with 501); 4:2:0 re-tagged BT.709 (the planes
stay, the nclx matrix says 709); ``enable-cdef``; and speed 4, where the
encoder turns loop restoration on. Each entry of the JSON holds the
file's name, the decoded width and height, and the digest of the Y, U
and V planes (then the alpha item's Y plane) of libdav1d, read through
the JAX package's ``avif_native._decode_obu``. The hashes are of
libdav1d's output, not the port's: the smoke phase holds the port to
them, and ``tests/test_torch_avif_sources.py`` holds them to libdav1d.

Run from the repository root: ``python tests/fixtures/make_avif_sources.py``.
"""

import hashlib
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "tests", "fixtures", "avif")
QUALITY = 60

#: name -> (picture seed, Pillow's keywords, alpha, nclx matrix re-tag)
RECIPES = {
    "1080p_420": (2701, {}, False, None),
    "1080p_444": (2702, {"subsampling": "4:4:4"}, False, None),
    "1080p_422": (2707, {"subsampling": "4:2:2"}, False, None),
    "1080p_rgba": (2703, {}, True, None),
    "1080p_bt709": (2704, {}, False, 1),
    "1080p_cdef": (2705, {"advanced": [("enable-cdef", "1")]}, False, None),
    "1080p_speed4_lr": (2706, {"speed": 4}, False, None),
}


def retag_matrix(data: bytes, matrix: int) -> bytes:
    """The file with its colr/nclx matrix_coefficients set to ``matrix``."""
    i = data.find(b"colrnclx")
    off = i + 8 + 4
    return data[:off] + matrix.to_bytes(2, "big") + data[off + 2:]


def planes_digest(data: bytes):
    """(width, height, SHA-256 of libdav1d's planes of the colour item and
    of the alpha item's luma)."""
    from imagekit_tpu.codecs import avif_native as ref_avif

    info = ref_avif.parse_container(data)
    h = hashlib.sha256()
    y, u, v = ref_avif._decode_obu(info.obu, info.width, info.height)[:3]
    for p in (y, u, v):
        h.update(np.ascontiguousarray(p).tobytes())
    if info.alpha_obu:
        a = ref_avif._decode_obu(info.alpha_obu, info.width, info.height)[0]
        h.update(np.ascontiguousarray(a).tobytes())
    return info.width, info.height, h.hexdigest()


def main() -> int:
    sys.path.insert(0, ROOT)
    from PIL import Image

    import chip_smoke

    os.makedirs(OUT, exist_ok=True)
    table = {}
    for name, (seed, kw, alpha, matrix) in RECIPES.items():
        img = chip_smoke.synth_image(seed)
        if alpha:
            img = chip_smoke.ramp_alpha(img)
        buf = io.BytesIO()
        Image.fromarray(img, "RGBA" if alpha else "RGB").save(
            buf, "AVIF", quality=QUALITY, **kw)
        data = buf.getvalue()
        if matrix is not None:
            data = retag_matrix(data, matrix)
        with open(os.path.join(OUT, f"{name}.avif"), "wb") as f:
            f.write(data)
        w, h, digest = planes_digest(data)
        table[name] = {"file": f"{name}.avif", "width": w, "height": h,
                       "sha256": digest}
        print(f"{name}: {len(data) / 1e3:.1f} kB, {w}x{h}")
    with open(os.path.join(OUT, "avif_planes.json"), "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
