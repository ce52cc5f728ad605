"""Write the fixtures that ``chip_smoke.py``'s phases 20 and 21 read (the
card's machine has no Pillow), from seeds, with Pillow:

- ``g4_a4_300dpi.tif``: ``chip_smoke.text_page(700)``, a 2480x3508 bilevel
  page of text-like strokes, as a Group 4 TIFF;
- ``cmyk_1080p_q80_progressive.jpg``: the picture of ``cmyk_1080p_q80.jpg``
  (``chip_smoke.synth_image(500, noise=False)`` in CMYK) written
  progressive at q80 with C at 2x2;
- ``tiff_jpeg_rgb_1080p_q80.tif`` and ``tiff_jpeg_cmyk_1080p_q80.tif``:
  ``chip_smoke.synth_image(800, noise=False)`` as JPEG-compressed TIFFs at
  q80, in RGB (photometric 2, 16-row strips) and in CMYK (photometric 5,
  8-row strips), as Pillow's libtiff writes them.

Run from the root of a checkout:

    python tests/fixtures/make_pillow_fallbacks.py

``tests/test_torch_pillow_fallbacks.py`` checks that the committed files
are what this writes.
"""

import io
import struct
import sys
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

import chip_smoke  # noqa: E402


def g4_page() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(chip_smoke.text_page(chip_smoke.G4_SEED)).save(
        buf, "TIFF", compression="group4")
    return buf.getvalue()


def progressive_cmyk() -> bytes:
    buf = io.BytesIO()
    Image.fromarray(chip_smoke.synth_image(chip_smoke.CMYK_SEED, noise=False)
                    ).convert("CMYK").save(buf, "JPEG", quality=80,
                                           subsampling=2, progressive=True)
    return buf.getvalue()


def zero_gaps(data: bytes) -> bytes:
    """A little-endian TIFF with every byte that neither the header, the
    IFD, a tag's values nor a strip covers set to 0: libtiff leaves the
    byte that word-aligns the IFD unwritten, and Pillow's buffer holds
    whatever was there before."""
    size = {1: 1, 2: 1, 3: 2, 4: 4, 7: 1}
    ifd = struct.unpack("<I", data[4:8])[0]
    n = struct.unpack("<H", data[ifd:ifd + 2])[0]
    used = [(0, 8), (ifd, ifd + 2 + 12 * n + 4)]
    values = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack(
            "<HHII", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        nbytes = size[typ] * count
        at = ifd + 10 + 12 * i if nbytes <= 4 else raw
        used.append((at, at + nbytes))
        values[tag] = struct.unpack(f"<{count}{'HI'[typ == 4]}",
                                    data[at:at + nbytes]) if typ in (3, 4) \
            else None
    used += [(o, o + c) for o, c in zip(values[273], values[279])]
    keep = np.zeros(len(data), bool)
    for a, b in used:
        keep[a:b] = True
    return np.where(keep, np.frombuffer(data, np.uint8), 0).astype(
        np.uint8).tobytes()


def jpeg_tiff(mode: str):
    def make() -> bytes:
        buf = io.BytesIO()
        Image.fromarray(chip_smoke.synth_image(
            chip_smoke.TIFF_JPEG_SEED, noise=False)).convert(mode).save(
            buf, "TIFF", compression="jpeg", quality=80)
        return zero_gaps(buf.getvalue())
    return make


FIXTURES = {"g4_a4_300dpi.tif": g4_page,
            "cmyk_1080p_q80_progressive.jpg": progressive_cmyk,
            "tiff_jpeg_rgb_1080p_q80.tif": jpeg_tiff("RGB"),
            "tiff_jpeg_cmyk_1080p_q80.tif": jpeg_tiff("CMYK")}

if __name__ == "__main__":
    for name, make in FIXTURES.items():
        data = make()
        (HERE / name).write_bytes(data)
        print(f"{name}: {len(data)} bytes")
