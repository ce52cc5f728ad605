"""Write the two fixtures that ``chip_smoke.py``'s phase 20 reads (the
card's machine has no Pillow), from seeds, with Pillow:

- ``g4_a4_300dpi.tif``: ``chip_smoke.text_page(700)``, a 2480x3508 bilevel
  page of text-like strokes, as a Group 4 TIFF;
- ``cmyk_1080p_q80_progressive.jpg``: the picture of ``cmyk_1080p_q80.jpg``
  (``chip_smoke.synth_image(500, noise=False)`` in CMYK) written
  progressive at q80 with C at 2x2.

Run from the root of a checkout:

    python tests/fixtures/make_pillow_fallbacks.py

``tests/test_torch_pillow_fallbacks.py`` checks that the committed files
are what this writes.
"""

import io
import sys
from pathlib import Path

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


FIXTURES = {"g4_a4_300dpi.tif": g4_page,
            "cmyk_1080p_q80_progressive.jpg": progressive_cmyk}

if __name__ == "__main__":
    for name, make in FIXTURES.items():
        data = make()
        (HERE / name).write_bytes(data)
        print(f"{name}: {len(data)} bytes")
