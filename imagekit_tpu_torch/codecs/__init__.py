"""Host codecs of the port: format detection and the native codec glue.

:class:`SourceFormat` and :func:`guess_format` are copies of
``imagekit_tpu/codecs/__init__.py`` (magic-byte detection, the analogue of
``image::guess_format`` at ``src/transform.rs:28`` and ``src/fetch.rs:104``).
The port decodes and encodes through :mod:`.native` (JPEG entropy, VP8
encode, PNG decode) only; there is no host-library fallback.
"""

from __future__ import annotations

import enum
from typing import Optional

from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import TransformError


class SourceFormat(str, enum.Enum):
    """Decodable input container formats (superset of the three output
    formats, like the ``image`` crate's format enum)."""

    jpeg = "jpeg"
    png = "png"
    webp = "webp"
    avif = "avif"
    gif = "gif"
    bmp = "bmp"
    tiff = "tiff"
    # long-tail formats (round 5): the full image::guess_format magic
    # table. The REFERENCE detects these but rejects them at decode (its
    # image crate is built default-features=false with only
    # jpeg/png/webp/avif enabled, Cargo.toml:20); we decode them —
    # ledger'd superset divergence (docs/PARITY_REPORT.md input matrix).
    ico = "ico"
    qoi = "qoi"
    pnm = "pnm"
    dds = "dds"
    hdr = "hdr"
    exr = "exr"
    farbfeld = "farbfeld"

    @property
    def as_output(self) -> Optional[ImageFormat]:
        """Map to a supported transformation format when possible
        (``src/transform.rs:35-40``)."""
        return {
            SourceFormat.jpeg: ImageFormat.jpeg,
            SourceFormat.webp: ImageFormat.webp,
            SourceFormat.avif: ImageFormat.avif,
        }.get(self)


def guess_format(data: bytes) -> SourceFormat:
    """Magic-byte container detection; raises TransformError when the format
    cannot be detected (parity with ``image::guess_format`` failing on
    garbage/empty input, covered by the reference's own tests
    ``tests/transform.rs:102-120``)."""
    if len(data) >= 3 and data[:3] == b"\xff\xd8\xff":
        return SourceFormat.jpeg
    if len(data) >= 8 and data[:8] == b"\x89PNG\r\n\x1a\n":
        return SourceFormat.png
    if len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return SourceFormat.webp
    if len(data) >= 12 and data[4:8] == b"ftyp":
        brand = data[8:12]
        if brand in (b"avif", b"avis", b"mif1", b"msf1"):
            return SourceFormat.avif
    if len(data) >= 6 and data[:6] in (b"GIF87a", b"GIF89a"):
        return SourceFormat.gif
    if len(data) >= 2 and data[:2] == b"BM":
        return SourceFormat.bmp
    if len(data) >= 4 and data[:4] in (b"II*\x00", b"MM\x00*"):
        return SourceFormat.tiff
    # long-tail magic table (the rest of image::guess_format's list;
    # TGA has no magic, so it is undetectable there AND here)
    if len(data) >= 4 and data[:4] == b"\x00\x00\x01\x00":
        return SourceFormat.ico
    if len(data) >= 4 and data[:4] == b"qoif":
        return SourceFormat.qoi
    if (
        len(data) >= 3
        and data[0:1] == b"P"
        and data[1:2] in b"1234567"
        and data[2:3] in b" \t\n\r"
    ):
        return SourceFormat.pnm
    if len(data) >= 4 and data[:4] == b"DDS ":
        return SourceFormat.dds
    if data.startswith((b"#?RADIANCE", b"#?RGBE")):
        return SourceFormat.hdr
    if len(data) >= 4 and data[:4] == b"\x76\x2f\x31\x01":
        return SourceFormat.exr
    if len(data) >= 8 and data[:8] == b"farbfeld":
        return SourceFormat.farbfeld
    raise TransformError("unsupported or undetectable image format")
