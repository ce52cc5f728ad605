"""Host codecs of the port: format detection and the native codec glue.

:class:`SourceFormat` and :func:`guess_format` are copies of
``imagekit_tpu/codecs/__init__.py`` (magic-byte detection, the analogue of
``image::guess_format`` at ``src/transform.rs:28`` and ``src/fetch.rs:104``).

:func:`decode_bytes` and :func:`encode_bytes` are the reference's
dispatchers (``:115-239``) over the port's decoders and encoders, all on
:mod:`.native` with no Pillow: PNG (:mod:`.png`), WebP lossy, lossless and
extended (:mod:`.vp8`), GIF and BMP (:mod:`.misc`), TIFF (:mod:`.tiff`),
Radiance HDR and farbfeld (:mod:`.longtail`), JPEG pixels in every layout
the pixel decode takes, CMYK and YCCK included (:mod:`.jpeg`, whose DCT
and colour stages run on the device: the reference's serving path decodes
JPEG pixels with Pillow), and the sources the reference decodes only with
Pillow: ICO (:mod:`.ico`), PNM (:mod:`.pnm`), QOI (:mod:`.qoi`) and DDS
(:mod:`.dds`); JPEG, WebP and AVIF (the first-party encoder,
:mod:`.avif_encode`) out. There is no host-library fallback: where the
reference falls to Pillow or libdav1d for a variant a native decoder does
not take, or for AVIF sources, the port raises
:class:`~imagekit_tpu_torch.errors.NotPortedError`.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np

from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.errors import NotPortedError, TransformError


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


def decode_bytes(data: bytes, device=None) -> Tuple[np.ndarray, SourceFormat]:
    """Decode to an HWC uint8 array (RGB, or RGBA when the source carries
    alpha). Raises TransformError on malformed input and NotPortedError for
    a source the port has no decoder for. ``device`` (the card unless the
    caller names another) runs the DCT and colour stages of a JPEG."""
    fmt = guess_format(data)
    if fmt == SourceFormat.png:
        from imagekit_tpu_torch.codecs import png

        return png.decode(data), fmt
    if fmt == SourceFormat.webp:
        from imagekit_tpu_torch.codecs import vp8

        try:
            arr = vp8.decode_rgb(data)
        except ValueError as e:
            raise TransformError(str(e)) from e
        if arr is None:
            raise NotPortedError(
                "a WebP the native decoders do not take (the host-library "
                "fallback)", "queue 1 item 9")
        return arr, fmt
    if fmt in (SourceFormat.gif, SourceFormat.bmp):
        from imagekit_tpu_torch.codecs import misc

        return (misc.decode_gif(data) if fmt == SourceFormat.gif
                else misc.decode_bmp(data)), fmt
    if fmt == SourceFormat.tiff:
        from imagekit_tpu_torch.codecs import tiff

        return tiff.decode(data), fmt
    if fmt in (SourceFormat.hdr, SourceFormat.farbfeld):
        from imagekit_tpu_torch.codecs import longtail

        return (longtail.decode_hdr(data) if fmt == SourceFormat.hdr
                else longtail.decode_farbfeld(data)), fmt
    if fmt == SourceFormat.jpeg:
        from imagekit_tpu_torch.codecs import jpeg

        return jpeg.decode_rgb(data, device=device), fmt
    if fmt in (SourceFormat.ico, SourceFormat.pnm, SourceFormat.qoi,
               SourceFormat.dds):
        from imagekit_tpu_torch.codecs import dds, ico, pnm, qoi

        mod = {SourceFormat.ico: ico, SourceFormat.pnm: pnm,
               SourceFormat.qoi: qoi, SourceFormat.dds: dds}[fmt]
        return mod.decode(data), fmt
    if fmt == SourceFormat.exr:
        # detected so the error names the format; the reference rejects
        # EXR too
        raise TransformError("EXR input is not supported")
    if fmt == SourceFormat.avif:
        raise NotPortedError("avif sources", "queue 1 item 8")
    raise TransformError(f"no decoder for {fmt.value} sources")


def encode_bytes(img: np.ndarray, fmt: ImageFormat, quality: int,
                 device=None) -> bytes:
    """Encode an HWC uint8 array (RGB or RGBA). Quality is clamped to
    [1, 100] like every encoder arm of the upstream service
    (``src/transform.rs:122-139``). JPEG: the fDCT on ``device`` (the card
    unless named), Huffman on the host. WebP: host colour conversion and
    the host VP8 encoder. JPEG and WebP drop alpha. AVIF: host colour
    conversion and the first-party AV1 encoder (:mod:`.avif_encode`),
    which keeps a real alpha plane and drops an all-255 one, as the
    reference's ``pil_backend.encode`` does."""
    q = int(min(max(quality, 1), 100))
    if fmt == ImageFormat.jpeg:
        from imagekit_tpu_torch.codecs import jpeg

        return jpeg.encode_rgb(_to_rgb(img), q, device=device)
    if fmt == ImageFormat.webp:
        from imagekit_tpu_torch.codecs import vp8

        return vp8.encode_rgb(_to_rgb(img), q)
    if fmt == ImageFormat.avif:
        from imagekit_tpu_torch.codecs import avif_encode

        if img.ndim == 2:
            img = _to_rgb(img)
        return avif_encode.encode_rgb(img, q)
    raise NotPortedError(f"{fmt.value} output from pixels", "queue 1 item 9")


def _to_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    if img.shape[2] == 4:
        return img[:, :, :3]
    return img
