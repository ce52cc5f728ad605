"""Remote source fetch for the port's ``/img``.

Counterpart of ``imagekit_tpu/fetch.py:92-194`` (``fetch_source``), with
a copy of the reference's :class:`Fetcher` (one shared aiohttp session; a
test substitutes an offline one) and its stages 1-4 as they are: status,
``image/*`` content type when parseable, the content-length preflight and
the streamed byte count. Stage 5 differs: the
reference decodes a PNG, GIF, BMP, TIFF, ICO, PNM, QOI or DDS, or a JPEG
whose header its native parser refuses, in full to validate it, through
decoders that import Pillow; here every such source, like a JPEG or a
WebP, is validated by its header only (the native ``ik_*_parse`` calls and
the port's header parsers), and the engine decodes it once, on its codec
pool (a source whose data then fails to decode is answered by ``/img`` with
this stage's body, :class:`~imagekit_tpu_torch.errors.SourceDecodeError`).
A JPEG whose header the native parser refuses answers here as the
reference's Pillow decode does ("Unable to decode image for validation"),
unless it refuses it as unsupported (-3): a CMYK or YCCK JPEG, baseline or
progressive, a baseline frame in several scans, an arithmetic-coded or a
lossless frame, is then validated by the port's own parser
(``codecs/jpeg.py::source_header``), and refused here where Pillow or
libjpeg refuse it, as the reference's Pillow decode does here: a frame
whose precision is not 8 bits or whose component count is not 1, 3 or 4,
a sampling libjpeg refuses, a hierarchical or lossless arithmetic frame,
a lossless one that needs a colour conversion; data the reference's full
decode would then find cut short is the engine's
:class:`~imagekit_tpu_torch.errors.SourceDecodeError`, answered with this
stage's body. A BMP or TIFF that the pinned parser refuses as
unsupported is validated by the port's own parser of those layouts
(``misc.parse_bmp``, ``tiff.parse``); what that one refuses as corrupt, as
Pillow would, is this stage's 400. A JPEG-compressed TIFF is validated by
its IFD (segment ranges inside the file); a segment that then does not
decode is the engine's :class:`~imagekit_tpu_torch.errors.
SourceDecodeError`, answered with this stage's body.
"""

from __future__ import annotations

from typing import Optional, Tuple

from imagekit_tpu_torch.codecs import (
    SourceFormat,
    dds,
    guess_format,
    ico,
    jpeg,
    misc,
    png,
    pnm,
    qoi,
    tiff,
    vp8,
)
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.errors import (
    InvalidArgumentError,
    NetworkError,
    NotPortedError,
    TransformError,
)

# header-only parsers of the sources that have one beside their decoder
_PARSERS = {
    SourceFormat.png: png.parse,
    SourceFormat.gif: misc.parse_gif,
    SourceFormat.bmp: misc.parse_bmp,
    SourceFormat.tiff: tiff.parse,
    SourceFormat.ico: ico.parse,
    SourceFormat.pnm: pnm.parse,
    SourceFormat.qoi: qoi.parse,
    SourceFormat.dds: dds.parse,
}


class Fetcher:
    """Shared-session remote fetcher. Subclass / substitute in tests for an
    offline backend (the reference's tests never reach the network;
    SURVEY.md §4)."""

    def __init__(self) -> None:
        self._session = None

    async def _get_session(self):
        import aiohttp

        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30)
            )
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    async def fetch(self, url: str) -> Tuple[int, str, "_BodyStream"]:
        """Return (status, content_type, body stream). NetworkError on
        transport failure."""
        import aiohttp

        session = await self._get_session()
        try:
            resp = await session.get(url)
        except aiohttp.ClientError as e:
            raise NetworkError(str(e)) from e
        ct = resp.headers.get("Content-Type", "")
        return resp.status, ct, _AiohttpBody(resp)


class _BodyStream:
    async def content_length(self) -> Optional[int]:
        raise NotImplementedError

    async def chunks(self):
        raise NotImplementedError

    async def release(self) -> None:
        pass


class _AiohttpBody(_BodyStream):
    def __init__(self, resp) -> None:
        self._resp = resp

    async def content_length(self) -> Optional[int]:
        return self._resp.content_length

    async def chunks(self):
        async for chunk in self._resp.content.iter_chunked(64 * 1024):
            yield chunk

    async def release(self) -> None:
        self._resp.release()


async def fetch_source(
    url: str, max_size: int, *, fetcher: Optional[Fetcher] = None
) -> Tuple[bytes, str]:
    """Fetch and validate; returns (bytes, content type). Raises
    NetworkError / InvalidArgumentError as the reference does."""
    f = fetcher or _default_fetcher()
    status, ct, body = await f.fetch(url)
    try:
        if not (200 <= status < 300):
            raise NetworkError(f"Upstream status: {status}")
        mime_main = ct.split(";", 1)[0].strip().lower()
        if "/" in mime_main and mime_main.split("/", 1)[0] != "image":
            raise InvalidArgumentError("Source is not an image")
        clen = await body.content_length()
        if clen is not None and clen > max_size:
            raise InvalidArgumentError("Input exceeds size limit")
        buf = bytearray()
        async for chunk in body.chunks():
            if len(buf) + len(chunk) > max_size:
                raise InvalidArgumentError("Input exceeds size limit")
            buf.extend(chunk)
        data = bytes(buf)
    finally:
        await body.release()

    try:
        src = guess_format(data)
        if src in _PARSERS:
            try:
                w, h, _ = _PARSERS[src](data)
            except NotPortedError:
                return data, ct  # the engine answers it
        elif src == SourceFormat.jpeg:
            hdr = _jpeg_header(data)
            if hdr is None:
                return data, ct  # the engine answers it (501)
            w, h = hdr.width, hdr.height
        elif src == SourceFormat.webp:
            # header-only, as the reference's: the engine decodes once, on
            # its YUV-domain path
            dims = vp8.dimensions(data)
            if dims is None:
                return data, ct  # an exotic container: the engine's decode
            w, h = dims
        else:
            return data, ct
    except TransformError:
        raise InvalidArgumentError("Unable to decode image for validation")
    if w <= 0 or h <= 0:
        raise InvalidArgumentError("Invalid image dimensions")
    return data, ct


def _jpeg_header(data: bytes):
    """The header of a JPEG the port decodes, None for one the native
    parsers refuse as unsupported (-3); anything else they refuse is the
    reference's validation failure (a
    :class:`~imagekit_tpu_torch.errors.TransformError` of
    ``jpeg.source_header`` is raised to the caller, which answers it so)."""
    try:
        return jpeg.source_header(loader.load(), data)
    except jpeg_abi.NativeJpegError as e:
        if e.code == -3:
            return None
        raise InvalidArgumentError(
            "Unable to decode image for validation") from None


_GLOBAL_FETCHER: Optional[Fetcher] = None


def _default_fetcher() -> Fetcher:
    global _GLOBAL_FETCHER
    if _GLOBAL_FETCHER is None:
        _GLOBAL_FETCHER = Fetcher()
    return _GLOBAL_FETCHER
