"""Remote source fetch for the port's ``/img``.

Counterpart of ``imagekit_tpu/fetch.py:92-194`` (``fetch_source``), with
the reference's :class:`~imagekit_tpu.fetch.Fetcher` and its stages 1-4
as they are: status, ``image/*`` content type when parseable, the
content-length preflight and the streamed byte count. Stage 5 differs: the
reference decodes a PNG in full to validate it, through a decoder that
imports Pillow; here every source is validated by its header only, and
the engine decodes it once, on its codec pool. A source the header check
cannot place is left to the engine, which answers it with a
:class:`~imagekit_tpu_torch.errors.NotPortedError` or a decode error.
"""

from __future__ import annotations

from typing import Optional, Tuple

from imagekit_tpu.codecs import SourceFormat, guess_format
from imagekit_tpu.codecs.native import jpeg_abi, loader
from imagekit_tpu.errors import InvalidArgumentError, NetworkError, TransformError
from imagekit_tpu.fetch import Fetcher, _default_fetcher
from imagekit_tpu_torch.codecs import png


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
        if src == SourceFormat.png:
            w, h, _ = png.parse(data)
        elif src == SourceFormat.jpeg and (lib := loader.load()) is not None:
            try:
                hdr = jpeg_abi.parse(lib, data)
            except jpeg_abi.NativeJpegError:
                return data, ct  # the engine classifies it
            w, h = hdr.width, hdr.height
        else:
            return data, ct
    except TransformError:
        raise InvalidArgumentError("Unable to decode image for validation")
    if w <= 0 or h <= 0:
        raise InvalidArgumentError("Invalid image dimensions")
    return data, ct
