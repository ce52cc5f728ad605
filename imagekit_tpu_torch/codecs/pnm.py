"""PNM sources (P1-P6) without Pillow.

The reference decodes PBM, PGM and PPM with Pillow
(``imagekit_tpu/codecs/pil_backend.py``); this module gives Pillow 12's
pixels (``PIL/PpmImagePlugin.py``) after its ``convert("RGB")``, with numpy
doing the per-sample work:

- the header is Pillow's token reader: whitespace-separated tokens of at
  most 10 characters, ``#`` comments to the end of the line, one
  whitespace character after the last token;
- P1 and P4 are bitonal, 1 black; P2 and P5 gray, P3 and P6 RGB;
- a ``maxval`` other than 255 rescales each sample to ``round(v / maxval
  * 255)`` with Python's rounding (half to even); a gray ``maxval`` above
  255 makes Pillow's 32-bit mode ``I`` (``round(v / maxval * 65535)``,
  raw for 65535), whose conversion to RGB clips at 255;
- a binary raster cut short is an error, and so is a plain (ASCII) one;
  a sample above ``maxval`` is clipped in a binary raster and an error in
  a plain one; comments may sit anywhere in a plain raster.

P7 (PAM), which Pillow does not read, is a
:class:`~imagekit_tpu_torch.errors.TransformError`, as in the reference.
The decompression-bomb ceiling is :data:`png.MAX_PIXELS`, after the header.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from imagekit_tpu_torch.codecs.png import MAX_PIXELS
from imagekit_tpu_torch.errors import TransformError

_WS = b" \t\n\x0b\x0c\r"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
          b"P6": "RGB"}
_COMMENT = re.compile(rb"#[^\r\n]*[\r\n]?")
_BLOCK = 65536  # Pillow's SAFEBLOCK: a plain raster is read in such blocks


def _token(data: bytes, pos: int) -> Tuple[bytes, int]:
    """Pillow's ``_read_token`` from ``pos``: (token, position after the
    whitespace that ended it)."""
    token = b""
    n = len(data)
    while len(token) <= 10:
        if pos >= n:
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WS:
            if not token:
                continue
            break
        if c == b"#":
            while pos < n and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1  # the CR or LF
            continue
        token += c
    if not token:
        raise TransformError("Reached EOF while reading header")
    if len(token) > 10:
        raise TransformError(f"Token too long in file header: {token!r}")
    return token, pos


def _int(token: bytes) -> int:
    try:
        return int(token)
    except ValueError:
        raise TransformError(f"invalid PNM header token {token!r}") from None


def _header(data: bytes):
    """(magic, mode, width, height, maxval, raster offset)."""
    magic = data[:2]
    if magic not in _MODES:
        raise TransformError("not a PPM file")  # P7 (PAM) among them
    mode = _MODES[magic]
    tok, pos = _token(data, 3)
    w = _int(tok)
    tok, pos = _token(data, pos)
    h = _int(tok)
    maxval = 1
    if mode != "1":
        tok, pos = _token(data, pos)
        maxval = _int(tok)
        if not 0 < maxval < 65536:
            raise TransformError(
                "maxval must be greater than 0 and less than 65536")
    if w <= 0 or h <= 0:
        raise TransformError("not identified by this driver")
    if w * h > MAX_PIXELS:
        raise TransformError(f"image is too large ({w}x{h} pixels)")
    return magic, mode, w, h, maxval, pos


def parse(data: bytes) -> Tuple[int, int, int]:
    """Header only: (width, height, 3)."""
    _, _, w, h, _, _ = _header(data)
    return w, h, 3


def _rescale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """``round(v / maxval * out_max)`` sample by sample, half to even, in
    float64 as Python computes it."""
    return np.round(v.astype(np.float64) / maxval * out_max).astype(np.int64)


def _plain_samples(body: bytes, n: int, maxval: int) -> np.ndarray:
    """The first ``n`` samples of a plain raster (comments removed)."""
    tokens = _COMMENT.sub(b"", body).split()[:n]
    if len(tokens) < n:
        raise TransformError("not enough image data")
    if max(map(len, tokens)) > 10:
        raise TransformError("Token too long found in data")
    try:
        v = np.array(tokens).astype(np.int64)
    except ValueError:
        raise TransformError("invalid PNM sample") from None
    if (v < 0).any():
        raise TransformError("Channel value is negative")
    if (v > maxval).any():
        raise TransformError("Channel value too large for this mode")
    return v


def _plain_bits(body: bytes, n: int) -> np.ndarray:
    """P1: every non-space byte is a sample, validated block by block as
    Pillow reads them."""
    bits = bytearray()
    pos = 0
    spans = False  # a comment continuing from the previous block
    while len(bits) < n and pos < len(body):
        block = body[pos:pos + _BLOCK]
        pos += _BLOCK
        if spans:
            end = re.search(rb"[\r\n]", block)
            if end is None:
                continue
            block = block[end.end():]
            spans = False
        cut = block.rfind(b"#")
        if cut >= 0 and re.search(rb"[\r\n]", block[cut:]) is None:
            block, spans = block[:cut], True
        block = b"".join(_COMMENT.sub(b"", block).split())
        if block.translate(None, b"01"):
            raise TransformError("Invalid token for this mode")
        bits += block
    if len(bits) < n:
        raise TransformError("not enough image data")
    return np.frombuffer(bytes(bits[:n]), np.uint8) == ord("0")


def decode(data: bytes) -> np.ndarray:
    """P1-P6 -> (H, W, 3) u8, as Pillow's ``convert("RGB")`` gives it."""
    magic, mode, w, h, maxval, pos = _header(data)
    bands = 3 if mode == "RGB" else 1
    n = w * h * bands
    body = data[pos:]
    if magic == b"P1":
        px = np.where(_plain_bits(body, n), 255, 0)
    elif magic == b"P4":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise TransformError("image file is truncated")
        bits = np.unpackbits(np.frombuffer(body, np.uint8, stride * h)
                             .reshape(h, stride), axis=1)[:, :w]
        px = np.where(bits == 0, 255, 0)
    else:
        wide = mode == "L" and maxval > 255  # Pillow's mode "I"
        out_max = 65535 if wide else 255
        if magic in (b"P2", b"P3"):
            px = _rescale(_plain_samples(body, n, maxval), maxval, out_max)
        else:
            two = maxval > 255
            need = n * (2 if two else 1)
            if len(body) < need:
                raise TransformError("image file is truncated")
            v = np.frombuffer(body, ">u2" if two else np.uint8, n)
            if maxval == 255:  # the raw samples
                px = v.copy()
            elif wide and maxval == 65535:
                px = v
            else:
                px = np.minimum(out_max, _rescale(v, maxval, out_max))
        if wide:
            px = np.minimum(px, 255)  # mode "I" -> RGB clips
    px = px.astype(np.uint8, copy=False).reshape(h, w, bands)
    return np.repeat(px, 3, axis=2) if bands == 1 else px
