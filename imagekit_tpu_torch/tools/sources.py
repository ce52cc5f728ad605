"""Source files of every class the port decodes, written without Pillow.

The writers of ``chip_smoke.py`` and of the soak (``tools/soak.py``), in
one copy: numpy, ``struct`` and ``zlib``, and the port's own encoders
(the native Huffman and VP8 encoders, the first-party AV1 encoder), so
that they run where Pillow is absent, as on the card's machine. Each
returns the bytes of one file (the BCn writer also what a decoder must
give):

- :func:`make_jpeg` (4:2:0, 4:2:2, 4:4:0, 4:4:4, grayscale), :func:`make_png`
  (RGB, RGBA) and :func:`make_png_palette`, :func:`make_bmp`,
  :func:`make_tiff`, :func:`make_gif`, :func:`make_webp` (lossy),
  :func:`make_webp_alpha` (VP8X with a raw ALPH chunk) and
  :func:`make_webp_lossless` (VP8L);
- the BMP and TIFF layouts past the pinned decoders: :func:`make_bmp_fields`
  (bit fields, BITMAPCOREHEADER), :func:`make_bilevel_tiff`,
  :func:`make_cmyk_tiff` and :func:`make_jpeg_tiff` (strips or tiles, on
  :func:`tiff_file` / :func:`tiff_ifd`);
- the long tail: :func:`make_pnm`, :func:`make_qoi`, :func:`make_dds`,
  :func:`make_ico`, :func:`make_farbfeld` and :func:`make_hdr` (as the
  reference's soak writes them, ``tools/soak.py:110-127``);

The pictures: :func:`synth_image` (1080p by default: gradient, hard-edged
rectangles, noise) and :func:`soak_image` (the reference soak's gradient
and noise at any size).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def soak_image(rng: np.random.Generator, w: int, h: int,
               gray: bool = False) -> np.ndarray:
    """The reference soak's picture (``tools/soak.py:40-48``): an x/y
    gradient and their sum mod 256, plus noise of sigma 20 from ``rng``;
    one channel with ``gray``."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                     (xx + yy) % 256], axis=-1)
    base = np.clip(base + rng.normal(0, 20, base.shape), 0, 255)
    a = base.astype(np.uint8)
    return a[:, :, 0] if gray else a


def synth_image(seed: int, w: int = 1920, h: int = 1080,
                noise: bool = True) -> np.ndarray:
    """Seeded RGB image: a smooth gradient, hard-edged rectangles (their
    edges give low-frequency AC levels beyond int8 at high quality, i.e.
    escapes) and, unless ``noise`` is False, mild noise."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    phase = rng.random(3).astype(np.float32)
    img = 127.5 + 100.0 * np.sin(
        2 * np.pi * (x * (1 + phase) + y * (1.5 - phase))
    )
    img = np.broadcast_to(img, (h, w, 3)).copy()
    for _ in range(24):
        x0, y0 = rng.integers(0, w - 64), rng.integers(0, h - 64)
        x1 = x0 + rng.integers(32, 400)
        y1 = y0 + rng.integers(32, 300)
        img[y0:y1, x0:x1] = rng.integers(0, 256, 3)
    if noise:
        img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def make_jpeg(seed: int, quality: int, image=synth_image, samp=(2, 2),
              gray: bool = False) -> bytes:
    """JPEG without Pillow: the port's numpy fDCT + the native Huffman
    encoder. ``samp`` is the luma's (h, v) sampling factors against the
    chroma's 1: (2, 2) 4:2:0, (2, 1) 4:2:2, (1, 2) 4:4:0, (1, 1) 4:4:4;
    ``gray`` writes the luma alone."""
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    img = image(seed)
    planes, qt = host_encode_rgb_to_coefficients(img, quality, samp)
    return loader.encode_jpeg(planes[:1] if gray else planes, qt,
                              img.shape[1], img.shape[0], samp)


def make_png(img: np.ndarray) -> bytes:
    """RGB or RGBA PNG (colour type 2 or 6, by the channel count) without
    Pillow: filter 0 on every row, zlib level 1."""
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if img.shape[2] == 4 else 2,
                       0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def make_bmp(img: np.ndarray) -> bytes:
    """24 bpp bottom-up BI_RGB BMP, written with ``struct``."""
    h, w = img.shape[:2]
    pad = (-3 * w) % 4
    rows = np.zeros((h, 3 * w + pad), np.uint8)
    rows[:, :3 * w] = img[::-1, :, ::-1].reshape(h, 3 * w)
    body = rows.tobytes()
    return (b"BM" + struct.pack("<IHHI", 54 + len(body), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(body), 2835,
                          2835, 0, 0) + body)


def make_tiff(img: np.ndarray) -> bytes:
    """Uncompressed little-endian RGB TIFF, one strip, written with
    ``struct``."""
    h, w = img.shape[:2]
    body = img.tobytes()
    bits_off = 8 + len(body)
    ifd_off = bits_off + 6
    entries = [(256, 3, 1, w), (257, 3, 1, h), (258, 3, 3, bits_off),
               (259, 3, 1, 1), (262, 3, 1, 2), (273, 4, 1, 8), (277, 3, 1, 3),
               (278, 3, 1, h), (279, 4, 1, len(body)), (284, 3, 1, 1)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", *e) for e in entries) + struct.pack("<I", 0)
    return (b"II*\x00" + struct.pack("<I", ifd_off) + body
            + struct.pack("<HHH", 8, 8, 8) + ifd)


def make_gif(img: np.ndarray) -> bytes:
    """GIF87a without Pillow: a 3-3-2 bit RGB palette and LZW with a clear
    code before the table can grow (every code stays 9 bits wide, so the
    stream packs with numpy)."""
    h, w = img.shape[:2]
    idx = ((img[..., 0] >> 5) << 5 | (img[..., 1] >> 5) << 2
           | img[..., 2] >> 6).astype(np.uint16).ravel()
    pal = np.array([[(i >> 5) * 255 // 7, ((i >> 2) & 7) * 255 // 7,
                     (i & 3) * 255 // 3] for i in range(256)], np.uint8)
    run = 250  # data codes between clear codes: 258 + run < 512
    n = len(idx)
    groups = -(-n // run)
    codes = np.full((groups, run + 1), 256, np.uint16)  # 256: clear
    padded = np.full(groups * run, 257, np.uint16)
    padded[:n] = idx
    codes[:, 1:] = padded.reshape(groups, run)
    codes = np.concatenate([codes.ravel()[: groups + n], [257]])  # 257: end
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8).ravel()
    data = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return (b"GIF87a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + pal.tobytes()
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08" + blocks
            + b"\x00;")


def make_webp(img: np.ndarray, quality: int) -> bytes:
    """Lossy WebP without Pillow: BT.601 studio-range planes (a 2x2 box for
    the chroma) through the port's own VP8 encoder."""
    from imagekit_tpu_torch.codecs import vp8

    rgb = img.astype(np.float32)
    h, w = rgb.shape[:2]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0

    def half(c):
        c = np.pad(c, ((0, h & 1), (0, w & 1)), mode="edge")
        return c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))

    def q8(p):
        return np.clip(np.floor(p + 0.5), 0, 255).astype(np.uint8)

    return vp8.encode_yuv420(q8(y), q8(half(cb)), q8(half(cr)), quality)


def _riff(chunks) -> bytes:
    body = b"".join(tag + struct.pack("<I", len(data)) + data
                    + b"\0" * (len(data) & 1) for tag, data in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


class _Bits:
    """VP8L's bit writer: values packed least significant bit first."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def put(self, value: int, bits: int) -> None:
        self.acc |= (value & ((1 << bits) - 1)) << self.n
        self.n += bits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def bytes(self) -> bytes:
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def make_webp_lossless(img: np.ndarray) -> bytes:
    """Lossless WebP (VP8L) without Pillow: no transforms and no colour
    cache; green, red, blue and alpha each a prefix code of all 256 values
    at 8 bits (green's 24 length codes at 0), written as normal codes whose
    code-length code has two symbols (0 and 8) of one bit; the distance
    code a simple code of one symbol."""
    h, w = img.shape[:2]
    rgba = img if img.shape[2] == 4 else np.dstack(
        [img, np.full((h, w), 255, np.uint8)])
    b = _Bits()
    b.put(0x2F, 8)
    b.put(w - 1, 14)
    b.put(h - 1, 14)
    b.put(int(img.shape[2] == 4), 1)
    b.put(0, 3)          # version
    b.put(0, 1)          # no transform
    b.put(0, 1)          # no colour cache
    b.put(0, 1)          # no meta prefix codes
    order = [17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8]
    for alphabet in (256 + 24, 256, 256, 256):
        b.put(0, 1)      # a normal code
        b.put(len(order) - 4, 4)
        for sym in order:
            b.put(1 if sym in (0, 8) else 0, 3)
        b.put(0, 1)      # every symbol's length follows
        for i in range(alphabet):
            b.put(1 if i < 256 else 0, 1)  # '1' is length 8, '0' length 0
    b.put(1, 1)          # distance: a simple code
    b.put(0, 1)          # of one symbol
    b.put(0, 1)          # coded in one bit
    b.put(0, 1)          # symbol 0
    px = rgba.reshape(-1, 4)
    codes = _REV8[px[:, [1, 0, 2, 3]]].astype(np.uint64)  # G, R, B, A
    words = (codes[:, 0] | codes[:, 1] << np.uint64(8)
             | codes[:, 2] << np.uint64(16) | codes[:, 3] << np.uint64(24))
    for word in words.tolist():
        b.put(word, 32)
    return _riff([(b"VP8L", b.bytes())])


def make_webp_alpha(img: np.ndarray, quality: int) -> bytes:
    """Lossy WebP with alpha without Pillow: a VP8X container, an ALPH
    chunk of raw alpha (no compression, no filter), then the VP8 chunk of
    :func:`make_webp` of the colour."""
    h, w = img.shape[:2]
    vp8 = make_webp(img[..., :3], quality)
    frame = vp8[12:]
    vp8x = struct.pack("<I", 0x10) + (w - 1).to_bytes(3, "little") \
        + (h - 1).to_bytes(3, "little")  # the alpha flag, the canvas
    tag, n = frame[:4], struct.unpack("<I", frame[4:8])[0]
    return _riff([(b"VP8X", vp8x),
                  (b"ALPH", b"\0" + img[..., 3].tobytes()),
                  (tag, frame[8:8 + n])])


def make_pnm(img: np.ndarray) -> bytes:
    """Binary PPM (P6, maxval 255)."""
    h, w = img.shape[:2]
    return b"P6\n%d %d\n255\n" % (w, h) + img.tobytes()


def make_qoi(img: np.ndarray) -> bytes:
    """RGBA QOI without Pillow: a QOI_OP_RUN (62 pixels at most) for each
    stretch of repeats, else QOI_OP_RGB where the alpha is the previous
    pixel's and QOI_OP_RGBA where it is not, built with numpy."""
    h, w = img.shape[:2]
    px = np.ascontiguousarray(img).reshape(-1, 4)
    prev = np.vstack([np.array([[0, 0, 0, 255]], np.uint8), px[:-1]])
    same = (px == prev).all(axis=1)
    edge = np.diff(np.concatenate([[0], same.astype(np.int8), [0]]))
    starts, ends = np.flatnonzero(edge == 1), np.flatnonzero(edge == -1)
    lens = ends - starts
    k = (lens + 61) // 62
    rid = np.repeat(np.arange(len(starts)), k)
    j = np.arange(int(k.sum())) - np.repeat(np.cumsum(k) - k, k)
    run_pos = starts[rid] + 62 * j
    run_len = np.minimum(62, lens[rid] - 62 * j)
    lit = np.flatnonzero(~same)
    rgba = px[lit, 3] != prev[lit, 3]
    rows = np.zeros((len(lit) + len(run_pos), 5), np.uint8)
    size = np.ones(len(rows), np.int64)
    rows[:len(lit), 0] = np.where(rgba, 0xFF, 0xFE)
    rows[:len(lit), 1:] = px[lit]
    size[:len(lit)] = np.where(rgba, 5, 4)
    rows[len(lit):, 0] = 0xC0 | (run_len - 1)
    order = np.argsort(np.concatenate([lit, run_pos]), kind="stable")
    rows, size = rows[order], size[order]
    body = rows[np.arange(5)[None, :] < size[:, None]].tobytes()
    return (b"qoif" + struct.pack(">IIBB", w, h, 4, 0) + body
            + b"\0" * 7 + b"\1")


def dds_file(w: int, h: int, body: bytes, fourcc: bytes = b"DX10",
             dxgi: int = 0, pfflags: int = 0x4, bitcount: int = 0,
             extra: bytes = b"") -> bytes:
    """A DDS header (and a DX10 one for ``fourcc`` DX10) before ``extra``
    (a palette) and the body."""
    head = (b"DDS " + struct.pack("<7I", 124, 0x81007, h, w, len(body), 0, 0)
            + bytes(44) + struct.pack("<4I", 32, pfflags,
                                      struct.unpack("<I", fourcc)[0],
                                      bitcount)
            + bytes(16) + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    if fourcc == b"DX10":
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + extra + body


def _blocks4(img: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H/4 * W/4, 16, C): 4x4 blocks, row-major."""
    h, w, c = img.shape
    return (img.reshape(h // 4, 4, w // 4, 4, c).transpose(0, 2, 1, 3, 4)
            .reshape(-1, 16, c))


def _unblocks4(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    c = blocks.shape[-1]
    return (blocks.reshape(h // 4, w // 4, 4, 4, c).transpose(0, 2, 1, 3, 4)
            .reshape(h, w, c))


def _bc1_colour(rgb: np.ndarray, four: bool):
    """A numpy BC1 colour encoder: the block's channel-wise max and min as
    565 endpoints, each texel the palette entry (bit-replicated 565, thirds
    truncated toward zero, as a decoder makes them) nearest its projection
    on the line between them. ``four`` is the block's mode: always four
    colours in BC3; in BC1 where c0 > c1 (equal endpoints take index 0).
    Returns (the 8-byte blocks, what a decoder gives: (N, 16, 3))."""
    def to565(c):
        c = c.astype(np.uint16)
        return (c[..., 0] >> 3) << 11 | (c[..., 1] >> 2) << 5 | c[..., 2] >> 3

    def from565(v):
        v = v.astype(np.int32)
        r, g, b = (v & 0xF800) >> 8, (v & 0x7E0) >> 3, (v & 0x1F) << 3
        return np.stack([r | r >> 5, g | g >> 6, b | b >> 5], axis=-1)

    a, b = to565(rgb.max(axis=1)), to565(rgb.min(axis=1))
    c0, c1 = np.maximum(a, b), np.minimum(a, b)
    e0, e1 = from565(c0), from565(c1)
    pal = np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], axis=1)
    d = (e0 - e1).astype(np.float32)
    t = ((rgb - e1[:, None]) * d[:, None]).sum(-1) / np.maximum(
        (d * d).sum(-1), 1.0)[:, None]  # 0 at e1, 1 at e0
    idx = np.array([1, 3, 2, 0])[np.clip(np.rint(3 * t), 0, 3).astype(int)]
    if not four:
        idx[c0 == c1] = 0
    lut = (idx.astype(np.uint32) << (2 * np.arange(16, dtype=np.uint32))).sum(
        axis=1, dtype=np.uint32)
    out = np.zeros((len(rgb), 8), np.uint8)
    out[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = lut.astype("<u4").view(np.uint8).reshape(-1, 4)
    return out, np.take_along_axis(pal, idx[:, :, None], axis=1)


def _bc3_alpha(alpha: np.ndarray):
    """A numpy BC3 alpha encoder: max and min as endpoints, each texel the
    nearest step of the eight-level ramp (index 0 where they are equal).
    Returns (the 8-byte blocks, the decoded (N, 16) alpha)."""
    a0 = alpha.max(axis=1).astype(np.int32)
    a1 = alpha.min(axis=1).astype(np.int32)
    i = np.arange(1, 7)
    ramp = ((7 - i) * a0[:, None] + i * a1[:, None]) // 7
    pal = np.concatenate([a0[:, None], a1[:, None], ramp], axis=1)
    step = np.rint((a0[:, None] - alpha) * 7 / np.maximum(a0 - a1, 1)[:, None])
    idx = np.array([0, 2, 3, 4, 5, 6, 7, 1])[np.clip(step, 0, 7).astype(int)]
    idx[a0 == a1] = 0
    bits = (idx.astype(np.uint64) << (3 * np.arange(16, dtype=np.uint64))).sum(
        axis=1, dtype=np.uint64)
    out = np.zeros((len(alpha), 8), np.uint8)
    out[:, 0], out[:, 1] = a0, a1
    out[:, 2:] = bits.astype("<u8").view(np.uint8).reshape(-1, 8)[:, :6]
    return out, np.take_along_axis(pal, idx, axis=1)


def make_dds(img: np.ndarray, fourcc: bytes):
    """DXT1 or DXT5 DDS without Pillow (sides multiples of 4): the header
    from :func:`dds_file`, the blocks from :func:`_bc1_colour` and
    :func:`_bc3_alpha`. Returns (the file, the RGBA pixels a decoder must
    give)."""
    h, w = img.shape[:2]
    blocks = _blocks4(img)
    colour, rgb = _bc1_colour(blocks[..., :3], fourcc != b"DXT1")
    if fourcc == b"DXT1":
        data, alpha = colour, np.full(rgb.shape[:2], 255)
    else:
        abytes, alpha = _bc3_alpha(blocks[..., 3])
        data = np.concatenate([abytes, colour], axis=1)
    want = _unblocks4(np.concatenate([rgb, alpha[..., None]], axis=2), h, w)
    return (dds_file(w, h, data.tobytes(), fourcc=fourcc),
            want.astype(np.uint8))


def make_ico(big: np.ndarray, small: np.ndarray, with_big: bool = True):
    """ICO without Pillow: a PNG entry of ``big`` (RGBA, 256x256) and a
    32 bpp BMP entry of ``small`` (RGBA, 48x48: a DIB of twice the height,
    BGRA rows bottom-up, then an all-clear AND mask)."""
    h, w = small.shape[:2]
    rows = small[::-1][:, :, [2, 1, 0, 3]].tobytes()
    mask = bytes((w + 31) // 32 * 4 * h)
    dib = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, 32, 0,
                      len(rows) + len(mask), 0, 0, 0, 0) + rows + mask
    images = ([(big.shape[1], big.shape[0], make_png(big))] if with_big
              else []) + [(w, h, dib)]
    out = b"\x00\x00\x01\x00" + struct.pack("<H", len(images))
    offset = 6 + 16 * len(images)
    body = b""
    for iw, ih, data in images:
        out += struct.pack("<BBBBHHII", iw % 256, ih % 256, 0, 0, 1, 32,
                           len(data), offset + len(body))
        body += data
    return out + body


def make_bmp_fields(img: np.ndarray, kind: str) -> bytes:
    """A BMP of an RGB or RGBA image, by ``struct`` and numpy: "v5_bgra" (32
    bpp BI_BITFIELDS, BGRA masks in a 124-byte header), "565" (16 bpp
    BI_BITFIELDS 5-6-5 after a 40-byte header) or "core24" (a 12-byte
    BITMAPCOREHEADER, 24 bpp)."""
    h, w = img.shape[:2]
    if kind == "v5_bgra":
        px = img[..., [2, 1, 0, 3]].reshape(h, 4 * w)
        header = struct.pack("<IiiHHIIiiII", 124, w, h, 1, 32, 3, px.size,
                             2835, 2835, 0, 0) + struct.pack(
            "<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000) + bytes(68)
    elif kind == "565":
        v = ((img[..., 0].astype(np.uint16) >> 3) << 11
             | (img[..., 1].astype(np.uint16) >> 2) << 5
             | img[..., 2].astype(np.uint16) >> 3)
        px = v.astype("<u2").view(np.uint8).reshape(h, 2 * w)
        header = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 16, 3, 0, 2835,
                             2835, 0, 0) + struct.pack(
            "<III", 0xF800, 0x7E0, 0x1F)
    else:
        px = img[..., ::-1].reshape(h, 3 * w)
        header = struct.pack("<IHHHH", 12, w, h, 1, 24)
    pad = (-px.shape[1]) % 4
    body = np.pad(px[::-1], ((0, 0), (0, pad))).tobytes()
    off = 14 + len(header)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + \
        header + body


def tiff_ifd(w: int, h: int, entries, body: bytes, tail: bytes = b"") -> bytes:
    """A little-endian TIFF of one strip, ``body``, with the IFD entries
    (tag, type, count, value) besides the size and strip tags, and ``tail``
    after the IFD: a value of None is the offset of the tail."""
    entries = sorted(entries + [
        (256, 4, 1, w), (257, 4, 1, h), (273, 4, 1, 8), (278, 4, 1, h),
        (279, 4, 1, len(body))])
    ifd_off = 8 + len(body)
    tail_off = ifd_off + 2 + 12 * len(entries) + 4
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHII", t, k, n, tail_off if v is None else v)
        for t, k, n, v in entries) + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", ifd_off) + body + ifd + tail


def tiff_file(w: int, h: int, tags: dict, chunks, tile: int = 0) -> bytes:
    """A little-endian TIFF of one IFD: ``chunks`` (strips, or ``tile``-px
    square tiles row by row) after the header, then the IFD of ``tags``
    {tag: (type, values)} (3 SHORT, 4 LONG, 7 UNDEFINED with the values as
    bytes) with the size and chunk tags added, then the values that do not
    fit in their entries."""
    body, offs = b"", []
    for c in chunks:
        offs.append(8 + len(body))
        body += c + b"\0" * (len(c) % 2)
    lens = [len(c) for c in chunks]
    tags = {256: (4, [w]), 257: (4, [h]), **tags}
    if tile:
        tags.update({322: (3, [tile]), 323: (3, [tile]), 324: (4, offs),
                     325: (4, lens)})
    else:
        tags.update({273: (4, offs), 279: (4, lens)})
    ifd_off = 8 + len(body)
    tail_off = ifd_off + 2 + 12 * len(tags) + 4
    ifd, tail = struct.pack("<H", len(tags)), b""
    for t in sorted(tags):
        typ, vals = tags[t]
        raw = bytes(vals) if typ == 7 else b"".join(
            struct.pack("<" + {3: "H", 4: "I"}[typ], v) for v in vals)
        ifd += struct.pack("<HHI", t, typ, len(raw) if typ == 7 else len(vals))
        if len(raw) <= 4:
            ifd += raw.ljust(4, b"\0")
        else:
            ifd += struct.pack("<I", tail_off + len(tail))
            tail += raw + b"\0" * (len(raw) % 2)
    return (b"II*\x00" + struct.pack("<I", ifd_off) + body + ifd
            + struct.pack("<I", 0) + tail)


def packbits(rows: np.ndarray) -> bytes:
    """PackBits of each row of (h, n) u8, as literal packets of at most 128
    bytes: a valid stream that decodes through the literal arm."""
    h, n = rows.shape
    out = []
    for at in range(0, n, 128):
        chunk = rows[:, at:at + 128]
        head = np.full((h, 1), chunk.shape[1] - 1, np.uint8)
        out.append(np.concatenate([head, chunk], axis=1))
    return np.concatenate(out, axis=1).tobytes()


def make_bilevel_tiff(page: np.ndarray) -> bytes:
    """Uncompressed 1-bit TIFF (BlackIsZero, BitsPerSample 1), by numpy."""
    h, w = page.shape
    return tiff_ifd(w, h, [(258, 3, 1, 1), (259, 3, 1, 1), (262, 3, 1, 1),
                           (277, 3, 1, 1)], np.packbits(page, axis=1).tobytes())


def make_cmyk_tiff(img: np.ndarray) -> bytes:
    """8-bit CMYK TIFF (photometric 5, chunky, PackBits) of an RGB image, as
    Pillow converts RGB to CMYK (C, M, Y = 255 - R, G, B; K = 0), so that
    the decode gives the image back exactly."""
    h, w = img.shape[:2]
    cmyk = np.concatenate([255 - img, np.zeros((h, w, 1), np.uint8)], 2)
    return tiff_ifd(w, h, [(258, 3, 4, None), (259, 3, 1, 32773),
                           (262, 3, 1, 5), (277, 3, 1, 4)],
                    packbits(cmyk.reshape(h, 4 * w)),
                    struct.pack("<HHHH", 8, 8, 8, 8))


def split_jpeg(data: bytes, moved=(0xDB, 0xC4)):
    """A whole baseline JPEG -> (tables, segment) as a JPEG TIFF holds them:
    SOI, its segments of the ``moved`` markers (DQT and DHT), EOI
    (``JPEGTables``); SOI, its other segments but the APPn ones, the scan,
    EOI (a strip or a tile)."""
    tables, rest, at = [], [], 2
    while data[at + 1] != 0xDA:
        n = struct.unpack(">H", data[at + 2:at + 4])[0]
        seg = data[at:at + 2 + n]
        if data[at + 1] in moved:
            tables.append(seg)
        elif not 0xE0 <= data[at + 1] <= 0xEF:
            rest.append(seg)
        at += 2 + n
    return (b"\xff\xd8" + b"".join(tables) + b"\xff\xd9",
            b"\xff\xd8" + b"".join(rest) + data[at:])


def make_jpeg_tiff(img: np.ndarray, quality: int = 80, samp=(2, 2),
                   rows: int = 16, tile: int = 0, gray: bool = False,
                   tables: bool = True) -> bytes:
    """A JPEG-compressed TIFF of an RGB image without Pillow: YCbCr
    (photometric 6, ``samp`` the YCbCrSubSampling), or gray (photometric 1)
    where ``gray``; in strips of ``rows`` rows (a multiple of the MCU
    height), or in ``tile``-px square tiles, the edge tiles padded by
    replicating the image's edge. The image is encoded once by the port's
    encoder (``make_jpeg``'s); each strip or tile is then the JPEG of its
    blocks (an MCU does not straddle a segment, so these are the segment's
    own JPEG's coefficients), its DQT moved into ``JPEGTables`` (tag 347)
    unless ``tables`` is False. The encoder's Huffman tables are optimised
    for each segment, so each keeps its DHT."""
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    h, w = img.shape[:2]
    sh, sv = (1, 1) if gray else samp
    if tile:
        gh, gw = -(-h // tile), -(-w // tile)
        img = np.pad(img, ((0, gh * tile - h), (0, gw * tile - w), (0, 0)),
                     mode="edge")
        seg_w, seg_h = tile, tile
    else:
        gh, gw, seg_w, seg_h = -(-h // rows), 1, w, rows
    planes, qt = host_encode_rgb_to_coefficients(img, quality, (sh, sv))
    factors = [(sh, sv), (1, 1), (1, 1)]
    if gray:
        planes, factors = planes[:1], factors[:1]
    tab, segs = None, []
    for i in range(gh):
        sh_px = seg_h if tile else min(rows, h - i * rows)
        for j in range(gw):
            my, mx = i * seg_h // (8 * sv), j * seg_w // (8 * sh)
            ny, nx = -(-sh_px // (8 * sv)), -(-seg_w // (8 * sh))
            part = [p[my * fv:(my + ny) * fv, mx * fh:(mx + nx) * fh]
                    for p, (fh, fv) in zip(planes, factors)]
            tab, seg = split_jpeg(loader.encode_jpeg(part, qt, seg_w, sh_px,
                                                     (sh, sv)), (0xDB,))
            segs.append(seg if tables else tab[:-2] + seg[2:])
    n = 1 if gray else 3
    tags = {258: (3, [8] * n), 259: (3, [7]), 262: (3, [1 if gray else 6]),
            277: (3, [n]), 284: (3, [1])}
    if not gray:
        tags[530] = (3, [sh, sv])
    if not tile:
        tags[278] = (4, [rows])
    if tables:
        tags[347] = (7, tab)
    return tiff_file(w, h, tags, segs, tile)



def make_png_palette(img: np.ndarray, colors: int = 63) -> bytes:
    """Palette PNG (colour type 3, 8-bit indices) without Pillow: the
    palette the first ``colors`` distinct entries of a 3-3-2 bit reduction,
    each pixel the nearest of them."""
    h, w = img.shape[:2]
    key = ((img[..., 0] >> 5).astype(np.int32) << 5
           | (img[..., 1] >> 5).astype(np.int32) << 2
           | (img[..., 2] >> 6).astype(np.int32))
    uniq, inv = np.unique(key.ravel(), return_inverse=True)
    pal = np.stack([(uniq >> 5) * 255 // 7, ((uniq >> 2) & 7) * 255 // 7,
                    (uniq & 3) * 255 // 3], axis=1).astype(np.uint8)
    if len(uniq) > colors:
        d = ((pal[:, None, :].astype(np.int32)
              - pal[None, :colors, :].astype(np.int32)) ** 2).sum(-1)
        inv = d.argmin(axis=1)[inv]
        pal = pal[:colors]
    idx = inv.reshape(h, w).astype(np.uint8)
    raw = b"".join(b"\x00" + idx[y].tobytes() for y in range(h))

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"PLTE", pal.tobytes())
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def make_farbfeld(img: np.ndarray) -> bytes:
    """farbfeld: RGBA as big-endian 16-bit samples (each u8 times 257)."""
    h, w = img.shape[:2]
    if img.shape[2] == 3:
        img = np.dstack([img, np.full((h, w), 255, np.uint8)])
    return (b"farbfeld" + struct.pack(">II", w, h)
            + (img.astype(np.uint16) * 257).astype(">u2").tobytes())


def make_hdr(rgbe: np.ndarray) -> bytes:
    """Radiance HDR of flat literal scanlines: (H, W, 4) RGBE bytes as
    they are (a width under 8 reads old-style, as the reference soak's)."""
    h, w = rgbe.shape[:2]
    return (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + b"-Y %d +X %d\n" % (h, w) + rgbe.astype(np.uint8).tobytes())
