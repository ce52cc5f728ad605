"""The mutation fuzz of the native decoders (``imagekit_tpu_torch/tools/
fuzz_codecs.py``), and the repairs of what it found, on the CPU.

- A seeded run of 4000 mutations (400 for each of the ten kinds, every
  entry of a kind called on each) against the ASan and UBSan build of the
  port's native sources (``loader.sanitizer_build``, the build
  ``test_torch_kernel_asan.py``
  loads), in a child process with the ASan runtime preloaded: no
  sanitizer report, and no exception out of ``codecs.decode_bytes`` or the
  fetch stage's parse that the app would answer with a 500 or a 501.
- The reproducers of its findings (``tests/fixtures/fuzz/``, seeds of every
  run), through the optimised library and both apps:
  - a DHT whose counts oversubscribe a code length of 8 bits or fewer made
    the pinned ``jpeg_entropy.cpp`` write past its 8-bit lookup and its
    decoder object (ASan: stack-buffer-overflow in ``HuffTable::Build``);
    ``jpeg4_decode.cpp``'s ``ik_jpeg4_huffman_guard`` now refuses such a
    table (-4) before each call into the pinned decoder, as libjpeg refuses
    it;
  - a DC table with a category past 15 made ``jpeg4_decode.cpp``'s libjpeg
    model (``Lj``) shift by more than its bit buffer (UBSan); it now checks
    a DC first scan's table as ``jpeg_make_d_derived_tbl`` does (-4);
  - frames whose SOFn states a component count Pillow refuses, past the
    segment's end, or a second SOFn of 0 bits before the first scan,
    answered 501 (the "guard no input reaches" of ``jpeg.decode_error``);
    the port now reads every SOFn's declared count and precision as
    Pillow's reader does: "cannot identify image file", 400;
  - an arithmetic frame with a hierarchical SOFn between its scans
    answered 501; it is now Pillow's "broken data stream", 400.
"""

import asyncio
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from aiohttp import FormData
from PIL import Image

from imagekit_tpu_torch.codecs import decode_bytes
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.errors import ImageKitError, NotPortedError
from imagekit_tpu_torch.tools import fuzz_codecs, sources
from tests.test_torch_jxc_slice import _ref_native_lib

ROOT = Path(__file__).resolve().parents[1]
REPRODUCERS = sorted(p.name for p in fuzz_codecs.REPRODUCERS.iterdir())
#: what the port answers for each reproducer (Pillow's words where Pillow
#: refuses the file; the pinned decoder's code for a bad Huffman table)
EXPECTED = {
    "arith_hierarchical_marker_after_scan.jpg": "broken data stream",
    "arith_progressive_sof_count_short.jpg": "cannot identify image file",
    "dc_category_past_15.jpg": "bad huffman data",
    "dht_oversubscribed.jpg": "bad huffman data",
    "lossless_sof_count_short.jpg": "cannot identify image file",
    "second_sof_of_0_bits.jpg": "cannot identify image file",
    "sof_119_components.jpg": "cannot identify image file",
    "sof_142_components_short.jpg": "cannot identify image file",
}


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    _ref_native_lib(monkeypatch)


def test_fuzz_under_address_sanitizer():
    so = loader.sanitizer_build()
    proc = subprocess.run(
        [sys.executable, "-m", "imagekit_tpu_torch.tools.fuzz_codecs",
         "--lib", str(so), "--iters", "4000", "--seed", "1"],
        capture_output=True, text=True, env=loader.sanitizer_env(),
        timeout=900, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-6000:])
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["findings"] == []
    table = fuzz_codecs.entries()
    assert set(summary["kinds"]) == set(table) - {"other"}
    assert len(summary["kinds"]) == 10
    assert all(n == 400 for n in summary["kinds"].values())
    names = {name for entries in table.values() for name, _ in entries}
    assert set(summary["entries"]) == names
    assert min(summary["entries"].values()) >= 400
    assert summary["corpus"] >= 40 + len(REPRODUCERS)


def test_every_reproducer_is_named():
    assert set(REPRODUCERS) == set(EXPECTED)


@pytest.mark.parametrize("name", REPRODUCERS)
def test_reproducer_answers_400(name):
    data = (fuzz_codecs.REPRODUCERS / name).read_bytes()
    assert fuzz_codecs._app_errors(data) == []
    with pytest.raises(ImageKitError) as e:
        decode_bytes(data, device="cpu")
    assert not isinstance(e.value, NotPortedError)
    assert EXPECTED[name] in str(e.value)
    pillow = EXPECTED[name] in ("cannot identify image file",
                                "broken data stream")
    if pillow:  # Pillow's own words for the file
        with pytest.raises(OSError, match=EXPECTED[name]):
            Image.open(io.BytesIO(data)).load()
    # each entry of its kind refuses it, or decodes it, and raises nothing
    # else
    found = fuzz_codecs.feed(fuzz_codecs.kind_of(data), data,
                             fuzz_codecs.entries(), {})
    assert found == []


def _upload(which, tmp_path, data):
    from aiohttp.test_utils import TestClient, TestServer

    from imagekit_tpu_torch.serving.metrics import Metrics

    async def inner():
        if which == "port":
            from imagekit_tpu_torch.config import ImageKitConfig
            from imagekit_tpu_torch.serving.app import create_app

            app = create_app(ImageKitConfig(secret="s", cache_dir=tmp_path),
                             metrics=Metrics(), rate_limit=False,
                             device="cpu")
        else:
            from imagekit_tpu import config as ref_config
            from imagekit_tpu.serving.app import create_app
            from imagekit_tpu.serving.metrics import Metrics as RefMetrics

            app = create_app(ref_config.ImageKitConfig(
                secret="s", cache_dir=tmp_path), metrics=RefMetrics(),
                rate_limit=False)
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            form = FormData()
            form.add_field("file", data, filename="x")
            form.add_field("w", "32")
            r = await client.post("/upload", data=form)
            return r.status, await r.text()
        finally:
            await client.close()

    return asyncio.run(inner())


@pytest.mark.parametrize("name", REPRODUCERS)
def test_reproducer_over_http(tmp_path, name):
    """``/upload`` answers 400 in the port's app, as in the reference's,
    but for the oversubscribed table: the reference's copy of the pinned
    decoder writes past its tables on it (undefined), so its app is not
    asked."""
    data = (fuzz_codecs.REPRODUCERS / name).read_bytes()
    status, body = _upload("port", tmp_path / "port", data)
    assert status == 400, body
    assert EXPECTED[name] in body
    if name != "dht_oversubscribed.jpg":
        assert _upload("ref", tmp_path / "ref", data)[0] == 400


def _tables(data: bytes):
    """(offset of the counts, the 16 counts) of each Huffman table, in file
    order."""
    out, i = [], 2
    while i + 4 <= len(data):
        m, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        if m == 0xC4:
            j = i + 4
            while j < i + 2 + n:
                counts = list(data[j + 1:j + 17])
                out.append((j + 1, counts))
                j += 17 + sum(counts)
        if m == 0xDA:  # to the next marker past the scan's data
            i += 2 + n
            while not (data[i] == 0xFF and data[i + 1] not in (0, 0xFF)
                       and not 0xD0 <= data[i + 1] <= 0xD7):
                i += 1
            if data[i + 1] == 0xD9:
                break
            continue
        i += 2 + n
    return out


def _oversubscribed(data: bytes, table: int) -> bytes:
    """``data`` with three codes of one bit in its ``table``-th Huffman
    table, moved from its longest lengths (the total kept)."""
    at, counts = _tables(data)[table]
    c = list(counts)
    extra = 3 - c[0]
    c[0] = 3
    for i in range(15, 0, -1):
        take = min(extra, c[i])
        c[i] -= take
        extra -= take
    assert extra == 0
    return data[:at] + bytes(c) + data[at + 16:]


def _first_oversubscribed(counts):
    """The first code length whose codes overflow it, or None."""
    code = 0
    for length in range(1, 17):
        code += counts[length - 1]
        if code > 1 << length:
            return length
        code <<= 1
    return None


def _jpeg():
    img = sources.soak_image(np.random.default_rng(3), 64, 48)
    return sources.make_jpeg(0, 90, image=lambda _: img)


def test_huffman_guard_refuses_only_what_overruns():
    """Every entry into the pinned decoder refuses a table oversubscribed
    at 8 bits or fewer (-4); a JPEG TIFF strip with one is a 400; a table
    oversubscribed only past 8 bits, which the pinned decoder reads
    without overrunning its lookup, is left to it."""
    lib = loader.load()
    data = _jpeg()
    hdr = jpeg_abi.parse(lib, data)
    bad = _oversubscribed(data, 0)
    calls = [lambda d: jpeg_abi.parse(lib, d),
             lambda d: jpeg_abi.decode(lib, d),
             lambda d: jpeg_abi.decode_planes(lib, d),
             lambda d: jpeg_abi.decode_lowfreq(lib, d, 2, hdr=hdr),
             lambda d: jpeg_abi.decode_lowfreq_i8(lib, d, 2, hdr=hdr)]
    for call in calls:
        with pytest.raises(jpeg_abi.NativeJpegError) as e:
            call(bad)
        assert e.value.code == -4
        call(data)  # the file as written decodes
    assert lib.ik_jpeg4_huffman_guard(data, len(data)) == 0
    # the longest codes moved to 9 bits until that length is oversubscribed:
    # lengths of 8 bits or fewer untouched, so the pinned decoder's lookup
    # is not overrun, and the guard leaves the table to it
    at, counts = _tables(data)[1]
    c = list(counts)
    while _first_oversubscribed(c) != 9:
        last = max(i for i, v in enumerate(c) if v)
        c[last] -= 1
        c[8] += 1
    deep = data[:at] + bytes(c) + data[at + 16:]
    assert lib.ik_jpeg4_huffman_guard(deep, len(deep)) == 0
    # a JPEG TIFF page whose strip carries the bad table
    from imagekit_tpu_torch.codecs import tiff

    img = sources.soak_image(np.random.default_rng(4), 64, 32)
    page = sources.make_jpeg_tiff(img, 90, rows=32)
    strip = page.index(b"\xff\xd8")  # the strip, before the IFD
    bad_page = page[:strip] + _oversubscribed(page[strip:], 0)
    tiff.decode(page, device="cpu")
    with pytest.raises(ImageKitError) as e:
        tiff.decode(bad_page, device="cpu")
    assert not isinstance(e.value, NotPortedError)


def test_huffman_guard_reads_between_progressive_scans():
    """In a progressive frame the pinned decoder builds the tables between
    its scans too: the guard walks past each scan's data to them."""
    buf = io.BytesIO()
    Image.fromarray(sources.soak_image(np.random.default_rng(5), 64, 48)).save(
        buf, "JPEG", quality=90, progressive=True)
    data = buf.getvalue()
    lib = loader.load()
    first_sos = data.index(b"\xff\xda")
    tables = _tables(data)
    later = next(k for k, (at, _) in enumerate(tables) if at > first_sos)
    bad = _oversubscribed(data, later)
    jpeg_abi.decode(lib, data)
    with pytest.raises(jpeg_abi.NativeJpegError) as e:
        jpeg_abi.parse(lib, bad)
    assert e.value.code == -4
