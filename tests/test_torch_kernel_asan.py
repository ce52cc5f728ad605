"""K2, K3 and K6 under AddressSanitizer, on the CPU.

``compute-sanitizer`` does not run on the card's machine: its memcheck and
racecheck stop at "Device not supported" before the first kernel (PERF.md).
In their place, the kernels' sources are built under the shim of
``tests/test_torch_kernel_cpu.py`` (one thread a block) with
``-fsanitize=address,undefined`` and launched, in a subprocess with the ASan
runtime preloaded, on the cases the BMP, TIFF and CMYK paths give them at
small sizes: K2 with three and four channels a pixel, in whole rows and in
column strips (the RGB and RGBA heads), K3's two launches on three and
one planes with their own stacks (libjpeg's upsampling of a progressive
CMYK JPEG and of a CMYK JPEG at ratios of 4 and 2, replication stacks),
and K6's two entries on those two files and on three YCbCr JPEGs (4:4:4,
4:2:2, 4:2:0, 37x23). Every output is held against the plain version
(K6's exactly). This checks the
indexing of the global and shared memory the body touches; races it cannot
see.

``jpeg4_decode.cpp``'s arithmetic and lossless decoders run under the same
sanitizers on the writers' files and on hostile ones (DAC segments out of
range, scans cut short, lossless scans libjpeg refuses, frames at the
sides' ceiling).

Beside them, the host half of the JPEG TIFF path: ``tiff_ext_decode.cpp``
under the same sanitizers, its ``ik_tiffx_jpeg_segments`` fed JPEG TIFFs
and hostile IFDs (segment offsets and counts past the end, a tile grid
that overflows, ``JPEGTables`` of 0, 2 or too many bytes), each copied into
a buffer of its exact size so that a read past it is caught.

The port's AV1 decoder (``av1_decode.cpp``) runs under the same sanitizers
on inter streams of every tool and hostile ones (``_INTER``), and on real
streams (Pillow's and the port's encoders: 4:2:0, 4:2:2, 4:4:4,
loop restoration, CDEF, alpha, odd sizes, quantizer matrices and film
grain at 8 and 10 bits, superres from libaom), whose planes must equal
the normal build's, and on hostile ones (truncations, byte flips,
garbage, headers that claim the largest frame, grain params libdav1d
refuses, superres headers spliced to other denominators and widths),
which decode or are refused.

The YUV -> RGB of the AVIFs the reference hands to Pillow
(``avif_yuv_rgb.cpp``) runs under them too, on every path it takes:
libyuv's rows at 8 bits, shifted down from 10 and 12, at 16 bits with
alpha, I400, libavif's float path, identity, YCgCo and YCgCo-Re, odd
sizes down to 1 x 1, alpha, premultiplied alpha on both unmultiplies,
one thread and several; each output must equal the normal build's. So
do the AV1 decoder's walk over a temporal unit (layered streams, hidden
key frames, an INTER top layer, every frame selection and operating
point, cut short and flipped) and the plane scaler of the items libavif
rescales (``avif_scale.cpp``: every path of libyuv's ScalePlane at 8 and
16 bits, crops, thread counts).
"""

import json
import os
import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = textwrap.dedent("""
    import ctypes, io, json, sys
    import numpy as np
    import torch
    from PIL import Image

    from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
    from imagekit_tpu_torch.ops import _build, weights
    from imagekit_tpu_torch.ops import jpeg_pixels as jp
    from imagekit_tpu_torch.ops import resize_planes as rp
    from imagekit_tpu_torch.ops import resize_strip as rs
    from imagekit_tpu_torch.ops.resize_strip import plane_record
    from tests.conftest import make_test_image
    from tests.fixtures import jpeg_writer
    from tests.test_torch_kernel_cpu import K2_CASES, _images, _stack, _strip_launch

    lib = ctypes.CDLL(sys.argv[1])
    _build.configure_band(lib)
    _build.configure_pixels(lib)
    worst = {}

    def note(name, got, want):
        d = (got.int() - want.int()).abs()
        worst[name] = [int(d.max()), float((d > 0).float().mean())]

    for case in ("b5_mixed", "hole", "tall_band", "tr4"):
        B, H, W, OH, OW, U, vidx, hidx, opts = K2_CASES[case]
        wv = torch.from_numpy(_stack(H, OH, H, OH, U, **opts))
        wh = torch.from_numpy(_stack(W, OW, W, OW, U))
        v = torch.tensor(vidx, dtype=torch.int32)
        h = torch.tensor(hidx, dtype=torch.int32)
        for C in (3, 4):
            x = torch.from_numpy(_images(B, H, W * C, seed=C))
            plain = rs.rgba_resize_plain if C == 4 else rs.rgb_resize_plain
            want = plain(x, wv, wh, v.clamp(0, U - 1), h.clamp(0, U - 1))
            for strip in (0, 8):
                got = _strip_launch(lib, x, wv, wh, v, h, C, strip=strip)
                note(f"K2 {case} C={C} strip={strip}", got, want)

    def sampled_inputs(decoded):
        # each component's islow plane and its stacks by libjpeg's choice
        # to the largest grid, as K3 took them in the four-component decode
        hdr, coeffs, qtabs = decoded
        grids = [c.shape[:2] for c in coeffs]
        full = (max(g[0] for g in grids), max(g[1] for g in grids))
        planes, stacks, tabs = [], [], []
        for c, grid in enumerate(grids):
            method = weights.upsample_method(
                (hdr.hmax // hdr.comp_h[c], hdr.vmax // hdr.comp_v[c]),
                hdr.comp_width[c])
            wv, wh = (torch.from_numpy(a[None]) for a in
                      weights.component_stacks(
                          full, grid, (hdr.comp_height[c], hdr.comp_width[c]),
                          method))
            qt = torch.from_numpy(qtabs[hdr.comp_tq[c]].astype(np.int16))
            planes.append(jp.idct_plain(torch.from_numpy(coeffs[c]),
                                        qt)[None].contiguous())
            stacks.append((wv, wh))
            tabs.append(rs.resize_tables(wv, wh))
        return planes, stacks, tabs, torch.zeros(1, dtype=torch.int32)

    def k6(decoded, label):
        # K6's two entries on the frame, against its plain version
        x = jp.upload(jp.frame_plan(*decoded, jp.YCCK if decoded[0].ncomp
                                    == 4 else jp.YCC), torch.device("cpu"))
        planes = [torch.empty((c.shape[0] * 8, c.shape[1] * 8),
                              dtype=torch.uint8) for c in x.coeffs]
        out = torch.empty((x.height, x.width, len(x.coeffs)),
                          dtype=torch.uint8)
        rec = jp.record(x, planes, out)
        for fn in (lib.ik_jpeg_idct, lib.ik_jpeg_upcolour):
            assert fn(ctypes.byref(rec), None) == 0
        note(f"K6 {label}", out, jp.decode_pixels_plain(x))

    def cmyk_planes(decoded, label):
        k6(decoded, f"CMYK {label}")
        planes, stacks, tabs, vidx = sampled_inputs(decoded)
        for part in (slice(0, 3), slice(3, 4)):  # the two launches
            recs, outs = [], []
            for p, (wv, wh), t in zip(planes[part], stacks[part], tabs[part]):
                B, ph, pw = p.shape
                oh, ow = wv.shape[1], wh.shape[1]
                out = torch.empty((B, oh, ow), dtype=torch.uint8)
                recs.append(plane_record(p.data_ptr(), ph * pw, pw, 1, wv, t,
                                         vidx, vidx, out, oh * ow, 0, ph, pw))
                outs.append(out)
            _build.launch_band(lib.ik_resize_planes_u8, recs, planes[0].shape[0],
                               None)
            for i, (out, p, (wv, wh)) in enumerate(zip(outs, planes[part],
                                                       stacks[part])):
                note(f"K3 CMYK {label} plane {part.start + i}", out,
                     rp.resize_planes_plain(p, wv, wh, vidx))

    buf = io.BytesIO()
    Image.fromarray(make_test_image(83, 61)).convert("CMYK").save(
        buf, "JPEG", quality=90, subsampling=2, progressive=True)
    four = np.dstack([make_test_image(83, 61)] * 2)[:, :, :4]
    samp = ((4, 1), (1, 1), (1, 1), (2, 1))
    q, tabs4, tq = jpeg_writer.coefficients(four, 90, samp, colour="raw")
    for label, data in (("progressive", buf.getvalue()),
                        ("ratios_4_2", jpeg_writer.write(q, tabs4, 83, 61,
                                                         samp, tq))):
        cmyk_planes(jpeg_abi.decode4(loader.load(), data), label)
    for samp in (0, 1, 2):
        buf = io.BytesIO()
        Image.fromarray(make_test_image(37, 23)).save(
            buf, "JPEG", quality=90, subsampling=samp)
        k6(jpeg_abi.decode(loader.load(), buf.getvalue()), f"YCC {samp}")
    print(json.dumps(worst))
""")


def test_k2_and_k3_under_address_sanitizer(tmp_path):
    from tests.test_torch_kernel_cpu import CSRC, SHIM

    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    so = tmp_path / "libik_band_asan.so"
    san = ["-fsanitize=address,undefined", "-fno-sanitize-recover=undefined"]
    objs = [tmp_path / f"{name}.o" for name in ("resize_strip",
                                                "resize_planes",
                                                "jpeg_pixels")]
    builds = [subprocess.Popen(
        ["g++", "-std=c++17", "-O0", "-g", "-ffp-contract=off", "-fPIC",
         *san, "-I", str(tmp_path), "-x", "c++", "-c",
         str(CSRC / f"{o.stem}.cu"), "-o", str(o)]) for o in objs]
    assert [b.wait(timeout=600) for b in builds] == [0, 0, 0]
    subprocess.run(["g++", "-shared", *san, *map(str, objs), "-o", str(so)],
                   check=True, timeout=300)
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    env = {**os.environ, "LD_PRELOAD": asan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1",
           "PYTHONPATH": os.pathsep.join(
               [str(ROOT), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, str(so)],
                          capture_output=True, text=True, env=env,
                          timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    worst = json.loads(proc.stdout.strip().splitlines()[-1])
    # K2 cases, two CMYK files through K3 and K6, three YCbCr files
    assert len(worst) == 4 * 2 * 2 + 2 * 4 + 2 + 3
    for name, (mx, share) in worst.items():
        assert mx <= (0 if name.startswith("K6") else 1), (name, mx, share)
        assert share <= 1e-3, (name, mx, share)


_TIFFX = textwrap.dedent("""
    import ctypes, json, sys
    lib = ctypes.CDLL(sys.argv[1])
    libc = ctypes.CDLL(None)
    libc.malloc.restype = ctypes.c_void_p
    libc.malloc.argtypes = [ctypes.c_size_t]
    libc.free.argtypes = [ctypes.c_void_p]
    u64 = ctypes.c_uint64

    class Jpeg(ctypes.Structure):
        _fields_ = [(n, ctypes.c_int32) for n in (
            "width", "height", "photometric", "samples", "alpha", "sub_h",
            "sub_v", "seg_w", "seg_h", "rows", "cols", "tiled")] + [
            ("tables_off", u64), ("tables_len", u64)] + [
            (n, ctypes.c_int32) for n in ("planes", "extra", "old_style")] + [
            ("luma", ctypes.c_float * 3), ("refbw", ctypes.c_float * 6)]

    lib.ik_tiffx_ojpeg_stream.restype = ctypes.c_int64

    class Info(ctypes.Structure):
        _fields_ = [(n, ctypes.c_int32) for n in ("w", "h", "c", "layout",
                                                  "unread")]

    class Seg(ctypes.Structure):  # IkSegInfo: 5 + 7 x 4 + 1 int32
        _fields_ = [("head", ctypes.c_int32 * 5),
                    ("comp", (ctypes.c_int32 * 4) * 7),
                    ("progressive", ctypes.c_int32)]

    class Splice(ctypes.Structure):
        _fields_ = [("data", ctypes.c_void_p), ("len", u64),
                    ("prefix", ctypes.c_void_p * 2), ("prefix_len", u64 * 2),
                    ("offsets", ctypes.c_void_p), ("counts", ctypes.c_void_p),
                    ("which", ctypes.c_void_p), ("n", ctypes.c_int32)]

    def exact(raw):
        # a copy of exactly its size: a redzone after
        at = libc.malloc(max(len(raw), 1))
        ctypes.memmove(at, raw, len(raw))
        return at

    def many(buf, size, ranges, case):
        # the page's segments, spliced onto exact-size prefixes by the
        # native entries, parsed and decoded into planes of exactly their
        # headers' size
        offs, cnts = zip(*ranges)
        offs, cnts = case.get("offsets", offs), case.get("counts", cnts)
        n = len(offs)
        pre = [bytes.fromhex(h) for h in case["prefixes"]]
        heads = [exact(p) for p in pre]
        arr = lambda t, v: (t * n)(*v)
        sp = Splice(buf, size, (ctypes.c_void_p * 2)(*heads),
                    (u64 * 2)(*map(len, pre)))
        keep = [arr(u64, offs), arr(u64, cnts),
                arr(ctypes.c_int32, case["which"])]
        sp.offsets, sp.counts, sp.which = map(ctypes.addressof, keep)
        sp.n = n
        infos = (Seg * n)()
        four, rcs = (ctypes.c_int32 * n)(), (ctypes.c_int32 * n)()
        lib.ik_tiffx_jpeg_parse_many(ctypes.byref(sp), infos, four, rcs)
        parsed = list(rcs)
        ptrs, owned = (ctypes.c_void_p * (4 * n))(), []
        strides = (ctypes.c_int64 * (4 * n))()
        for i in range(n):
            for c in range(infos[i].head[2] if parsed[i] == 0 else 0):
                bw, bh = infos[i].comp[4][c], infos[i].comp[5][c]
                ptrs[4 * i + c] = libc.malloc(bw * bh * 64 * 2)
                strides[4 * i + c] = bw
                owned.append(ptrs[4 * i + c])
        q = (ctypes.c_uint16 * (256 * n))()
        lib.ik_tiffx_jpeg_decode_many(ctypes.byref(sp), ptrs, strides, q,
                                      rcs)
        for a in owned + heads:
            libc.free(ctypes.c_void_p(a))
        return parsed, list(rcs)

    out = {}
    for name, case in json.loads(sys.stdin.read()).items():
        data = bytes.fromhex(case["data"])
        buf = exact(data)
        info, jinfo = Info(), Jpeg()
        rc_parse = lib.ik_tiffx_parse(ctypes.c_void_p(buf), len(data),
                                      ctypes.byref(info))
        rc_small = lib.ik_tiffx_jpeg_segments(
            ctypes.c_void_p(buf), len(data), ctypes.byref(jinfo), None, None,
            0)
        n = (max(jinfo.rows * jinfo.cols * jinfo.planes, 0)
             if rc_small == -7 else 0)
        offs, cnts = (u64 * n)(), (u64 * n)()
        rc = lib.ik_tiffx_jpeg_segments(ctypes.c_void_p(buf), len(data),
                                        ctypes.byref(jinfo), offs, cnts, n)
        ranges = [[offs[i], cnts[i]] for i in range(n)]
        out[name] = {"parse": rc_parse, "small": rc_small, "rc": rc,
                     "len": len(data), "ranges": ranges,
                     "tables": [jinfo.tables_off, jinfo.tables_len]}
        # an old-style page's stream, into a buffer of exactly its size;
        # a sample layout's pixels, likewise
        size = lib.ik_tiffx_ojpeg_stream(ctypes.c_void_p(buf), len(data),
                                         None, 0)
        if size > 0:
            at = libc.malloc(size)
            size = lib.ik_tiffx_ojpeg_stream(ctypes.c_void_p(buf), len(data),
                                             ctypes.c_void_p(at), size)
            libc.free(ctypes.c_void_p(at))
        out[name]["stream"] = size
        if rc_parse == 0 and info.layout in (0, 1):
            at = libc.malloc(info.w * info.h * info.c)
            out[name]["decode"] = lib.ik_tiffx_decode(
                ctypes.c_void_p(buf), len(data), ctypes.c_void_p(at),
                info.w * info.h * info.c)
            libc.free(ctypes.c_void_p(at))
        out[name]["unread"] = info.unread
        if case["splice"]:
            out[name]["many"] = many(buf, len(data), ranges, case["splice"])
        libc.free(ctypes.c_void_p(buf))
    print(json.dumps(out))
""")


def _tiffx_cases() -> dict:
    """JPEG TIFFs (strips, tiles, no tables) and hostile IFDs around
    them."""
    import chip_smoke
    from tests.conftest import make_test_image

    img = make_test_image(64, 48)
    good = {"strips": chip_smoke.make_jpeg_tiff(img, 85),
            "tiles": chip_smoke.make_jpeg_tiff(img, 85, tile=16),
            "no_tables": chip_smoke.make_jpeg_tiff(img, 85, tables=False)}
    base = {258: (3, [8] * 3), 259: (3, [7]), 262: (3, [6]), 277: (3, [3]),
            284: (3, [1]), 530: (3, [2, 2])}
    seg = b"\xff\xd8" + bytes(60) + b"\xff\xd9"

    def strips(n, extra=None, **tags):
        return chip_smoke.tiff_file(64, 16 * n, {**base, 278: (4, [16]),
                                                 **(extra or {})},
                                    [seg] * n)

    def patched(data, tag, index, value):
        # the index-th value of a LONG tag's array, set to ``value``
        at = data.index(tag.to_bytes(2, "little") + b"\x04\x00")
        off = int.from_bytes(data[at + 8:at + 12], "little")
        return (data[:off + 4 * index] + value.to_bytes(4, "little")
                + data[off + 4 * index + 4:])

    # tables of 60 kB (a COM segment in them) and a hundred one-row strips
    # of an SOI each: the splices would copy about 6 MB of a 61 kB file
    big = b"\xff\xd8\xff\xfe\xea\x60" + bytes(0xEA5E) + b"\xff\xd9"
    hostile = {
        "offset_past_the_end": patched(strips(3), 273, 2, 1 << 20),
        "count_past_the_end": patched(strips(3), 279, 1, 1 << 20),
        "offset_and_count_wrap": patched(patched(strips(3), 273, 0,
                                                 0xFFFFFFF0), 279, 0, 0x20),
        "tile_grid_overflows": chip_smoke.tiff_file(
            1 << 24, 1 << 24, base, [seg] * 4, tile=16),
        "tile_of_zero": chip_smoke.tiff_file(
            64, 48, {**base, 322: (3, [0]), 323: (3, [0]),
                     324: (4, [8]), 325: (4, [64])}, []),
        "tables_past_the_end": strips(2, {347: (7, b"\xff\xd8" * 3)})[:-4],
        "fewer_strips_than_rows": strips(2, {257: (4, [64])}),
        "tables_too_long": strips(2, {347: (7, b"\xff\xd8" + bytes(1 << 16)
                                             + b"\xff\xd9")}),
        "splices_amplified": chip_smoke.tiff_file(
            64, 100, {**base, 278: (4, [1]), 347: (7, big)},
            [b"\xff\xd8"] * 100),
    }
    edge = {"tables_of_0": strips(2, {347: (7, b"")}),
            "tables_of_2": strips(2, {347: (7, b"\xff\xd8")})}
    return good, hostile, edge


def test_tiff_jpeg_segments_under_address_sanitizer(tmp_path):
    """``ik_tiffx_jpeg_segments`` under ASan and UBSan: JPEG TIFFs give
    their grid and ranges inside the data; hostile IFDs are refused (rc <
    0), tables longer than 64 kB and splices that would copy more than 64
    times the file among them; ``JPEGTables`` of 0 or 2 bytes parse, their
    range inside the data; a grid larger than the caller's room is -7,
    nothing written. The good pages' segments go through
    ``ik_tiffx_jpeg_parse_many`` and ``ik_tiffx_jpeg_decode_many``, which
    splice them from the file and the prefixes, each held in a buffer of
    exactly its size; so do
    pages with a segment cut short or turned to garbage, and splices whose
    ranges leave the file or start without an SOI (all refused). The
    decode writes each segment's levels through a scratch buffer into
    destinations of exactly their size. The sanitizers report nothing."""
    from imagekit_tpu_torch.codecs import tiff

    native = ROOT / "imagekit_tpu_torch" / "codecs" / "native"
    so = tmp_path / "libtiffx_asan.so"
    # the batch entries call the pinned and the four-component decoders
    subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fPIC", "-shared",
                    "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined",
                    *(str(native / f) for f in ("tiff_ext_decode.cpp",
                                                "jpeg_entropy.cpp",
                                                "jpeg4_decode.cpp")),
                    "-o", str(so), "-lz"], check=True, timeout=300)
    good, hostile, edge = _tiffx_cases()

    def splice(data, **hostile_ranges):
        # the prefixes and each segment's choice of them, as entropy_decode
        # makes them
        info, offs, cnts = tiff.segments(data)
        tables = data[info.tables_off:info.tables_off + info.tables_len]
        defs = tiff.tables_defined(tables)
        which = [int(tiff._segment_tables(data[o:o + n], defs)[1])
                 for o, n in zip(offs.tolist(), cnts.tolist())]
        return {"prefixes": [p.hex() for p in tiff.prefixes(tables)],
                "which": which, **hostile_ranges}

    cases = {f"{kind}/{k}": {"data": v.hex(),
                             "splice": splice(v) if kind == "good" else None}
             for kind, group in (("good", good), ("hostile", hostile),
                                 ("edge", edge))
             for k, v in group.items()}
    strips = good["strips"]
    info, offs, cnts = tiff.segments(strips)
    offs, cnts = offs.tolist(), cnts.tolist()
    # a page whose last segment is cut short, one with a segment of
    # garbage (both decoded as libjpeg decodes them), and splices whose
    # ranges leave the file or have no SOI
    garbage = (strips[:offs[1] + 200] + b"\xab" * (cnts[1] - 200)
               + strips[offs[1] + cnts[1]:])
    len_ = len(strips)
    rogue = {
        "cut/last": (strips, {"counts": cnts[:2] + [300]}),
        "cut/garbage": (garbage, {}),
        "cut/offset_past_the_end": (strips, {"offsets": offs[:2]
                                             + [len_ + 1]}),
        "cut/count_past_the_end": (strips, {"counts": cnts[:2]
                                            + [len_ - offs[2] + 1]}),
        "cut/count_wraps": (strips, {"offsets": offs[:2] + [2 ** 64 - 4],
                                     "counts": cnts[:2] + [8]}),
        "cut/no_soi": (strips, {"offsets": offs[:2] + [offs[2] + 2],
                                "counts": cnts[:2] + [cnts[2] - 2]}),
        "cut/count_of_1": (strips, {"counts": cnts[:2] + [1]}),
    }
    for name, (data, ranges) in rogue.items():
        cases[name] = {"data": data.hex(), "splice": splice(data, **ranges)}
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    env = {**os.environ, "LD_PRELOAD": asan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _TIFFX, str(so)],
                          input=json.dumps(cases), capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, r in res.items():
        kind = name.split("/")[0]
        if name in ("cut/last", "cut/garbage"):
            # decoded as libjpeg decodes them under libtiff's fake EOI: data
            # that ends early, bad codes as the symbol 0
            assert r["many"] == [[0] * 3] * 2, (name, r)
            continue
        if kind == "cut":  # the rogue segment 2 is refused, the others not
            parsed, decoded = r["many"]
            cut = 2
            assert min(parsed[cut], decoded[cut]) < 0, (name, r)
            assert parsed[:cut] == decoded[:cut] == [0] * cut, (name, r)
            continue
        if kind == "good":  # every segment parses and decodes
            assert r["many"] == [[0] * len(r["ranges"])] * 2, (name, r)
        if kind == "hostile":
            assert r["rc"] < 0 and r["parse"] < 0, (name, r)
            continue
        assert r["rc"] == r["parse"] == 0 and r["small"] == -7, (name, r)
        assert r["ranges"] and all(0 < o and o + n <= r["len"]
                                   for o, n in r["ranges"]), (name, r)
        off, n = r["tables"]
        assert off + n <= r["len"], (name, r)
    assert res["good/tiles"]["ranges"].__len__() == 12
    assert res["edge/tables_of_0"]["tables"][1] == 0
    assert res["edge/tables_of_2"]["tables"][1] == 2
    for name in ("offset_past_the_end", "no_soi", "count_of_1"):
        assert res[f"cut/{name}"]["many"][0][2] in (-1, -2), name


def test_tiff_remainder_under_address_sanitizer(tmp_path):
    """The paths of ``tiff_ext_decode.cpp`` for the layouts the reference
    still decoded with Pillow, under ASan and UBSan, every file held in a
    buffer of exactly its size: the sample layouts (FillOrder 2, 16-bit
    CMYK, CMYK with extra samples, 32-bit gray, their predictors) parse and
    decode into an exact buffer; old-style pages assemble their stream
    (``ik_tiffx_ojpeg_stream``) into an exact buffer; planar, gray +
    alpha and extra-sample JPEG pages splice, parse and decode every
    segment (``ik_jpeg4_*`` for two components); what Pillow refuses is -8
    (a raw YCbCr page's unread bytes counted), or -9 where its read fails
    ("decoder error -2"); hostile old-style pages
    (tables past the file, Huffman counts past 256, a frame past 65535, a
    stream of no JPEG, a length past the file) and corrupt ones are
    refused. The sanitizers report nothing."""
    from imagekit_tpu_torch.codecs import tiff
    from tests import test_torch_tiff_remainder as rem

    native = ROOT / "imagekit_tpu_torch" / "codecs" / "native"
    so = tmp_path / "libtiffx_asan.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fPIC", "-shared",
                    "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined",
                    *(str(native / f) for f in ("tiff_ext_decode.cpp",
                                                "jpeg_entropy.cpp",
                                                "jpeg4_decode.cpp")),
                    "-o", str(so), "-lz"], check=True, timeout=300)

    def splice(data):
        info, offs, cnts = tiff.segments(data)
        tables = data[info.tables_off:info.tables_off + info.tables_len]
        defs = tiff.tables_defined(tables)
        return {"prefixes": [p.hex() for p in tiff.prefixes(tables)],
                "which": [int(tiff._segment_tables(data[o:o + n], defs)[1])
                          for o, n in zip(offs.tolist(), cnts.tolist())]}

    tables = rem._tables_form()

    def tables_with(tag, value):
        return rem._patched_first(tables, tag, value)

    dc_at = struct.unpack("<I", tables[tables.index(
        struct.pack("<HHI", 520, 4, 3)) + 8:][:4])[0]
    dc0 = struct.unpack("<I", tables[dc_at:dc_at + 4])[0]
    hostile = {
        "old_style_qtable_past_the_file": tables_with(519, len(tables) - 10),
        "old_style_dctable_at_the_end": tables_with(520, len(tables) - 8),
        "old_style_huffman_counts_past_256": (
            tables[:dc0] + bytes([255] * 16) + tables[dc0 + 16:]),
        "old_style_frame_past_65535": rem._tiff(
            70000, 8, {258: (3, [8] * 3), 259: (3, [6]), 262: (3, [6]),
                       277: (3, [3]), 519: (4, [8, 8, 8]),
                       520: (4, [8, 8, 8]), 521: (4, [8, 8, 8])},
            [bytes(64)]),
        "old_style_no_jpeg": rem.CORRUPT["old_style_no_jpeg"](),
        "old_style_jif_of_garbage": rem._ojpeg(jif=(30, None)),
        **{f"refused_{k}": v() for k, v in rem.REFUSED.items()},
    }
    cases = {f"sample/{k}": {"data": v().hex(), "splice": None}
             for k, v in rem.SAMPLES.items()}
    # a CCITT row that overshoots, cut as libtiff cuts it: decoded
    cases["sample/fill_order_2_ccitt_row_overshoots"] = {
        "data": rem.fill_order_2_ccitt_row_overshoots().hex(),
        "splice": None}
    cases.update({f"old/{k}": {"data": v().hex(), "splice": None}
                  for k, v in rem.OLD_STYLE.items()})
    cases.update({f"page/{k}": {"data": v().hex(), "splice": splice(v())}
                  for k, v in rem.JPEG_PAGES.items()})
    cases.update({f"hostile/{k}": {"data": v.hex(), "splice": None}
                  for k, v in hostile.items()})
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    env = {**os.environ, "LD_PRELOAD": asan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _TIFFX, str(so)],
                          input=json.dumps(cases), capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, r in res.items():
        kind = name.split("/")[0]
        if kind == "sample":
            assert r["parse"] == 0 and r["decode"] == 0, (name, r)
        elif kind == "old":
            assert r["parse"] == r["rc"] == 0 and r["stream"] > 0, (name, r)
        elif kind == "page":
            assert r["many"] == [[0] * len(r["ranges"])] * 2, (name, r)
        elif name.startswith("hostile/refused_"):
            # -9 where Pillow's read fails with "decoder error -2" (a
            # planar YCbCr JPEG page), -8 where it has no mode
            want = -9 if name.endswith("jpeg_ycbcr_planar") else -8
            assert r["parse"] == want, (name, r)
            assert (r["unread"] >= 0) == ("ycbcr_uncompressed" in name), (
                name, r)
        else:
            assert min(r["parse"], r["stream"], r.get("decode", 0)) < 0, (
                name, r)


_JPEG4 = textwrap.dedent("""
    import ctypes, json, sys
    lib = ctypes.CDLL(sys.argv[1])
    out = {}
    for name, hexdata in json.loads(sys.stdin.read()).items():
        data = bytes.fromhex(hexdata)
        # each file, header and buffer, of exactly its size
        buf = ctypes.create_string_buffer(data, len(data))
        info = (ctypes.c_int32 * 38)()
        extra = (ctypes.c_int32 * 2)()  # the Adobe flag, the coding
        rc = lib.ik_jpeg4_parse(buf, len(data), info, extra)
        r = {"parse": rc, "coding": extra[1], "decode": None}
        n, width, height = info[2], info[0], info[1]
        if rc == 0 and width * height <= 1 << 22:
            if extra[1] == 2:
                planes = [ctypes.create_string_buffer(
                    info[13 + c] * info[17 + c]) for c in range(n)]
                ptrs = (ctypes.c_void_p * 4)(*[ctypes.addressof(p)
                                               for p in planes])
                r["decode"] = lib.ik_jpeg4_decode_lossless(buf, len(data),
                                                           ptrs)
            else:
                planes = [(ctypes.c_int16 * (64 * info[21 + c] * info[25 + c]))()
                          for c in range(n)]
                ptrs = (ctypes.c_void_p * 4)(*[ctypes.addressof(p)
                                               for p in planes])
                q = (ctypes.c_uint16 * 256)()
                r["decode"] = lib.ik_jpeg4_decode_coeffs(buf, len(data),
                                                         ptrs, q)
        out[name] = r
    print(json.dumps(out))
""")


def _segment(marker: int, body: bytes) -> bytes:
    return bytes((0xFF, marker)) + struct.pack(">H", len(body) + 2) + body


def _arith_lossless_cases():
    """The writers' files (good), and hostile ones: DAC segments out of
    range, scans cut short or ending in a marker, refinement data of
    garbage, lossless scans of predictor 0 or 8, of Pt 8, of an MCU of
    more than 10 samples, frames at the sides' ceiling."""
    import numpy as np

    from tests.conftest import make_test_image
    from tests.fixtures import jpeg_arith_writer as aw
    from tests.fixtures import jpeg_lossless_writer as lw
    from tests.fixtures import jpeg_writer as jw

    img = make_test_image(61, 37)
    s420 = ((2, 2), (1, 1), (1, 1))
    planes, tabs, tq = jw.coefficients(img, 85, s420)
    cmyk = planes + [planes[0].copy()]
    good = {
        "sof9": aw.write(planes, tabs, 61, 37, s420, tq),
        "sof9_rst": aw.write(planes, tabs, 61, 37, s420, tq, restart=2),
        "sof9_scans": aw.write(planes, tabs, 61, 37, s420, tq,
                               interleaved=False),
        "sof10": aw.write(planes, tabs, 61, 37, s420, tq, progressive=True),
        "sof10_gray": aw.write(planes[:1], tabs, 61, 37, s420[:1], tq[:1],
                               progressive=True, restart=5),
        "sof10_cmyk": aw.write(cmyk, tabs, 61, 37, s420 + ((2, 2),),
                               tq + [0], progressive=True),
        "dac_k_0": aw.write(planes, tabs, 61, 37, s420, tq,
                            dac={("ac", 0): 0, ("ac", 1): 0}),
        "dac_k_200": aw.write(planes, tabs, 61, 37, s420, tq,
                              dac={("ac", 0): 200, ("dc", 0): (15, 15)}),
    }
    for pred in (1, 4, 7):
        for samp in (((1, 1),) * 3, s420, ((1, 1),)):
            good[f"lossless_p{pred}_{len(samp)}_{samp[0][0]}"] = lw.write(
                lw.subsample(img[:, :, :len(samp)], samp), 61, 37, samp,
                predictor=pred, pt=pred % 3, restart=31 if samp == s420
                else 0)

    def patched(data, find, offset, value):
        out = bytearray(data)
        out[out.index(find) + offset] = value
        return bytes(out)

    sof9, sof10 = good["sof9"], good["sof10"]
    lossless = good["lossless_p1_3_1"]
    first_sos = sof10.index(b"\xff\xda")
    refine = sof10.rindex(b"\xff\xda")  # the last scan: an AC refinement
    rng = np.random.default_rng(0)
    noise = bytes(rng.integers(0, 255, 400, dtype=np.uint8).tolist())
    sos_len = struct.unpack(">H", sof10[refine + 2:refine + 4])[0]
    body_at = refine + 2 + sos_len
    dac_at = sof9.index(b"\xff\xc9")
    hostile = {
        "dac_l_over_u": sof9[:dac_at] + _segment(0xCC, bytes((0, 0x25)))
        + sof9[dac_at:],
        "dac_index_32": sof9[:dac_at] + _segment(0xCC, bytes((32, 1)))
        + sof9[dac_at:],
        "dac_odd_length": sof9[:dac_at] + _segment(0xCC, bytes((0, 0x10, 1)))
        + sof9[dac_at:],
        "scan_cut_short": sof9[:len(sof9) // 2],
        "progressive_cut_short": sof10[:first_sos + 60],
        "lossless_cut_short": lossless[:len(lossless) // 2],
        "refinement_past_se": sof10[:refine]
        + sof10[refine:refine + 2 + sos_len - 3] + bytes((1, 64, 0x10))
        + sof10[body_at:],
        # an SOS of 3 components: Ss (the predictor) at 11, Ah/Al (Pt) at 13
        "lossless_predictor_0": patched(lossless, b"\xff\xda", 11, 0),
        "lossless_predictor_8": patched(lossless, b"\xff\xda", 11, 8),
        "lossless_pt_8": patched(lossless, b"\xff\xda", 13, 8),
        "lossless_mcu_of_11": lw.write(
            lw.subsample(img, ((3, 3), (1, 1), (1, 1))), 61, 37,
            ((3, 3), (1, 1), (1, 1))),
        "lossless_restart_not_rows": patched(
            good["lossless_p4_3_2"], b"\xff\xdd", 5, 7),
    }
    edge = {  # decoded (or refused) without a report
        "scan_ending_in_marker": sof9[:sof9.index(b"\xff\xda") + 40]
        + b"\xff\xd9",
        "refinement_of_garbage": sof10[:body_at] + noise.replace(
            b"\xff", b"\x00") + b"\xff\xd9",
        "sequential_of_garbage": sof9[:sof9.index(b"\xff\xda") + 14]
        + noise + b"\xff\xd9",
        "lossless_of_garbage": lossless[:lossless.index(b"\xff\xda") + 14]
        + noise.replace(b"\xff", b"\x00") + b"\xff\xd9",
        "rst_out_of_order": good["sof9_rst"].replace(b"\xff\xd0", b"\xff\xd5",
                                                     1),
        "wide_at_the_ceiling": patched(
            sof9[:sof9.index(b"\xff\xda") + 14] + b"\xff\xd9", b"\xff\xc9",
            7, 0xFF).replace(b"\x00\x3d\x03", b"\xff\xff\x03", 1),
        "tall_at_the_ceiling": patched(patched(
            sof9[:sof9.index(b"\xff\xda") + 14] + b"\xff\xd9", b"\xff\xc9",
            5, 0xFF), b"\xff\xc9", 6, 0xFF),
        "both_at_the_ceiling": lossless[:lossless.index(b"\xff\xc3") + 5]
        + b"\xff\xff\xff\xff" + lossless[lossless.index(b"\xff\xc3") + 9:],
        "lossless_wide_at_the_ceiling": lossless[:lossless.index(
            b"\xff\xc3") + 5] + b"\x00\x10\xff\xff" + lossless[
            lossless.index(b"\xff\xc3") + 9:lossless.index(b"\xff\xda") + 14]
        + b"\xff\xd9",
    }
    return good, hostile, edge


def test_arithmetic_and_lossless_under_address_sanitizer(tmp_path):
    """``jpeg4_decode.cpp``'s QM decoder and lossless decoder under ASan and
    UBSan, every file and buffer of exactly its size: the writers' files
    (SOF9, SOF10 with successive approximation and restarts, DAC K of 0
    and above 63, lossless of predictors 1, 4, 7 with Pt and restarts)
    decode; hostile ones are refused (a DAC with L > U, an index past 31 or
    an odd length; scans cut short; an AC refinement past Se; lossless
    predictors 0 and 8, Pt 8, an MCU of 11 samples, a restart interval of
    a part of a row); scans ending in a marker or of garbage data, restart
    markers out of order and frames at the sides' ceiling (65535) decode or
    are refused. The sanitizers report nothing."""
    native = ROOT / "imagekit_tpu_torch" / "codecs" / "native"
    so = tmp_path / "libjpeg4_asan.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fPIC", "-shared",
                    "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined",
                    str(native / "jpeg4_decode.cpp"), "-o", str(so)],
                   check=True, timeout=300)
    good, hostile, edge = _arith_lossless_cases()
    cases = {f"{kind}/{k}": v.hex() for kind, group in (
        ("good", good), ("hostile", hostile), ("edge", edge))
        for k, v in group.items()}
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    env = {**os.environ, "LD_PRELOAD": asan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _JPEG4, str(so)],
                          input=json.dumps(cases), capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, r in res.items():
        kind = name.split("/")[0]
        if kind == "good":
            assert r["parse"] == 0 and r["decode"] == 0, (name, r)
            assert r["coding"] == (2 if "lossless" in name else 1), (name, r)
        elif kind == "hostile":
            assert r["parse"] < 0 or r["decode"] < 0, (name, r)
    assert res["edge/scan_ending_in_marker"]["decode"] == 0
    assert res["edge/rst_out_of_order"]["decode"] == 0
    assert res["hostile/lossless_mcu_of_11"]["parse"] == -8


_AV1 = textwrap.dedent("""
    import ctypes, hashlib, json, sys
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    lib = ctypes.CDLL(sys.argv[1])
    av1_dec_abi.load(lib)
    out = {}
    for name, hexdata in json.loads(sys.stdin.read()).items():
        data = bytes.fromhex(hexdata)
        buf = ctypes.create_string_buffer(data, len(data))  # exact size
        try:
            y, u, v, info = av1_dec_abi.decode(buf.raw, lib)
            h = hashlib.sha256(y.tobytes())
            for p in (u, v):
                if p is not None:
                    h.update(p.tobytes())
            out[name] = h.hexdigest()
        except ValueError:
            out[name] = "400"
    print(json.dumps(out))
""")


#: the QM and grain cases of the AV1 harness, by the names it gives them
QM_GRAIN_CASES = ("pillow_qm_420", "pillow_grain_444", "pillow_grain_420",
                  "hbd_qm_grain_420", "hbd_qm_grain_444")


def _qm_grain_writers() -> bool:
    """Pillow's AVIF writer and libavif, which write the QM and grain
    cases."""
    import ctypes

    from tests.test_torch_av1_decode import _have_pillow_avif

    try:
        ctypes.CDLL("libavif.so.15")
    except OSError:
        return False
    return _have_pillow_avif()


def _av1_cases():
    """(good streams with their planes' digest from the normal build,
    hostile streams)."""
    import hashlib
    import io

    import numpy as np
    from PIL import Image

    from imagekit_tpu_torch.codecs import avif_encode
    from imagekit_tpu_torch.codecs.avif_native import parse_container
    from imagekit_tpu_torch.codecs.native import av1_dec_abi
    from tests.test_torch_av1_decode import hostile_streams, seq_header, synth

    files = {"own_420": avif_encode.encode_rgb(synth(96, 64, seed=1), 60)}
    for name, w, h, kw in (
            ("pillow_422_odd", 37, 21, dict(subsampling="4:2:2")),
            ("pillow_444", 64, 48, dict(subsampling="4:4:4")),
            ("pillow_lr", 160, 96, dict(speed=4, quality=20)),
            ("pillow_cdef", 128, 96,
             dict(advanced=[("enable-cdef", "1")], quality=40))):
        buf = io.BytesIO()
        try:
            Image.fromarray(synth(w, h, seed=w, kind="edges")).save(
                buf, "AVIF", **{"quality": 50, **kw})
        except Exception:  # no AVIF writer: the port's encoder's only
            continue
        files[name] = buf.getvalue()
    rgba = np.dstack([synth(48, 32), np.full((32, 48), 100, np.uint8)])
    files["own_alpha"] = avif_encode.encode_rgb(rgba, 70)
    # quantizer matrices and film grain: 4:2:0 and 4:4:4, 8 and 10 bits,
    # where their writers are at hand (the test asserts these cases then)
    if _qm_grain_writers():
        from tests.fixtures.make_avif_sources import encode_avif_hbd
        from tests.test_torch_av1_screen_hbd import hbd_picture

        for name, sub, adv in (
                ("pillow_qm_420", "4:2:0", [("tune", "iq")]),
                ("pillow_grain_444", "4:4:4", [("film-grain-test", "16")]),
                ("pillow_grain_420", "4:2:0", [("film-grain-test", "10")])):
            buf = io.BytesIO()
            Image.fromarray(synth(75, 53, seed=7)).save(
                buf, "AVIF", quality=50, subsampling=sub, advanced=adv)
            files[name] = buf.getvalue()
        for layout in ("420", "444"):
            files[f"hbd_qm_grain_{layout}"] = encode_avif_hbd(
                *hbd_picture(67, 45, 10, layout, 3), 10, layout, 30, 6,
                {"enable-qm": "1", "film-grain-test": "3"})
    good = {}
    # palette blocks, intra block copy and a 10-bit frame, where their
    # writers are at hand
    from tests.test_torch_av1_decode import tool_streams

    for name, stream in tool_streams().items():
        y, u, v, _ = av1_dec_abi.decode(stream)
        digest = hashlib.sha256(y.tobytes())
        digest.update(u.tobytes())
        digest.update(v.tobytes())
        good[f"tool_{name}"] = (stream, digest.hexdigest())
    for name, data in files.items():
        info = parse_container(data)
        for item, stream in (("", info.obu), ("_alpha", info.alpha_obu)):
            if not stream:
                continue
            y, u, v, _ = av1_dec_abi.decode(stream)
            digest = hashlib.sha256(y.tobytes())
            for p in (u, v):
                if p is not None:
                    digest.update(p.tobytes())
            good[name + item] = (stream, digest.hexdigest())
    hostile = {f"h{i}": s for i, s in enumerate(hostile_streams())}
    if _qm_grain_writers():
        # grain params libdav1d refuses, and byte flips over a stream's
        from tests.test_torch_av1_qm_grain import hostile_grain, with_grain

        base = parse_container(files["pillow_grain_420"]).obu
        for i, g in enumerate(hostile_grain().values()):
            hostile[f"grain{i}"] = with_grain(base, g)
        rng = np.random.default_rng(9)
        for i in range(12):
            m = bytearray(base)
            m[int(rng.integers(8, 40))] ^= int(rng.integers(1, 256))
            hostile[f"grain_flip{i}"] = bytes(m)
    # a header that claims 65536 x 65536 with no tile data
    hostile["huge"] = seq_header(65535, 65535)[:0] + bytes([0x0A, 0x0B, 0x00,
                                                           0x00, 0x00, 0x24,
                                                           0xFF, 0xFF, 0xFF,
                                                           0xFF, 0xC0, 0x00])
    return good, hostile


@pytest.fixture(scope="module")
def av1_asan_lib():
    """The port's native library built with ASan and UBSan
    (``loader.sanitizer_build``: every source, ``av1_decode.cpp`` and
    ``avif_scale.cpp`` among them, one g++ a source, all at once, then the
    link), once for this file's tests and for the fuzz of
    ``test_torch_fuzz.py``, which loads the same build."""
    from imagekit_tpu_torch.codecs.native import loader

    return loader.sanitizer_build()


def test_av1_decoder_under_address_sanitizer(av1_asan_lib):
    """``av1_decode.cpp`` under ASan and UBSan, each stream in a buffer of
    exactly its size: real streams (palette, intrabc and 10-bit ones
    among them) decode to the normal build's planes (digests), hostile
    ones (their truncations and byte flips, an intrabc vector outside its
    tile) decode or are refused, and the sanitizers report nothing."""
    so = av1_asan_lib
    good, hostile = _av1_cases()
    cases = {**{k: v[0].hex() for k, v in good.items()},
             **{k: v.hex() for k, v in hostile.items()}}
    # the decoder leaves a malformed stream by a C++ throw: ASan's
    # interceptor of it needs libstdc++ loaded at start-up as well
    asan, cxx = (subprocess.run(["g++", f"-print-file-name={lib}"],
                                capture_output=True, text=True).stdout.strip()
                 for lib in ("libasan.so", "libstdc++.so.6"))
    env = {**os.environ, "LD_PRELOAD": f"{asan} {cxx}",
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _AV1, str(so)],
                          input=json.dumps(cases), capture_output=True,
                          text=True, env=env, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, (_stream, digest) in good.items():
        assert res[name] == digest, name
    assert set(res) == set(cases)
    assert res["huge"] == "400"
    assert res["h4"] == "400"  # hostile_streams' intrabc vector off its tile
    from tests.fixtures.make_avif_sources import _aom_lib

    if _aom_lib() is not None:  # the superres seed and its splices ran
        from tests.test_torch_av1_superres import hostile_superres_streams

        assert "tool_superres" in good
        assert set(hostile_superres_streams()) <= set(hostile.values())
    if not _qm_grain_writers():
        pytest.skip("Pillow's AVIF writer or libavif unavailable: the QM "
                    "and grain cases were not written")
    assert all(name in good for name in QM_GRAIN_CASES)
    refused = [n for n in res if n.startswith("grain") and "flip" not in n]
    assert refused and all(res[n] == "400" for n in refused), refused


_YUV_RGB = textwrap.dedent("""
    import ctypes, hashlib, json, sys
    import numpy as np
    from imagekit_tpu_torch.codecs.native import avif_yuv_rgb
    from tests.test_torch_kernel_asan import yuv_rgb_cases

    lib = ctypes.CDLL(sys.argv[1]) if len(sys.argv) > 1 else None
    if lib is not None:
        avif_yuv_rgb.load(lib)
    out = {}
    for name, (args, kw) in yuv_rgb_cases().items():
        try:
            rgb = avif_yuv_rgb.convert(*args, **kw, lib=lib)
            out[name] = hashlib.sha256(rgb.tobytes()).hexdigest()
        except avif_yuv_rgb.Refused:
            out[name] = "refused"
    print(json.dumps(out))
""")


def yuv_rgb_cases() -> dict:
    """name -> (convert's arguments, keywords): every path of
    ``avif_yuv_rgb.cpp`` on seeded planes at odd sizes."""
    import numpy as np

    rng = np.random.default_rng(22)
    cases = {}
    for depth in (8, 10, 12):
        dt = np.uint8 if depth == 8 else np.uint16
        top = (1 << depth) - 1
        for layout in (0, 1, 2, 3):
            for w, h in ((1, 1), (2, 3), (37, 21)):
                cw = w if layout == 3 else (w + 1) // 2
                ch = (h + 1) // 2 if layout == 1 else h
                y = rng.integers(0, top + 1, (h, w)).astype(dt)
                u = rng.integers(0, top + 1, (ch, cw)).astype(dt)
                v = rng.integers(0, top + 1, (ch, cw)).astype(dt)
                a = rng.integers(0, top + 1, (h, w)).astype(dt)
                a[0, 0] = 1  # the unattenuate's saturating corner
                if layout == 0:
                    u = v = None
                for matrix, full, prim in ((6, False, 1), (1, True, 1),
                                           (9, False, 9), (12, True, 7),
                                           (4, True, 1), (0, True, 1),
                                           (8, True, 1), (16, True, 1),
                                           (3, True, 1)):
                    for alpha, prem in ((False, False), (True, False),
                                        (True, True)):
                        name = (f"{depth}_{layout}_{w}x{h}_{matrix}"
                                f"{'f' if full else 'l'}{'a' if alpha else ''}"
                                f"{'p' if prem else ''}")
                        cases[name] = ((y, u, v, a if alpha else None, depth,
                                        layout, full, matrix, prim, prem),
                                       {"threads": 1 + (w * h) % 3})
    return cases


def test_yuv_rgb_under_address_sanitizer(tmp_path):
    """``avif_yuv_rgb.cpp`` under ASan and UBSan: every case's pixels equal
    the normal build's, and the sanitizers report nothing."""
    native = ROOT / "imagekit_tpu_torch" / "codecs" / "native"
    so = tmp_path / "libyuvrgb_asan.so"
    subprocess.run(["g++", "-std=c++17", "-O1", "-g", "-fPIC", "-shared",
                    "-ffp-contract=off", "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined",
                    str(native / "avif_yuv_rgb.cpp"), "-o", str(so)],
                   check=True, timeout=300)
    normal = subprocess.run([sys.executable, "-c", _YUV_RGB],
                            capture_output=True, text=True, timeout=600,
                            cwd=ROOT)
    assert normal.returncode == 0, normal.stderr[-6000:]
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    env = {**os.environ, "LD_PRELOAD": asan,
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _YUV_RGB, str(so)],
                          capture_output=True, text=True, env=env,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = json.loads(normal.stdout.strip().splitlines()[-1])
    assert got == want
    assert sum(v == "refused" for v in got.values()) >= 12
    assert len(got) == len(yuv_rgb_cases())


_REMAINDER = textwrap.dedent("""
    import ctypes, hashlib, json, sys
    from imagekit_tpu_torch.codecs.native import av1_dec_abi, avif_scale
    from tests.test_torch_kernel_asan import scale_cases

    lib = ctypes.CDLL(sys.argv[1]) if len(sys.argv) > 1 else None
    if lib is not None:
        av1_dec_abi.load(lib)
        avif_scale.load(lib)
    out = {}
    for name, hexdata in json.loads(sys.stdin.read()).items():
        data = bytes.fromhex(hexdata)
        buf = ctypes.create_string_buffer(data, len(data))  # exact size
        for select, op in ((-1, 0), (-2, 0), (0, 0), (1, 0), (3, 0),
                           (-2, 1), (-2, 7), (-1, 40)):
            key = f"{name}/{select}/{op}"
            try:
                y, u, v, info = av1_dec_abi.decode_samples(
                    buf.raw, lib, select=select, op=op)
                h = hashlib.sha256(y.tobytes())
                for p in (u, v):
                    if p is not None:
                        h.update(p.tobytes())
                out[key] = h.hexdigest()
            except ValueError:
                out[key] = "400"
    for name, (plane, size, crop, threads) in scale_cases().items():
        got = avif_scale.scale_plane(plane, *size, crop, threads, lib=lib)
        out[name] = hashlib.sha256(got.tobytes()).hexdigest()
    print(json.dumps(out))
""")


def scale_cases() -> dict:
    """name -> (plane, (width, height), crop, threads): every path of
    ``avif_scale.cpp`` at 8 and 16 bits, on seeded planes of odd and
    one-sample sides, crops and thread counts."""
    import numpy as np

    rng = np.random.default_rng(24)
    sizes = (((1, 1), (3, 2)), ((1, 7), (2, 9)), ((9, 1), (20, 1)),
             ((37, 21), (37, 9)), ((37, 21), (37, 50)), ((48, 32), (36, 24)),
             ((48, 32), (24, 16)), ((64, 32), (24, 12)), ((48, 32), (12, 8)),
             ((50, 30), (13, 7)), ((24, 16), (47, 31)), ((24, 16), (47, 16)),
             ((24, 16), (61, 39)), ((48, 32), (31, 21)), ((45, 30), (15, 30)),
             ((45, 30), (60, 10)), ((333, 129), (1000, 7)))
    cases = {}
    for depth in (8, 12):
        dt = np.uint8 if depth == 8 else np.uint16
        for (sw, sh), (dw, dh) in sizes:
            p = rng.integers(0, 1 << depth, (sh, sw)).astype(dt)
            for crop, threads in ((None, 1), ((max(1, dw // 2), dh), 3),
                                  ((dw, max(1, dh - 1)), 0)):
                cases[f"{depth}_{sw}x{sh}_{dw}x{dh}_{crop}_{threads}"] = (
                    p, (dw, dh), crop, threads)
    return cases


def _remainder_streams() -> dict:
    """The streams of the last remainder with their cuts and byte flips:
    layered (a full and a half base), a hidden key frame (with grain), a
    progressive one whose top layer is an INTER frame."""
    import numpy as np

    from tests import test_torch_avif_remainder as R
    from tests.fixtures import make_avif_sources as M

    streams = {
        "layered_full": M.demux(R.layered("full"))["items"][0]["payload"],
        "layered_half": M.demux(R.layered("half"))["items"][0]["payload"],
        "hidden_key": R.hidden_key(),
        "hidden_key_grain": R.hidden_key(**{"film-grain-test": 4}),
        "progressive": M.demux(R.progressive())["items"][0]["payload"],
    }
    rng = np.random.default_rng(25)
    for name, data in list(streams.items()):
        for i, cut in enumerate(rng.integers(1, len(data), 4)):
            streams[f"{name}_cut{i}"] = data[:int(cut)]
        for i in range(4):
            m = bytearray(data)
            m[int(rng.integers(0, min(len(data), 64)))] ^= \
                int(rng.integers(1, 256))
            streams[f"{name}_flip{i}"] = bytes(m)
    return streams


def test_obu_selection_and_scaler_under_address_sanitizer(av1_asan_lib):
    """``av1_decode.cpp``'s walk over a temporal unit (layers, hidden
    frames, show_existing_frame, every selection and operating point) and
    ``avif_scale.cpp`` under ASan and UBSan: each stream in a buffer of
    exactly its size, cut short or flipped, decodes to the normal build's
    planes or answers as it does, every scaler case to the normal build's
    samples, and the sanitizers report nothing."""
    from tests.fixtures.make_avif_sources import _aom_lib

    if _aom_lib() is None:
        pytest.skip("libaom.so.3 (the streams' writer) unavailable")
    so = av1_asan_lib
    cases = json.dumps({k: v.hex() for k, v in _remainder_streams().items()})
    normal = subprocess.run([sys.executable, "-c", _REMAINDER],
                            input=cases, capture_output=True, text=True,
                            timeout=600, cwd=ROOT)
    assert normal.returncode == 0, normal.stderr[-6000:]
    asan, cxx = (subprocess.run(["g++", f"-print-file-name={lib}"],
                                capture_output=True, text=True).stdout.strip()
                 for lib in ("libasan.so", "libstdc++.so.6"))
    env = {**os.environ, "LD_PRELOAD": f"{asan} {cxx}",
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _REMAINDER, str(so)],
                          input=cases, capture_output=True, text=True,
                          env=env, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = json.loads(normal.stdout.strip().splitlines()[-1])
    assert got == want
    assert len(got) == 8 * len(json.loads(cases)) + len(scale_cases())
    # the walk's answers: the base and the top of the layers, the hidden
    # key frame, the INTER top layer (decoded since inter prediction is
    # built), an operating point past 31
    assert got["layered_half/-1/0"] != got["layered_half/-2/0"]
    assert got["layered_half/0/0"] == got["layered_half/-1/0"]
    assert got["layered_half/1/0"] == got["layered_half/-2/0"]
    assert got["layered_half/-2/1"] == got["layered_half/-1/0"]
    assert got["layered_half/3/0"] == "400"
    assert got["hidden_key/-1/0"] != "400"
    assert got["progressive/-2/0"] != "400"
    assert got["progressive/-1/0"] != "400"
    assert got["layered_full/-1/40"] == "400"


_INTER = textwrap.dedent("""
    import ctypes, hashlib, json, sys
    from imagekit_tpu_torch.codecs.native import av1_dec_abi

    lib = ctypes.CDLL(sys.argv[1]) if len(sys.argv) > 1 else None
    if lib is not None:
        av1_dec_abi.load(lib)
    out = {}
    for name, hexdata in json.loads(sys.stdin.read()).items():
        data = bytes.fromhex(hexdata)
        buf = ctypes.create_string_buffer(data, len(data))  # exact size
        try:
            y, u, v, info = av1_dec_abi.decode_samples(
                buf.raw, lib, select=av1_dec_abi.LAST)
            h = hashlib.sha256(y.tobytes())
            for p in (u, v):
                if p is not None:
                    h.update(p.tobytes())
            out[name] = [h.hexdigest(), info.tools]
        except ValueError:
            out[name] = ["400", {}]
    print(json.dumps(out))
""")


def test_inter_decoder_under_address_sanitizer(av1_asan_lib):
    """``av1_decode.cpp``'s inter prediction under ASan and UBSan, each
    stream in a buffer of exactly its size: streams of every inter tool
    (``make_avif_sources.INTER_CASES``, all frames to the last) decode to
    the normal build's planes; hostile ones
    (``test_torch_av1_inter.hostile_inter_streams``: references at and
    past the 2x / 16x rule, empty slots, tiles cut short, byte flips that
    send vectors far outside the frame and give local warps invalid
    shears) decode as the normal build does or are refused as it refuses
    them; the sanitizers report nothing."""
    from tests.fixtures.make_avif_sources import INTER_CASES, _aom_lib

    if _aom_lib() is None:
        pytest.skip("libaom.so.3 (the streams' writer) unavailable")
    from tests.test_torch_av1_inter import hostile_inter_streams, stream

    cases = {f"good/{k}": stream(k)[0] for k in INTER_CASES}
    cases.update({f"hostile/{k}": v
                  for k, v in hostile_inter_streams().items()})
    cases = json.dumps({k: v.hex() for k, v in cases.items()})
    normal = subprocess.run([sys.executable, "-c", _INTER],
                            input=cases, capture_output=True, text=True,
                            timeout=600, cwd=ROOT)
    assert normal.returncode == 0, normal.stderr[-6000:]
    asan, cxx = (subprocess.run(["g++", f"-print-file-name={lib}"],
                                capture_output=True, text=True).stdout.strip()
                 for lib in ("libasan.so", "libstdc++.so.6"))
    env = {**os.environ, "LD_PRELOAD": f"{asan} {cxx}",
           "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=1",
           "UBSAN_OPTIONS": "print_stacktrace=1:halt_on_error=1"}
    proc = subprocess.run([sys.executable, "-c", _INTER, str(av1_asan_lib)],
                          input=cases, capture_output=True, text=True,
                          env=env, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-6000:]
    assert "Sanitizer" not in proc.stderr, proc.stderr[-6000:]
    assert "runtime error" not in proc.stderr, proc.stderr[-6000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    want = json.loads(normal.stdout.strip().splitlines()[-1])
    assert got == want
    assert all(got[f"good/{k}"][0] != "400" for k in INTER_CASES)
    assert got["hostile/size_past_2x"][0] == "400"
    assert got["hostile/size_past_16x"][0] == "400"
    assert got["hostile/empty_slots"][0] == "400"
    assert got["hostile/size_16x_smaller"][1]["scaled"] > 0
    for tool in ("mv_outside", "warp_invalid"):
        assert sum(t.get(tool, 0) for _, t in got.values()), tool


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
