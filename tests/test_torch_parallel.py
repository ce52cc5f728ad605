"""The port's device grid against the JAX package's mesh, on the CPU.

The JAX package runs here on eight virtual CPU devices
(``tests/conftest.py``); the port's grid is eight ``torch.device("cpu")``
replicas, each shard of it one call of a head's plain version. The same
seeded numpy inputs go through both:

- ``parallel.mesh.make_mesh``: the grid's shape against the reference's,
  the same ``ValueError``\\ s, and no grid without a card unless devices are
  named;
- ``parallel.sharding.sharded_resample``: data parallel over 8 and spatial
  over 2 x 4 against the reference's; ``shard_batch``'s pieces;
- ``parallel.tiling.resize_oversized`` over a 4-space grid against the
  reference's on ``make_mesh(4, space=4)``: 900x120 -> 90x12, 8400x24, an
  H that 4 does not divide, a gray image;
- a height shard whose output rows lie wholly in other shards (empty
  bands), through K2's f32 entry compiled with g++ under the CPU shim of
  ``tests/test_torch_kernel_cpu.py``: exactly 0 there; each shard
  launched over its own output rows only (``row_spans``), a shard with
  none not launched;
- ``tiling.split_grid``: an image beyond the ladder splits only where the
  first device cannot hold it;
- the split-int8 escapes: each shard's scatter, concatenated, equals the
  batch's, escapes on the shards' edges included;
- ``BatchedEngine(device="cpu", mesh=<8 replicas>)`` against the JAX
  engine on its 8-device mesh (what each hands its host encoders) and
  against the port's one-device engine (the bodies, byte for byte): JPEG
  -> WebP with escapes in items of several shards (K1's plain version),
  PNG -> WebP and JPEG, lossy WebP -> WebP, k=8 JPEG -> JPEG (levels
  exact), and a batch of 4 on 8 devices, which runs unsharded; the exact
  path on a grid with and without room on the first device; every batch
  head's device views (``host=False``) against its own readback; weight
  trees built once for every device; a failed shard failing its batch.

Tolerance: u8 within max |d| <= 1 on at most 0.1% of values (fp32 sums in
another order; the reference's own band, tests/test_pallas_jpeg8.py:72),
expected 0; jxc levels exact; f32 partials within rtol 1e-5.
"""

import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from imagekit_tpu import config as ref_config
from imagekit_tpu.codecs import vp8 as ref_vp8
from imagekit_tpu.codecs.native import loader as ref_loader
from imagekit_tpu.parallel import mesh as ref_mesh
from imagekit_tpu.parallel import sharding as ref_sharding
from imagekit_tpu.parallel import tiling as ref_tiling
from imagekit_tpu.serving.batcher import BatchedEngine as RefEngine
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch.codecs import vp8
from imagekit_tpu_torch.codecs.jpeg import source_header
from imagekit_tpu_torch.codecs.native import jpeg_abi, loader
from imagekit_tpu_torch.config import ImageFormat
from imagekit_tpu_torch.ops import _build, resize_strip
from imagekit_tpu_torch.ops import weights as port_w
from imagekit_tpu_torch.parallel import dryrun, mesh, sharding, tiling
from imagekit_tpu_torch.serving import batcher, engine_jpeg, engine_rgb
from imagekit_tpu_torch.serving import engine_yuv
from imagekit_tpu_torch.serving import jpeg_transport as jt
from imagekit_tpu_torch.serving.batcher import BatchedEngine as PortEngine
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.utils.bucketing import batch_bucket, bucket_for
from tests.conftest import cpu_devices, encode_png, make_test_image
from tests.test_batcher import _noisy_jpeg
from tests.test_torch_jxc_slice import _ref_native_lib, jpeg_sig
from tests.test_torch_kernel_cpu import CSRC, SHIM
from tests.test_torch_resize import assert_band
from tests.test_torch_rgba_slice import _cfg, _drive
from tests.test_torch_standalone import _heads as _standalone_heads
from tests.test_vp8_decode import _libwebp

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    """The reference's native library loaded before any test runs its
    decoders (``_ref_native_lib``: it is built in place with no lock)."""
    _ref_native_lib(monkeypatch)


def _diff(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert_band(got, want, what)
    n = int((got != want).sum())
    print(f"{what}: {n} of {got.size} values differ")
    return n


# -- parallel/mesh.py ------------------------------------------------------


@pytest.mark.parametrize("n, space", [(8, 1), (8, 2), (8, 4), (4, 4),
                                      (None, 1), (6, 3)])
def test_make_mesh_shape_matches_reference(n, space):
    want = ref_mesh.make_mesh(n, space=space, devices=cpu_devices())
    got = mesh.make_mesh(n, space=space, devices=CPU8)
    assert got.shape == want.devices.shape
    assert got.size == want.devices.size
    assert got.axis_names == tuple(want.axis_names) == ("data", "space")
    assert got.flat == tuple([torch.device("cpu")] * got.size)


@pytest.mark.parametrize("n, space", [(8, 3), (1000, 1), (9, 1), (4, 8)])
def test_make_mesh_refuses_what_the_reference_refuses(n, space):
    with pytest.raises(ValueError):
        ref_mesh.make_mesh(n, space=space, devices=cpu_devices())
    with pytest.raises(ValueError):
        mesh.make_mesh(n, space=space, devices=CPU8)


def test_make_mesh_without_a_card_raises(monkeypatch):
    """The default devices are the visible cards: none here, so no grid
    (no fallback to the CPU), while named CPU devices build one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mesh, "_default_mesh", None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.get_mesh()
    with pytest.raises(RuntimeError):
        tiling.resize_oversized(np.zeros((9000, 8, 3), np.uint8), 90, 4)
    grid = mesh.make_mesh(devices=["cpu", "cpu"])
    assert grid.shape == (2, 1) and grid.flat[1] == torch.device("cpu")


# -- parallel/sharding.py --------------------------------------------------


def _batch(B, H, W, C, OH, OW, seed):
    """Seeded (B, H, W, C) u8 images and per-image stacks of true sizes
    that vary with the image (zero pad rows and columns)."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((B, H, W, C), np.uint8)
    wv = np.zeros((B, OH, H), np.float32)
    wh = np.zeros((B, OW, W), np.float32)
    for b in range(B):
        th, tw = H - 3 * (b % 4), W - 5 * (b % 3)
        imgs[b, :th, :tw] = rng.integers(0, 256, (th, tw, C))
        wv[b] = port_w.padded_weights(th, OH - b % 3, H, OH)
        wh[b] = port_w.padded_weights(tw, OW - b % 2, W, OW)
    return imgs, wv, wh


@pytest.mark.parametrize("C", [1, 3, 4])
def test_data_parallel_resample_matches_reference(C):
    imgs, wv, wh = _batch(8, 64, 60, C, 32, 24, seed=C)
    want = np.asarray(ref_sharding.sharded_resample(
        imgs, wv, wh, ref_mesh.make_mesh(8, devices=cpu_devices())))
    got = sharding.sharded_resample(imgs, wv, wh,
                                    mesh.make_mesh(8, devices=CPU8))
    assert got.dtype == torch.uint8 and got.device == torch.device("cpu")
    _diff(got.numpy(), want, f"data parallel, {C} channels")


@pytest.mark.parametrize("C", [1, 3])
def test_spatial_resample_matches_reference(C):
    """2 data rows x 4 space columns: each column resizes its 32 rows to
    f32 partials, summed on the first device, then rounded."""
    imgs, wv, wh = _batch(2, 128, 64, C, 48, 40, seed=10 + C)
    want = np.asarray(ref_sharding.sharded_resample(
        imgs, wv, wh, ref_mesh.make_mesh(8, space=4, devices=cpu_devices()),
        spatial=True))
    grid = mesh.make_mesh(8, space=4, devices=CPU8)
    got = sharding.sharded_resample(imgs, wv, wh, grid, spatial=True)
    _diff(got.numpy(), want, f"spatial, {C} channels")


@pytest.mark.parametrize("spatial", [False, True])
def test_shard_batch_pieces(spatial):
    grid = mesh.make_mesh(8, space=2, devices=CPU8)
    x = np.arange(8 * 6 * 4 * 3, dtype=np.int32).reshape(8, 6, 4, 3)
    w = np.arange(8 * 5 * 6, dtype=np.float32).reshape(8, 5, 6)
    xs = sharding.shard_batch(x, grid, spatial=spatial)
    ws = sharding.shard_batch(w, grid, spatial=spatial)
    assert len(xs) == 4 and all(len(row) == 2 for row in xs)
    for r in range(4):
        for c in range(2):
            rows = slice(3 * c, 3 * c + 3) if spatial else slice(None)
            assert xs[r][c].is_contiguous()
            np.testing.assert_array_equal(xs[r][c].numpy(),
                                          x[2 * r:2 * r + 2, rows])
            np.testing.assert_array_equal(ws[r][c].numpy(),
                                          w[2 * r:2 * r + 2, :, rows])
    with pytest.raises(ValueError):
        sharding.shard_batch(x[:6], grid)  # 6 items over 4 data rows


# -- parallel/tiling.py: the mesh branch ------------------------------------


@pytest.mark.parametrize("h, w, oh, ow, gray", [
    (900, 120, 90, 12, False),
    (8400, 24, 840, 3, False),
    (901, 40, 45, 20, False),   # H not divisible by 4: padded, zero weights
    (602, 32, 61, 16, True),
])
def test_resize_oversized_on_a_space_grid_matches_reference(h, w, oh, ow,
                                                            gray):
    img = make_test_image(w, h)
    if gray:
        img = img[:, :, 1]
    want = ref_tiling.resize_oversized(
        img, oh, ow, mesh=ref_mesh.make_mesh(4, space=4,
                                             devices=cpu_devices()[:4]))
    grid = mesh.make_mesh(4, space=4, devices=CPU8[:4])
    got = tiling.resize_oversized(img, oh, ow, mesh=grid)
    assert got.shape == want.shape == (oh, ow, 1 if gray else 3)
    _diff(got, want, f"{h}x{w} -> {oh}x{ow} over 4 rows shards")
    # the one-device branch is the same resample
    one = tiling.resize_oversized(img, oh, ow, device="cpu")
    assert_band(got, one, "grid against one device")


# -- K2's f32 entry on a height shard: empty bands --------------------------


@pytest.fixture(scope="module")
def strip_lib(tmp_path_factory):
    """``csrc/resize_strip.cu`` compiled with g++ under the CPU shim (one
    thread a block, shared memory filled with NaN)."""
    d = tmp_path_factory.mktemp("strip_cpu")
    (d / "cuda_runtime.h").write_text(SHIM)
    so = d / "libik_strip_cpu.so"
    subprocess.run(
        [shutil.which("g++"), "-std=c++17", "-O1", "-ffp-contract=off",
         "-fPIC", "-shared", "-I", str(d), "-x", "c++",
         str(CSRC / "resize_strip.cu"), "-o", str(so)],
        check=True, capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ik_resize_strip_f32.argtypes = [vp, ci, ci, vp,
                                        ctypes.POINTER(_build.BandInfo)]
    lib.ik_resize_strip_f32.restype = ci
    return lib


def _f32_launch(lib, planes, wv, wh, vidx, strip=0):
    """One launch of K2's f32 entry over ``planes`` with one stack pair."""
    tabs = resize_strip.resize_tables(wv, wh)
    outs, recs = [], []
    for x in planes:
        B, ih, iw = x.shape
        out = torch.empty((B, wv.shape[1], wh.shape[1]), dtype=torch.float32)
        recs.append(resize_strip.plane_record(
            x.data_ptr(), ih * iw, iw, 1, wv, tabs, vidx, vidx, out,
            out.shape[1] * out.shape[2], 0, ih, iw, strip=strip))
        outs.append(out)
    _build.launch_band(lib.ik_resize_strip_f32, recs, planes[0].shape[0],
                       None)
    return outs


@pytest.mark.parametrize("strip", [0, 16], ids=["whole_rows", "strips"])
@pytest.mark.parametrize("shard", [0, 1, 3])
def test_height_shard_with_empty_bands_is_exactly_zero(strip_lib, shard,
                                                       strip):
    """400 rows -> 40 over 4 shards of 100: an output row whose Lanczos
    support lies wholly in another shard has an empty band in this shard's
    slice of Wv, and its partial is exactly 0; the rest holds to the plain
    product, and the four partials sum to the unsharded product."""
    rng = np.random.default_rng(shard)
    H, W, OH, OW, C = 400, 64, 40, 48, 3
    img = rng.integers(0, 256, (2, H, W, C), dtype=np.uint8)
    wv = np.stack([port_w.resample_weights(H, OH)] * 2)
    wh = np.stack([port_w.resample_weights(W, OW)] * 2)
    rows = slice(100 * shard, 100 * shard + 100)
    wv_s = torch.from_numpy(np.ascontiguousarray(wv[:, :, rows]))
    empty = ~(wv_s[0] != 0).any(dim=1)
    assert 0 < int(empty.sum()) < OH
    planes = list(torch.from_numpy(img[:, rows]).permute(3, 0, 1, 2)
                  .contiguous().unbind(0))
    v = torch.arange(2, dtype=torch.int32)
    wh_t = torch.from_numpy(wh)
    got = _f32_launch(strip_lib, planes, wv_s, wh_t, v, strip)
    plain = resize_strip.planes_resize_f32(planes, wv_s, wh_t, v)
    for g, p in zip(got, plain):
        assert torch.equal(g[:, empty], torch.zeros_like(g[:, empty]))
        torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-3)
    # the partials of all four shards sum to the unsharded product
    full = sum(
        torch.stack(resize_strip.planes_resize_f32(
            list(torch.from_numpy(img[:, 100 * s:100 * s + 100])
                 .permute(3, 0, 1, 2).contiguous().unbind(0)),
            torch.from_numpy(np.ascontiguousarray(
                wv[:, :, 100 * s:100 * s + 100])), wh_t, v))
        for s in range(4))
    whole = torch.stack(resize_strip.planes_resize_f32(
        list(torch.from_numpy(img).permute(3, 0, 1, 2).contiguous()
             .unbind(0)), torch.from_numpy(wv), wh_t, v))
    torch.testing.assert_close(full, whole, rtol=1e-5, atol=1e-3)


# -- serving/jpeg_transport.py: the escapes of each shard --------------------


def _split_items(k, n=8, seed=0):
    """``n`` split-transport items of one bucket, each with escapes in each
    plane (the first and last items of every shard among them)."""
    rng = np.random.default_rng(seed)
    na = k * k - 1
    items = []
    for i in range(n):
        by, bx = 8 - i % 2, 12 - i % 3
        cy, cx = (by + 1) // 2, (bx + 1) // 2
        dc = [rng.integers(-500, 500, s).astype(np.int16)
              for s in ((by, bx), (cy, cx), (cy, cx))]
        ac = [rng.integers(-100, 100, s + (na,)).astype(np.int8)
              for s in ((by, bx), (cy, cx), (cy, cx))]
        esc = []
        for c, (h_, w_) in enumerate(((by, bx), (cy, cx), (cy, cx))):
            flat = rng.choice(h_ * w_ * na, 3 + i % 4, replace=False)
            vals = rng.integers(128, 900, len(flat)) * rng.choice([-1, 1],
                                                                 len(flat))
            esc += [(c, f, v) for f, v in zip(flat, vals)]
        items.append(types.SimpleNamespace(
            split=(dc, ac, np.asarray(esc, np.int64))))
    return items


def _scatter(ac, esc):
    a = torch.from_numpy(ac).to(torch.int32)
    i = torch.from_numpy(esc[0]).long()
    a.index_put_((i[:, 0], i[:, 1], i[:, 2]),
                 torch.from_numpy(esc[1]).to(torch.int32), accumulate=True)
    return a


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("k", [2, 8])
def test_escape_split_scatters_as_the_batch(k, shards):
    items = _split_items(k)
    dims = (8, 12, 4, 6)
    dcs, acs, escs = jt._pack_split(items, 8, *dims, k)
    dcs2, acs2, escs2 = jt._pack_split(items, 8, *dims, k, shards=shards)
    assert len(escs) == 1 and len(escs2) == shards
    m = 8 // shards
    for p in range(3):
        np.testing.assert_array_equal(dcs[p], dcs2[p])
        np.testing.assert_array_equal(acs[p], acs2[p])
        want = _scatter(acs[p], escs[0][p])
        got = torch.cat([_scatter(acs[p][j * m:(j + 1) * m], escs2[j][p])
                         for j in range(shards)])
        assert torch.equal(got, want)
        for j in range(shards):  # rebased, within the caps, padded with 0
            idx, val = escs2[j][p]
            live = val != 0
            assert len(val) == (port_w.LOWFREQ_ESC_Y if p == 0
                                else port_w.LOWFREQ_ESC_C)
            assert live.sum() > 0 and idx[live, 0].max() < m
            assert not idx[~live].any()


# -- the engine on a grid ---------------------------------------------------


def _capture_encoders(monkeypatch):
    """What each engine hands the host encoders, in call order: {"ref":
    [...], "port": [...]} (the reference's modules and the port's)."""
    got = {"ref": [], "port": []}
    for who, vp8_mod, loader_mod in (("ref", ref_vp8, ref_loader),
                                     ("port", vp8, loader)):
        real_vp8, real_jpeg = vp8_mod.encode_yuv420, loader_mod.encode_jpeg

        def rec_vp8(y, u, v, q, real=real_vp8, who=who):
            got[who].append(tuple(np.array(p) for p in (y, u, v)))
            return real(y, u, v, q)

        def rec_jpeg(planes, qtabs, width, height, real=real_jpeg, who=who):
            got[who].append(tuple(np.array(p) for p in planes))
            return real(planes, qtabs, width, height)

        monkeypatch.setattr(vp8_mod, "encode_yuv420", rec_vp8)
        monkeypatch.setattr(loader_mod, "encode_jpeg", rec_jpeg)
    return got


def _nearest(planes, candidates):
    """The candidate of the same shapes closest to ``planes``."""
    same = [c for c in candidates
            if [p.shape for p in c] == [p.shape for p in planes]]
    return min(same, key=lambda c: sum(
        np.abs(a.astype(np.int64) - b.astype(np.int64)).sum()
        for a, b in zip(c, planes)))


def _heads(monkeypatch):
    """Every call of the heads the engines' device steps make: (name,
    items in the call, the device it ran on)."""
    calls = []
    for mod, names in ((engine_jpeg, ("decode_resize_yuv_lowfreq_i8_batch",
                                      "decode_resize_yuv_i8_batch",
                                      "decode_resize_yuv_lowfreq_batch",
                                      "decode_resize_yuv_batch",
                                      "decode_resize_rgb_batch",
                                      "transcode_i8_batch")),
                       (engine_rgb, ("resample_rgb_yuv_batch",
                                     "resample_rgb_jpeg_batch",
                                     "resample_bucketed_flat")),
                       (engine_yuv, ("resize_yuv420_batch",
                                     "resize_yuv_jpeg_batch"))):
        for name in names:
            real = getattr(mod, name)

            def rec(*args, real=real, name=name, **kw):
                calls.append((name, args[0][0].shape[0] if isinstance(
                    args[0], tuple) else args[0].shape[0], kw["device"]))
                return real(*args, **kw)

            monkeypatch.setattr(mod, name, rec)
    return calls


def _noisy(seed, q=90):
    return _noisy_jpeg(640, 480, q, seed=seed)


def _clean_jpeg(seed, w=640, h=480, q=90):
    from tests.conftest import encode_jpeg_pil

    return encode_jpeg_pil(make_test_image(w, h)[:, ::-1] if seed % 2
                           else make_test_image(w, h), q)


def _k2_escapes(data):
    lib = loader.load()
    hdr = source_header(lib, data)
    return len(jpeg_abi.decode_lowfreq_i8(lib, data, 2, hdr)[3])


def _webp(seed):
    img = make_test_image(320, 240)
    return _libwebp(np.roll(img, 17 * seed, axis=1), 80)


# name: (sources, width, fmt, JAX signature (ref, nb) -> sig, items, head)
ENGINE_CASES = {
    "jpeg_webp_k2_escapes": (
        lambda: [_noisy(i, 95 if i in (0, 7) else 90) if i in (0, 3, 4, 7)
                 else _clean_jpeg(i) for i in range(8)],
        128, ImageFormat.webp,
        lambda ref, nb: jpeg_sig(ref, nb, "yuv", 2, (480, 640), 128),
        "decode_resize_yuv_lowfreq_i8_batch"),
    "png_webp": (
        lambda: [encode_png(np.roll(make_test_image(320, 240), 9 * i, 0))
                 for i in range(8)],
        100, ImageFormat.webp,
        lambda ref, nb: ("rgbyuv", ref._use_mesh(nb), nb, bucket_for(240),
                         bucket_for(320), bucket_for(75), bucket_for(100), 3),
        "resample_rgb_yuv_batch"),
    "png_jpeg": (
        lambda: [encode_png(np.roll(make_test_image(320, 240), 9 * i, 1))
                 for i in range(8)],
        100, ImageFormat.jpeg,
        lambda ref, nb: ("rgbjpg", ref._use_mesh(nb), nb, bucket_for(240),
                         bucket_for(320), bucket_for(75), bucket_for(100), 3),
        "resample_rgb_jpeg_batch"),
    "webp_webp": (
        lambda: [_webp(i) for i in range(8)],
        120, ImageFormat.webp,
        lambda ref, nb: ("yuvsrc", ref._use_mesh(nb), nb, bucket_for(240),
                         bucket_for(320), bucket_for(90), bucket_for(120),
                         2, 2, False, False),
        "resize_yuv420_batch"),
    "jpeg_jpeg_k8": (
        lambda: [_clean_jpeg(i, 320, 240) for i in range(8)],
        240, ImageFormat.jpeg,
        lambda ref, nb: jpeg_sig(ref, nb, "jxc", 8, (240, 320), 240),
        "transcode_i8_batch"),
    "png_webp_batch_of_4_unsharded": (
        lambda: [encode_png(np.roll(make_test_image(320, 240), 9 * i, 0))
                 for i in range(4)],
        100, ImageFormat.webp,
        lambda ref, nb: ("rgbyuv", ref._use_mesh(nb), nb, bucket_for(240),
                         bucket_for(320), bucket_for(75), bucket_for(100), 3),
        "resample_rgb_yuv_batch"),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_on_eight_replicas_matches_jax_mesh_and_one_device(
        monkeypatch, case):
    make, width, fmt, sig, head = ENGINE_CASES[case]
    datas = make()
    n = len(datas)
    widths = [width] * n
    if case.startswith("jpeg_webp"):  # escapes in items of several shards
        assert [bool(_k2_escapes(d)) for d in datas] == [
            i in (0, 3, 4, 7) for i in range(n)]
    got = _capture_encoders(monkeypatch)
    ref = RefEngine(_cfg(ref_config, n), metrics=RefMetrics())
    assert ref._mesh_ndev == 8
    marked = sig(ref, batch_bucket(n, n))
    ref._compiled.add(marked)
    ref_out = _drive(ref, datas, widths, fmt)
    assert ref.metrics.host_fallbacks == 0 and ref.metrics.batches == 1, (
        marked, sorted(ref._compiled - {marked}, key=repr))

    heads = _heads(monkeypatch)
    grid = PortEngine(_cfg(port_config, n), metrics=Metrics(), device="cpu",
                      mesh=mesh.make_mesh(8, devices=CPU8))
    assert grid._mesh_ndev == 8 and grid._use_mesh(n) == (n == 8)
    with dryrun.placements(grid) as seen:
        grid_out = _drive(grid, datas, widths, fmt)
    port_calls = got["port"][:]
    one = PortEngine(_cfg(port_config, n), metrics=Metrics(), device="cpu")
    one_out = _drive(one, datas, widths, fmt)

    # the grid's bodies are the one device's, byte for byte
    assert grid_out == one_out
    sharded = n == 8
    calls = [c for c in heads if c[0] == head]
    assert len(calls) == (n + 1 if sharded else 2), heads  # + one device
    grid_calls = calls[:-1]
    assert [c[1] for c in grid_calls] == ([1] * 8 if sharded else [n])
    assert sorted(seen) == (list(range(8)) if sharded else [0])
    assert all(dev == torch.device("cpu") for arrays in seen.values()
               for dev, _ in arrays)
    # what the grid engine handed its encoders, against the JAX mesh's
    assert len(port_calls) == len(got["ref"]) == n
    changed = 0
    for planes in port_calls:
        want = _nearest(planes, got["ref"])
        for name, g, w in zip(("y", "cb", "cr"), planes, want):
            if case == "jpeg_jpeg_k8":  # jxc levels exact
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                changed += _diff(g, w, f"{case} {name} {g.shape}")
    print(f"{case}: {changed} values differ from the JAX mesh's")


@pytest.mark.parametrize("fits", [True, False], ids=["fits", "too_big"])
def test_exact_path_on_a_grid_splits_only_what_one_device_cannot_hold(
        monkeypatch, fits):
    """An image beyond the ladder on an engine with a grid: resized on the
    first device where it fits there, as on the one-device engine, and its
    height split over 4 of the grid's devices (``sharded_resample`` with
    ``spatial``) where the first device's free memory cannot hold it; what
    it hands the encoder is the one-device engine's within the band."""
    import asyncio

    seen, resized = [], []
    real = sharding.sharded_resample

    def rec(imgs, wv, wh, grid, **kw):
        seen.append((grid.shape, kw))
        return real(imgs, wv, wh, grid, **kw)

    real_encode = batcher.encode_image

    def rec_encode(img, *args):
        resized.append(np.array(img))
        return real_encode(img, *args)

    monkeypatch.setattr(tiling, "sharded_resample", rec)
    monkeypatch.setattr(tiling, "free_bytes",
                        lambda dev: (1 << 40) if fits else 1000)
    monkeypatch.setattr(batcher, "encode_image", rec_encode)
    data = encode_png(make_test_image(16, 9000))
    for kw in ({"mesh": mesh.make_mesh(8, devices=CPU8)}, {}):
        engine = PortEngine(_cfg(port_config, 1), metrics=Metrics(),
                            device="cpu", **kw)

        async def run():
            try:
                return await engine.transform(data, None, 900,
                                              ImageFormat.webp, 80)
            finally:
                await engine.close()

        assert asyncio.run(run())[:4] == b"RIFF"
    assert seen == ([] if fits else [((1, 4), {"spatial": True})])
    assert resized[0].shape == resized[1].shape == (900, 2, 3)
    if fits:
        np.testing.assert_array_equal(resized[0], resized[1])
    _diff(resized[0], resized[1], "exact path, grid against one device")


@pytest.mark.parametrize("n, free, space", [
    (8, None, None),      # the CPU: no bound read, no split
    (8, 1 << 40, None),   # the image fits the first device
    (8, 1000, 4),
    (2, 1000, 2),
    (1, 1000, None),      # one device: nothing to split over
])
def test_split_grid_only_where_the_first_device_cannot_hold_the_image(
        monkeypatch, n, free, space):
    monkeypatch.setattr(tiling, "free_bytes", lambda dev: free)
    img = np.zeros((9000, 16, 3), np.uint8)
    assert tiling.one_device_bytes(img.shape, 900, 2) > 1000
    grid = tiling.split_grid(img, 900, 2, CPU8[:n])
    assert (grid is None) if space is None else grid.shape == (1, space)


@pytest.mark.parametrize("empty_shard", [False, True])
def test_height_shards_launch_only_their_output_rows(monkeypatch,
                                                     empty_shard):
    """Each height shard resizes only the run of output rows with a tap in
    its rows (``row_spans``), a shard with none is not launched, and the
    result is the unsharded product's within the band."""
    H, W, OH, OW = 256, 40, 64, 20
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    h = 192 if empty_shard else H  # the last shard's rows all pad rows
    wv = np.stack([port_w.padded_weights(h, OH, H, OH)] * 2)
    wh = np.stack([port_w.resample_weights(W, OW)] * 2)
    spans = sharding.row_spans(wv, 4)
    for c, (r0, r1) in enumerate(spans):
        taps = wv[:, :, 64 * c:64 * (c + 1)] != 0
        assert list(np.flatnonzero(taps.any(axis=(0, 2)))) == list(
            range(r0, r1))
    assert (spans[3] == (0, 0)) == empty_shard
    assert all(r1 - r0 < OH for r0, r1 in spans)
    launched = []
    real = sharding.shard_partials

    def rec(x, wv_s, wh_s, bands=None):
        launched.append(wv_s.shape[1])
        return real(x, wv_s, wh_s, bands)

    monkeypatch.setattr(sharding, "shard_partials", rec)
    got = sharding.sharded_resample(
        imgs, wv, wh, mesh.make_mesh(4, space=4, devices=CPU8[:4]),
        spatial=True)
    assert launched == [r1 - r0 for r0, r1 in spans if r1 > r0]
    _diff(got.numpy(), dryrun._golden(imgs, wv, wh), "row spans")


@pytest.mark.parametrize("head", sorted(_standalone_heads()))
def test_heads_give_device_views_for_the_grid_to_read_back(head):
    """``host=False`` (each shard of a grid's batch): the head's result as
    tensors, equal to what it reads back itself."""
    fn = _standalone_heads()[head]
    want, got = fn(device="cpu"), fn(device="cpu", host=False)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and isinstance(w, np.ndarray)
        np.testing.assert_array_equal(g.numpy(), w)


def test_weight_trees_are_built_once_for_every_device():
    """A cold key builds its CPU tree once, on the engine's device; the
    grid's other device takes a copy into its own cache."""
    grid = mesh.make_mesh(devices=["cpu", "cpu:0"])
    engine = PortEngine(_cfg(port_config, 8), metrics=Metrics(), mesh=grid)
    builds = []

    def build():
        builds.append(1)
        return torch.ones(3), (torch.zeros(2), None)

    try:
        trees = [engine._on_device("key", dev, build)
                 for dev in engine._grid * 2]
    finally:
        import asyncio

        asyncio.run(engine.close())
    assert len(builds) == 1 and len(engine._dweights) == 2
    assert all(len(cache) == 1 for cache in engine._dweights.values())
    assert trees[0] is trees[2] and trees[1] is trees[3]
    torch.testing.assert_close(trees[1][0], torch.ones(3))


def test_a_failed_shard_fails_its_batch(monkeypatch):
    """One shard's head raises: every request of the batch gets the error,
    no later shard is launched, and the batch is not run again
    unsharded."""
    import asyncio
    import itertools

    calls, count = [], itertools.count()
    real = engine_rgb.resample_rgb_yuv_batch

    def flaky(*args, **kw):
        calls.append(args[0].shape[0])
        if next(count) == 2:
            raise RuntimeError("shard failed")
        return real(*args, **kw)

    monkeypatch.setattr(engine_rgb, "resample_rgb_yuv_batch", flaky)
    datas = [encode_png(np.roll(make_test_image(320, 240), 9 * i, 0))
             for i in range(8)]
    engine = PortEngine(_cfg(port_config, 8), metrics=Metrics(),
                        device="cpu", mesh=mesh.make_mesh(8, devices=CPU8))

    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(d, 100, None, ImageFormat.webp, 85)
                for d in datas), return_exceptions=True)
        finally:
            await engine.close()

    outs = asyncio.run(run())
    assert all(isinstance(o, Exception) and "shard failed" in str(o)
               for o in outs), outs
    assert calls == [1] * 3


def test_engine_builds_no_grid_on_one_device():
    engine = PortEngine(_cfg(port_config, 4), metrics=Metrics(), device="cpu")
    assert engine._mesh is None and engine._mesh_ndev == 1
    assert not engine._use_mesh(4) and engine._grid == (engine.device,)
    assert batcher._all_cards("cpu") is False
    assert batcher._all_cards("cuda:0") is False


def test_dryrun_on_cpu_replicas():
    report = dryrun.dryrun_multichip(4, CPU8)
    assert report["grid"] == [2, 2]
    assert report["data_parallel"]["max_abs_err"] == 0
    assert report["spatial"]["max_abs_err"] <= 1
    assert report["engine"]["bodies_equal"]
    assert report["engine"]["shards"] == 4
