"""K1: the folded jpeg8 head, three planes in one hand-written CUDA launch.

Counterpart of ``imagekit_tpu/ops/pallas_jpeg8.py:81-267`` (the plane body
launched by ``_folded_plane_pallas``, and its two fronts
``_decode_resize_i8_pallas`` and ``_transcode_i8_pallas``). One call takes
a batch in the split-int8 transport as the engine uploads it (i16 DC
planes, planar i8 AC planes, escape lists of (img, row, planar col) and
i32 residuals) and, for Y, Cb and Cr: widen, add the escapes, dequantise,
run the k-point IDCT folded into the resize weights, +128, then either
the studio-range remap to u8, packed as ``split_yuv`` reads it (decode),
or the centred i8 planes of the JPEG -> JPEG transcode (``centered``).

:func:`folded_planes_i8` launches the kernel (``csrc/jpeg8_folded.cu``)
for CUDA tensors and raises on anything the kernel does not take. It takes
the plain version, :func:`folded_planes_i8_plain` (an i16 widen and
escape scatter, then :func:`folded_plane_plain` per plane), only for
tensors that lie on the CPU.

:func:`folded_planes_i16` is the same head on the int16 transport of an
escape-dense image (``dct.py:496-509,575-604``): one block-grouped i16
array per plane (level u*k+v of block column c at c*k*k + u*k+v), no
escapes. It launches the kernel's int16 entry, which differs in its
staging only; its plain version, :func:`folded_planes_i16_plain`, splits
the levels by ``reshape`` as the reference does and runs
:func:`folded_plane_plain`.

The folded stacks are banded (Lanczos taps times the IDCT basis): each
stack has a :func:`folded_bands` table of every output row's nonzero run,
the union over the IDCT index, and the kernel loops over it only. The
skipped terms are exact zeros, so the banded sums are the dense ones.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from imagekit_tpu_torch.ops.resize_strip import band_table
from imagekit_tpu_torch.ops.weights import _lowfreq_indices

#: kernel launches made by :func:`folded_planes_i8` and
#: :func:`folded_planes_i16` (read and reset by callers that must show the
#: main path went through the kernel)
LAUNCHES = 0
_launch_lock = threading.Lock()

_LUMA = (219.0 / 255.0, 16.0)
_CHROMA = (224.0 / 255.0, 128.0 * (1.0 - 224.0 / 255.0))


def folded_bands(w: torch.Tensor) -> torch.Tensor:
    """(U, k, O, n) folded stack -> (U, O, 2) int32 ``[first, last)`` of
    each output row's nonzero run, the union over the stack's second
    index (u for ``Wv_f``, v for ``Wh_f``)."""
    return band_table((w != 0).any(dim=1))


def _check_common(levels, named, qtabs, stacks, bands, vidx, k):
    """The checks both transports share: every tensor of ``named`` (and
    the tables, stacks and index) on the first level array's device, of its
    type and contiguous; k; the batch shapes. Returns (B, U)."""
    dev = levels.device
    named = {"qtabs": (qtabs, torch.float32), "vidx": (vidx, torch.int32),
             **named}
    for i, name in enumerate(("wv_y", "wh_y", "wv_c", "wh_c")):
        named[name] = (stacks[i], torch.float32)
        named[f"band_{name}"] = (bands[i], torch.int32)
    for name, (t, dtype) in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the levels on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k < 2 or k > 7:
        raise ValueError(f"k={k}: the folded head serves 2 <= k < 8")
    B = levels.shape[0]
    if tuple(qtabs.shape) != (B, 128) or tuple(vidx.shape) != (B,):
        raise ValueError(f"qtabs {tuple(qtabs.shape)} / vidx "
                         f"{tuple(vidx.shape)} do not fit B={B}")
    if any(s.dim() != 4 for s in stacks):
        raise ValueError("the folded stacks must be (U, k, O, n)")
    return B, stacks[0].shape[0]


def _check_stacks(p, rows, wv, wh, bv, bh, U, k):
    """Plane ``p``'s stacks and band tables against its ``rows`` block
    rows; returns (nblk, O, P)."""
    Uv, kv, O, wrows = wv.shape
    Uh, kh, P, nblk = wh.shape
    if (Uv, Uh) != (U, U) or (kv, kh) != (k, k) or wrows != rows:
        raise ValueError(f"plane {p}: stacks {tuple(wv.shape)} / "
                         f"{tuple(wh.shape)} do not fit k={k}, U={U}, "
                         f"rows={rows}")
    # the kernel clamps each run to its stack, so a table of the right
    # shape is memory-safe; folded_bands makes one that is exact
    if tuple(bv.shape) != (U, O, 2) or tuple(bh.shape) != (U, P, 2):
        raise ValueError(f"plane {p}: band tables {tuple(bv.shape)} / "
                         f"{tuple(bh.shape)} do not fit the stacks")
    return nblk, O, P


def _check(dcs, acs, escs, qtabs, stacks, bands, vidx, k):
    """Raise on what the kernel does not take; return each plane's
    (rows, pw, acw, nblk, O, P)."""
    named = {}
    for p, name in enumerate(("y", "cb", "cr")):
        named[f"{name}_dc"] = (dcs[p], torch.int16)
        named[f"{name}_ac"] = (acs[p], torch.int8)
        named[f"{name}_esc_idx"] = (escs[p][0], torch.int32)
        named[f"{name}_esc_val"] = (escs[p][1], torch.int32)
    B, U = _check_common(dcs[0], named, qtabs, stacks, bands, vidx, k)
    na = k * k - 1
    dims = []
    for p in range(3):
        wv, wh = stacks[:2] if p == 0 else stacks[2:]
        bv, bh = bands[:2] if p == 0 else bands[2:]
        dc, ac, (ei, ev) = dcs[p], acs[p], escs[p]
        if dc.dim() != 3 or ac.dim() != 3 or dc.shape[0] != B:
            raise ValueError(f"plane {p}: dc {tuple(dc.shape)} / ac "
                             f"{tuple(ac.shape)} are not (B, rows, n)")
        _, rows, pw = dc.shape
        nblk, O, P = _check_stacks(p, rows, wv, wh, bv, bh, U, k)
        if tuple(ac.shape[:2]) != (B, rows) or ac.shape[2] % na:
            raise ValueError(f"plane {p}: ac {tuple(ac.shape)} is not "
                             f"planar for k={k}")
        if nblk > pw or nblk > ac.shape[2] // na:
            raise ValueError(f"plane {p}: nblk={nblk} exceeds the "
                             f"coefficient planes")
        # the kernel reads four levels at a time: rows and planes start on
        # 4-level boundaries (the engine pads them to 128)
        if (pw % 4 or (ac.shape[2] // na) % 4 or dc.data_ptr() % 8
                or ac.data_ptr() % 4):
            raise ValueError(f"plane {p}: dc/ac rows and planes must start "
                             f"on 4-level boundaries")
        if (ei.dim() != 2 or ei.shape[1] != 3
                or tuple(ev.shape) != (ei.shape[0],)):
            raise ValueError(f"plane {p}: escapes {tuple(ei.shape)} / "
                             f"{tuple(ev.shape)} are not (E, 3) / (E,)")
        dims.append((rows, pw, ac.shape[2], nblk, O, P))
    if dims[1] != dims[2]:
        raise ValueError(f"Cb {dims[1]} and Cr {dims[2]} shapes differ")
    return B, U, dims


def folded_planes_i8(dcs, acs, escs, qtabs, stacks, bands, vidx, k: int,
                     centered: bool = False):
    """The three planes of a split-int8 batch in one K1 launch.

    ``dcs`` (y, cb, cr) i16 (B, rows, pad128(nblk)); ``acs`` the planar i8
    AC planes (B, rows, (k²-1)·pad128(nblk)); ``escs`` three (idx (E, 3)
    i32 (img, row, planar col), val (E,) i32) escape lists; ``qtabs`` (B,
    128) f32 natural-order tables, luma then chroma; ``stacks`` (wv_y,
    wh_y, wv_c, wh_c) folded f32 stacks (U, k, O, rows) / (U, k, P, nblk);
    ``bands`` their :func:`folded_bands` tables (computed here when None;
    the engine caches them beside its stacks); ``vidx`` (B,) i32.

    Returns the packed (B, O·P + 2·Oc·Pc) u8 studio-range planes, or with
    ``centered`` the three (B, O, P) i8 centred full-range planes."""
    global LAUNCHES
    if bands is None:
        bands = tuple(folded_bands(s) for s in stacks)
    B, U, dims = _check(dcs, acs, escs, qtabs, stacks, bands, vidx, k)
    dev = dcs[0].device
    if dev.type == "cpu":
        return folded_planes_i8_plain(dcs, acs, escs, qtabs, stacks, bands,
                                      vidx, k, centered)
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    from imagekit_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out, rc = _launch(lib, stream, dcs, acs, escs, qtabs, stacks, bands,
                          vidx, k, centered, B, U, dims)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return out


def _outputs(dev, B, shapes, centered):
    """The kernel's outputs for three (O, P) planes: (what the entry
    returns, each plane's address, each plane's image stride)."""
    sizes = [O * P for O, P in shapes]
    if centered:
        out = tuple(torch.empty((B, O, P), dtype=torch.int8, device=dev)
                    for O, P in shapes)
        return out, [o.data_ptr() for o in out], sizes
    out = torch.empty((B, sum(sizes)), dtype=torch.uint8, device=dev)
    base = out.data_ptr()
    return (out, [base, base + sizes[0], base + sizes[0] + sizes[1]],
            [sum(sizes)] * 3)


def _launch(lib, stream, dcs, acs, escs, qtabs, stacks, bands, vidx, k,
            centered, B, U, dims):
    """Allocate the outputs and call the C entry point; returns (outputs,
    cudaError_t)."""
    out, out_ptrs, strides = _outputs(
        dcs[0].device, B, [(O, P) for (_, _, _, _, O, P) in dims], centered)
    ptrs, ints = [], []
    for p in range(3):
        wv, wh = stacks[:2] if p == 0 else stacks[2:]
        bv, bh = bands[:2] if p == 0 else bands[2:]
        ei, ev = escs[p]
        ptrs += [dcs[p].data_ptr(), acs[p].data_ptr(), ei.data_ptr(),
                 ev.data_ptr(), wv.data_ptr(), wh.data_ptr(), bv.data_ptr(),
                 bh.data_ptr(), out_ptrs[p]]
        ints += [*dims[p], ei.shape[0], int(p == 0), strides[p]]
    rc = lib.ik_jpeg8_folded_planes(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_longlong * len(ints))(*ints),
        qtabs.data_ptr(), vidx.data_ptr(), B, U, k, int(centered), stream,
    )
    return out, rc


def folded_planes_i16(flats, qtabs, stacks, bands, vidx, k: int,
                      centered: bool = False):
    """The three planes of an int16-transport batch in one K1 launch.

    ``flats`` (y, cb, cr) i16 (B, rows, pw) block-grouped levels, pw >=
    nblk·k² (the engine pads it to 128); the other arguments and the result
    as :func:`folded_planes_i8`. There are no escapes: the levels are
    whole."""
    global LAUNCHES
    if bands is None:
        bands = tuple(folded_bands(s) for s in stacks)
    B, U, dims = _check_i16(flats, qtabs, stacks, bands, vidx, k)
    dev = flats[0].device
    if dev.type == "cpu":
        return folded_planes_i16_plain(flats, qtabs, stacks, bands, vidx, k,
                                       centered)
    if dev.type != "cuda":
        raise ValueError(f"no K1 kernel for device {dev}")
    from imagekit_tpu_torch.ops import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        out, rc = _launch_i16(lib, stream, flats, qtabs, stacks, bands, vidx,
                              k, centered, B, U, dims)
    if rc != 0:
        raise RuntimeError(f"K1 (int16) launch failed: cudaError_t {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return out


def _check_i16(flats, qtabs, stacks, bands, vidx, k):
    """Raise on what the int16 entry does not take; return each plane's
    (rows, pw, nblk, O, P)."""
    named = {f"{name}_levels": (flats[p], torch.int16)
             for p, name in enumerate(("y", "cb", "cr"))}
    B, U = _check_common(flats[0], named, qtabs, stacks, bands, vidx, k)
    dims = []
    for p in range(3):
        wv, wh = stacks[:2] if p == 0 else stacks[2:]
        bv, bh = bands[:2] if p == 0 else bands[2:]
        if flats[p].dim() != 3 or flats[p].shape[0] != B:
            raise ValueError(f"plane {p}: levels {tuple(flats[p].shape)} "
                             f"are not (B, rows, n)")
        _, rows, pw = flats[p].shape
        nblk, O, P = _check_stacks(p, rows, wv, wh, bv, bh, U, k)
        if nblk * k * k > pw:
            raise ValueError(f"plane {p}: nblk={nblk} blocks of {k * k} "
                             f"levels exceed the rows of {pw}")
        dims.append((rows, pw, nblk, O, P))
    if dims[1] != dims[2]:
        raise ValueError(f"Cb {dims[1]} and Cr {dims[2]} shapes differ")
    return B, U, dims


def _launch_i16(lib, stream, flats, qtabs, stacks, bands, vidx, k, centered,
                B, U, dims):
    """:func:`_launch` for the int16 entry."""
    out, out_ptrs, strides = _outputs(
        flats[0].device, B, [(O, P) for (_, _, _, O, P) in dims], centered)
    ptrs, ints = [], []
    for p in range(3):
        wv, wh = stacks[:2] if p == 0 else stacks[2:]
        bv, bh = bands[:2] if p == 0 else bands[2:]
        ptrs += [flats[p].data_ptr(), wv.data_ptr(), wh.data_ptr(),
                 bv.data_ptr(), bh.data_ptr(), out_ptrs[p]]
        ints += [*dims[p], int(p == 0), strides[p]]
    rc = lib.ik_jpeg8_folded_planes_i16(
        (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_longlong * len(ints))(*ints),
        qtabs.data_ptr(), vidx.data_ptr(), B, U, k, int(centered), stream,
    )
    return out, rc


def folded_planes_i16_plain(flats, qtabs, stacks, bands, vidx, k: int,
                            centered: bool = False):
    """Plain PyTorch version of the int16 entry: the block-grouped levels
    split by ``reshape`` (``dct.py:502-506``), then
    :func:`folded_plane_plain` per plane and the u8 pack."""
    del bands
    qt_l, qt_c = qt_lowfreq(qtabs, k)
    nk = k * k
    planes = []
    for p in range(3):
        luma = p == 0
        wv, wh = stacks[:2] if luma else stacks[2:]
        nblk = wh.shape[3]
        B, rows, _ = flats[p].shape
        lev = flats[p][:, :, : nblk * nk].reshape(B, rows, nblk, nk)
        # planar AC, one nblk-wide slice per coefficient plane
        ac16 = lev[..., 1:].permute(0, 1, 3, 2).reshape(B, rows, -1)
        planes.append(folded_plane_plain(
            lev[..., 0], ac16, qt_l if luma else qt_c, wv, wh, vidx, k, luma,
            centered))
    if centered:
        return tuple(planes)
    B = flats[0].shape[0]
    return torch.cat([pl.reshape(B, -1) for pl in planes], dim=1)


def folded_planes_i8_plain(dcs, acs, escs, qtabs, stacks, bands, vidx,
                           k: int, centered: bool = False):
    """Plain PyTorch version of the kernel: :func:`widen_scatter` and
    :func:`folded_plane_plain` per plane, then the u8 pack. ``bands`` is
    accepted and unused: the dense product is the banded one."""
    del bands
    qt_l, qt_c = qt_lowfreq(qtabs, k)
    planes = []
    for p in range(3):
        luma = p == 0
        wv, wh = stacks[:2] if luma else stacks[2:]
        ac16 = widen_scatter(acs[p], *escs[p])
        planes.append(folded_plane_plain(dcs[p], ac16, qt_l if luma else qt_c,
                                         wv, wh, vidx, k, luma, centered))
    if centered:
        return tuple(planes)
    B = dcs[0].shape[0]
    return torch.cat([pl.reshape(B, -1) for pl in planes], dim=1)


def folded_plane_plain(dc16, ac16, qt, wv_f, wh_f, vidx, k: int, luma: bool,
                       centered: bool = False) -> torch.Tensor:
    """One plane: dc16 (B, rows, pw) i16, ac16 (B, rows, (k²-1)·p) i16 with
    escapes added, qt (B, k²) dequant scales -> (B, O, P) u8 (i8 when
    ``centered``), in the reference's float order
    (``pallas_jpeg8.py:89-123``). An index outside the stacks is clamped,
    as a JAX gather clamps it."""
    nblk = wh_f.shape[3]
    p = ac16.shape[2] // (k * k - 1)
    ui = vidx.long().clamp(0, wv_f.shape[0] - 1)
    wv = wv_f[ui]  # (B, k, O, rows)
    wh = wh_f[ui]  # (B, k, P, nblk)
    out = None
    for v in range(k):
        Pv = None
        for u in range(k):
            lin = u * k + v
            if lin == 0:
                C = dc16[:, :, :nblk].float()
            else:
                j = lin - 1
                C = ac16[:, :, j * p:j * p + nblk].float()
            C = C * qt[:, lin][:, None, None]
            t = torch.bmm(wv[:, u], C)
            Pv = t if Pv is None else Pv + t
        t2 = torch.bmm(Pv, wh[:, v].transpose(1, 2))
        out = t2 if out is None else out + t2
    if centered:
        return (torch.clamp(torch.floor(out + 128.0 + 0.5), 0.0, 255.0)
                - 128.0).to(torch.int8)
    scale, offset = _LUMA if luma else _CHROMA
    out = (out + 128.0) * scale + offset
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0).to(torch.uint8)


def widen_scatter(ac8: torch.Tensor, eidx: torch.Tensor,
                  evals: torch.Tensor) -> torch.Tensor:
    """i8 planar AC -> i16 with the escape residuals ADDED in place. The
    padding rows all point at (0, 0, 0) with value 0, so the scatter must
    accumulate: a plain put would overwrite the real level there."""
    a = ac8.to(torch.int16)
    i = eidx.long()
    a.index_put_((i[:, 0], i[:, 1], i[:, 2]), evals.to(torch.int16),
                 accumulate=True)
    return a


def qt_lowfreq(qtabs: torch.Tensor, k: int):
    """(B, 128) natural-order tables -> (luma, chroma) (B, k²) dequant
    scales pre-scaled by k/8 (``dct.py:654-656``)."""
    idx = torch.as_tensor(_lowfreq_indices(k), device=qtabs.device).long()
    return (qtabs[:, :64][:, idx] * (k / 8.0),
            qtabs[:, 64:][:, idx] * (k / 8.0))
