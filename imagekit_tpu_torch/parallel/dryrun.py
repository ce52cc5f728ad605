"""A run of the sharded serving step over a device grid.

Counterpart of ``__graft_entry__.dryrun_multichip``: :func:`dryrun_multichip`
builds an ``n_devices`` grid (data x space), runs the sharded bucket
resample data-parallel and spatial, and serves a batch of JPEG -> WebP
requests through :class:`~imagekit_tpu_torch.serving.batcher.BatchedEngine`
on the grid (K1 once a shard), against the same engine on the grid's first
device alone. Any check that fails raises.

    python -m imagekit_tpu_torch.parallel.dryrun [N]

runs it on N visible cards (default: every card, or four replicas of
``cuda:0`` where there is one).
"""

from __future__ import annotations

import asyncio
import contextlib
import sys
from typing import List, Optional, Sequence

import numpy as np

from imagekit_tpu_torch.parallel.mesh import (
    grid_devices,
    make_mesh,
    visible_devices,
)
from imagekit_tpu_torch.parallel.sharding import shard_batch, sharded_resample


def _golden(imgs, wv, wh) -> np.ndarray:
    """The reference's ``_sharded_resample_impl`` in numpy."""
    x = np.einsum("boh,bhwc->bowc", wv, imgs.astype(np.float32))
    x = np.einsum("bpw,bowc->bopc", wh, x)
    return np.floor(np.clip(x, 0.0, 255.0) + 0.5).astype(np.uint8)


def _check_pieces(pieces, mesh, shape) -> None:
    """Each piece of :func:`shard_batch` on its grid device, of ``shape``."""
    for row, devs in zip(pieces, mesh.devices):
        for piece, dev in zip(row, devs):
            if piece.device != dev or tuple(piece.shape) != shape:
                raise AssertionError(
                    f"a shard is {tuple(piece.shape)} on {piece.device}, "
                    f"expected {shape} on {dev}")


def resample_case(mesh, spatial: bool, seed: int = 1) -> dict:
    """The sharded bucket resample (2 images a data row, 64x64 -> 32x32)
    against its numpy golden: exact data-parallel, within |d| <= 1 on at
    most 0.1% of values spatial (the partials summed in another order)."""
    from imagekit_tpu_torch.ops.weights import padded_weights

    d, s = mesh.shape
    batch, bh, bw, obh, obw = 2 * d, 64, 64, 32, 32
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (batch, bh, bw, 3), dtype=np.uint8)
    wv = np.stack([padded_weights(60, 30, bh, obh)] * batch)
    wh = np.stack([padded_weights(56, 28, bw, obw)] * batch)
    _check_pieces(shard_batch(imgs, mesh, spatial=spatial), mesh,
                  (2, bh // s if spatial else bh, bw, 3))
    out = sharded_resample(imgs, wv, wh, mesh, spatial=spatial)
    if out.device != mesh.devices[0][0] or tuple(out.shape) != (
            batch, obh, obw, 3):
        raise AssertionError(f"result {tuple(out.shape)} on {out.device}")
    got = out.cpu().numpy().astype(np.int32)
    diff = np.abs(got - _golden(imgs, wv, wh))
    n = int((diff > 0).sum())
    if diff.max() > (1 if spatial else 0) or n > 1e-3 * diff.size:
        raise AssertionError(f"sharded resample (spatial={spatial}) off by "
                             f"{diff.max()} on {n} of {diff.size} values")
    return {"max_abs_err": int(diff.max()), "values_differ": n,
            "shards": d * (s if spatial else 1)}


@contextlib.contextmanager
def placements(engine):
    """Record every host array the engine places, by grid place: yields
    {place: [(device, shape), ...]}."""
    real = engine._placement
    seen: dict = {}

    @contextlib.contextmanager
    def recording(place: int = 0):
        with real(place) as put:
            def put_seen(a):
                t = put(a)
                seen.setdefault(place, []).append((t.device, tuple(t.shape)))
                return t
            yield put_seen

    engine._placement = recording
    try:
        yield seen
    finally:
        del engine._placement


def serve(engine, datas: Sequence[bytes], width: int, fmt, quality: int = 80
          ) -> List[bytes]:
    """``datas`` through ``engine.transform`` at once; closes the engine."""
    async def run():
        try:
            return await asyncio.gather(*(
                engine.transform(d, width, None, fmt, quality)
                for d in datas))
        finally:
            await engine.close()

    return asyncio.run(run())


def engine_case(mesh, datas: Sequence[bytes], width: int, fmt) -> dict:
    """One batch of ``datas`` (as many as fill a batch of the grid) through
    the engine on the grid and through the engine on its first device:
    the bodies byte for byte, and every array of shard j placed on the
    grid's device j with the shard's share of the batch."""
    from imagekit_tpu_torch.config import BatchConfig, ImageKitConfig
    from imagekit_tpu_torch.serving.batcher import BatchedEngine
    from imagekit_tpu_torch.serving.metrics import Metrics

    n = len(datas)
    cfg = ImageKitConfig(secret="dryrun", batch=BatchConfig(
        max_batch=n, max_delay_ms=60_000.0, hard_delay_ms=60_000.0))
    grid_engine = BatchedEngine(cfg, metrics=Metrics(), mesh=mesh)
    if not grid_engine._use_mesh(n):
        raise AssertionError(f"a batch of {n} does not split over the grid")
    with placements(grid_engine) as seen:
        sharded = serve(grid_engine, datas, width, fmt)
    one = serve(BatchedEngine(cfg, metrics=Metrics(),
                              device=mesh.devices[0][0]), datas, width, fmt)
    grid = mesh.flat
    m = n // len(grid)
    if sorted(seen) != list(range(len(grid))):
        raise AssertionError(f"shards placed at {sorted(seen)}")
    for place, arrays in seen.items():
        if any(dev != grid[place] for dev, _ in arrays):
            raise AssertionError(f"shard {place} placed off {grid[place]}")
        if not any(shape[0] == m for _, shape in arrays):
            raise AssertionError(f"shard {place} holds no {m} items")
    if sharded != one:
        raise AssertionError("the grid's bodies differ from one device's")
    return {"requests": n, "shards": len(grid), "items_a_shard": m,
            "bodies_equal": True,
            "arrays_a_shard": len(seen[0])}


def synth_jpeg(seed: int, w: int = 640, h: int = 480, quality: int = 95
               ) -> bytes:
    """A seeded noisy 4:2:0 JPEG, written with the port's fDCT and Huffman
    encoder (no Pillow)."""
    from imagekit_tpu_torch.codecs.native import loader
    from imagekit_tpu_torch.ops.weights import host_encode_rgb_to_coefficients

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)],
                    axis=-1)
    img = np.clip(base + rng.normal(0, 40, (h, w, 3)), 0, 255).astype(
        np.uint8)
    planes, qt = host_encode_rgb_to_coefficients(img, quality)
    return loader.encode_jpeg(planes, qt, w, h)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """Build an ``n_devices`` grid over ``devices`` (every visible card by
    default; a device may repeat), with a ``space`` axis of 2 where
    ``n_devices`` is even, and run the sharded step on it: the bucket
    resample data-parallel and spatial, then the engine's JPEG -> WebP
    batch (K1, one launch a shard). Returns what each step showed."""
    from imagekit_tpu_torch.config import ImageFormat

    devices = visible_devices() if devices is None else list(devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, found {len(devices)}")
    space = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, space=space, devices=devices[:n_devices])
    data_mesh = make_mesh(n_devices, devices=devices[:n_devices])
    report = {"devices": [str(d) for d in mesh.flat],
              "grid": list(mesh.shape),
              "data_parallel": resample_case(data_mesh, spatial=False)}
    if space > 1:
        report["spatial"] = resample_case(mesh, spatial=True)
    jpegs = [synth_jpeg(seed) for seed in range(2 * n_devices)]
    report["engine"] = engine_case(data_mesh, jpegs, 160, ImageFormat.webp)
    return report


def main(argv: Sequence[str]) -> int:
    devices = grid_devices()
    n = int(argv[0]) if argv else len(devices)
    print(dryrun_multichip(n, devices))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
