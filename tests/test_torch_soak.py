"""The soak (``imagekit_tpu_torch/tools/soak.py``) against the port's app
and the reference's, in process, on the CPU.

One seeded plan of about 60 ``/upload`` requests and one of 60 ``/sign``
-> ``/img`` requests go to the port's app (``device="cpu"``) and to the
reference's (its first-party AVIF encoder, ``IMAGEKIT_AVIF_FIRSTPARTY``),
each on a local port; both with load shedding off
(``max_queue_latency_s=0``), so that every status is the request's own and
not the machine's. The soak's rules hold on the port (no 5xx, no 501,
decodable classes 200, hostile ones 400, tampered 401, expired 410, cache
hits and 304 revalidations, the sampled bodies' format and size), and each
request's status equals the reference's. The two kept differences of
ROADMAP queue 3 that this corpus could meet do not arise on it: every
class here decodes, or fails, alike in both apps.

Upload requests whose output is an AVIF of more than 200 000 pixels (the
reference's mix upscales to w=640 and w=1200) are left out here: the
first-party encoder takes about 18 s for 1200 x 881 on this CPU, per app.
``chip_smoke.py`` phase 31 sends the whole mix to the card.
"""

import asyncio

import pytest
from aiohttp import web

from imagekit_tpu import config as ref_config
from imagekit_tpu import fetch as ref_fetch
from imagekit_tpu.serving.metrics import Metrics as RefMetrics
from imagekit_tpu_torch import config as port_config
from imagekit_tpu_torch import fetch as port_fetch
from imagekit_tpu_torch.ops.weights import target_dimensions
from imagekit_tpu_torch.serving.metrics import Metrics
from imagekit_tpu_torch.tools import soak
from tests.test_torch_jxc_slice import _ref_native_lib

SECRET = "soak-secret"


@pytest.fixture(autouse=True)
def _reference_library(monkeypatch):
    _ref_native_lib(monkeypatch)


def _app(which: str, cache_dir):
    if which == "port":
        from imagekit_tpu_torch.serving.app import create_app

        return create_app(
            port_config.ImageKitConfig(
                secret=SECRET, cache_dir=cache_dir,
                batch=port_config.BatchConfig(max_queue_latency_s=0)),
            fetcher=port_fetch.Fetcher(), metrics=Metrics(),
            rate_limit=False, device="cpu")
    from imagekit_tpu.serving.app import create_app

    return create_app(
        ref_config.ImageKitConfig(
            secret=SECRET, cache_dir=cache_dir,
            batch=ref_config.BatchConfig(max_queue_latency_s=0)),
        fetcher=ref_fetch.Fetcher(), metrics=RefMetrics(), rate_limit=False)


def _soak(which, cache_dir, fn, plan):
    async def inner():
        runner = web.AppRunner(_app(which, cache_dir))
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        try:
            return await fn(f"http://127.0.0.1:{runner.addresses[0][1]}",
                            concurrency=4, plan=plan)
        finally:
            await runner.cleanup()

    return asyncio.run(inner())


def _small_avif(req) -> bool:
    if req.fmt != "avif" or req.source.dims is None:
        return True
    w, h = (int(req.fields[k]) if k in req.fields else None
            for k in ("w", "h"))
    ow, oh = target_dimensions(*req.source.dims, w, h)
    return ow * oh <= 200_000


@pytest.fixture(scope="module")
def sources():
    srcs, skipped = soak.make_sources()
    assert set(skipped) == set(soak.NO_WRITER)
    return srcs


def test_corpus_has_the_reference_classes(sources):
    names = {s.name for s in sources}
    assert {"jpeg_base", "jpeg_gray", "png_rgb", "png_rgba", "png_pal", "gif",
            "bmp", "tiff", "webp_lossy", "webp_ll", "avif", "avif_mono",
            "ico", "qoi", "pnm", "dds", "farbfeld", "hdr", "exr_rejected",
            "empty", "garbage", "truncated", "corrupt"} <= names
    # every class decodes as its label says, through the port's decoders
    from imagekit_tpu_torch.codecs import decode_bytes
    from imagekit_tpu_torch.errors import ImageKitError

    for s in sources:
        if s.decodable is True:
            arr, _ = decode_bytes(s.data, device="cpu")
            assert (arr.shape[1], arr.shape[0]) == s.dims, s.name
        elif s.decodable is False:
            with pytest.raises(ImageKitError):
                decode_bytes(s.data, device="cpu")
    mono = next(s for s in sources if s.name == "avif_mono")
    from imagekit_tpu_torch.codecs.avif_native import parse_container

    assert parse_container(mono.data).monochrome


def test_plans_are_seeded(sources):
    a, b = soak.upload_plan(sources, 40), soak.upload_plan(sources, 40)
    assert [(r.source.name, r.fields) for r in a] == \
        [(r.source.name, r.fields) for r in b]
    assert {r.fmt for r in a} == {"webp", "jpeg", "avif"}
    modes = {r.mode for r in soak.img_plan(sources, 40)}
    assert modes == {"ok", "tamper", "expired"}


@pytest.mark.parametrize("kind", ["upload", "img"])
def test_soak_matches_the_reference(monkeypatch, tmp_path, sources, kind):
    monkeypatch.setenv("IMAGEKIT_AVIF_FIRSTPARTY", "1")
    if kind == "upload":
        plan = [r for r in soak.upload_plan(sources, 64) if _small_avif(r)]
        fn = soak.run
    else:
        plan = soak.img_plan(sources, 60)
        fn = soak.run_img
    assert len(plan) >= 60
    port = _soak("port", tmp_path / "port", fn, plan)
    assert not port.misses, "\n".join(port.lines())
    assert len(port.results) == len(plan)
    assert port.shed == 0 and port.checked > 0
    statuses = set(port.statuses())
    assert not any(st >= 500 for st in statuses)
    assert {200, 400} <= statuses
    if kind == "img":
        assert {401, 410} <= statuses and port.revalidated > 0
    ref = _soak("ref", tmp_path / "ref", fn, plan)
    differ = [(r.index, r.source.name, r.fields, st, rst)
              for (r, st, _), (_, rst, _) in zip(port.results, ref.results)
              if st != rst]
    assert len(ref.results) == len(plan)
    assert not differ, differ
    lines = port.lines()
    assert lines[-1].startswith(f"{kind} soak: {len(plan)} requests")
