"""Declarative pipeline definitions for each output format family.

A copy of ``imagekit_tpu/models/pipelines.py``: the reference's three
encoder arms (``src/transform.rs:121-146``) and their stage splits, as the
JAX package declares them. The port's app exposes the table over HTTP at
``GET /stats/pipelines`` (:func:`describe`), unchanged, so both services
answer that route alike.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Sequence

from imagekit_tpu_torch.config import ImageFormat


class Stage(str, enum.Enum):
    # host (serial / entropy) stages
    HOST_ENTROPY_DECODE = "host_entropy_decode"     # C++ Huffman -> coeffs
    HOST_LIBRARY_DECODE = "host_library_decode"     # libjpeg/libwebp/libavif
    HOST_ENTROPY_ENCODE = "host_entropy_encode"     # coeffs -> C++ Huffman
    HOST_LIBRARY_ENCODE = "host_library_encode"
    # device (parallel) stages
    DEVICE_DEQUANT_IDCT = "device_dequant_idct"
    DEVICE_CHROMA_RESAMPLE = "device_chroma_resample"  # upsample∘resize fold
    DEVICE_RESIZE = "device_resize"                    # separable matmuls
    DEVICE_COLOR_CONVERT = "device_color_convert"
    DEVICE_SUBSAMPLE = "device_subsample"              # 4:2:0 box average
    DEVICE_FDCT_QUANT = "device_fdct_quant"


@dataclass(frozen=True)
class Pipeline:
    """One output-format family."""

    fmt: ImageFormat
    mime: str
    decode_stages: Sequence[Stage]
    encode_stages: Sequence[Stage]
    # whether the device encode path exists or the host library finishes
    device_encode: bool
    input_color: str  # what the encoder consumes (reference parity)
    notes: str = ""
    # relative cost rank, reference parity (src/transform.rs:105):
    # JPEG > WebP > AVIF in speed
    speed_rank: int = 0


PIPELINES = {
    ImageFormat.jpeg: Pipeline(
        fmt=ImageFormat.jpeg,
        mime="image/jpeg",
        decode_stages=(
            Stage.HOST_ENTROPY_DECODE,
            Stage.DEVICE_DEQUANT_IDCT,
            Stage.DEVICE_CHROMA_RESAMPLE,
            Stage.DEVICE_RESIZE,
            Stage.DEVICE_COLOR_CONVERT,
        ),
        encode_stages=(
            Stage.DEVICE_COLOR_CONVERT,
            Stage.DEVICE_SUBSAMPLE,
            Stage.DEVICE_FDCT_QUANT,
            Stage.HOST_ENTROPY_ENCODE,
        ),
        device_encode=True,
        input_color="rgb8",  # to_rgb8, src/transform.rs:123
        speed_rank=1,
        notes="fully TPU-native both directions (baseline + progressive "
        "scans decode natively; exotic samplings fall back to the host "
        "library decoder)",
    ),
    ImageFormat.webp: Pipeline(
        fmt=ImageFormat.webp,
        mime="image/webp",
        decode_stages=(Stage.HOST_ENTROPY_DECODE,),
        encode_stages=(
            Stage.DEVICE_RESIZE,
            Stage.DEVICE_COLOR_CONVERT,
            Stage.DEVICE_SUBSAMPLE,
            Stage.HOST_ENTROPY_ENCODE,
        ),
        device_encode=True,
        input_color="rgb8",  # to_rgb8 + libwebp lossy, src/transform.rs:131-136
        speed_rank=2,
        notes="native both directions: C++ VP8 keyframe decoder (bit-exact "
        "vs libwebp) + VP8L lossless + VP8X/ALPH/animation-frame-0; encoder "
        "I16+B_PRED with RD mode decision, per-frame coefficient-prob "
        "adaptation and chroma quality deltas; device RGB->YUV 4:2:0 "
        "stages; JPEG->WebP runs fully fused in YUV space",
    ),
    ImageFormat.avif: Pipeline(
        fmt=ImageFormat.avif,
        mime="image/avif",
        decode_stages=(
            Stage.HOST_LIBRARY_DECODE,  # dav1d AV1 core over a pinned ctypes ABI
            Stage.DEVICE_CHROMA_RESAMPLE,
            Stage.DEVICE_RESIZE,
        ),
        encode_stages=(
            Stage.DEVICE_RESIZE,
            Stage.DEVICE_COLOR_CONVERT,
            Stage.DEVICE_SUBSAMPLE,
            Stage.HOST_LIBRARY_ENCODE,  # direct libavif ABI fed device YUV
        ),
        # device_encode gates encode_bytes' native arms (jpeg/webp only);
        # the serving engine feeds libavif device-produced YUV planes
        # directly (codecs/avif_encode.py), bypassing this host path
        device_encode=False,
        input_color="yuv420_studio",  # device planes; reference: rgba8 + AV1
        speed_rank=3,
        notes="native ISOBMFF container + dav1d AV1 core via pinned ctypes "
        "ABI (alpha/10/12-bit/avis frame-0), YUV planes straight into the "
        "fused device heads (4:2:2/4:4:4 ride subsample-folded weights, "
        "mono rides with synthesized neutral chroma; alpha/709 take the "
        "generic RGB path); encode is the direct "
        "libavif ABI fed device YUV 4:2:0 — no RGBA materialisation, "
        "opaque sources drop the alpha plane. The AV1 entropy cores are "
        "the sanctioned host-library pieces (docs/ROADMAP.md item 1)",
    ),
}


def get_pipeline(fmt: ImageFormat) -> Pipeline:
    return PIPELINES[fmt]


def describe() -> dict:
    """JSON-ready snapshot for ``GET /stats/pipelines``."""
    return {
        p.fmt.value: {
            "mime": p.mime,
            "decode_stages": [s.value for s in p.decode_stages],
            "encode_stages": [s.value for s in p.encode_stages],
            "device_encode": p.device_encode,
            "input_color": p.input_color,
            "speed_rank": p.speed_rank,
            "notes": p.notes,
        }
        for p in PIPELINES.values()
    }
