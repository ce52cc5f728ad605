"""imagekit_tpu_torch — the imagekit service on PyTorch and CUDA.

The port of :mod:`imagekit_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU. The JAX package stays beside it as the reference; this package
imports ``torch``, never ``jax`` and nothing of :mod:`imagekit_tpu`. It
keeps its own copies of the reference's host modules (config, errors,
signature, fetch, caches, native codecs and their C++ sources, bucketing,
metrics, rate limiting), under the reference's module names, and ports the
device plane slice by slice:

- :mod:`imagekit_tpu_torch.ops`     — numpy weight builders, the plain
  PyTorch heads and the hand-written CUDA kernels (``csrc/``);
- :mod:`imagekit_tpu_torch.serving` — the batched engine and the HTTP app;
- :mod:`imagekit_tpu_torch.codecs`  — format detection, the native codec
  build and the PNG decode without Pillow;
- :mod:`imagekit_tpu_torch.fetch`   — the header-only source validation;
- :mod:`imagekit_tpu_torch.device`  — explicit device selection.

Requests outside the ported slice raise :class:`NotPortedError` (HTTP 501).
"""

from imagekit_tpu_torch.config import (  # noqa: F401
    DEFAULT_CACHE_CONTROL,
    DEFAULT_QUALITY,
    MAX_QUALITY,
    MIN_QUALITY,
    NO_CACHE_CONTROL,
    ImageFormat,
    ImageKitConfig,
)
from imagekit_tpu_torch.errors import ImageKitError, NotPortedError  # noqa: F401

__version__ = "0.1.0"
