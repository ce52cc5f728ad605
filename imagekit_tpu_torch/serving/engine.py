"""Transform execution engine interface (counterpart of
``imagekit_tpu/serving/engine.py:28-58``).

The port has one implementation, :class:`~imagekit_tpu_torch.serving.
batcher.BatchedEngine`, which also serves single images (requests with no
resize) through :mod:`imagekit_tpu_torch.transform`; the reference's
``ThreadedEngine``, a per-request engine over the same functions, has no
counterpart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from imagekit_tpu_torch.config import ImageFormat


class TransformEngine:
    """Interface: async decode / resize+encode on pre-decoded pixels."""

    async def transform(
        self,
        data: bytes,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        img = await self.decode(data)
        return await self.resize_encode(img, w, h, fmt, quality)

    async def decode(self, data: bytes) -> np.ndarray:
        raise NotImplementedError

    async def resize_encode(
        self,
        img: np.ndarray,
        w: Optional[int],
        h: Optional[int],
        fmt: ImageFormat,
        quality: int,
    ) -> bytes:
        raise NotImplementedError

    async def close(self) -> None:
        pass
