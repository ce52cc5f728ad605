"""Device grids: counterpart of ``imagekit_tpu/parallel/mesh.py``.

The reference builds a ``jax.sharding.Mesh`` and lets GSPMD place and
partition its arrays. The port holds the same ``(data, space)`` grid of
devices explicitly, and its callers launch once per device
(:mod:`.sharding`, the engine's batches): a :class:`Mesh` is that grid of
``torch.device``\\ s. A device may repeat in it: the CPU tests run eight
``torch.device("cpu")`` replicas, and one card can carry several logical
replicas, each on its own stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional, Sequence, Tuple

import torch

from imagekit_tpu_torch.device import resolve_device

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclass(frozen=True)
class Mesh:
    """A ``(n // space, space)`` grid of devices: rows split the batch
    (``data``), columns split an image's height (``space``)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: ClassVar[Tuple[str, str]] = (DATA_AXIS, SPACE_AXIS)

    @property
    def shape(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def flat(self) -> Tuple[torch.device, ...]:
        """The devices in grid order, row after row."""
        return tuple(d for row in self.devices for d in row)


def visible_devices() -> list:
    """Every visible card, ``cuda:0 … cuda:N-1``; raises without one (the
    CPU must be named, as everywhere in the port)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for a device grid (torch.cuda.is_available() is "
            "False); pass devices=[torch.device('cpu')] * n to build one on "
            "the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def grid_devices(replicas: int = 4) -> list:
    """Every visible card where there are several, else ``replicas``
    replicas of the one card (each shard of a batch on its own stream):
    the devices a grid is built over to run the split on any host."""
    cards = visible_devices()
    return cards if len(cards) > 1 else cards * replicas


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    space: int = 1,
    devices: Optional[Sequence["str | torch.device"]] = None,
) -> Mesh:
    """A (data, space) grid over the first ``n_devices`` of ``devices``
    (every visible card by default). ``space`` > 1 gives the columns to
    the rows of oversized images; the default keeps every device on the
    batch (data-parallel serving)."""
    devices = (visible_devices() if devices is None
               else [resolve_device(d) for d in devices])
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}")
    if n % space != 0:
        raise ValueError(f"{n} devices not divisible by space={space}")
    grid = tuple(tuple(devices[r * space:(r + 1) * space])
                 for r in range(n // space))
    return Mesh(grid)


_default_mesh: Optional[Mesh] = None


def get_mesh() -> Mesh:
    """Process-default grid (every visible card, data-parallel)."""
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = make_mesh()
    return _default_mesh
