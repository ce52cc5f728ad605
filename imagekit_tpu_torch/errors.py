"""Errors of the port beyond the reference's error model."""

from __future__ import annotations

from imagekit_tpu.errors import ImageKitError


class NotPortedError(ImageKitError):
    """The request needs a path of :mod:`imagekit_tpu` that the port does
    not serve yet; the message names the ROADMAP item that ports it. The
    port's HTTP app answers it with 501."""

    kind = "Internal"

    def __init__(self, what: str, roadmap_item: str):
        super().__init__(f"{what} is not ported yet (ROADMAP {roadmap_item})")
        self.roadmap_item = roadmap_item

    def __str__(self) -> str:
        return f"Not implemented: {self.message}"
