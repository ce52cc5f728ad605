"""Service-wide error model.

A copy of ``imagekit_tpu/errors.py``, which mirrors the reference's
``ImageKitError`` enum (``src/lib.rs:34-52``) and its per-site HTTP status
mapping: signature failures map to 401 (410 for expired,
``src/lib.rs:120-127``), bad parameters / fetch / decode / resize / encode
errors map to 400 at the ``/img`` handler (``src/lib.rs:130-191``). The
port adds :class:`NotPortedError` (501).
"""


from __future__ import annotations


class ImageKitError(Exception):
    """Base class; ``kind`` names the reference enum variant."""

    kind = "Internal"

    def __init__(self, message: str = ""):
        super().__init__(message)
        self.message = message

    def __str__(self) -> str:  # mirrors thiserror's "{kind}: {msg}" display
        prefix = {
            "Cache": "Cache error",
            "Transform": "Transformation error",
            "Network": "Network error",
            "InvalidArgument": "Invalid argument",
            "NotFound": "Not found",
            "Unauthorized": "Unauthorized",
            "Expired": "Expired",
            "Internal": "Internal server error",
        }[self.kind]
        return f"{prefix}: {self.message}"


class CacheError(ImageKitError):
    kind = "Cache"


class TransformError(ImageKitError):
    kind = "Transform"


class SourceDecodeError(TransformError):
    """A fetched source whose header parsed and whose data did not decode.
    The reference decodes such a source (a PNG) in full at its fetch stage
    and answers ``/img`` from there; the port decodes it once, in the
    engine, and its ``/img`` handler answers this error with the fetch
    stage's body."""


class NetworkError(ImageKitError):
    kind = "Network"


class InvalidArgumentError(ImageKitError):
    kind = "InvalidArgument"


class NotFoundError(ImageKitError):
    kind = "NotFound"


class UnauthorizedError(ImageKitError):
    kind = "Unauthorized"


class ExpiredError(ImageKitError):
    kind = "Expired"


class InternalError(ImageKitError):
    kind = "Internal"


class ConfigError(ValueError):
    """Configuration validation failure (reference ``src/config.rs:98-105``)."""


class EngineOverloaded(Exception):
    """Admission control: the engine's estimated queue-drain latency
    exceeds its budget; shed instead of queueing. NOT an ImageKitError —
    the HTTP layer maps it to 429 + ``Retry-After`` (the engine-layer
    analogue of the reference's per-IP governor, ``src/lib.rs:450-467``,
    which bounds latency only per client, not per server)."""

    def __init__(self, retry_after: float):
        super().__init__(
            f"engine overloaded; retry after ~{retry_after:.0f}s"
        )
        self.retry_after = retry_after


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
