"""HMAC-SHA256 URL signing and verification.

Parity with the reference ``src/signature.rs``:

- Canonical string: lexicographically sorted ``k=v`` pairs joined with ``&``,
  excluding ``sig`` (``src/signature.rs:30-38``).
- Verification: empty sig -> Missing; ``t`` param parseable as int and
  strictly less than now -> Expired; otherwise HMAC-SHA256(secret, canonical)
  hex compared with the provided sig (``src/signature.rs:60-91``).
- Expiry uses strict ``<`` (``t == now`` is still valid, SURVEY.md §2.4.5).

Divergence (deliberate fix, SURVEY.md §2.4.4): the reference *documents*
constant-time comparison but performs plain string equality
(``src/signature.rs:86``); we use ``hmac.compare_digest``. Accept/reject
behaviour is identical.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import time as _time
from typing import Mapping, Optional

from imagekit_tpu_torch.errors import ExpiredError, UnauthorizedError


class SignatureError(Exception):
    """Base for verification failures (reference ``SignatureError`` enum)."""


class MissingSignature(SignatureError):
    def __str__(self) -> str:
        return "missing signature"


class InvalidSignature(SignatureError):
    def __str__(self) -> str:
        return "invalid signature"


class ExpiredSignature(SignatureError):
    def __str__(self) -> str:
        return "expired"


def canonical_string(params: Mapping[str, str]) -> str:
    """Sorted ``k=v`` join, excluding ``sig`` (``src/signature.rs:30-38``).

    Values are used verbatim (no URL re-encoding), matching the reference,
    which operates on already-decoded query values.
    """
    return "&".join(f"{k}={params[k]}" for k in sorted(params) if k != "sig")


def sign(params: Mapping[str, str], secret: str) -> str:
    """Hex HMAC-SHA256 over the canonical string (``src/lib.rs:226-228``)."""
    canonical = canonical_string(params)
    mac = _hmac.new(secret.encode(), canonical.encode(), hashlib.sha256)
    return mac.hexdigest()


def verify_signature(
    params: Mapping[str, str],
    sig: str,
    secret: str,
    *,
    now: Optional[int] = None,
) -> None:
    """Raise a ``SignatureError`` subclass on failure (``src/signature.rs:60-91``).

    Order of checks matches the reference: missing -> expired -> invalid.
    ``now`` is injectable for tests; defaults to current unix time.
    """
    if not sig:
        raise MissingSignature()

    ts = params.get("t")
    if ts is not None:
        try:
            epoch = int(ts)
        except ValueError:
            epoch = None  # unparseable t is ignored, like the reference
        if epoch is not None:
            current = int(_time.time()) if now is None else now
            if epoch < current:
                raise ExpiredSignature()

    expected = sign(params, secret)
    if not _hmac.compare_digest(expected, sig):
        raise InvalidSignature()


def error_to_http(e: SignatureError):
    """Status mapping used by the /img handler (``src/lib.rs:120-127``):
    Expired -> 410 Gone, everything else -> 401 Unauthorized."""
    if isinstance(e, ExpiredSignature):
        return 410, ExpiredError(str(e))
    return 401, UnauthorizedError(str(e))
