"""Client-side error parsing for recoverable tx failures.

Parity with app/errors/: ParseExpectedSequence
(nonce_mismatch.go:34 — extract the expected sequence so the signer can
re-sign) and ParseInsufficientMinGasPrice (insufficient_gas_price.go:23 —
compute the fee that would have been accepted).
"""

from __future__ import annotations

import re
from typing import Optional

_SEQUENCE_RE = re.compile(
    r"account sequence mismatch, expected (\d+), got (\d+)"
)
_MIN_FEE_RE = re.compile(
    r"insufficient fee.*?: got (\d+)utia, required (\d+)utia"
)


def is_nonce_mismatch(log: str) -> bool:
    return "incorrect account sequence" in log or _SEQUENCE_RE.search(log) is not None


def parse_expected_sequence(log: str) -> Optional[int]:
    m = _SEQUENCE_RE.search(log)
    return int(m.group(1)) if m else None


def is_insufficient_min_gas_price(log: str) -> bool:
    return "insufficient fee" in log


def parse_required_fee(log: str) -> Optional[int]:
    m = _MIN_FEE_RE.search(log)
    return int(m.group(2)) if m else None
