"""Namespaces: 29-byte (1-byte version + 28-byte ID) share labels.

Behavioral parity with go-square/namespace as used by the reference
(specs/src/specs/namespace.md, pkg/appconsts/global_consts.go:17-27).
Namespaces order the data square and drive the Namespaced Merkle Tree; the
reserved primary namespaces hold transactions, the reserved secondary
namespaces hold padding and erasure parity.
"""

from __future__ import annotations

from dataclasses import dataclass

from celestia_tpu_torch.appconsts import (
    NAMESPACE_ID_SIZE,
    NAMESPACE_SIZE,
    NAMESPACE_VERSION_MAX,
    NAMESPACE_VERSION_SIZE,
    PARITY_SHARE_NAMESPACE_RAW,
)

# Version-0 namespaces must have 18 leading zero bytes in the 28-byte ID,
# leaving 10 user-specifiable bytes (specs/namespace.md "Version 0").
NAMESPACE_VERSION_ZERO = 0
NAMESPACE_VERSION_ZERO_PREFIX_LEN = 18
NAMESPACE_VERSION_ZERO_USER_LEN = NAMESPACE_ID_SIZE - NAMESPACE_VERSION_ZERO_PREFIX_LEN


@dataclass(frozen=True, order=True)
class Namespace:
    """An immutable 29-byte namespace; ordering is bytewise over version||id."""

    raw: bytes  # NAMESPACE_SIZE bytes: version || id

    def __post_init__(self):
        if len(self.raw) != NAMESPACE_SIZE:
            raise ValueError(
                f"namespace must be {NAMESPACE_SIZE} bytes, got {len(self.raw)}"
            )

    @property
    def version(self) -> int:
        return self.raw[0]

    @property
    def id(self) -> bytes:
        return self.raw[NAMESPACE_VERSION_SIZE:]

    @classmethod
    def from_version_id(cls, version: int, id_: bytes) -> "Namespace":
        if not 0 <= version <= NAMESPACE_VERSION_MAX:
            raise ValueError(f"invalid namespace version {version}")
        if len(id_) != NAMESPACE_ID_SIZE:
            raise ValueError(
                f"namespace id must be {NAMESPACE_ID_SIZE} bytes, got {len(id_)}"
            )
        return cls(bytes([version]) + id_)

    @classmethod
    def v0(cls, user_bytes: bytes) -> "Namespace":
        """Build a version-0 namespace from <=10 user bytes (left-padded)."""
        if len(user_bytes) > NAMESPACE_VERSION_ZERO_USER_LEN:
            raise ValueError(
                f"version-0 user namespace must be <= {NAMESPACE_VERSION_ZERO_USER_LEN}"
                f" bytes, got {len(user_bytes)}"
            )
        id_ = b"\x00" * (NAMESPACE_ID_SIZE - len(user_bytes)) + user_bytes
        return cls.from_version_id(NAMESPACE_VERSION_ZERO, id_)

    def is_reserved(self) -> bool:
        return self.is_primary_reserved() or self.is_secondary_reserved()

    def is_primary_reserved(self) -> bool:
        """<= 0x00..FF: version 0 and id <= 27 zero bytes + 0xFF."""
        return self.raw <= MAX_PRIMARY_RESERVED_NAMESPACE.raw

    def is_secondary_reserved(self) -> bool:
        """>= 0xFF..00: version 255 and 27 leading 0xFF id bytes."""
        return self.raw >= MIN_SECONDARY_RESERVED_NAMESPACE.raw

    def is_usable_by_users(self) -> bool:
        return not self.is_reserved()

    def validate_for_blob(self) -> None:
        """Blob namespaces must be version 0, non-reserved, with the v0 zero prefix."""
        if self.version != NAMESPACE_VERSION_ZERO:
            raise ValueError(f"blob namespace version must be 0, got {self.version}")
        if self.id[:NAMESPACE_VERSION_ZERO_PREFIX_LEN] != b"\x00" * NAMESPACE_VERSION_ZERO_PREFIX_LEN:
            raise ValueError("version-0 namespace id must have 18 leading zero bytes")
        if self.is_reserved():
            raise ValueError(f"namespace {self.raw.hex()} is reserved for protocol use")

    def is_parity(self) -> bool:
        return self.raw == PARITY_SHARE_NAMESPACE.raw

    def is_padding(self) -> bool:
        return self.raw in (
            TAIL_PADDING_NAMESPACE.raw,
            PRIMARY_RESERVED_PADDING_NAMESPACE.raw,
        )

    def hex(self) -> str:
        return self.raw.hex()

    def __repr__(self) -> str:
        return f"Namespace(0x{self.raw.hex()})"


def _primary(last_byte: int) -> Namespace:
    return Namespace(b"\x00" * (NAMESPACE_SIZE - 1) + bytes([last_byte]))


def _secondary(last_byte: int) -> Namespace:
    return Namespace(b"\xff" * (NAMESPACE_SIZE - 1) + bytes([last_byte]))


# Reserved namespaces (specs/namespace.md "Reserved Namespaces").
TRANSACTION_NAMESPACE = _primary(0x01)
INTERMEDIATE_STATE_ROOT_NAMESPACE = _primary(0x02)
PAY_FOR_BLOB_NAMESPACE = _primary(0x04)
PRIMARY_RESERVED_PADDING_NAMESPACE = _primary(0xFF)
MAX_PRIMARY_RESERVED_NAMESPACE = _primary(0xFF)
MIN_SECONDARY_RESERVED_NAMESPACE = _secondary(0x00)
TAIL_PADDING_NAMESPACE = _secondary(0xFE)
# the raw bytes are pinned in appconsts (ops/nmt.py consumes them below
# the da/ layer); wrapping them here keeps one source of truth
PARITY_SHARE_NAMESPACE = Namespace(PARITY_SHARE_NAMESPACE_RAW)
