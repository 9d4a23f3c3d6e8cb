"""x/slashing equivalent: liveness tracking, downtime jailing, and the
double-sign slash entry point consumed by x/evidence.

Parity role: the cosmos-sdk slashing keeper the reference wires at
app/app.go:192,307-310 (SlashingKeeper + staking hooks).
Per-validator signing info tracks a sliding missed-block window; crossing
the liveness threshold slashes a fraction of stake and jails for a
duration.  Equivocation (from x/evidence) slashes harder and tombstones —
the validator can never rejoin.

Integer-only params (ppm fractions, ns durations) keep every validator's
arithmetic bit-identical — the same determinism rule as the rest of the
state machine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.staking import StakingKeeper
from celestia_tpu_torch.state.store import KVStore

# SDK-default-shaped params, window scaled for 15s blocks
SIGNED_BLOCKS_WINDOW = 100
MIN_SIGNED_PER_WINDOW_PPM = 500_000  # 50%
DOWNTIME_JAIL_DURATION_NS = 600 * 10**9  # 10 minutes
SLASH_FRACTION_DOWNTIME_PPM = 10_000  # 1%
SLASH_FRACTION_DOUBLE_SIGN_PPM = 50_000  # 5%

_INFO_PREFIX = b"si/"
_BITMAP_PREFIX = b"bm/"


class SlashingError(ValueError):
    pass


@dataclass
class SigningInfo:
    start_height: int = 0
    index_offset: int = 0
    missed_blocks: int = 0

    def marshal(self) -> bytes:
        return bytes(
            _varint(self.start_height)
            + _varint(self.index_offset)
            + _varint(self.missed_blocks)
        )

    @classmethod
    def unmarshal(cls, raw: bytes) -> "SigningInfo":
        sh, pos = _read_varint(raw, 0)
        io, pos = _read_varint(raw, pos)
        mb, pos = _read_varint(raw, pos)
        return cls(sh, io, mb)


class SlashingKeeper:
    def __init__(
        self,
        store: KVStore,
        staking: StakingKeeper,
        window: int = SIGNED_BLOCKS_WINDOW,
    ):
        self.store = store
        self.staking = staking
        self.window = window

    # -- signing info ---------------------------------------------------

    def signing_info(self, operator: bytes) -> Optional[SigningInfo]:
        raw = self.store.get(_INFO_PREFIX + operator)
        return SigningInfo.unmarshal(raw) if raw is not None else None

    def _set_info(self, operator: bytes, info: SigningInfo) -> None:
        self.store.set(_INFO_PREFIX + operator, info.marshal())

    def _bitmap_get(self, operator: bytes, index: int) -> bool:
        return self.store.get(
            _BITMAP_PREFIX + operator + index.to_bytes(4, "big")
        ) is not None

    def _bitmap_set(self, operator: bytes, index: int, missed: bool) -> None:
        key = _BITMAP_PREFIX + operator + index.to_bytes(4, "big")
        if missed:
            self.store.set(key, b"\x01")
        else:
            self.store.delete(key)

    def _reset_window(self, operator: bytes, info: SigningInfo) -> None:
        for i in range(self.window):
            self._bitmap_set(operator, i, False)
        info.missed_blocks = 0
        info.index_offset = 0

    # -- liveness -------------------------------------------------------

    def handle_validator_signature(
        self, operator: bytes, signed: bool, height: int, now_ns: int
    ) -> Optional[int]:
        """Record one block's vote for a bonded validator; slash + jail on
        crossing the downtime threshold (SDK HandleValidatorSignature).
        Returns the slashed amount, or None if no slashing happened."""
        v = self.staking.validator(operator)
        if v is None or v.jailed:
            return None
        info = self.signing_info(operator)
        if info is None:
            info = SigningInfo(start_height=height)
        idx = info.index_offset % self.window
        info.index_offset += 1
        previously_missed = self._bitmap_get(operator, idx)
        if not signed and not previously_missed:
            info.missed_blocks += 1
            self._bitmap_set(operator, idx, True)
        elif signed and previously_missed:
            info.missed_blocks -= 1
            self._bitmap_set(operator, idx, False)

        max_missed = self.window - self.window * MIN_SIGNED_PER_WINDOW_PPM // 1_000_000
        slashed = None
        # only enforce once the validator has been around a full window
        if (
            height >= info.start_height + self.window
            and info.missed_blocks > max_missed
        ):
            slashed = self.staking.slash(operator, SLASH_FRACTION_DOWNTIME_PPM)
            self.staking.jail(operator, now_ns + DOWNTIME_JAIL_DURATION_NS)
            # reset the window so the validator starts clean after unjail
            self._reset_window(operator, info)
            info.start_height = height
        self._set_info(operator, info)
        return slashed

    def begin_blocker(
        self,
        votes: List[Tuple[bytes, bool]],
        height: int,
        now_ns: int,
    ) -> Dict[bytes, int]:
        """Process the previous commit's votes (SDK slashing BeginBlocker)."""
        slashes: Dict[bytes, int] = {}
        for operator, signed in votes:
            s = self.handle_validator_signature(operator, signed, height, now_ns)
            if s is not None:
                slashes[operator] = s
        return slashes

    # -- infractions ----------------------------------------------------

    def handle_equivocation(self, operator: bytes) -> int:
        """Double-sign: slash hard and tombstone (never unjailable) — the
        x/evidence -> slashing path."""
        v = self.staking.validator(operator)
        if v is None:
            raise SlashingError(f"unknown validator {operator.hex()}")
        if v.tombstoned:
            raise SlashingError("validator already tombstoned")
        slashed = self.staking.slash(operator, SLASH_FRACTION_DOUBLE_SIGN_PPM)
        self.staking.tombstone(operator)
        return slashed

    def unjail(self, operator: bytes, now_ns: int) -> None:
        """MsgUnjail: validator rejoins after the jail duration (never after
        a tombstone)."""
        self.staking.unjail(operator, now_ns)
