"""x/feegrant equivalent: fee allowances (granter pays a grantee's tx fees).

Parity role: cosmos-sdk feegrant keeper as wired into the reference's ante
chain (NewDeductFeeDecorator(accountKeeper, bankKeeper, feegrantKeeper, ...),
app/ante/ante.go:60-62).  Two allowance kinds mirror the
SDK's: BasicAllowance (optional one-shot spend limit + optional expiration)
and PeriodicAllowance (a basic envelope plus a per-period budget that
refills every period).

All amounts are integer utia; all times are integer nanoseconds — the same
decimal-determinism rule the rest of the state machine follows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.store import KVStore

_GRANT_PREFIX = b"fg/"

KIND_BASIC = 0
KIND_PERIODIC = 1


class FeeGrantError(ValueError):
    pass


@dataclass
class Allowance:
    """One allowance record.  spend_limit/expiration of 0 mean "unset"
    (an explicit zero-limit grant is meaningless and rejected on grant)."""

    kind: int = KIND_BASIC
    spend_limit: int = 0  # 0 = unlimited
    expiration_ns: int = 0  # 0 = never expires
    # periodic-only fields
    period_ns: int = 0
    period_spend_limit: int = 0
    period_can_spend: int = 0
    period_reset_ns: int = 0

    def marshal(self) -> bytes:
        out = bytearray()
        out += _varint(self.kind)
        out += _varint(self.spend_limit)
        out += _varint(self.expiration_ns)
        out += _varint(self.period_ns)
        out += _varint(self.period_spend_limit)
        out += _varint(self.period_can_spend)
        out += _varint(self.period_reset_ns)
        return bytes(out)

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Allowance":
        pos = 0
        kind, pos = _read_varint(raw, pos)
        spend, pos = _read_varint(raw, pos)
        exp, pos = _read_varint(raw, pos)
        pns, pos = _read_varint(raw, pos)
        plim, pos = _read_varint(raw, pos)
        pcan, pos = _read_varint(raw, pos)
        prst, pos = _read_varint(raw, pos)
        return cls(kind, spend, exp, pns, plim, pcan, prst)


class FeeGrantKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    # -- grant lifecycle ------------------------------------------------

    def grant(self, granter: bytes, grantee: bytes, allowance: Allowance) -> None:
        if granter == grantee:
            raise FeeGrantError("cannot self-grant a fee allowance")
        if self.get(granter, grantee) is not None:
            raise FeeGrantError("fee allowance already exists; revoke it first")
        if allowance.kind == KIND_PERIODIC:
            if allowance.period_ns <= 0 or allowance.period_spend_limit <= 0:
                raise FeeGrantError("periodic allowance needs period and limit")
            allowance.period_can_spend = allowance.period_spend_limit
        elif allowance.kind != KIND_BASIC:
            raise FeeGrantError(f"unknown allowance kind {allowance.kind}")
        self.store.set(_GRANT_PREFIX + granter + grantee, allowance.marshal())

    def revoke(self, granter: bytes, grantee: bytes) -> None:
        key = _GRANT_PREFIX + granter + grantee
        if self.store.get(key) is None:
            raise FeeGrantError("fee allowance not found")
        self.store.delete(key)

    def get(self, granter: bytes, grantee: bytes) -> Optional[Allowance]:
        raw = self.store.get(_GRANT_PREFIX + granter + grantee)
        return Allowance.unmarshal(raw) if raw is not None else None

    def grants_by_granter(self, granter: bytes) -> List[Tuple[bytes, Allowance]]:
        return [
            (k[len(_GRANT_PREFIX) + 20 :], Allowance.unmarshal(v))
            for k, v in self.store.iterate(_GRANT_PREFIX + granter)
        ]

    # -- the ante-chain entry point ------------------------------------

    def use_grant(
        self, granter: bytes, grantee: bytes, fee: int, now_ns: int
    ) -> None:
        """Accept or reject spending `fee` from the allowance; mutates the
        record (SDK Allowance.Accept semantics).  Expired or exhausted
        allowances are pruned on touch."""
        key = _GRANT_PREFIX + granter + grantee
        allowance = self.get(granter, grantee)
        if allowance is None:
            raise FeeGrantError(
                f"no fee allowance from {granter.hex()} to {grantee.hex()}"
            )
        if allowance.expiration_ns and now_ns >= allowance.expiration_ns:
            self.store.delete(key)
            raise FeeGrantError("fee allowance expired")
        if allowance.kind == KIND_PERIODIC:
            # refill the period budget if one or more periods elapsed
            if now_ns >= allowance.period_reset_ns:
                allowance.period_can_spend = allowance.period_spend_limit
                reset = allowance.period_reset_ns or now_ns
                while reset <= now_ns:
                    reset += allowance.period_ns
                allowance.period_reset_ns = reset
            if fee > allowance.period_can_spend:
                raise FeeGrantError(
                    f"fee {fee}utia exceeds period budget "
                    f"{allowance.period_can_spend}utia"
                )
            allowance.period_can_spend -= fee
        if allowance.spend_limit:
            if fee > allowance.spend_limit:
                raise FeeGrantError(
                    f"fee {fee}utia exceeds allowance {allowance.spend_limit}utia"
                )
            allowance.spend_limit -= fee
            if allowance.spend_limit == 0:
                # fully spent basic allowance is removed (SDK `remove` flag)
                self.store.delete(key)
                return
        self.store.set(key, allowance.marshal())
