"""Staking keeper (lite): validators, voting power, delegations, unbonding,
and staking hooks.

Parity role: the cosmos-sdk staking keeper surface the reference actually
depends on — validator set + powers for x/upgrade's 5/6 quorum tally
(x/upgrade/keeper.go:137 TallyVotingPower) and for x/blobstream valsets
(keeper_valset.go GetCurrentValset), plus AfterValidatorBeginUnbonding /
AfterValidatorCreated hooks that trigger valset attestations
(x/blobstream/keeper/hooks.go:24-43).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.bank import BONDED_POOL, NOT_BONDED_POOL, BankKeeper
from celestia_tpu_torch.state.store import KVStore

_VAL_PREFIX = b"val/"
_DEL_PREFIX = b"del/"

POWER_REDUCTION = 1_000_000  # utia per unit of consensus power


DEFAULT_COMMISSION_PPM = 100_000  # 10% validator commission


@dataclass
class Validator:
    operator: bytes  # 20-byte address
    tokens: int  # bonded utia
    jailed: bool = False
    commission_ppm: int = DEFAULT_COMMISSION_PPM
    # ns timestamp until which a jailed validator cannot unjail (x/slashing)
    jailed_until_ns: int = 0
    # tombstoned validators (double-signers) can never unjail
    tombstoned: bool = False

    @property
    def power(self) -> int:
        return self.tokens // POWER_REDUCTION

    def marshal(self) -> bytes:
        out = bytearray()
        out += _varint(self.tokens)
        out += _varint(1 if self.jailed else 0)
        out += _varint(self.commission_ppm)
        out += _varint(self.jailed_until_ns)
        out += _varint(1 if self.tombstoned else 0)
        return bytes(out)

    @classmethod
    def unmarshal(cls, operator: bytes, raw: bytes) -> "Validator":
        tokens, pos = _read_varint(raw, 0)
        jailed, pos = _read_varint(raw, pos)
        commission, pos = _read_varint(raw, pos)
        jailed_until, pos = _read_varint(raw, pos)
        tombstoned, pos = _read_varint(raw, pos)
        return cls(
            operator, tokens, bool(jailed), commission, jailed_until,
            bool(tombstoned),
        )


class StakingKeeper:
    def __init__(self, store: KVStore, bank: BankKeeper):
        self.store = store
        self.bank = bank
        # blobstream subscribes to these (x/blobstream/keeper/hooks.go)
        self.hooks_after_validator_created: List[Callable[[bytes], None]] = []
        self.hooks_after_unbonding_initiated: List[Callable[[bytes], None]] = []
        # x/distribution subscribes: rewards must be settled before a
        # delegation's stake changes, and the reference point re-anchored
        # at the new stake afterwards (F1 period semantics)
        self.hooks_before_delegation_modified: List[
            Callable[[bytes, bytes], None]
        ] = []
        self.hooks_after_delegation_modified: List[
            Callable[[bytes, bytes], None]
        ] = []

    # --- validators -------------------------------------------------------

    def validator(self, operator: bytes) -> Optional[Validator]:
        raw = self.store.get(_VAL_PREFIX + operator)
        return Validator.unmarshal(operator, raw) if raw is not None else None

    def set_validator(self, v: Validator) -> None:
        self.store.set(_VAL_PREFIX + v.operator, v.marshal())

    def validators(self) -> List[Validator]:
        return [
            Validator.unmarshal(k[len(_VAL_PREFIX):], v)
            for k, v in self.store.iterate(_VAL_PREFIX)
        ]

    def bonded_validators(self) -> List[Validator]:
        return [v for v in self.validators() if not v.jailed and v.power > 0]

    def total_power(self) -> int:
        return sum(v.power for v in self.bonded_validators())

    def create_validator(self, operator: bytes, self_delegation: int) -> Validator:
        if self.validator(operator) is not None:
            raise ValueError("validator already exists")
        v = Validator(operator, 0)
        self.set_validator(v)
        self.delegate(operator, operator, self_delegation)
        for hook in self.hooks_after_validator_created:
            hook(operator)
        return self.validator(operator)

    # --- delegations ------------------------------------------------------

    def delegation(self, delegator: bytes, operator: bytes) -> int:
        raw = self.store.get(_DEL_PREFIX + delegator + operator)
        return int.from_bytes(raw, "big") if raw else 0

    def delegate(self, delegator: bytes, operator: bytes, amount: int) -> None:
        v = self.validator(operator)
        if v is None:
            raise ValueError(f"unknown validator {operator.hex()}")
        for hook in self.hooks_before_delegation_modified:
            hook(delegator, operator)
        self.bank.send(delegator, BONDED_POOL, amount)
        v.tokens += amount
        self.set_validator(v)
        self.store.set(
            _DEL_PREFIX + delegator + operator,
            (self.delegation(delegator, operator) + amount).to_bytes(16, "big"),
        )
        for hook in self.hooks_after_delegation_modified:
            hook(delegator, operator)

    def undelegate(self, delegator: bytes, operator: bytes, amount: int) -> None:
        """Begin unbonding; tokens move to the not-bonded pool immediately
        (unbonding period bookkeeping is tracked by consumers via hooks)."""
        v = self.validator(operator)
        if v is None:
            raise ValueError(f"unknown validator {operator.hex()}")
        cur = self.delegation(delegator, operator)
        if cur < amount:
            raise ValueError("undelegate amount exceeds delegation")
        for hook in self.hooks_before_delegation_modified:
            hook(delegator, operator)
        self.store.set(
            _DEL_PREFIX + delegator + operator, (cur - amount).to_bytes(16, "big")
        )
        v.tokens -= amount
        self.set_validator(v)
        self.bank.send(BONDED_POOL, NOT_BONDED_POOL, amount)
        for hook in self.hooks_after_delegation_modified:
            hook(delegator, operator)
        # delegator claim tracked out-of-band; release at maturity not modeled
        for hook in self.hooks_after_unbonding_initiated:
            hook(operator)

    def powers_snapshot(self) -> Dict[bytes, int]:
        return {v.operator: v.power for v in self.bonded_validators()}

    # --- punitive surface (x/slashing & x/evidence call these) ------------

    def slash(self, operator: bytes, fraction_ppm: int) -> int:
        """Burn fraction_ppm of the validator's bonded tokens (the SDK
        Slash path: tokens leave the bonded pool and the supply).

        Every DELEGATION to the validator is cut by the same fraction and
        the validator's tokens drop by exactly the sum of the cuts, so
        delegations always sum to validator tokens and the bonded pool
        stays 1:1 backed — without this, a post-slash undelegate would
        withdraw pre-slash amounts, draining other validators' backing
        (the SDK gets the same effect through its shares exchange rate).
        Returns the burned amount."""
        v = self.validator(operator)
        if v is None:
            raise ValueError(f"unknown validator {operator.hex()}")
        burn = 0
        for key, raw in list(self.store.iterate(_DEL_PREFIX)):
            if not key.endswith(operator):
                continue
            delegation = int.from_bytes(raw, "big")
            cut = delegation * fraction_ppm // 1_000_000
            if cut == 0:
                continue
            delegator = key[len(_DEL_PREFIX) : len(_DEL_PREFIX) + 20]
            # settle rewards at the pre-slash stake and re-anchor after —
            # a stale F1 reference point would over-pay rewards on stake
            # that no longer exists
            for hook in self.hooks_before_delegation_modified:
                hook(delegator, operator)
            self.store.set(key, (delegation - cut).to_bytes(16, "big"))
            burn += cut
            for hook in self.hooks_after_delegation_modified:
                hook(delegator, operator)
        if burn == 0:
            return 0
        v.tokens -= burn
        self.set_validator(v)
        self.bank.burn(BONDED_POOL, burn)
        return burn

    def jail(self, operator: bytes, until_ns: int = 0) -> None:
        v = self.validator(operator)
        if v is None:
            raise ValueError(f"unknown validator {operator.hex()}")
        v.jailed = True
        v.jailed_until_ns = max(v.jailed_until_ns, until_ns)
        self.set_validator(v)

    def unjail(self, operator: bytes, now_ns: int) -> None:
        v = self.validator(operator)
        if v is None:
            raise ValueError(f"unknown validator {operator.hex()}")
        if not v.jailed:
            raise ValueError("validator is not jailed")
        if v.tombstoned:
            raise ValueError("validator is tombstoned (double-sign); cannot unjail")
        if now_ns < v.jailed_until_ns:
            raise ValueError(
                f"validator jailed until t={v.jailed_until_ns}ns (now {now_ns}ns)"
            )
        v.jailed = False
        self.set_validator(v)

    def tombstone(self, operator: bytes) -> None:
        v = self.validator(operator)
        if v is None:
            raise ValueError(f"unknown validator {operator.hex()}")
        v.jailed = True
        v.tombstoned = True
        self.set_validator(v)
