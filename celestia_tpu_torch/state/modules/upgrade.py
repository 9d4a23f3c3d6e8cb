"""x/upgrade: single-binary coordinated upgrades via validator signalling.

Parity with x/upgrade/: validators MsgSignalVersion for the
current or next app version (keeper.go:60), MsgTryUpgrade tallies signalled
power (keeper.go:87, TallyVotingPower :137) and schedules the upgrade once
>= 5/6 of bonded power signalled; the app's EndBlocker consumes
ShouldUpgrade to bump the app version and run migrations
(app/app.go:675-708, ADR-018).  Signals reset on upgrade.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from celestia_tpu_torch.state.staking import StakingKeeper
from celestia_tpu_torch.state.store import KVStore

_SIGNAL_PREFIX = b"signal/"
_PENDING_KEY = b"pending_upgrade"

# quorum: 5/6 of total bonded power (keeper.go threshold)
QUORUM_NUM = 5
QUORUM_DEN = 6


class UpgradeKeeper:
    def __init__(self, store: KVStore, staking: StakingKeeper):
        self.store = store
        self.staking = staking

    # --- signalling -------------------------------------------------------

    def signal_version(self, validator: bytes, version: int, current_version: int) -> None:
        if self.staking.validator(validator) is None:
            raise ValueError(f"unknown validator {validator.hex()}")
        if version not in (current_version, current_version + 1):
            raise ValueError(
                f"can only signal the current ({current_version}) or next "
                f"({current_version + 1}) version, got {version}"
            )
        self.store.set(_SIGNAL_PREFIX + validator, version.to_bytes(8, "big"))

    def signals(self) -> Dict[bytes, int]:
        return {
            k[len(_SIGNAL_PREFIX):]: int.from_bytes(v, "big")
            for k, v in self.store.iterate(_SIGNAL_PREFIX)
        }

    def tally_voting_power(self, version: int) -> Tuple[int, int]:
        """(power signalled for version, total bonded power)."""
        powers = self.staking.powers_snapshot()
        signalled = sum(
            powers.get(val, 0)
            for val, v in self.signals().items()
            if v == version
        )
        return signalled, self.staking.total_power()

    def try_upgrade(self, current_version: int) -> bool:
        """Tally for current+1; if quorum met, schedule the upgrade
        (consumed by the app's EndBlocker)."""
        target = current_version + 1
        signalled, total = self.tally_voting_power(target)
        if total == 0:
            return False
        if signalled * QUORUM_DEN >= QUORUM_NUM * total:
            self.store.set(_PENDING_KEY, target.to_bytes(8, "big"))
            return True
        return False

    # --- EndBlocker consumption -------------------------------------------

    def should_upgrade(self) -> Optional[int]:
        raw = self.store.get(_PENDING_KEY)
        return int.from_bytes(raw, "big") if raw else None

    def consume_upgrade(self) -> None:
        """Clear pending upgrade + all signals (post-migration reset)."""
        self.store.delete(_PENDING_KEY)
        for val in list(self.signals()):
            self.store.delete(_SIGNAL_PREFIX + val)
