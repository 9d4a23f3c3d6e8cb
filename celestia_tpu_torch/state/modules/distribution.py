"""x/distribution equivalent: fee + inflation distribution to validators,
delegators, and the community pool.

Parity role: the cosmos-sdk distribution keeper the reference wires at
app/app.go:303-306 (DistrKeeper: community tax, proposer
reward, per-validator commission, F1 delegator rewards, withdraw msgs).

Design: the SDK's F1 fee-distribution scheme reduced to one cumulative
"reward per staked token" accumulator per validator (scaled by 1e18 for
integer precision).  Each delegation stores the accumulator value at its
last settlement; pending rewards = stake x (accum_now - accum_then).  A
before-delegation-modified staking hook settles rewards whenever stake
changes, which is exactly the invariant F1's period mechanism protects.
All arithmetic is integer — determinism across validators is a consensus
requirement.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.bank import BankKeeper, FEE_COLLECTOR, module_address
from celestia_tpu_torch.state.staking import StakingKeeper
from celestia_tpu_torch.state.store import KVStore

DISTRIBUTION_MODULE = module_address("distribution")

SCALE = 10**18  # accumulator fixed-point scale

# distribution params (SDK defaults, integer ppm)
COMMUNITY_TAX_PPM = 20_000  # 2%
BASE_PROPOSER_REWARD_PPM = 10_000  # 1%
BONUS_PROPOSER_REWARD_PPM = 40_000  # up to 4%, scaled by precommit power

_ACCUM_PREFIX = b"acc/"  # val -> cumulative reward-per-token (scaled)
_COMMISSION_PREFIX = b"com/"  # val -> accrued commission (utia)
_REF_PREFIX = b"ref/"  # delegator+val -> (stake, accum at settlement)
_WITHDRAW_ADDR_PREFIX = b"wa/"  # delegator -> withdraw address
_COMMUNITY_POOL_KEY = b"community_pool"
_DUST_KEY = b"dust"  # rounding residue retained by the module account


class DistributionError(ValueError):
    pass


class DistributionKeeper:
    def __init__(self, store: KVStore, bank: BankKeeper, staking: StakingKeeper):
        self.store = store
        self.bank = bank
        self.staking = staking

    def register_hooks(self) -> None:
        """Subscribe to staking: settle rewards before a stake change (the
        stored reference stake is what accrued), re-anchor at the new stake
        after (zero-delta settle; F1 period rollover)."""
        self.staking.hooks_before_delegation_modified.append(self._settle)
        self.staking.hooks_after_delegation_modified.append(self._settle)

    # -- small int helpers ---------------------------------------------

    def _get_int(self, key: bytes) -> int:
        raw = self.store.get(key)
        return int.from_bytes(raw, "big") if raw else 0

    def _set_int(self, key: bytes, value: int) -> None:
        if value:
            self.store.set(key, value.to_bytes(32, "big"))
        else:
            self.store.delete(key)

    # -- public read surface -------------------------------------------

    def community_pool(self) -> int:
        return self._get_int(_COMMUNITY_POOL_KEY)

    def commission(self, operator: bytes) -> int:
        return self._get_int(_COMMISSION_PREFIX + operator)

    def accumulator(self, operator: bytes) -> int:
        return self._get_int(_ACCUM_PREFIX + operator)

    def withdraw_address(self, delegator: bytes) -> bytes:
        raw = self.store.get(_WITHDRAW_ADDR_PREFIX + delegator)
        return raw if raw else delegator

    def set_withdraw_address(self, delegator: bytes, addr: bytes) -> None:
        self.store.set(_WITHDRAW_ADDR_PREFIX + delegator, addr)

    # -- delegation reference points -----------------------------------

    def _get_ref(self, delegator: bytes, operator: bytes) -> Tuple[int, int]:
        raw = self.store.get(_REF_PREFIX + delegator + operator)
        if raw is None:
            return 0, 0
        stake, pos = _read_varint(raw, 0)
        accum, pos = _read_varint(raw, pos)
        return stake, accum

    def _set_ref(
        self, delegator: bytes, operator: bytes, stake: int, accum: int
    ) -> None:
        if stake == 0 and accum == 0:
            self.store.delete(_REF_PREFIX + delegator + operator)
        else:
            self.store.set(
                _REF_PREFIX + delegator + operator,
                bytes(_varint(stake) + _varint(accum)),
            )

    def pending_rewards(self, delegator: bytes, operator: bytes) -> int:
        """Unsettled rewards since the last reference point, PLUS rewards
        for stake the keeper hasn't seen settle yet (a delegation made
        before distribution was wired starts at accum of first sight)."""
        stake, accum_then = self._get_ref(delegator, operator)
        accum_now = self.accumulator(operator)
        return stake * (accum_now - accum_then) // SCALE

    def _settle(self, delegator: bytes, operator: bytes) -> int:
        """Pay rewards accrued on the STORED reference stake, then anchor
        the reference point at the actual current stake."""
        reward = self.pending_rewards(delegator, operator)
        if reward:
            self.bank.send(
                DISTRIBUTION_MODULE, self.withdraw_address(delegator), reward
            )
        current_stake = self.staking.delegation(delegator, operator)
        self._set_ref(delegator, operator, current_stake, self.accumulator(operator))
        return reward

    # -- BeginBlocker: allocate the previous block's fees ---------------

    def allocate_tokens(
        self,
        proposer: Optional[bytes],
        votes: Optional[List[Tuple[bytes, bool]]] = None,
    ) -> Dict[str, int]:
        """Drain the fee collector (tx fees + that block's mint provision)
        into: community pool (2%), proposer reward (1% + up to 4% by signed
        power), and power-proportional validator rewards — the SDK
        AllocateTokens shape.  Votes are (operator, signed) pairs from the
        previous block's commit; None means every bonded validator signed."""
        fees = self.bank.balance(FEE_COLLECTOR)
        if fees == 0:
            return {"fees": 0}
        self.bank.send(FEE_COLLECTOR, DISTRIBUTION_MODULE, fees)

        bonded = {v.operator: v for v in self.staking.bonded_validators()}
        if votes is None:
            votes = [(op, True) for op in bonded]
        signed_power = sum(
            bonded[op].power for op, ok in votes if ok and op in bonded
        )
        total_power = sum(v.power for v in bonded.values())
        if total_power == 0 or signed_power == 0:
            # no validators to pay: everything goes to the community pool
            self._set_int(_COMMUNITY_POOL_KEY, self.community_pool() + fees)
            return {"fees": fees, "community": fees}

        community = fees * COMMUNITY_TAX_PPM // 1_000_000
        remaining = fees - community

        proposer_reward = 0
        if proposer is not None and proposer in bonded:
            # base 1% + bonus 4% x (signed power / total power)
            ppm = (
                BASE_PROPOSER_REWARD_PPM
                + BONUS_PROPOSER_REWARD_PPM * signed_power // total_power
            )
            proposer_reward = fees * ppm // 1_000_000
            self._credit_validator(bonded[proposer], proposer_reward)
            remaining -= proposer_reward

        # the rest splits over validators that signed, by power
        distributed = 0
        for op, ok in votes:
            if not ok or op not in bonded:
                continue
            share = remaining * bonded[op].power // signed_power
            self._credit_validator(bonded[op], share)
            distributed += share
        # integer-division dust accrues to the community pool
        community += remaining - distributed
        self._set_int(_COMMUNITY_POOL_KEY, self.community_pool() + community)
        return {
            "fees": fees,
            "community": community,
            "proposer": proposer_reward,
            "distributed": distributed,
        }

    def _credit_validator(self, validator, amount: int) -> None:
        """Split one validator's allocation into commission + delegator
        rewards; fold the delegator part into the F1 accumulator."""
        if amount == 0:
            return
        commission = amount * validator.commission_ppm // 1_000_000
        to_delegators = amount - commission
        op = validator.operator
        self._set_int(
            _COMMISSION_PREFIX + op, self.commission(op) + commission
        )
        if validator.tokens > 0 and to_delegators > 0:
            delta = to_delegators * SCALE // validator.tokens
            self._set_int(_ACCUM_PREFIX + op, self.accumulator(op) + delta)
            # per-token rounding dust stays in the module account
            dust = to_delegators - delta * validator.tokens // SCALE
            self._set_int(_DUST_KEY, self._get_int(_DUST_KEY) + dust)
        else:
            self._set_int(
                _COMMISSION_PREFIX + op, self.commission(op) + to_delegators
            )

    # -- msg handlers ---------------------------------------------------

    def withdraw_delegator_reward(self, delegator: bytes, operator: bytes) -> int:
        if self.staking.validator(operator) is None:
            raise DistributionError(f"unknown validator {operator.hex()}")
        return self._settle(delegator, operator)

    def withdraw_validator_commission(self, operator: bytes) -> int:
        amount = self.commission(operator)
        if amount == 0:
            raise DistributionError("no commission to withdraw")
        self._set_int(_COMMISSION_PREFIX + operator, 0)
        self.bank.send(
            DISTRIBUTION_MODULE, self.withdraw_address(operator), amount
        )
        return amount

    def fund_community_pool(self, from_addr: bytes, amount: int) -> None:
        self.bank.send(from_addr, DISTRIBUTION_MODULE, amount)
        self._set_int(_COMMUNITY_POOL_KEY, self.community_pool() + amount)

    def spend_community_pool(self, to_addr: bytes, amount: int) -> None:
        """Gov-gated community pool spend (CommunityPoolSpendProposal)."""
        pool = self.community_pool()
        if amount > pool:
            raise DistributionError(
                f"community pool has {pool}utia < spend {amount}utia"
            )
        self._set_int(_COMMUNITY_POOL_KEY, pool - amount)
        self.bank.send(DISTRIBUTION_MODULE, to_addr, amount)
