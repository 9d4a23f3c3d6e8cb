"""x/bank equivalent: balances, transfers, module accounts, supply, and
vesting-account lock enforcement.

Parity role: cosmos-sdk bank keeper (fee deduction in the ante chain, mint
module provisioning, staking bonding — SURVEY.md §2.1).  Single native denom
``utia`` (appconsts.BondDenom).

Vesting (auth/vesting parity): a vesting schedule stored against an address
locks part of its balance; `send` rejects spends of locked coins.  The
block time the locks are evaluated at is written INTO the bank store by the
App's BeginBlocker, so every branch (check state, ante branch, deliver
branch) sees the same deterministic clock — a wall-clock read here would
fork app hashes between validators.  Like the SDK, delegating locked coins
is allowed (sends to the bonded pool bypass the lock).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.store import KVStore

_BALANCE_PREFIX = b"bal/"
_SUPPLY_KEY = b"supply"
_VESTING_PREFIX = b"vest/"
_BLOCK_TIME_KEY = b"block_time_ns"


def module_address(name: str) -> bytes:
    """Deterministic address of a module account (fee collector, mint, bonded pool)."""
    return hashlib.sha256(b"module/" + name.encode()).digest()[:20]


FEE_COLLECTOR = module_address("fee_collector")
MINT_MODULE = module_address("mint")
BONDED_POOL = module_address("bonded_tokens_pool")
NOT_BONDED_POOL = module_address("not_bonded_tokens_pool")


class BankKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    @staticmethod
    def balance_key(addr: bytes) -> bytes:
        """The raw store key for an account balance — what a light client
        asks the `store/proof` query route to prove."""
        return _BALANCE_PREFIX + addr

    def balance(self, addr: bytes) -> int:
        raw = self.store.get(_BALANCE_PREFIX + addr)
        return int.from_bytes(raw, "big") if raw else 0

    def _set_balance(self, addr: bytes, amount: int) -> None:
        if amount < 0:
            raise ValueError("negative balance")
        if amount == 0:
            self.store.delete(_BALANCE_PREFIX + addr)
        else:
            self.store.set(_BALANCE_PREFIX + addr, amount.to_bytes(16, "big"))

    def supply(self) -> int:
        raw = self.store.get(_SUPPLY_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def send(self, from_addr: bytes, to_addr: bytes, amount: int) -> None:
        if amount < 0:
            raise ValueError("negative send amount")
        bal = self.balance(from_addr)
        if bal < amount:
            raise ValueError(
                f"insufficient funds: balance {bal}utia < {amount}utia"
            )
        if to_addr != BONDED_POOL:  # delegating locked coins is allowed
            locked = self.locked(from_addr)
            if bal - amount < locked:
                raise ValueError(
                    f"insufficient spendable funds: balance {bal}utia has "
                    f"{locked}utia still vesting"
                )
        self._set_balance(from_addr, bal - amount)
        self._set_balance(to_addr, self.balance(to_addr) + amount)

    def mint(self, to_addr: bytes, amount: int) -> None:
        """Create new supply (x/mint BeginBlocker provisioning)."""
        self._set_balance(to_addr, self.balance(to_addr) + amount)
        self.store.set(_SUPPLY_KEY, (self.supply() + amount).to_bytes(16, "big"))

    def burn(self, from_addr: bytes, amount: int) -> None:
        bal = self.balance(from_addr)
        if bal < amount:
            raise ValueError("insufficient funds to burn")
        self._set_balance(from_addr, bal - amount)
        self.store.set(_SUPPLY_KEY, (self.supply() - amount).to_bytes(16, "big"))

    def all_balances(self) -> Dict[bytes, int]:
        return {
            k[len(_BALANCE_PREFIX):]: int.from_bytes(v, "big")
            for k, v in self.store.iterate(_BALANCE_PREFIX)
        }

    # -- vesting accounts ----------------------------------------------
    #
    # schedule record: (original_vesting, start_ns, end_ns, delayed)
    # delayed=1: everything locked until end (DelayedVestingAccount);
    # delayed=0: linear release between start and end (ContinuousVesting).

    def set_block_time(self, now_ns: int) -> None:
        """Called by the App's BeginBlocker; the deterministic clock every
        lock evaluation uses."""
        self.store.set(_BLOCK_TIME_KEY, now_ns.to_bytes(8, "big"))

    def block_time(self) -> int:
        raw = self.store.get(_BLOCK_TIME_KEY)
        return int.from_bytes(raw, "big") if raw else 0

    def vesting_schedule(
        self, addr: bytes
    ) -> Optional[Tuple[int, int, int, bool]]:
        raw = self.store.get(_VESTING_PREFIX + addr)
        if raw is None:
            return None
        orig, pos = _read_varint(raw, 0)
        start, pos = _read_varint(raw, pos)
        end, pos = _read_varint(raw, pos)
        delayed, pos = _read_varint(raw, pos)
        return orig, start, end, bool(delayed)

    def set_vesting_schedule(
        self, addr: bytes, original: int, start_ns: int, end_ns: int,
        delayed: bool,
    ) -> None:
        if self.vesting_schedule(addr) is not None:
            raise ValueError("account already has a vesting schedule")
        if end_ns <= start_ns or original <= 0:
            raise ValueError("invalid vesting schedule")
        self.store.set(
            _VESTING_PREFIX + addr,
            bytes(
                _varint(original) + _varint(start_ns) + _varint(end_ns)
                + _varint(1 if delayed else 0)
            ),
        )

    def locked(self, addr: bytes) -> int:
        """Still-vesting amount at the current block time; fully-vested
        schedules are pruned on touch."""
        sched = self.vesting_schedule(addr)
        if sched is None:
            return 0
        original, start, end, delayed = sched
        now = self.block_time()
        if now >= end:
            self.store.delete(_VESTING_PREFIX + addr)
            return 0
        if delayed or now <= start:
            return original
        # continuous: linear release over [start, end]
        return original * (end - now) // (end - start)

    def spendable(self, addr: bytes) -> int:
        return max(0, self.balance(addr) - self.locked(addr))

    # -- multi-denom (IBC vouchers) ------------------------------------
    #
    # The native denom rides the fast single-denom path above; other denoms
    # (ICS-20 voucher denoms on counterparty chains in tests — Celestia
    # itself never mints one thanks to x/tokenfilter) are stored under
    # denom-scoped keys.

    NATIVE_DENOM = "utia"

    def balance_of(self, addr: bytes, denom: str) -> int:
        if denom == self.NATIVE_DENOM:
            return self.balance(addr)
        raw = self.store.get(b"bal2/" + denom.encode() + b"/" + addr)
        return int.from_bytes(raw, "big") if raw else 0

    def _set_balance_of(self, addr: bytes, denom: str, amount: int) -> None:
        if denom == self.NATIVE_DENOM:
            self._set_balance(addr, amount)
            return
        if amount < 0:
            raise ValueError("negative balance")
        key = b"bal2/" + denom.encode() + b"/" + addr
        if amount == 0:
            self.store.delete(key)
        else:
            self.store.set(key, amount.to_bytes(16, "big"))

    def send_denom(
        self, from_addr: bytes, to_addr: bytes, amount: int, denom: str
    ) -> None:
        if denom == self.NATIVE_DENOM:
            self.send(from_addr, to_addr, amount)
            return
        bal = self.balance_of(from_addr, denom)
        if amount < 0 or bal < amount:
            raise ValueError(
                f"insufficient funds: balance {bal}{denom} < {amount}{denom}"
            )
        self._set_balance_of(from_addr, denom, bal - amount)
        self._set_balance_of(
            to_addr, denom, self.balance_of(to_addr, denom) + amount
        )

    def mint_denom(self, to_addr: bytes, amount: int, denom: str) -> None:
        if denom == self.NATIVE_DENOM:
            self.mint(to_addr, amount)
            return
        self._set_balance_of(
            to_addr, denom, self.balance_of(to_addr, denom) + amount
        )

    def burn_denom(self, from_addr: bytes, amount: int, denom: str) -> None:
        if denom == self.NATIVE_DENOM:
            self.burn(from_addr, amount)
            return
        bal = self.balance_of(from_addr, denom)
        if bal < amount:
            raise ValueError("insufficient funds to burn")
        self._set_balance_of(from_addr, denom, bal - amount)
