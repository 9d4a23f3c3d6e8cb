"""x/auth equivalent: account records (pubkey, account number, sequence).

Parity role: cosmos-sdk auth keeper as used by the reference's ante chain
(sig verification + nonce increment, SURVEY.md §2.1 "Ante chain").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.store import KVStore

_ACCOUNT_PREFIX = b"acc/"
_GLOBAL_NUM_KEY = b"next_account_number"


@dataclass
class Account:
    address: bytes
    pubkey: bytes  # 33-byte compressed, b"" until first tx
    account_number: int
    sequence: int

    def marshal(self) -> bytes:
        out = bytearray()
        out += _varint(len(self.pubkey))
        out += self.pubkey
        out += _varint(self.account_number)
        out += _varint(self.sequence)
        return bytes(out)

    @classmethod
    def unmarshal(cls, address: bytes, raw: bytes) -> "Account":
        n, pos = _read_varint(raw, 0)
        pubkey = raw[pos : pos + n]
        pos += n
        num, pos = _read_varint(raw, pos)
        seq, pos = _read_varint(raw, pos)
        return cls(address, pubkey, num, seq)


class AccountKeeper:
    def __init__(self, store: KVStore):
        self.store = store

    def get(self, address: bytes) -> Optional[Account]:
        raw = self.store.get(_ACCOUNT_PREFIX + address)
        if raw is None:
            return None
        return Account.unmarshal(address, raw)

    def set(self, acc: Account) -> None:
        self.store.set(_ACCOUNT_PREFIX + acc.address, acc.marshal())

    def peek(self, address: bytes) -> "Account":
        """Non-mutating read for query paths: the existing account, or the
        account AS IT WOULD BE CREATED (next global number, sequence 0)
        without writing anything.  Queries must never touch consensus
        state — a query-created account would fork the app hash between
        nodes that did and didn't serve it."""
        acc = self.get(address)
        if acc is not None:
            return acc
        num_raw = self.store.get(_GLOBAL_NUM_KEY)
        num = int.from_bytes(num_raw, "big") if num_raw else 0
        return Account(address, b"", num, 0)

    def get_or_create(self, address: bytes) -> Account:
        acc = self.get(address)
        if acc is None:
            num_raw = self.store.get(_GLOBAL_NUM_KEY)
            num = int.from_bytes(num_raw, "big") if num_raw else 0
            self.store.set(_GLOBAL_NUM_KEY, (num + 1).to_bytes(8, "big"))
            acc = Account(address, b"", num, 0)
            self.set(acc)
        return acc

    def increment_sequence(self, address: bytes) -> None:
        acc = self.get(address)
        if acc is None:
            raise KeyError(f"unknown account {address.hex()}")
        acc.sequence += 1
        self.set(acc)
