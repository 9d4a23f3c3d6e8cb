"""Prioritized mempool with TTL eviction.

Parity with the reference's consensus-side mempool config: v1 prioritized
mempool ordered by gas price, TTL of 5 blocks, MaxTxBytes bounded by the max
square (app/default_overrides.go:258-284; CAT pool spec
specs/src/specs/cat_pool.md is the gossip layer above this).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional

TTL_NUM_BLOCKS = 5


@dataclass
class MempoolTx:
    raw: bytes
    gas_price: float
    added_height: int
    tx_hash: bytes


class Mempool:
    def __init__(self, max_tx_bytes: int, ttl_blocks: int = TTL_NUM_BLOCKS):
        self.max_tx_bytes = max_tx_bytes
        self.ttl_blocks = ttl_blocks
        self._txs: Dict[bytes, MempoolTx] = {}
        self._order: Dict[bytes, int] = {}  # insertion sequence (FIFO ties)
        self._counter = 0

    def __len__(self) -> int:
        return len(self._txs)

    def add(self, raw: bytes, gas_price: float, height: int) -> bytes:
        if len(raw) > self.max_tx_bytes:
            raise ValueError(
                f"tx size {len(raw)} exceeds mempool max {self.max_tx_bytes}"
            )
        h = hashlib.sha256(raw).digest()
        if h not in self._txs:
            self._txs[h] = MempoolTx(raw, gas_price, height, h)
            self._order[h] = self._counter
            self._counter += 1
        return h

    def remove(self, tx_hash: bytes) -> None:
        self._txs.pop(tx_hash, None)
        self._order.pop(tx_hash, None)

    def reap(self, max_txs: Optional[int] = None) -> List[MempoolTx]:
        """Highest gas price first; strict FIFO within equal price (comet's
        prioritized mempool v1 ordering — a same-account sequence chain at
        one gas price must come out in submission order or FilterTxs drops
        the later nonces; data_square_layout.md 'Ordering')."""
        ordered = sorted(
            self._txs.values(),
            key=lambda t: (-t.gas_price, self._order[t.tx_hash]),
        )
        return ordered if max_txs is None else ordered[:max_txs]

    def recheck(self, still_valid) -> int:
        """Comet recheck parity: after a block commits, every pooled tx
        re-runs CheckTx against the fresh state; invalidated txs (spent
        balance, consumed sequence, expired timeout) leave the pool
        immediately instead of lingering until TTL.  Iterates in
        ADMISSION order — not reap order — because a same-account
        sequence chain was admitted oldest-nonce-first regardless of gas
        price, and rechecking a later nonce before an earlier one would
        wrongly evict a still-valid chain.
        still_valid(raw) -> bool; returns the eviction count."""
        evicted = 0
        for t in sorted(
            list(self._txs.values()), key=lambda t: self._order[t.tx_hash]
        ):
            if not still_valid(t.raw):
                self.remove(t.tx_hash)
                evicted += 1
        return evicted

    def evict_expired(self, current_height: int) -> int:
        expired = [
            h
            for h, t in self._txs.items()
            if current_height - t.added_height >= self.ttl_blocks
        ]
        for h in expired:
            del self._txs[h]
            self._order.pop(h, None)
        return len(expired)
