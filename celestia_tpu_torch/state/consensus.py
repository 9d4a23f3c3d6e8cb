"""Consensus wire primitives: the data structures and digests a commit
certificate is MADE of, below the engine that assembles them.

Moved out of node/bft.py and node/testnode.py (celint R8): the IBC
07-tendermint light client (state/modules/ibc_client.py) verifies vote
signatures and block ids, and the persistence layer (state/disk.py)
replays Block records — both live in ``state/``, which sits BELOW
``node/`` in the package DAG, so the pure wire/crypto pieces they share
with the BFT engine live here.  node/bft.py and node/testnode.py
re-export every name, so engine-side callers are unchanged.

Everything in this module is a pure function of its inputs (sha256
digests, frozen dataclasses) — no engine state, no clocks, no I/O.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, List, Optional, Tuple

if TYPE_CHECKING:  # pragma: no cover — annotation-only
    from celestia_tpu_torch.state.app import TxResult

NIL = b""  # block_id of a nil vote

PREVOTE = "prevote"
PRECOMMIT = "precommit"


def _varint(n: int) -> bytes:
    if n < 0:
        # a negative int never terminates the shift loop below; every
        # wire decoder range-checks before reaching here, this is the
        # last line of defense against a hang
        raise ValueError(f"varint of negative int {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def block_id_of(
    height: int,
    time_ns: int,
    square_size: int,
    data_root: bytes,
    proposer: bytes,
    last_commit_digest: bytes,
    prev_app_hash: bytes = b"",
) -> bytes:
    """The consensus block id: commits to EVERY field that feeds
    finalization — height, timestamp, layout, the data root (which
    commits to every tx byte via the DAH), the proposer, the previous
    block's commit certificate (LastCommitInfo feeds distribution and
    slashing, so replicas must agree on it byte-for-byte) and the app
    hash the previous block produced (Tendermint's header.AppHash: this
    is what lets a commit certificate double as a LIGHT-CLIENT proof of
    the chain's state root, the ibc 07-tendermint role)."""
    return hashlib.sha256(
        b"block-id" + _varint(height) + _varint(time_ns)
        + _varint(square_size) + data_root + proposer + last_commit_digest
        + prev_app_hash
    ).digest()


def vote_sign_bytes(
    chain_id: str, height: int, round_: int, vtype: str, block_id: bytes
) -> bytes:
    """Round- and type-scoped vote digest.  Signing two DIFFERENT block
    ids at one (height, round, type) is equivocation; re-voting across
    rounds is legitimate Tendermint behavior and hashes differently."""
    return hashlib.sha256(
        b"bft-vote" + vtype.encode() + b"|" + chain_id.encode()
        + _varint(height) + _varint(round_) + block_id
    ).digest()


def proposal_sign_bytes(
    chain_id: str, height: int, round_: int, pol_round: int, block_id: bytes
) -> bytes:
    return hashlib.sha256(
        b"bft-proposal|" + chain_id.encode() + _varint(height)
        + _varint(round_) + _varint(pol_round + 1) + block_id
    ).digest()


@dataclass(frozen=True)
class Vote:
    vtype: str  # PREVOTE / PRECOMMIT
    height: int
    round: int
    block_id: bytes  # NIL for a nil vote
    validator: bytes
    signature: bytes = b""

    def to_wire(self) -> dict:
        return {
            "kind": "vote",
            "vtype": self.vtype,
            "height": self.height,
            "round": self.round,
            "block_id": self.block_id.hex(),
            "validator": self.validator.hex(),
            "signature": self.signature.hex(),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Vote":
        height = int(d["height"])
        round_ = int(d["round"])
        if height <= 0 or round_ < 0:
            # negative ints would spin _varint forever in vote_sign_bytes
            raise ValueError("vote fields out of range")
        return cls(
            vtype=d["vtype"],
            height=height,
            round=round_,
            block_id=bytes.fromhex(d["block_id"]),
            validator=bytes.fromhex(d["validator"]),
            signature=bytes.fromhex(d["signature"]),
        )


@dataclass
class BlockHeader:
    height: int
    time_ns: int
    chain_id: str
    app_version: int
    data_hash: bytes
    app_hash: bytes  # state root AFTER this block
    square_size: int


@dataclass
class Block:
    header: BlockHeader
    txs: List[bytes]
    tx_results: List["TxResult"] = field(default_factory=list)
    # the commit info applied with this block (ABCI LastCommitInfo role);
    # replayed verbatim during catch-up so app hashes reproduce
    proposer: bytes = b""
    votes: Optional[List[Tuple[bytes, bool]]] = None
