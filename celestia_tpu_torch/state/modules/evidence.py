"""x/evidence equivalent: equivocation (double-sign) evidence handling.

Parity role: the cosmos-sdk evidence keeper the reference wires at
app/app.go:200,328-332 (EvidenceKeeper routing equivocation
to the slashing keeper).  Evidence too old to act on is ignored (max-age
window, both height- and time-bounded like CometBFT's consensus params);
fresh evidence slashes + tombstones through x/slashing and is recorded so
a replay cannot double-slash.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional

from celestia_tpu_torch.da.shares import _read_varint, _varint
from celestia_tpu_torch.state.modules.slashing import SlashingKeeper
from celestia_tpu_torch.state.store import KVStore

MAX_AGE_NUM_BLOCKS = 100_000
MAX_AGE_DURATION_NS = 14 * 24 * 3600 * 10**9  # two weeks

_EVIDENCE_PREFIX = b"ev/"


class EvidenceError(ValueError):
    pass


def vote_sign_bytes(chain_id: str, height: int, block_hash: bytes) -> bytes:
    """Canonical consensus-vote digest a validator signs (one per height;
    two different block hashes at one height = equivocation)."""
    return hashlib.sha256(
        b"consensus-vote" + chain_id.encode() + _varint(height) + block_hash
    ).digest()


@dataclass(frozen=True)
class Equivocation:
    """Double-sign evidence: one validator, two CONFLICTING SIGNED votes at
    one height.  Unlike the SDK (where comet verifies evidence before it
    reaches the app), the msg-based submission path here is open to anyone,
    so the evidence must prove itself: both votes must verify under the
    validator's registered pubkey and commit to different block hashes."""

    validator: bytes
    height: int
    time_ns: int
    block_hash_a: bytes = b""
    sig_a: bytes = b""
    block_hash_b: bytes = b""
    sig_b: bytes = b""

    def hash(self) -> bytes:
        return hashlib.sha256(
            b"equivocation" + self.validator + _varint(self.height)
            + _varint(self.time_ns)
        ).digest()

    def verify(self, chain_id: str, pubkey: bytes) -> None:
        """Raise EvidenceError unless this is a provable double-sign."""
        from celestia_tpu_torch.utils.secp256k1 import PublicKey

        if self.block_hash_a == self.block_hash_b:
            raise EvidenceError("votes commit to the same block: no conflict")
        if not pubkey:
            raise EvidenceError("validator has no registered pubkey")
        try:
            pk = PublicKey.from_compressed(pubkey)
        except ValueError as e:
            raise EvidenceError(f"bad validator pubkey: {e}") from e
        for bh, sig, name in (
            (self.block_hash_a, self.sig_a, "a"),
            (self.block_hash_b, self.sig_b, "b"),
        ):
            if not pk.verify(vote_sign_bytes(chain_id, self.height, bh), sig):
                raise EvidenceError(f"vote {name} signature does not verify")

    def marshal(self) -> bytes:
        out = bytearray()
        out += self.validator
        out += _varint(self.height)
        out += _varint(self.time_ns)
        for b in (self.block_hash_a, self.sig_a, self.block_hash_b, self.sig_b):
            out += _varint(len(b))
            out += b
        return bytes(out)

    @classmethod
    def unmarshal(cls, raw: bytes) -> "Equivocation":
        val = raw[:20]
        h, pos = _read_varint(raw, 20)
        t, pos = _read_varint(raw, pos)
        fields = []
        for _ in range(4):
            n, pos = _read_varint(raw, pos)
            fields.append(raw[pos : pos + n])
            pos += n
        return cls(val, h, t, *fields)


class EvidenceKeeper:
    def __init__(self, store: KVStore, slashing: SlashingKeeper):
        self.store = store
        self.slashing = slashing

    def get(self, evidence_hash: bytes) -> Optional[Equivocation]:
        raw = self.store.get(_EVIDENCE_PREFIX + evidence_hash)
        return Equivocation.unmarshal(raw) if raw is not None else None

    def all_evidence(self) -> List[Equivocation]:
        return [
            Equivocation.unmarshal(v)
            for _, v in self.store.iterate(_EVIDENCE_PREFIX)
        ]

    def submit(
        self,
        ev: Equivocation,
        current_height: int,
        now_ns: int,
        chain_id: str = "",
        pubkey: bytes = b"",
    ) -> int:
        """Validate, record, and act on equivocation evidence.  Returns the
        slashed amount (SDK HandleEquivocationEvidence).  When chain_id is
        provided the evidence must PROVE the double-sign (two conflicting
        votes verifying under the validator's pubkey) — fabricated evidence
        must never slash."""
        if chain_id:
            ev.verify(chain_id, pubkey)
        if ev.height <= 0 or ev.height > current_height:
            raise EvidenceError(
                f"evidence height {ev.height} outside (0, {current_height}]"
            )
        age_blocks = current_height - ev.height
        age_ns = now_ns - ev.time_ns
        # expire only when BOTH bounds are exceeded (CometBFT's rule).
        # ev.time_ns is submitter-supplied and not signature-covered, so it
        # must never be the SOLE gate in either direction: the height bound
        # (consensus-verified) always has the final say.
        if age_blocks > MAX_AGE_NUM_BLOCKS and age_ns > MAX_AGE_DURATION_NS:
            raise EvidenceError(
                f"evidence too old: {age_blocks} blocks / {age_ns}ns past max age"
            )
        if self.get(ev.hash()) is not None:
            raise EvidenceError("evidence already submitted")
        slashed = self.slashing.handle_equivocation(ev.validator)
        self.store.set(_EVIDENCE_PREFIX + ev.hash(), ev.marshal())
        return slashed
