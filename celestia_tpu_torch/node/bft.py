"""Two-phase BFT consensus engine: per-validator Tendermint state machine.

Prevote/precommit with 2/3 quorums, proposer locking, timeout-driven
rounds — each validator decides commit from the votes IT has verified,
with any coordinator acting as dumb transport only.  node/network.py
keeps the single-phase, centrally-sequenced driver for replication tests.

Role parity: celestia-core's consensus state machine (SURVEY §2.2; the
algorithm is Tendermint consensus, Buchman-Kwon-Milosevic
arXiv:1807.04938).  The implementation is message-driven and clock-free:
the engine never reads a wall clock — transports deliver messages via
``receive`` and fire ``on_timeout_*`` when their timers lapse, which is
what makes safety properties unit-testable (partitions, conflicting
proposals, dropped messages) without real time.

Safety intuition, enforced by the vote rules below:
- a validator PREVOTES a proposal only if it validates on its own state
  AND does not conflict with a block it locked earlier;
- it LOCKS (and precommits) only after seeing a 2/3-power polka of
  prevotes for that exact block in the current round;
- once locked, it prevotes against competing proposals unless a LATER
  polka (proof-of-lock round >= its lock round) justifies unlocking;
- it DECIDES only on 2/3-power precommits for one block in one round.
Two conflicting blocks can thus both commit at a height only if >= 1/3
of the power signed conflicting votes — the standard BFT bound, and the
engine reports every such double-sign it observes via on_equivocation.
"""

from __future__ import annotations

import hashlib
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from celestia_tpu_torch.utils.secp256k1 import PrivateKey, PublicKey

# The wire/crypto primitives (NIL, PREVOTE/PRECOMMIT, _varint,
# block_id_of, vote_sign_bytes, proposal_sign_bytes, Vote) moved to
# state/consensus.py so the IBC light client and the persistence layer
# can use them WITHOUT importing node/ (celint R8); re-exported here so
# engine-side callers are unchanged.
from celestia_tpu_torch.state.consensus import (  # noqa: F401
    NIL,
    PRECOMMIT,
    PREVOTE,
    Vote,
    _varint,
    block_id_of,
    proposal_sign_bytes,
    vote_sign_bytes,
)

STEP_PROPOSE = "propose"
STEP_PREVOTE = "prevote"
STEP_PRECOMMIT = "precommit"


@dataclass(frozen=True)
class BlockPayload:
    """What a proposal carries: everything needed to validate + finalize.

    ``last_commit`` is the precommit certificate for height-1 as observed
    by THIS block's proposer.  Replicas verify it (>= 2/3 power of valid
    signatures over the previous block id) and feed it to finalization as
    LastCommitInfo — the Tendermint pattern of carrying block H-1's
    commit inside block H so all replicas apply identical reward/slash
    inputs regardless of which certificate their own engine assembled.
    """

    height: int
    time_ns: int
    square_size: int
    data_root: bytes
    txs: Tuple[bytes, ...]
    proposer: bytes = b""
    last_commit: Tuple["Vote", ...] = ()
    # the app hash committed by block height-1 (Tendermint header.AppHash);
    # replicas reject a payload whose value differs from their own commit,
    # so a 2/3 certificate over this block id PROVES the state root to
    # IBC light clients
    prev_app_hash: bytes = b""

    def last_commit_digest(self) -> bytes:
        h = hashlib.sha256(b"last-commit")
        for v in self.last_commit:
            h.update(v.validator)
            h.update(_varint(v.round))
            h.update(v.block_id)
            h.update(v.signature)
        return h.digest()

    @property
    def block_id(self) -> bytes:
        return block_id_of(
            self.height, self.time_ns, self.square_size, self.data_root,
            self.proposer, self.last_commit_digest(), self.prev_app_hash,
        )

    def header_fields(self) -> dict:
        """The block-id preimage WITHOUT txs — what an IBC light client
        needs to recompute the id a commit certificate signs."""
        return {
            "height": self.height,
            "time_ns": self.time_ns,
            "square_size": self.square_size,
            "data_root": self.data_root.hex(),
            "proposer": self.proposer.hex(),
            "last_commit_digest": self.last_commit_digest().hex(),
            "prev_app_hash": self.prev_app_hash.hex(),
        }

    def commit_signers(self) -> Set[bytes]:
        return {v.validator for v in self.last_commit}

    def to_wire(self) -> dict:
        return {
            "height": self.height,
            "time_ns": self.time_ns,
            "square_size": self.square_size,
            "data_root": self.data_root.hex(),
            "txs": [t.hex() for t in self.txs],
            "proposer": self.proposer.hex(),
            "last_commit": [v.to_wire() for v in self.last_commit],
            "prev_app_hash": self.prev_app_hash.hex(),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "BlockPayload":
        height = int(d["height"])
        time_ns = int(d["time_ns"])
        square_size = int(d["square_size"])
        if height <= 0 or time_ns < 0 or square_size < 0:
            # negative ints would spin _varint forever in block_id_of
            raise ValueError("payload fields out of range")
        return cls(
            height=height,
            time_ns=time_ns,
            square_size=square_size,
            data_root=bytes.fromhex(d["data_root"]),
            txs=tuple(bytes.fromhex(t) for t in d["txs"]),
            proposer=bytes.fromhex(d.get("proposer", "")),
            last_commit=tuple(
                Vote.from_wire(v) for v in d.get("last_commit", [])
            ),
            prev_app_hash=bytes.fromhex(d.get("prev_app_hash", "")),
        )


@dataclass(frozen=True)
class Proposal:
    height: int
    round: int
    pol_round: int  # proof-of-lock round; -1 = fresh proposal
    payload: BlockPayload
    proposer: bytes  # validator operator address
    signature: bytes = b""

    def to_wire(self) -> dict:
        return {
            "kind": "proposal",
            "height": self.height,
            "round": self.round,
            "pol_round": self.pol_round,
            "payload": self.payload.to_wire(),
            "proposer": self.proposer.hex(),
            "signature": self.signature.hex(),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Proposal":
        height = int(d["height"])
        round_ = int(d["round"])
        pol_round = int(d["pol_round"])
        if height <= 0 or round_ < 0 or pol_round < -1:
            raise ValueError("proposal fields out of range")
        return cls(
            height=height,
            round=round_,
            pol_round=pol_round,
            payload=BlockPayload.from_wire(d["payload"]),
            proposer=bytes.fromhex(d["proposer"]),
            signature=bytes.fromhex(d["signature"]),
        )


def msg_from_wire(d: dict):
    return Proposal.from_wire(d) if d["kind"] == "proposal" else Vote.from_wire(d)


# heights past the engine's whose messages it holds, and how many it holds
AHEAD = 2
AHEAD_HELD = 1024


class ProposeFailed(RuntimeError):
    """This validator could not build its proposal (its App's
    PrepareProposal raised: a CUDA launch or synchronise error among the
    causes): the node's own failure, which ends it."""


class MalformedWire(ValueError):
    """A decided-block wire that does not parse: the fault of the peer
    that served it (node/gossip.py opens that peer's breaker)."""


@dataclass
class DecidedBlock:
    payload: BlockPayload
    round: int
    # the precommits that justify the decision (>= 2/3 power): the commit
    # certificate a late joiner can verify, and LastCommitInfo's source
    precommits: List[Vote] = field(default_factory=list)


# Ceiling on how far ahead of the validator's own clock a proposed block
# timestamp may sit.  Tendermint derives BFT-time from commit votes; here
# the proposer names the time and every replica enforces the same two
# rules (strict monotonicity + bounded drift), which keeps _now_ns, block
# headers and time-based mint inflation out of a Byzantine proposer's
# control (reference: celestia-core header validation / BFT-time).
DEFAULT_MAX_TIME_DRIFT_NS = 60_000_000_000  # 60 s


def validate_payload_against_chain(
    engine: "BFTNode",
    payload: BlockPayload,
    prev_block_id: Optional[bytes],
    first_bft_height: int = 2,
    expected_prev_app_hash: Optional[bytes] = None,
    prev_time_ns: Optional[int] = None,
    now_ns: Optional[int] = None,
    max_drift_ns: int = DEFAULT_MAX_TIME_DRIFT_NS,
) -> Tuple[bool, str]:
    """Shared certificate-validation glue for every transport tier.

    - At the first BFT height there is no previous certificate, so the
      payload's last_commit must be EMPTY — a proposer cannot smuggle
      fabricated (unverified) votes into LastCommitInfo.
    - Past it, the previous block id must be known and the certificate
      must verify at >= 2/3 power (verify_commit_certificate).
    - When the validator knows its own committed app hash for height-1,
      the payload's prev_app_hash must equal it — this is what turns a
      commit certificate into a light-client-verifiable state-root proof
      (Tendermint header.AppHash semantics).
    - When the caller supplies prev_time_ns (its last committed block
      time), the payload's time must be strictly after it; when it
      supplies now_ns (its own clock), the payload's time must be within
      max_drift_ns of it.  Every tier inherits the timestamp rules by
      validating through this one path.
    """
    if prev_time_ns is not None and payload.time_ns <= prev_time_ns:
        return False, "proposal time is not after the previous block"
    if now_ns is not None and payload.time_ns > now_ns + max_drift_ns:
        return False, "proposal time is beyond the allowed clock drift"
    if expected_prev_app_hash is not None and payload.prev_app_hash != (
        expected_prev_app_hash
    ):
        return False, "prev_app_hash does not match the committed state"
    if payload.height <= first_bft_height:
        if payload.last_commit:
            return False, "first BFT height must carry an empty last_commit"
        return True, ""
    if prev_block_id is None:
        return False, "unknown previous block"
    return engine.verify_commit_certificate(
        payload, prev_block_id, payload.height - 1
    )


def verify_commit_certificate(
    chain_id: str,
    validators: Dict[bytes, int],
    pubkeys: Dict[bytes, bytes],
    total_power: int,
    payload: "BlockPayload",
    precommits: List["Vote"],
) -> Tuple[bool, str]:
    """Standalone 2/3 commit-certificate check over one block id: the
    verification core of adopt_decision, callable WITHOUT an engine and
    with no side effects — state-sync verifies a snapshot's anchoring
    certificate with this before swapping any state in."""
    h = payload.height
    bid = payload.block_id
    rounds = {v.round for v in precommits}
    if len(rounds) != 1:
        return False, "certificate mixes rounds"
    seen: Set[bytes] = set()
    power = 0
    for v in precommits:
        if v.round < 0:
            return False, "negative round in certificate"
        if v.vtype != PRECOMMIT or v.height != h or v.block_id != bid:
            return False, "certificate vote does not match the block"
        if v.validator in seen:
            return False, "duplicate validator in certificate"
        seen.add(v.validator)
        vp = validators.get(v.validator)
        pk_raw = pubkeys.get(v.validator)
        if not vp or pk_raw is None:
            return False, "unknown validator in certificate"
        digest = vote_sign_bytes(chain_id, v.height, v.round, v.vtype, v.block_id)
        if not PublicKey.from_compressed(pk_raw).verify(digest, v.signature):
            return False, "certificate signature invalid"
        power += vp
    if power * 3 < total_power * 2:
        return False, "certificate below 2/3 power"
    return True, ""


def last_commit_vote_pairs(
    validators: Dict[bytes, int], payload: BlockPayload
) -> List[Tuple[bytes, bool]]:
    """LastCommitInfo derivation shared by every tier: (address, signed)
    over the SORTED valset, driven only by the payload's certificate —
    identical on every replica by construction."""
    if payload.last_commit:
        signers = payload.commit_signers()
        return [(addr, addr in signers) for addr in sorted(validators)]
    return [(addr, True) for addr in sorted(validators)]


class BFTNode:
    """One validator's consensus state machine.

    Inputs: ``receive(msg)`` (from the transport), ``on_timeout_*``
    (from the transport's timers), ``start_height()``.
    Outputs: ``outbox`` (messages to gossip — the transport drains it),
    ``decided`` (height -> DecidedBlock), ``on_decide`` callback.
    The engine never calls the network and never sleeps.
    """

    def __init__(
        self,
        chain_id: str,
        key: PrivateKey,
        validators: Dict[bytes, int],  # operator address -> power
        validate_fn: Callable[[BlockPayload], Tuple[bool, str]],
        propose_fn: Callable[[int, int], Optional[BlockPayload]],
        on_decide: Optional[Callable[[DecidedBlock], None]] = None,
        on_equivocation: Optional[Callable[[Vote, Vote], None]] = None,
        pubkeys: Optional[Dict[bytes, bytes]] = None,
    ):
        """validate_fn runs ProcessProposal on the validator's own app;
        propose_fn(height, round) builds a fresh payload from its own
        mempool (returns None if this validator cannot propose — e.g.
        crashed app — which forfeits the round).
        pubkeys: operator address -> 33-byte compressed secp256k1 key;
        defaults to addresses derived from nothing — supply it unless all
        peers share this process (then keys are registered via
        register_pubkey)."""
        self.chain_id = chain_id
        self.key = key
        self.address = key.public_key().address()
        self.validators = dict(validators)
        self.total_power = sum(validators.values())
        self.pubkeys: Dict[bytes, bytes] = dict(pubkeys or {})
        self.pubkeys[self.address] = key.public_key().compressed()
        self.validate_fn = validate_fn
        self.propose_fn = propose_fn
        self.on_decide = on_decide
        self.on_equivocation = on_equivocation

        self.height = 0
        self.round = 0
        self.step = STEP_PROPOSE
        self.locked_payload: Optional[BlockPayload] = None
        self.locked_round = -1
        self.valid_payload: Optional[BlockPayload] = None
        self.valid_round = -1

        # (height, round) -> proposal received; block_id -> payload
        self._proposals: Dict[Tuple[int, int], Proposal] = {}
        self._payloads: Dict[bytes, BlockPayload] = {}
        # votes[(height, round, vtype)][validator] = Vote
        self._votes: Dict[Tuple[int, int, str], Dict[bytes, Vote]] = {}
        # validation cache: block_id -> (ok, reason)
        self._valid_cache: Dict[bytes, Tuple[bool, str]] = {}
        # once-only triggers per (height, round): polka lock, timeouts
        self._fired: Set[Tuple] = set()

        self.decided: Dict[int, DecidedBlock] = {}
        # messages of the next AHEAD heights, held until start_height
        # reaches theirs (bounded: oldest dropped first)
        self._ahead: deque = deque(maxlen=AHEAD_HELD)
        self.outbox: List[dict] = []
        # timeout requests for the transport: (step, height, round)
        self.timeout_requests: List[Tuple[str, int, int]] = []

    # -- identity helpers ------------------------------------------------

    def register_pubkey(self, address: bytes, compressed: bytes) -> None:
        self.pubkeys[address] = compressed

    def proposer_for(self, height: int, round_: int) -> bytes:
        """Deterministic rotation over the sorted validator set — every
        correct node computes the same proposer for (height, round)."""
        order = sorted(self.validators)
        return order[(height + round_) % len(order)]

    # -- lifecycle -------------------------------------------------------

    def start_height(self, height: int) -> None:
        if height <= self.height:
            return
        self.height = height
        self.locked_payload = None
        self.locked_round = -1
        self.valid_payload = None
        self.valid_round = -1
        self._prune_below(height)
        self._start_round(0)
        held = list(self._ahead)
        self._ahead.clear()
        self._ahead.extend(m for m in held if m.height > height)
        for m in held:
            if m.height == height:
                self.receive(m)

    def _prune_below(self, height: int) -> None:
        """Drop per-height consensus state no longer reachable: a
        run-forever validator must not grow with chain length.  The
        previous height's decision is kept (its certificate becomes the
        next proposal's last_commit); older decisions are dropped."""
        self._proposals = {
            k: v for k, v in self._proposals.items() if k[0] >= height
        }
        live_payloads = {
            d.payload.block_id for d in self.decided.values()
        } | {p.payload.block_id for p in self._proposals.values()}
        self._votes = {
            k: v for k, v in self._votes.items() if k[0] >= height
        }
        self._fired = {k for k in self._fired if k[1] >= height}
        # keep a window of recent decisions: height-1 feeds the next
        # proposal's last_commit, the rest serve laggard catch-up
        for h in [h for h in self.decided if h < height - 8]:
            live_payloads.discard(self.decided[h].payload.block_id)
            del self.decided[h]
        self._payloads = {
            bid: p
            for bid, p in self._payloads.items()
            if bid in live_payloads or p.height >= height
        }
        self._valid_cache = {
            bid: v
            for bid, v in self._valid_cache.items()
            if bid in self._payloads
        }

    def adopt_decision(
        self, payload: BlockPayload, precommits: List[Vote]
    ) -> Tuple[bool, str]:
        """Catch-up: accept an externally-replayed decided block IF its
        commit certificate proves it — >= 2/3 power of valid precommit
        signatures over this exact block id, all from one round.  The
        replayer (relay or peer) is untrusted; the signatures are the
        authority.  On success the engine records the decision and fires
        on_decide (the app finalizes), exactly as if it had assembled
        the quorum itself."""
        h = payload.height
        if h in self.decided:
            return True, "already decided"
        ok, why = verify_commit_certificate(
            self.chain_id, self.validators, self.pubkeys,
            self.total_power, payload, precommits,
        )
        if not ok:
            return False, why
        self.height = max(self.height, h)
        self._payloads[payload.block_id] = payload
        # the helper guaranteed a non-empty single-round certificate
        decided = DecidedBlock(payload, precommits[0].round, list(precommits))
        self.decided[h] = decided
        if self.on_decide:
            self.on_decide(decided)
        return True, ""

    # (verify_commit_certificate lives at module level so state-sync can
    # verify a snapshot's anchoring certificate BEFORE any state swap)

    def _start_round(self, round_: int) -> None:
        if self.height in self.decided:
            return  # decided: the machine halts until start_height
        self.round = round_
        self.step = STEP_PROPOSE
        if self.proposer_for(self.height, round_) == self.address:
            payload = (
                self.valid_payload
                if self.valid_payload is not None
                else self.propose_fn(self.height, round_)
            )
            if payload is not None:
                prop = Proposal(
                    height=self.height,
                    round=round_,
                    pol_round=self.valid_round,
                    payload=payload,
                    proposer=self.address,
                    signature=self.key.sign(
                        proposal_sign_bytes(
                            self.chain_id, self.height, round_,
                            self.valid_round, payload.block_id,
                        )
                    ),
                )
                self._broadcast(prop.to_wire())
                self.receive(prop)  # deliver to self
                return
        # non-proposer (or a proposer with nothing to propose) arms the
        # propose timeout: no (valid) proposal in time -> prevote nil
        self.timeout_requests.append((STEP_PROPOSE, self.height, round_))

    # -- inbound ---------------------------------------------------------

    def receive(self, msg) -> None:
        """Handle a proposal or vote.  One for a height up to ``AHEAD``
        past the engine's is held and handled when ``start_height``
        reaches it (departure from the reference, which drops it: a
        transport that delivers each message once, as the gossip mesh's
        dedup does, would never deliver it again, and a validator a height
        behind its peers would wait for their votes for good)."""
        if isinstance(msg, dict):
            msg = msg_from_wire(msg)
        if self.height < msg.height <= self.height + AHEAD:
            self._ahead.append(msg)
            return
        if isinstance(msg, Proposal):
            self._on_proposal(msg)
        elif isinstance(msg, Vote):
            self._on_vote(msg)

    def _on_proposal(self, prop: Proposal) -> None:
        if prop.height != self.height:
            return
        if prop.proposer != self.proposer_for(prop.height, prop.round):
            return  # not this round's proposer: ignore
        pk_raw = self.pubkeys.get(prop.proposer)
        if pk_raw is None:
            return
        digest = proposal_sign_bytes(
            self.chain_id, prop.height, prop.round, prop.pol_round,
            prop.payload.block_id,
        )
        if not PublicKey.from_compressed(pk_raw).verify(digest, prop.signature):
            return
        if prop.payload.height != prop.height:
            return
        # a FRESH proposal's payload must name its builder as proposer —
        # rewards follow payload.proposer, so letting it point elsewhere
        # would let a proposer redirect or forfeit another's rewards.  A
        # re-proposal (pol_round >= 0) legitimately keeps the ORIGINAL
        # builder's name; its payload is pinned by the polka's block id.
        if prop.pol_round == -1 and prop.payload.proposer != prop.proposer:
            return
        if prop.payload.proposer not in self.validators:
            return
        key = (prop.height, prop.round)
        if key in self._proposals:
            return  # first proposal per round wins; a second is ignored
        self._proposals[key] = prop
        self._payloads[prop.payload.block_id] = prop.payload
        self._try_transitions(prop.round)

    def _on_vote(self, vote: Vote) -> None:
        if vote.height != self.height:
            # precommits for an already-decided height still matter to
            # laggards; the transport replays decided blocks instead
            return
        if vote.vtype not in (PREVOTE, PRECOMMIT):
            return
        power = self.validators.get(vote.validator)
        if not power:
            return  # not a validator: no voting power
        pk_raw = self.pubkeys.get(vote.validator)
        if pk_raw is None:
            return
        digest = vote_sign_bytes(
            self.chain_id, vote.height, vote.round, vote.vtype, vote.block_id
        )
        if not PublicKey.from_compressed(pk_raw).verify(digest, vote.signature):
            return  # forged or tampered vote
        slot = self._votes.setdefault(
            (vote.height, vote.round, vote.vtype), {}
        )
        prev = slot.get(vote.validator)
        if prev is not None:
            if prev.block_id != vote.block_id and self.on_equivocation:
                self.on_equivocation(prev, vote)
            return  # first vote per (h, r, type) counts
        slot[vote.validator] = vote
        self._try_transitions(vote.round)

    # -- timeouts (fired by the transport's timers) ----------------------

    def on_timeout_propose(self, height: int, round_: int) -> None:
        if (height, round_) == (self.height, self.round) and self.step == STEP_PROPOSE:
            self._cast_vote(PREVOTE, NIL)
            self.step = STEP_PREVOTE
            self._try_transitions(round_)

    def on_timeout_prevote(self, height: int, round_: int) -> None:
        if (height, round_) == (self.height, self.round) and self.step == STEP_PREVOTE:
            self._cast_vote(PRECOMMIT, NIL)
            self.step = STEP_PRECOMMIT
            self._try_transitions(round_)

    def on_timeout_precommit(self, height: int, round_: int) -> None:
        if (
            height == self.height
            and round_ == self.round
            and height not in self.decided
        ):
            self._start_round(round_ + 1)

    # -- internals -------------------------------------------------------

    def _broadcast(self, wire: dict) -> None:
        self.outbox.append(wire)

    def _cast_vote(self, vtype: str, block_id: bytes) -> None:
        vote = Vote(
            vtype=vtype,
            height=self.height,
            round=self.round,
            block_id=block_id,
            validator=self.address,
            signature=self.key.sign(
                vote_sign_bytes(
                    self.chain_id, self.height, self.round, vtype, block_id
                )
            ),
        )
        self._broadcast(vote.to_wire())
        self._on_vote(vote)  # count own vote

    def _validate(self, payload: BlockPayload) -> bool:
        bid = payload.block_id
        if bid not in self._valid_cache:
            try:
                self._valid_cache[bid] = self.validate_fn(payload)
            except Exception as e:  # validation panic = invalid
                self._valid_cache[bid] = (False, f"validation panic: {e}")
        return self._valid_cache[bid][0]

    def _power_for(
        self, round_: int, vtype: str, block_id: Optional[bytes]
    ) -> int:
        """Voting power at (height, round, vtype); block_id None = any."""
        slot = self._votes.get((self.height, round_, vtype), {})
        return sum(
            self.validators[v.validator]
            for v in slot.values()
            if block_id is None or v.block_id == block_id
        )

    def _quorum(self, power: int) -> bool:
        return power * 3 >= self.total_power * 2

    def _polka_block(self, round_: int) -> Optional[bytes]:
        """The non-nil block id with a 2/3 prevote quorum at round_, if any."""
        slot = self._votes.get((self.height, round_, PREVOTE), {})
        by_block: Dict[bytes, int] = {}
        for v in slot.values():
            by_block[v.block_id] = (
                by_block.get(v.block_id, 0) + self.validators[v.validator]
            )
        for bid, power in by_block.items():
            if bid != NIL and self._quorum(power):
                return bid
        return None

    def verify_commit_certificate(
        self, payload: BlockPayload, prev_block_id: bytes, prev_height: int
    ) -> Tuple[bool, str]:
        """Check a payload's last_commit: every vote must be a valid
        precommit signature by a known validator over prev_block_id, one
        per validator, totalling >= 2/3 power, all from ONE round — a
        commit is the set of precommits that co-existed in the round that
        decided, so mixing genuine votes from different rounds would
        fabricate a certificate that never existed (same rule as
        adopt_decision and LightClient.update).  Used by harness
        validate_fns so a proposer cannot forge reward/slash inputs."""
        if len({v.round for v in payload.last_commit}) > 1:
            return False, "commit certificate mixes rounds"
        if any(v.round < 0 for v in payload.last_commit):
            return False, "negative round in commit certificate"
        seen: Set[bytes] = set()
        power = 0
        for v in payload.last_commit:
            if v.validator in seen:
                return False, "duplicate validator in commit certificate"
            seen.add(v.validator)
            vp = self.validators.get(v.validator)
            pk_raw = self.pubkeys.get(v.validator)
            if not vp or pk_raw is None:
                return False, "unknown validator in commit certificate"
            if v.vtype != PRECOMMIT or v.height != prev_height:
                return False, "certificate vote is not a precommit for h-1"
            if v.block_id != prev_block_id:
                return False, "certificate vote is for a different block"
            digest = vote_sign_bytes(
                self.chain_id, v.height, v.round, v.vtype, v.block_id
            )
            if not PublicKey.from_compressed(pk_raw).verify(
                digest, v.signature
            ):
                return False, "certificate signature invalid"
            power += vp
        if not self._quorum(power):
            return False, "commit certificate below 2/3 power"
        return True, ""

    def _round_skip_check(self) -> None:
        """Liveness: > 1/3 power sending votes at a round AHEAD of ours
        proves the network moved on (at least one correct validator is
        there) — jump to that round instead of waiting out our timeouts."""
        by_round: Dict[int, Set[bytes]] = {}
        for (vh, vr, _), slot in self._votes.items():
            if vh == self.height and vr > self.round:
                by_round.setdefault(vr, set()).update(slot.keys())
        for vr in sorted(by_round):
            power = sum(self.validators[a] for a in by_round[vr])
            if power * 3 > self.total_power:
                self._start_round(vr)
                return

    def _try_transitions(self, round_: int) -> None:
        """Run every Tendermint 'upon' rule that newly applies."""
        h = self.height
        if h in self.decided:
            return  # decided: only start_height re-activates the machine
        self._round_skip_check()

        # -- upon Proposal at (h, current round) while step == propose
        prop = self._proposals.get((h, self.round))
        if prop is not None and self.step == STEP_PROPOSE:
            payload = prop.payload
            if prop.pol_round == -1:
                ok = self._validate(payload) and (
                    self.locked_round == -1
                    or self.locked_payload.block_id == payload.block_id
                )
                self._cast_vote(PREVOTE, payload.block_id if ok else NIL)
                self.step = STEP_PREVOTE
            elif 0 <= prop.pol_round < self.round:
                # re-proposal with a proof-of-lock: needs the polka at
                # pol_round before we can judge it
                if self._polka_block(prop.pol_round) == payload.block_id:
                    ok = self._validate(payload) and (
                        self.locked_round <= prop.pol_round
                        or self.locked_payload.block_id == payload.block_id
                    )
                    self._cast_vote(PREVOTE, payload.block_id if ok else NIL)
                    self.step = STEP_PREVOTE

        # -- upon 2/3 ANY prevotes at (h, current round) while prevoting:
        # arm the prevote timeout (votes are split; give the polka a
        # moment to form before precommitting nil)
        if self.step == STEP_PREVOTE and self._quorum(
            self._power_for(self.round, PREVOTE, None)
        ):
            fkey = ("timeout-prevote", h, self.round)
            if fkey not in self._fired:
                self._fired.add(fkey)
                self.timeout_requests.append((STEP_PREVOTE, h, self.round))

        # -- upon polka for a block at (h, current round) while step >=
        # prevote, first time: lock + precommit (if prevoting), mark valid
        polka = self._polka_block(self.round)
        if polka is not None and polka in self._payloads:
            payload = self._payloads[polka]
            if self._validate(payload):
                fkey = ("polka", h, self.round, polka)
                if fkey not in self._fired and self.step != STEP_PROPOSE:
                    self._fired.add(fkey)
                    if self.step == STEP_PREVOTE:
                        self.locked_payload = payload
                        self.locked_round = self.round
                        self._cast_vote(PRECOMMIT, polka)
                        self.step = STEP_PRECOMMIT
                    self.valid_payload = payload
                    self.valid_round = self.round

        # -- upon 2/3 prevotes NIL at (h, current round) while prevoting:
        # precommit nil
        if self.step == STEP_PREVOTE and self._quorum(
            self._power_for(self.round, PREVOTE, NIL)
        ):
            self._cast_vote(PRECOMMIT, NIL)
            self.step = STEP_PRECOMMIT

        # -- upon 2/3 ANY precommits at (h, current round): arm precommit
        # timeout (round change if no decision lands)
        if self._quorum(self._power_for(self.round, PRECOMMIT, None)):
            fkey = ("timeout-precommit", h, self.round)
            if fkey not in self._fired:
                self._fired.add(fkey)
                self.timeout_requests.append((STEP_PRECOMMIT, h, self.round))

        # -- upon 2/3 precommits for a block at (h, ANY round): decide
        for (vh, vr, vtype), slot in list(self._votes.items()):
            if vh != h or vtype != PRECOMMIT:
                continue
            by_block: Dict[bytes, int] = {}
            for v in slot.values():
                if v.block_id != NIL:
                    by_block[v.block_id] = (
                        by_block.get(v.block_id, 0)
                        + self.validators[v.validator]
                    )
            for bid, power in by_block.items():
                if not self._quorum(power):
                    continue
                payload = self._payloads.get(bid)
                if payload is None:
                    continue  # commit certificate seen, payload not yet
                if h not in self.decided and self._validate(payload):
                    cert = [
                        v for v in slot.values() if v.block_id == bid
                    ]
                    decided = DecidedBlock(payload, vr, cert)
                    self.decided[h] = decided
                    if self.on_decide:
                        self.on_decide(decided)
                return
