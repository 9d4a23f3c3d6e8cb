"""x/gov: proposal submission, power-weighted voting, tally, execution.

The reference routes parameter changes through the SDK gov module whose
proposal handler is wrapped by x/paramfilter's blocklist
(x/paramfilter/gov_handler.go:36-60: a ParamChangeProposal touching any
hardfork-only param fails WITHOUT partial application).  This module
implements that flow natively: MsgSubmitProposal (deposit + param changes)
-> voting window measured in blocks -> EndBlocker tally against bonded
power (quorum 1/3, threshold 1/2, veto 1/3 of non-abstain) -> gated
execution applying all changes atomically.

Gov params live in the params store (VotingPeriodBlocks, MinDeposit,
QuorumPpm, ThresholdPpm, VetoPpm) — themselves gov-changeable, except where
the blocklist says otherwise.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.state.tx import MsgSubmitProposal, MsgVote

PROPOSAL_STATUS_VOTING = 1
PROPOSAL_STATUS_PASSED = 2
PROPOSAL_STATUS_REJECTED = 3
PROPOSAL_STATUS_FAILED = 4  # passed the vote but execution was refused

DEFAULT_VOTING_PERIOD_BLOCKS = 10
DEFAULT_MIN_DEPOSIT = 1_000_000  # 1 TIA in utia
DEFAULT_QUORUM_PPM = 334_000  # 33.4%
DEFAULT_THRESHOLD_PPM = 500_000  # 50%
DEFAULT_VETO_PPM = 334_000  # 33.4%

_PROPOSAL_PREFIX = b"proposal/"
_VOTE_PREFIX = b"vote/"
_NEXT_ID_KEY = b"next_proposal_id"

# The gov module account: escrows deposits AND is the only authority allowed
# to execute MsgParamChange.  It is a module address with no private key, so
# no user transaction can ever carry a valid signature for it — param writes
# happen exclusively through a passed proposal's execution.
GOV_MODULE_ADDR = b"gov-escrow-pool-addr"
assert len(GOV_MODULE_ADDR) == 20


@dataclass
class Proposal:
    id: int
    proposer: bytes
    title: str
    description: str
    changes: Tuple[Tuple[str, str, bytes], ...]
    deposit: int
    submit_height: int
    voting_end_height: int
    status: int = PROPOSAL_STATUS_VOTING
    result_log: str = ""
    # community-pool spend content (distribution CommunityPoolSpendProposal)
    spend_to: bytes = b""
    spend_amount: int = 0

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "id": self.id,
                "proposer": self.proposer.hex(),
                "title": self.title,
                "description": self.description,
                "changes": [
                    [s, k, v.hex()] for s, k, v in self.changes
                ],
                "deposit": self.deposit,
                "submit_height": self.submit_height,
                "voting_end_height": self.voting_end_height,
                "status": self.status,
                "result_log": self.result_log,
                "spend_to": self.spend_to.hex(),
                "spend_amount": self.spend_amount,
            }
        ).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Proposal":
        d = json.loads(raw)
        return cls(
            id=d["id"],
            proposer=bytes.fromhex(d["proposer"]),
            title=d["title"],
            description=d["description"],
            changes=tuple(
                (s, k, bytes.fromhex(v)) for s, k, v in d["changes"]
            ),
            deposit=d["deposit"],
            submit_height=d["submit_height"],
            voting_end_height=d["voting_end_height"],
            status=d["status"],
            result_log=d.get("result_log", ""),
            spend_to=bytes.fromhex(d.get("spend_to", "")),
            spend_amount=d.get("spend_amount", 0),
        )


class GovKeeper:
    """Proposal lifecycle over the gov KV store."""

    def __init__(self, store, bank, staking, params, param_block_list):
        self.store = store
        self.bank = bank
        self.staking = staking
        self.params = params
        self.block_list = param_block_list

    # -- config --------------------------------------------------------

    def voting_period(self) -> int:
        return int(
            self.params.get(
                "gov", "VotingPeriodBlocks", DEFAULT_VOTING_PERIOD_BLOCKS
            )
        )

    def min_deposit(self) -> int:
        return int(self.params.get("gov", "MinDeposit", DEFAULT_MIN_DEPOSIT))

    # -- submission / voting -------------------------------------------

    def submit_proposal(self, msg: MsgSubmitProposal, height: int) -> int:
        spend_amount = getattr(msg, "spend_amount", 0)
        if not msg.changes and not spend_amount:
            raise ValueError("proposal carries no content")
        if spend_amount and len(getattr(msg, "spend_to", b"")) != 20:
            raise ValueError("community-pool spend needs a 20-byte recipient")
        if msg.deposit < self.min_deposit():
            raise ValueError(
                f"deposit {msg.deposit} below minimum {self.min_deposit()}"
            )
        # early blocklist check: a proposal that can never execute is
        # rejected at submission, mirroring the handler-gate intent
        for subspace, key, _ in msg.changes:
            self.block_list.validate_change(subspace, key)
        # deposit escrows into the gov pool (burned on veto, else refunded)
        self.bank.send(msg.proposer, GOV_MODULE_ADDR, msg.deposit)
        pid = self._next_id()
        prop = Proposal(
            id=pid,
            proposer=msg.proposer,
            title=msg.title,
            description=msg.description,
            changes=msg.changes,
            deposit=msg.deposit,
            submit_height=height,
            voting_end_height=height + self.voting_period(),
            spend_to=getattr(msg, "spend_to", b""),
            spend_amount=spend_amount,
        )
        self._put(prop)
        return pid

    def vote(self, msg: MsgVote, height: int) -> None:
        prop = self.proposal(msg.proposal_id)
        if prop is None:
            raise ValueError(f"no proposal {msg.proposal_id}")
        if prop.status != PROPOSAL_STATUS_VOTING:
            raise ValueError(f"proposal {prop.id} is not in voting")
        if height > prop.voting_end_height:
            raise ValueError(f"voting on proposal {prop.id} has ended")
        if msg.option not in (1, 2, 3, 4):
            raise ValueError(f"invalid vote option {msg.option}")
        power = self.staking.powers_snapshot().get(msg.voter, 0)
        if power <= 0:
            raise ValueError("only bonded validators vote in this gov model")
        self.store.set(
            _VOTE_PREFIX + msg.proposal_id.to_bytes(8, "big") + msg.voter,
            bytes([msg.option]),
        )

    # -- tally / execution ---------------------------------------------

    def end_blocker(self, height: int, app) -> List[dict]:
        """Tally every proposal whose voting window closed this block."""
        events = []
        for prop in self.proposals():
            if prop.status != PROPOSAL_STATUS_VOTING:
                continue
            if height < prop.voting_end_height:
                continue
            events.append(self._tally_and_execute(prop, app))
        return events

    def _tally_and_execute(self, prop: Proposal, app) -> dict:
        powers = self.staking.powers_snapshot()
        total_power = sum(powers.values())
        yes = no = abstain = veto = 0
        prefix = _VOTE_PREFIX + prop.id.to_bytes(8, "big")
        for key, val in self.store.iterate(prefix):
            voter = key[len(prefix):]
            power = powers.get(voter, 0)
            opt = val[0]
            if opt == MsgVote.OPTION_YES:
                yes += power
            elif opt == MsgVote.OPTION_NO:
                no += power
            elif opt == MsgVote.OPTION_ABSTAIN:
                abstain += power
            elif opt == MsgVote.OPTION_VETO:
                veto += power
        turnout = yes + no + abstain + veto
        non_abstain = yes + no + veto
        quorum_ppm = int(self.params.get("gov", "QuorumPpm", DEFAULT_QUORUM_PPM))
        threshold_ppm = int(
            self.params.get("gov", "ThresholdPpm", DEFAULT_THRESHOLD_PPM)
        )
        veto_ppm = int(self.params.get("gov", "VetoPpm", DEFAULT_VETO_PPM))
        burn_deposit = False
        if total_power == 0 or turnout * 1_000_000 < total_power * quorum_ppm:
            prop.status = PROPOSAL_STATUS_REJECTED
            prop.result_log = "quorum not reached"
        elif non_abstain > 0 and veto * 1_000_000 > non_abstain * veto_ppm:
            prop.status = PROPOSAL_STATUS_REJECTED
            prop.result_log = "vetoed"
            burn_deposit = True
        elif non_abstain > 0 and yes * 1_000_000 > non_abstain * threshold_ppm:
            # execute through the blocklist-gated handler: all-or-nothing
            try:
                self._execute(prop, app)
                prop.status = PROPOSAL_STATUS_PASSED
                prop.result_log = "executed"
            except ValueError as e:
                prop.status = PROPOSAL_STATUS_FAILED
                prop.result_log = f"execution refused: {e}"
        else:
            prop.status = PROPOSAL_STATUS_REJECTED
            prop.result_log = "threshold not reached"
        if burn_deposit:
            self.bank.burn(GOV_MODULE_ADDR, prop.deposit)
        else:
            self.bank.send(GOV_MODULE_ADDR, prop.proposer, prop.deposit)
        self._put(prop)
        return {
            "type": "proposal_tally",
            "proposal_id": prop.id,
            "status": prop.status,
            "log": prop.result_log,
            "yes": yes,
            "no": no,
            "abstain": abstain,
            "veto": veto,
        }

    def _execute(self, prop: Proposal, app) -> None:
        """GovHandler parity (gov_handler.go:36-60): validate EVERY change
        against the blocklist before applying ANY; a community-pool spend
        that cannot be covered refuses the whole proposal."""
        for subspace, key, _ in prop.changes:
            self.block_list.validate_change(subspace, key)
        if prop.spend_amount:
            pool = app.distribution.community_pool()
            if prop.spend_amount > pool:
                raise ValueError(
                    f"community pool {pool}utia cannot cover spend "
                    f"{prop.spend_amount}utia"
                )
        for subspace, key, value in prop.changes:
            app.params.set(subspace, key, json.loads(value))
        if prop.spend_amount:
            app.distribution.spend_community_pool(
                prop.spend_to, prop.spend_amount
            )

    # -- storage -------------------------------------------------------

    def _next_id(self) -> int:
        raw = self.store.get(_NEXT_ID_KEY)
        nid = int.from_bytes(raw, "big") if raw else 1
        self.store.set(_NEXT_ID_KEY, (nid + 1).to_bytes(8, "big"))
        return nid

    def _put(self, prop: Proposal) -> None:
        self.store.set(
            _PROPOSAL_PREFIX + prop.id.to_bytes(8, "big"), prop.to_json()
        )

    def proposal(self, pid: int) -> Optional[Proposal]:
        raw = self.store.get(_PROPOSAL_PREFIX + pid.to_bytes(8, "big"))
        return Proposal.from_json(raw) if raw else None

    def proposals(self) -> List[Proposal]:
        return [
            Proposal.from_json(v)
            for _, v in self.store.iterate(_PROPOSAL_PREFIX)
        ]
