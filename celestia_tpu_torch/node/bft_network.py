"""In-process N-validator network driven by the two-phase BFT engine.

Each validator runs its OWN BFTNode state machine over its OWN App; the
harness is a dumb message transport with controllable faults — it
shuttles outbox messages between nodes (honoring partitions and drop
rules), fires timeouts only when the network is quiescent, and NEVER
counts votes or sequences commits itself.  Every validator decides from
the votes it verified; the harness merely checks afterwards that the
decisions and app hashes agree (a divergence raises ConsensusFailure —
that's an assertion about the protocol, not part of it).

Deterministic timeout model: real transports fire timeouts when wall
clocks lapse; here a timeout becomes DUE when the message queue drains
without a decision — same observable semantics (timeouts only matter
when progress stalls), fully reproducible.

Relation to the chaos harness (specs/robustness.md): this harness
injects faults at the TRANSPORT level (partitions, drop rules, crashed
validators) with determinism coming from the quiescence-driven pump; the
utils/faults.py registry injects at the SUBSYSTEM level (native codec,
hostpool, state-sync chunks, serving plane) with determinism coming from
seeded schedules.  The two compose: a BFTNetwork scenario can run with
fault points armed, and neither layer sleeps or draws ambient entropy.

Reference role: celestia-core consensus + p2p gossip driving N nodes
(SURVEY §2.2/§2.3); replaces the central sequencing of
node/network.py's legacy driver.

Re-homed from ``celestia_tpu/node/bft_network.py``: ``BFTNetwork(device=
None)`` gives its device to every validator's App.  No device means the
card, and the constructor raises without one; ``device="cpu"`` runs the
host regime (da/dah.py).
"""

from __future__ import annotations

import hashlib
from collections import deque
from typing import Callable, Dict, List, Optional, Set, Tuple

from celestia_tpu_torch.appconsts import GOAL_BLOCK_TIME_SECONDS
from celestia_tpu_torch.node.bft import (
    NIL,
    STEP_PRECOMMIT,
    STEP_PREVOTE,
    STEP_PROPOSE,
    BFTNode,
    BlockPayload,
    DecidedBlock,
    Vote,
)
from celestia_tpu_torch.node.mempool import Mempool
from celestia_tpu_torch.node.network import ConsensusFailure
from celestia_tpu_torch.node.testnode import Block, BlockHeader
from celestia_tpu_torch.state.app import App
from celestia_tpu_torch.utils import tracing
from celestia_tpu_torch.utils.device import resolve_device
from celestia_tpu_torch.utils.secp256k1 import PrivateKey


class BFTValidator:
    """One validator: app state, mempool, key and its consensus engine."""

    def __init__(self, name: str, key: PrivateKey, power: int, app: App):
        self.name = name
        self.key = key
        self.power = power
        self.app = app
        self.mempool = Mempool(max_tx_bytes=64 * 1024 * 1024)
        self.engine: Optional[BFTNode] = None
        self.crashed = False  # a crashed validator neither sends nor acts
        self.finalized: Dict[int, bytes] = {}  # height -> app hash

    @property
    def address(self) -> bytes:
        return self.key.public_key().address()


class BFTNetwork:
    """Deterministic in-process transport + fault injection harness."""

    def __init__(
        self,
        n_validators: int = 4,
        chain_id: str = "celestia-tpu-bftnet",
        funded_accounts=None,
        powers: Optional[List[int]] = None,
        block_interval_ns: int = GOAL_BLOCK_TIME_SECONDS * 10**9,
        v2_upgrade_height: Optional[int] = None,
        device=None,
    ):
        """device: where every validator's App extends its squares (None:
        the card, raising when there is none; ``"cpu"``: the host
        regime)."""
        self.device = resolve_device(device)
        self.chain_id = chain_id
        self.block_interval_ns = block_interval_ns
        powers = powers or [100] * n_validators
        keys = [
            PrivateKey.from_seed(b"bftnet-val-%d" % i)
            for i in range(n_validators)
        ]
        genesis = {
            "chain_id": chain_id,
            "genesis_time_ns": 1_700_000_000_000_000_000,
            "accounts": [
                {
                    "address": k.public_key().address().hex(),
                    "balance": 1_000_000_000_000,
                }
                for k in keys
            ]
            + [
                {
                    "address": key.public_key().address().hex(),
                    "balance": balance,
                }
                for key, balance in (funded_accounts or [])
            ],
            "validators": [
                {
                    "address": k.public_key().address().hex(),
                    "self_delegation": p * 1_000_000,
                }
                for k, p in zip(keys, powers)
            ],
        }
        self.genesis = genesis
        self.validators: List[BFTValidator] = []
        valset = {
            k.public_key().address(): p for k, p in zip(keys, powers)
        }
        pubkeys = {
            k.public_key().address(): k.public_key().compressed()
            for k in keys
        }
        for i, (key, power) in enumerate(zip(keys, powers)):
            app = App(
                chain_id=chain_id,
                v2_upgrade_height=v2_upgrade_height,
                device=self.device,
            )
            app.init_chain(genesis)
            val = BFTValidator(f"val-{i}", key, power, app)
            val.engine = BFTNode(
                chain_id=chain_id,
                key=key,
                validators=valset,
                validate_fn=self._make_validate_fn(val),
                propose_fn=self._make_propose_fn(val),
                on_equivocation=self._record_equivocation,
                pubkeys=pubkeys,
            )
            self.validators.append(val)
        self.blocks: List[Block] = []
        self._tx_index: Dict[bytes, dict] = {}
        self._now_ns = genesis["genesis_time_ns"]
        self._block_ids: Dict[int, bytes] = {}  # height -> decided block id
        self.equivocations: List[Tuple[Vote, Vote]] = []
        # fault injection: (sender_name, receiver_name) pairs to drop;
        # None in either slot = wildcard
        self.drop_rules: Set[Tuple[Optional[str], Optional[str]]] = set()
        self._queue: deque = deque()  # (sender, wire_msg)

    # -- engine hooks ---------------------------------------------------

    def _make_validate_fn(self, val: BFTValidator):
        from celestia_tpu_torch.node.bft import validate_payload_against_chain

        def validate(payload: BlockPayload) -> Tuple[bool, str]:
            # 1. the commit certificate for height-1 must be genuine and
            # prev_app_hash must match our own committed state root
            try:
                expected = val.app.store.committed_hash(payload.height - 1)
            except KeyError:
                expected = None
            ok, why = validate_payload_against_chain(
                val.engine, payload, self._block_ids.get(payload.height - 1),
                expected_prev_app_hash=expected,
                prev_time_ns=self._now_ns,
                # the harness is clock-free: simulated chain time is the
                # validator's clock.  The bound is a small multiple of
                # the block interval so a Byzantine proposer cannot creep
                # chain time forward by a large drift allowance on every
                # block it proposes (honest proposals sit at exactly
                # prev + interval)
                now_ns=self._now_ns,
                max_drift_ns=2 * self.block_interval_ns,
            )
            if not ok:
                return False, f"bad commit certificate: {why}"
            # 2. full ProcessProposal re-validation on our own state
            return val.app.process_proposal(
                list(payload.txs), payload.square_size, payload.data_root
            )

        return validate

    def _make_propose_fn(self, val: BFTValidator):
        def propose(height: int, round_: int) -> Optional[BlockPayload]:
            if val.crashed:
                return None
            mem_txs = val.mempool.reap()
            try:
                proposal = val.app.prepare_proposal([t.raw for t in mem_txs])
            except Exception:
                return None  # broken proposer forfeits the round
            last_commit: Tuple[Vote, ...] = ()
            prev = val.engine.decided.get(height - 1)
            if prev is not None:
                last_commit = tuple(
                    sorted(prev.precommits, key=lambda v: v.validator)
                )
            try:
                prev_app_hash = val.app.store.committed_hash(height - 1)
            except KeyError:
                prev_app_hash = b""
            return BlockPayload(
                height=height,
                time_ns=self._now_ns + self.block_interval_ns,
                square_size=proposal.square_size,
                data_root=proposal.data_root,
                txs=tuple(proposal.block_txs),
                proposer=val.address,
                last_commit=last_commit,
                prev_app_hash=prev_app_hash,
            )

        return propose

    def _record_equivocation(self, a: Vote, b: Vote) -> None:
        self.equivocations.append((a, b))

    # -- transport ------------------------------------------------------

    def _dropped(self, sender: str, receiver: str) -> bool:
        for s, r in self.drop_rules:
            if (s is None or s == sender) and (r is None or r == receiver):
                return True
        return False

    def partition(self, group_a: List[str], group_b: List[str]) -> None:
        """Cut all links between the two groups (both directions)."""
        for a in group_a:
            for b in group_b:
                self.drop_rules.add((a, b))
                self.drop_rules.add((b, a))

    def heal(self) -> None:
        self.drop_rules.clear()

    def _drain_outboxes(self) -> None:
        for val in self.validators:
            if val.engine is None:
                continue
            while val.engine.outbox:
                self._queue.append((val.name, val.engine.outbox.pop(0)))

    def _deliver_all(self, max_msgs: int = 100_000) -> None:
        """Pump queued messages to every (non-partitioned, non-crashed)
        peer until quiescent."""
        delivered = 0
        while self._queue:
            sender, wire = self._queue.popleft()
            for val in self.validators:
                if val.name == sender or val.crashed:
                    continue
                if self._dropped(sender, val.name):
                    continue
                if tracing.enabled():
                    # the in-process analogue of the mesh's envelope
                    # context: sender/receiver attribution on every
                    # delivery, so harness runs read like mesh traces
                    with tracing.span(
                        "bftnet.deliver", cat="gossip",
                        sender=sender, receiver=val.name,
                        kind=str(wire.get("kind", "")),
                        height=int(wire.get("height", 0) or 0),
                    ):
                        val.engine.receive(wire)
                else:
                    val.engine.receive(wire)
            self._drain_outboxes()
            delivered += 1
            if delivered > max_msgs:
                raise RuntimeError("message storm: transport not quiescing")

    def _fire_due_timeouts(self) -> bool:
        """Fire each engine's oldest pending timeout request that is
        still relevant.  Returns True if anything fired."""
        fired = False
        for step in (STEP_PROPOSE, STEP_PREVOTE, STEP_PRECOMMIT):
            for val in self.validators:
                if val.crashed or val.engine is None:
                    continue
                eng = val.engine
                due = [t for t in eng.timeout_requests if t[0] == step]
                eng.timeout_requests = [
                    t for t in eng.timeout_requests if t[0] != step
                ]
                for _, h, r in due:
                    if step == STEP_PROPOSE:
                        eng.on_timeout_propose(h, r)
                    elif step == STEP_PREVOTE:
                        eng.on_timeout_prevote(h, r)
                    else:
                        eng.on_timeout_precommit(h, r)
                    fired = True
            if fired:
                return True  # earlier-step timeouts fire first
        return fired

    # -- block production ----------------------------------------------

    @property
    def height(self) -> int:
        return self.blocks[-1].header.height if self.blocks else 1

    @property
    def total_power(self) -> int:
        return sum(v.power for v in self.validators)

    def live_power(self) -> int:
        return sum(v.power for v in self.validators if not v.crashed)

    def broadcast_tx(self, raw: bytes):
        from celestia_tpu_torch.state.tx import SubmitResult
        from celestia_tpu_torch.da.blob import unmarshal_blob_tx
        from celestia_tpu_torch.state.tx import unmarshal_tx

        code, log = 0, ""
        for val in self.validators:
            if val.crashed:
                continue
            res = val.app.check_tx(raw)
            if res.code == 0:
                btx = unmarshal_blob_tx(raw)
                tx = unmarshal_tx(btx.tx if btx is not None else raw)
                val.mempool.add(raw, tx.fee.gas_price(), self.height)
            else:
                code, log = res.code, res.log
        return SubmitResult(code, log, hashlib.sha256(raw).digest())

    def produce_block(self, max_steps: int = 200) -> Block:
        """Drive one height to a decision on every live validator."""
        height = self.height + 1
        for val in self.validators:
            if not val.crashed:
                val.engine.start_height(height)
        self._drain_outboxes()
        steps = 0
        while True:
            self._deliver_all()
            if all(
                height in val.engine.decided
                for val in self.validators
                if not val.crashed
            ):
                break
            if not self._fire_due_timeouts():
                raise RuntimeError(
                    f"height {height} stalled with no due timeouts: "
                    + ", ".join(
                        f"{v.name}@r{v.engine.round}/{v.engine.step}"
                        for v in self.validators
                        if not v.crashed
                    )
                )
            self._drain_outboxes()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"height {height} did not decide")
        return self._finalize_height(height)

    def _finalize_height(self, height: int) -> Block:
        # all live validators decided — the decisions MUST agree
        decisions = {
            val.engine.decided[height].payload.block_id
            for val in self.validators
            if not val.crashed
        }
        if len(decisions) != 1:
            raise ConsensusFailure(
                f"conflicting decisions at height {height}: "
                f"{[d.hex()[:12] for d in decisions]}"
            )
        sample = next(
            val.engine.decided[height]
            for val in self.validators
            if not val.crashed
        )
        payload = sample.payload
        self._block_ids[height] = payload.block_id
        self._now_ns = payload.time_ns
        # LastCommitInfo comes from the PAYLOAD (identical everywhere),
        # not from each node's local certificate
        from celestia_tpu_torch.node.bft import last_commit_vote_pairs

        vote_pairs = last_commit_vote_pairs(
            {v.address: v.power for v in self.validators}, payload
        )
        app_hashes = {}
        results_sample = None
        for val in self.validators:
            if val.crashed:
                continue
            results, _end, app_hash = val.app.finalize_block(
                list(payload.txs), height, payload.time_ns,
                payload.data_root,
                proposer=payload.proposer or None, votes=vote_pairs,
            )
            val.finalized[height] = app_hash
            app_hashes[val.name] = app_hash
            if results_sample is None:
                results_sample = results
        if len(set(app_hashes.values())) != 1:
            raise ConsensusFailure(
                f"app hash divergence at height {height}: "
                f"{ {n: h.hex()[:12] for n, h in app_hashes.items()} }"
            )
        header = BlockHeader(
            height=height,
            time_ns=payload.time_ns,
            chain_id=self.chain_id,
            app_version=next(
                v for v in self.validators if not v.crashed
            ).app.app_version,
            data_hash=payload.data_root,
            app_hash=next(iter(app_hashes.values())),
            square_size=payload.square_size,
        )
        block = Block(
            header, list(payload.txs), results_sample,
            payload.proposer, vote_pairs,
        )
        self.blocks.append(block)
        for raw, res in zip(payload.txs, results_sample):
            h = hashlib.sha256(raw).digest()
            self._tx_index[h] = {
                "code": res.code, "log": res.log, "height": height,
            }
            for val in self.validators:
                val.mempool.remove(h)
        for val in self.validators:
            if not val.crashed:
                val.mempool.recheck(
                    lambda raw, _a=val.app: _a.check_tx(
                        raw, is_recheck=True
                    ).code
                    == 0
                )
            val.mempool.evict_expired(height)
        return block

    def produce_blocks(self, n: int) -> List[Block]:
        return [self.produce_block() for _ in range(n)]

    # -- client surface (Signer-compatible, served by validator 0) ------

    @property
    def app(self) -> App:
        return self.validators[0].app

    def account_info(self, address: bytes):
        acc = self.validators[0].app.accounts.peek(address)
        return acc.account_number, acc.sequence

    def get_tx(self, tx_hash: bytes):
        return self._tx_index.get(tx_hash)

    def simulate(self, raw: bytes) -> int:
        from celestia_tpu_torch.node.testnode import TestNode

        return TestNode._simulate_locked(self, raw)  # type: ignore[arg-type]

    @property
    def chain_id_prop(self):
        return self.chain_id
