"""Multi-validator network: real state-machine replication in one process.

N validators each run their OWN App instance over independent state; every
block goes through the actual BFT-shaped round:

  1. the height's proposer (round-robin, rotating on rejection) reaps its
     mempool and runs PrepareProposal;
  2. EVERY validator independently re-validates the proposal with
     ProcessProposal on its own state and votes accept/reject;
  3. the block commits only with >= 2/3 of voting power accepting
     (Tendermint's commit rule); on commit every validator finalizes and
     the resulting app hashes MUST be identical — any divergence is a
     consensus-safety failure and raises.

Byzantine cases: give a validator a MaliciousApp (node/malicious.py) and its
proposals are rejected by the honest majority, after which the next proposer
produces the canonical block — the scenario the reference covers with its
malicious-app e2e tests (test/util/malicious/app.go:38-42,
test/e2e/simple_test.go shape).

Catch-up: a fresh validator joins mid-chain and replays committed blocks
through the batched extension pipeline (multi-square batch verification) —
or restores from a peer snapshot and replays the tail.

Reference surfaces: test/util/testnode/full_node.go:20-49,
test/e2e/testnet.go:62-96, app/process_proposal.go:24-157.

Re-homed from ``celestia_tpu/node/network.py``.  What differs:

* ``ValidatorNetwork(device=None)`` gives its device to every App it
  builds, the byzantine ones and a joining validator's too.  No device
  means the card, and the constructor raises without one; ``device="cpu"``
  runs the host regime (da/dah.py).
* ``join_validator`` checks a chunk of committed blocks with one
  ``dah.data_roots_batched`` call on that device (K5b extends the batch,
  K2 and K3 hash every axis root, K4 every data root), and compares the
  data roots with the headers directly.
"""

from __future__ import annotations

import hashlib
import time as _time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.appconsts import GOAL_BLOCK_TIME_SECONDS
from celestia_tpu_torch.node.mempool import Mempool
from celestia_tpu_torch.node.testnode import Block, BlockHeader
from celestia_tpu_torch.state.app import App, PreparedProposal
from celestia_tpu_torch.state.modules.evidence import vote_sign_bytes
from celestia_tpu_torch.utils.device import resolve_device
from celestia_tpu_torch.utils.secp256k1 import PrivateKey


class ConsensusFailure(RuntimeError):
    """Committed state diverged between validators (consensus safety)."""


@dataclass
class Vote:
    validator: str
    accept: bool
    reason: str = ""
    # consensus-vote signature over (chain_id, height, block_hash): what
    # makes double-signing provable (x/evidence's Equivocation verifies
    # exactly these bytes).  Reject votes are nil votes — unsigned.
    block_hash: bytes = b""
    signature: bytes = b""


@dataclass
class RoundResult:
    height: int
    proposer: str
    committed: bool
    votes: List[Vote]
    block: Optional[Block] = None


class Validator:
    """One validator: its own app state, key, mempool and voting power."""

    def __init__(self, name: str, key: PrivateKey, power: int, app: App):
        self.name = name
        self.key = key
        self.power = power
        self.app = app
        self.mempool = Mempool(max_tx_bytes=64 * 1024 * 1024)
        # byzantine fixture: also sign a conflicting block hash each
        # height (the double-sign x/evidence exists to punish)
        self.double_signs = False

    @property
    def address(self) -> bytes:
        return self.key.public_key().address()

    def sign_vote(self, chain_id: str, height: int, block_hash: bytes) -> bytes:
        return self.key.sign(vote_sign_bytes(chain_id, height, block_hash))


class ValidatorNetwork:
    """An in-process N-validator devnet with real replication."""

    def __init__(
        self,
        n_validators: int = 4,
        chain_id: str = "celestia-tpu-multinet",
        funded_accounts=None,
        powers: Optional[List[int]] = None,
        block_interval_ns: int = GOAL_BLOCK_TIME_SECONDS * 10**9,
        malicious: Optional[Dict[int, str]] = None,
        app_factory=None,
        device=None,
    ):
        """malicious: {validator index -> malicious handler name} builds
        those validators with a MaliciousApp.  device: where every App
        extends its squares (None: the card, raising when there is none;
        ``"cpu"``: the host regime)."""
        self.device = resolve_device(device)
        self.chain_id = chain_id
        self.block_interval_ns = block_interval_ns
        powers = powers or [100] * n_validators
        keys = [
            PrivateKey.from_seed(b"multinet-val-%d" % i)
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
        self.validators: List[Validator] = []
        malicious = malicious or {}
        for i, (key, power) in enumerate(zip(keys, powers)):
            if app_factory is not None:
                app = app_factory(i)
            elif i in malicious:
                from celestia_tpu_torch.node.malicious import MaliciousApp

                app = MaliciousApp(
                    chain_id=chain_id, handler=malicious[i], device=self.device
                )
            else:
                app = App(chain_id=chain_id, device=self.device)
            app.init_chain(genesis)
            self.validators.append(Validator(f"val-{i}", key, power, app))
        self.blocks: List[Block] = []
        self.rounds: List[RoundResult] = []
        self._tx_index: Dict[bytes, dict] = {}
        self._now_ns = genesis["genesis_time_ns"]
        # gossip-observed conflicting signed votes:
        # (validator, height, hash_a, sig_a, hash_b, sig_b)
        self.observed_double_signs: List[tuple] = []

    # ------------------------------------------------------------------

    @property
    def height(self) -> int:
        return self.blocks[-1].header.height if self.blocks else 1

    @property
    def total_power(self) -> int:
        return sum(v.power for v in self.validators)

    def broadcast_tx(self, raw: bytes):
        """Gossip emulation: CheckTx everywhere; pool on every validator."""
        from celestia_tpu_torch.state.tx import SubmitResult
        from celestia_tpu_torch.da.blob import unmarshal_blob_tx
        from celestia_tpu_torch.state.tx import unmarshal_tx

        code, log = 0, ""
        for val in self.validators:
            res = val.app.check_tx(raw)
            if res.code == 0:
                btx = unmarshal_blob_tx(raw)
                tx = unmarshal_tx(btx.tx if btx is not None else raw)
                val.mempool.add(raw, tx.fee.gas_price(), self.height)
            else:
                code, log = res.code, res.log
        return SubmitResult(code, log, hashlib.sha256(raw).digest())

    # ------------------------------------------------------------------
    # consensus rounds
    # ------------------------------------------------------------------

    def proposer_for(self, height: int, round_: int = 0) -> Validator:
        return self.validators[(height + round_) % len(self.validators)]

    def produce_block(self, max_rounds: int = None) -> Block:
        """Run consensus rounds at the next height until a block commits.

        Each failed round rotates the proposer (Tendermint round
        progression); raises if every validator's proposal is rejected.
        """
        height = self.height + 1
        if max_rounds is None:
            max_rounds = len(self.validators)
        last: Optional[RoundResult] = None
        for round_ in range(max_rounds):
            last = self._run_round(height, round_)
            if last.committed:
                return last.block
        raise RuntimeError(
            f"no block committed at height {height} after {max_rounds} rounds:"
            f" last votes {[(v.validator, v.accept, v.reason) for v in last.votes]}"
        )

    def _run_round(self, height: int, round_: int) -> RoundResult:
        proposer = self.proposer_for(height, round_)
        self._now_ns += self.block_interval_ns
        mem_txs = proposer.mempool.reap()
        try:
            proposal = proposer.app.prepare_proposal([t.raw for t in mem_txs])
        except Exception as e:  # a crashed proposer forfeits its round
            # (the reference's PrepareProposal deliberately panics to halt a
            # broken proposer, app/prepare_proposal.go:58-85; the network
            # moves to the next round)
            result = RoundResult(
                height, proposer.name, False,
                [Vote(proposer.name, False, f"proposer crashed: {e}")],
            )
            self.rounds.append(result)
            return result

        votes: List[Vote] = []
        accept_power = 0
        for val in self.validators:
            if val is proposer:
                ok, reason = True, "proposer"
            else:
                ok, reason = val.app.process_proposal(
                    proposal.block_txs, proposal.square_size, proposal.data_root
                )
            if ok:
                # an accept is a SIGNED vote on the block's data root; a
                # reject is a nil vote (unsigned)
                sig = val.sign_vote(self.chain_id, height, proposal.data_root)
                votes.append(
                    Vote(val.name, True, reason, proposal.data_root, sig)
                )
                if val.double_signs:
                    # byzantine: a second signature on a conflicting hash,
                    # gossiped like any vote — observers collect it as
                    # equivocation evidence
                    fake = hashlib.sha256(b"conflict" + proposal.data_root).digest()
                    self.observed_double_signs.append(
                        (val.address, height,
                         proposal.data_root, sig,
                         fake, val.sign_vote(self.chain_id, height, fake))
                    )
            else:
                votes.append(Vote(val.name, False, reason))
        # only votes whose signature verifies over THIS proposal's data
        # root count toward the quorum — a validly-signed vote on some
        # other hash is a nil vote here (and evidence fodder elsewhere)
        digest = vote_sign_bytes(self.chain_id, height, proposal.data_root)
        for val, vote in zip(self.validators, votes):
            if not vote.accept:
                continue
            if vote.block_hash == proposal.data_root and val.key.public_key(
            ).verify(digest, vote.signature):
                accept_power += val.power
            else:
                vote.accept = False
                vote.reason = "vote signature invalid for this block"
        committed = accept_power * 3 >= self.total_power * 2
        result = RoundResult(height, proposer.name, committed, votes)
        if committed:
            result.block = self._commit(height, proposal, proposer, votes)
        self.rounds.append(result)
        return result

    def _commit(
        self,
        height: int,
        proposal: PreparedProposal,
        proposer: Validator,
        votes: List[Vote],
    ) -> Block:
        # the commit's proposer + votes feed x/distribution (proposer
        # reward, power-weighted allocation) and x/slashing (liveness
        # window) in every validator's BeginBlocker — identical inputs are
        # a consensus requirement, like the block txs themselves
        vote_pairs = [
            (val.address, vote.accept)
            for val, vote in zip(self.validators, votes)
        ]
        app_hashes = []
        results_per_val = []
        for val in self.validators:
            results, _end, app_hash = val.app.finalize_block(
                proposal.block_txs, height, self._now_ns, proposal.data_root,
                proposer=proposer.address, votes=vote_pairs,
            )
            app_hashes.append(app_hash)
            results_per_val.append(results)
        if len(set(app_hashes)) != 1:
            raise ConsensusFailure(
                f"app hash divergence at height {height}: "
                f"{[h.hex()[:16] for h in app_hashes]}"
            )
        header = BlockHeader(
            height=height,
            time_ns=self._now_ns,
            chain_id=self.chain_id,
            app_version=self.validators[0].app.app_version,
            data_hash=proposal.data_root,
            app_hash=app_hashes[0],
            square_size=proposal.square_size,
        )
        block = Block(
            header, proposal.block_txs, results_per_val[0],
            proposer.address, vote_pairs,
        )
        self.blocks.append(block)
        for raw, res in zip(proposal.block_txs, results_per_val[0]):
            h = hashlib.sha256(raw).digest()
            self._tx_index[h] = {
                "code": res.code, "log": res.log, "height": height,
            }
            for val in self.validators:
                val.mempool.remove(h)
        for val in self.validators:
            val.mempool.evict_expired(height)
        return block

    def produce_blocks(self, n: int) -> List[Block]:
        return [self.produce_block() for _ in range(n)]

    # ------------------------------------------------------------------
    # client surface (Signer-compatible, routed via validator 0)
    # ------------------------------------------------------------------

    @property
    def app(self) -> App:
        """Validator 0's app — the state any client RPC would serve from."""
        return self.validators[0].app

    def account_info(self, address: bytes):
        # non-mutating: a query must never write one validator's state
        acc = self.validators[0].app.accounts.peek(address)
        return acc.account_number, acc.sequence

    def get_tx(self, tx_hash: bytes) -> Optional[dict]:
        return self._tx_index.get(tx_hash)

    def simulate(self, raw: bytes) -> int:
        from celestia_tpu_torch.node.testnode import TestNode

        # reuse the lock-free body (this class has no service lock; the
        # simulation runs on a discarded branch of validator 0's state)
        return TestNode._simulate_locked(self, raw)  # type: ignore[arg-type]

    # ------------------------------------------------------------------
    # catch-up
    # ------------------------------------------------------------------

    def join_validator(
        self, name: str = None, power: int = 100, batch: int = 8
    ) -> Validator:
        """A fresh node joins: init from genesis, replay committed blocks
        verifying data roots with the BATCHED extension pipeline (multi-
        square batch parallelism — SURVEY §2.3 'validator catch-up'), then
        execute the blocks to rebuild state; it must land on the same app
        hash as the network."""
        import numpy as np

        from celestia_tpu_torch.da import dah as dah_mod
        from celestia_tpu_torch.da.square import construct as construct_square

        key = PrivateKey.from_seed(b"joiner-%d" % len(self.validators))
        app = App(chain_id=self.chain_id, device=self.device)
        app.init_chain(self.genesis)
        # phase 1: batched DA verification of all committed blocks
        squares_by_size: Dict[int, List[Tuple[int, "np.ndarray"]]] = {}
        for blk in self.blocks:
            # reconstruct with the size bound recorded in the header (the
            # gov bound may have changed since the block was built)
            square, _txs, _w = construct_square(
                blk.txs, blk.header.square_size
            )
            squares_by_size.setdefault(square.size, []).append(
                (
                    blk.header.height,
                    square.to_array().reshape(square.size, square.size, -1),
                )
            )
        roots_by_height: Dict[int, bytes] = {}
        for size, items in squares_by_size.items():
            for i in range(0, len(items), batch):
                chunk = items[i : i + batch]
                stacked = np.stack([sq for _, sq in chunk])
                # the extended squares stay on the device: only the axis
                # roots and the data roots come back, in one copy
                _roots, data_roots = dah_mod.data_roots_batched(
                    stacked, device=self.device
                )
                for (h, _), droot in zip(chunk, data_roots):
                    roots_by_height[h] = droot
        for blk in self.blocks:
            if roots_by_height[blk.header.height] != blk.header.data_hash:
                raise ConsensusFailure(
                    f"catch-up: data root mismatch at height {blk.header.height}"
                )
        # phase 2: execute blocks to rebuild state (replaying each block's
        # recorded commit info so distribution/slashing writes reproduce)
        for blk in self.blocks:
            _res, _end, app_hash = app.finalize_block(
                blk.txs, blk.header.height, blk.header.time_ns,
                blk.header.data_hash,
                proposer=blk.proposer or None, votes=blk.votes,
            )
            if app_hash != blk.header.app_hash:
                raise ConsensusFailure(
                    f"catch-up: app hash mismatch at height {blk.header.height}"
                )
        val = Validator(name or f"val-{len(self.validators)}", key, power, app)
        self.validators.append(val)
        return val
