"""In-process single-node network: the workhorse test/devnet driver.

Parity with test/util/testnode/ (full_node.go:20-49 spins a
consensus node + app in one process via a local ABCI client; network.go:19-69
+ node_interaction_api.go:40-151 provide the fluent config, funded accounts
and WaitForHeight/PostData helpers).  Here the consensus engine is an
in-process block-production loop that drives the App's ABCI surface exactly
the way celestia-core does: reap mempool by priority -> PrepareProposal ->
ProcessProposal (every block self-validated, so a Prepare/Process divergence
fails loudly) -> finalize + commit.

Re-homed from ``celestia_tpu/node/testnode.py``.  What differs:

* ``TestNode(**app_kwargs)`` passes ``device=`` to its App: no device means
  the card, and the constructor raises without one; ``device="cpu"`` runs
  the host regime (da/dah.py), and DAS is served by the host prover.  A
  node restored from a snapshot or a network
  state-sync keeps its App's device.
* A block that has aged out of the node's EDS cache is rebuilt on the
  App's device (``dah.extend_block(square, device=self.app.device)``), so
  every proof query is served from an EDS on that device.
* ``bft_catchup_batch``'s batched warm leg has no fallback: a failure of
  ``App.validate_blocks_batched(..., warm_only=True)`` raises to the
  caller instead of being noted and replayed block by block.
"""

from __future__ import annotations

import hashlib
import threading
import time as _time
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.appconsts import (
    CONTINUATION_SPARSE_SHARE_CONTENT_SIZE,
    GOAL_BLOCK_TIME_SECONDS,
)
from celestia_tpu_torch.state.tx import SubmitResult
from celestia_tpu_torch.da.blob import unmarshal_blob_tx
from celestia_tpu_torch.node.mempool import Mempool
from celestia_tpu_torch.utils.lru import LruCache
from celestia_tpu_torch.state.ante import AnteContext, AnteError, run_ante
from celestia_tpu_torch.state.app import App
from celestia_tpu_torch.state.auth import AccountKeeper
from celestia_tpu_torch.state.bank import BankKeeper
from celestia_tpu_torch.state.params import ParamsKeeper
from celestia_tpu_torch.state.tx import unmarshal_tx
from celestia_tpu_torch.utils.secp256k1 import PrivateKey


# Block/BlockHeader moved to state/consensus.py (celint R8: the
# persistence layer replays them from state/, below node/); re-exported
# here so node-side callers are unchanged.
from celestia_tpu_torch.state.consensus import Block, BlockHeader  # noqa: F401,E402


class TestNode:
    """Single-process node exposing the client surface the Signer needs."""

    __test__ = False  # not a pytest class

    def __init__(
        self,
        chain_id: str = "celestia-tpu-devnet",
        funded_accounts: Optional[List[Tuple[PrivateKey, int]]] = None,
        genesis_time_ns: Optional[int] = None,
        block_interval_ns: int = GOAL_BLOCK_TIME_SECONDS * 10**9,
        auto_produce: bool = True,
        genesis: Optional[dict] = None,
        validator_key: Optional[PrivateKey] = None,
        snapshot_dir: Optional[str] = None,
        snapshot_interval: int = 0,
        snapshot_keep_recent: int = 2,
        app: Optional[App] = None,
        data_dir: Optional[str] = None,
        state_checkpoint_interval: int = 500,
        **app_kwargs,
    ):
        # One reentrant lock serialises every client-surface entry point:
        # concurrent confirm-polls (get_tx auto-produce), broadcasts and
        # the server's production loop all touch app/mempool/blocks state
        # (pkg/user's Signer is explicitly multi-threaded against one node)
        self._service_lock = threading.RLock()
        # disk-backed persistence (data_dir given): recover a previous
        # chain from the append-only logs, or start fresh and log from
        # genesis.  The block log is the consistency anchor: a crash
        # between the state fsync and the block fsync replays state only
        # up to the last fully-persisted block.
        self.data_dir = data_dir
        self._state_log = None
        self._block_log = None
        # genesis document served to joining peers (download-genesis);
        # set below on the fresh-InitChain path, or by the CLI on the
        # recovery/snapshot-restore paths (which never re-run InitChain)
        self.genesis_doc: Optional[dict] = None
        recovered_blocks: List[Block] = []
        disk_recovered = False
        if data_dir and app is None:
            import os as _os

            from celestia_tpu_torch.state.disk import BlockLog, StateLog

            recovered_blocks = BlockLog.recover(data_dir)
            if recovered_blocks:
                rec = StateLog.recover(
                    data_dir, up_to=recovered_blocks[-1].header.height
                )
                if rec is None:
                    raise RuntimeError(
                        f"data dir {data_dir} has blocks but no intact "
                        "state log"
                    )
                state, h, ah = rec
                if h != recovered_blocks[-1].header.height:
                    raise RuntimeError(
                        f"state log recovered to height {h} but block log "
                        f"ends at {recovered_blocks[-1].header.height}"
                    )
                app = App.restore_from_disk(state, h, ah, **app_kwargs)
                disk_recovered = True
            else:
                # no fully-persisted block survived: a stale state.log
                # (e.g. crash in the first block's fsync window) would
                # poison a fresh chain with duplicate/orphan records —
                # start from a clean slate
                for name in ("state.log", "blocks.log"):
                    p = _os.path.join(data_dir, name)
                    if _os.path.exists(p):
                        _os.remove(p)
        restored = app is not None
        self.app = app if restored else App(chain_id=chain_id, **app_kwargs)
        if data_dir:
            from celestia_tpu_torch.state.disk import BlockLog, StateLog

            self._state_log = StateLog(
                data_dir, checkpoint_interval=state_checkpoint_interval
            )
            self._block_log = BlockLog(data_dir)
            if restored and not disk_recovered:
                # snapshot-restored app adopting a data dir: seed the
                # state log with a base checkpoint so future recoveries
                # replay from here, not from an empty state
                self._state_log.append_checkpoint(
                    self.app.store.last_height,
                    self.app.store.committed_hash(self.app.store.last_height),
                    self.app.store.raw_state(),
                )
            self.app.store.set_persister(self._persist_commit)
        self.chain_id = self.app.chain_id if restored else chain_id
        self.block_interval_ns = block_interval_ns
        self.auto_produce = auto_produce
        self.snapshot_interval = snapshot_interval
        self.snapshot_keep_recent = snapshot_keep_recent
        self.snapshots = None
        if snapshot_dir:
            from celestia_tpu_torch.node.snapshots import SnapshotStore

            self.snapshots = SnapshotStore(snapshot_dir)
        max_bytes = (
            self.app.max_effective_square_size() ** 2
            * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
        )
        self.mempool = Mempool(max_tx_bytes=max_bytes)
        self.blocks: List[Block] = []
        self._tx_index: Dict[bytes, dict] = {}
        # event index: "type" and "type.attr=value" -> tx hashes, serving
        # query-by-event (the reference's tx_search over indexed events,
        # pkg/user/signer.go:365-395 confirm workflows)
        self._event_index: Dict[str, List[bytes]] = {}
        # recent-block EDS/DAH/layout cache: inclusion proofs are served
        # from here without recomputing the extension (the role of
        # pkg/inclusion's EDS subtree cache + pkg/proof query routes)
        self._eds_cache: Dict[int, dict] = {}
        self.eds_cache_blocks = 8
        self._validator_key = validator_key or PrivateKey.from_seed(
            b"testnode-validator"
        )
        self._bft = None  # armed by enable_bft()
        self._bft_decided_log = LruCache("bft_decided_log", 512)
        if recovered_blocks:
            # disk recovery: resume the chain where the logs end
            self.blocks = recovered_blocks
            for blk in recovered_blocks:
                for raw, res in zip(blk.txs, blk.tx_results):
                    self._index_tx(
                        hashlib.sha256(raw).digest(), res, blk.header.height
                    )
            self._now_ns = recovered_blocks[-1].header.time_ns
            return
        if restored:
            # state-sync restore: the app already carries committed state at
            # its snapshot height; no InitChain
            self._now_ns = genesis_time_ns or _time.time_ns()
            return
        if genesis is None:
            genesis = {
                "chain_id": chain_id,
                "genesis_time_ns": genesis_time_ns or _time.time_ns(),
                "accounts": [],
                "validators": [],
            }
            val_addr = self._validator_key.public_key().address()
            genesis["accounts"].append(
                {"address": val_addr.hex(), "balance": 1_000_000_000_000}
            )
            genesis["validators"].append(
                {"address": val_addr.hex(), "self_delegation": 100_000_000_000}
            )
            for key, balance in funded_accounts or []:
                genesis["accounts"].append(
                    {
                        "address": key.public_key().address().hex(),
                        "balance": balance,
                    }
                )
        else:
            genesis = dict(genesis)
            genesis.setdefault("chain_id", chain_id)
            if not genesis.get("genesis_time_ns"):
                genesis["genesis_time_ns"] = genesis_time_ns or _time.time_ns()
        self.app.init_chain(genesis)
        # retained so joining peers can download the genesis document
        # over gRPC (the reference's download-genesis role)
        self.genesis_doc = genesis
        self._now_ns = self.app.genesis_time_ns

    # ------------------------------------------------------------------
    # two-phase BFT mode (node/bft.py engine; the relay is dumb transport)
    # ------------------------------------------------------------------

    def enable_bft(self, valset: List[dict]) -> None:
        """Arm the Tendermint-style consensus engine.  valset entries:
        {"address": hex, "pubkey": hex (33B compressed), "power": int}.
        Once enabled, blocks are produced ONLY by BFT decisions — this
        node prevotes/precommits with its validator key and finalizes
        when IT observes a 2/3 precommit quorum, never because a
        coordinator told it to."""
        from celestia_tpu_torch.node.bft import BFTNode

        validators = {
            bytes.fromhex(v["address"]): int(v["power"]) for v in valset
        }
        pubkeys = {
            bytes.fromhex(v["address"]): bytes.fromhex(v["pubkey"])
            for v in valset
        }
        own = self._validator_key.public_key().address()
        if own not in validators:
            # fail at startup, not as a silent consensus stall later
            raise ValueError(
                f"this node's validator key ({own.hex()}) is not in the "
                "BFT valset — check priv_validator_key.json vs valset.json"
            )
        self._bft_valset = [dict(v) for v in valset]  # for state-sync re-arm
        self._bft_block_ids: Dict[int, bytes] = {}
        self._bft_decided_log = LruCache("bft_decided_log", 512)
        self._bft = BFTNode(
            chain_id=self.chain_id,
            key=self._validator_key,
            validators=validators,
            validate_fn=self._bft_validate,
            propose_fn=self._bft_propose,
            on_decide=self._bft_decide,
            pubkeys=pubkeys,
        )

    def _bft_validate(self, payload):
        from celestia_tpu_torch.node.bft import validate_payload_against_chain

        # one a proposal (the engine caches each block id's verdict)
        self.app.telemetry.incr("bft_proposals_validated")
        try:
            expected = self.app.store.committed_hash(payload.height - 1)
        except KeyError:
            expected = None
        # Timestamp anchor: the PREVIOUS BLOCK's header time when this
        # node has it.  Not _now_ns — a snapshot-restored node's _now_ns
        # is wall/genesis time, which can sit far ahead of chain time and
        # would make it nil-prevote every honest proposal forever.  When
        # the previous block is unknown (fresh post-restore) both checks
        # are skipped; they re-arm at the next committed block.  The
        # drift bound is a small multiple of the interval so a Byzantine
        # proposer cannot creep chain time by a large allowance per
        # block (honest proposals sit at exactly prev + interval).
        prev_time = None
        if self.blocks and (
            self.blocks[-1].header.height == payload.height - 1
        ):
            prev_time = self.blocks[-1].header.time_ns
        ok, why = validate_payload_against_chain(
            self._bft, payload, self._bft_block_ids.get(payload.height - 1),
            expected_prev_app_hash=expected,
            prev_time_ns=prev_time,
            now_ns=prev_time,
            max_drift_ns=2 * self.block_interval_ns,
        )
        if not ok:
            return False, f"bad commit certificate: {why}"
        return self.app.process_proposal(
            list(payload.txs), payload.square_size, payload.data_root
        )

    def _bft_propose(self, height: int, round_: int):
        from celestia_tpu_torch.node.bft import BlockPayload, ProposeFailed

        mem_txs = self.mempool.reap()
        try:
            proposal = self.app.prepare_proposal([t.raw for t in mem_txs])
        except Exception as e:
            # departure from the reference, whose validator forfeits the
            # round and goes on: the failure is the node's own and ends it
            # (node/gossip.py hands it to NodeServer.fail)
            raise ProposeFailed(
                f"PrepareProposal at height {height} round {round_}: {e!r}"
            ) from e
        # keep the proposer's own (EDS, DAH, layout): its validate leg
        # hits the content-addressed EDS cache instead of re-extending,
        # and _bft_decide reuses the artifacts for proof serving (the
        # same wiring the coordinator path has via cons_prepare)
        self._pending_proposal = proposal
        last_commit = ()
        prev = self._bft.decided.get(height - 1)
        if prev is not None:
            last_commit = tuple(
                sorted(prev.precommits, key=lambda v: v.validator)
            )
        try:
            prev_app_hash = self.app.store.committed_hash(height - 1)
        except KeyError:
            prev_app_hash = b""
        return BlockPayload(
            height=height,
            time_ns=self._now_ns + self.block_interval_ns,
            square_size=proposal.square_size,
            data_root=proposal.data_root,
            txs=tuple(proposal.block_txs),
            proposer=self._validator_key.public_key().address(),
            last_commit=last_commit,
            prev_app_hash=prev_app_hash,
        )

    def _bft_decide(self, decided) -> None:
        from celestia_tpu_torch.node.bft import last_commit_vote_pairs

        payload = decided.payload
        self._bft_block_ids[payload.height] = payload.block_id
        for h in [h for h in self._bft_block_ids if h < payload.height - 16]:
            del self._bft_block_ids[h]
        # bounded decided log for laggard catch-up past the engine's
        # prune window (the payload wire carries the full tx list, so
        # the window trades memory for how far behind a peer may fall
        # before needing a snapshot)
        log_max = getattr(self, "bft_decided_log_max", 512)
        if log_max != self._bft_decided_log.max_entries:
            self._bft_decided_log.set_max_entries(log_max)
        self._bft_decided_log.put(payload.height, {
            "payload": payload.to_wire(),
            "precommits": [v.to_wire() for v in decided.precommits],
        })
        # identical LastCommitInfo everywhere: derived from the payload's
        # certificate over the SORTED valset, never from local votes
        vote_pairs = last_commit_vote_pairs(self._bft.validators, payload)
        self._now_ns = payload.time_ns
        artifacts = self._take_pending_artifacts(payload.data_root)
        self._apply_block(
            payload.height, payload.time_ns, list(payload.txs),
            payload.data_root, payload.square_size,
            proposer=payload.proposer, votes=vote_pairs,
            artifacts=artifacts,
        )

    def bft_start(self, height: int) -> None:
        with self._service_lock:
            if self._bft is None:
                raise RuntimeError("BFT mode not enabled")
            if height != self.height + 1:
                return  # stale/duplicate start
            self._bft.start_height(height)

    def bft_msg(self, wire: dict) -> None:
        with self._service_lock:
            if self._bft is not None:
                self._bft.receive(wire)

    def bft_timeout(self, step: str, height: int, round_: int) -> None:
        with self._service_lock:
            if self._bft is None:
                return
            if step == "propose":
                self._bft.on_timeout_propose(height, round_)
            elif step == "prevote":
                self._bft.on_timeout_prevote(height, round_)
            elif step == "precommit":
                self._bft.on_timeout_precommit(height, round_)

    def bft_decided(self, height: int) -> Optional[dict]:
        """Serve a decided block + its precommit certificate for laggard
        catch-up.  The certificate is what makes the replay trustless:
        the receiver verifies the 2/3 signatures, not the sender.
        Backed by the engine's recent window first, then the node's
        bounded decided log (the engine prunes aggressively; a laggard
        more than a few heights behind still needs the certificates —
        beyond the log window, snapshot state-sync takes over)."""
        with self._service_lock:
            if self._bft is None:
                return None
            d = self._bft.decided.get(height)
            if d is not None:
                return {
                    "payload": d.payload.to_wire(),
                    "precommits": [v.to_wire() for v in d.precommits],
                }
            # touch=False: puts arrive in height order, so an untouched
            # LRU evicts lowest-height first — a contiguous sliding
            # window.  A laggard (or monitor) re-reading ancient heights
            # must not refresh them into the retained set and fragment
            # the "how far behind may a peer fall" window.
            return self._bft_decided_log.get(height, touch=False)

    def bft_catchup(self, decided_wire: dict) -> Tuple[bool, str]:
        """Adopt an externally-replayed decided block after verifying
        its commit certificate (engine.adopt_decision)."""
        from celestia_tpu_torch.node.bft import BlockPayload, Vote

        with self._service_lock:
            if self._bft is None:
                return False, "BFT mode not enabled"
            payload = BlockPayload.from_wire(decided_wire["payload"])
            if payload.height != self.height + 1:
                # height-guard BEFORE precommit parsing: a stale
                # (already-adopted) wire with junk precommits stays a
                # benign duplicate instead of raising mid-catch-up
                return payload.height <= self.height, "not the next height"
            precommits = [
                Vote.from_wire(v) for v in decided_wire["precommits"]
            ]
            return self._adopt_parsed(payload, precommits)

    def _adopt_parsed(self, payload, precommits) -> Tuple[bool, str]:
        """Shared adoption tail (caller holds the service lock and has
        already deserialized the wire)."""
        if payload.height != self.height + 1:
            return payload.height <= self.height, "not the next height"
        ok, why = self._bft.adopt_decision(payload, precommits)
        if ok:
            # adopted on its certificate: finalized without an extension
            self.app.telemetry.incr("bft_blocks_adopted")
            self.app.telemetry.gauge("bft_adopted_height", payload.height)
        return ok, why

    def bft_catchup_batch(self, decided_wires: List[dict]) -> Tuple[int, str]:
        """Adopt a WINDOW of externally-replayed decided blocks: the
        state-independent extends of every same-k square in the window
        run as ONE batched mesh dispatch (App.validate_blocks_batched
        warm-only leg, parallel/sharded.extend_and_roots_sharded_batch),
        then each block adopts sequentially through the unchanged
        certificate-verified path — adopt_decision's per-block
        validation (ante, signatures, strict reconstruction, root
        compare) runs against the then-current state and simply hits the
        warm EDS cache on its extend leg.  Trust is untouched: nothing
        is adopted that bft_catchup would not have adopted one at a
        time.  A failure of the batched warm leg raises before any block
        is adopted (there is no per-block fallback).  Returns (blocks
        adopted, reason for the first failed adoption verdict or "").
        A MALFORMED wire raises ``MalformedWire`` (from its parse error)
        AFTER the intact prefix has been adopted — the same
        penalty path per-block replay took (the gossip caller drops the
        serving peer and records a breaker failure; swallowing it would
        leave a peer persistently serving junk breaker-healthy and
        re-pulled forever).  The gossip engine tells it apart from a
        failure of this node's own adoption, which ends the node."""
        from celestia_tpu_torch.node.bft import BlockPayload, MalformedWire, Vote
        from celestia_tpu_torch.utils import faults

        if self._bft is None:
            return 0, "BFT mode not enabled"
        # parse + warm OUTSIDE the service lock: parsing is pure and
        # the warm leg only touches thread-safe surfaces (EDS cache,
        # mesh provider, telemetry) — a batched extension here must not
        # stall every RPC the node serves behind the lock
        parsed = []
        parse_exc = None
        for w in decided_wires:
            try:
                parsed.append(
                    (
                        BlockPayload.from_wire(w["payload"]),
                        [Vote.from_wire(v) for v in w["precommits"]],
                    )
                )
            except Exception as e:
                faults.note("gossip.catchup_batch", e)
                parse_exc = e
                break  # adopt the intact prefix, then re-raise
        # warm keys are stamped with the CURRENT app_version, so a
        # window straddling the predictable v1->v2 upgrade height
        # warms only the pre-upgrade prefix — post-upgrade blocks
        # would validate under v2 keys and miss every warmed entry
        # (signal-based v2+ upgrades can't be foreseen; those
        # blocks just degrade to the per-block extend path)
        warmable = parsed
        if (
            self.app.app_version == 1
            and self.app.v2_upgrade_height is not None
        ):
            warmable = [
                (p, pc)
                for p, pc in parsed
                if p.height < self.app.v2_upgrade_height
            ]
        if len(warmable) > 1:
            # no fallback: a failed batched extension raises here, before
            # any block of the window is adopted
            self.app.validate_blocks_batched(
                [
                    (list(p.txs), p.square_size, p.data_root)
                    for p, _pc in warmable
                ],
                warm_only=True,
            )
        # lock PER BLOCK, as the replaced per-block loop did: a window
        # of full validations (signatures + strict reconstruction +
        # commit, hundreds of ms each) must not stall every RPC behind
        # one continuous hold — _adopt_parsed's height check makes
        # interleaved adoptions (another catch-up source, live commits)
        # benign duplicates, not corruption
        adopted = 0
        for payload, precommits in parsed:
            with self._service_lock:
                if self._bft is None:
                    return adopted, "BFT mode not enabled"
                ok, why = self._adopt_parsed(payload, precommits)
            if not ok:
                return adopted, why
            adopted += 1
        if parse_exc is not None:
            # the prefix's progress is already committed to state;
            # the junk wire still penalizes the peer that served it
            raise MalformedWire(
                f"decided wire {len(parsed)} of the window: {parse_exc!r}"
            ) from parse_exc
        return adopted, ""

    def verify_state_sync_anchor(
        self, meta: dict, decided_wire: dict
    ) -> Tuple[bool, str]:
        """Pre-swap trust check for network state-sync: the decided block
        at meta.height+1 must carry a valid 2/3 commit certificate (over
        this node's valset) AND its prev_app_hash must equal the
        snapshot's app hash — only then is the snapshot state certified
        by the validator set, not merely self-consistent."""
        from celestia_tpu_torch.node.bft import (
            BlockPayload,
            Vote,
            verify_commit_certificate,
        )

        with self._service_lock:
            if self._bft is None:
                return False, "BFT mode not enabled"
            if meta.get("chain_id") != self.chain_id:
                return False, "snapshot is for a different chain"
            if int(meta["height"]) <= self.height:
                return False, "snapshot is not ahead of this node"
            payload = BlockPayload.from_wire(decided_wire["payload"])
            if payload.height != int(meta["height"]) + 1:
                return False, "anchor block is not snapshot height + 1"
            if payload.prev_app_hash != bytes.fromhex(meta["app_hash"]):
                return False, (
                    "anchor certificate does not commit to the snapshot's "
                    "app hash"
                )
            precommits = [
                Vote.from_wire(v) for v in decided_wire["precommits"]
            ]
            return verify_commit_certificate(
                self._bft.chain_id, self._bft.validators,
                self._bft.pubkeys, self._bft.total_power, payload,
                precommits,
            )

    def adopt_state_sync(self, meta: dict, data: dict) -> None:
        """Swap in a snapshot state fetched from the network (AFTER
        verify_state_sync_anchor passed).  The app is rebuilt from the
        chunk payload (restore_from_snapshot re-verifies that the state
        reproduces the recorded app hash), block bookkeeping resets to
        the snapshot height, and the BFT engine is re-armed on the same
        valset so the next catch-up/consensus step starts at height+1."""
        from celestia_tpu_torch.state.app import App

        with self._service_lock:
            if int(meta["height"]) <= self.height:
                # re-checked under the lock: a concurrent catch-up may
                # have advanced us; never regress to an older snapshot
                raise ValueError("snapshot is not ahead of this node")
            app = App.restore_from_snapshot(
                chain_id=meta["chain_id"],
                state=data["state"],
                height=int(meta["height"]),
                expected_app_hash=bytes.fromhex(meta["app_hash"]),
                genesis_time_ns=data.get("genesis_time_ns", 0),
                device=self.app.device,
            )
            self.app = app
            self.blocks = []  # height now reads app.store.last_height
            if self._state_log is not None:
                # future recoveries replay from this base, not genesis
                self._state_log.append_checkpoint(
                    app.store.last_height,
                    app.store.committed_hash(app.store.last_height),
                    app.store.raw_state(),
                )
                app.store.set_persister(self._persist_commit)
            if self._bft is not None:
                self.enable_bft(self._bft_valset)

    def bft_drain(self) -> dict:
        """Hand the transport everything outbound: gossip messages and
        due-timeout requests.  The transport forwards messages verbatim
        and echoes timeouts back via bft_timeout — it makes no consensus
        decisions (the 'dumb relay' contract)."""
        with self._service_lock:
            if self._bft is None:
                return {"outbox": [], "timeouts": [], "height": self.height}
            out = list(self._bft.outbox)
            self._bft.outbox.clear()
            timeouts = list(self._bft.timeout_requests)
            self._bft.timeout_requests.clear()
            return {
                "outbox": out,
                "timeouts": [
                    {"step": s, "height": h, "round": r}
                    for s, h, r in timeouts
                ],
                "height": self.height,
            }

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def _index_tx(self, tx_hash: bytes, res, height: int) -> None:
        """Record a delivered tx in the hash index and the event index.
        res.events must already be JSON-safe (normalized in _apply_block
        and by block-log recovery)."""
        self._tx_index[tx_hash] = {
            "code": res.code,
            "log": res.log,
            "height": height,
            "events": res.events,
        }
        # one index entry per tx per key, even when several events of the
        # same type (multi-msg txs) produce the same key
        keys = set()
        for ev in res.events:
            etype = ev.get("type") if isinstance(ev, dict) else None
            if not etype:
                continue
            keys.add(etype)
            for k, v in ev.items():
                if k != "type" and isinstance(v, (str, int, bool)):
                    keys.add(f"{etype}.{k}={v}")
        for key in keys:
            self._event_index.setdefault(key, []).append(tx_hash)

    def _persist_commit(self, height, app_hash, roots, forward) -> None:
        self._state_log.append_commit(
            height,
            app_hash,
            roots,
            forward,
            full_state_fn=self.app.store.raw_state,
        )

    def close(self) -> None:
        """Release the disk logs (restart tests reopen the data dir)."""
        if self._state_log is not None:
            self._state_log.close()
            self._state_log = None
        if self._block_log is not None:
            self._block_log.close()
            self._block_log = None
        self.app.store.set_persister(None)

    # ------------------------------------------------------------------
    # client surface (what pkg/user's gRPC connection provides)
    # ------------------------------------------------------------------

    @property
    def height(self) -> int:
        if self.blocks:
            return self.blocks[-1].header.height
        # restored-from-snapshot nodes resume at the snapshot height
        return max(1, self.app.store.last_height)

    def account_info(self, address: bytes) -> Tuple[int, int]:
        with self._service_lock:
            acc = self.app.accounts.peek(address)
            return acc.account_number, acc.sequence

    def broadcast_tx(self, raw: bytes) -> SubmitResult:
        """BroadcastMode_SYNC parity: CheckTx, then admit to the mempool."""
        with self._service_lock:
            return self._broadcast_tx_locked(raw)

    def _broadcast_tx_locked(self, raw: bytes) -> SubmitResult:
        res = self.app.check_tx(raw)
        return self._admit_checked_locked(raw, res)

    def _admit_checked_locked(self, raw: bytes, res) -> SubmitResult:
        tx_hash = hashlib.sha256(raw).digest()
        if res.code != 0:
            return SubmitResult(res.code, res.log, tx_hash)
        btx = unmarshal_blob_tx(raw)
        tx = unmarshal_tx(btx.tx if btx is not None else raw)
        self.mempool.add(raw, tx.fee.gas_price(), self.height)
        return SubmitResult(0, "", tx_hash)

    def broadcast_txs_batch(self, raws: List[bytes]) -> List[SubmitResult]:
        """Batched BroadcastMode_SYNC: one service-lock hold, one
        ``check_txs_batch`` pass (single verify_batch over all fresh
        single-key signatures), then mempool admission per admitted tx.
        Results are positionally identical to looping broadcast_tx."""
        with self._service_lock:
            results = self.app.check_txs_batch(list(raws))
            out: List[SubmitResult] = []
            for raw, res in zip(raws, results):
                try:
                    out.append(self._admit_checked_locked(raw, res))
                except ValueError as e:
                    # mempool admission error (e.g. oversize): isolate it
                    # per tx — the rest of the drained queue still lands
                    out.append(
                        SubmitResult(1, str(e), hashlib.sha256(raw).digest())
                    )
            return out

    def get_tx(self, tx_hash: bytes) -> Optional[dict]:
        with self._service_lock:
            return self._get_tx_locked(tx_hash)

    def _get_tx_locked(self, tx_hash: bytes) -> Optional[dict]:
        info = self._tx_index.get(tx_hash)
        if info is None and self.auto_produce and len(self.mempool):
            # emulate chain progress for poll-confirm clients: a pending
            # mempool makes the (virtual) proposer cut the next block
            self.produce_block()
            info = self._tx_index.get(tx_hash)
        return info

    def simulate(self, raw: bytes) -> int:
        """Gas estimation via simulated ante + 20% margin (signer.go
        EstimateGas shape)."""
        with self._service_lock:
            return self._simulate_locked(raw)

    def _simulate_locked(self, raw: bytes) -> int:
        tx = unmarshal_tx(raw)
        branch = self.app.store.branch()
        ctx = AnteContext(
            tx=tx,
            raw_tx=raw,
            accounts=AccountKeeper(branch.store("auth")),
            bank=BankKeeper(branch.store("bank")),
            params=ParamsKeeper(branch.store("params")),
            chain_id=self.chain_id,
            app_version=self.app.app_version,
            simulate=True,
        )
        try:
            meter = run_ante(ctx)
            base = meter.consumed
        except AnteError:
            base = 100_000
        return int(base * 1.2) + 100_000

    # ------------------------------------------------------------------
    # consensus loop
    # ------------------------------------------------------------------

    def produce_block(self) -> Block:
        """One consensus round: reap -> Prepare -> Process -> finalize."""
        with self._service_lock:
            return self._produce_block_locked()

    def _produce_block_locked(self) -> Block:
        height = self.height + 1
        self._now_ns += self.block_interval_ns
        time_ns = self._now_ns
        mem_txs = self.mempool.reap()
        proposal = self.app.prepare_proposal([t.raw for t in mem_txs])
        accepted, reason = self.app.process_proposal(
            proposal.block_txs, proposal.square_size, proposal.data_root
        )
        if not accepted:
            raise RuntimeError(
                f"node's own proposal rejected at height {height}: {reason}"
            )
        val_addr = self._validator_key.public_key().address()
        return self._apply_block(
            height, time_ns, proposal.block_txs, proposal.data_root,
            proposal.square_size, artifacts=proposal,
            proposer=val_addr, votes=[(val_addr, True)],
        )

    def _take_pending_artifacts(self, data_root: bytes):
        """Consume the proposer's own PreparedProposal if it matches the
        block being committed: when WE proposed this block, commit with
        the prepared (EDS/DAH/layout) so proof queries serve from the
        cache without a reconstruct+re-extend.  The data-root match
        guards staleness (a restarted round that re-prepared different
        txs); the pending slot is cleared either way."""
        pending = getattr(self, "_pending_proposal", None)
        self._pending_proposal = None
        if pending is not None and pending.data_root == data_root:
            return pending
        return None

    def _apply_block(
        self,
        height: int,
        time_ns: int,
        block_txs: List[bytes],
        data_root: bytes,
        square_size: int,
        artifacts: Optional[object] = None,
        proposer: bytes = b"",
        votes: Optional[List[Tuple[bytes, bool]]] = None,
    ) -> Block:
        """Shared commit tail: finalize + header/block append, EDS cache,
        tx index, mempool maintenance, snapshotting.  Used by both the
        self-producing path and the coordinator's cons_commit.  proposer +
        votes are the previous commit's info (ABCI LastCommitInfo role):
        they feed x/distribution and x/slashing, so every replica of one
        block must receive identical values."""
        results, _end, app_hash = self.app.finalize_block(
            block_txs, height, time_ns, data_root,
            proposer=proposer or None, votes=votes,
        )
        header = BlockHeader(
            height=height,
            time_ns=time_ns,
            chain_id=self.chain_id,
            app_version=self.app.app_version,
            data_hash=data_root,
            app_hash=app_hash,
            square_size=square_size,
        )
        block = Block(header, list(block_txs), results, proposer, votes)
        self.blocks.append(block)
        if self._block_log is not None:
            self._block_log.append_block(block)
        # retain the proposal's EDS + layout for proof queries (bounded);
        # non-proposers reconstruct on demand via _block_artifacts
        if artifacts is not None:
            self._eds_cache[height] = {
                "eds": artifacts.eds,
                "dah": artifacts.dah,
                "square": artifacts.square,
                "wrappers": artifacts.wrappers,
            }
            for h in [
                h for h in self._eds_cache
                if h <= height - self.eds_cache_blocks
            ]:
                del self._eds_cache[h]
        # normalize events to JSON-safe form ONCE; the tx index, the
        # event index, the block log and the gRPC surface all share it
        from celestia_tpu_torch.state.app import jsonable_events

        for res in results:
            res.events[:] = jsonable_events(res.events)
        # index included txs + drop them from the mempool
        for raw, res in zip(block_txs, results):
            h = hashlib.sha256(raw).digest()
            self._index_tx(h, res, height)
            self.mempool.remove(h)
        # comet recheck parity: the block just moved state under every
        # still-pooled tx — re-run CheckTx (recheck mode, fresh check
        # state branched off the new commit) and evict what no longer
        # passes, instead of letting stale txs linger until TTL
        if len(self.mempool):
            self.mempool.recheck(
                lambda raw: self.app.check_tx(raw, is_recheck=True).code == 0
            )
        # txs the proposer dropped stay pooled until their TTL expires
        self.mempool.evict_expired(height)
        if (
            self.snapshots is not None
            and self.snapshot_interval > 0
            and height % self.snapshot_interval == 0
        ):
            self.snapshots.create(self.app)
            self.snapshots.prune(self.snapshot_keep_recent)
        return block

    # ------------------------------------------------------------------
    # consensus surface for an EXTERNAL coordinator (multi-process
    # replication): a coordinator drives N such nodes over gRPC through
    # prepare/process/commit, this node never self-produces
    # ------------------------------------------------------------------

    def cons_prepare(self) -> dict:
        """Proposer half of a round: reap own mempool, PrepareProposal.
        Returns native bytes; the gRPC handler does the wire encoding."""
        with self._service_lock:
            mem_txs = self.mempool.reap()
            proposal = self.app.prepare_proposal([t.raw for t in mem_txs])
            self._pending_proposal = proposal  # reuse EDS on self-commit
            return {
                "block_txs": list(proposal.block_txs),
                "square_size": proposal.square_size,
                "data_root": proposal.data_root,
            }

    def cons_process(
        self, block_txs: List[bytes], square_size: int, data_root: bytes
    ) -> Tuple[bool, str]:
        """Validator half: vote on a foreign proposal."""
        with self._service_lock:
            return self.app.process_proposal(block_txs, square_size, data_root)

    def cons_commit(
        self,
        block_txs: List[bytes],
        height: int,
        time_ns: int,
        data_root: bytes,
        square_size: int,
        proposer: bytes = b"",
        votes: Optional[List[Tuple[bytes, bool]]] = None,
    ) -> bytes:
        """Finalize a quorum-committed block; returns the app hash."""
        with self._service_lock:
            if height != self.height + 1:
                raise ValueError(
                    f"commit height {height} != expected {self.height + 1}"
                )
            artifacts = self._take_pending_artifacts(data_root)
            block = self._apply_block(
                height, time_ns, block_txs, data_root, square_size,
                artifacts=artifacts, proposer=proposer, votes=votes,
            )
            return block.header.app_hash

    @classmethod
    def from_snapshot(
        cls,
        snapshot_dir: str,
        block_interval_ns: int = GOAL_BLOCK_TIME_SECONDS * 10**9,
        auto_produce: bool = True,
        snapshot_interval: int = 0,
        snapshot_keep_recent: int = 2,
        validator_key: Optional[PrivateKey] = None,
        data_dir: Optional[str] = None,
        **app_kwargs,
    ) -> "TestNode":
        """Boot a node from the latest state-sync snapshot (the restart
        path of the reference's snapshot subsystem).  Snapshotting keeps
        running at the given interval after restore.  With ``data_dir``
        the restored node also logs every block to disk from here on
        (seeded with a base checkpoint at the snapshot height)."""
        from celestia_tpu_torch.node.snapshots import SnapshotStore

        store = SnapshotStore(snapshot_dir)
        info = store.latest()
        if info is None:
            raise FileNotFoundError(f"no snapshots in {snapshot_dir}")
        app = store.restore_app(info, **app_kwargs)
        return cls(
            app=app,
            block_interval_ns=block_interval_ns,
            auto_produce=auto_produce,
            snapshot_dir=snapshot_dir,
            snapshot_interval=snapshot_interval,
            snapshot_keep_recent=snapshot_keep_recent,
            validator_key=validator_key,
            data_dir=data_dir,
        )

    def produce_blocks(self, n: int) -> List[Block]:
        return [self.produce_block() for _ in range(n)]

    def wait_for_height(self, h: int) -> None:
        while self.height < h:
            self.produce_block()

    # ------------------------------------------------------------------
    # queries (node_interaction_api.go helpers)
    # ------------------------------------------------------------------

    def block(self, height: int) -> Block:
        for b in self.blocks:
            if b.header.height == height:
                return b
        raise KeyError(f"no block at height {height}")

    def _block_artifacts(self, height: int) -> dict:
        """EDS/DAH/layout for a block: cache hit, or reconstruct from txs
        (older blocks fall out of the bounded cache but stay provable)."""
        art = self._eds_cache.get(height)
        if art is not None:
            return art
        from celestia_tpu_torch.da import dah as dah_mod
        from celestia_tpu_torch.da.square import construct as construct_square

        blk = self.block(height)
        # the bound in effect when the block was built is its own recorded
        # square size — the CURRENT gov bound may have changed since
        square, _txs, wrappers = construct_square(
            blk.txs, blk.header.square_size
        )
        eds, dah = dah_mod.extend_block(square, device=self.app.device)
        if dah.hash != blk.header.data_hash:
            raise RuntimeError(
                f"reconstructed data root mismatch at height {height}"
            )
        self.app.telemetry.incr("block_artifacts_rebuilt")
        art = {"eds": eds, "dah": dah, "square": square, "wrappers": wrappers}
        self._eds_cache[height] = art
        return art

    def abci_query(self, path: str, data: dict):
        """ABCI-style query routes (JSON-safe result values).

        Parity targets: the proof query routes registered at
        app/app.go:622-623 (pkg/proof/querier.go:28,72), plus the
        bank/auth/params gRPC queries the reference serves via module
        queriers (app/app.go:826-852).
        """
        from celestia_tpu_torch.da import proof as proof_mod
        from celestia_tpu_torch.da.blob import unmarshal_blob_tx as _ubt

        if path == "store/bank/balance":
            addr = bytes.fromhex(data["address"])
            if data.get("height"):
                # height-pinned read against the committed version window
                from celestia_tpu_torch.state.bank import BankKeeper

                raw = self.app.store.get_at(
                    "bank", BankKeeper.balance_key(addr), int(data["height"])
                )
                return int.from_bytes(raw, "big") if raw else 0
            return self.app.bank.balance(addr)
        if path == "store/proof":
            # generic merkleized-state query: any (store, key) at a pinned
            # height, with the membership proof a client verifies against
            # that block's app hash (state.merkle.verify_query_proof) —
            # the reference's `--prove` ABCI query over IAVL
            height = int(data["height"]) if data.get("height") else None
            return self.app.store.prove(
                data["store"], bytes.fromhex(data["key"]), height
            )
        if path == "custom/auth/account":
            acc = self.app.accounts.peek(bytes.fromhex(data["address"]))
            return {
                "account_number": acc.account_number,
                "sequence": acc.sequence,
                "pubkey": acc.pubkey.hex() if acc.pubkey else "",
            }
        if path == "custom/params/param":
            return self.app.params.get(data["subspace"], data["key"])
        if path == "custom/staking/validators":
            return [
                {"operator": v.operator.hex(), "power": v.power}
                for v in self.app.staking.bonded_validators()
            ]
        if path == "custom/upgrade/status":
            tally = self.app.upgrade.tally_voting_power(self.app.app_version + 1)
            return {
                "app_version": self.app.app_version,
                "next_version_power": tally[0],
                "total_power": tally[1],
            }
        if path == "custom/blobstream/attestation":
            att = self.app.blobstream.attestation(int(data["nonce"]))
            return {"found": att is not None, "attestation": att}
        if path == "custom/blobstream/latest_nonce":
            return {"nonce": self.app.blobstream.latest_nonce()}
        if path == "custom/blobstream/data_commitment_range":
            att = self.app.blobstream.data_commitment_for_height(
                int(data["height"])
            )
            return {"found": att is not None, "data_commitment": att}
        if path == "custom/blobstream/data_root_inclusion":
            return self.app.blobstream.data_root_inclusion_proof(
                int(data["height"]), int(data["begin"]), int(data["end"])
            )
        if path == "custom/distribution/rewards":
            delegator = bytes.fromhex(data["delegator"])
            validator = bytes.fromhex(data["validator"])
            return {
                "pending": self.app.distribution.pending_rewards(
                    delegator, validator
                )
            }
        if path == "custom/distribution/commission":
            return {
                "commission": self.app.distribution.commission(
                    bytes.fromhex(data["validator"])
                )
            }
        if path == "custom/distribution/community-pool":
            return {"pool": self.app.distribution.community_pool()}
        if path == "custom/slashing/signing-info":
            operator = bytes.fromhex(data["validator"])
            info = self.app.slashing.signing_info(operator)
            v = self.app.staking.validator(operator)
            return {
                "missed_blocks": info.missed_blocks if info else 0,
                "index_offset": info.index_offset if info else 0,
                "jailed": bool(v and v.jailed),
                "tombstoned": bool(v and v.tombstoned),
                "jailed_until_ns": v.jailed_until_ns if v else 0,
            }
        if path == "custom/feegrant/allowance":
            a = self.app.feegrant.get(
                bytes.fromhex(data["granter"]), bytes.fromhex(data["grantee"])
            )
            if a is None:
                return {"found": False}
            return {
                "found": True, "kind": a.kind, "spend_limit": a.spend_limit,
                "expiration_ns": a.expiration_ns,
                "period_can_spend": a.period_can_spend,
            }
        if path == "custom/authz/grant":
            g = self.app.authz.get(
                bytes.fromhex(data["granter"]), bytes.fromhex(data["grantee"]),
                int(data["msg_type"]),
            )
            if g is None:
                return {"found": False}
            return {
                "found": True, "msg_type": g.msg_type,
                "spend_limit": g.spend_limit, "expiration_ns": g.expiration_ns,
            }
        if path == "custom/crisis/invariants":
            from celestia_tpu_torch.state.invariants import assert_invariants

            return assert_invariants(self.app)
        if path == "custom/tx/search":
            # query-by-event: "transfer", "transfer.recipient=<hex>", ...
            hashes = self._event_index.get(data["event"], [])
            return [
                {"hash": h.hex(), **self._tx_index[h]} for h in hashes
            ]
        if path == "custom/namespace/shares":
            # GetSharesByNamespace: all shares of one namespace + proofs,
            # with the DAH so a light client can verify completeness
            # against its trusted data root
            from celestia_tpu_torch.da import namespace_data as nsd

            height = int(data["height"])
            art = self._block_artifacts(height)
            result = nsd.get_shares_by_namespace(
                art["eds"], art["dah"], bytes.fromhex(data["namespace"])
            )
            return {
                "data": result.to_dict(),
                "dah": {
                    "row_roots": [r.hex() for r in art["dah"].row_roots],
                    "col_roots": [c.hex() for c in art["dah"].col_roots],
                },
                "data_root": self.data_root(height).hex(),
            }
        if path == "custom/das/sample":
            # DAS serving surface: one EDS cell + proof to the data root
            from celestia_tpu_torch.da import das as das_mod

            height = int(data["height"])
            art = self._block_artifacts(height)
            proof = das_mod.sample_proof(
                art["eds"], art["dah"], int(data["row"]), int(data["col"])
            )
            return {
                "proof": proof.to_dict(),
                "data_root": self.data_root(height).hex(),
            }
        if path == "custom/das/sample_batch":
            # vectorized serving surface: n cells in one row-grouped
            # pass (shared row stacks + one root tree; da/das.py).
            # Chunking/shedding live at the RPC layer (node/server.py
            # DasSampleBatch) — this query proves whatever it is handed.
            from celestia_tpu_torch.da import das as das_mod

            height = int(data["height"])
            art = self._block_artifacts(height)
            proofs = das_mod.sample_proofs_batch(
                art["eds"], art["dah"],
                [(int(r), int(c)) for r, c in data["coords"]],
            )
            return {
                "proofs": [p.to_dict() for p in proofs],
                "data_root": self.data_root(height).hex(),
            }
        if path == "custom/proof/share":
            height = int(data["height"])
            art = self._block_artifacts(height)
            proof = proof_mod.new_share_inclusion_proof(
                art["eds"], art["dah"], int(data["start"]), int(data["end"])
            )
            return {
                "proof": proof.to_dict(),
                "data_root": self.data_root(height).hex(),
            }
        if path == "custom/proof/tx":
            height = int(data["height"])
            art = self._block_artifacts(height)
            blk = self.block(height)
            normal = [t for t in blk.txs if _ubt(t) is None]
            wrapped = [w.marshal() for w in art["wrappers"]]
            proof = proof_mod.new_tx_inclusion_proof(
                art["square"], art["eds"], art["dah"], normal, wrapped,
                int(data["tx_index"]),
            )
            return {
                "proof": proof.to_dict(),
                "data_root": self.data_root(height).hex(),
            }
        raise ValueError(f"unknown query path: {path}")

    def data_root(self, height: int) -> bytes:
        return self.block(height).header.data_hash

    def fill_block(self, square_size: int, signer) -> SubmitResult:
        """Post a blob sized to produce a square of ``square_size``
        (node_interaction_api.go FillBlock)."""
        from celestia_tpu_torch.da.blob import Blob
        from celestia_tpu_torch.da.namespace import Namespace

        n_shares = square_size * square_size // 2
        size = (n_shares - 1) * CONTINUATION_SPARSE_SHARE_CONTENT_SIZE
        blob = Blob(Namespace.v0(b"fill"), b"\xaa" * max(size, 1))
        return signer.submit_pay_for_blob([blob])
