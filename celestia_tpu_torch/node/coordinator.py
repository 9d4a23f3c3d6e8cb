"""Multi-process consensus coordinator: replication across node PROCESSES.

The wire-level upgrade of node/network.py's in-process replication
(ADR 005): N ``celestia-tpu start`` processes expose the consensus surface
(ConsPrepare / ConsProcess / ConsCommit) over gRPC; this coordinator
sequences the Tendermint-shaped round across them —

  1. the height's proposer (round-robin, rotating on rejection) prepares a
     proposal from ITS OWN mempool;
  2. every other validator votes by re-validating on its own state;
  3. on >= 2/3 of voting power accepting, every validator commits and the
     returned app hashes MUST agree (``ConsensusFailure`` otherwise).

Tx gossip is emulated by broadcasting client txs to every validator
(gossip_tx).  The coordinator holds no state of its own beyond the block
log — all chain state lives in the validator processes, which is what makes
this a real replication test: the processes share nothing but their
genesis file and these RPCs.

Proposal-lifecycle caching: the coordinator deliberately stays
dumb — the redundant-work elimination lives in the validator processes.
A proposer's ``cons_prepare`` populates its content-addressed EDS cache
(da/eds_cache.py) and pins the PreparedProposal for its own
``cons_commit`` (testnode._pending_proposal); a round restart where the
SAME proposer re-prepares an unchanged mempool is an EDS-cache hit, and
every validator's ``cons_process`` of a re-gossiped block it has already
validated skips the re-extend the same way.  The coordinator never
carries EDS bytes over the wire — only (txs, square_size, data_root).

Reference analogue: celestia-core's consensus driving N nodes over p2p
(test/e2e/testnet.go:62-96 shape); SURVEY §2.3 state-machine replication.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import functools
import inspect

from celestia_tpu_torch.node.network import ConsensusFailure, RoundResult, Vote
from celestia_tpu_torch.utils import faults


@functools.lru_cache(maxsize=None)
def _type_accepts_tc(cls: type, method: str) -> bool:
    """Whether ``cls.<method>`` declares the optional trace-context
    kwarg (RemoteNode does; the in-process TestNode surface does not —
    hand it only to clients that declare it).  Cached by type: the
    answer is constant per client class, and inspect.signature is too
    reflective for the per-block consensus loop."""
    fn = getattr(cls, method, None)
    if fn is None:
        return False
    try:
        return "tc" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _accepts_tc(bound_method) -> bool:
    owner = getattr(bound_method, "__self__", None)
    if owner is None:
        return False
    return _type_accepts_tc(type(owner), bound_method.__name__)


@dataclass
class PeerValidator:
    name: str
    client: object  # RemoteNode (or any object with the cons_* surface)
    power: int = 100
    height: int = 0  # last height this peer committed (coordinator view)
    address: bytes = b""  # staking operator address (from node status)


class ProcessCoordinator:
    """Drives consensus rounds across remote validator processes."""

    def __init__(self, peers: Sequence[PeerValidator], block_interval_ns: int = 10**9):
        if not peers:
            raise ValueError("need at least one validator peer")
        self.peers = list(peers)
        self.block_interval_ns = block_interval_ns
        status = self.peers[0].client.status()
        self.height = int(status["height"])
        # block timestamps continue the CHAIN's clock, not the wall clock:
        # a wall-clock jump would make time-based inflation mint the gap in
        # one block and break parity with the other consensus drivers
        self._now_ns = int(status.get("time_ns") or 0)
        if self._now_ns == 0:
            self._now_ns = int(status.get("genesis_time_ns") or _time.time_ns())
        for peer in self.peers:
            peer_status = peer.client.status()
            peer.height = int(peer_status["height"])
            if not peer.address:
                peer.address = bytes.fromhex(
                    peer_status.get("validator_address", "") or ""
                )
        self.rounds: List[RoundResult] = []
        self.blocks: List[dict] = []

    @property
    def total_power(self) -> int:
        return sum(p.power for p in self.peers)

    def gossip_tx(self, raw: bytes):
        """Broadcast a tx to every validator's mempool (gossip emulation).
        Returns the FIRST non-zero result if any validator rejects."""
        first_bad = None
        for peer in self.peers:
            res = peer.client.broadcast_tx(raw)
            if res.code != 0 and first_bad is None:
                first_bad = res
        return first_bad

    def produce_block(self, max_rounds: Optional[int] = None):
        height = self.height + 1
        if max_rounds is None:
            max_rounds = len(self.peers)
        last = None
        for round_ in range(max_rounds):
            last = self._run_round(height, round_)
            if last.committed:
                return last
        raise RuntimeError(
            f"no block committed at height {height} after {max_rounds} rounds: "
            f"{[(v.validator, v.accept, v.reason) for v in last.votes]}"
        )

    def catch_up(self, peer: PeerValidator) -> bool:
        """Replay blocks a peer missed through its consensus surface;
        True if the peer reaches the coordinator's height."""
        for blk in self.blocks:
            if blk["height"] <= peer.height:
                continue
            try:
                app_hash = peer.client.cons_commit(
                    blk["block_txs"], blk["height"], blk["time_ns"],
                    blk["data_root"], blk["square_size"],
                    proposer=blk.get("proposer_address", b""),
                    votes=blk.get("votes"),
                )
            except Exception:
                return False
            if app_hash != blk["app_hash"]:
                raise ConsensusFailure(
                    f"{peer.name} diverged during catch-up at height "
                    f"{blk['height']}"
                )
            peer.height = blk["height"]
        return peer.height == self.height

    def _run_round(self, height: int, round_: int) -> RoundResult:
        proposer = self.peers[(height + round_) % len(self.peers)]
        self._now_ns += self.block_interval_ns
        # stale peers (missed commits) must not vote on state they don't
        # have: try to catch them up first; still-stale peers sit out
        current = []
        for peer in self.peers:
            if peer.height == self.height or self.catch_up(peer):
                current.append(peer)
        if proposer not in current:
            result = RoundResult(
                height, proposer.name, False,
                [Vote(proposer.name, False, "proposer is stale/unreachable")],
            )
            self.rounds.append(result)
            return result
        try:
            proposal = proposer.client.cons_prepare()
        except Exception as e:  # crashed proposer forfeits its round
            result = RoundResult(
                height, proposer.name, False,
                [Vote(proposer.name, False, f"proposer crashed: {e}")],
            )
            self.rounds.append(result)
            return result
        # the proposer's prepare-root trace context (when its tracer is
        # on): forwarded into every validator's process/commit RPC so
        # their spans name the PROPOSER as cross-node parent — the
        # coordinator is glue, not the causal origin.  Absent against
        # un-upgraded or untraced proposers; clients that don't declare
        # the kwarg (in-process TestNode surface) are never handed it.
        tc = proposal.get("_tc")

        def tc_kwargs(fn):
            return {"tc": tc} if tc and _accepts_tc(fn) else {}

        votes: List[Vote] = []
        accept_power = 0
        for peer in self.peers:
            if peer not in current:
                votes.append(Vote(peer.name, False, "stale: sitting out"))
                continue
            if peer is proposer:
                ok, reason = True, "proposer"
            else:
                try:
                    ok, reason = peer.client.cons_process(
                        proposal["block_txs"],
                        proposal["square_size"],
                        proposal["data_root"],
                        **tc_kwargs(peer.client.cons_process),
                    )
                except Exception as e:  # unreachable validator = NO vote
                    ok, reason = False, f"vote failed: {e}"
            votes.append(Vote(peer.name, ok, reason))
            if ok:
                accept_power += peer.power
        committed = accept_power * 3 >= self.total_power * 2
        result = RoundResult(height, proposer.name, committed, votes)
        if committed:
            # the commit info every replica must apply identically (ABCI
            # LastCommitInfo role: distribution + slashing inputs)
            vote_pairs = [
                (peer.address, vote.accept)
                for peer, vote in zip(self.peers, votes)
                if peer.address
            ]
            app_hashes = {}
            missed = []
            for peer in self.peers:
                if peer not in current:
                    missed.append(peer.name)
                    continue
                try:
                    app_hashes[peer.name] = peer.client.cons_commit(
                        proposal["block_txs"], height, self._now_ns,
                        proposal["data_root"], proposal["square_size"],
                        proposer=proposer.address, votes=vote_pairs,
                        **tc_kwargs(peer.client.cons_commit),
                    )
                    peer.height = height
                except Exception:
                    # an unreachable validator misses the commit and must
                    # catch up next round — the quorum's block stands
                    missed.append(peer.name)
            if not app_hashes:
                raise ConsensusFailure(
                    f"no validator could commit height {height}"
                )
            if len(set(app_hashes.values())) != 1:
                raise ConsensusFailure(
                    f"app hash divergence at height {height}: "
                    f"{{ {', '.join(f'{n}: {h.hex()[:12]}' for n, h in app_hashes.items())} }}"
                )
            self.height = height
            self.blocks.append(
                {
                    "height": height,
                    "time_ns": self._now_ns,
                    "block_txs": proposal["block_txs"],
                    "square_size": proposal["square_size"],
                    "data_root": proposal["data_root"],
                    "app_hash": next(iter(app_hashes.values())),
                    "proposer": proposer.name,
                    "proposer_address": proposer.address,
                    "votes": vote_pairs,
                    "n_txs": len(proposal["block_txs"]),
                    "missed": missed,
                }
            )
        self.rounds.append(result)
        return result

    def produce_blocks(self, n: int) -> List[dict]:
        out = []
        for _ in range(n):
            self.produce_block()
            out.append(self.blocks[-1])
        return out


class BFTRelay:
    """Dumb message transport for the two-phase BFT tier.

    Unlike ProcessCoordinator above (which SEQUENCES consensus: it counts
    votes and orders commits), this relay only (a) announces the next
    height, (b) forwards each node's outbound gossip verbatim to every
    other node, and (c) echoes due-timeout requests back to the node
    that asked for them when the network is quiescent — the shared-clock
    role.  It never reads message contents, never counts votes, never
    tells a node to commit: every validator process decides from the
    2/3 precommit quorum its OWN engine verified (node/bft.py), and the
    relay merely observes the resulting heights converge.
    """

    def __init__(self, peers: Sequence[PeerValidator]):
        if not peers:
            raise ValueError("need at least one validator peer")
        self.peers = list(peers)
        self.heights: List[int] = []

    def _heights(self) -> List[int]:
        out = []
        for p in self.peers:
            try:
                out.append(int(p.client.status()["height"]))
            except Exception as e:
                faults.note("relay.status", e)
                continue  # unreachable peers just don't report
        return out

    def _catch_up_laggards(self, target: int) -> None:
        """Replay decided blocks to peers behind the pack.  The relay
        only MOVES the (payload, certificate) pairs; each laggard
        verifies the 2/3 signatures itself (bft_catchup) — trustless."""
        peer_heights = []
        for p in self.peers:
            try:
                peer_heights.append((p, int(p.client.status()["height"])))
            except Exception as e:
                faults.note("relay.status", e)
                continue
        if not peer_heights:
            return
        best = max(h for _, h in peer_heights)
        sources = [p for p, h in peer_heights if h == best]
        for peer, h in peer_heights:
            while h < best:
                replayed = False
                for src in sources:
                    try:
                        d = src.client.bft_decided(h + 1)
                    except Exception as e:
                        faults.note("relay.catchup", e)
                        continue
                    if d is None:
                        continue
                    try:
                        if peer.client.bft_catchup(d):
                            h += 1
                            replayed = True
                            break
                    except Exception:
                        break
                if not replayed:
                    break  # decision pruned everywhere or peer down

    def produce_block(self, max_steps: int = 300) -> int:
        """Drive one height to a decision on every reachable peer;
        returns the new height."""
        heights = self._heights()
        if not heights:
            # unified retry layer (utils/faults.py): jittered 0.5-2 s
            # polls under a 30 s budget replace the hand-rolled
            # sleep(1.0) loop this relay shipped with
            try:
                heights = faults.RetryPolicy(
                    base_s=0.5, cap_s=2.0, deadline_s=30.0
                ).poll(self._heights, what="any validator peer")
            except TimeoutError:
                raise RuntimeError(
                    "no validator peer reachable: "
                    + ", ".join(p.name for p in self.peers)
                )
        start = max(heights)
        if min(heights) < start:
            self._catch_up_laggards(start)
        target = start + 1
        for peer in self.peers:
            try:
                peer.client.bft_start(target)
            except Exception as e:
                faults.note("relay.start", e)  # unreachable: misses the round
        steps = 0
        pending_timeouts: List[tuple] = []  # (peer, {step,height,round})
        while True:
            moved = False
            drained = []
            for peer in self.peers:
                try:
                    drained.append((peer, peer.client.bft_drain()))
                except Exception as e:
                    faults.note("relay.drain", e)
                    continue
            for sender, d in drained:
                pending_timeouts.extend((sender, t) for t in d["timeouts"])
                for wire in d["outbox"]:
                    moved = True
                    for peer in self.peers:
                        if peer is sender:
                            continue
                        try:
                            peer.client.bft_msg(wire)
                        except Exception as e:
                            faults.note("relay.forward", e)
                            continue
            if drained and all(d["height"] >= target for _, d in drained):
                return target
            if not moved:
                # a quiescent network where SOME peer reached the target
                # means the height is decided; stragglers are replayed
                # the certificate at the next produce_block (catch-up)
                if any(d["height"] >= target for _, d in drained):
                    return target
                # quiescent: tick the clocks — echo every buffered due
                # timeout back to its own node (stale ones are no-ops,
                # the engine guards by height/round/step)
                if not pending_timeouts:
                    raise RuntimeError(
                        f"height {target} stalled with no due timeouts; "
                        f"peer heights {self._heights()}"
                    )
                for peer, t in pending_timeouts:
                    try:
                        peer.client.bft_timeout(
                            t["step"], t["height"], t["round"]
                        )
                    except Exception as e:
                        faults.note("relay.timeout", e)
                        continue
                pending_timeouts.clear()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"height {target} did not decide after {steps} steps; "
                    f"peer heights {self._heights()}"
                )

    def produce_blocks(self, n: int) -> List[int]:
        return [self.produce_block() for _ in range(n)]
