"""P2P gossip mesh for the two-phase BFT validator tier.

Flood-with-dedup of consensus messages plus content-addressed want/have
transaction admission between validator processes, driven by node-local
wall-clock timers — no central relay in the critical path.  Each
validator process runs one :class:`GossipEngine`:

- **Consensus flood with BOUNDED fanout.**  The engine drains its own
  BFT engine's outbox and floods every message to at most ``fanout``
  randomly-sampled peers (default min(N-1, 8)); a received message is
  delivered to the local engine once (dedup by locally-computed content
  hash — never by a sender-supplied id, which a malicious relayer could
  use to poison the dedup set and censor real messages) and re-flooded
  onward, so coverage comes from multi-hop epidemic spread rather than
  O(N²) direct links.  Round timeouts + the status-poll catch-up are
  the liveness backstop for the (rare) sampling gaps.
- **Peer exchange (PEX).**  ``--peers`` needs only one seed: engines
  periodically swap peer lists with a random peer (the comet
  p2p/addrbook role, cmd/celestia-appd/cmd/root.go:141),
  merging new addresses up to ``max_peers``.  Killing the seed after
  bootstrap does not affect the mesh.
- **Per-peer sender threads.**  Every peer gets its own outbound queue
  and worker; a hung or black-holed peer blocks only its own link,
  never the pump loop or the round timers.
- **Re-flood on a stalled height.**  A message whose link is down (a
  peer still booting or just killed, say) is dropped, and the reference
  never sends it again: validators that boot seconds apart can each miss
  the votes of the others' first round and wait for a 2/3 that never
  arrives, and a validator that missed a dead peer's prevote cannot see
  the polka a locked proposer re-proposes on.  The engine keeps the votes
  of the heights being decided, its own and those it delivered, and
  sends them again every ``REFLOOD_S`` while the height does not advance,
  to each peer whose link is idle (more on a backlogged link would only
  delay it further); a receiver that has one drops it by its content
  hash.  A
  proposal is not sent again: a round that lost its proposal times out
  and the next round brings another, and a proposal carries the block
  (over a megabyte of hex at k = 64), so sending proposals again turns a
  mesh that is slow into one that stalls.
- **Messages of the next heights held.**  The flood's dedup delivers a
  message once, so one for a height the BFT engine has not started (a
  faster peer already there) must not be dropped: the engine
  (node/bft.py ``BFTNode.receive``) holds those of the next two heights
  and handles each when its height starts.  The reference drops them.
- **Own timers.**  Tendermint's liveness comes from timeouts; the engine
  schedules each requested (step, height, round) timeout on its own wall
  clock with the standard round-escalating duration, so a dead peer or
  a dead relay never freezes the round clock (timers fire FIRST in the
  pump, before any RPC work).
- **Want/have tx gossip** (specs/cat_pool.md "Gossip"): a pooled tx is
  ANNOUNCED by hash; peers reply with the subset they lack; only those
  raw bytes are pushed, and the receiver re-announces onward.  A pushed
  tx that fails CheckTx is NOT marked seen — admission can succeed later
  (e.g. a sequence gap fills), and the periodic full-pool re-announce
  heals any such gap.
- **Certificate-verified catch-up.**  A validator that sees traffic for
  heights ahead of its own pulls the decided blocks from peers and
  adopts them ONLY after verifying the 2/3 precommit certificate
  (``bft_catchup`` -> ``engine.adopt_decision``) — peers are untrusted.
  A failed pull or a malformed wire is the serving peer's fault and opens
  its breaker; a failed adoption of well-formed blocks (the batched
  extension on the node's device among its causes) is the node's own and
  ends it: the engine stops and calls ``on_failure`` (``cli start`` passes
  ``NodeServer.fail``, so ``/healthz`` reports the node failed and the
  process exits 1).  The reference notes it as a peer fault and goes on.
- **A failed proposal ends the node.**  A PrepareProposal that raises
  (``bft.ProposeFailed``, from a round's start, a timeout or a message
  that moves the round) ends the node the same way; the reference's
  validator forfeits the round and goes on.

The ``bft-relay`` CLI demotes to bootstrap/observer: kill it mid-run and
the mesh keeps committing (tests/test_torch_gossip.py).

Reference role: celestia-core's p2p reactors — consensus gossip + the
CAT mempool protocol (SURVEY §2.2 consensus engine row;
specs/src/specs/cat_pool.md).
"""

from __future__ import annotations

import hashlib
import json
import random as _random
import threading
import time as _time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from celestia_tpu_torch.node.bft import MalformedWire, ProposeFailed
from celestia_tpu_torch.utils import faults, tracing
from celestia_tpu_torch.utils.logging import Logger
from celestia_tpu_torch.utils.lru import LruCache, bytes_len_weigher

_log = Logger(level="warn")

# seconds a height may stall before its votes are flooded again (see the
# module docstring)
REFLOOD_S = 2.0


class NodeFailed(Exception):
    """The node failed to adopt blocks it pulled (not the serving peer's
    fault): the engine has stopped and reported the cause."""


def wire_id(wire: dict) -> bytes:
    """Content address of a consensus wire message (dedup key)."""
    return hashlib.sha256(
        json.dumps(wire, sort_keys=True).encode()
    ).digest()


class _SeenSet:
    """Bounded membership set (flood dedup) on the unified LRU.

    ``add`` is the atomic check-then-insert the flood path needs
    (LruCache.add_if_absent); a re-announce of a seen id refreshes its
    recency, so actively flooded messages outlive one-shot noise."""

    def __init__(self, maxlen: int = 65536, name: str = "gossip_seen"):
        self._lru = LruCache(name, maxlen, weigher=bytes_len_weigher)

    def add(self, key: bytes) -> bool:
        """True if newly added, False if already present."""
        return self._lru.add_if_absent(key)

    def __contains__(self, key: bytes) -> bool:
        return key in self._lru


class _PeerLink:
    """One peer's outbound lane: a bounded queue + worker thread.  All
    RPCs to this peer happen here, so a hung peer stalls only itself."""

    def __init__(self, engine: "GossipEngine", addr: str, maxlen: int = 4096):
        self.engine = engine
        self.addr = addr
        self._q: deque = deque(maxlen=maxlen)  # drop-oldest on overflow
        self.dropped = 0  # messages shed by backpressure (observable)
        self._qlock = threading.Lock()
        self._event = threading.Event()
        self._stop = threading.Event()
        self._client = None
        self._thread = threading.Thread(
            target=self._run, name=f"gossip-peer-{addr}", daemon=True
        )
        self._thread.start()

    def send(self, kind: str, data) -> None:
        # a full deque sheds its oldest item on append; count it so
        # silent consensus-message loss on a congested link shows up in
        # logs/telemetry instead of only as mysterious round timeouts.
        # Producers (pump + gRPC threads) and the consumer both take
        # _qlock, so the len check is exact, not check-then-act.
        with self._qlock:
            if len(self._q) == self._q.maxlen:
                self.dropped += 1
                dropped = self.dropped
            else:
                dropped = 0
            self._q.append((kind, data))
        if dropped and (dropped == 1 or dropped % 256 == 0):
            self.engine.log.warn(
                "gossip peer backpressure: dropping oldest",
                peer=self.addr, dropped=dropped,
            )
        self._event.set()

    def stop(self) -> None:
        self._stop.set()
        self._event.set()
        self._thread.join(timeout=5)

    def _ensure_client(self):
        if self._client is None:
            from celestia_tpu_torch.node.remote import RemoteNode

            try:
                self._client = RemoteNode(
                    self.addr, timeout_s=self.engine.client_timeout_s
                )
            except Exception:
                self._client = None
        return self._client

    def _drop_client(self) -> None:
        if self._client is not None:
            try:
                self._client.close()
            except Exception as e:
                faults.note("gossip.link", e)
            self._client = None

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._q:
                self._event.wait(timeout=0.2)
                self._event.clear()
                continue
            with self._qlock:
                try:
                    kind, data = self._q.popleft()
                except IndexError:
                    continue
            cli = self._ensure_client()
            if cli is None:
                # peer down; the item is dropped (flood re-sends) and the
                # failure counts toward PEX-learned-address eviction
                self.engine._peer_failed(self.addr)
                continue
            try:
                if kind == "msg":
                    cli.gossip_msg(data)
                elif kind == "announce":
                    hashes, by_hash = data
                    want = cli.tx_have(hashes)
                    if want:
                        cli.tx_push(
                            [by_hash[h] for h in want if h in by_hash]
                        )
                elif kind == "pex":
                    learned = cli.peer_exchange(
                        self.engine._self_name(), data
                    )
                    self.engine._merge_peers([self.addr] + list(learned))
                self.engine._peer_ok(self.addr)
            except Exception:
                self._drop_client()
                self.engine._peer_failed(self.addr)


class GossipEngine:
    """One validator process's p2p overlay: floods consensus messages,
    runs the round timers, gossips txs want/have, and self-paces block
    production.  Attach to a BFT-enabled TestNode; the NodeServer routes
    the Gossip*/Tx* RPCs here via ``node.gossip_engine``."""

    def __init__(
        self,
        node,
        peer_addrs: List[str],
        *,
        tick_s: float = 0.02,
        base_timeout_s: float = 0.4,
        timeout_delta_s: float = 0.2,
        block_gap_s: float = 0.0,
        client_timeout_s: float = 5.0,
        reannounce_s: float = 2.0,
        fanout: int = 8,
        max_peers: int = 64,
        pex_interval_s: float = 1.0,
        chunk_retry_deadline_s: float = 10.0,
        catchup_batch: Optional[int] = None,
        logger=None,
        on_failure: Optional[Callable[[BaseException, str], None]] = None,
    ):
        self.node = node
        # called once with the error when an adoption fails (see _adopt)
        self.on_failure = on_failure
        self.failure: Optional[BaseException] = None
        self.log = logger if logger is not None else _log
        self.peer_addrs = list(dict.fromkeys(peer_addrs))
        # operator-configured addresses are never evicted; PEX-learned
        # ones are dropped after repeated delivery failures so a poisoned
        # address book drains instead of eclipsing honest peers forever
        self._static_peers = set(self.peer_addrs)
        self._peer_failures: Dict[str, int] = {}
        self._evict_after = 5
        self.fanout = max(1, fanout)
        self.max_peers = max_peers
        self.pex_interval_s = pex_interval_s
        self._last_pex = 0.0
        self._pex_rr = 0  # round-robin cursor over peers for PEX
        self._catch_up_thread: Optional[threading.Thread] = None
        # per-peer circuit breakers over the catch-up/state-sync pulls
        # (the unified policy layer, utils/faults.py): one failure opens
        # the peer for 10 s (the cooldown semantics), resource-bound
        # violations trip it for 60 s via trip()
        self._breakers = faults.BreakerRegistry(
            failures_to_open=1, cooldown_s=10.0
        )
        self.chunk_retry_deadline_s = chunk_retry_deadline_s
        # decided blocks adopted per batched catch-up step: the window's
        # same-k extends run as ONE mesh dispatch (BASELINE config #5 —
        # node.bft_catchup_batch); 1 restores the per-block behavior.
        # Default sized to the warmable EDS-cache budget (max_entries
        # minus the reserved min-DAH slot) so a full window's warm never
        # truncates — a window one larger would pay a per-block extend
        # for its last block on EVERY step and fire the truncation
        # telemetry continuously during normal catch-up
        # The budget is the content cache of the node's App device (one
        # per device in this package).
        if catchup_batch is None:
            from celestia_tpu_torch.da import eds_cache

            catchup_batch = min(
                8, eds_cache.content_cache(node.app.device).max_entries - 1
            )
        self.catchup_batch = max(1, catchup_batch)
        # drops from links that no longer exist (evicted peers) — keeps
        # dropped_total monotonic for monitoring deltas
        self._dropped_closed = 0
        self.tick_s = tick_s
        self.base_timeout_s = base_timeout_s
        self.timeout_delta_s = timeout_delta_s
        self.block_gap_s = block_gap_s
        self.client_timeout_s = client_timeout_s
        self.reannounce_s = reannounce_s
        # votes sent and delivered (bounded), flooded again every
        # REFLOOD_S while the height does not advance (_pump_once)
        self._recent: deque = deque(maxlen=1024)
        # messages of the heights after the engine's, held (on_gossip)
        self._reflood_height = -1
        self._last_reflood = 0.0
        self._links: Dict[str, _PeerLink] = {}
        self._pull_clients: Dict[str, object] = {}
        self._seen = _SeenSet(name="gossip_seen")
        self._seen_tx = _SeenSet(name="gossip_seen_tx")
        self._announced = _SeenSet(name="gossip_announced")
        # timers: (due, step, height, round); key-dedup in _timer_keys
        self._timers: List[Tuple[float, str, int, int]] = []
        self._timer_keys: set = set()
        self._behind_hint = 0  # highest height seen in foreign traffic
        self._last_start = 0.0
        self._last_reannounce = 0.0
        self._last_status_poll = 0.0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        node.gossip_engine = self

    # -- peer links ------------------------------------------------------

    def _link(self, addr: str) -> _PeerLink:
        # pump + gRPC server threads both create links; the lock keeps a
        # racing double-create from orphaning a worker thread
        with self._lock:
            link = self._links.get(addr)
            if link is None:
                link = _PeerLink(self, addr)
                self._links[addr] = link
            return link

    def _peers_snapshot(self, exclude: Optional[str] = None) -> List[str]:
        with self._lock:
            return [a for a in self.peer_addrs if a != exclude]

    # at most this many NEW addresses are admitted per PEX exchange, so
    # one malicious reply cannot fill the whole book in a single swap
    _PEX_BATCH_LIMIT = 8

    @staticmethod
    def _normalize_addr(addr: str) -> Optional[str]:
        """Canonical dialable form, or None for junk: rejects wildcard
        binds (0.0.0.0 / ::) that would make a peer dial itself, and
        folds the localhost alias so the self-filter can't be bypassed
        by spelling."""
        if not isinstance(addr, str) or len(addr) > 128 or ":" not in addr:
            return None
        host, _, port = addr.rpartition(":")
        if not port.isdigit():
            return None
        if host in ("0.0.0.0", "::", "[::]", ""):
            return None
        if host == "localhost":
            host = "127.0.0.1"
        return f"{host}:{port}"

    def _merge_peers(self, addrs) -> None:
        """Admit newly-learned peer addresses (PEX): normalized, bounded
        per exchange (_PEX_BATCH_LIMIT) and in total (max_peers); dead
        entries are evicted by _peer_failed, so garbage costs bounded
        slots for a bounded time, not permanent book space."""
        me = self._self_name()
        admitted = 0
        with self._lock:
            known = set(self.peer_addrs)
            for addr in addrs:
                addr = self._normalize_addr(addr)
                if addr is None or addr == me or addr in known:
                    continue
                if (
                    len(self.peer_addrs) >= self.max_peers
                    or admitted >= self._PEX_BATCH_LIMIT
                ):
                    break
                self.peer_addrs.append(addr)
                known.add(addr)
                admitted += 1

    def _peer_ok(self, addr: str) -> None:
        with self._lock:
            self._peer_failures.pop(addr, None)

    def _peer_failed(self, addr: str) -> None:
        """Called by a peer's link worker after a failed delivery.  A
        PEX-learned address that keeps failing is evicted (its link
        worker winds down on its own); operator-configured seeds are
        kept — the flood keeps retrying them."""
        with self._lock:
            n = self._peer_failures.get(addr, 0) + 1
            self._peer_failures[addr] = n
            if addr in self._static_peers or n < self._evict_after:
                return
            if addr in self.peer_addrs:
                self.peer_addrs.remove(addr)
            self._peer_failures.pop(addr, None)
            link = self._links.pop(addr, None)
            if link is not None:
                self._dropped_closed += link.dropped
        if link is not None:
            self._breakers.drop(addr)
            link._stop.set()  # worker exits on its own; never join here
            link._event.set()
            # drop the cached catch-up client too: an evicted address
            # must not keep an open channel/fd behind (its cost really
            # is "bounded slots for a bounded time")
            self._drop_pull_client(addr)
            self.log.warn("evicted unresponsive PEX-learned peer", peer=addr)

    def _flood(self, wire: dict, exclude: Optional[str] = None) -> None:
        payload = {"wire": wire, "sender": self._self_name()}
        if tracing.enabled():
            # optional envelope trace context (NEVER inside `wire`: the
            # dedup id is a content hash of the wire, and a per-hop
            # context stamped into it would defeat flood dedup).  Old
            # peers read wire/sender only and drop this silently.
            tc = tracing.wire_context(
                height=int(wire.get("height", 0) or 0)
            )
            if tc:
                payload["_tc"] = tc
        peers = self._peers_snapshot(exclude)
        if len(peers) > self.fanout:
            # epidemic spread: each hop re-floods to its own sample, so
            # a random subset per message covers the mesh w.h.p. while
            # links stay O(N * fanout) instead of O(N^2)
            peers = _random.sample(peers, self.fanout)
        for addr in peers:
            self._link(addr).send("msg", payload)

    # -- inbound RPC surface (called from server threads) ---------------

    def _wire_ok(self, wire: dict) -> bool:
        """Structural + signature validation BEFORE propagation: the
        sender is untrusted, so only messages signed by a known validator
        are delivered, re-flooded, or allowed into the dedup set — junk
        must neither amplify across the mesh nor evict legitimate dedup
        entries."""
        from celestia_tpu_torch.node.bft import (
            Proposal,
            msg_from_wire,
            proposal_sign_bytes,
            vote_sign_bytes,
        )
        from celestia_tpu_torch.utils.secp256k1 import PublicKey

        eng = self.node._bft
        if eng is None:
            return False
        try:
            msg = msg_from_wire(wire)
            if isinstance(msg, Proposal):
                pk = eng.pubkeys.get(msg.proposer)
                if pk is None:
                    return False
                digest = proposal_sign_bytes(
                    eng.chain_id, msg.height, msg.round, msg.pol_round,
                    msg.payload.block_id,
                )
                return PublicKey.from_compressed(pk).verify(
                    digest, msg.signature
                )
            pk = eng.pubkeys.get(msg.validator)
            if pk is None:
                return False
            digest = vote_sign_bytes(
                eng.chain_id, msg.height, msg.round, msg.vtype, msg.block_id
            )
            return PublicKey.from_compressed(pk).verify(digest, msg.signature)
        except Exception:
            return False

    def on_gossip(self, wire: dict, sender: str, tc=None) -> bool:
        """Deliver a flooded consensus message once; queue the re-flood.
        The dedup id is computed HERE from the wire bytes — a sender-
        supplied id could poison the dedup set (censorship) — and only
        validator-signed messages propagate.  Returns True if the
        message was new and valid.  ``tc`` is the optional envelope
        trace context of the SENDING hop (specs/observability.md): it
        only decorates the deliver span, never consensus handling."""
        msg_id = wire_id(wire)
        if msg_id in self._seen:
            return False
        if not self._wire_ok(wire):
            return False  # unsigned junk: not delivered, not flooded
        if not self._seen.add(msg_id):
            return False
        with self._lock:
            if wire.get("kind") == "vote":
                self._recent.append(wire)
            h = int(wire.get("height", 0) or 0)
            if h > self._behind_hint:
                # a hint, not a fact: _catch_up verifies against peers'
                # actual heights (a Byzantine validator can sign a vote
                # at any height it likes)
                self._behind_hint = h
        # span args are built only when the tracer is on: this is the
        # per-message flood hot path, and a NULL_SPAN must cost nothing
        span = (
            tracing.rpc_span(
                "gossip.deliver", tc, cat="gossip",
                kind=str(wire.get("kind", "")), height=h,
            )
            if tracing.enabled()
            else tracing.NULL_SPAN
        )
        with span:
            self._deliver(wire)
            self._flood(wire, exclude=sender)
        return True

    def _deliver(self, wire: dict) -> None:
        try:
            self.node.bft_msg(wire)
        except ProposeFailed as e:
            self._fail(e, "propose")
        except Exception as e:
            # engine rejects bad messages; a raise must not kill the RPC
            # thread — but the failure lands in telemetry, never silently
            faults.note("gossip.deliver", e)

    def stats(self) -> dict:
        """Operational snapshot for the status RPC: address-book size,
        PEX-learned vs operator-configured split, and total messages
        shed by per-peer backpressure (the observable form of the
        drop-oldest queues)."""
        with self._lock:
            peers = len(self.peer_addrs)
            static = len(self._static_peers & set(self.peer_addrs))
            links = list(self._links.values())
            dropped_closed = self._dropped_closed
        return {
            "peers": peers,
            "static_peers": static,
            "pex_learned": peers - static,
            "fanout": self.fanout,
            # monotonic: includes links already closed by eviction
            "dropped_total": dropped_closed
            + sum(link.dropped for link in links),
            # per-peer circuit-breaker states over the pull plane
            "pull_breakers": self._breakers.stats(),
        }

    def on_peer_exchange(self, sender: str, peers: List[str]) -> List[str]:
        """PEX inbound: learn the sender + its peers, return our list so
        the exchange is symmetric.  Called from gRPC server threads."""
        self._merge_peers([sender] + list(peers))
        return self._peers_snapshot()

    def on_tx_have(self, hashes: List[bytes]) -> List[bytes]:
        """want/have: return the subset of announced tx hashes this node
        does not hold."""
        want = []
        pool = self.node.mempool
        # snapshot the key set under the node lock once: CheckTx
        # admissions and commit-time removals mutate the dict from other
        # gRPC threads (same discipline as _announce_txs)
        with self.node._service_lock:
            pooled = set(pool._txs)
        for h in hashes:
            if h in pooled or h in self._seen_tx:
                continue
            if self.node.get_tx(h) is not None:
                continue  # already committed
            want.append(h)
        return want

    def on_tx_push(self, raws: List[bytes]) -> int:
        """Admit pushed txs through the batched CheckTx plane; re-announce
        admitted ones.  The whole pending push drains through ONE
        ``broadcast_txs_batch`` call (single verify_batch pass over all
        fresh signatures) instead of looping per-tx CheckTx.  A failed
        admission is NOT marked seen: it may succeed later (sequence
        gaps), and the periodic re-announce retries it."""
        fresh: List[bytes] = []
        fresh_hashes: List[bytes] = []
        for raw in raws:
            h = hashlib.sha256(raw).digest()
            if h in self._seen_tx:
                continue
            fresh.append(raw)
            fresh_hashes.append(h)
        if not fresh:
            return 0
        admitted = 0
        try:
            results = self.node.broadcast_txs_batch(fresh)
        except Exception as e:
            # batch-layer failure (not a per-tx verdict): note it and
            # degrade to the per-tx loop so one poisoned raw cannot
            # starve its neighbors
            faults.note("gossip.txpush", e)
            results = []
            for raw in fresh:
                try:
                    results.append(self.node.broadcast_tx(raw))
                except Exception as e:  # noqa: PERF203 - per-tx isolation
                    faults.note("gossip.txpush", e)
                    results.append(None)
        for h, res in zip(fresh_hashes, results):
            if res is not None and res.code == 0:
                self._seen_tx.add(h)
                admitted += 1
        return admitted

    # -- the pump loop ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="gossip-pump", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        t = self._catch_up_thread
        if t is not None and t.is_alive():
            t.join(timeout=5)
        # a link's worker may still evict its peer (_peer_failed) while
        # the others are stopped: take the links out under the lock first
        with self._lock:
            links = list(self._links.values())
            self._links.clear()
        for link in links:
            link.stop()
        for addr in list(self._pull_clients):
            self._drop_pull_client(addr)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._pump_once()
            except Exception as e:
                # the mesh must survive transient RPC storms — recorded,
                # never silently dropped (celint R5 contract)
                faults.note("gossip.pump", e)
            # fixed-cadence pump tick, not a retry loop
            # celint: allow(sanctioned-retry) — the pump's pacing sleep: timers/floods tick at tick_s by design
            _time.sleep(self.tick_s)

    def _pump_once(self) -> None:
        now = _time.time()
        # 1. fire due timers FIRST — liveness must not wait on any RPC
        with self._lock:
            due_now = [t for t in self._timers if t[0] <= now]
            self._timers = [t for t in self._timers if t[0] > now]
            for _, s, h, r in due_now:
                self._timer_keys.discard((s, h, r))
        for _, step, height, round_ in due_now:
            try:
                self.node.bft_timeout(step, height, round_)
            except ProposeFailed as e:
                self._fail(e, "propose")
                return
            except Exception as e:
                faults.note("gossip.timer", e)
        # 2. start the next height when the current one is decided
        if self.node._bft is not None and (
            now - self._last_start >= self.block_gap_s
        ):
            target = self.node.height + 1
            if self.node._bft.height < target:
                try:
                    self.node.bft_start(target)
                    self._last_start = now
                except ProposeFailed as e:
                    self._fail(e, "propose")
                    return
                except Exception as e:
                    faults.note("gossip.start", e)
        # 3. drain own outbox + timeout requests; enqueue floods
        d = self.node.bft_drain()
        if d["height"] != self._reflood_height:
            # a height was decided: drop what it decided
            self._reflood_height, self._last_reflood = d["height"], now
            with self._lock:
                self._recent = deque(
                    (w for w in self._recent
                     if int(w.get("height", 0) or 0) > d["height"]),
                    maxlen=self._recent.maxlen,
                )
        for wire in d["outbox"]:
            self._seen.add(wire_id(wire))  # don't re-deliver our own
            self._flood(wire)
            if wire.get("kind") == "vote":
                with self._lock:
                    self._recent.append(wire)
        if now - self._last_reflood >= REFLOOD_S:
            # the height stalled: a peer may have missed these for good.
            # Only to peers whose link is idle: a backlogged link already
            # delivers late, and more on it would only delay the rest
            self._last_reflood = now
            with self._lock:
                pending = [w for w in self._recent
                           if int(w.get("height", 0) or 0) > d["height"]]
                idle = [a for a in self.peer_addrs
                        if a not in self._links or not self._links[a]._q]
            me = self._self_name()
            for addr in idle if pending else ():
                link = self._link(addr)
                for wire in pending:
                    link.send("msg", {"wire": wire, "sender": me})
        with self._lock:
            for t in d["timeouts"]:
                key = (t["step"], t["height"], t["round"])
                if key not in self._timer_keys:
                    self._timer_keys.add(key)
                    due = now + self.base_timeout_s + (
                        self.timeout_delta_s * t["round"]
                    )
                    self._timers.append((due, *key))
        # 4. announce pooled txs (fresh every tick; full pool periodically)
        self._announce_txs(now)
        # 5. catch-up pull when traffic shows we're behind — on its OWN
        # thread: peer addresses can be PEX-learned (untrusted), and a
        # book full of black holes must never stall the pump loop whose
        # first job is firing the round timers
        self._maybe_catch_up()
        # 6. PEX: swap peer lists with one peer (round-robin) per
        # interval — the exchange runs on that peer's link worker, so a
        # dead peer can never stall the pump or the round timers
        if now - self._last_pex >= self.pex_interval_s:
            self._last_pex = now
            peers = self._peers_snapshot()
            if peers:
                target = peers[self._pex_rr % len(peers)]
                self._pex_rr += 1
                self._link(target).send("pex", peers)

    def _self_name(self) -> str:
        return getattr(self.node, "_server_address", "") or "peer"

    def _announce_txs(self, now: float) -> None:
        pool = self.node.mempool
        full = now - self._last_reannounce >= self.reannounce_s
        if full:
            self._last_reannounce = now
        # snapshot under the node lock: gRPC workers mutate the pool
        # concurrently (CheckTx admissions, commit-time removals)
        with self.node._service_lock:
            items = [(h, t.raw) for h, t in pool._txs.items()]
        batch = []
        for h, raw in items:
            if self._announced.add(h) or full:
                batch.append((h, raw))
        if not batch:
            return
        hashes = [h for h, _ in batch]
        by_hash = dict(batch)
        peers = self._peers_snapshot()
        if len(peers) > self.fanout:
            # receivers re-announce admitted txs and the periodic full
            # re-announce rotates samples, so fanout-bounded want/have
            # still reaches everyone
            peers = _random.sample(peers, self.fanout)
        for addr in peers:
            self._link(addr).send("announce", (hashes, by_hash))

    def _pull_client(self, addr: str):
        cli = self._pull_clients.get(addr)
        if cli is None:
            from celestia_tpu_torch.node.remote import RemoteNode

            try:
                cli = RemoteNode(addr, timeout_s=self.client_timeout_s)
            except Exception:
                return None
            self._pull_clients[addr] = cli
        return cli

    def _drop_pull_client(self, addr: str) -> None:
        cli = self._pull_clients.pop(addr, None)
        if cli is not None:
            try:
                cli.close()
            except Exception as e:
                faults.note("gossip.link", e)

    def _maybe_catch_up(self) -> None:
        """Spawn at most one background catch-up worker when behind.
        The pump thread never blocks on a peer RPC."""
        now = _time.time()
        with self._lock:
            behind = self._behind_hint
        if self.node.height + 1 >= behind:
            return
        if now - self._last_status_poll < 0.5:
            return
        t = self._catch_up_thread
        if t is not None and t.is_alive():
            return
        self._last_status_poll = now
        t = threading.Thread(
            target=self._catch_up, name="gossip-catchup", daemon=True
        )
        self._catch_up_thread = t
        t.start()

    def _pull_rpc(self, fn, *args):
        """Every catch-up/state-sync pull RPC funnels through here: the
        ``gossip.fetch`` fault point lives at the top, so the chaos suite
        can make any pull flaky without touching peer code — and the
        ``gossip.fetch`` span makes every pull visible on the trace."""
        with tracing.span(
            "gossip.fetch", cat="gossip",
            rpc=getattr(fn, "__name__", "rpc"),
        ):
            faults.fire("gossip.fetch")
            return fn(*args)

    def _catch_up(self) -> None:
        """Pull decided blocks we're missing (background worker, direct
        blocking RPCs).  Unreachable peers open their circuit breaker so
        a poisoned address book costs each poll a bounded set of dial
        attempts (utils/faults.BreakerRegistry — the unified policy
        layer; resource-bound violators are tripped for 60 s).

        The wire-derived hint only TRIGGERS the check; the pull target
        is the peers' actually-reported best height (rate-limited status
        poll), so a Byzantine validator signing sky-high vote heights
        cannot lock the mesh into a permanent catch-up loop — a hint no
        reachable peer corroborates is discarded."""
        best = 0
        peers = [
            a for a in self._peers_snapshot() if self._breakers.allow(a)
        ]
        for addr in peers:
            cli = self._pull_client(addr)
            if cli is None:
                self._breakers.record_failure(addr)
                continue
            try:
                best = max(
                    best, int(self._pull_rpc(cli.status).get("height", 0))
                )
                self._breakers.record_ok(addr)
            except Exception as e:
                faults.note("gossip.fetch", e)
                self._drop_pull_client(addr)
                self._breakers.record_failure(addr)
        if best <= self.node.height:
            with self._lock:
                # nobody is actually ahead: the hint was noise
                self._behind_hint = self.node.height
            return
        target = best
        for addr in peers:
            if self.node.height >= target:
                return
            if not self._breakers.available(addr):
                continue  # opened by the status poll above
            cli = self._pull_client(addr)
            if cli is None:
                self._breakers.record_failure(addr)
                continue
            try:
                while self.node.height < target:
                    # pull a WINDOW of decided blocks, then adopt them in
                    # one batched step: the window's same-k extends run
                    # as one mesh dispatch instead of one per block
                    # (testnode.bft_catchup_batch; the RPCs stay one per
                    # block — the device dispatch is what batches)
                    wires = []
                    lo = self.node.height + 1
                    hi = min(target, lo + self.catchup_batch - 1)
                    for h in range(lo, hi + 1):
                        try:
                            d = self._pull_rpc(cli.bft_decided, h)
                        except Exception:
                            if not wires:
                                raise  # same failure path as per-block
                            # a mid-window RPC failure must not discard
                            # the wires already pulled: adopt the
                            # partial window; the next window (or the
                            # empty-window raise above) retries h
                            break
                        if d is None:
                            break
                        wires.append(d)
                    if not wires:
                        # the peer has pruned past our height: a node
                        # offline longer than the decided-log window
                        # state-syncs from a served snapshot, then
                        # resumes certificate replay from there
                        if not self._try_state_sync(cli, addr):
                            break
                        continue
                    adopted, _why = self._adopt(
                        self.node.bft_catchup_batch, wires
                    )
                    if adopted < len(wires):
                        break
            except NodeFailed:
                return
            except Exception as e:
                faults.note("gossip.fetch", e)
                self._drop_pull_client(addr)
                self._breakers.record_failure(addr)

    def _adopt(self, fn, *args):
        """``fn(*args)``, an adoption of pulled blocks.  A malformed wire
        raises to the caller (the serving peer's fault).  Any other
        failure is the node's own: the engine stops, records it in
        ``failure``, calls ``on_failure`` and raises :class:`NodeFailed`.
        Departure from the reference, which notes it as a peer fault."""
        try:
            return fn(*args)
        except MalformedWire:
            raise
        except Exception as e:
            self._fail(e, "catchup")
            raise NodeFailed(repr(e)) from e

    def _fail(self, exc: BaseException, where: str) -> None:
        """The node's own work failed (``where``: "catchup", "propose"):
        stop the engine, keep the cause in ``failure`` and hand it to
        ``on_failure``."""
        if self.failure is not None:
            return
        self.log.error(f"{where} failed; stopping", err=repr(exc))
        self.failure = exc
        self._stop.set()  # the pump ends at its next tick
        if self.on_failure is not None:
            self.on_failure(exc, where)

    def _alt_snapshot_clients(self, exclude: str, limit: int = 2) -> list:
        """Up to ``limit`` other reachable peers' pull clients — the
        re-fetch sources for a chunk the primary served corrupt."""
        out = []
        for addr in self._peers_snapshot(exclude=exclude or None):
            if len(out) >= limit:
                break
            if not self._breakers.available(addr):
                continue
            cli = self._pull_client(addr)
            if cli is not None:
                out.append(cli)
        return out

    def _fetch_snapshot_chunks(self, cli, meta: dict, alt_clis=()) -> list:
        """Download one snapshot's chunks with per-chunk resource bounds:
        every chunk is size-capped BEFORE its hash check —
        the writer never produces a chunk above MAX_WIRE_CHUNK_BYTES, so
        an oversized payload is hostile and raises SnapshotLimitError
        immediately (never retried).

        A TRANSFER-corrupt or missing chunk, by contrast, is transient:
        the chunk is marked bad and re-fetched — from a DIFFERENT peer
        first when alternates exist — under the unified RetryPolicy, and
        the download aborts only once a chunk exhausts its deadline
        budget (``chunk_retry_deadline_s``)."""
        from celestia_tpu_torch.node.snapshots import (
            MAX_WIRE_CHUNK_BYTES,
            SnapshotLimitError,
        )

        n_chunks = int(meta["chunks"])
        sources = [cli, *alt_clis]
        chunks = []
        for i in range(n_chunks):
            turn = [0]

            def fetch_once(i=i, turn=turn):
                # rotate sources: attempt 0 is the primary, each retry
                # moves to the next peer (wrapping), so a peer serving
                # bit-flipped bytes cannot fail the restore on its own
                src = sources[turn[0] % len(sources)]
                turn[0] += 1
                with tracing.span(
                    "snapshot.chunk_fetch", cat="gossip",
                    chunk=i, attempt=turn[0],
                    height=int(meta["height"]),
                ):
                    faults.fire("snapshots.chunk")
                    c = src.snapshot_chunk(
                        int(meta["height"]), int(meta.get("format", 1)), i
                    )
                    if c is None:
                        raise ValueError(f"peer missing chunk {i}")
                    if len(c) > MAX_WIRE_CHUNK_BYTES:
                        raise SnapshotLimitError(
                            f"chunk {i} is {len(c)} bytes "
                            f"(cap {MAX_WIRE_CHUNK_BYTES})"
                        )
                    c = faults.corrupt("snapshots.chunk", c)
                    if hashlib.sha256(c).hexdigest() != meta["chunk_hashes"][i]:
                        raise ValueError(f"chunk {i} corrupt in transfer")
                    return c

            policy = faults.RetryPolicy(
                attempts=max(2, 2 * len(sources)),
                base_s=0.02,
                cap_s=0.5,
                deadline_s=self.chunk_retry_deadline_s,
            )
            chunks.append(
                policy.run(
                    fetch_once,
                    no_retry_on=(SnapshotLimitError,),
                    on_retry=lambda n, e, i=i: self.log.warn(
                        "snapshot chunk re-fetch", chunk=i, attempt=n,
                        err=str(e)[:120],
                    ),
                )
            )
        return chunks

    def _try_state_sync(self, cli, addr: str = "") -> bool:
        """Network state-sync (the reference serves
        snapshots to syncing peers, root.go:227-243 +
        default_overrides.go:296-297).  Trust order matters: the
        anchoring certificate (decided block at snapshot height + 1,
        2/3-signed, committing to the snapshot's app hash via
        prev_app_hash) is verified BEFORE any chunk is applied — a
        malicious snapshot can never swap state in."""
        from celestia_tpu_torch.node.snapshots import (
            SnapshotLimitError,
            SnapshotStore,
        )

        try:
            metas = self._pull_rpc(cli.snapshot_list)
        except Exception as e:
            faults.note("gossip.fetch", e)
            return False
        metas = [
            m for m in metas if int(m.get("height", 0)) > self.node.height
        ]
        # the metas LIST is peer-supplied and unbounded: only try the few
        # newest (honest servers keep ~2 recent snapshots), so one peer
        # cannot chain hundreds of 512 MiB download attempts
        metas = sorted(metas, key=lambda m: -int(m.get("height", 0)))[:3]
        for meta in metas:
            downloaded = False
            try:
                anchor = cli.bft_decided(int(meta["height"]) + 1)
                if anchor is None:
                    continue
                ok, why = self.node.verify_state_sync_anchor(meta, anchor)
                if not ok:
                    self.log.warn(
                        "state-sync snapshot rejected", reason=why,
                        height=meta.get("height"),
                    )
                    continue
                n_chunks = int(meta["chunks"])
                # the chunk COUNT is peer-supplied and not covered by the
                # anchor certificate: bound it so one peer cannot force
                # unbounded download/memory per sync attempt (with the
                # per-chunk byte bound in _fetch_snapshot_chunks this
                # caps a sync attempt at 512 MiB on the wire, far above
                # any real app state)
                if n_chunks > 512 or len(meta.get("chunk_hashes", [])) != (
                    n_chunks
                ):
                    raise ValueError(
                        f"implausible snapshot shape: {n_chunks} chunks"
                    )
                chunks = self._fetch_snapshot_chunks(
                    cli, meta, self._alt_snapshot_clients(addr)
                )
                downloaded = True
                data = SnapshotStore.assemble(meta, chunks)
                self.node.adopt_state_sync(meta, data)
                # apply the anchor block (parsed by the anchor check above)
                self._adopt(self.node.bft_catchup, anchor)
                self.log.warn(
                    "state-synced from peer snapshot",
                    height=meta["height"],
                )
                return True
            except NodeFailed:
                raise
            except SnapshotLimitError as e:
                # resource-bound violation: no honest peer serves this —
                # abort the whole sync attempt and cool the peer down
                # much longer than a transient failure
                self.log.warn(
                    "state-sync peer exceeded resource bounds; backing off",
                    err=str(e)[:200], peer=addr,
                )
                if addr:
                    self._breakers.trip(addr, 60.0)
                return False
            except Exception as e:
                self.log.warn("state-sync attempt failed", err=str(e)[:200])
                if downloaded:
                    # the peer served a COMPLETE, hash-consistent snapshot
                    # that still failed to apply (bad app hash / state):
                    # hostile or corrupt — don't burn another full
                    # download on its next meta this attempt
                    if addr:
                        self._breakers.trip(addr, 60.0)
                    return False
                continue
        return False
