"""gRPC node service: the network boundary between clients and a node.

Role parity: the reference node exposes gRPC/RPC services that pkg/user's
Signer talks to (app/app.go:826-852 wires the API/gRPC services;
pkg/user/signer.go:278-309 broadcasts over gRPC and polls GetTx).  Here the
same surface is served with grpc generic handlers (no codegen): every method
is bytes -> bytes, with JSON envelopes for control-plane calls and raw tx
bytes for broadcast.

Methods (service ``celestia.tpu.v1.Node``):
  Broadcast    raw BlobTx/Tx bytes        -> {code, log, txhash}
  BroadcastBatch {"txs": [hex, ...]}      -> {"results": [{code, log,
               txhash}, ...]}: batched admission — one check_txs_batch
               pass (single verify_batch over fresh signatures) under
               one service-lock hold
  GetTx        {"hash": hex}              -> tx status or {"found": false}
  AccountInfo  {"address": hex}           -> {account_number, sequence}
  Simulate     raw tx bytes               -> {gas} | {code, log}
  Status       {}                         -> chain/app status
  Block        {"height": N}              -> header + tx hashes
  Query        {"path": str, "data": {}}  -> ABCI-style query routes,
               including the proof routes (custom/proof/share,
               custom/proof/tx — pkg/proof/querier.go parity).
  Metrics      {}                         -> Prometheus text exposition
               (counters, gauges, bounded histograms, cache registry —
               comet's DefaultMetricsProvider role — plus per-RPC
               byte/call counters, client-side RPC counters,
               fault/degradation totals, device-plane gauges
               (celestia_tpu_kernel_* / celestia_tpu_device_*), trace-ring
               health and alert states)
  TraceDump    {"last": N}                -> the last N block traces as
               Chrome trace-event JSON (utils/tracing.py; open the
               ``trace`` value directly in Perfetto)
  ClockProbe   {}                         -> {"ts", "node_id", "height"}:
               one telemetry-clock read for the cross-node midpoint
               offset probe (tracing.estimate_clock_offset)
  TimeSeries   {"last": N}                -> {"snapshots", "rates",
               "alerts", ...}: the bounded telemetry time-series ring
               (utils/timeseries.py) + the declarative alert engine's
               verdicts; every call records one fresh sample first, so
               two consecutive calls always yield a computable rate

  HostProfile  {"top": N, "folded": M}    -> the host sampling
               profiler's stats, top self-time frames and folded
               stacks (utils/hostprof.py)
  FlightList   {}                         -> kept incident-bundle
               manifests + recorder ring stats (utils/flight.py)
  FlightFetch  {"id": str}                -> one full incident bundle
               (manifest + every artifact as text; empty id = newest)

The same exposition is optionally served as PLAIN HTTP (``GET
/metrics`` on ``--metrics-port``; off by default) so a stock Prometheus
scrapes the node without speaking the custom gRPC framing, plus a
``GET /healthz`` JSON probe (node id, height, breakers open, alerts
firing, uptime) for load balancers and orchestrators.

Cross-node trace context: consensus, gossip, state-sync and DAS
requests may carry an optional ``"_tc"`` envelope field (specs/
observability.md "Distributed tracing").  Handlers read named keys, so
un-upgraded peers ignore the field and upgraded ones open an
``rpc.*`` span whose ``remote_node``/``remote_span`` args name the
caller's span — the explicit cross-node parent the trace merger folds
into flow events.  Every handler also counts ``rpc_{method}_calls`` and
``rpc_{method}_bytes_{in,out}`` into the node's telemetry.
"""

from __future__ import annotations

import hashlib
import json
import threading
from concurrent import futures
from typing import Dict, Optional

from celestia_tpu_torch.utils import faults, tracing

SERVICE = "celestia.tpu.v1.Node"


def _identity(b: bytes) -> bytes:
    return b


class _PeerRegistry:
    """Bounded per-peer DAS serving accounting (specs/da_serving.md
    "QoS lanes & per-peer accounting").

    Peer ids are CLIENT-ASSERTED (an optional ``"peer"`` envelope field
    on DasSample/DasSampleBatch — old clients simply stay anonymous),
    so the server bounds everything about them: ids are truncated to
    ``MAX_PEER_ID`` chars, at most ``max_peers`` peers are tracked on a
    :class:`~celestia_tpu_torch.utils.lru.LruCache` (label cardinality on the
    exposition is bounded by the same cap; an evicted peer's labels
    disappear from the scrape), and per-peer distinct-row tracking
    saturates at ``MAX_ROWS_TRACKED``.  Served/shed/bytes/rows feed the
    per-peer exposition lines and the Jain fairness index."""

    MAX_PEER_ID = 64
    MAX_ROWS_TRACKED = 512

    def __init__(self, max_peers: int = 256):
        from celestia_tpu_torch.utils.lru import LruCache

        self._lock = threading.Lock()
        # entries are mutable dicts mutated only under self._lock
        self._peers = LruCache("das_peers", max_entries=max(1, int(max_peers)))

    @classmethod
    def peer_id(cls, q) -> str:
        """The bounded peer id out of a request envelope ('' = anonymous)."""
        try:
            raw = q.get("peer", "")
        except Exception:
            return ""
        return str(raw or "")[: cls.MAX_PEER_ID]

    def _entry(self, peer: str) -> dict:
        # caller holds self._lock
        st = self._peers.get(peer, count=False)
        if st is None:
            st = {
                "served": 0, "shed": 0, "bytes": 0,
                "rows": set(), "rows_capped": False, "lane": "",
            }
            self._peers.put(peer, st)
        return st

    def record_served(self, peer, cells, bytes_out, rows=(), lane=None):
        if not peer:
            return
        with self._lock:
            st = self._entry(peer)
            st["served"] += int(cells)
            st["bytes"] += int(bytes_out)
            if lane:
                st["lane"] = str(lane)
            seen = st["rows"]
            for key in rows:
                if len(seen) >= self.MAX_ROWS_TRACKED:
                    st["rows_capped"] = True
                    break
                seen.add(key)

    def record_shed(self, peer, lane=None):
        if not peer:
            return
        with self._lock:
            st = self._entry(peer)
            st["shed"] += 1
            if lane:
                st["lane"] = str(lane)

    def snapshot(self) -> dict:
        """peer -> flat counters (no mutable internals escape the lock)."""
        with self._lock:
            out = {}
            for peer in self._peers.keys():
                st = self._peers.peek(peer)
                if st is None:  # raced an eviction
                    continue
                out[peer] = {
                    "served": st["served"],
                    "shed": st["shed"],
                    "bytes": st["bytes"],
                    "rows": len(st["rows"]),
                    "lane": st["lane"],
                }
            return out

    def fairness_index(self) -> Optional[float]:
        """Jain fairness over per-peer SERVED counts; None until at
        least one identified peer has been served (skip-absent: the
        metric must not exist before there is a distribution to judge)."""
        from celestia_tpu_torch.utils.telemetry import jain_fairness_index

        with self._lock:
            served = []
            for peer in self._peers.keys():
                st = self._peers.peek(peer)
                if st is not None:
                    served.append(st["served"])
        return jain_fairness_index(served)

    def exposition_lines(self) -> list:
        """Bounded-label per-peer exposition (cardinality capped by the
        registry's LRU bound, values escaped — always parse-valid)."""
        from celestia_tpu_torch.utils.telemetry import escape_label_value

        snap = self.snapshot()
        if not snap:
            return []
        lines = [
            "# TYPE celestia_tpu_das_peer_served_total counter",
            "# TYPE celestia_tpu_das_peer_shed_total counter",
            "# TYPE celestia_tpu_das_peer_bytes_total counter",
        ]
        for peer in sorted(snap):
            st = snap[peer]
            lbl = escape_label_value(peer)
            lines.append(
                f'celestia_tpu_das_peer_served_total{{peer="{lbl}"}} '
                f'{st["served"]}'
            )
            lines.append(
                f'celestia_tpu_das_peer_shed_total{{peer="{lbl}"}} '
                f'{st["shed"]}'
            )
            lines.append(
                f'celestia_tpu_das_peer_bytes_total{{peer="{lbl}"}} '
                f'{st["bytes"]}'
            )
            lines.append(
                f'celestia_tpu_das_peer_rows{{peer="{lbl}"}} {st["rows"]}'
            )
            if st["lane"]:
                lane = escape_label_value(st["lane"])
                lines.append(
                    f'celestia_tpu_das_peer_lane{{peer="{lbl}",'
                    f'lane="{lane}"}} 1'
                )
        return lines


class _BlockScorecardRing:
    """Bounded ring of per-height block scorecards.

    One row per height, merged from whatever legs THIS node actually
    saw: the proposer contributes prepare wall, a validator contributes
    process wall + the gossip propagation hop, and the commit RPC
    arrival stamps commit lag.  Rows are assembled incrementally (the
    lifecycle reaches a node as separate RPCs), and ``e2e_ms`` is
    always the sum of the parts known so far — a proposer-only row is
    an honest partial, not a lie.  Keys starting with ``_`` are
    internal (raw clock stamps for lag arithmetic) and stripped from
    served rows.
    """

    CAP = 64

    def __init__(self, cap: int = CAP):
        self._cap = int(cap)
        self._lock = threading.Lock()
        # height -> row; heights are monotonic, so height order IS the
        # arrival order and eviction drops the numerically oldest —
        # this is a ring, not a cache (no LRU touch semantics);
        # celint: guarded-by(self._lock)
        self._rows: Dict[int, dict] = {}
        # celint: guarded-by(self._lock)
        self._seen: set = set()

    def first_time(self, key) -> bool:
        """Dedupe gate for trace ingestion (ring re-reads repeat)."""
        with self._lock:
            if key in self._seen:
                return False
            if len(self._seen) > 8 * self._cap:
                self._seen.clear()
            self._seen.add(key)
            return True

    def _recompute(self, row: dict) -> None:
        e2e = 0.0
        for k in ("prepare_ms", "propagation_ms", "process_ms", "commit_lag_ms"):
            v = row.get(k)
            if v is not None:
                e2e += float(v)
        row["e2e_ms"] = round(e2e, 3)
        end = row.get("_end_ts")
        commit = row.get("_commit_ts")
        if end is not None and commit is not None and "commit_lag_ms" not in row:
            row["commit_lag_ms"] = round(max(0.0, commit - end) * 1000.0, 3)
            self._recompute(row)

    def update(self, height: int, **fields) -> dict:
        """Merge fields into the height's row (creating it), recompute
        the e2e rollup, trim the ring; returns a copy of the row."""
        with self._lock:
            row = self._rows.get(height)
            if row is None:
                row = {"height": int(height)}
                self._rows[height] = row
                if len(self._rows) > self._cap:
                    for h in sorted(self._rows)[: len(self._rows) - self._cap]:
                        del self._rows[h]
            row.update({k: v for k, v in fields.items() if v is not None})
            self._recompute(row)
            return dict(row)

    def note_commit(self, height: int, ts: float) -> dict:
        return self.update(height, _commit_ts=ts)

    def rows(self, last: Optional[int] = None) -> list:
        with self._lock:
            rows = [
                {k: v for k, v in self._rows[h].items() if not k.startswith("_")}
                for h in sorted(self._rows)
            ]
        if last is not None:
            rows = rows[-int(last):]
        return rows

    def latest(self) -> Optional[dict]:
        rows = self.rows(last=1)
        return rows[0] if rows else None


# extend-leg span name -> the scorecard's leg label
_EXTEND_LEGS = {
    "extend.native": "native",
    "extend.jax": "jax",
    "extend.sharded": "mesh",
    "extend.device_plane": "device_plane",
}


class NodeService:
    """Method implementations over an in-process node (TestNode surface)."""

    def __init__(
        self, node, das_max_inflight: int = 4, flight=None,
        das_qos: bool = False,
    ):
        from celestia_tpu_torch.utils import timeseries as ts_mod
        from celestia_tpu_torch.utils.telemetry import clock

        self.node = node
        # continuous telemetry: the bounded snapshot ring + the alert
        # engine (stock rules + operator-declared CELESTIA_TPU_TORCH_ALERT_RULES)
        self.timeseries = ts_mod.TimeSeries()
        self.alert_engine = ts_mod.AlertEngine(ts_mod.default_rules())
        for rule in ts_mod.rules_from_env():
            self.alert_engine.add_rule(rule)
        # block-lifecycle SLO plane (utils/timeseries.py): stock budgets
        # with CELESTIA_TPU_TORCH_SLO operator overrides — malformed config
        # raises HERE, at boot, not at the first breach.  SLO verdicts
        # ride the same firing-transition path as alert rules, so a
        # breach trips the flight recorder into an incident bundle.
        self.slos = ts_mod.effective_slos()
        # per-height block scorecard ring, fed from completed block
        # traces (prepare/process walls, extend leg, propagation hop,
        # commit lag, critical-path top contributors)
        self.scorecard = _BlockScorecardRing()
        # anomaly flight recorder (utils/flight.py): None unless the
        # operator gave --flight-dir; fed firing transitions from every
        # sampler tick / TimeSeries RPC below
        self.flight = flight
        # service birth (telemetry clock) for the /healthz uptime field
        self._t0 = clock()
        # the errors that ended the node (NodeServer.fail), by where they
        # arose ("producer", "catchup", "propose"): /healthz then reports
        # the node failed (departure from the reference)
        self.failures: Dict[str, str] = {}
        # DAS serving-plane admission (specs/robustness.md): sampling
        # requests above the inflight bound are SHED with a retry-after
        # hint instead of queueing behind the service lock until every
        # gRPC worker is wedged — the plane degrades, it never collapses.
        # The bound must stay BELOW the gRPC worker count (NodeServer
        # max_workers, default 8): with bound == workers no request can
        # ever observe a full gate and shedding silently never happens,
        # while consensus RPCs starve behind queued samples.
        # QoS lanes (opt-in, das_qos=True): the same gate capacity split
        # into a reserved `light` lane plus a shared pool `bulk` and
        # `hostile` compete for, with deterministic recent-usage tier
        # assignment — a flood of over-askers saturates the shared pool
        # but can never starve reserved light-lane admissions.  Off by
        # default: the degenerate single-lane gate is byte-for-byte the
        # pre-QoS weighted gate.
        if das_qos:
            reserved_light = max(1, int(das_max_inflight) // 2)
            self.das_gate = faults.LoadShedGate(
                max_inflight=das_max_inflight,
                retry_after_ms=25.0,
                lanes=(
                    (faults.TierPolicy.LIGHT, reserved_light),
                    (faults.TierPolicy.BULK, 0),
                    (faults.TierPolicy.HOSTILE, 0),
                ),
            )
            self.das_tiers: Optional[faults.TierPolicy] = faults.TierPolicy()
        else:
            self.das_gate = faults.LoadShedGate(
                max_inflight=das_max_inflight, retry_after_ms=25.0
            )
            self.das_tiers = None
        # per-peer serving accounting + per-tier end-to-end latency
        self.das_peers = _PeerRegistry()
        self._das_lat_lock = threading.Lock()
        self._das_lat: dict = {}  # lane -> Log2Histogram
        # backref for collect_node_sample (utils/timeseries.py): the
        # gate/fairness signals live on the service, the collector gets
        # the node
        node._das_service = self

    def _das_lane(self, peer: str, rows: int) -> Optional[str]:
        """Tier-assign one request: note the asked rows (demotion must
        see offered load, served or shed) and return the current lane
        (None when QoS lanes are off — the degenerate gate)."""
        if self.das_tiers is None:
            return None
        if peer:
            self.das_tiers.note(peer, rows=rows)
        return self.das_tiers.lane_for(peer)

    def _observe_das_latency(self, lane: Optional[str], t0: float) -> None:
        from celestia_tpu_torch.utils.telemetry import Log2Histogram, clock

        name = lane or faults.TierPolicy.LIGHT
        with self._das_lat_lock:
            hist = self._das_lat.get(name)
            if hist is None:
                hist = Log2Histogram()
                self._das_lat[name] = hist
        hist.observe(max(0.0, clock() - t0))

    def das_latency_summary(self) -> dict:
        """Per-tier end-to-end sample latency summary (lane ->
        count/p50/p99/... in ms)."""
        with self._das_lat_lock:
            items = sorted(self._das_lat.items())
        return {lane: hist.summary() for lane, hist in items}

    # -- handlers (bytes -> bytes) ------------------------------------

    def broadcast(self, raw: bytes, ctx) -> bytes:
        res = self.node.broadcast_tx(raw)
        return json.dumps(
            {"code": res.code, "log": res.log, "txhash": res.tx_hash.hex()}
        ).encode()

    def broadcast_batch(self, req: bytes, ctx) -> bytes:
        """Batched tx submission: the whole chunk drains through ONE
        check_txs_batch pass (single verify_batch over fresh signatures)
        under one service-lock hold; per-tx results in input order."""
        d = json.loads(req)
        raws = [bytes.fromhex(r) for r in d.get("txs", [])]
        results = self.node.broadcast_txs_batch(raws)
        return json.dumps(
            {
                "results": [
                    {"code": r.code, "log": r.log, "txhash": r.tx_hash.hex()}
                    for r in results
                ]
            }
        ).encode()

    def get_tx(self, req: bytes, ctx) -> bytes:
        q = json.loads(req or b"{}")
        info = self.node.get_tx(bytes.fromhex(q["hash"]))
        if info is None:
            return json.dumps({"found": False}).encode()
        out = {"found": True}
        for key, val in info.items():
            out[key] = val.hex() if isinstance(val, bytes) else val
        return json.dumps(out, default=str).encode()

    def account_info(self, req: bytes, ctx) -> bytes:
        q = json.loads(req or b"{}")
        num, seq = self.node.account_info(bytes.fromhex(q["address"]))
        return json.dumps({"account_number": num, "sequence": seq}).encode()

    def simulate(self, raw: bytes, ctx) -> bytes:
        try:
            gas = self.node.simulate(raw)
            return json.dumps({"gas": gas}).encode()
        except Exception as e:
            return json.dumps({"code": 1, "log": str(e)}).encode()

    def status(self, req: bytes, ctx) -> bytes:
        node = self.node
        blocks = getattr(node, "blocks", [])
        latest = blocks[-1].header if blocks else None
        return json.dumps(
            {
                "chain_id": node.chain_id,
                "height": node.height,
                "app_version": node.app.app_version,
                "app_hash": latest.app_hash.hex() if latest else "",
                "data_root": latest.data_hash.hex() if latest else "",
                "time_ns": latest.time_ns if latest else 0,
                "genesis_time_ns": getattr(node.app, "genesis_time_ns", 0),
                "validator_address": (
                    node._validator_key.public_key().address().hex()
                    if getattr(node, "_validator_key", None)
                    else ""
                ),
                **(
                    {"gossip": node.gossip_engine.stats()}
                    if getattr(node, "gossip_engine", None) is not None
                    else {}
                ),
            }
        ).encode()

    def block(self, req: bytes, ctx) -> bytes:
        q = json.loads(req or b"{}")
        try:
            blk = self.node.block(int(q["height"]))
        except (KeyError, IndexError, ValueError) as e:
            return json.dumps({"found": False, "log": str(e)}).encode()
        h = blk.header
        return json.dumps(
            {
                "found": True,
                "height": h.height,
                "time_ns": h.time_ns,
                "chain_id": h.chain_id,
                "app_version": h.app_version,
                "data_root": h.data_hash.hex(),
                "app_hash": h.app_hash.hex(),
                "square_size": h.square_size,
                "tx_hashes": [
                    hashlib.sha256(t).hexdigest() for t in blk.txs
                ],
            }
        ).encode()

    # -- consensus surface (multi-process replication) -----------------
    #
    # Driven by an external coordinator (node/coordinator.py): this node
    # never self-produces in validator mode; the coordinator sequences
    # prepare -> process votes -> commit across the validator processes.

    def cons_prepare(self, req: bytes, ctx) -> bytes:
        q = json.loads(req or b"{}")
        with tracing.rpc_span("rpc.cons_prepare", q.get("_tc")):
            p = self.node.cons_prepare()
        out = {
            "block_txs": [t.hex() for t in p["block_txs"]],
            "square_size": p["square_size"],
            "data_root": p["data_root"].hex(),
        }
        # hand the caller the prepare root's trace context: the
        # coordinator forwards it to every validator's cons_process so
        # the cross-node parent is the PROPOSER's prepare span, not the
        # coordinator's glue
        tc = tracing.last_block_context("prepare_proposal")
        if tc is not None:
            out["_tc"] = tc
        return json.dumps(out).encode()

    def cons_process(self, req: bytes, ctx) -> bytes:
        q = json.loads(req)
        with tracing.rpc_span("rpc.cons_process", q.get("_tc")):
            ok, reason = self.node.cons_process(
                [bytes.fromhex(t) for t in q["block_txs"]],
                int(q["square_size"]),
                bytes.fromhex(q["data_root"]),
            )
        return json.dumps({"accept": ok, "reason": reason}).encode()

    def cons_commit(self, req: bytes, ctx) -> bytes:
        q = json.loads(req)
        votes = q.get("votes")
        with tracing.rpc_span("rpc.cons_commit", q.get("_tc")):
            app_hash = self.node.cons_commit(
                [bytes.fromhex(t) for t in q["block_txs"]],
                int(q["height"]),
                int(q["time_ns"]),
                bytes.fromhex(q["data_root"]),
                int(q["square_size"]),
                proposer=bytes.fromhex(q.get("proposer", "") or ""),
                votes=(
                    [(bytes.fromhex(a), bool(ok)) for a, ok in votes]
                    if votes is not None
                    else None
                ),
            )
        # commit-lag stamp for the block scorecard: the lifecycle ends
        # here, and the gap between the process/prepare trace's end and
        # this arrival is the consensus glue the waterfall reports
        from celestia_tpu_torch.utils.telemetry import clock

        self.scorecard.note_commit(int(q["height"]), clock())
        try:
            self._scorecard_ingest()
        except Exception as e:
            # scorecard bugs degrade observability, never consensus
            faults.note("scorecard.commit", e)
        return json.dumps({"app_hash": app_hash.hex()}).encode()

    # -- two-phase BFT surface (node/bft.py; the relay is dumb transport)

    def bft_start(self, req: bytes, ctx) -> bytes:
        q = json.loads(req)
        self.node.bft_start(int(q["height"]))
        return b"{}"

    def bft_msg(self, req: bytes, ctx) -> bytes:
        wire = json.loads(req)
        # relay-leg trace context rides INSIDE the wire dict (the relay
        # forwards wires verbatim, so there is no outer envelope to
        # extend); engines ignore unknown keys, and the context is
        # stripped before delivery so re-serialized outbox messages never
        # carry a stale hop's context
        tc, kind = None, ""
        if isinstance(wire, dict):  # the only valid wire shape
            tc = wire.pop("_tc", None)
            kind = str(wire.get("kind", ""))
        with tracing.rpc_span("rpc.bft_msg", tc, kind=kind):
            self.node.bft_msg(wire)
        return b"{}"

    def bft_timeout(self, req: bytes, ctx) -> bytes:
        q = json.loads(req)
        self.node.bft_timeout(q["step"], int(q["height"]), int(q["round"]))
        return b"{}"

    def bft_drain(self, req: bytes, ctx) -> bytes:
        return json.dumps(self.node.bft_drain()).encode()

    def bft_decided(self, req: bytes, ctx) -> bytes:
        q = json.loads(req)
        d = self.node.bft_decided(int(q["height"]))
        return json.dumps({"found": d is not None, "decided": d}).encode()

    def bft_catchup(self, req: bytes, ctx) -> bytes:
        ok, why = self.node.bft_catchup(json.loads(req))
        return json.dumps({"ok": ok, "reason": why}).encode()

    def das_sample(self, req: bytes, ctx) -> bytes:
        """One DAS cell + proof to the data root, behind the load-shed
        gate.  A shed response carries ``retry_after_ms`` so an honest
        light client backs off through the unified RetryPolicy instead
        of hammering a saturated node; the ``server.sample`` fault point
        makes the handler itself injectable for the chaos suite (an
        injected failure is reported as retriable, exactly like shed
        load — the client cannot tell a chaos drill from real pressure).

        The optional client-asserted ``"peer"`` envelope field feeds the
        bounded per-peer accounting + the QoS tier hook; requests
        without it stay anonymous on the pre-QoS path (version-tolerant
        envelopes — old clients need no change)."""
        from celestia_tpu_torch.utils.telemetry import clock

        t0 = clock()
        try:
            q = json.loads(req or b"{}")
        except Exception as e:
            return json.dumps({"code": 1, "log": str(e)}).encode()
        peer = _PeerRegistry.peer_id(q)
        lane = self._das_lane(peer, rows=1)
        if not self.das_gate.try_acquire(lane=lane):
            self.node.app.telemetry.incr("das_sample_shed")
            self.das_peers.record_shed(peer, lane)
            tracing.instant("das_sample.shed", cat="serving")
            shed = {
                "shed": True,
                "retry_after_ms": self.das_gate.retry_after_ms,
            }
            if lane is not None:
                shed["lane"] = lane
            return json.dumps(shed).encode()
        try:
            with tracing.rpc_span(
                "das_sample", q.get("_tc"), cat="serving",
                height=int(q.get("height", 0) or 0),
                row=int(q.get("row", 0) or 0),
                col=int(q.get("col", 0) or 0),
            ):
                faults.fire("server.sample")
                out = self.node.abci_query("custom/das/sample", q)
            self.node.app.telemetry.incr("das_samples_served")
            resp = json.dumps({"shed": False, **out}, default=str).encode()
            self.das_peers.record_served(
                peer, cells=1, bytes_out=len(resp),
                rows=((int(q.get("height", 0) or 0),
                       int(q.get("row", 0) or 0)),),
                lane=lane,
            )
            self._observe_das_latency(lane, t0)
            return resp
        except faults.InjectedFault as e:
            return json.dumps(
                {
                    "shed": True,
                    "retry_after_ms": self.das_gate.retry_after_ms,
                    "log": str(e),
                }
            ).encode()
        except Exception as e:
            return json.dumps({"code": 1, "log": str(e)}).encode()
        finally:
            self.das_gate.release(lane=lane)

    # DasSampleBatch chunking: cells proven (and streamed) per response
    # message.  Bounds BOTH the per-message JSON size (a 10k-cell
    # request never builds one giant blob — a 64-proof chunk is ~100 KiB
    # on the wire, far under the 4 MiB transport cap) and the admission
    # granularity: every chunk re-passes the shed gate, weighted by the
    # distinct rows it proves.
    DAS_BATCH_CHUNK = 64

    def das_sample_batch(self, req: bytes, ctx):
        """Streaming DAS batch prover: one request -> n cells, served as
        chunked responses behind the load-shed gate.

        Each chunk is admitted SEPARATELY with weight = the distinct
        rows it proves (the row level stack is the unit of prover work),
        and chunk boundaries keep that weight STRICTLY below the gate's
        ``max_inflight`` — so every chunk is individually admissible
        under concurrent traffic, while an n-cell batch still consumes
        admission proportional to its size.  Batching therefore cannot
        launder load past the gate, and a saturated node
        sheds mid-stream with ``retry_after_ms`` + the count of cells
        already ``served`` so an honest client resumes the remainder
        through the unified RetryPolicy instead of re-requesting served
        cells.  The ``server.sample`` fault point makes every chunk
        injectable for the chaos suite, reported as retriable exactly
        like shed load."""
        from celestia_tpu_torch.utils.telemetry import clock

        q = json.loads(req or b"{}")
        coords = [(int(r), int(c)) for r, c in q.get("coords", [])]
        height = int(q.get("height", 0) or 0)
        peer = _PeerRegistry.peer_id(q)
        # tier usage counts the batch's ASKED cells up front: a shed
        # over-asker keeps offering load, and demotion must see it (cells
        # not distinct rows — a tiny square caps rows at 2k, which would
        # let an over-asker hide arbitrary cell volume behind few rows)
        if self.das_tiers is not None and peer:
            self.das_tiers.note(peer, rows=len(coords))
        chunk = max(
            1, min(int(q.get("chunk", 0) or self.DAS_BATCH_CHUNK),
                   self.DAS_BATCH_CHUNK)
        )
        # chunk boundaries respect BOTH caps: <= `chunk` cells (message
        # size) AND < max_inflight distinct rows (admission weight).
        # STRICTLY below the gate bound: try_acquire(w) needs
        # inflight + w <= max_inflight once anything is in flight, so a
        # chunk weighing the full bound — like one weighing more — could
        # only ever be admitted idle and would shed under ANY concurrent
        # traffic, starving honest batch clients at modest load
        max_rows = max(1, self.das_gate.max_inflight - 1)
        chunks: list = []
        cur: list = []
        cur_rows: set = set()
        for rc in coords:
            if cur and (
                len(cur) >= chunk
                or (rc[0] not in cur_rows and len(cur_rows) >= max_rows)
            ):
                chunks.append(cur)
                cur, cur_rows = [], set()
            cur.append(rc)
            cur_rows.add(rc[0])
        if cur:
            chunks.append(cur)
        telemetry = self.node.app.telemetry
        telemetry.incr("das_batch_calls")
        served = 0
        with tracing.rpc_span(
            "das_sample_batch", q.get("_tc"), cat="serving",
            height=height, cells=len(coords),
        ):
            for i, part in enumerate(chunks):
                weight = len({r for r, _ in part})
                # lane re-evaluated per chunk: an over-asker's giant
                # batch slides to bulk/hostile MID-STREAM once the usage
                # window catches up — demotion is not per-connection
                lane = (
                    self.das_tiers.lane_for(peer)
                    if self.das_tiers is not None
                    else None
                )
                t0 = clock()
                if not self.das_gate.try_acquire(weight=weight, lane=lane):
                    telemetry.incr("das_batch_shed")
                    self.das_peers.record_shed(peer, lane)
                    tracing.instant("das_sample_batch.shed", cat="serving")
                    shed = {
                        "shed": True,
                        "retry_after_ms": self.das_gate.retry_after_ms,
                        "served": served,
                    }
                    if lane is not None:
                        shed["lane"] = lane
                    yield json.dumps(shed).encode()
                    return
                try:
                    faults.fire("server.sample")
                    out = self.node.abci_query(
                        "custom/das/sample_batch",
                        {"height": height, "coords": part},
                    )
                    telemetry.incr("das_samples_served", len(part))
                    served += len(part)
                    resp = json.dumps(
                        {
                            "shed": False,
                            "done": i == len(chunks) - 1,
                            **out,
                        },
                        default=str,
                    ).encode()
                    self.das_peers.record_served(
                        peer, cells=len(part), bytes_out=len(resp),
                        rows=[(height, r) for r, _ in part],
                        lane=lane,
                    )
                    self._observe_das_latency(lane, t0)
                    yield resp
                except faults.InjectedFault as e:
                    # reported retriable like shed load, but NOT counted
                    # as shed: the shed counters track real gate
                    # pressure (same rule as the single-cell handler),
                    # so a chaos drill never inflates the das_shed
                    # signal dashboards scale out on
                    yield json.dumps(
                        {
                            "shed": True,
                            "retry_after_ms": self.das_gate.retry_after_ms,
                            "served": served,
                            "log": str(e),
                        }
                    ).encode()
                    return
                except Exception as e:
                    yield json.dumps({"code": 1, "log": str(e)}).encode()
                    return
                finally:
                    self.das_gate.release(weight=weight, lane=lane)

    # -- observability plane (utils/telemetry.py + utils/tracing.py) ----

    def metrics_text(self) -> str:
        """The ONE exposition builder (the gRPC ``Metrics`` RPC and the
        plain-HTTP ``/metrics`` endpoint both serve exactly this):
        counters, gauges, the bounded log2 histograms, per-span
        aggregates (when tracing is on) and the unified cache registry.

        Appended sections (all line-parse-valid, the same gate as the
        core export): client-side RPC counters (this node's OWN outbound
        pulls — gossip catch-up, state-sync), fault-note/degradation
        totals (the robustness ladder, so ``cluster-health`` needs no
        second RPC), the node identity as an info gauge, the device
        plane's ``celestia_tpu_kernel_*``/``celestia_tpu_device_*`` gauges
        (utils/devprof.py), trace-ring health (span drops + background
        depth — silent truncation must be remotely detectable) and the
        alert engine's per-rule firing states."""
        from celestia_tpu_torch.node import remote as remote_mod
        from celestia_tpu_torch.utils import devprof, faults
        from celestia_tpu_torch.utils.telemetry import escape_label_value

        lines = [self.node.app.telemetry.export_prometheus().rstrip("\n")]
        client_lines = remote_mod.client_rpc_exposition()
        if client_lines:
            lines.extend(client_lines)
        fs = faults.fault_stats()
        notes_total = sum(v["count"] for v in fs["notes"].values())
        lines.append("# TYPE celestia_tpu_fault_notes_total counter")
        lines.append(f"celestia_tpu_fault_notes_total {notes_total}")
        lines.append("# TYPE celestia_tpu_degradations_total counter")
        lines.append(
            f"celestia_tpu_degradations_total {len(fs['degradations'])}"
        )
        nid = tracing.node_id()
        if nid:
            lines.append(
                'celestia_tpu_node_info{node_id="%s"} 1'
                % escape_label_value(nid)
            )
        # device plane (cost table, per-device busy ms, mem watermark)
        lines.extend(devprof.exposition_lines())
        # host profiler (sampler rates + measured self-overhead)
        from celestia_tpu_torch.utils import hostprof

        lines.extend(hostprof.exposition_lines())
        # flight recorder: lifetime incident seq (cluster_health reads
        # the per-peer count straight off the scrape) + kept-ring depth
        if self.flight is not None:
            fst = self.flight.stats()
            lines.append(
                "# TYPE celestia_tpu_flight_incidents_total counter"
            )
            lines.append(
                "celestia_tpu_flight_incidents_total "
                f"{fst['incidents_total']}"
            )
            lines.append(
                f"celestia_tpu_flight_incidents_kept {fst['incidents_kept']}"
            )
        # multi-chip mesh plane (parallel/mesh.py): whether live extends
        # shard, how many have, and how many squares fell back — a
        # degraded (poisoned) mesh shows as active 0 with extends frozen
        from celestia_tpu_torch.parallel import mesh as mesh_mod

        ms = mesh_mod.stats()
        lines.append(
            f"celestia_tpu_mesh_active {1 if ms['active'] else 0}"
        )
        lines.append(
            "# TYPE celestia_tpu_mesh_sharded_extends_total counter"
        )
        lines.append(
            f"celestia_tpu_mesh_sharded_extends_total "
            f"{ms['sharded_extends']}"
        )
        lines.append(
            "# TYPE celestia_tpu_mesh_fallback_squares_total counter"
        )
        lines.append(
            f"celestia_tpu_mesh_fallback_squares_total "
            f"{ms['fallback_squares']}"
        )
        # DAS serving plane (da/das.py + the das_gate): admission stats
        # as explicit gauges/counters (the das_rows cache's hits/misses
        # already ride the unified cache registry lines with
        # cache="das_rows"; the served/shed request counters ride the
        # telemetry export as celestia_tpu_das_*_total) plus the rows
        # hit rate as a ready-made gauge for dashboards/alerts
        from celestia_tpu_torch.da import das as das_mod

        gate = self.das_gate.stats()
        lines.append(f"celestia_tpu_das_gate_inflight {gate['inflight']}")
        lines.append(
            f"celestia_tpu_das_gate_max_inflight {gate['max_inflight']}"
        )
        lines.append("# TYPE celestia_tpu_das_gate_admitted_total counter")
        lines.append(
            f"celestia_tpu_das_gate_admitted_total {gate['admitted']}"
        )
        lines.append("# TYPE celestia_tpu_das_gate_shed_total counter")
        lines.append(f"celestia_tpu_das_gate_shed_total {gate['shed']}")
        # QoS lanes (when configured): per-lane reserved/inflight plus
        # admitted/shed counters — the fairness story per tier
        lane_table = gate.get("lanes")
        if lane_table:
            lines.append(
                "# TYPE celestia_tpu_das_lane_admitted_total counter"
            )
            lines.append("# TYPE celestia_tpu_das_lane_shed_total counter")
            for lane_name in sorted(lane_table):
                lst = lane_table[lane_name]
                ll = escape_label_value(lane_name)
                lines.append(
                    f'celestia_tpu_das_lane_reserved{{lane="{ll}"}} '
                    f'{lst["reserved"]}'
                )
                lines.append(
                    f'celestia_tpu_das_lane_inflight{{lane="{ll}"}} '
                    f'{lst["inflight"]}'
                )
                lines.append(
                    f'celestia_tpu_das_lane_admitted_total{{lane="{ll}"}} '
                    f'{lst["admitted"]}'
                )
                lines.append(
                    f'celestia_tpu_das_lane_shed_total{{lane="{ll}"}} '
                    f'{lst["shed"]}'
                )
        # per-tier end-to-end sample latency (lane folded into the
        # metric name: lane names are server-defined, so the family set
        # is bounded; Log2Histogram renders proper cumulative buckets)
        from celestia_tpu_torch.utils.telemetry import sanitize_metric_name

        with self._das_lat_lock:
            lat_items = sorted(self._das_lat.items())
        for lane_name, hist in lat_items:
            lines.extend(
                hist.prometheus_lines(
                    "celestia_tpu_das_latency_"
                    f"{sanitize_metric_name(lane_name)}_seconds"
                )
            )
        # per-peer accounting (bounded labels — see _PeerRegistry) + the
        # Jain fairness index (skip-absent until a peer has been served)
        lines.extend(self.das_peers.exposition_lines())
        fairness = self.das_peers.fairness_index()
        if fairness is not None:
            lines.append(
                f"celestia_tpu_das_fairness_index {round(fairness, 6)}"
            )
        rows = das_mod.rows_cache().stats()
        lines.append(
            f"celestia_tpu_das_rows_hit_rate {round(rows['hit_rate'], 6)}"
        )
        # trace-ring health (satellite: remote truncation detectability)
        rs = tracing.ring_stats()
        lines.append(
            "# TYPE celestia_tpu_trace_span_drops_total counter"
        )
        lines.append(
            f"celestia_tpu_trace_span_drops_total {rs['span_drops_total']}"
        )
        lines.append(
            f"celestia_tpu_trace_background_depth {rs['background_depth']}"
        )
        # alert states: one 0/1 gauge per rule + the firing total, so
        # cluster_health flags a degrading node from the scrape alone
        # (SLO burn-rate verdicts ride the same gauge family)
        firing_total = 0
        for verdict in self._evaluate_all():
            label = escape_label_value(verdict["name"])
            val = 1 if verdict["firing"] else 0
            firing_total += val
            lines.append(f'celestia_tpu_alert_firing{{rule="{label}"}} {val}')
        lines.append(f"celestia_tpu_alerts_firing_total {firing_total}")
        lines.append(f"celestia_tpu_timeseries_samples {len(self.timeseries)}")
        return "\n".join(lines) + "\n"

    def metrics(self, req: bytes, ctx) -> bytes:
        """Prometheus text exposition (see :meth:`metrics_text`).  Raw
        text bytes — point a scraper straight at the RPC."""
        return self.metrics_text().encode()

    def _evaluate_all(self):
        """Alert-rule verdicts + SLO burn-rate verdicts, one list.  The
        flight recorder keys on verdict name/firing, so SLO breaches
        transition into incident bundles through the unchanged path."""
        verdicts = self.alert_engine.evaluate(self.timeseries)
        verdicts.extend(s.evaluate(self.timeseries) for s in self.slos)
        return verdicts

    def _scorecard_ingest(self) -> None:
        """Fold newly completed block traces into the scorecard ring.

        Called on every sampler tick, scorecard RPC and commit (the
        trace ring is tiny, ingestion dedupes on root span id, so
        repeated calls are cheap no-ops).  Per trace: wall + slowest
        phase from ``phase_breakdown``, extend leg + cache verdict from
        the extend spans, the propagation hop from the critical-path
        report (``_tc`` send ts, offset 0 on a single node's own axis —
        clamped at 0 with ``celestia_tpu_clock_skew_clamped_total``
        counting the skew), and the top-3 critical-path contributors.
        The e2e/propagation observations feed the SLO metrics and the
        ``celestia_tpu_block_{e2e,propagation}_seconds`` histograms."""
        from celestia_tpu_torch.utils import critpath, faults

        t = self.node.app.telemetry
        for tr in tracing.block_traces():
            if not tr.complete or not tr.spans:
                continue
            if not self.scorecard.first_time((tr.name, tr.height, tr.root_id)):
                continue
            try:
                report = critpath.critical_path(tr)
                breakdown = tracing.TRACER.phase_breakdown(tr)
            except Exception as e:
                faults.note("scorecard.ingest", e)
                continue
            root = next(
                (s for s in tr.spans if s.span_id == tr.root_id), None
            )
            leg, cache = "", ""
            for s in tr.spans:
                if s.name == "extend":
                    cache = s.args.get("eds_cache", cache)
                elif s.name in _EXTEND_LEGS:
                    leg = _EXTEND_LEGS[s.name]
            if cache == "hit" and not leg:
                leg = "cache"
            phases = {
                k: v
                for k, v in breakdown.items()
                if k.endswith("_ms") and k != "total_ms"
            }
            slowest = max(phases, key=phases.get) if phases else ""
            fields = {
                "slowest_phase": slowest[:-3] if slowest else "",
                "top_contributors": report["top_contributors"],
                "_end_ts": root.t1 if root is not None else None,
            }
            if leg:
                fields["extend_leg"] = leg
            if cache:
                fields["eds_cache"] = cache
            wall = report["root_wall_ms"]
            prop = report["propagation_delay_ms"]
            if tr.name == "prepare_proposal":
                fields["prepare_ms"] = wall
            else:
                fields["process_ms"] = wall
            if prop is not None:
                fields["propagation_ms"] = prop
                t.observe("block_propagation", prop)
            if report["clock_skew_clamped"]:
                fields["propagation_clamped"] = report["clock_skew_clamped"]
                t.incr("clock_skew_clamped", report["clock_skew_clamped"])
            row = self.scorecard.update(tr.height, **fields)
            t.observe("block_e2e", row["e2e_ms"])
            obs = {"block_e2e_ms": row["e2e_ms"]}
            if prop is not None:
                obs["block_propagation_ms"] = prop
            self.timeseries.record(obs)

    def block_scorecard(self, req: bytes, ctx) -> bytes:
        """The per-height scorecard ring (``query block-scorecard``).
        Ingests any freshly completed traces first, so a scorecard
        fetched right after a block always has that height's row."""
        q = json.loads(req or b"{}")
        from celestia_tpu_torch.utils import faults

        try:
            self._scorecard_ingest()
        except Exception as e:
            faults.note("scorecard.rpc", e)
        last = q.get("last")
        return json.dumps(
            {
                "node_id": tracing.node_id(),
                "height": int(getattr(self.node, "height", 0) or 0),
                "rows": self.scorecard.rows(
                    int(last) if last is not None else None
                ),
            }
        ).encode()

    def sample_timeseries(self):
        """Record ONE snapshot of the node's operational signals into
        the ring (the sampler thread's tick; also the on-demand sample
        every TimeSeries RPC takes before answering).  Returns the
        alert verdicts the flight tick computed (None when no recorder
        is armed) so the TimeSeries RPC never evaluates the engine a
        second time for the same tick."""
        from celestia_tpu_torch.utils import faults, timeseries as ts_mod

        try:
            # scorecard first: freshly completed traces contribute the
            # block_e2e_ms/block_propagation_ms observations the SLO
            # verdicts below are judged on
            self._scorecard_ingest()
        except Exception as e:
            faults.note("scorecard.tick", e)
        try:
            self.timeseries.record(ts_mod.collect_node_sample(self.node))
        except Exception as e:
            # a collector bug degrades the ring, never the node
            faults.note("timeseries.sample", e)
        verdicts = None
        if self.flight is not None:
            verdicts = self._evaluate_all()
            self.flight_tick(verdicts)
        return verdicts

    def flight_tick(self, verdicts=None) -> None:
        """Feed the flight recorder: alert firing TRANSITIONS over the
        fresh sample trigger an incident bundle, and the newest block
        trace is judged against the slow-block threshold.  A recorder
        bug degrades to a fault note, never the node.  A caller that
        has already evaluated the engine passes its ``verdicts`` so one
        tick never evaluates twice."""
        if self.flight is None:
            return
        from celestia_tpu_torch.utils import faults

        try:
            if verdicts is None:
                verdicts = self._evaluate_all()
            inc = self.flight.on_alerts(
                verdicts,
                height=int(getattr(self.node, "height", 0) or 0),
                # callables: resolved only when a bundle actually dumps,
                # so the steady-state tick never builds an exposition
                metrics_text=self.metrics_text,
                timeseries_snapshots=self.timeseries.samples,
            )
            if inc is None and self.flight.slow_block_ms is not None:
                for tr in tracing.block_traces(last=1):
                    breakdown = tracing.TRACER.phase_breakdown(tr)
                    self.flight.on_block(
                        tr.height, breakdown.get("total_ms", 0.0),
                        metrics_text=self.metrics_text,
                        timeseries_snapshots=self.timeseries.samples,
                    )
        except Exception as e:
            faults.note("flight.tick", e)

    def time_series(self, req: bytes, ctx) -> bytes:
        """The continuous-telemetry ring + alert verdicts.  One fresh
        sample is recorded per call, so two consecutive RPCs always
        return >= 2 snapshots with a computable rate — a fresh node is
        queryable immediately, no waiting on the sampler cadence."""
        q = json.loads(req or b"{}")
        verdicts = self.sample_timeseries()
        if verdicts is None:  # no recorder armed: the tick skipped it
            verdicts = self._evaluate_all()
        last = q.get("last")
        snapshots = self.timeseries.samples(
            int(last) if last is not None else None
        )
        return json.dumps(
            {
                "node_id": tracing.node_id(),
                "samples_kept": len(self.timeseries),
                "max_samples": self.timeseries.max_samples,
                "snapshots": snapshots,
                "rates": self.timeseries.rates(),
                "alerts": verdicts,
            }
        ).encode()

    def clock_probe(self, req: bytes, ctx) -> bytes:
        """One sanctioned telemetry-clock read for the cross-node
        midpoint offset probe (utils/tracing.estimate_clock_offset):
        merged cluster timelines subtract the estimated offset so N
        nodes' spans line up on one axis."""
        from celestia_tpu_torch.utils.telemetry import clock

        return json.dumps(
            {
                "ts": clock(),
                "node_id": tracing.node_id(),
                "height": self.node.height,
            }
        ).encode()

    def trace_dump(self, req: bytes, ctx) -> bytes:
        """The last N block traces (plus the background ring) as a Chrome
        trace-event document: ``{"enabled", "blocks", "trace"}`` where
        ``trace`` opens as-is in Perfetto / chrome://tracing."""
        q = json.loads(req or b"{}")
        last = q.get("last")
        dump = tracing.trace_dump(int(last) if last is not None else None)
        return json.dumps(
            {
                "enabled": tracing.enabled(),
                "blocks": dump.get("otherData", {}).get("blocks", []),
                "trace": dump,
            }
        ).encode()

    def host_profile(self, req: bytes, ctx) -> bytes:
        """The host sampling profiler's state (utils/hostprof.py):
        sampler stats, top self-time frames and the folded stacks
        (bounded to the top N by count so the response stays under the
        transport cap even on a long-running node)."""
        from celestia_tpu_torch.utils import hostprof

        q = json.loads(req or b"{}")
        top = int(q.get("top", 25) or 25)
        folded = sorted(
            hostprof.folded_stacks().items(), key=lambda kv: (-kv[1], kv[0])
        )[: max(1, int(q.get("folded", 200) or 200))]
        return json.dumps(
            {
                "node_id": tracing.node_id(),
                "stats": hostprof.stats(),
                "top_frames": hostprof.top_frames(top),
                "folded": dict(folded),
            }
        ).encode()

    def flight_list(self, req: bytes, ctx) -> bytes:
        """Manifest summaries of every kept incident bundle (oldest
        first), plus the recorder's ring stats.  ``enabled: false`` when
        the node runs without --flight-dir."""
        if self.flight is None:
            return json.dumps(
                {"enabled": False, "incidents": [], "stats": {}}
            ).encode()
        return json.dumps(
            {
                "enabled": True,
                "incidents": self.flight.list_incidents(),
                "stats": self.flight.stats(),
            }
        ).encode()

    # stay safely under RemoteNode.MAX_RECV_BYTES (4 MiB): a bundle
    # whose artifacts exceed this is served file-by-file instead of
    # inline, and a single oversized artifact is truncated with a
    # marker rather than made irretrievable
    FLIGHT_INLINE_MAX = 2 * 1024 * 1024
    FLIGHT_FILE_MAX = 3 * 1024 * 1024

    def flight_fetch(self, req: bytes, ctx) -> bytes:
        """One incident bundle by id ({"id": ...}; empty id = the
        newest).  Small bundles return manifest + every artifact
        inline; a bundle that would blow the client's 4 MiB transport
        cap returns ``files_inline: false`` and the client re-fetches
        each artifact with ``{"id", "file": <name>}``."""
        q = json.loads(req or b"{}")
        if self.flight is None:
            return json.dumps({"found": False, "enabled": False}).encode()
        incident_id = str(q.get("id", "") or "")
        if not incident_id:
            incidents = self.flight.list_incidents()
            if not incidents:
                return json.dumps({"found": False}).encode()
            incident_id = incidents[-1]["id"]
        bundle = self.flight.load_bundle(incident_id)
        if bundle is None:
            return json.dumps({"found": False, "id": incident_id}).encode()
        name = str(q.get("file", "") or "")
        if name:
            content = bundle["files"].get(name)
            if content is None:
                return json.dumps(
                    {"found": False, "id": incident_id, "file": name}
                ).encode()
            truncated = len(content) > self.FLIGHT_FILE_MAX
            if truncated:
                content = content[: self.FLIGHT_FILE_MAX]
            return json.dumps(
                {
                    "found": True, "id": incident_id, "file": name,
                    "content": content, "truncated": truncated,
                }
            ).encode()
        total = sum(len(v) for v in bundle["files"].values())
        if total > self.FLIGHT_INLINE_MAX:
            return json.dumps(
                {
                    "found": True,
                    "manifest": bundle["manifest"],
                    "files_inline": False,
                }
            ).encode()
        return json.dumps({"found": True, **bundle}).encode()

    def healthz(self) -> dict:
        """The load-balancer / orchestrator probe body (plain-HTTP
        ``GET /healthz`` on --metrics-port): one small JSON answering
        "is this node serving and is anything on fire" without the full
        exposition."""
        from celestia_tpu_torch.utils.telemetry import clock

        breakers_open = 0
        eng = getattr(self.node, "gossip_engine", None)
        if eng is not None:
            try:
                breakers = eng.stats().get("pull_breakers", {})
                breakers_open = sum(
                    1 for s in breakers.values() if s != "closed"
                )
            except Exception as e:
                faults.note("healthz.breakers", e)
        firing = [
            a["name"] for a in self._evaluate_all() if a["firing"]
        ]
        # DAS serving health without a metrics scrape: gate shed totals,
        # per-lane inflight, and the current fairness index (omitted
        # until an identified peer has been served — skip-absent)
        gate = self.das_gate.stats()
        das = {
            "gate_shed": gate["shed"],
            "gate_admitted": gate["admitted"],
            "lanes": (
                {n: st["inflight"] for n, st in gate["lanes"].items()}
                if "lanes" in gate
                else {"default": gate["inflight"]}
            ),
        }
        fairness = self.das_peers.fairness_index()
        if fairness is not None:
            das["fairness_index"] = round(fairness, 4)
        # block-lifecycle health: the last scored height's e2e and its
        # slowest phase, straight off the scorecard ring
        block = {}
        last_row = self.scorecard.latest()
        if last_row is not None:
            block = {
                "height": last_row.get("height"),
                "e2e_ms": last_row.get("e2e_ms"),
                "slowest_phase": last_row.get("slowest_phase", ""),
            }
        body = {
            "status": "degraded" if firing else "ok",
            "node_id": tracing.node_id(),
            "chain_id": getattr(self.node, "chain_id", ""),
            "height": int(getattr(self.node, "height", 0) or 0),
            "breakers_open": breakers_open,
            "alerts_firing": firing,
            "uptime_s": round(
                max(0.0, clock() - self._t0), 3
            ),
            "incidents_kept": (
                len(self.flight.list_incidents())
                if self.flight is not None
                else 0
            ),
            "das": das,
            "block": block,
        }
        if self.failures:
            body["status"] = "failed"
            for where, what in self.failures.items():
                body[f"{where}_failure"] = what
        return body

    def query(self, req: bytes, ctx) -> bytes:
        q = json.loads(req or b"{}")
        path = q.get("path", "")
        data = q.get("data", {})
        try:
            result = self.node.abci_query(path, data)
            return json.dumps({"code": 0, "value": result}, default=str).encode()
        except Exception as e:
            return json.dumps({"code": 1, "log": str(e)}).encode()

    # -- p2p gossip mesh (node/gossip.py) -------------------------------

    def gossip_msg(self, req: bytes, ctx) -> bytes:
        d = json.loads(req)
        eng = getattr(self.node, "gossip_engine", None)
        if eng is None:
            # no mesh engine on this node: deliver directly (lets a
            # meshed peer talk to a relay-driven node during rollout)
            self.node.bft_msg(d["wire"])
            return json.dumps({"new": True}).encode()
        # dedup id is computed engine-side from the wire content; a
        # sender-supplied id is never trusted.  "_tc" is the OPTIONAL
        # envelope trace context (version-tolerant: an old engine simply
        # never sees it, an old sender simply never sends it)
        new = eng.on_gossip(d["wire"], d.get("sender", ""), tc=d.get("_tc"))
        return json.dumps({"new": new}).encode()

    def tx_have(self, req: bytes, ctx) -> bytes:
        d = json.loads(req)
        eng = getattr(self.node, "gossip_engine", None)
        hashes = [bytes.fromhex(h) for h in d.get("hashes", [])]
        want = eng.on_tx_have(hashes) if eng is not None else []
        return json.dumps({"want": [h.hex() for h in want]}).encode()

    def genesis(self, req: bytes, ctx) -> bytes:
        """Serve the chain's genesis document (download-genesis role,
        cmd/root.go:131-142).  The caller should validate it and, for a
        real deployment, cross-check the chain id / app hash out of
        band — a single serving peer is not a trust anchor."""
        doc = getattr(self.node, "genesis_doc", None)
        return json.dumps(
            {"found": doc is not None, "genesis": doc or {}}
        ).encode()

    def snapshot_list(self, req: bytes, ctx) -> bytes:
        """State-sync serving (root.go:227-243 role): metadata of the
        snapshots this node can serve, incl. per-chunk hashes."""
        store = getattr(self.node, "snapshots", None)
        metas = store.list_wire() if store is not None else []
        return json.dumps({"snapshots": metas}).encode()

    def snapshot_chunk(self, req: bytes, ctx) -> bytes:
        d = json.loads(req)
        store = getattr(self.node, "snapshots", None)
        chunk = None
        with tracing.rpc_span(
            "rpc.snapshot_chunk", d.get("_tc"),
            height=int(d.get("height", 0) or 0), idx=int(d.get("idx", 0) or 0),
        ):
            if store is not None:
                chunk = store.chunk_bytes(
                    int(d["height"]), int(d.get("format", 1)), int(d["idx"])
                )
        return json.dumps(
            {"found": chunk is not None,
             "data": chunk.hex() if chunk is not None else ""}
        ).encode()

    def peer_exchange(self, req: bytes, ctx) -> bytes:
        """PEX (comet p2p/addrbook role): learn the caller + its peers,
        return ours."""
        d = json.loads(req)
        eng = getattr(self.node, "gossip_engine", None)
        if eng is None:
            return json.dumps({"peers": []}).encode()
        peers = eng.on_peer_exchange(
            str(d.get("sender", "")), list(d.get("peers", []))
        )
        return json.dumps({"peers": peers}).encode()

    def tx_push(self, req: bytes, ctx) -> bytes:
        d = json.loads(req)
        eng = getattr(self.node, "gossip_engine", None)
        raws = [bytes.fromhex(r) for r in d.get("txs", [])]
        if eng is not None:
            n = eng.on_tx_push(raws)
        elif raws:
            # no gossip engine: drain the push through the batched
            # admission plane directly (one verify_batch pass), degrading
            # to the per-tx loop on a batch-layer failure
            try:
                results = self.node.broadcast_txs_batch(raws)
                n = sum(1 for r in results if r.code == 0)
            except Exception as e:
                faults.note("server.txpush", e)
                n = 0
                for raw in raws:
                    try:
                        if self.node.broadcast_tx(raw).code == 0:
                            n += 1
                    except Exception as e:  # noqa: PERF203 - per-tx isolation
                        faults.note("server.txpush", e)
                        continue
        else:
            n = 0
        return json.dumps({"admitted": n}).encode()

    # -- grpc wiring ---------------------------------------------------

    def handlers(self):
        """The service's ``grpc.GenericRpcHandler``.  grpc is imported here,
        where the transport is built, so the handlers, healthz and metrics
        run on a machine without it."""
        import grpc

        rpcs = {
            "Broadcast": self.broadcast,
            "BroadcastBatch": self.broadcast_batch,
            "GetTx": self.get_tx,
            "AccountInfo": self.account_info,
            "Simulate": self.simulate,
            "Status": self.status,
            "Block": self.block,
            "Query": self.query,
            "Metrics": self.metrics,
            "BlockScorecard": self.block_scorecard,
            "TraceDump": self.trace_dump,
            "ClockProbe": self.clock_probe,
            "TimeSeries": self.time_series,
            "HostProfile": self.host_profile,
            "FlightList": self.flight_list,
            "FlightFetch": self.flight_fetch,
            "DasSample": self.das_sample,
            "ConsPrepare": self.cons_prepare,
            "ConsProcess": self.cons_process,
            "ConsCommit": self.cons_commit,
            "BftStart": self.bft_start,
            "BftMsg": self.bft_msg,
            "BftTimeout": self.bft_timeout,
            "BftDrain": self.bft_drain,
            "BftDecided": self.bft_decided,
            "BftCatchup": self.bft_catchup,
            "GossipMsg": self.gossip_msg,
            "TxHave": self.tx_have,
            "TxPush": self.tx_push,
            "PeerExchange": self.peer_exchange,
            "SnapshotList": self.snapshot_list,
            "SnapshotChunk": self.snapshot_chunk,
            "Genesis": self.genesis,
        }
        method_handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                self._counted(name, fn),
                request_deserializer=_identity, response_serializer=_identity
            )
            for name, fn in rpcs.items()
        }
        # the one server-streaming method: a DAS batch arrives as ONE
        # request and leaves as chunked responses (each independently
        # gate-admitted), so a 10k-cell answer never materializes as a
        # single JSON blob on either side of the wire
        method_handlers["DasSampleBatch"] = grpc.unary_stream_rpc_method_handler(
            self._counted_stream("DasSampleBatch", self.das_sample_batch),
            request_deserializer=_identity, response_serializer=_identity
        )
        return grpc.method_handlers_generic_handler(SERVICE, method_handlers)

    def _counted(self, name: str, fn):
        """Per-RPC byte/count telemetry: ``rpc_{method}_calls`` plus
        ``rpc_{method}_bytes_{in,out}`` counters on the node's telemetry
        (three locked dict increments — cheap enough for the gossip
        flood path, and the cluster-health rollup reads them straight
        off the Metrics exposition).  The telemetry is read per call,
        never captured: a state-sync restore REPLACES node.app (and its
        Telemetry), and counters bound to the old instance would freeze
        out of the Metrics export."""
        from celestia_tpu_torch.utils.telemetry import snake_case

        prefix = f"rpc_{snake_case(name)}"

        def handler(req: bytes, ctx, _fn=fn, _p=prefix):
            t = self.node.app.telemetry
            t.incr(f"{_p}_calls")
            t.incr(f"{_p}_bytes_in", len(req) if req else 0)
            resp = _fn(req, ctx)
            t.incr(f"{_p}_bytes_out", len(resp) if resp else 0)
            return resp

        return handler

    def _counted_stream(self, name: str, fn):
        """The streaming-method twin of :meth:`_counted`: one ``_calls``
        per stream, ``bytes_out`` accumulated per yielded message (the
        telemetry is re-read per message for the same state-sync-restore
        reason)."""
        from celestia_tpu_torch.utils.telemetry import snake_case

        prefix = f"rpc_{snake_case(name)}"

        def handler(req: bytes, ctx, _fn=fn, _p=prefix):
            t = self.node.app.telemetry
            t.incr(f"{_p}_calls")
            t.incr(f"{_p}_bytes_in", len(req) if req else 0)
            for resp in _fn(req, ctx):
                self.node.app.telemetry.incr(
                    f"{_p}_bytes_out", len(resp) if resp else 0
                )
                yield resp

        return handler


class _MetricsHTTPServer:
    """Plain-HTTP ``/metrics`` endpoint (stdlib ``http.server`` on its
    own daemon thread) so a stock Prometheus scrapes the node without
    speaking the custom gRPC framing.  Serves EXACTLY
    ``NodeService.metrics_text()`` — one exposition builder, two
    transports.  Off by default; explicit shutdown path."""

    def __init__(self, service: "NodeService", host: str, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        svc = service

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler contract
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    # the orchestrator/load-balancer probe: small JSON,
                    # never the full exposition (a probe every second
                    # must not pay for histogram rendering)
                    try:
                        health = svc.healthz()
                        body = json.dumps(health).encode()
                    except Exception as e:  # noqa: BLE001 — probe gets 500
                        self.send_error(500, str(e)[:200])
                        return
                    ctype = "application/json; charset=utf-8"
                    # a failed producer answers 503 (the probe's "not serving")
                    code = 503 if health["status"] == "failed" else 200
                elif path in ("/metrics", "/"):
                    try:
                        body = svc.metrics_text().encode()
                    except Exception as e:  # noqa: BLE001 — scraper gets 500
                        self.send_error(500, str(e)[:200])
                        return
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                    code = 200
                else:
                    self.send_error(404, "only /metrics and /healthz are served")
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.address = f"{host}:{self.port}"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        # shutdown() waits on an event only serve_forever() sets: calling
        # it on a constructed-but-never-started server would hang forever
        # (e.g. teardown after the gRPC bind raised before start())
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


class NodeServer:
    """A running node + its gRPC service + a block-production loop
    (+ the optional plain-HTTP metrics endpoint and the continuous
    telemetry sampler)."""

    def __init__(
        self,
        node,
        address: str = "127.0.0.1:0",
        block_interval_s: Optional[float] = None,
        max_workers: int = 8,
        das_max_inflight: int = 4,
        das_qos: bool = False,
        metrics_port: Optional[int] = None,
        timeseries_interval_s: Optional[float] = 5.0,
        host_profile_hz: Optional[float] = None,
        flight_dir: Optional[str] = None,
    ):
        self.node = node
        # anomaly flight recorder: armed only by an explicit --flight-dir
        flight = None
        if flight_dir:
            from celestia_tpu_torch.utils.flight import FlightRecorder

            flight = FlightRecorder(flight_dir)
        self.service = NodeService(
            node, das_max_inflight=das_max_inflight, flight=flight,
            das_qos=das_qos,
        )
        # host sampling profiler: started/stopped with the server when a
        # rate is given (the module may also be armed via env — in that
        # case the server leaves ownership with whoever armed it)
        self.host_profile_hz = host_profile_hz
        self._owns_hostprof = False
        # the gRPC transport is built and bound by start(), which imports
        # grpc: the service runs without it, the server does not
        self._requested_address = address
        self._max_workers = max_workers
        self._server = None
        self.port: Optional[int] = None
        self.address: Optional[str] = None
        self.block_interval_s = block_interval_s
        self._stop = threading.Event()
        self._producer: Optional[threading.Thread] = None
        # set when the node fails (see fail), with its error
        self.failed = threading.Event()
        self.failure: Optional[BaseException] = None
        # continuous telemetry sampler (utils/timeseries.py): one cheap
        # snapshot per tick; None/0 disables
        self.timeseries_interval_s = (
            float(timeseries_interval_s)
            if timeseries_interval_s
            else None
        )
        self._sampler: Optional[threading.Thread] = None
        # plain-HTTP /metrics (off unless a port is given; 0 = ephemeral)
        self.metrics_http: Optional[_MetricsHTTPServer] = None
        if metrics_port is not None:
            host = address.rsplit(":", 1)[0] or "127.0.0.1"
            self.metrics_http = _MetricsHTTPServer(
                self.service, host, int(metrics_port)
            )
        # node-internal locking: the production loop and gRPC workers touch
        # the same app state; the TestNode surface is synchronised by this
        # coarse lock installed onto the node.
        if not hasattr(node, "_service_lock"):
            node._service_lock = threading.RLock()
        self._wrap_node_with_lock()

    def _wrap_node_with_lock(self) -> None:
        lock = self.node._service_lock
        for name in (
            "broadcast_tx", "get_tx", "account_info", "simulate",
            "produce_block", "block", "abci_query",
        ):
            fn = getattr(self.node, name, None)
            if fn is None or getattr(fn, "_locked", False):
                continue

            def locked(*a, _fn=fn, **kw):
                with lock:
                    return _fn(*a, **kw)

            locked._locked = True
            setattr(self.node, name, locked)

    def start(self) -> None:
        """Bind the gRPC transport (raising ``ImportError`` when grpc is not
        installed; no other transport stands in) and start serving, the
        producer and the sampler."""
        import grpc

        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers)
        )
        self._server.add_generic_rpc_handlers((self.service.handlers(),))
        self.port = self._server.add_insecure_port(self._requested_address)
        if self.port == 0:
            raise RuntimeError(
                f"could not bind gRPC server to {self._requested_address}"
            )
        host = self._requested_address.rsplit(":", 1)[0]
        self.address = f"{host}:{self.port}"
        # the gossip engine stamps outbound floods with this (sender
        # exclusion on re-flood)
        self.node._server_address = self.address
        # stable node identity for the cross-node trace/metrics planes:
        # the bind address is unique per mesh member.  First write wins —
        # CELESTIA_TPU_TORCH_NODE_ID (pinned at import) or a test override is
        # never clobbered.
        tracing.set_node_id(self.address)
        self._server.start()
        if self.host_profile_hz:
            from celestia_tpu_torch.utils import hostprof

            if not hostprof.enabled():
                self._owns_hostprof = True
            hostprof.start(self.host_profile_hz)
        if self.metrics_http is not None:
            self.metrics_http.start()
        if self.block_interval_s:
            self._producer = threading.Thread(
                target=self._produce_loop, name="block-producer", daemon=True
            )
            self._producer.start()
        if self.timeseries_interval_s:
            self._sampler = threading.Thread(
                target=self._sample_loop, name="timeseries-sampler",
                daemon=True,
            )
            self._sampler.start()

    def fail(self, exc: BaseException, where: str = "producer") -> None:
        """End the node on a failure of its own work: a block the producer
        cannot make, blocks the gossip catch-up cannot adopt, or a BFT
        proposal it cannot build (a CUDA launch or synchronise error among
        the causes).  ``/healthz`` then
        reports the node failed, with the error under
        ``<where>_failure``, and ``failed`` is set (``cli start`` then
        exits 1)."""
        import traceback

        traceback.print_exception(exc)
        self.failure = exc
        self.service.failures[where] = f"{type(exc).__name__}: {exc}"
        self.failed.set()

    def _produce_loop(self) -> None:
        # Departure from the reference, whose producer prints the error and
        # keeps producing: a block that fails ends the loop and the node.
        while not self._stop.wait(self.block_interval_s):
            try:
                self.node.produce_block()
            except Exception as e:  # noqa: BLE001 — surfaced, not swallowed
                self.fail(e, "producer")
                return

    def _sample_loop(self) -> None:
        # Event.wait paces the cadence (no sleep-in-loop, celint R5);
        # sample_timeseries itself swallows collector bugs via
        # faults.note, so the loop body cannot die.  The seed sample
        # runs HERE, not in start(): the collector's device-plane read
        # (nvidia-smi, the allocator's stats) may be slow, and a daemon
        # sampler may stall where node startup must not.
        self.service.sample_timeseries()
        while not self._stop.wait(self.timeseries_interval_s):
            self.service.sample_timeseries()

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        if self._server is not None:
            # wait for the transport to end: a process that exits while
            # gRPC is still taking calls (a mesh's peers keep sending) can
            # hang at exit, a worker waiting on a call whose events the
            # serving thread, refused by the shut executor, never delivers
            # (departure from the reference, which does not wait)
            self._server.stop(grace).wait(grace + 5.0)
        if self._owns_hostprof:
            from celestia_tpu_torch.utils import hostprof

            hostprof.stop()
            self._owns_hostprof = False
        if self.metrics_http is not None:
            self.metrics_http.stop()
        if self._producer is not None:
            self._producer.join(timeout=5)
        if self._sampler is not None:
            self._sampler.join(timeout=5)

    def __enter__(self) -> "NodeServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
