"""gRPC client: a network-remote node with the same surface as TestNode.

The Signer (client/signer.py) binds to anything exposing broadcast_tx /
account_info / simulate / get_tx / chain_id — in-process TestNode or this
class over a real network boundary.  Parity role: the gRPC connection
pkg/user's Signer holds (pkg/user/signer.go:31-55, broadcast :268-309,
ConfirmTx poll :365-395).

Lives in node/ (moved from client/, celint R8): the mesh itself is this
class's heaviest user — gossip links, catch-up pulls, state-sync chunk
fetches are all a NODE acting as an RPC client — and node/ may not
import client/.  client/remote.py re-exports the public surface for the
wallet/CLI tier, so existing client-side imports are unchanged.
"""

from __future__ import annotations

import json
from typing import List, Optional

from celestia_tpu_torch.state.tx import SubmitResult
from celestia_tpu_torch.utils import tracing
from celestia_tpu_torch.utils.telemetry import Telemetry, snake_case

SERVICE = "celestia.tpu.v1.Node"

# Client-side RPC byte/count telemetry: one process-wide Telemetry for
# every RemoteNode (gossip links, catch-up pulls, CLI tools) — counters
# only, named rpc_client_{method}_{calls,bytes_in,bytes_out}.  The node
# Metrics RPC appends these via client_rpc_exposition(), so a node's
# OWN outbound traffic (state-sync, catch-up) is scrapeable next to its
# serving-side counters.
RPC_TELEMETRY = Telemetry()


def client_rpc_exposition() -> List[str]:
    """Prometheus lines for the client-side RPC counters.  Hand-built
    from the counter map (never Telemetry.export_prometheus(): that
    would re-emit the shared cache-registry/span sections a node's own
    export already carries, and duplicate samples are malformed)."""
    counters, _gauges, _timings = RPC_TELEMETRY._snapshot()
    lines: List[str] = []
    for name, val in sorted(counters.items()):
        metric = f"celestia_tpu_{name}_total"
        lines.append(f"# TYPE {metric} counter")
        lines.append(f"{metric} {val}")
    return lines


class RemoteError(RuntimeError):
    pass


class RemoteNode:
    """Client handle to a celestia-tpu node's gRPC service."""

    # Hard transport bound on any single response (state-sync
    # DoS): grpc's own default is 4 MiB but IMPLICIT — pin it explicitly
    # so a future channel tweak cannot silently remove the only layer
    # that stops a hostile peer flooding an unbounded message.  Every
    # legitimate RPC (snapshot chunks are <= 1 MiB on the wire, 2 MiB as
    # hex) fits comfortably.
    MAX_RECV_BYTES = 4 * 1024 * 1024

    def __init__(self, address: str, timeout_s: float = 30.0):
        # grpc is imported where the channel is built: the module imports
        # on a machine without it
        import grpc

        self.address = address
        self.timeout_s = timeout_s
        self._rpc_error = grpc.RpcError
        self._channel = grpc.insecure_channel(
            address,
            options=[
                ("grpc.max_receive_message_length", self.MAX_RECV_BYTES)
            ],
        )
        self._methods: dict = {}
        status = self.status()
        self.chain_id = status["chain_id"]

    def close(self) -> None:
        self._channel.close()

    def _call(self, method: str, payload: bytes) -> bytes:
        fn = self._methods.get(method)
        if fn is None:
            fn = self._channel.unary_unary(
                f"/{SERVICE}/{method}",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            self._methods[method] = fn
        prefix = f"rpc_client_{snake_case(method)}"
        RPC_TELEMETRY.incr(f"{prefix}_calls")
        RPC_TELEMETRY.incr(f"{prefix}_bytes_out", len(payload))
        try:
            resp = fn(payload, timeout=self.timeout_s)
        except self._rpc_error as e:
            RPC_TELEMETRY.incr(f"{prefix}_errors")
            raise RemoteError(f"{method}: {e.code().name} {e.details()}") from e
        RPC_TELEMETRY.incr(f"{prefix}_bytes_in", len(resp) if resp else 0)
        return resp

    def _call_json(self, method: str, obj: dict) -> dict:
        return json.loads(self._call(method, json.dumps(obj).encode()))

    def _call_stream(self, method: str, payload: bytes):
        """Server-streaming call: yields response messages as bytes.
        Same byte/count telemetry as :meth:`_call`, accumulated per
        received message."""
        fn = self._methods.get(("stream", method))
        if fn is None:
            fn = self._channel.unary_stream(
                f"/{SERVICE}/{method}",
                request_serializer=lambda b: b,
                response_deserializer=lambda b: b,
            )
            self._methods[("stream", method)] = fn
        prefix = f"rpc_client_{snake_case(method)}"
        RPC_TELEMETRY.incr(f"{prefix}_calls")
        RPC_TELEMETRY.incr(f"{prefix}_bytes_out", len(payload))
        try:
            for resp in fn(payload, timeout=self.timeout_s):
                RPC_TELEMETRY.incr(
                    f"{prefix}_bytes_in", len(resp) if resp else 0
                )
                yield resp
        except self._rpc_error as e:
            RPC_TELEMETRY.incr(f"{prefix}_errors")
            raise RemoteError(
                f"{method}: {e.code().name} {e.details()}"
            ) from e

    @staticmethod
    def _attach_tc(payload: dict, tc=None, height: int = 0) -> dict:
        """Attach the optional cross-node trace context: an explicit
        ``tc`` (a context being FORWARDED, e.g. the coordinator relaying
        the proposer's prepare context) wins over the ambient one; with
        tracing disabled and no explicit context the envelope is
        byte-identical to the pre-context wire format."""
        if tc is None:
            tc = tracing.wire_context(height=height)
        if tc:
            payload["_tc"] = tc
        return payload

    # -- TestNode-compatible client surface ----------------------------

    def status(self) -> dict:
        return self._call_json("Status", {})

    @property
    def height(self) -> int:
        return int(self.status()["height"])

    def account_info(self, address: bytes):
        out = self._call_json("AccountInfo", {"address": address.hex()})
        return out["account_number"], out["sequence"]

    def broadcast_tx(self, raw: bytes) -> SubmitResult:
        out = json.loads(self._call("Broadcast", raw))
        return SubmitResult(
            out["code"], out["log"], bytes.fromhex(out["txhash"])
        )

    def broadcast_txs_batch(self, raws) -> list:
        """Batched submission through the server's BroadcastBatch RPC:
        one check_txs_batch pass node-side, per-tx results in order."""
        out = self._call_json(
            "BroadcastBatch", {"txs": [r.hex() for r in raws]}
        )
        return [
            SubmitResult(e["code"], e["log"], bytes.fromhex(e["txhash"]))
            for e in out["results"]
        ]

    def get_tx(self, tx_hash: bytes) -> Optional[dict]:
        try:
            out = self._call_json("GetTx", {"hash": tx_hash.hex()})
        except RemoteError as e:
            if "DEADLINE_EXCEEDED" in str(e):
                # the node is busy (e.g. the kernels' first build inside
                # block production holds the service lock); treat as "not yet"
                # so confirm loops keep polling instead of dying
                return None
            raise
        if not out.pop("found"):
            return None
        return out

    def simulate(self, raw: bytes) -> int:
        out = json.loads(self._call("Simulate", raw))
        if "gas" not in out:
            raise ValueError(out.get("log", "simulation failed"))
        return int(out["gas"])

    def block(self, height: int) -> dict:
        out = self._call_json("Block", {"height": height})
        if not out.pop("found"):
            raise KeyError(f"no block at height {height}")
        return out

    def data_root(self, height: int) -> bytes:
        return bytes.fromhex(self.block(height)["data_root"])

    def abci_query(self, path: str, data: dict):
        out = self._call_json("Query", {"path": path, "data": data})
        if out.get("code"):
            raise RemoteError(out.get("log", "query failed"))
        return out["value"]

    # -- observability plane --------------------------------------------

    def metrics(self) -> str:
        """The node's Prometheus text exposition (the ``Metrics`` RPC):
        counters, gauges, bounded histograms, cache registry."""
        return self._call("Metrics", b"{}").decode()

    def trace_dump(self, last: Optional[int] = None) -> dict:
        """The node's last N block traces: ``{"enabled", "blocks",
        "trace"}``; ``trace`` is Chrome trace-event JSON — write it to a
        file and open it in Perfetto (ui.perfetto.dev) unchanged."""
        payload: dict = {}
        if last is not None:
            payload["last"] = int(last)
        return self._call_json("TraceDump", payload)

    def time_series(self, last: Optional[int] = None) -> dict:
        """The node's continuous-telemetry ring + alert verdicts (the
        ``TimeSeries`` RPC): ``{"snapshots", "rates", "alerts",
        "samples_kept", ...}``.  The server records one fresh sample per
        call, so calling twice always yields >= 2 snapshots with a
        computable rate."""
        payload: dict = {}
        if last is not None:
            payload["last"] = int(last)
        return self._call_json("TimeSeries", payload)

    def block_scorecard(self, last: Optional[int] = None) -> dict:
        """The node's per-height block scorecard ring (the
        ``BlockScorecard`` RPC): ``{"node_id", "height", "rows"}`` —
        one row per height with prepare/process walls, extend leg,
        propagation delay, commit lag and the critical-path top
        contributors.  The server ingests freshly completed traces
        before answering, so a row exists right after its block."""
        payload: dict = {}
        if last is not None:
            payload["last"] = int(last)
        return self._call_json("BlockScorecard", payload)

    def host_profile(self, top: int = 25, folded: int = 200) -> dict:
        """The node's host sampling-profiler view (the ``HostProfile``
        RPC): ``{"stats", "top_frames", "folded"}`` — folded stacks are
        bounded to the top N by count."""
        return self._call_json(
            "HostProfile", {"top": int(top), "folded": int(folded)}
        )

    def flight_list(self) -> dict:
        """Kept incident-bundle manifests + recorder ring stats (the
        ``FlightList`` RPC); ``{"enabled": false}`` on a node running
        without --flight-dir."""
        return self._call_json("FlightList", {})

    def flight_fetch(self, incident_id: str = "") -> dict:
        """One full incident bundle (the ``FlightFetch`` RPC): manifest
        plus every artifact as text.  Empty id fetches the newest.
        Large bundles arrive file-by-file (the server answers
        ``files_inline: false`` when the inline form would blow this
        channel's 4 MiB receive cap); the per-file fetches are folded
        back into the inline shape, so callers never see the split."""
        out = self._call_json("FlightFetch", {"id": incident_id})
        if not out.get("found") or out.get("files_inline") is not False:
            return out
        files = {}
        inc_id = out["manifest"]["id"]
        for entry in out["manifest"].get("files", []):
            name = entry.get("name", "")
            part = self._call_json(
                "FlightFetch", {"id": inc_id, "file": name}
            )
            if part.get("found"):
                files[name] = part.get("content", "")
                if part.get("truncated"):
                    files[name] += "\n<truncated by transport cap>"
        return {"found": True, "manifest": out["manifest"], "files": files}

    def clock_probe(self) -> dict:
        """One peer telemetry-clock read: ``{"ts", "node_id",
        "height"}`` (the ClockProbe RPC)."""
        return self._call_json("ClockProbe", {})

    def clock_offset(self, samples: int = 5) -> dict:
        """Midpoint-estimate this peer's clock offset/RTT
        (``{"offset_s", "rtt_s", "samples"}``; see
        tracing.estimate_clock_offset).  Raises RemoteError against an
        un-upgraded peer without the ClockProbe RPC — callers treat
        that as offset unknown (0)."""
        return tracing.estimate_clock_offset(
            lambda: self.clock_probe()["ts"], samples=samples
        )

    # -- consensus surface (used by node/coordinator.py) ----------------

    def cons_prepare(self) -> dict:
        out = self._call_json("ConsPrepare", self._attach_tc({}))
        result = {
            "block_txs": [bytes.fromhex(t) for t in out["block_txs"]],
            "square_size": out["square_size"],
            "data_root": bytes.fromhex(out["data_root"]),
        }
        # the proposer's prepare-root trace context, when its tracer is
        # on: the coordinator forwards this into cons_process/commit so
        # validator-side spans carry the PROPOSER as their cross-node
        # parent (old servers simply never return it)
        if out.get("_tc"):
            result["_tc"] = out["_tc"]
        return result

    def cons_process(
        self, block_txs, square_size: int, data_root: bytes, tc=None
    ):
        out = self._call_json(
            "ConsProcess",
            self._attach_tc(
                {
                    "block_txs": [t.hex() for t in block_txs],
                    "square_size": square_size,
                    "data_root": data_root.hex(),
                },
                tc=tc,
            ),
        )
        return out["accept"], out.get("reason", "")

    def cons_commit(
        self, block_txs, height: int, time_ns: int, data_root: bytes,
        square_size: int, proposer: bytes = b"", votes=None, tc=None,
    ) -> bytes:
        out = self._call_json(
            "ConsCommit",
            self._attach_tc(
                {
                    "block_txs": [t.hex() for t in block_txs],
                    "height": height,
                    "time_ns": time_ns,
                    "data_root": data_root.hex(),
                    "square_size": square_size,
                    "proposer": proposer.hex(),
                    "votes": (
                        [[a.hex(), bool(ok)] for a, ok in votes]
                        if votes is not None
                        else None
                    ),
                },
                tc=tc,
                height=height,
            ),
        )
        return bytes.fromhex(out["app_hash"])

    # -- two-phase BFT surface (dumb-relay transport, node/bft.py) ------

    def bft_start(self, height: int) -> None:
        self._call_json("BftStart", {"height": height})

    def bft_msg(self, wire: dict) -> None:
        # the relay forwards wires verbatim (no outer envelope), so the
        # trace context rides INSIDE the wire dict under "_tc": old
        # receivers hand it to an engine that ignores unknown keys, new
        # receivers strip it before delivery.  Never mutate the caller's
        # dict — the relay re-forwards the same object to other peers.
        if tracing.enabled():
            wire = dict(
                wire,
                _tc=tracing.wire_context(
                    height=int(wire.get("height", 0) or 0)
                ),
            )
        self._call_json("BftMsg", wire)

    def bft_timeout(self, step: str, height: int, round_: int) -> None:
        self._call_json(
            "BftTimeout", {"step": step, "height": height, "round": round_}
        )

    def bft_drain(self) -> dict:
        return self._call_json("BftDrain", {})

    def bft_decided(self, height: int) -> Optional[dict]:
        out = self._call_json("BftDecided", {"height": height})
        return out["decided"] if out["found"] else None

    def bft_catchup(self, decided_wire: dict) -> bool:
        return bool(self._call_json("BftCatchup", decided_wire)["ok"])

    # -- p2p gossip mesh surface (node/gossip.py) -----------------------

    def gossip_msg(self, payload: dict) -> bool:
        """Deliver a flooded consensus message: {"wire", "sender"}.  The
        dedup id is always computed receiver-side from the wire content —
        a sender-supplied id would be a censorship vector."""
        return bool(self._call_json("GossipMsg", payload).get("new"))

    def tx_have(self, hashes) -> list:
        """Announce pooled tx hashes; returns the subset the peer wants."""
        out = self._call_json(
            "TxHave", {"hashes": [h.hex() for h in hashes]}
        )
        return [bytes.fromhex(h) for h in out.get("want", [])]

    def tx_push(self, raws) -> int:
        out = self._call_json("TxPush", {"txs": [r.hex() for r in raws]})
        return int(out.get("admitted", 0))

    def peer_exchange(self, sender: str, peers) -> list:
        """PEX: offer our address + known peers, learn the callee's."""
        out = self._call_json(
            "PeerExchange", {"sender": sender, "peers": list(peers)}
        )
        return list(out.get("peers", []))

    def das_sample(
        self, height: int, row: int, col: int, *, policy=None, peer=None
    ):
        """One DAS cell + proof from the node's serving plane.

        A shed response (load shedding or an injected serving fault) is
        retried through the unified RetryPolicy, honoring the server's
        ``retry_after_ms`` pushback; returns the sample dict
        ``{"proof": ..., "data_root": ...}``.  The final shed attempt
        raises :class:`faults.Overloaded` — the caller's signal that the
        plane is saturated, not broken.

        ``peer`` (optional) stamps a client-asserted identity on the
        envelope for the server's per-peer QoS accounting; omitted =
        anonymous, and old servers ignore the field (version-tolerant
        envelopes)."""
        from celestia_tpu_torch.utils import faults

        if policy is None:
            policy = faults.RetryPolicy(
                attempts=6, base_s=0.02, cap_s=0.25,
                deadline_s=self.timeout_s,
            )

        def attempt():
            payload = {"height": height, "row": row, "col": col}
            if peer:
                payload["peer"] = str(peer)
            out = self._call_json(
                "DasSample",
                self._attach_tc(payload, height=height),
            )
            if out.get("shed"):
                raise faults.Overloaded(
                    out.get("log") or "DAS serving plane shed the request",
                    retry_after_ms=float(out.get("retry_after_ms", 25.0)),
                )
            if out.get("code"):
                raise RemoteError(out.get("log", "das sample failed"))
            return out

        return policy.run(attempt, retry_on=(faults.Overloaded,))

    def das_sample_batch(
        self, height: int, coords, *, policy=None, chunk: int = 0,
        peer=None,
    ) -> dict:
        """n DAS cells + proofs in ONE streaming request (the
        DasSampleBatch RPC): the server proves row-grouped chunks and
        streams them back, re-passing its load-shed gate per chunk.

        A mid-stream shed carries ``served`` (cells already streamed)
        and ``retry_after_ms``; this client keeps every proof it has,
        drops the served prefix, and retries ONLY the remainder through
        the unified RetryPolicy — honest pushback costs re-requesting
        nothing.  Returns ``{"proofs": [...], "data_root": hex}`` with
        proofs in the requested coordinate order; the final shed attempt
        raises :class:`faults.Overloaded`.  ``peer`` stamps the optional
        client-asserted identity for per-peer QoS accounting (see
        :meth:`das_sample`)."""
        from celestia_tpu_torch.utils import faults

        if policy is None:
            policy = faults.RetryPolicy(
                attempts=6, base_s=0.02, cap_s=0.25,
                deadline_s=self.timeout_s,
            )
        remaining = [(int(r), int(c)) for r, c in coords]
        proofs: list = []
        state = {"data_root": ""}

        def attempt():
            payload = {
                "height": int(height),
                "coords": [[r, c] for r, c in remaining],
            }
            if chunk:
                payload["chunk"] = int(chunk)
            if peer:
                payload["peer"] = str(peer)
            stream = self._call_stream(
                "DasSampleBatch",
                json.dumps(
                    self._attach_tc(payload, height=int(height))
                ).encode(),
            )
            while True:
                try:
                    resp = next(stream)
                except StopIteration:
                    break
                except RemoteError as e:
                    # a transport drop MID-conversation (some chunks
                    # already landed, this attempt or an earlier one) is
                    # retried like shed load — partial progress is kept
                    # and only the remainder re-requested, exactly as a
                    # clean early EOF would be.  A server that never
                    # answered at all stays a hard RemoteError.
                    if proofs:
                        raise faults.Overloaded(
                            f"DAS batch stream dropped: {e}",
                            retry_after_ms=25.0,
                        ) from e
                    raise
                out = json.loads(resp)
                if out.get("shed"):
                    # every chunk already streamed trimmed `remaining`
                    # below, so the retry asks only for the rest
                    raise faults.Overloaded(
                        out.get("log")
                        or "DAS serving plane shed the batch",
                        retry_after_ms=float(
                            out.get("retry_after_ms", 25.0)
                        ),
                    )
                if out.get("code"):
                    raise RemoteError(
                        out.get("log", "das sample batch failed")
                    )
                got = out.get("proofs", [])
                proofs.extend(got)
                del remaining[: len(got)]
                root = out.get("data_root", "")
                if state["data_root"] and root != state["data_root"]:
                    raise RemoteError(
                        "data_root changed mid-stream"
                    )
                state["data_root"] = root
            if remaining:
                # stream ended without a shed marker but short: treat
                # as overload (a crashing server must not look like a
                # complete answer)
                raise faults.Overloaded(
                    "DAS batch stream ended early",
                    retry_after_ms=25.0,
                )
            return {"proofs": proofs, "data_root": state["data_root"]}

        return policy.run(attempt, retry_on=(faults.Overloaded,))

    def genesis(self):
        """The peer's genesis document, or None (download-genesis)."""
        out = self._call_json("Genesis", {})
        return out.get("genesis") if out.get("found") else None

    # -- state-sync (snapshot serving) ----------------------------------

    def snapshot_list(self) -> list:
        """Snapshot metadata dicts the peer can serve (state-sync)."""
        return list(self._call_json("SnapshotList", {}).get("snapshots", []))

    def snapshot_chunk(self, height: int, fmt: int, idx: int):
        out = self._call_json(
            "SnapshotChunk",
            self._attach_tc(
                {"height": height, "format": fmt, "idx": idx}, height=height
            ),
        )
        if not out.get("found"):
            return None
        data = out["data"]
        # size-bound the HEX payload before decoding.  The transport cap
        # (MAX_RECV_BYTES on the channel — the layer that actually stops
        # an arbitrarily large response from being buffered) has already
        # bounded the message; this check catches a hostile-but-small
        # oversized chunk early, with the precise SnapshotLimitError the
        # sync engine uses to back the peer off
        from celestia_tpu_torch.node.snapshots import (
            MAX_WIRE_CHUNK_BYTES,
            SnapshotLimitError,
        )

        if len(data) > 2 * MAX_WIRE_CHUNK_BYTES:
            raise SnapshotLimitError(
                f"snapshot chunk {idx} hex payload is {len(data)} chars "
                f"(cap {2 * MAX_WIRE_CHUNK_BYTES})"
            )
        return bytes.fromhex(data)

    def wait_for_height(self, h: int, timeout_s: float = 60.0) -> None:
        from celestia_tpu_torch.utils.faults import RetryPolicy

        RetryPolicy(base_s=0.05, cap_s=0.2, deadline_s=timeout_s).poll(
            lambda: self.height >= h, what=f"height {h}"
        )
