"""Cluster observability: fold N nodes' planes into one operator view.

Two rollups over the per-node RPC surface (node/server.py):

* **Cluster trace** — fan ``TraceDump`` out to every peer, probe each
  peer's clock offset (RPC midpoint method, ClockProbe), and merge the
  dumps into ONE Chrome trace-event document: one Chrome "process" per
  node (named by its node id), every timestamp shifted onto the
  collector's timeline, and every span that recorded an explicit
  cross-node parent (``remote_node``/``remote_span`` args — see
  utils/tracing.py) resolved into a flow arrow from the sender's span
  to the receiver's.  Open the result in Perfetto and the proposer's
  prepare, the validators' process legs and the gossip hops line up on
  adjacent tracks.

* **Cluster health** — fan ``Status`` + ``Metrics`` out and aggregate
  the operational signals one page answers: per-peer height/app-hash,
  gossip breaker states, cache hit rates, fault-note/
  degradation/shed totals and the per-RPC byte/call counters.

Consumed by ``celestia-tpu query cluster-trace`` / ``cluster-health``
(cli.py) and the file-driven ``tools/trace_merge.py``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from celestia_tpu_torch.utils import faults, tracing

# ---------------------------------------------------------------------------
# collection (per peer)
# ---------------------------------------------------------------------------


def collect_trace(client, last: Optional[int] = None, probes: int = 5) -> dict:
    """One peer's TraceDump + clock offset, in the merge input shape:
    ``{"node_id", "clock_offset_s", "rtt_s", "enabled", "trace"}``.
    An un-upgraded peer without the ClockProbe RPC merges at offset 0
    (its track still renders; only alignment degrades), and a peer that
    dies between dial and fan-out contributes an empty track annotated
    with its error — the other N-1 nodes still merge."""
    try:
        out = client.trace_dump(last=last)
    except Exception as e:
        faults.note("cluster.trace_dump", e)
        return {
            "node_id": str(getattr(client, "address", "")),
            "clock_offset_s": 0.0,
            "rtt_s": 0.0,
            "enabled": False,
            "error": str(e)[:200],
            "trace": {"traceEvents": [], "otherData": {}},
        }
    trace = out.get("trace", {}) or {}
    node_id = str(
        trace.get("otherData", {}).get("node_id", "")
        or getattr(client, "address", "")
    )
    offset_s, rtt_s = 0.0, 0.0
    try:
        probe = client.clock_offset(samples=probes)
        offset_s, rtt_s = probe["offset_s"], probe["rtt_s"]
    except Exception as e:
        faults.note("cluster.clock_probe", e)
    return {
        "node_id": node_id,
        "clock_offset_s": offset_s,
        "rtt_s": rtt_s,
        "enabled": bool(out.get("enabled")),
        "trace": trace,
    }


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


def merge_node_dumps(parts: List[dict]) -> dict:
    """Fold N per-node trace parts (:func:`collect_trace` shape, or a
    bare Chrome doc under ``"trace"``) into one Perfetto timeline.

    Per part: a distinct Chrome pid with a ``process_name`` metadata
    event carrying the node id; every event's ``ts`` shifted by that
    node's ``clock_offset_s`` (peer minus collector, so subtracting
    lands on the collector's axis).  Then every event whose args name a
    cross-node parent is resolved against a (node, span) index of ALL
    parts and emitted as a Chrome flow ``s``/``f`` pair — the explicit
    cross-node link between the sender's span and the receiver's."""
    events_out: List[dict] = []
    span_index: Dict[Tuple[str, int], dict] = {}
    linked: List[Tuple[dict, dict]] = []  # (event, its remote args)
    nodes: List[dict] = []
    for i, part in enumerate(parts):
        pid = i + 1
        trace = part.get("trace", part) or {}
        node_id = str(
            part.get("node_id", "")
            or trace.get("otherData", {}).get("node_id", "")
            or f"node-{pid}"
        )
        offset_us = float(part.get("clock_offset_s", 0.0) or 0.0) * 1e6
        node_entry = {
            "node_id": node_id,
            "pid": pid,
            "clock_offset_s": part.get("clock_offset_s", 0.0),
            "rtt_s": part.get("rtt_s", 0.0),
        }
        if part.get("error"):
            # a peer that failed collection still gets its (empty) track,
            # but the merged doc must say WHY it is empty — "unreachable"
            # and "tracing off" are different operator problems
            node_entry["error"] = part["error"]
        nodes.append(node_entry)
        events_out.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "args": {"name": node_id},
            }
        )
        events_out.append(
            {
                "ph": "M",
                "name": "process_sort_index",
                "pid": pid,
                "args": {"sort_index": pid},
            }
        )
        for ev in trace.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                continue  # replaced by the per-node entry above
            ev = dict(ev, pid=pid)
            if "ts" in ev:
                ev["ts"] = round(float(ev["ts"]) - offset_us, 3)
            args = ev.get("args")
            if isinstance(args, dict):
                sid = args.get("span_id")
                if isinstance(sid, int) and sid > 0 and ev.get("ph") in (
                    "X", "b"
                ):
                    span_index.setdefault((node_id, sid), ev)
                if args.get("remote_node") and args.get("remote_span"):
                    linked.append((ev, args))
            events_out.append(ev)
    flows = _flow_events(span_index, linked)
    events_out.extend(flows)
    return {
        "displayTimeUnit": "ms",
        "traceEvents": events_out,
        "otherData": {
            "tracer": "celestia-tpu-cluster",
            "nodes": nodes,
            "cross_node_flows": len(flows) // 2,
        },
    }


def _flow_events(
    span_index: Dict[Tuple[str, int], dict],
    linked: List[Tuple[dict, dict]],
) -> List[dict]:
    """Chrome flow ``s``/``f`` pairs for every resolvable cross-node
    link.  The ``s`` event binds inside the SOURCE span's interval (its
    end, minus an epsilon: the send happens after the work) and the
    ``f`` event (``bp: "e"``) inside the destination's start — the
    binding rule Perfetto uses to attach arrows to slices.  Links whose
    source span lives in a dump we did not collect (ring rolled over,
    peer missing) are skipped — attribution degrades, never errors."""
    out: List[dict] = []
    flow_id = 0
    for ev, args in linked:
        src = span_index.get((args["remote_node"], args["remote_span"]))
        if src is None or src is ev:
            continue
        flow_id += 1
        src_ts = float(src.get("ts", 0.0))
        src_end = src_ts + max(0.0, float(src.get("dur", 0.0)) - 1.0)
        base = {
            "name": "xnode",
            "cat": "xnode",
            "id": str(flow_id),
        }
        out.append(
            dict(
                base,
                ph="s",
                pid=src["pid"],
                tid=src.get("tid", 0),
                ts=round(src_end, 3),
            )
        )
        out.append(
            dict(
                base,
                ph="f",
                bp="e",
                pid=ev["pid"],
                tid=ev.get("tid", 0),
                ts=round(float(ev.get("ts", 0.0)) + 1.0, 3),
            )
        )
    return out


def cluster_trace(
    clients, last: Optional[int] = None, probes: int = 5
) -> dict:
    """Fan TraceDump+ClockProbe out to every client and merge: the
    ``query cluster-trace`` backend.  Returns the merged Chrome doc."""
    return merge_node_dumps(
        [collect_trace(c, last=last, probes=probes) for c in clients]
    )


# ---------------------------------------------------------------------------
# per-height mesh waterfall
# ---------------------------------------------------------------------------


def mesh_waterfall(doc: dict, height: Optional[int] = None) -> dict:
    """Per-height latency waterfall across a merged mesh trace.

    For every height with a block root in ``doc`` (a
    :func:`merge_node_dumps` product — all timestamps on the
    collector's clock axis): the proposer's prepare wall, each
    validator's process wall with its propagation hop (``_tc`` send ts
    shifted by the node's clock offset, clamped at 0 on skew), start /
    end offsets relative to the proposer's prepare start, the
    propagation SPREAD (max - min hop delay: how unevenly gossip
    reached the mesh) and the slowest validator NAMED (latest
    wall-clock finisher — the node actually holding up the round).
    ``height`` filters to one height; default rolls up every height in
    the doc.
    """
    from celestia_tpu_torch.utils import critpath

    spans, offsets = critpath.extract_spans(doc)
    by_height: Dict[int, list] = {}
    for s in spans:
        if s.name not in critpath.BLOCK_ROOT_NAMES:
            continue
        try:
            h = int(s.args.get("height"))
        except (TypeError, ValueError):
            continue
        if height is not None and h != int(height):
            continue
        by_height.setdefault(h, []).append(s)

    heights = []
    for h in sorted(by_height):
        roots = by_height[h]
        proposer = None
        for s in roots:
            if s.name == "prepare_proposal" and (
                proposer is None or s.t0 < proposer.t0
            ):
                proposer = s
        t_zero = proposer.t0 if proposer is not None else min(s.t0 for s in roots)
        validators = []
        for s in sorted(
            (x for x in roots if x.name == "process_proposal"),
            key=lambda x: x.t0,
        ):
            entry = {
                "node": s.node,
                "process_ms": round(s.wall_ms, 3),
                "start_ms": round((s.t0 - t_zero) * 1000.0, 3),
                "end_ms": round((s.t1 - t_zero) * 1000.0, 3),
            }
            hop = critpath.hop_delay_ms(s, offsets)
            if hop is not None:
                entry["propagation_ms"], entry["clamped"] = hop
            validators.append(entry)
        delays = [
            v["propagation_ms"] for v in validators if "propagation_ms" in v
        ]
        slowest = max(validators, key=lambda v: v["end_ms"], default=None)
        row = {
            "height": h,
            "proposer": (
                {
                    "node": proposer.node,
                    "prepare_ms": round(proposer.wall_ms, 3),
                }
                if proposer is not None
                else None
            ),
            "validators": validators,
            "propagation_spread_ms": (
                round(max(delays) - min(delays), 3) if delays else None
            ),
            "slowest_validator": slowest["node"] if slowest else None,
        }
        heights.append(row)
    return {
        "heights": heights,
        "nodes": sorted({s.node for s in spans if s.node}),
    }


# ---------------------------------------------------------------------------
# cluster health
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>[^}]*)\})?'
    r' (?P<value>[+-]?[0-9.eE+-]+)$'
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_exposition(text: str) -> List[Tuple[str, Dict[str, str], float]]:
    """Minimal Prometheus text parse: (metric, labels, value) triples.
    Comment/TYPE lines are skipped; unparseable lines are ignored (the
    exposition's own validity gate lives in telemetry tests)."""
    out = []
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = _SAMPLE_RE.match(ln)
        if m is None:
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels") or ""))
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.append((m.group("name"), labels, value))
    return out


def _peer_health(client) -> dict:
    status = client.status()
    samples = parse_exposition(client.metrics())
    by_name: Dict[str, float] = {}
    cache_hits: Dict[str, float] = {}
    cache_misses: Dict[str, float] = {}
    rpc: Dict[str, dict] = {}
    alerts: Dict[str, bool] = {}
    peer_served: Dict[str, int] = {}
    peer_shed: Dict[str, int] = {}
    lanes: Dict[str, dict] = {}
    node_info = ""
    for name, labels, value in samples:
        if name == "celestia_tpu_node_info":
            node_info = labels.get("node_id", "")
        elif name == "celestia_tpu_cache_hits_total":
            cache_hits[labels.get("cache", "?")] = value
        elif name == "celestia_tpu_cache_misses_total":
            cache_misses[labels.get("cache", "?")] = value
        elif name == "celestia_tpu_alert_firing":
            alerts[labels.get("rule", "?")] = bool(value)
        elif name == "celestia_tpu_das_peer_served_total":
            peer_served[labels.get("peer", "?")] = int(value)
        elif name == "celestia_tpu_das_peer_shed_total":
            peer_shed[labels.get("peer", "?")] = int(value)
        elif name.startswith("celestia_tpu_das_lane_"):
            lane = labels.get("lane", "?")
            key = name[len("celestia_tpu_das_lane_"):].replace("_total", "")
            lanes.setdefault(lane, {})[key] = int(value)
        elif name.startswith("celestia_tpu_rpc_"):
            m = re.match(
                r"celestia_tpu_rpc_(client_)?(\w+?)_"
                r"(calls|bytes_in|bytes_out|errors)_total$",
                name,
            )
            if m:
                side = "client" if m.group(1) else "server"
                method = m.group(2)
                rpc.setdefault(side, {}).setdefault(method, {})[
                    m.group(3)
                ] = int(value)
        elif not labels:
            by_name[name] = value
    caches = {
        name: {
            "hits": int(hits),
            "misses": int(cache_misses.get(name, 0)),
            "hit_rate": round(
                hits / (hits + cache_misses.get(name, 0)), 4
            )
            if (hits + cache_misses.get(name, 0)) > 0
            else 0.0,
        }
        for name, hits in sorted(cache_hits.items())
    }
    gossip = status.get("gossip", {})
    # DAS serving plane rollup (batch prover + das_rows cache): read
    # straight off the scrape, so the page needs no extra RPC.  Single-
    # cell + batch sheds combined — a mesh shedding only on the batch
    # plane must not read as a healthy serving plane — and computed
    # ONCE: the legacy top-level das_shed references the same figure.
    das = {
        "samples_served": int(
            by_name.get("celestia_tpu_das_samples_served_total", 0)
        ),
        "batch_calls": int(
            by_name.get("celestia_tpu_das_batch_calls_total", 0)
        ),
        "shed": int(
            by_name.get("celestia_tpu_das_sample_shed_total", 0)
        )
        + int(by_name.get("celestia_tpu_das_batch_shed_total", 0)),
        "rows_hit_rate": float(
            by_name.get("celestia_tpu_das_rows_hit_rate", 0.0)
        ),
        # per-peer QoS accounting (bounded labels — the serving node's
        # LRU-backed registry caps cardinality): identified clients'
        # served/shed counts, per-lane gate pressure, and this node's
        # own fairness index (None until a peer has been served —
        # skip-absent survives the scrape)
        "clients": len(peer_served),
        "peer_served": peer_served,
        "peer_shed": peer_shed,
        "lanes": lanes,
        "fairness_index": (
            float(by_name["celestia_tpu_das_fairness_index"])
            if "celestia_tpu_das_fairness_index" in by_name
            else None
        ),
    }
    return {
        "node_id": node_info
        or str(getattr(client, "address", "") or status.get("chain_id", "")),
        "address": str(getattr(client, "address", "")),
        "chain_id": status.get("chain_id", ""),
        "height": int(status.get("height", 0)),
        "app_hash": status.get("app_hash", ""),
        "data_root": status.get("data_root", ""),
        "gossip": {
            "peers": gossip.get("peers", 0),
            "dropped_total": gossip.get("dropped_total", 0),
            "pull_breakers": gossip.get("pull_breakers", {}),
        },
        "fault_notes": int(by_name.get("celestia_tpu_fault_notes_total", 0)),
        "degradations": int(
            by_name.get("celestia_tpu_degradations_total", 0)
        ),
        "das_shed": das["shed"],
        "das": das,
        "caches": caches,
        "rpc": rpc,
        # trace-ring health: silent span truncation
        # and a ballooning background ring on a busy node are now
        # visible from the scrape, not only in a local dump
        "trace": {
            "span_drops": int(
                by_name.get("celestia_tpu_trace_span_drops_total", 0)
            ),
            "background_depth": int(
                by_name.get("celestia_tpu_trace_background_depth", 0)
            ),
        },
        # declarative alert states (utils/timeseries.py): rule -> firing
        "alerts": alerts,
        "alerts_firing": sum(1 for v in alerts.values() if v),
        # flight-recorder incident count (lifetime, from the scrape) —
        # a node that has been black-boxing incidents is visible
        # mesh-wide without a second RPC
        "incidents": int(
            by_name.get("celestia_tpu_flight_incidents_total", 0)
        ),
    }


def _aggregate_clients(healthy: List[dict]) -> Dict[str, Dict[str, int]]:
    """Per-CLIENT served/shed summed across every serving node (one
    light client may sample from many nodes — fairness is judged on
    what the mesh as a whole gave it)."""
    agg: Dict[str, Dict[str, int]] = {}
    for p in healthy:
        das = p.get("das", {})
        for cid, served in das.get("peer_served", {}).items():
            agg.setdefault(cid, {"served": 0, "shed": 0})["served"] += served
        for cid, shed in das.get("peer_shed", {}).items():
            agg.setdefault(cid, {"served": 0, "shed": 0})["shed"] += shed
    return agg


def _mesh_fairness(healthy: List[dict]):
    from celestia_tpu_torch.utils.telemetry import jain_fairness_index

    agg = _aggregate_clients(healthy)
    return jain_fairness_index(st["served"] for st in agg.values())


def _top_over_askers(healthy: List[dict], k: int = 5) -> List[dict]:
    agg = _aggregate_clients(healthy)
    ranked = sorted(
        agg.items(),
        key=lambda it: (-(it[1]["served"] + it[1]["shed"]), it[0]),
    )
    return [
        {"peer": cid, "served": st["served"], "shed": st["shed"]}
        for cid, st in ranked[:k]
    ]


def cluster_health(clients, probes: int = 3) -> dict:
    """The coordinator-side aggregated health page: per-peer status +
    metrics rollup plus cluster-level agreement/spread summary.  An
    unreachable peer is reported with its error, never dropped
    silently."""
    peers: List[dict] = []
    for client in clients:
        addr = str(getattr(client, "address", ""))
        try:
            h = _peer_health(client)
            try:
                h["clock_offset_s"] = client.clock_offset(samples=probes)[
                    "offset_s"
                ]
            except Exception as e:  # un-upgraded peer: offset unknown
                faults.note("cluster.clock_probe", e)
                h["clock_offset_s"] = None
            peers.append(h)
        except Exception as e:
            peers.append({"node_id": addr, "error": str(e)[:200]})
    healthy = [p for p in peers if "error" not in p]
    heights = [p["height"] for p in healthy]
    # app-hash agreement is judged among the peers AT the max height;
    # laggards are a spread problem, not (yet) a fork
    top = [p for p in healthy if heights and p["height"] == max(heights)]
    return {
        "peers": peers,
        "reachable": len(healthy),
        "unreachable": len(peers) - len(healthy),
        "min_height": min(heights) if heights else 0,
        "max_height": max(heights) if heights else 0,
        "height_spread": (max(heights) - min(heights)) if heights else 0,
        # None (unknown) when nobody answered: a fully-dark cluster must
        # not read as healthy consensus to automation keying off this
        "app_hash_agree": (
            len({p["app_hash"] for p in top}) <= 1 if top else None
        ),
        "breakers_open": sum(
            1
            for p in healthy
            for state in p["gossip"]["pull_breakers"].values()
            if state != "closed"
        ),
        "degradations": sum(p["degradations"] for p in healthy),
        "das_shed": sum(p["das_shed"] for p in healthy),
        # serving-plane rollup: total cells served across the mesh and
        # the peers shedding batch load (the ones to scale out first)
        "das_samples_served": sum(
            p.get("das", {}).get("samples_served", 0) for p in healthy
        ),
        "das_shedding_peers": sorted(
            p["node_id"]
            for p in healthy
            if p.get("das", {}).get("shed", 0) > 0
        ),
        # swarm fairness rollup: Jain index over per-CLIENT served
        # counts aggregated across every serving node (None until any
        # node reports identified peers), and the top over-askers NAMED
        # — the clients to demote/pin first
        "das_fairness_index": _mesh_fairness(healthy),
        "das_top_over_askers": _top_over_askers(healthy),
        "fault_notes": sum(p["fault_notes"] for p in healthy),
        # mesh-wide degradation flags: summed trace truncation
        # and every peer with at least one firing alert rule — the
        # degrading node is NAMED across the mesh, not observed post-hoc
        "trace_span_drops": sum(
            p.get("trace", {}).get("span_drops", 0) for p in healthy
        ),
        "alerts_firing": sum(p.get("alerts_firing", 0) for p in healthy),
        "degraded_peers": sorted(
            p["node_id"] for p in healthy if p.get("alerts_firing", 0) > 0
        ),
        # flight-recorder rollup: total incidents across the mesh plus
        # every peer that captured at least one (named, like
        # degraded_peers — the operator pulls those bundles first)
        "incidents": sum(p.get("incidents", 0) for p in healthy),
        "incident_peers": sorted(
            p["node_id"] for p in healthy if p.get("incidents", 0) > 0
        ),
        "collector_node_id": tracing.node_id(),
    }


def discover_peers(client, max_peers: int = 64) -> List[str]:
    """Peer addresses learned from one node's PEX surface (the CLI's
    fan-out discovery when --nodes is not given).  Returns dialable
    addresses, the seed's own excluded."""
    try:
        peers = client.peer_exchange("", [])
    except Exception as e:
        faults.note("cluster.discover", e)
        return []
    out: List[str] = []
    for addr in peers:
        if isinstance(addr, str) and addr and addr not in out:
            out.append(addr)
        if len(out) >= max_peers:
            break
    return out
