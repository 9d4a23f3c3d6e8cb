"""The port's cluster observability (``celestia_tpu_torch/node/cluster.py``)
against the JAX package's.

Both packages' ``cluster_trace``, ``mesh_waterfall``, ``cluster_health``
and ``discover_peers`` run over the same seeded per-node clients: trace
dumps with block roots, gossip hops and cross-node links (some
unresolvable), clock offsets (one probe failing), status answers and
metric expositions in the families ``cluster.py`` reads (one peer
unreachable).  Their outputs must be equal as canonical JSON.  Then
``cluster_health`` over a live pair, one JAX ``NodeServer`` and one port
``NodeServer`` on 127.0.0.1, through each package's ``RemoteNode``: both
rollups see two reachable peers at one height and app hash, and a peer
of either package rolls up with the same fields.
"""

import json

import numpy as np
import pytest

from celestia_tpu.node import cluster as jax_cluster
from celestia_tpu.node import remote as jax_remote
from celestia_tpu.node import server as jax_server
from celestia_tpu.node import testnode as jax_testnode
from celestia_tpu.utils import tracing as jax_tracing
from celestia_tpu_torch.node import cluster
from celestia_tpu_torch.node import remote as port_remote
from celestia_tpu_torch.node import server as port_server
from celestia_tpu_torch.node import testnode as port_testnode
from celestia_tpu_torch.utils import tracing

NODES = 4
HEIGHTS = range(2, 7)
GENESIS_NS = 1_700_000_000_000_000_000


def canonical(x) -> str:
    return json.dumps(x, sort_keys=True)


def seeded_dumps(rng):
    """Per-node Chrome docs: at each height the proposer's prepare root and
    a gossip push; each other node's process root linked to the push (its
    send time carried), an rpc span linked to a node never collected, and
    a fault instant."""
    ids = [f"val-{i}" for i in range(NODES)]
    events = {nid: [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": nid}}]
              for nid in ids}
    sid = 1
    for h in HEIGHTS:
        proposer = ids[h % NODES]
        t0 = h * 1e6 + float(rng.uniform(0, 1e4))
        prep, push = sid, sid + 1
        sid += 2
        events[proposer] += [
            {"ph": "X", "name": "prepare_proposal", "cat": "block", "ts": t0,
             "dur": float(rng.uniform(1e3, 5e4)), "pid": 1, "tid": 5,
             "args": {"span_id": prep, "parent_id": 0, "height": h}},
            {"ph": "X", "name": "gossip.push", "cat": "gossip", "ts": t0 + 100.0,
             "dur": float(rng.uniform(10, 500)), "pid": 1, "tid": 6,
             "args": {"span_id": push, "parent_id": prep, "height": h}},
        ]
        for nid in ids:
            if nid == proposer:
                continue
            start = t0 + float(rng.uniform(200, 3e4))
            events[nid] += [
                {"ph": "X", "name": "process_proposal", "cat": "block", "ts": start,
                 "dur": float(rng.uniform(1e3, 4e4)), "pid": 1, "tid": 5,
                 "args": {"span_id": sid, "parent_id": 0, "height": h,
                          "remote_node": proposer, "remote_span": push,
                          "remote_send_ts": (t0 + 150.0) / 1e6}},
                {"ph": "X", "name": "rpc.cons_commit", "cat": "rpc", "ts": start + 50.0,
                 "dur": 20.0, "pid": 1, "tid": 7,
                 "args": {"span_id": sid + 1, "parent_id": 0,
                          "remote_node": "val-gone", "remote_span": 999}},
                {"ph": "i", "name": "fault.note", "ts": start + 60.0, "pid": 1, "tid": 7,
                 "s": "t", "args": {"point": "gossip.fetch", "node_id": nid}},
            ]
            sid += 2
    return {nid: {"displayTimeUnit": "ms", "traceEvents": evs,
                  "otherData": {"node_id": nid, "blocks": []}}
            for nid, evs in events.items()}


def seeded_exposition(rng, nid: str) -> str:
    lines = [f'celestia_tpu_node_info{{node_id="{nid}"}} 1']
    for cache in ("eds", "commitment", "sig"):
        lines.append(f'celestia_tpu_cache_hits_total{{cache="{cache}"}} {int(rng.integers(0, 99))}')
        lines.append(f'celestia_tpu_cache_misses_total{{cache="{cache}"}} '
                     f'{int(rng.integers(0, 99))}')
    for rule in ("das_fairness_floor", "shed_rate"):
        lines.append(f'celestia_tpu_alert_firing{{rule="{rule}"}} {int(rng.integers(0, 2))}')
    for peer in ("swarm-g0-0001", "hostile-g0-0000"):
        lines.append(f'celestia_tpu_das_peer_served_total{{peer="{peer}"}} '
                     f'{int(rng.integers(0, 500))}')
        lines.append(f'celestia_tpu_das_peer_shed_total{{peer="{peer}"}} '
                     f'{int(rng.integers(0, 50))}')
    for lane in ("light", "bulk"):
        lines.append(f'celestia_tpu_das_lane_admitted_total{{lane="{lane}"}} '
                     f'{int(rng.integers(0, 300))}')
    for method in ("status", "das_sample_batch"):
        for field in ("calls", "bytes_in", "bytes_out", "errors"):
            lines.append(f"celestia_tpu_rpc_{method}_{field}_total {int(rng.integers(0, 9999))}")
            lines.append(f"celestia_tpu_rpc_client_{method}_{field}_total "
                         f"{int(rng.integers(0, 9999))}")
    for name in ("das_samples_served_total", "das_batch_calls_total", "das_sample_shed_total",
                 "das_batch_shed_total", "fault_notes_total", "degradations_total",
                 "trace_span_drops_total", "trace_background_depth",
                 "flight_incidents_total"):
        lines.append(f"celestia_tpu_{name} {int(rng.integers(0, 1000))}")
    lines.append(f"celestia_tpu_das_rows_hit_rate {round(float(rng.uniform()), 4)}")
    lines.append(f"celestia_tpu_das_fairness_index {round(float(rng.uniform()), 4)}")
    lines.append("# a comment line the parse skips")
    return "\n".join(lines) + "\n"


class SeededClient:
    """One node's RPC surface from seeded data; ``dead`` raises on every
    call, ``no_probe`` lacks the clock probe (an older peer)."""

    def __init__(self, rng, nid, dump, dead=False, no_probe=False):
        self.address = f"127.0.0.1:{26000 + int(nid.split('-')[1])}"
        self.nid, self.dump, self.dead, self.no_probe = nid, dump, dead, no_probe
        self.offset = float(rng.uniform(-0.5, 0.5))
        self.rtt = float(rng.uniform(1e-4, 1e-2))
        self._status = {"chain_id": "cluster-parity-1", "height": int(rng.integers(5, 7)),
                        "app_hash": "ab" * 32, "data_root": "cd" * 32,
                        "gossip": {"peers": NODES - 1, "dropped_total": int(rng.integers(0, 9)),
                                   "pull_breakers": {"127.0.0.1:26001": "open"}
                                   if nid == "val-2" else {}}}
        self._metrics = seeded_exposition(rng, nid)

    def _alive(self):
        if self.dead:
            raise ConnectionError(f"{self.nid} unreachable")

    def trace_dump(self, last=None):
        self._alive()
        return {"enabled": True, "trace": self.dump}

    def clock_offset(self, samples=5):
        self._alive()
        if self.no_probe:
            raise RuntimeError("method ClockProbe not implemented")
        return {"offset_s": self.offset, "rtt_s": self.rtt}

    def status(self):
        self._alive()
        return self._status

    def metrics(self):
        self._alive()
        return self._metrics

    def peer_exchange(self, sender, peers):
        self._alive()
        return [f"127.0.0.1:{26000 + i}" for i in range(NODES)] + ["", 7]


@pytest.fixture
def node_id():
    """Both packages' collector id pinned to one value, then restored."""
    saved = (jax_tracing.node_id(), tracing.node_id())
    jax_tracing.set_node_id("collector", force=True)
    tracing.set_node_id("collector", force=True)
    yield
    jax_tracing.set_node_id(saved[0], force=True)
    tracing.set_node_id(saved[1], force=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rollups_equal_jax_on_seeded_clients(seed, node_id):
    rng = np.random.default_rng(seed)
    dumps = seeded_dumps(rng)
    clients = [SeededClient(rng, nid, dump, dead=(seed == 1 and nid == "val-3"),
                            no_probe=(nid == "val-1"))
               for nid, dump in dumps.items()]
    out = []
    for mod in (jax_cluster, cluster):
        doc = mod.cluster_trace(clients)
        out.append({
            "trace": doc,
            "waterfall": mod.mesh_waterfall(doc),
            "waterfall_h3": mod.mesh_waterfall(doc, height=3),
            "health": mod.cluster_health(clients),
            "peers": mod.discover_peers(clients[0], max_peers=3),
            "parsed": mod.parse_exposition(clients[0]._metrics),
        })
    assert canonical(out[1]) == canonical(out[0])
    assert tracing.validate_chrome_trace(out[1]["trace"]) == []
    assert out[1]["trace"]["otherData"]["cross_node_flows"] >= 1
    assert out[1]["health"]["reachable"] == (3 if seed == 1 else 4)
    rows = out[1]["waterfall"]["heights"]
    assert len(rows) == len(HEIGHTS) and all(r["validators"] for r in rows)
    assert any("propagation_ms" in v for r in rows for v in r["validators"])


@pytest.fixture
def fresh_faults():
    """Both packages' fault stats empty before and after the test: a test
    that poisons a device entry on purpose (the JAX package's device-plane
    tests) leaves its degradations in the process, and a server started
    after it reports them as its own."""
    from celestia_tpu.utils import faults as jax_faults
    from celestia_tpu_torch.utils import faults

    for mod in (jax_faults, faults):
        mod.reset_stats()
    yield
    for mod in (jax_faults, faults):
        mod.reset_stats()


def test_cluster_health_over_a_jax_and_a_port_server(fresh_faults):
    """One JAX and one port node on one genesis, each behind its own
    package's server: each package's rollup over both sees two reachable
    peers at one height and app hash, and the port's peer carries the JAX
    peer's fields."""
    gen = {"chain_id": "cluster-pair-1", "genesis_time_ns": GENESIS_NS}
    nodes = [jax_testnode.TestNode(genesis=dict(gen), auto_produce=False),
             port_testnode.TestNode(genesis=dict(gen), auto_produce=False, device="cpu")]
    servers = [jax_server.NodeServer(nodes[0], block_interval_s=None),
               port_server.NodeServer(nodes[1], block_interval_s=None)]
    for s in servers:
        s.start()
    try:
        for remote_cls, mod in ((jax_remote.RemoteNode, jax_cluster),
                                (port_remote.RemoteNode, cluster)):
            clients = [remote_cls(s.address, timeout_s=30.0) for s in servers]
            try:
                health = mod.cluster_health(clients)
            finally:
                for c in clients:
                    c.close()
            assert health["reachable"] == 2 and health["unreachable"] == 0
            assert health["height_spread"] == 0 and health["app_hash_agree"] is True
            jax_peer, port_peer = health["peers"]
            assert set(port_peer) == set(jax_peer)
            for key in ("chain_id", "height", "app_hash"):
                assert port_peer[key] == jax_peer[key]
            for peer in health["peers"]:
                assert peer["clock_offset_s"] is not None
                assert peer["rpc"]["server"]["status"]["calls"] >= 1
                assert peer["caches"] and peer["degradations"] == 0
    finally:
        for s in servers:
            s.stop()
