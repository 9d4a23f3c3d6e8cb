"""The port's gossip mesh (``celestia_tpu_torch/node/gossip.py``) against
the JAX package's.

A mixed mesh first: four BFT validators, two JAX ``TestNode``s and two
port ones (``device="cpu"``), each behind its own package's ``NodeServer``
and ``GossipEngine`` on 127.0.0.1, so no 2/3 quorum forms without both
packages.  Seeded sends and PayForBlobs go to single validators, one of
them to a port validator only; every validator must end on one app hash and
the same data roots, height by height.  Then the twins of
``tests/test_gossip_mesh.py``'s in-process tests on the port alone: PEX
from one seed, a tx carried by want/have gossip, a relay killed mid-run, a
dead validator caught up, the batched catch-up stopping on a bad
certificate or a malformed wire, unsigned junk, a state-sync rejoin.
Last, the port's departures: the default ``catchup_batch`` equals JAX's
(read from the App device's content cache), a failed adoption ends the
node (``NodeServer.fail``: ``/healthz`` reports it failed) and opens no
peer's breaker, while a peer's failed RPC or malformed wire opens only that
peer's breaker; and ``cli start --bft-valset --peers`` as three OS
processes.
"""

import copy
import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

from celestia_tpu.client import signer as jax_signer
from celestia_tpu.da import blob as jax_blob
from celestia_tpu.da import namespace as jax_namespace
from celestia_tpu.node import gossip as jax_gossip
from celestia_tpu.node import remote as jax_remote
from celestia_tpu.node import server as jax_server
from celestia_tpu.node import testnode as jax_testnode
from celestia_tpu.state import tx as jax_tx
from celestia_tpu.utils import secp256k1 as jax_secp
from _torch_common import ReservedAddrs, node_env, torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch.client import signer as port_signer
from celestia_tpu_torch.da import blob as port_blob
from celestia_tpu_torch.da import eds_cache
from celestia_tpu_torch.da import namespace as port_namespace
from celestia_tpu_torch.node import bft as port_bft
from celestia_tpu_torch.node import gossip as port_gossip
from celestia_tpu_torch.node import remote as port_remote
from celestia_tpu_torch.node import server as port_server
from celestia_tpu_torch.node import testnode as port_testnode
from celestia_tpu_torch.node.coordinator import BFTRelay, PeerValidator
from celestia_tpu_torch.state import tx as port_tx
from celestia_tpu_torch.utils import secp256k1 as port_secp

REPO = Path(__file__).resolve().parents[1]
GENESIS_NS = 1_700_000_000_000_000_000

JAX = types.SimpleNamespace(
    TestNode=jax_testnode.TestNode, NodeServer=jax_server.NodeServer,
    GossipEngine=jax_gossip.GossipEngine, RemoteNode=jax_remote.RemoteNode,
    Signer=jax_signer.Signer, SubmitResult=jax_signer.SubmitResult,
    Key=jax_secp.PrivateKey, MsgSend=jax_tx.MsgSend,
    Blob=jax_blob.Blob, Namespace=jax_namespace.Namespace, node_kw={},
)
PORT = types.SimpleNamespace(
    TestNode=port_testnode.TestNode, NodeServer=port_server.NodeServer,
    GossipEngine=port_gossip.GossipEngine, RemoteNode=port_remote.RemoteNode,
    Signer=port_signer.Signer, SubmitResult=port_signer.SubmitResult,
    Key=port_secp.PrivateKey, MsgSend=port_tx.MsgSend,
    Blob=port_blob.Blob, Namespace=port_namespace.Namespace, node_kw={"device": "cpu"},
)


def valset(keys, power=100):
    return [{"address": k.public_key().address().hex(),
             "pubkey": k.public_key().compressed().hex(), "power": power} for k in keys]


def genesis(keys, chain_id, funded=(), max_k=None):
    out = {
        "chain_id": chain_id,
        "genesis_time_ns": GENESIS_NS,
        "accounts": [{"address": k.public_key().address().hex(), "balance": 10**12}
                     for k in keys]
        + [{"address": k.public_key().address().hex(), "balance": b} for k, b in funded],
        "validators": [{"address": k.public_key().address().hex(),
                        "self_delegation": 100_000_000} for k in keys],
    }
    if max_k is not None:
        out["params"] = {"blob": {"GovMaxSquareSize": max_k}}
    return out


def val_keys(chain_id, n):
    return [PORT.Key.from_seed(b"%s-val-%d" % (chain_id.encode(), i)) for i in range(n)]


def bft_node(side, key, gen, vals, **kw):
    node = side.TestNode(chain_id=gen["chain_id"], genesis=gen, validator_key=side.Key(key.d),
                         auto_produce=False, **side.node_kw, **kw)
    node.enable_bft(vals)
    return node


def mesh(chain_id, sides, funded=(), max_k=None, node_kw=None, **engine_kw):
    """One BFT validator per entry of ``sides`` (its package), each behind
    its package's NodeServer, with a GossipEngine to every other server
    (built after the servers bind: the engine stamps the bound address)."""
    keys = val_keys(chain_id, len(sides))
    gen = genesis(keys, chain_id, funded, max_k)
    vals = valset(keys)
    nodes, servers = [], []
    for side, key in zip(sides, keys):
        node = bft_node(side, key, gen, vals, **(node_kw or {}))
        server = side.NodeServer(node, block_interval_s=None)
        server.start()
        nodes.append(node)
        servers.append(server)
    engine_kw.setdefault("block_gap_s", 0.05)
    engines = [
        side.GossipEngine(node, [s.address for j, s in enumerate(servers) if j != i],
                          **engine_kw)
        for i, (side, node) in enumerate(zip(sides, nodes))
    ]
    return types.SimpleNamespace(keys=keys, genesis=gen, valset=vals, nodes=nodes,
                                 servers=servers, engines=engines)


def wait_height(nodes, h, timeout_s=60.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(n.height >= h for n in nodes):
            return
        time.sleep(0.02)
    raise TimeoutError(f"mesh stuck below height {h}: {[n.height for n in nodes]}")


def teardown(servers, engines, remotes=()):
    for e in engines:
        e.stop()
    for s in servers:
        s.stop()
    for r in remotes:
        r.close()


def agree(nodes, h):
    """One app hash at height ``h`` on every node."""
    return len({n.app.store.committed_hash(h) for n in nodes}) == 1


def data_roots(node) -> dict:
    return {b.header.height: b.header.data_hash for b in node.blocks}


@pytest.fixture(autouse=True)
def content_caches():
    eds_cache.clear()
    yield
    eds_cache.clear()


# --- the mixed mesh ---------------------------------------------------------


def test_mixed_mesh_commits_one_chain_across_packages():
    """2 JAX + 2 port validators (no quorum without both packages):
    seeded sends and PayForBlobs, each submitted to one validator (one
    PayForBlobs to a port validator only), commit on every validator with
    one app hash and equal data roots height by height."""
    rng = np.random.default_rng(13)
    users = [PORT.Key.from_seed(b"mixed-mesh-user-%d" % i) for i in range(4)]
    net = mesh("mixed-mesh-1", [JAX, JAX, PORT, PORT],
               funded=[(u, 10**12) for u in users], max_k=4)
    sides = [JAX, JAX, PORT, PORT]
    remotes = [side.RemoteNode(s.address, timeout_s=30.0)
               for side, s in zip(sides, net.servers)]
    try:
        for e in net.engines:
            e.start()
        wait_height(net.nodes, 2)
        hashes = []
        # (user, validator, what): the PayForBlobs of user 2 goes to port
        # validator 3 only; every tx reaches the proposers by gossip alone.
        # Broadcast only (no confirmation poll): the mesh cuts the blocks.
        for user, val, what in ((0, 0, "send"), (1, 1, "pfb"), (2, 3, "pfb"), (3, 2, "send")):
            side = sides[val]
            signer = side.Signer(remotes[val], side.Key(users[user].d))
            signer.confirm_tx = lambda tx_hash, side=side, **kw: side.SubmitResult(0, "", tx_hash)
            if what == "send":
                res = signer.submit_tx([side.MsgSend(signer.address, rng.bytes(20),
                                                     int(rng.integers(1, 10**6)))])
            else:
                blobs = [side.Blob(side.Namespace.v0(b"\x01" + rng.bytes(9)),
                                   rng.bytes(int(rng.integers(400, 1200))))
                         for _ in range(int(rng.integers(1, 3)))]
                res = signer.submit_pay_for_blob(blobs)
            assert res.code == 0, res.log
            hashes.append(res.tx_hash)
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                r.get_tx(h) is not None for r in remotes for h in hashes):
            time.sleep(0.05)
        for r in remotes:
            for h in hashes:
                info = r.get_tx(h)
                assert info is not None and info["code"] == 0, info
        wait_height(net.nodes, max(n.height for n in net.nodes))
        h = min(n.height for n in net.nodes)
        assert h >= 3
        for height in range(2, h + 1):
            assert agree(net.nodes, height), f"app hashes differ at height {height}"
        roots = [data_roots(n) for n in net.nodes]
        for height in range(2, h + 1):
            assert len({r[height] for r in roots}) == 1, f"data roots differ at {height}"
    finally:
        teardown(net.servers, net.engines, remotes)


# --- twins of the JAX package's in-process mesh tests -------------------------


def test_pex_bootstrap_from_one_seed_with_bounded_fanout():
    """Four port validators that know only the seed's address, fanout 2,
    find each other by PEX and commit; killing the seed does not stop the
    mesh."""
    n = 4
    keys = val_keys("port-pex-1", n)
    gen = genesis(keys, "port-pex-1")
    vals = valset(keys)
    nodes = [bft_node(PORT, k, gen, vals) for k in keys]
    servers = [PORT.NodeServer(node, block_interval_s=None) for node in nodes]
    for s in servers:
        s.start()
    engines = [PORT.GossipEngine(node, [] if i == 0 else [servers[0].address],
                                 block_gap_s=0.05, fanout=2, pex_interval_s=0.1)
               for i, node in enumerate(nodes)]
    seed_stopped = False
    try:
        for e in engines:
            e.start()
        wait_height(nodes, 3)
        for e in engines[1:]:
            assert len(e._peers_snapshot()) >= n - 2, e._peers_snapshot()
        r = PORT.RemoteNode(servers[1].address, timeout_s=30)
        try:
            st = r.status()["gossip"]
            assert st["peers"] >= n - 2 and st["fanout"] == 2 and st["pex_learned"] >= n - 3
        finally:
            r.close()
        engines[0].stop()
        servers[0].stop()
        seed_stopped = True
        wait_height(nodes[1:], max(node.height for node in nodes[1:]) + 2)
    finally:
        k = 1 if seed_stopped else 0
        teardown(servers[k:], engines[k:])


def test_tx_submitted_to_one_validator_lands_via_gossip():
    alice = PORT.Key.from_seed(b"port-mesh-tx-alice")
    net = mesh("port-mesh-tx", [PORT] * 3, funded=[(alice, 10**12)])
    remotes = [PORT.RemoteNode(s.address, timeout_s=30.0) for s in net.servers]
    try:
        for e in net.engines:
            e.start()
        wait_height(net.nodes, 2)
        signer = PORT.Signer(remotes[0], alice)
        bob = b"\x61" * 20
        raw = signer.sign_tx([PORT.MsgSend(signer.address, bob, 5_500)]).marshal()
        assert remotes[0].broadcast_tx(raw).code == 0  # ONE validator only
        deadline = time.time() + 60
        while time.time() < deadline and not all(
                n.app.bank.balance(bob) == 5_500 for n in net.nodes):
            time.sleep(0.05)
        assert all(n.app.bank.balance(bob) == 5_500 for n in net.nodes)
    finally:
        teardown(net.servers, net.engines, remotes)


def test_relay_killed_mid_run_network_keeps_committing():
    net = mesh("port-mesh-relaykill", [PORT] * 3)
    remotes = [PORT.RemoteNode(s.address, timeout_s=30.0) for s in net.servers]
    try:
        relay = BFTRelay([PeerValidator(name=f"val-{i}", client=r)
                          for i, r in enumerate(remotes)])
        relay.produce_block()
        assert all(n.height == 2 for n in net.nodes)
        del relay
        for e in net.engines:
            e.start()
        wait_height(net.nodes, 4)
        assert agree(net.nodes, min(n.height for n in net.nodes))
    finally:
        teardown(net.servers, net.engines, remotes)


def test_mesh_survives_one_dead_validator_and_catches_it_up():
    net = mesh("port-mesh-crash", [PORT] * 3)
    servers, engines, nodes = net.servers, net.engines, net.nodes
    try:
        for e in engines:
            e.start()
        wait_height(nodes, 3)
        engines[2].stop()
        servers[2].stop()
        wait_height(nodes[:2], nodes[2].height + 2)
        revived = PORT.NodeServer(nodes[2], block_interval_s=None)
        revived.start()
        servers.append(revived)
        e2 = PORT.GossipEngine(nodes[2], [servers[0].address, servers[1].address],
                               block_gap_s=0.05)
        for i in (0, 1):
            engines[i].peer_addrs = [servers[1 - i].address, revived.address]
        engines.append(e2)
        e2.start()
        wait_height(nodes, max(n.height for n in nodes[:2]) + 2)
        assert agree(nodes, min(n.height for n in nodes))
    finally:
        teardown(servers, engines)


@pytest.fixture(scope="module")
def decided():
    """A 3-validator port mesh run to height 5, stopped: its keys, genesis,
    valset and the decided wires of heights 2.. (served by its node 0)."""
    net = mesh("port-mesh-decided", [PORT] * 3)
    try:
        for e in net.engines:
            e.start()
        wait_height(net.nodes, 5)
    finally:
        teardown(net.servers, net.engines)
    src = net.nodes[0]
    wires = [src.bft_decided(h) for h in range(2, src.height + 1)]
    assert None not in wires and len(wires) >= 4
    return types.SimpleNamespace(net=net, src=src, wires=wires)


def laggard(decided):
    net = decided.net
    return bft_node(PORT, net.keys[0], net.genesis, net.valset)


def test_bft_catchup_batch_adopts_window_and_stops_on_bad_wire(decided):
    """A laggard adopts a window of decided blocks in one call; a
    certificate below 2/3 stops it at that block; a malformed wire raises
    ``MalformedWire`` after the intact prefix is adopted."""
    wires, src = decided.wires, decided.src
    node = laggard(decided)
    adopted, why = node.bft_catchup_batch(wires)
    assert adopted == len(wires), why
    assert node.app.store.committed_hash(node.height) == src.app.store.committed_hash(
        node.height)
    bad = copy.deepcopy(wires)
    bad[1]["precommits"] = bad[1]["precommits"][:1]  # below 2/3
    node = laggard(decided)
    adopted, why = node.bft_catchup_batch(bad)
    assert adopted == 1 and why and node.height == 2
    junk = copy.deepcopy(wires)
    del junk[2]["payload"]["txs"]
    node = laggard(decided)
    with pytest.raises(port_bft.MalformedWire):
        node.bft_catchup_batch(junk)
    assert node.height == 3


def test_unsigned_junk_gossip_rejected_and_harmless():
    net = mesh("port-mesh-junk", [PORT] * 3)
    remotes = [PORT.RemoteNode(s.address, timeout_s=30.0) for s in net.servers]
    try:
        for e in net.engines:
            e.start()
        wait_height(net.nodes, 3)
        assert remotes[0].gossip_msg(
            {"wire": {"kind": "vote", "garbage": True}, "sender": "evil"}) is False
        junk_vote = {"kind": "vote", "vtype": "precommit", "height": 10**12, "round": 0,
                     "block_id": "00" * 32,
                     "validator": net.keys[0].public_key().address().hex(),
                     "signature": "00" * 64}
        assert remotes[0].gossip_msg({"wire": junk_vote, "sender": "evil"}) is False
        wait_height(net.nodes, min(n.height for n in net.nodes) + 2)
    finally:
        teardown(net.servers, net.engines, remotes)


def test_state_sync_rejoin_past_decided_window(tmp_path):
    """A validator offline past the decided-log window rejoins from a
    served snapshot whose anchor certificate it verifies first, and its
    App keeps its device."""
    keys = val_keys("port-mesh-sync", 4)
    gen = genesis(keys, "port-mesh-sync")
    vals = valset(keys)
    nodes = [bft_node(PORT, k, gen, vals, snapshot_dir=str(tmp_path / f"snap-{i}"),
                      snapshot_interval=4) for i, k in enumerate(keys)]
    for node in nodes:
        node.bft_decided_log_max = 3
    servers = [PORT.NodeServer(node, block_interval_s=None) for node in nodes]
    for s in servers:
        s.start()
    fast = {"block_gap_s": 0.02}
    engines = [PORT.GossipEngine(node, [s.address for j, s in enumerate(servers) if j != i],
                                 **fast)
               for i, node in enumerate(nodes)]
    eng3 = srv3 = None
    try:
        for e in engines:
            e.start()
        wait_height(nodes, 2)
        engines[3].stop()
        servers[3].stop()
        offline_at = nodes[3].height
        wait_height(nodes[:3], offline_at + 11, timeout_s=120.0)
        assert min(nodes[0]._bft_decided_log) > offline_at + 1
        assert nodes[0].snapshots.latest() is not None
        app_before = nodes[3].app
        srv3 = PORT.NodeServer(nodes[3], block_interval_s=None)
        srv3.start()
        eng3 = PORT.GossipEngine(nodes[3], [servers[i].address for i in range(3)], **fast)
        eng3.start()
        wait_height(nodes, max(node.height for node in nodes[:3]) + 1, timeout_s=120.0)
        assert nodes[3].app is not app_before  # state-synced, not replayed
        assert str(nodes[3].app.device) == "cpu"
        assert agree(nodes, min(n.height for n in nodes))
    finally:
        teardown(servers + ([srv3] if srv3 else []), engines + ([eng3] if eng3 else []))


# --- the port's departures ------------------------------------------------------


def test_a_vote_for_the_next_height_is_held_until_it_starts():
    """A prevote for a height the BFT engine has not started is held, not
    dropped (the flood's dedup would stop it coming again), and is handled
    when the height starts; the reference's engine loses it."""
    keys = val_keys("port-mesh-early", 4)
    gen = genesis(keys, "port-mesh-early")
    vals = valset(keys)
    ahead, behind = bft_node(PORT, keys[0], gen, vals), bft_node(PORT, keys[1], gen, vals)
    ahead.bft_start(2)
    ahead.bft_timeout("propose", 2, 0)  # prevote nil at (2, 0)
    wire = next(w for w in ahead.bft_drain()["outbox"] if w.get("vtype") == "prevote")
    eng = PORT.GossipEngine(behind, [])
    assert behind.height == 1 and behind._bft.height < 2
    assert eng.on_gossip(wire, "peer") is True
    assert not behind._bft._votes
    behind.bft_start(2)
    got = behind._bft._votes[(2, 0, port_bft.PREVOTE)]
    assert list(got) == [keys[0].public_key().address()]
    assert eng.on_gossip(wire, "peer") is False  # delivered once



def staggered_mesh(chain_id):
    """Four port validators on pre-picked addresses; validators 2 and 3
    start serving and pumping first, 0 and 1 a second later, so the first
    round's floods of 2 and 3 to 0 and 1 are dropped on links that are
    down."""
    addrs = free_addrs(4)
    keys = val_keys(chain_id, 4)
    gen = genesis(keys, chain_id)
    vals = valset(keys)
    nodes = [bft_node(PORT, k, gen, vals) for k in keys]
    servers = [PORT.NodeServer(n, address=a, block_interval_s=None)
               for n, a in zip(nodes, addrs)]
    engines = [PORT.GossipEngine(n, [a for j, a in enumerate(addrs) if j != i],
                                 block_gap_s=0.05)
               for i, n in enumerate(nodes)]
    # the sender stamp: the address each server binds in start()
    for n, a in zip(nodes, addrs):
        n._server_address = a
    for i in (2, 3, 0, 1):
        if i == 0:
            time.sleep(1.0)
        servers[i].start()
        engines[i].start()
    return nodes, servers, engines


def test_a_stalled_height_is_reflooded(monkeypatch):
    """Floods dropped while two validators were still down leave the
    first height without a 2/3 of prevotes anywhere unless a validator
    sends its messages again; the port's engine re-floods them while the
    height stalls (the reference's does not) and the mesh commits."""
    monkeypatch.setattr(port_gossip, "REFLOOD_S", 1e9)
    nodes, servers, engines = staggered_mesh("port-mesh-no-reflood")
    try:
        time.sleep(3.0)
        assert [n.height for n in nodes] == [1, 1, 1, 1]
    finally:
        teardown(servers, engines)
    monkeypatch.setattr(port_gossip, "REFLOOD_S", 1.0)
    nodes, servers, engines = staggered_mesh("port-mesh-reflood")
    try:
        wait_height(nodes, 3, timeout_s=30.0)
        assert agree(nodes, 3)
    finally:
        teardown(servers, engines)



def test_default_catchup_batch_equals_jax():
    """JAX sizes the window from its one EDS cache, the port from the
    content cache of the node's App device: 7 with the default 8 entries."""
    jax_node = jax_testnode.TestNode(auto_produce=False, genesis_time_ns=GENESIS_NS)
    port_node = port_testnode.TestNode(auto_produce=False, genesis_time_ns=GENESIS_NS,
                                       device="cpu")
    got = [jax_gossip.GossipEngine(jax_node, []).catchup_batch,
           port_gossip.GossipEngine(port_node, []).catchup_batch]
    assert got[0] == got[1] == 7
    assert eds_cache.content_cache("cpu").max_entries - 1 == 7


class FakePeer:
    """A pull client serving ``wires`` (heights 2..) from memory; ``dead``
    fails every RPC as an unreachable peer does."""

    def __init__(self, wires, dead=False):
        self.wires, self.dead, self.address = wires, dead, "fake"

    def status(self):
        if self.dead:
            raise ConnectionError("peer offline")
        return {"height": 1 + len(self.wires)}

    def bft_decided(self, h):
        if self.dead:
            raise ConnectionError("peer offline")
        return self.wires[h - 2] if 2 <= h < 2 + len(self.wires) else None

    def close(self):
        pass


def catch_up_engine(node, peers: dict, **kw):
    eng = PORT.GossipEngine(node, list(peers), **kw)
    eng._pull_client = lambda addr: peers[addr]
    eng._behind_hint = 10**6
    return eng


def breakers(eng) -> dict:
    return eng._breakers.stats()


def test_a_failed_adoption_ends_the_node_and_blames_no_peer(decided, monkeypatch):
    """The batched catch-up's warm leg raises on the node: the engine stops,
    ``NodeServer.fail`` reports the node failed on ``/healthz``, and the
    serving peer's breaker stays closed.  The JAX package notes the
    failure as the peer's and goes on."""
    node = laggard(decided)
    server = PORT.NodeServer(node, block_interval_s=None)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(node.app, "validate_blocks_batched", broken)
    eng = catch_up_engine(node, {"10.0.0.1:1": FakePeer(decided.wires)},
                          on_failure=server.fail)
    eng._catch_up()
    assert server.failed.is_set() and isinstance(server.failure, RuntimeError)
    assert eng.failure is server.failure and eng._stop.is_set()
    health = server.service.healthz()
    assert health["status"] == "failed"
    assert "illegal memory access" in health["catchup_failure"]
    assert node.height == 1
    assert set(breakers(eng).values()) <= {"closed"}


def test_a_peer_fault_opens_only_that_peers_breaker(decided):
    """A dead peer and a peer serving a malformed wire each open their own
    breaker; the node adopts what the good peer serves and does not fail."""
    wires = decided.wires
    junk = copy.deepcopy(wires)
    junk[1]["payload"] = "not a payload"
    node = laggard(decided)
    server = PORT.NodeServer(node, block_interval_s=None)
    peers = {"10.0.0.1:1": FakePeer(wires, dead=True), "10.0.0.2:1": FakePeer(junk),
             "10.0.0.3:1": FakePeer(wires)}
    eng = catch_up_engine(node, peers, on_failure=server.fail)
    eng._catch_up()
    assert not server.failed.is_set() and eng.failure is None
    assert server.service.healthz()["status"] != "failed"
    assert node.height == 1 + len(wires)
    st = breakers(eng)
    assert st["10.0.0.1:1"] != "closed" and st["10.0.0.2:1"] != "closed"
    assert st.get("10.0.0.3:1", "closed") == "closed"


def test_stop_while_a_link_evicts_its_peer(decided):
    """A link's worker evicts its PEX-learned peer (``_peer_failed``) while
    ``stop`` is stopping the other links: every link is stopped and none
    is left behind (stop walked the live dict of links and raised
    "dictionary changed size during iteration" under a parallel run)."""
    eng = PORT.GossipEngine(laggard(decided), ["10.0.0.1:1"])
    eng._merge_peers(["10.0.0.2:1", "10.0.0.3:1"])
    eng._evict_after = 1
    links = [eng._link(a) for a in ("10.0.0.1:1", "10.0.0.2:1", "10.0.0.3:1")]
    first_stop = links[0].stop

    def stop_while_a_peer_fails():
        eng._peer_failed("10.0.0.3:1")
        first_stop()

    links[0].stop = stop_while_a_peer_fails
    eng.stop()
    assert eng._links == {} and "10.0.0.3:1" not in eng.peer_addrs
    assert not any(link._thread.is_alive() for link in links)


def test_a_failed_proposal_ends_the_node(monkeypatch):
    """The proposer's PrepareProposal raises when its height starts: the
    engine stops, ``NodeServer.fail`` reports the node failed on
    ``/healthz`` with the cause, and no proposal goes out.  The JAX
    package's validator forfeits the round and goes on."""
    keys = val_keys("port-mesh-propose-fail", 1)
    gen = genesis(keys, "port-mesh-propose-fail")
    node = bft_node(PORT, keys[0], gen, valset(keys))
    server = PORT.NodeServer(node, block_interval_s=None)

    def broken(*a, **kw):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(node.app, "prepare_proposal", broken)
    eng = PORT.GossipEngine(node, [], on_failure=server.fail)
    eng._pump_once()
    assert server.failed.is_set() and isinstance(server.failure, port_bft.ProposeFailed)
    assert isinstance(server.failure.__cause__, RuntimeError)
    assert eng.failure is server.failure and eng._stop.is_set()
    health = server.service.healthz()
    assert health["status"] == "failed"
    assert "unspecified launch failure" in health["propose_failure"]
    assert node.height == 1 and not node.bft_drain()["outbox"]


# --- OS processes ---------------------------------------------------------------


def free_addrs(n):
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    addrs = ["127.0.0.1:%d" % s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return addrs


def port_cli(home, *args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "celestia_tpu_torch.cli", "--home", str(home), *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "CELESTIA_TPU_TORCH_DEVICE": "cpu"},
    )


def test_mesh_of_three_port_processes(tmp_path):
    """``cli start --bft-valset --peers`` as three OS processes on the CPU,
    each told one seed's address (the first process, which is told the
    second's): PEX, a self-paced chain with no
    relay, a tx submitted to one process in every process's state, and
    SIGTERM exits 0."""
    keys = val_keys("port-meshproc-3", 3)
    alice = PORT.Key.from_seed(b"port-meshproc-alice")
    shared = tmp_path / "genesis.json"
    shared.write_text(json.dumps(genesis(keys, "port-meshproc-3", [(alice, 10**12)])))
    valset_file = tmp_path / "valset.json"
    valset_file.write_text(json.dumps(valset(keys)))
    # held until each process has bound its own (a freed port can be taken
    # by another test's server in a parallel run: ReservedAddrs)
    reserved = ReservedAddrs(3)
    addrs = reserved.addrs
    procs, remotes = [], []
    try:
        for i in range(3):
            home = tmp_path / f"val{i}"
            out = port_cli(home, "init", "--chain-id", "port-meshproc-3",
                           "--genesis", str(shared))
            assert out.returncode == 0, out.stderr
            (home / "config" / "priv_validator_key.json").write_text(
                json.dumps({"priv_key": f"{keys[i].d:064x}"}))
        for i in range(3):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "celestia_tpu_torch.cli", "--home",
                 str(tmp_path / f"val{i}"), "start", "--bft-valset", str(valset_file),
                 "--grpc-address", addrs[i], "--block-interval", "0.1",
                 "--warm-squares", "1,2", "--timeseries-interval", "0"]
                + ["--peers", addrs[1] if i == 0 else addrs[0]],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
                # three validators on one host: a third of the cores each
                env=node_env(3)))
        for i, proc in enumerate(procs):
            assert json.loads(proc.stdout.readline())["grpc"] == addrs[i]
        reserved.release()
        remotes = [PORT.RemoteNode(a, timeout_s=30.0) for a in addrs]
        deadline = time.time() + 60
        while time.time() < deadline and not all(r.height >= 3 for r in remotes):
            time.sleep(0.1)
        assert all(r.height >= 3 for r in remotes), [r.height for r in remotes]
        signer = PORT.Signer(remotes[2], alice)
        bob = b"\x71" * 20
        raw = signer.sign_tx([PORT.MsgSend(signer.address, bob, 3_300)]).marshal()
        assert remotes[2].broadcast_tx(raw).code == 0
        deadline = time.time() + 60
        balances = []
        while time.time() < deadline:
            balances = [int(r.abci_query("store/bank/balance", {"address": bob.hex()}))
                        for r in remotes]
            if balances == [3_300] * 3:
                break
            time.sleep(0.1)
        assert balances == [3_300] * 3
        assert all(r.status()["gossip"]["peers"] >= 2 for r in remotes)
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        assert [proc.wait(timeout=30) for proc in procs] == [0, 0, 0]
    finally:
        reserved.release()
        for r in remotes:
            r.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()


def test_reserved_addrs_keep_their_ports_until_the_nodes_bind():
    """The ports of the process meshes stay held until the nodes bind them:
    while held, no bind(0) gets one (a freed port could, and a gRPC server
    would then share it with the node through SO_REUSEPORT), and a node's
    gRPC server still binds it."""
    import grpc
    from concurrent import futures

    reserved = ReservedAddrs(2)
    try:
        ports = {int(a.rsplit(":", 1)[1]) for a in reserved.addrs}
        taken = set()
        for _ in range(2000):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                taken.add(s.getsockname()[1])
        assert not ports & taken
        server = grpc.server(futures.ThreadPoolExecutor(max_workers=1))
        try:
            assert server.add_insecure_port(reserved.addrs[0]) in ports
        finally:
            server.stop(None)
    finally:
        reserved.release()
