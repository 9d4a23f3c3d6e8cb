"""The port's process coordinator (``celestia_tpu_torch/node/coordinator.py``)
against the JAX package's.

Three validator nets over gRPC on 127.0.0.1, each of three ``TestNode``s
behind ``NodeServer``s: the JAX coordinator over JAX validators, the
port's coordinator over port validators (``device="cpu"``), and the JAX
coordinator over port validators (the packages' clients and servers
interoperate).  One seeded tx stream is gossiped to every validator of
each net; blocks (txs, data roots, app hashes, proposers, votes), rounds
and tx results must be equal height by height.  Then an unreachable
validator misses a commit and is caught up, and ``cli start --validator``
as three OS processes driven by the ``coordinator`` command.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from celestia_tpu.node import coordinator as jax_coordinator
from celestia_tpu.node import remote as jax_remote
from celestia_tpu.node import server as jax_server
from _torch_common import torch_one_thread  # noqa: F401 (fixture)
from test_torch_node import JAX, N_KEYS, PORT, canon, stream, submit
from celestia_tpu_torch.da import eds_cache
from celestia_tpu_torch.node import coordinator as port_coordinator
from celestia_tpu_torch.node import remote as port_remote
from celestia_tpu_torch.node import server as port_server

REPO = Path(__file__).resolve().parents[1]
CHAIN = "coord-parity-1"
N_VALS = 3
MAX_K = 8
PLAN = ("plain", "plain", "overfill", "empty", "plain")

SERVERS = {"jax": jax_server.NodeServer, "port": port_server.NodeServer}
CLIENTS = {"jax": (jax_remote.RemoteNode, jax_coordinator),
           "port": (port_remote.RemoteNode, port_coordinator)}
SIDES = {"jax": JAX, "port": PORT}


def genesis(side) -> dict:
    users = [side.Key.from_seed(b"node-parity-%d" % i) for i in range(N_KEYS)]
    vals = [side.Key.from_seed(b"coord-parity-val-%d" % i) for i in range(N_VALS)]
    return {
        "chain_id": CHAIN,
        "genesis_time_ns": 1_700_000_000 * 10**9,
        "accounts": [{"address": k.public_key().address().hex(), "balance": 10**12}
                     for k in users + vals],
        "validators": [{"address": k.public_key().address().hex(),
                        "self_delegation": 100_000_000} for k in vals],
        "params": {"blob": {"GovMaxSquareSize": MAX_K}},
    }


class Gossiped:
    """A Signer's node: account queries go to the first validator, a
    broadcast goes to every validator through ``coord.gossip_tx``."""

    def __init__(self, coord, remote):
        self.coord, self.remote = coord, remote

    def __getattr__(self, name):
        return getattr(self.remote, name)

    def broadcast_tx(self, raw: bytes):
        bad = self.coord.gossip_tx(raw)
        return bad or types.SimpleNamespace(code=0, log="", tx_hash=hashlib.sha256(raw).digest())


def coord_net(validators: str, coordinator: str):
    """N_VALS validators of package ``validators`` behind their servers,
    driven by package ``coordinator``'s RemoteNode and ProcessCoordinator."""
    side = SIDES[validators]
    remote_cls, coord_mod = CLIENTS[coordinator]
    gen = genesis(side)
    nodes, servers, remotes = [], [], []
    for i in range(N_VALS):
        node = side.TestNode(chain_id=CHAIN, genesis=gen,
                             validator_key=side.Key.from_seed(b"coord-parity-val-%d" % i),
                             auto_produce=False, **side.node_kw)
        server = SERVERS[validators](node, block_interval_s=None)
        server.start()
        nodes.append(node)
        servers.append(server)
        remotes.append(remote_cls(server.address, timeout_s=60.0))
    coord = coord_mod.ProcessCoordinator(
        [coord_mod.PeerValidator(f"val-{i}", r) for i, r in enumerate(remotes)],
        block_interval_ns=10**9)
    return types.SimpleNamespace(side=SIDES[coordinator], nodes=nodes, servers=servers,
                                 remotes=remotes, coord=coord)


def close(net):
    for r in net.remotes:
        r.close()
    for s in net.servers:
        s.stop()


@pytest.fixture
def clean_caches():
    eds_cache.clear()
    yield
    eds_cache.clear()


def test_coordinator_nets_give_equal_blocks(clean_caches):
    """JAX over JAX, port over port, JAX over port: one seeded stream, the
    same blocks, rounds and tx results height by height."""
    nets = {name: coord_net(*name) for name in (("jax", "jax"), ("port", "port"),
                                               ("port", "jax"))}
    try:
        signers = {}
        for name, net in nets.items():
            node = Gossiped(net.coord, net.remotes[0])
            signers[name] = [net.side.Signer(node, net.side.Key.from_seed(
                b"node-parity-%d" % i)) for i in range(N_KEYS)]
        rng = np.random.default_rng(21)
        hashes = []
        for kind in PLAN:
            for item in stream(rng, kind, MAX_K):
                got = [submit(net.side, signers[name][item["key"]], item)
                       for name, net in nets.items()]
                assert [g.code for g in got] == [0] * len(nets), [g.log for g in got]
                assert len({g.tx_hash for g in got}) == 1
                hashes.append(got[0].tx_hash)
            for net in nets.values():
                net.coord.produce_block()
        while any(len(n.mempool) for net in nets.values() for n in net.nodes):
            for net in nets.values():
                net.coord.produce_block()
        blocks = [net.coord.blocks for net in nets.values()]
        assert len(blocks[0]) >= len(PLAN)
        assert {b["square_size"] for b in blocks[0]} >= {2, 4, MAX_K}
        assert blocks[1] == blocks[0] and blocks[2] == blocks[0]
        rounds = [canon(net.coord.rounds) for net in nets.values()]
        assert rounds[1] == rounds[0] and rounds[2] == rounds[0]
        for net in nets.values():
            assert len({n.app.store.app_hash() for n in net.nodes}) == 1
            assert [b.header.data_hash for b in net.nodes[0].blocks] == [
                b.header.data_hash for b in next(iter(nets.values())).nodes[0].blocks]
        for h in hashes:
            results = [r.get_tx(h) for net in nets.values() for r in net.remotes]
            assert results[0] is not None and results[0]["code"] == 0
            assert all(r == results[0] for r in results)
    finally:
        for net in nets.values():
            close(net)


def test_unreachable_validator_misses_commit(clean_caches):
    net = coord_net("port", "port")
    coord, nodes = net.coord, net.nodes
    try:
        coord.produce_block()
        victim = coord.peers[2]
        live_client = victim.client

        class Dead:
            def __getattr__(self, name):
                def boom(*a, **k):
                    raise ConnectionError("validator offline")

                return boom

        victim.client = Dead()
        try:
            before = coord.height
            coord.produce_block()
            assert coord.height == before + 1
            assert coord.blocks[-1]["missed"] == ["val-2"]
            assert nodes[2].height == before
        finally:
            victim.client = live_client
        coord.produce_block()
        assert coord.blocks[-1]["missed"] == []
        assert nodes[2].height == coord.height
        assert all(v.accept for v in coord.rounds[-1].votes)
        assert len({n.app.store.app_hash() for n in nodes}) == 1
    finally:
        close(net)


def port_cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "celestia_tpu_torch.cli", *args], capture_output=True,
        text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "CELESTIA_TPU_TORCH_DEVICE": "cpu"},
    )


def test_three_process_validator_net(tmp_path):
    """Three ``cli start --validator`` processes on the CPU and the
    ``coordinator`` command: four heights, proposers rotating, one app hash
    and data root in every process."""
    keys = [PORT.Key.from_seed(b"port-procnet-val-%d" % i) for i in range(3)]
    gen = {
        "chain_id": "port-procnet-3", "genesis_time_ns": 1_700_000_000_000_000_000,
        "accounts": [{"address": k.public_key().address().hex(), "balance": 10**12}
                     for k in keys],
        "validators": [{"address": k.public_key().address().hex(),
                        "self_delegation": 100_000_000} for k in keys],
    }
    shared = tmp_path / "genesis.json"
    shared.write_text(json.dumps(gen))
    procs, addrs = [], []
    try:
        for i in range(3):
            home = tmp_path / f"val{i}"
            out = port_cli("--home", str(home), "init", "--chain-id", "port-procnet-3",
                           "--genesis", str(shared))
            assert out.returncode == 0, out.stderr
            (home / "config" / "priv_validator_key.json").write_text(
                json.dumps({"priv_key": f"{keys[i].d:064x}"}))
        for i in range(3):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "celestia_tpu_torch.cli", "--home",
                 str(tmp_path / f"val{i}"), "start", "--validator", "--grpc-address",
                 "127.0.0.1:0", "--warm-squares", "1", "--timeseries-interval", "0"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO,
                env={**os.environ, "CELESTIA_TPU_TORCH_DEVICE": "cpu"}))
        for proc in procs:
            addrs.append(json.loads(proc.stdout.readline())["grpc"])
        out = port_cli("coordinator", "--peers", ",".join(addrs), "--blocks", "4",
                       "--block-interval", "0.1")
        assert out.returncode == 0, out.stdout + out.stderr
        lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
        assert [b["height"] for b in lines] == [2, 3, 4, 5]
        assert len({b["proposer"] for b in lines}) == 3
        remotes = [port_remote.RemoteNode(a, timeout_s=30.0) for a in addrs]
        statuses = [r.status() for r in remotes]
        for r in remotes:
            r.close()
        assert {s["height"] for s in statuses} == {5}
        assert len({s["app_hash"] for s in statuses}) == 1
        assert len({s["data_root"] for s in statuses}) == 1
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        assert [proc.wait(timeout=30) for proc in procs] == [0, 0, 0]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
