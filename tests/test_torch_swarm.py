"""The port's DAS swarm (``celestia_tpu_torch/client/swarm.py``) and remote
txsim (``client/txsim.py`` ``run_remote``) against the JAX package's.

``SwarmClient.pick_batch`` gives JAX's (height, coordinates) sequence for
the same seed, generation and population.  ``run_swarm`` of both packages
drives a port ``NodeServer`` on 127.0.0.1 serving seeded blocks: the
reports have the same keys, every round runs, and every cell the port's
swarm was served verifies against its block's data root.  ``run_remote``
of both packages against a port server and a JAX server (each node cuts a
block at a confirmation poll) gives equal tx hashes and results.
"""

import numpy as np
import pytest

from celestia_tpu.client import signer as jax_signer
from celestia_tpu.client import swarm as jax_swarm
from celestia_tpu.client import txsim as jax_txsim
from celestia_tpu.node import remote as jax_remote
from celestia_tpu.node import server as jax_server
from celestia_tpu.node import testnode as jax_testnode
from celestia_tpu.utils import secp256k1 as jax_secp
from _torch_common import torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch.client import signer as port_signer
from celestia_tpu_torch.client import swarm
from celestia_tpu_torch.client import txsim
from celestia_tpu_torch.da import blob, das, eds_cache
from celestia_tpu_torch.da.namespace import Namespace
from celestia_tpu_torch.node import remote as port_remote
from celestia_tpu_torch.node import server as port_server
from celestia_tpu_torch.node import testnode as port_testnode
from celestia_tpu_torch.utils import secp256k1 as port_secp

GENESIS_NS = 1_700_000_000_000_000_000


def key_sets(x):
    """The nested key structure of a report (values dropped)."""
    return {k: key_sets(v) for k, v in x.items()} if isinstance(x, dict) else None


@pytest.mark.parametrize("seed", [0, 7])
def test_pick_batch_sequence_equals_jax(seed):
    blocks = [(2, 2), (3, 4), (4, 8), (5, 16)]
    out = []
    for mod in (jax_swarm, swarm):
        cfg = mod.SwarmConfig(seed=seed)
        seq = []
        for generation in (0, 3):
            for i in range(12):
                cl = mod.SwarmClient(i, generation, i < cfg.hostile, blocks, cfg)
                seq += [(cl.peer_id, cl.pick_batch()) for _ in range(4)]
        out.append(seq)
    assert out[1] == out[0]
    assert any(len(coords) > 16 * 6 for _, (_, coords) in out[1])  # hostile over-ask


@pytest.fixture(scope="module")
def served():
    """A port node on the CPU with 4 seeded heights of PayForBlobs, behind
    a NodeServer on 127.0.0.1."""
    eds_cache.clear()
    rng = np.random.default_rng(5)
    keys = [port_secp.PrivateKey.from_seed(b"swarm-parity-%d" % i) for i in range(3)]
    node = port_testnode.TestNode(funded_accounts=[(k, 10**13) for k in keys],
                                  auto_produce=False, device="cpu")
    signers = [port_signer.Signer(node, k) for k in keys]
    for s in signers:
        s.confirm_tx = lambda tx_hash, **kw: port_signer.SubmitResult(0, "", tx_hash)
    for _ in range(4):
        for s in signers:
            res = s.submit_pay_for_blob([blob.Blob(Namespace.v0(b"\x01" + rng.bytes(9)),
                                                   rng.bytes(int(rng.integers(100, 4000))))])
            assert res.code == 0, res.log
        node.produce_block()
    server = port_server.NodeServer(node, block_interval_s=None)
    server.start()
    blocks = [(b.header.height, b.header.square_size) for b in node.blocks if b.txs]
    roots = {b.header.height: b.header.data_hash for b in node.blocks}
    yield server.address, blocks, roots
    server.stop()
    eds_cache.clear()


def test_run_swarm_against_a_port_server(served):
    address, blocks, roots = served
    assert len(blocks) == 4 and max(k for _, k in blocks) >= 4
    answers = []
    reports = []
    for mod, kw in ((jax_swarm, {}),
                    (swarm, {"on_served": lambda h, coords, out: answers.append((h, coords, out))})):
        cfg = mod.SwarmConfig(clients=12, hostile=2, rounds=2, samples_per_round=1,
                              hostile_multiplier=2, batch_sizes=(2, 4), workers=4, seed=3)
        reports.append(mod.run_swarm(address, blocks, cfg, **kw))
    assert key_sets(reports[1]) == key_sets(reports[0])
    port = reports[1]
    assert port["rounds_run"] == 2 and port["requests"] == 24 and not port["deadline_hit"]
    assert port["cells_served"] > 0 and len(answers) == port["requests"] - port["failed"]
    assert sum(len(out["proofs"]) for _, _, out in answers) == port["cells_served"]
    for h, coords, out in answers:
        for p in out["proofs"]:
            proof = das.SampleProof.from_dict(p)
            assert (proof.row, proof.col) in set(coords)
            assert proof.verify(roots[h])


def recording(remote_cls):
    """``remote_cls`` recording the hash of every broadcast in ``hashes``."""

    class RecordingRemote(remote_cls):
        def broadcast_tx(self, raw):
            res = super().broadcast_tx(raw)
            self.hashes.append(res.tx_hash)
            return res

    return RecordingRemote


def test_run_remote_equals_jax_on_both_servers():
    """The port's run_remote against a port server and a JAX server, and
    JAX's against the JAX server: equal tx hashes and records."""
    runs = []
    for txsim_mod, remote_mod, signer_mod, secp, node in (
        (jax_txsim, jax_remote, jax_signer, jax_secp, "jax"),
        (txsim, port_remote, port_signer, port_secp, "jax"),
        (txsim, port_remote, port_signer, port_secp, "port"),
    ):
        master = secp.PrivateKey.from_seed(b"txsim-parity-master")
        if node == "jax":
            n = jax_testnode.TestNode(funded_accounts=[(jax_secp.PrivateKey(master.d), 10**13)],
                                      genesis_time_ns=GENESIS_NS)
            srv_cls = jax_server.NodeServer
        else:
            n = port_testnode.TestNode(funded_accounts=[(master, 10**13)],
                                       genesis_time_ns=GENESIS_NS, device="cpu")
            srv_cls = port_server.NodeServer
        server = srv_cls(n, block_interval_s=None)
        server.start()
        remote = recording(remote_mod.RemoteNode)(server.address, timeout_s=60.0)
        remote.hashes = []
        try:
            records = txsim_mod.run_remote(
                remote, signer_mod.Signer(remote, master),
                [txsim_mod.BlobSequence(size_max=1500), txsim_mod.SendSequence()],
                iterations=3, seed=4, funding=10**9)
        finally:
            remote.close()
            server.stop()
        runs.append((remote.hashes, records))
    assert runs[1] == runs[0] and runs[2] == runs[0]
    hashes, records = runs[0]
    assert len(records) == 6 and all(r["code"] == 0 for r in records)
    assert {r["type"] for r in records} == {"blob", "send"} and len(hashes) == 7
