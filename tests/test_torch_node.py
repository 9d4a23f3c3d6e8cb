"""The port's devnet node against the JAX package's, height by height.

One seeded stream of Signer-built transactions (sends, PayForBlobs of 1-3
blobs, a height whose PayForBlobs overfill the square and leave some for
the next block, an empty block) goes to the JAX ``TestNode`` and to the
port's ``TestNode(device="cpu")``, each through its own package's
``Signer``.  A height closes through the Signer's confirmation (the node
cuts the block for a poll-confirm client) or through ``produce_block``.
Per height the transaction hashes, the blocks (headers with data roots and
app hashes, tx results with their events, commit info) and the answers of
the five proof routes (DAS cell and batch, namespace data, share and tx
proofs) must be equal, the answers as canonical JSON byte for byte; then
the same for an old block rebuilt by ``_block_artifacts`` after it left
the node's EDS cache.  Then the chain state crosses packages: a JAX data
dir is recovered by the port, the port's logs equal JAX's byte for byte,
and a JAX snapshot is restored by the port.  Last, the port's departures
are pinned: no node without a device, and no fallback from a failed batched
catch-up leg.
"""

import dataclasses
import hashlib
import json
import types

import numpy as np
import pytest
import torch

from celestia_tpu.client import signer as jax_signer
from celestia_tpu.client import txsim as jax_txsim
from celestia_tpu.da import blob as jax_blob
from celestia_tpu.da import eds_cache as jax_eds_cache
from celestia_tpu.da import namespace as jax_namespace
from celestia_tpu.node import bft as jax_bft
from celestia_tpu.node import testnode as jax_testnode
from celestia_tpu.ops import gf256 as jax_gf256
from celestia_tpu.state import tx as jax_tx
from celestia_tpu.utils import faults as jax_faults
from celestia_tpu.utils import secp256k1 as jax_secp
from _torch_common import jitted_jax_level_stack, torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch.client import signer as port_signer
from celestia_tpu_torch.client import txsim as port_txsim
from celestia_tpu_torch.da import blob as port_blob
from celestia_tpu_torch.da import eds_cache
from celestia_tpu_torch.da import namespace as port_namespace
from celestia_tpu_torch.node import bft as port_bft
from celestia_tpu_torch.node import testnode as port_testnode
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.parallel import mesh
from celestia_tpu_torch.state import tx as port_tx
from celestia_tpu_torch.utils import secp256k1 as port_secp

CODECS = (gf256.CODEC_LEOPARD, gf256.CODEC_LAGRANGE)
CHAIN = "devnet-parity-1"
GENESIS_TIME_NS = 1_700_000_000 * 10**9
N_KEYS = 6
SHARE_PAYLOAD = 478  # bytes of blob data a sparse share carries

JAX = types.SimpleNamespace(
    Blob=jax_blob.Blob, Namespace=jax_namespace.Namespace, MsgSend=jax_tx.MsgSend,
    Key=jax_secp.PrivateKey, Signer=jax_signer.Signer,
    SubmitResult=jax_signer.SubmitResult, TestNode=jax_testnode.TestNode, node_kw={},
)
PORT = types.SimpleNamespace(
    Blob=port_blob.Blob, Namespace=port_namespace.Namespace, MsgSend=port_tx.MsgSend,
    Key=port_secp.PrivateKey, Signer=port_signer.Signer,
    SubmitResult=port_signer.SubmitResult, TestNode=port_testnode.TestNode,
    node_kw={"device": "cpu"},
)


@pytest.fixture
def chains():
    """Both packages' codec, EDS caches and the port's mesh restored after
    the test, and no degradation left counted in the JAX package's faults."""
    saved = (jax_gf256.active_codec(), gf256.active_codec())
    jax_faults.reset_stats()
    yield
    jax_gf256.set_active_codec(saved[0])
    gf256.set_active_codec(saved[1])
    jax_eds_cache.clear()
    eds_cache.clear()
    mesh._reset_for_tests()
    jax_faults.reset_stats()


def genesis(side, codec: str, max_k: int) -> dict:
    keys = [side.Key.from_seed(b"node-parity-%d" % i) for i in range(N_KEYS)]
    validator = side.Key.from_seed(b"node-parity-validator")
    return {
        "chain_id": CHAIN,
        "genesis_time_ns": GENESIS_TIME_NS,
        "codec": codec,
        "accounts": [
            {"address": k.public_key().address().hex(), "balance": 10**12} for k in keys
        ],
        "validators": [
            {"address": validator.public_key().address().hex(), "self_delegation": 10**9}
        ],
        "params": {"blob": {"GovMaxSquareSize": max_k}},
    }


class Chain:
    """One package's TestNode with a Signer for each funded key."""

    def __init__(self, side, codec: str, max_k: int, **node_kw):
        self.side = side
        self.node = side.TestNode(
            chain_id=CHAIN, genesis=genesis(side, codec, max_k),
            validator_key=side.Key.from_seed(b"node-parity-validator"),
            **side.node_kw, **node_kw,
        )
        self.signers = [
            side.Signer(self.node, side.Key.from_seed(b"node-parity-%d" % i))
            for i in range(N_KEYS)
        ]

    def submit(self, item, confirm: bool):
        return submit(self.side, self.signers[item["key"]], item, confirm)


def submit(side, signer, item, confirm: bool = False):
    """Send one stream item through ``signer``.  Without ``confirm`` the
    Signer broadcasts only (its confirmation poll is skipped)."""
    if item["kind"] == "send":
        call = lambda: signer.submit_tx(  # noqa: E731
            [side.MsgSend(signer.address, item["to"], item["amount"])])
    else:
        blobs = [side.Blob(side.Namespace.v0(ns), data) for ns, data in item["blobs"]]
        call = lambda: signer.submit_pay_for_blob(blobs)  # noqa: E731
    if confirm:
        return call()
    signer.confirm_tx = lambda tx_hash, **kw: side.SubmitResult(0, "", tx_hash)
    try:
        return call()
    finally:
        del signer.confirm_tx


def stream(rng, kind: str, max_k: int):
    """One height's items, package-neutral; each key used at most once."""
    keys = [int(i) for i in rng.permutation(N_KEYS)]
    if kind == "empty":
        return []
    if kind == "overfill":
        # four single-blob PFBs of ~40 % of the square each: some must wait
        size = int(0.4 * max_k * max_k * SHARE_PAYLOAD)
        return [{"kind": "pfb", "key": key, "blobs": [(b"\x01" + rng.bytes(9), rng.bytes(size))]}
                for key in keys[:4]]
    items = [{"kind": "send", "key": key, "to": rng.bytes(20),
              "amount": int(rng.integers(1, 10_000))} for key in keys[:2]]
    for key in keys[2:2 + int(rng.integers(1, 4))]:
        # each blob within 3 rows of the square, so the JAX namespace query
        # stays on its host leg
        blobs = [(b"\x01" + rng.bytes(9), rng.bytes(int(rng.integers(1, 3 * SHARE_PAYLOAD * max_k))))
                 for _ in range(int(rng.integers(1, 4)))]
        items.append({"kind": "pfb", "key": key, "blobs": blobs})
    return items


def canon(x):
    """A package-neutral form: dataclasses by class name and fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: canon(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    return x


ROUTES = ("custom/das/sample", "custom/das/sample_batch", "custom/namespace/shares",
          "custom/proof/share", "custom/proof/tx")


def query_args(route: str, block) -> dict:
    """A proof route's arguments at one block, seeded by its height.  The
    share range and the namespace stay within few rows, so the JAX
    package's proofs compile few level-stack shapes."""
    h, k = block.header.height, block.header.square_size
    rng = np.random.default_rng(h)
    cells = [[int(r), int(c)] for r, c in rng.integers(0, 2 * k, (16, 2))]
    if route == "custom/das/sample":
        return {"height": h, "row": cells[0][0], "col": cells[0][1]}
    if route == "custom/das/sample_batch":
        return {"height": h, "coords": cells}
    if route == "custom/proof/share":
        start = int(rng.integers(0, k - 1)) if k > 1 else 0
        return {"height": h, "start": start, "end": min(start + 2, k)}
    if route == "custom/proof/tx":
        return {"height": h, "tx_index": int(rng.integers(0, len(block.txs)))}
    wrapped = [port_blob.unmarshal_blob_tx(t) for t in block.txs]
    blobs = sorted((len(b.data), b.namespace.raw) for btx in wrapped if btx is not None
                   for b in btx.blobs)
    # the smallest blob's namespace, or one absent from the block when every
    # blob spans more than 3 rows
    small = [ns for size, ns in blobs if size <= 3 * SHARE_PAYLOAD * k]
    namespace = small[0] if small else port_namespace.Namespace.v0(b"absent").raw
    return {"height": h, "namespace": namespace.hex()}


def answer(node, route: str, block) -> str:
    """The route's answer at ``block`` as canonical JSON."""
    return json.dumps(node.abci_query(route, query_args(route, block)), sort_keys=True)


def run_height(ref: Chain, port: Chain, items, close: str):
    """One height's items on both chains through the Signers, then the
    blocks: ``"confirm"`` lets the last item's confirmation cut a block
    and then drains the pool, ``"produce"`` cuts one block and may leave
    txs pooled, ``"drain"`` cuts blocks until the pool is empty.  Returns
    the tx hashes and the port's new blocks, each equal to the JAX
    node's."""
    start, hashes = port.node.height, []
    for i, item in enumerate(items):
        last = close == "confirm" and i == len(items) - 1
        got = [c.submit(item, confirm=last) for c in (ref, port)]
        assert canon(got[0]) == canon(got[1])
        assert got[1].code == 0, got[1].log
        hashes.append(got[1].tx_hash)
    if close != "confirm" or not items:
        for c in (ref, port):
            c.node.produce_block()
    while close != "produce" and len(port.node.mempool):
        for c in (ref, port):
            c.node.produce_block()
    assert ref.node.height == port.node.height
    assert len(ref.node.mempool) == len(port.node.mempool)
    blocks = [port.node.block(h) for h in range(start + 1, port.node.height + 1)]
    for blk in blocks:
        assert canon(blk) == canon(ref.node.block(blk.header.height))
    return hashes, blocks


@pytest.fixture(scope="module", params=[(c, k) for k in (8, 16) for c in CODECS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def devnets(request, jitted_jax_level_stack):
    """Both packages' nodes driven through one seeded stream at one codec
    and GovMaxSquareSize: a height closed by a Signer's confirmation, an
    overfilled height, the pool drained, an empty block."""
    codec, max_k = request.param
    saved = (jax_gf256.active_codec(), gf256.active_codec())
    ref, port = Chain(JAX, codec, max_k), Chain(PORT, codec, max_k)
    assert port.node.app.device.type == "cpu"
    assert port.node.app.store.app_hash() == ref.node.app.store.app_hash()
    rng = np.random.default_rng(200 + max_k)
    kinds = [("plain", "confirm"), ("overfill", "produce"), ("empty", "drain"),
             ("empty", "produce")]
    submitted, blocks = [], []
    for kind, close in kinds:
        hashes, new = run_height(ref, port, stream(rng, kind, max_k), close)
        submitted += hashes
        blocks += new
    yield types.SimpleNamespace(ref=ref, port=port, max_k=max_k, submitted=submitted,
                                blocks=blocks)
    jax_gf256.set_active_codec(saved[0])
    gf256.set_active_codec(saved[1])
    jax_eds_cache.clear()
    eds_cache.clear()


def test_testnode_blocks_match_jax_height_by_height(devnets):
    ref, port, blocks = devnets.ref, devnets.port, devnets.blocks
    assert [canon(b) for b in port.node.blocks] == [canon(b) for b in ref.node.blocks]
    assert port.node.app.store.app_hash() == ref.node.app.store.app_hash()
    # the overfilled height filled the square and left PFBs in the pool,
    # and the drain took them; the last block is empty
    assert blocks[1].header.square_size == devnets.max_k
    assert len(blocks[1].txs) < 4 and blocks[2].txs and not blocks[-1].txs
    included = {hashlib.sha256(t).digest() for b in port.node.blocks for t in b.txs}
    assert set(devnets.submitted) == included
    for blk in blocks:
        # every block's artifacts are the proposer's, on the App's device
        art = port.node._eds_cache[blk.header.height]
        assert art["eds"].tensor.device.type == "cpu"
        assert art["dah"].hash == blk.header.data_hash


@pytest.mark.parametrize("route", ROUTES)
def test_testnode_proof_queries_match_jax_height_by_height(devnets, route):
    for blk in devnets.blocks:
        if route == "custom/proof/tx" and not blk.txs:
            continue
        assert answer(devnets.port.node, route, blk) == answer(devnets.ref.node, route, blk)


def test_a_rebuilt_block_answers_like_jax(devnets):
    """An aged-out block is rebuilt on the App's device by
    ``_block_artifacts``, and every route answers as the JAX node does."""
    ref, port = devnets.ref.node, devnets.port.node
    old = devnets.blocks[0]
    for node in (ref, port):
        node._eds_cache.clear()
    for route in ROUTES:
        assert answer(port, route, old) == answer(ref, route, old)
    rebuilt = port._eds_cache[old.header.height]
    assert rebuilt["dah"].hash == old.header.data_hash
    assert rebuilt["eds"].tensor.device.type == "cpu"
    assert list(port._eds_cache) == [old.header.height]


def _drive(chains_, heights: int, seed: int, max_k: int = 8):
    """``heights`` rounds of the seeded stream on each chain, each round's
    pool drained into blocks."""
    rng = np.random.default_rng(seed)
    kinds = ["plain", "empty", "plain"]
    for i in range(heights):
        items = stream(rng, kinds[i % len(kinds)], max_k)
        for c in chains_:
            for item in items:
                assert c.submit(item, confirm=False).code == 0
            c.node.produce_block()
            while len(c.node.mempool):
                c.node.produce_block()


def test_a_rebuilt_data_root_mismatch_raises(chains):
    """A block whose rebuilt square does not give its recorded data root
    raises, as in the JAX package; nothing is served."""
    port = Chain(PORT, gf256.CODEC_LEOPARD, 8)
    _drive([port], 1, seed=1)
    h = port.node.height
    blk = port.node.block(h)
    blk.header = dataclasses.replace(blk.header, data_hash=bytes(32))
    port.node._eds_cache.clear()
    with pytest.raises(RuntimeError, match=f"reconstructed data root mismatch at height {h}"):
        port.node.abci_query("custom/das/sample", {"height": h, "row": 0, "col": 0})


@pytest.mark.parametrize("codec", CODECS)
def test_a_jax_data_dir_recovers_on_the_port_and_logs_are_equal(chains, codec, tmp_path):
    ref = Chain(JAX, codec, 8, data_dir=str(tmp_path / "jax"), state_checkpoint_interval=2)
    port = Chain(PORT, codec, 8, data_dir=str(tmp_path / "port"), state_checkpoint_interval=2)
    _drive([ref, port], 3, seed=40)
    height, app_hash = ref.node.height, ref.node.blocks[-1].header.app_hash
    assert port.node.blocks[-1].header.app_hash == app_hash
    for c in (ref, port):
        c.node.close()
    for name in ("blocks.log", "state.log"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # the JAX data dir, recovered by both packages
    ref2 = jax_testnode.TestNode(data_dir=str(tmp_path / "jax"))
    ref2.close()
    port2 = port_testnode.TestNode(data_dir=str(tmp_path / "jax"), device="cpu")
    assert port2.app.device.type == "cpu"
    assert port2.height == ref2.height == height
    assert port2.app.store.committed_hash(height) == app_hash
    assert port2.app.store.app_hash() == ref2.app.store.app_hash()
    assert [canon(b) for b in port2.blocks] == [canon(b) for b in ref2.blocks]
    # the recovered chain goes on in the JAX data dir
    block = port2.produce_block()
    ref4 = jax_testnode.TestNode(data_dir=str(tmp_path / "jax"))
    # the port appended to the JAX logs; the JAX package recovers them
    assert ref4.height == height + 1
    assert ref4.blocks[-1].header.app_hash == block.header.app_hash
    ref4.close()
    port2.close()


@pytest.mark.parametrize("codec", CODECS)
def test_a_jax_snapshot_restores_on_the_port(chains, codec, tmp_path):
    ref = Chain(JAX, codec, 8, snapshot_dir=str(tmp_path / "jax"), snapshot_interval=2)
    port = Chain(PORT, codec, 8, snapshot_dir=str(tmp_path / "port"), snapshot_interval=2)
    _drive([ref, port], 3, seed=50)
    snap_height = 2 * (ref.node.height // 2)
    assert ref.node.snapshots.latest().height == port.node.snapshots.latest().height == snap_height
    want = ref.node.app.store.committed_hash(snap_height)
    for d in ("jax", "port"):
        restored = port_testnode.TestNode.from_snapshot(str(tmp_path / d), device="cpu")
        assert restored.app.device.type == "cpu"
        assert restored.height == snap_height
        assert restored.app.store.app_hash() == want
    ref_restored = jax_testnode.TestNode.from_snapshot(str(tmp_path / "jax"))
    # both restored nodes cut the same next block (a restored node's clock
    # starts at the wall clock; both are set to the chain's)
    ref_restored._now_ns = restored._now_ns = ref.node.blocks[-1].header.time_ns
    a, b = ref_restored.produce_block(), restored.produce_block()
    assert canon(a) == canon(b)


def test_testnode_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_testnode.TestNode()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_testnode.TestNode(device="cuda:0")
    assert port_testnode.TestNode(device="cpu").app.device == torch.device("cpu")


def _decided_wires(bft, chain, n: int) -> list:
    """Wires of ``n`` decided blocks after the chain's head (the batch
    catch-up parses them; their certificates are never reached)."""
    wires = []
    for i in range(n):
        payload = bft.BlockPayload(
            height=chain.node.height + 1 + i, time_ns=GENESIS_TIME_NS + i,
            square_size=1, data_root=bytes(32), txs=(),
        )
        wires.append({"payload": payload.to_wire(), "precommits": []})
    return wires


def test_a_failed_catch_up_warm_leg_raises(chains, monkeypatch):
    """The port's batched catch-up has no per-block fallback: the failure
    of its warm leg raises and nothing is adopted.  The JAX package notes
    the same failure and goes on block by block."""
    chains_ = {}
    for name, side, bft in (("jax", JAX, jax_bft), ("port", PORT, port_bft)):
        c = Chain(side, gf256.CODEC_LEOPARD, 8)
        key = side.Key.from_seed(b"node-parity-validator")
        valset = [{"address": key.public_key().address().hex(),
                   "pubkey": key.public_key().compressed().hex(), "power": 10}]
        c.node.enable_bft(valset)

        def broken(*a, **kw):
            raise RuntimeError("batched extension failed")

        monkeypatch.setattr(c.node.app, "validate_blocks_batched", broken)
        chains_[name] = (c, bft)
    port, pbft = chains_["port"]
    height = port.node.height
    with pytest.raises(RuntimeError, match="batched extension failed"):
        port.node.bft_catchup_batch(_decided_wires(pbft, port, 2))
    assert port.node.height == height
    ref, jbft = chains_["jax"]
    adopted, why = ref.node.bft_catchup_batch(_decided_wires(jbft, ref, 2))
    assert adopted == 0 and why
    assert "gossip.catchup_batch" in jax_faults.fault_stats()["notes"]


def test_txsim_run_matches_jax(chains):
    """txsim's blob, send and stake sequences, each through its own
    Signer, against both packages' nodes: equal records and blocks."""
    nodes, records = [], []
    for side, txsim in ((JAX, jax_txsim), (PORT, port_txsim)):
        node = Chain(side, gf256.CODEC_LEOPARD, 8).node
        sequences = (txsim.BlobSequence(size_min=100, size_max=3000, blobs_per_tx=2).clone(2)
                     + [txsim.SendSequence(amount=10), txsim.StakeSequence(amount=10**6)])
        records.append(txsim.run(node, sequences, iterations=2, seed=3))
        nodes.append(node)
    assert records[1] == records[0]
    assert [r["code"] for r in records[1]] == [0] * 8
    assert [canon(b) for b in nodes[1].blocks] == [canon(b) for b in nodes[0].blocks]
