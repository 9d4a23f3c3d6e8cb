"""The port's App against the JAX package's App, height by height.

The same seeded stream of signed transactions (sends, PayForBlobs of 1-3
blobs, a height whose BlobTxs overfill the square, a bad signature, a wrong
sequence, a fee below the minimum) goes through CheckTx, PrepareProposal,
ProcessProposal (the honest block and three tampered ones) and
FinalizeBlock on the port's ``App(device="cpu")`` and on the JAX App.
Every result must be equal: CheckTx codes, the prepared block's txs, square
size and data root, the verdicts and their reasons, the tx results with
their events, the end-block responses and the app hashes.  Then the state
is carried across (a JAX export imported into the port), the mesh legs run
over repeated CPU devices, and the port's own departures are pinned: no
mesh fallback, no App without a device, no EDS served across devices.
"""

import ast
import dataclasses
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from celestia_tpu.da import eds_cache as jax_eds_cache
from celestia_tpu.ops import gf256 as jax_gf256
from celestia_tpu.state import app as jax_app
from celestia_tpu.utils import faults as jax_faults
from celestia_tpu_torch.da import eds_cache, inclusion
from celestia_tpu_torch.da.blob import Blob, BlobTx
from celestia_tpu_torch.da.namespace import Namespace
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.parallel import mesh, sharded
from celestia_tpu_torch.state import app as port_app
from celestia_tpu_torch.state.modules.blob import estimate_gas
from celestia_tpu_torch.state.tx import Fee, MsgPayForBlobs, MsgSend, Tx
from celestia_tpu_torch.utils.secp256k1 import PrivateKey

CODECS = (gf256.CODEC_LEOPARD, gf256.CODEC_LAGRANGE)
CHAIN = "parity-1"
GENESIS_TIME_NS = 1_700_000_000 * 10**9
BLOCK_NS = 15 * 10**9
KEYS = [PrivateKey.from_seed(b"app-parity-%d" % i) for i in range(6)]
VALIDATOR = PrivateKey.from_seed(b"app-parity-validator")
SHARE_PAYLOAD = 478  # bytes of blob data a sparse share carries


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


def genesis(codec: str, max_k: int) -> dict:
    return {
        "chain_id": CHAIN,
        "genesis_time_ns": GENESIS_TIME_NS,
        "codec": codec,
        "accounts": [
            {"address": k.public_key().address().hex(), "balance": 10**12} for k in KEYS
        ],
        "validators": [
            {"address": VALIDATOR.public_key().address().hex(), "self_delegation": 10**9}
        ],
        "params": {"blob": {"GovMaxSquareSize": max_k}},
    }


def pair(codec: str, max_k: int):
    """A JAX App and a port App (on the CPU) from one genesis."""
    ref = jax_app.App(chain_id=CHAIN)
    ref.init_chain(genesis(codec, max_k))
    port = port_app.App(chain_id=CHAIN, device="cpu")
    port.init_chain(genesis(codec, max_k))
    assert port.store.app_hash() == ref.store.app_hash()
    return ref, port


# --- the seeded stream ---------------------------------------------------------


def _sign(key, msgs, seq, acct, gas, fee=None):
    amount = math.ceil(gas * 0.002) + 1 if fee is None else fee
    tx = Tx(tuple(msgs), Fee(amount, gas), key.public_key().compressed(), seq, acct)
    return tx.signed(key, CHAIN)


def _pfb(key, blobs, seq, acct, **kw) -> bytes:
    """A BlobTx built as the client's signer builds one: share commitments
    from the port's ``create_commitment``, gas from ``estimate_gas``."""
    msg = MsgPayForBlobs(
        signer=key.public_key().address(),
        namespaces=tuple(b.namespace.raw for b in blobs),
        blob_sizes=tuple(len(b.data) for b in blobs),
        share_commitments=tuple(inclusion.create_commitment(b) for b in blobs),
        share_versions=tuple(b.share_version for b in blobs),
    )
    tx = _sign(key, [msg], seq, acct, estimate_gas([len(b.data) for b in blobs]), **kw)
    return BlobTx(tx=tx.marshal(), blobs=tuple(blobs)).marshal()


def _blob(rng, size: int) -> Blob:
    return Blob(Namespace.v0(b"\x01" + rng.bytes(9)), rng.bytes(size))


def stream(rng, app, height_kind: str, max_k: int):
    """One height's raw txs, each signer used at most once, sequences and
    account numbers read from ``app``'s committed state."""
    order = rng.permutation(len(KEYS))
    signers = [KEYS[i] for i in order]

    def account(key):
        acc = app.accounts.get(key.public_key().address())
        return acc.sequence, acc.account_number

    txs = []
    if height_kind == "overfill":
        # four single-blob PFBs of ~40 % of the square each: some must wait
        for key in signers[:4]:
            size = int(0.4 * max_k * max_k * SHARE_PAYLOAD)
            txs.append(_pfb(key, [_blob(rng, size)], *account(key)))
        return txs
    for key in signers[:2]:
        seq, acct = account(key)
        to = rng.bytes(20)
        send = MsgSend(key.public_key().address(), to, int(rng.integers(1, 10_000)))
        txs.append(_sign(key, [send], seq, acct, 100_000).marshal())
    for key in signers[2:2 + int(rng.integers(1, 4))]:
        blobs = [_blob(rng, int(rng.integers(1, 3 * SHARE_PAYLOAD * max_k // 4)))
                 for _ in range(int(rng.integers(1, 4)))]
        txs.append(_pfb(key, blobs, *account(key)))
    if height_kind == "bad":
        key = signers[5]
        seq, acct = account(key)
        send = MsgSend(key.public_key().address(), rng.bytes(20), 5)
        bad_sig = _sign(key, [send], seq, acct, 100_000)
        sig = bytes([bad_sig.signature[0] ^ 1]) + bad_sig.signature[1:]
        txs.append(dataclasses.replace(bad_sig, signature=sig).marshal())
        txs.append(_sign(key, [send], seq + 5, acct, 100_000).marshal())
        txs.append(_pfb(key, [_blob(rng, 600)], seq, acct, fee=1))
    return txs


# --- comparing the two packages' results ---------------------------------------


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


def tx_results(module, results):
    return [(r.code, r.log, r.gas_wanted, r.gas_used, module.jsonable_events(r.events))
            for r in results]


def run_height(ref, port, txs, height: int, tamper: bool = True) -> dict:
    """One height on both Apps; every step's results equal.  Returns the
    port's prepared proposal and verdicts."""
    checks = [[(r.code, r.log, r.gas_wanted, r.gas_used) for r in map(a.check_tx, txs)]
              for a in (ref, port)]
    assert checks[0] == checks[1]
    p_ref, p_port = ref.prepare_proposal(list(txs)), port.prepare_proposal(list(txs))
    assert p_port.block_txs == p_ref.block_txs
    assert (p_port.square_size, p_port.data_root) == (p_ref.square_size, p_ref.data_root)
    assert p_port.eds.tensor.device.type == "cpu"
    block, k, root = p_port.block_txs, p_port.square_size, p_port.data_root
    proposals = [(block, k, root)]
    if tamper:
        proposals += [
            (block, k, bytes([root[0] ^ 1]) + root[1:]),  # flipped data root
            (block, 2 * k, root),  # wrong square size
            (block[:-1], k, root),  # a dropped tx
        ]
    verdicts = [[a.process_proposal(list(b), kk, r) for b, kk, r in proposals]
                for a in (ref, port)]
    assert verdicts[0] == verdicts[1]
    assert verdicts[1][0] == (True, "")
    assert not any(ok for ok, _ in verdicts[1][1:])
    time_ns = GENESIS_TIME_NS + height * BLOCK_NS
    proposer = VALIDATOR.public_key().address()
    outs = [a.finalize_block(list(block), height, time_ns, root, proposer=proposer)
            for a in (ref, port)]
    assert tx_results(port_app, outs[1][0]) == tx_results(jax_app, outs[0][0])
    assert canon(outs[1][1]) == canon(outs[0][1])
    assert outs[1][2] == outs[0][2]
    assert port.telemetry.counters.get("process_proposal_panic_reject", 0) == (
        ref.telemetry.counters.get("process_proposal_panic_reject", 0))
    return {"prepared": p_port, "verdicts": verdicts[1], "txs": txs}


@pytest.mark.parametrize("max_k", [8, 16])
@pytest.mark.parametrize("codec", CODECS)
def test_app_matches_jax_height_by_height(chains, codec, max_k):
    ref, port = pair(codec, max_k)
    rng = np.random.default_rng(100 + max_k)
    kinds = ["plain", "overfill", "bad", "plain"]
    seen = []
    for height, kind in enumerate(kinds, start=2):
        out = run_height(ref, port, stream(rng, port, kind, max_k), height)
        seen.append(out)
    overfill, bad = seen[1], seen[2]
    # the overfilled height left BlobTxs out, at the full square size
    assert overfill["prepared"].square_size == max_k
    assert len(overfill["prepared"].block_txs) < len(overfill["txs"])
    # the three bad txs were refused by CheckTx and left out of the block
    codes = [port.check_tx(raw).code for raw in bad["txs"][-3:]]
    assert codes == [1, 1, 1]
    assert not set(bad["txs"][-3:]) & set(bad["prepared"].block_txs)
    assert port.telemetry.counters["eds_cache_hit_process"] >= len(kinds)


@pytest.mark.parametrize("codec", CODECS)
def test_exported_jax_state_carries_into_the_port(chains, codec):
    ref, port = pair(codec, 8)
    rng = np.random.default_rng(7)
    for height in (2, 3):
        run_height(ref, port, stream(rng, ref, "plain", 8), height, tamper=False)
    dump = ref.export_genesis()
    ref2 = jax_app.App.import_genesis(dump)
    port2 = port_app.App.import_genesis(dump, device="cpu")
    assert port2.device.type == "cpu" and port2.codec == codec == gf256.active_codec()
    assert port2.store.app_hash() == ref2.store.app_hash()
    for height in (4, 5):
        run_height(ref2, port2, stream(rng, port2, "plain", 8), height, tamper=False)


@pytest.mark.parametrize("codec", CODECS)
def test_validate_blocks_batched_on_a_cpu_mesh(chains, codec):
    """Proposals cut from one state (disjoint signers), validated in one
    batched call: the port's over a 1 x 2 mesh of repeated CPU devices,
    the JAX App's per block.  Verdicts and data roots equal; the port's
    sharded and batched legs ran."""
    ref, port = pair(codec, 8)
    mesh.configure("1x2", ["cpu"] * 2)
    rng = np.random.default_rng(11)
    groups = [KEYS[0:2], KEYS[2:4], KEYS[4:6]]
    proposals, ref_roots = [], []
    for keys in groups:
        txs = []
        for key in keys:
            acc = port.accounts.get(key.public_key().address())
            txs.append(_pfb(key, [_blob(rng, int(rng.integers(500, 6000)))],
                            acc.sequence, acc.account_number))
        p_ref, p_port = ref.prepare_proposal(txs), port.prepare_proposal(txs)
        assert p_port.data_root == p_ref.data_root and p_port.block_txs == p_ref.block_txs
        proposals.append((p_port.block_txs, p_port.square_size, p_port.data_root))
        ref_roots.append(p_ref.data_root)
    assert port.telemetry.counters["extend_sharded"] == len(groups)
    block, k, root = proposals[0]
    proposals.append((block, k, bytes(32)))  # a forged root
    validator = port_app.App(chain_id=CHAIN, device="cpu")
    validator.init_chain(genesis(codec, 8))
    ref_validator = jax_app.App(chain_id=CHAIN)
    ref_validator.init_chain(genesis(codec, 8))
    eds_cache.clear()  # the validator extends the squares itself
    got = validator.validate_blocks_batched(proposals)
    want = ref_validator.validate_blocks_batched(proposals)
    assert got == want
    assert [ok for ok, _ in got] == [True] * len(groups) + [False]
    assert [p[2] for p in proposals[:-1]] == ref_roots
    # every proposal's square went through the batched leg (the forged one
    # too: the extension never trusts a claimed root)
    assert validator.telemetry.counters["extend_batched_blocks"] == len(proposals)
    assert validator.telemetry.counters["eds_cache_hit_process"] == len(proposals)
    assert mesh.stats()["batched_dispatches"] >= 1


def test_a_sharded_failure_raises_from_prepare(chains, monkeypatch):
    """No fallback: a failing sharded extension is not retried on the
    single-device path, and no poison is set."""
    _, port = pair(gf256.CODEC_LEOPARD, 8)
    mesh.configure("1x2", ["cpu"] * 2)
    calls = []

    def broken(square, m):
        raise RuntimeError("sharded launch failed")

    def single(*a, **kw):
        calls.append(a)
        raise AssertionError("the single-device path ran")

    monkeypatch.setattr(sharded, "extend_block_sharded", broken)
    monkeypatch.setattr(port_app.dah_mod, "extend_block", single)
    key = KEYS[0]
    acc = port.accounts.get(key.public_key().address())
    txs = [_pfb(key, [_blob(np.random.default_rng(3), 2000)], acc.sequence,
                acc.account_number)]
    with pytest.raises(RuntimeError, match="sharded launch failed"):
        port.prepare_proposal(txs)
    assert not calls
    assert "extend_mesh_degraded" not in port.telemetry.counters
    # no App path names a poison: the mesh provider has none to call
    assert not hasattr(mesh, "poison")
    tree = ast.parse(Path(port_app.__file__).read_text())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not {x for x in names if "poison" in x}


def test_a_batched_failure_raises_from_validate(chains, monkeypatch):
    _, port = pair(gf256.CODEC_LEOPARD, 8)
    key = KEYS[1]
    acc = port.accounts.get(key.public_key().address())
    txs = [_pfb(key, [_blob(np.random.default_rng(4), 3000)], acc.sequence,
                acc.account_number)]
    prepared = port.prepare_proposal(txs)
    eds_cache.clear()
    mesh.configure("1x2", ["cpu"] * 2)

    def broken(*a, **kw):
        raise RuntimeError("batched launch failed")

    monkeypatch.setattr(sharded, "extend_and_headers_sharded_batch", broken)
    with pytest.raises(RuntimeError, match="batched launch failed"):
        port.validate_blocks_batched(
            [(prepared.block_txs, prepared.square_size, prepared.data_root)]
        )


def test_app_without_a_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_app.App()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_app.App(device="cuda:0")
    assert port_app.App(device="cpu").device.type == "cpu"


def test_eds_cache_is_scoped_by_device(chains, monkeypatch):
    """An entry made by a CPU App is never returned for a cuda:0 lookup,
    and a mesh on another device is not the App's."""
    _, port = pair(gf256.CODEC_LEOPARD, 8)
    key = KEYS[2]
    acc = port.accounts.get(key.public_key().address())
    txs = [_pfb(key, [_blob(np.random.default_rng(5), 1500)], acc.sequence,
                acc.account_number)]
    prepared = port.prepare_proposal(txs)
    content = eds_cache.make_key(prepared.block_txs, prepared.square_size,
                                 port.app_version, gf256.active_codec())
    assert eds_cache.get(content, "cpu") is not None
    assert eds_cache.get(content, "cuda:0") is None
    assert eds_cache.content_cache("cuda:0") is not eds_cache.content_cache("cpu")
    assert eds_cache.content_cache("cpu") is eds_cache.content_cache("cpu")
    # a mesh whose first device is not the App's device is not its mesh
    card_mesh = types.SimpleNamespace(first_device=torch.device("cuda", 0))
    monkeypatch.setattr(mesh, "device_mesh", lambda: card_mesh)
    assert port._mesh_provider() is None
    assert port.process_proposal(prepared.block_txs, prepared.square_size,
                                 prepared.data_root) == (True, "")
    assert port.telemetry.counters.get("extend_sharded", 0) == 0
