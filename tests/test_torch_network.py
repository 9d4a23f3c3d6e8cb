"""The port's in-process validator networks against the JAX package's.

``ValidatorNetwork`` (the single-phase, centrally sequenced driver) and
``BFTNetwork`` (every validator runs the two-phase engine) are built by both
packages from the same keys, the port's on ``device="cpu"``.  One seeded
stream of Signer-built sends and PayForBlobs goes to both; every round, vote
(with its signature), block and app hash must be equal, and every validator
of a network must end on one app hash.  A byzantine proposer of each kind
is rejected with the JAX package's reasons, a joining validator catches up
through ``dah.data_roots_batched`` and lands on the networks' app hash, a
tampered chain is refused with the JAX package's message, and the
networks refuse to start without a card unless asked for the CPU.
"""

import dataclasses

import numpy as np
import pytest

from celestia_tpu.da import eds_cache as jax_eds_cache
from celestia_tpu.node import bft_network as jax_bft_network
from celestia_tpu.node import network as jax_network
from celestia_tpu.utils import faults as jax_faults
from _torch_common import torch_one_thread  # noqa: F401 (fixture)
from test_torch_node import JAX, PORT, canon, stream, submit
from celestia_tpu_torch.da import dah, eds_cache
from celestia_tpu_torch.node import bft_network as port_bft_network
from celestia_tpu_torch.node import network as port_network

ALICE = b"network-parity-alice"
BOB = b"network-parity-bob"


@pytest.fixture
def caches():
    """Both packages' EDS caches emptied after the test, and no note left
    in the JAX package's faults."""
    jax_faults.reset_stats()
    yield
    jax_eds_cache.clear()
    eds_cache.clear()
    jax_faults.reset_stats()


class Net:
    """One package's network with Signers for two funded keys."""

    def __init__(self, side, module, cls: str, **kw):
        self.side = side
        keys = [side.Key.from_seed(s) for s in (ALICE, BOB)]
        if side is PORT:
            kw["device"] = "cpu"
        self.net = getattr(module, cls)(
            n_validators=4, funded_accounts=[(k, 10**14) for k in keys], **kw
        )
        self.signers = [side.Signer(self.net, k) for k in keys]

    def submit(self, item):
        """Broadcast one stream item through a Signer (the networks cut
        blocks only when told)."""
        return submit(self.side, self.signers[item["key"] % 2], item)


def items_of(rng, kind: str, n_pfbs: int = 0):
    """The seeded stream's items for the two keys (one each), or
    ``n_pfbs`` single-blob PFBs with distinct namespaces."""
    if n_pfbs:
        return [{"kind": "pfb", "key": i, "blobs": [(b"\x02" + bytes([i]) * 9, rng.bytes(700))]}
                for i in range(n_pfbs)]
    picked = {}
    for item in stream(rng, kind, 8):
        picked.setdefault(item["key"] % 2, item)
    return [picked[k] for k in sorted(picked)]


def drive(nets, items):
    """One height on every network: the items, then one block each."""
    for item in items:
        got = [n.submit(item) for n in nets]
        assert canon(got[0]) == canon(got[1]) and got[1].code == 0, got[1].log
    return [n.net.produce_block() for n in nets]


def app_hashes(net) -> set:
    return {v.app.store.app_hash() for v in net.validators}


def test_validator_network_matches_jax(caches, monkeypatch):
    ref, port = (Net(s, m, "ValidatorNetwork") for s, m in
                 ((JAX, jax_network), (PORT, port_network)))
    assert {v.app.device.type for v in port.net.validators} == {"cpu"}
    rng = np.random.default_rng(60)
    for kind in ("plain", "empty", "plain", "plain"):
        blocks = drive((ref, port), items_of(rng, kind))
        assert canon(blocks[1]) == canon(blocks[0])
        assert canon(port.net.rounds) == canon(ref.net.rounds)
        assert app_hashes(port.net) == app_hashes(ref.net) == {blocks[1].header.app_hash}
    assert all(r.committed and all(v.accept for v in r.votes) for r in port.net.rounds)
    # the joiner catches up through the batched data roots on the device
    # and lands on the app hash of both networks.  (The JAX package's own
    # join runs its vmapped NMT roots eagerly, a few hundred XLA compiles:
    # its network's app hash is the reference here.)
    calls = []
    batched = dah.data_roots_batched

    def spy(squares, device=None):
        calls.append((squares.shape, device))
        return batched(squares, device=device)

    monkeypatch.setattr(dah, "data_roots_batched", spy)
    joined = port.net.join_validator()
    assert joined.app.store.app_hash() == ref.net.validators[0].app.store.app_hash()
    assert joined.app.device.type == "cpu" and len(port.net.validators) == 5
    assert sum(shape[0] for shape, _ in calls) == len(port.net.blocks)
    assert {str(device) for _, device in calls} == {"cpu"}
    # a chain whose header lies about a data root is refused, with the
    # JAX package's message (celestia_tpu/node/network.py join_validator)
    good = port.net.blocks[1]
    port.net.blocks[1] = dataclasses.replace(
        good, header=dataclasses.replace(good.header, data_hash=bytes(32)))
    with pytest.raises(port_network.ConsensusFailure,
                       match=f"^catch-up: data root mismatch at height {good.header.height}$"):
        port.net.join_validator()
    assert len(port.net.validators) == 5


@pytest.mark.parametrize("handler", ["out_of_order", "lying_data_root"])
def test_a_byzantine_proposer_is_rejected_like_jax(caches, handler):
    """Validator 1 proposes at height 5 (round 0); three honest validators
    reject its block with the JAX package's reasons, and the next
    proposer's block commits."""
    ref, port = (Net(s, m, "ValidatorNetwork", malicious={1: handler}) for s, m in
                 ((JAX, jax_network), (PORT, port_network)))
    rng = np.random.default_rng(70)
    for _ in range(3):
        drive((ref, port), [])
    blocks = drive((ref, port), items_of(rng, "", n_pfbs=2))
    assert canon(blocks[1]) == canon(blocks[0])
    assert canon(port.net.rounds) == canon(ref.net.rounds)
    rejected, committed = port.net.rounds[-2:]
    assert (rejected.height, rejected.proposer, rejected.committed) == (5, "val-1", False)
    accepts = [v.validator for v in rejected.votes if v.accept]
    assert accepts == ["val-1"] and len(rejected.votes) == 4
    assert all(v.reason for v in rejected.votes if not v.accept)
    assert (committed.height, committed.proposer, committed.committed) == (5, "val-2", True)
    assert app_hashes(port.net) == app_hashes(ref.net) == {blocks[1].header.app_hash}


def test_bft_network_matches_jax(caches):
    ref, port = (Net(s, m, "BFTNetwork") for s, m in
                 ((JAX, jax_bft_network), (PORT, port_bft_network)))
    assert {v.app.device.type for v in port.net.validators} == {"cpu"}
    rng = np.random.default_rng(80)
    for kind in ("plain", "empty", "plain"):
        blocks = drive((ref, port), items_of(rng, kind))
        assert canon(blocks[1]) == canon(blocks[0])
        h = blocks[1].header.height
        decided = [{v.name: v.engine.decided[h].payload.block_id for v in n.net.validators}
                   for n in (ref, port)]
        assert decided[1] == decided[0] and len(set(decided[1].values())) == 1
        assert ({v.name: v.finalized[h] for v in port.net.validators}
                == {v.name: v.finalized[h] for v in ref.net.validators})
        assert app_hashes(port.net) == {blocks[1].header.app_hash}
    assert port.net.equivocations == [] and ref.net.equivocations == []


def test_networks_without_a_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for cls in (port_network.ValidatorNetwork, port_bft_network.BFTNetwork):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(n_validators=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(n_validators=1, device="cuda:0")
    net = port_network.ValidatorNetwork(n_validators=1, device="cpu")
    assert net.validators[0].app.device.type == "cpu"
