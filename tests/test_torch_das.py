"""The port's DAS light client and prover (celestia_tpu_torch.da.das)
against the JAX package's, on the CPU: the same seeded coordinates, the
same proof bytes (from the device-plane gather and from the host prover),
every sample verified, the wire form round-tripping across both packages,
and tampered proofs failing.
"""

import dataclasses

import numpy as np
import pytest

from celestia_tpu.da import dah as jdah
from celestia_tpu.da import das as jdas
from _torch_common import pinned_codec, torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch.da import dah, das, eds_cache
from celestia_tpu_torch.ops import gf256

K = 4


@pytest.fixture(scope="module", params=gf256.CODECS)
def block(request):
    """One seeded k = 4 block extended through the port's plane (CPU) under
    each codec, and the same EDS and DAH as the JAX package's types."""
    rng = np.random.default_rng(2024)
    sq = rng.integers(0, 256, (K, K, 512), dtype=np.uint8)
    sq[..., :29] = 0
    sq[..., 28] = np.sort(rng.integers(1, 200, K * K)).reshape(K, K)
    with pinned_codec(request.param):
        eds, hdr = dah.extend_and_header(sq, device="cpu")
    jeds = jdah.ExtendedDataSquare(eds.shares.copy())
    jhdr = jdah.DataAvailabilityHeader(hdr.row_roots, hdr.col_roots, hdr.hash)
    yield eds, hdr, jeds, jhdr
    eds_cache.clear()


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_light_client_matches_jax(block, seed):
    eds, hdr, jeds, jhdr = block
    assert eds_cache.get_device_entry(hdr.hash, "cpu") is not None
    client = das.LightClient(hdr.hash, K, seed=seed)
    jclient = jdas.LightClient(jhdr.hash, K, seed=seed)
    served = []

    def fetch_batch(coords):
        proofs = das.sample_proofs_batch(eds, hdr, coords)
        served.extend(proofs)
        return proofs

    calls = das.host_prover_calls()
    res = client.sample(fetch_batch=fetch_batch, n_samples=16)
    assert das.host_prover_calls() == calls  # the gather served it
    jres = jclient.sample(
        fetch_batch=lambda cs: jdas.sample_proofs_batch(jeds, jhdr, cs), n_samples=16
    )
    assert res.coordinates == jres.coordinates
    assert res.available and res.verified == 16 == jres.verified
    assert res.confidence == jres.confidence
    for p in served:
        assert p.to_dict() == jdas._sample_proof_uncached(jeds, jhdr, p.row, p.col).to_dict()
        assert das.SampleProof.from_dict(p.to_dict()) == p
        assert jdas.SampleProof.from_dict(p.to_dict()).verify(jhdr.hash)


def test_single_sample_and_host_prover_match(block):
    eds, hdr, jeds, jhdr = block
    warm = das.sample_proof(eds, hdr, 7, 0)
    assert warm == das._sample_proof_uncached(eds, hdr, 7, 0)
    assert warm.to_dict() == jdas.sample_proof(jeds, jhdr, 7, 0).to_dict()
    with pytest.raises(ValueError):
        das.sample_proofs_batch(eds, hdr, [(0, 2 * K)])
    assert das.sample_proofs_batch(eds, hdr, []) == []


def _tampered(p: das.SampleProof, what: str) -> das.SampleProof:
    if what == "share":
        share = bytes([p.share[0] ^ 1]) + p.share[1:]
        return dataclasses.replace(p, share=share)
    if what == "node":
        nodes = list(p.nmt_proof.nodes)
        nodes[0] = nodes[0][:-1] + bytes([nodes[0][-1] ^ 1])
        return dataclasses.replace(
            p, nmt_proof=dataclasses.replace(p.nmt_proof, nodes=tuple(nodes))
        )
    aunts = list(p.root_proof.aunts)
    aunts[-1] = bytes(32)
    return dataclasses.replace(p, root_proof=dataclasses.replace(p.root_proof, aunts=tuple(aunts)))


@pytest.mark.parametrize("what", ["share", "node", "aunt"])
def test_tampered_proofs_fail(block, what):
    eds, hdr, _, _ = block
    client = das.LightClient(hdr.hash, K, seed=5)

    def fetch_batch(coords):
        proofs = das.sample_proofs_batch(eds, hdr, coords)
        proofs[3] = _tampered(proofs[3], what)
        return proofs

    res = client.sample(fetch_batch=fetch_batch, n_samples=8)
    assert res.verified == 7 and not res.available
    assert [f[2] for f in res.failed] == ["proof does not verify"]
    assert res.failed[0][:2] == res.coordinates[3]


def test_withheld_and_misplaced_samples_count_as_failures(block):
    eds, hdr, _, _ = block
    client = das.LightClient(hdr.hash, K, seed=9)

    def fetch_batch(coords):
        proofs = das.sample_proofs_batch(eds, hdr, coords)
        proofs[1] = proofs[0]  # a proof for another cell
        return proofs[:-1]  # the last one withheld

    res = client.sample(fetch_batch=fetch_batch, n_samples=6)
    assert [f[2] for f in res.failed] == ["proof for the wrong coordinate", "not served"]
    assert res.verified == 4
    with pytest.raises(ValueError):
        client.sample(n_samples=1)
