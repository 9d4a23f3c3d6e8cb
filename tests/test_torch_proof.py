"""The port's share, tx and namespace proofs (celestia_tpu_torch.da.proof,
da.namespace_data) against the JAX package's, on one seeded k = 8 block
built by both packages' ``square.build``: every ``to_dict()`` equal, every
proof verifying.  The block holds a namespace that spans 6 rows, so the
JAX package's ``get_shares_by_namespace`` takes both its host leg (4 rows
or fewer) and its device leg; the port takes its one leg (K1 + K3 over the
rows, K7b gather) for both.

The JAX package's proofs run its ``nmt_level_stack`` eagerly, 9-19 s a
call on a CPU.  Here the same function runs under ``jax.jit``, compiled
once per shape at LLVM optimisation level 0 (the integer results are the
same; only the compile is shorter), and the block's ranges touch 1, 2, 6
or 8 rows so that few shapes are compiled.
"""

import jax
import numpy as np
import pytest

from celestia_tpu.da import blob as jblob
from celestia_tpu.da import dah as jdah
from celestia_tpu.da import namespace_data as jnsd
from celestia_tpu.da import proof as jproof
from celestia_tpu.da import square as jsquare
from celestia_tpu.da.namespace import Namespace as JNamespace
from celestia_tpu.ops import nmt as jnmt
from _torch_common import pinned_codec, torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch.da import blob, dah, das, eds_cache, namespace_data, proof, square
from celestia_tpu_torch.da.namespace import Namespace
from celestia_tpu_torch.ops import gf256

# blob namespace ids and sizes: 19,000 B spans 6 rows of a k = 8 square
SPECS = [(b"\x01" + bytes([10 * i + 1]) * 9, n) for i, n in enumerate([300, 19000, 1200, 700, 2500])]
ABSENT = b"\x01" + bytes([5]) * 9  # between the first two: a row root covers it


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_level_stack():
    """JAX ``nmt_level_stack`` under ``jax.jit`` for the JAX proofs (see
    the module docstring), restored afterwards."""
    eager = jnmt.nmt_level_stack
    compiled = {}

    def run(leaves):
        key = tuple(leaves.shape)
        if key not in compiled:
            compiled[key] = jax.jit(eager).lower(leaves).compile(
                compiler_options={"xla_backend_optimization_level": 0}
            )
        return compiled[key](leaves)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnmt, "nmt_level_stack", run)
        yield


@pytest.fixture(scope="module", params=gf256.CODECS)
def blocks(request):
    """The block built and extended by both packages under each codec."""
    rng = np.random.default_rng(7)
    data = [rng.bytes(n) for _, n in SPECS]
    plain = [b"plain-tx-%d" % i * 20 for i in range(3)]
    ours, theirs = list(plain), list(plain)
    for i, ((ns, _), d) in enumerate(zip(SPECS, data)):
        inner = b"inner%d" % i * 30
        ours.append(blob.BlobTx(inner, (blob.Blob(Namespace.v0(ns), d),)).marshal())
        theirs.append(jblob.BlobTx(inner, (jblob.Blob(JNamespace.v0(ns), d),)).marshal())
    sq, block_txs, wrappers = square.build(ours, max_square_size=8)
    jsq, jblock_txs, jwrappers = jsquare.build(theirs, max_square_size=8)
    assert sq.size == jsq.size == 8 and block_txs == jblock_txs
    with pinned_codec(request.param):
        eds, hdr = dah.extend_block(sq, device="cpu")
        jeds, jhdr = jdah.extend_block(jsq)
    assert hdr.hash == jhdr.hash
    normal = [t for t in block_txs if t in plain]
    wrapped = [w.marshal() for w in wrappers]
    assert wrapped == [w.marshal() for w in jwrappers] and len(normal) == len(plain)
    yield (sq, eds, hdr, normal, wrapped), (jsq, jeds, jhdr)
    eds_cache.clear()


@pytest.mark.parametrize("start,end", [(0, 1), (0, 3), (5, 6), (7, 9), (6, 46), (0, 64)])
def test_share_inclusion_proof_matches_jax(blocks, start, end):
    (_, eds, hdr, _, _), (_, jeds, jhdr) = blocks
    got = proof.new_share_inclusion_proof(eds, hdr, start, end)
    want = jproof.new_share_inclusion_proof(jeds, jhdr, start, end)
    assert got.to_dict() == want.to_dict()
    assert got.verify(hdr.hash)
    assert proof.ShareInclusionProof.from_dict(got.to_dict()) == got


def test_share_inclusion_proof_rejects_bad_ranges(blocks):
    (_, eds, hdr, _, _), _ = blocks
    for start, end in [(3, 3), (-1, 2), (0, 65)]:
        with pytest.raises(ValueError):
            proof.new_share_inclusion_proof(eds, hdr, start, end)


def test_tampered_share_proof_fails(blocks):
    (_, eds, hdr, _, _), _ = blocks
    p = proof.new_share_inclusion_proof(eds, hdr, 6, 12)
    shares = (b"\x00" * 512,) + p.shares[1:]
    bad = proof.ShareInclusionProof(
        p.start, p.end, p.square_size, p.namespace, shares, p.row_proofs, p.row_roots
    )
    assert not bad.verify(hdr.hash)
    assert not p.verify(b"\x00" * 32)


@pytest.mark.parametrize("i", range(3 + len(SPECS)))
def test_tx_inclusion_proof_matches_jax(blocks, i):
    (sq, eds, hdr, normal, wrapped), (jsq, jeds, jhdr) = blocks
    assert proof.tx_share_range(normal, wrapped, i) == jproof.tx_share_range(normal, wrapped, i)
    got = proof.new_tx_inclusion_proof(sq, eds, hdr, normal, wrapped, i)
    want = jproof.new_tx_inclusion_proof(jsq, jeds, jhdr, normal, wrapped, i)
    assert got.to_dict() == want.to_dict()
    assert got.verify(hdr.hash)


def test_tx_share_range_rejects_an_index_past_the_block(blocks):
    (_, _, _, normal, wrapped), _ = blocks
    with pytest.raises(IndexError):
        proof.tx_share_range(normal, wrapped, len(normal) + len(wrapped))


@pytest.mark.parametrize("n", [1, 7, 16, 512])
def test_merkle_tree_and_proofs_match_jax(n):
    rng = np.random.default_rng(n)
    leaves = [rng.bytes(90) for _ in range(n)]
    got = proof.merkle_level_tree(leaves) if n & (n - 1) == 0 else None
    if got is not None:
        want = jproof.merkle_level_tree(leaves)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    root = bytes(jproof.nmt_ops.rfc6962_root_np(leaves))
    for i in sorted({0, n // 3, n - 1}):
        p = proof.merkle_proof(leaves, i)
        assert p == proof.MerkleProof(**vars(jproof.merkle_proof(leaves, i)))
        assert p.verify(root, leaves[i])
        assert not p.verify(root, b"wrong")
        if got is not None:
            assert proof.merkle_proof_from_levels(got, i) == p


@pytest.mark.parametrize("ns", [ns for ns, _ in SPECS] + [ABSENT])
def test_namespace_data_matches_jax(blocks, ns):
    (_, eds, hdr, _, _), (_, jeds, jhdr) = blocks
    raw = Namespace.v0(ns).raw
    got = namespace_data.get_shares_by_namespace(eds, hdr, raw)
    want = jnsd.get_shares_by_namespace(jeds, jhdr, raw)
    assert got.to_dict() == want.to_dict()
    assert got.verify(hdr)
    assert namespace_data.NamespaceData.from_dict(got.to_dict()) == got
    if ns == ABSENT:
        assert got.rows and not got.blobs_payload()
    if ns == SPECS[1][0]:
        assert len(got.rows) > 4  # wider than the JAX package's host leg


def test_namespace_data_from_the_device_leg_matches_the_host_leg(blocks):
    """Every namespace's proofs (K1 + K3 over the covered rows and one K7b
    gather, here their plain twins) against proofs read off each row's
    host level stack (hashlib)."""
    (_, eds, hdr, _, _), _ = blocks
    k = eds.square_size
    for ns in [ns for ns, _ in SPECS] + [ABSENT]:
        got = namespace_data.get_shares_by_namespace(eds, hdr, Namespace.v0(ns).raw)
        host = [
            proof.nmt_range_proof_from_levels(
                das._host_level_stack(das._leaves_of_row(eds.row(r.row), r.row, k)),
                r.start, r.end,
            )
            for r in got.rows
        ]
        assert [r.proof for r in got.rows] == host


def test_share_proof_is_the_same_without_the_block_entry(blocks):
    """Root aunts from the cached entry's root tree, and from the tree
    rebuilt over the DAH's roots once the entry is gone."""
    (_, eds, hdr, _, _), _ = blocks
    entry = eds_cache.get_device_entry(hdr.hash, "cpu")
    assert entry is not None
    with_entry = proof.new_share_inclusion_proof(eds, hdr, 6, 46)
    assert eds_cache.drop_device_entry(hdr.hash)
    try:
        without = proof.new_share_inclusion_proof(eds, hdr, 6, 46)
    finally:
        eds_cache.put_device_entry(hdr.hash, entry)
    assert without == with_entry and without.verify(hdr.hash)


def test_namespace_data_rejects_the_parity_namespace(blocks):
    (_, eds, hdr, _, _), _ = blocks
    with pytest.raises(ValueError):
        namespace_data.get_shares_by_namespace(eds, hdr, b"\xff" * 29)
    with pytest.raises(ValueError):
        namespace_data.get_shares_by_namespace(eds, hdr, b"\x00" * 28)
