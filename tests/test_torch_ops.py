"""The port's ops (celestia_tpu_torch.ops) against the JAX package, on the CPU.

Inputs come from a numpy seed; the bar is byte equality.  On CPU tensors
the port's entry points run their plain PyTorch versions, so these tests
pin the plain twins that chip_smoke.py then holds the CUDA kernels to.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu.ops import nmt as jnmt
from celestia_tpu.ops import rs as jrs
from celestia_tpu.ops import sha256 as jsha
from _torch_common import codec_pair, torch_one_thread  # noqa: F401 (fixtures)
from celestia_tpu_torch.ops import gf256, nmt, rs
from celestia_tpu_torch.ops.sha256 import sha256, sha256_batch_host

# FIPS 180-4 vectors (the same as tests/test_golden_vectors.py)
SHA_VECTORS = [
    (b"", "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855"),
    (b"abc", "ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff61f20015ad"),
    (
        b"abcdbcdecdefdefgefghfghighijhijkijkljklmklmnlmnomnopnopq",
        "248d6a61d20638b8e5c026930c3e6039a33ce45964ff2167f6ecedd419db06c1",
    ),
    (
        b"abcdefghbcdefghicdefghijdefghijkefghijklfghijklmghijklmn"
        b"hijklmnoijklmnopjklmnopqklmnopqrlmnopqrsmnopqrstnopqrstu",
        "cf5b16a778af8380036ce59e7b0492370b249b11e8f07a51afac45037afee9d1",
    ),
]

# Leopard FF8 parity pinned as hex (tests/test_leopard_codec.py:204)
from test_leopard_codec import LEO_GOLDEN_PARITY  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint8, order="C"))  # own, writable copy


def _random_eds(seed: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    sq[..., :18] = 0  # version-0 style namespaces
    sq[-1, -1, :29] = 0xFF  # a parity-namespace cell inside Q0
    return np.asarray(jrs.extend_square(sq))


@pytest.mark.parametrize("L", [65, 91, 181, 542])
def test_sha256_matches_jax_and_hashlib(L):
    rng = np.random.default_rng(L)
    msgs = rng.integers(0, 256, (257, L), dtype=np.uint8)
    got = sha256(_t(msgs)).numpy()
    np.testing.assert_array_equal(got, jsha.sha256_np(msgs))
    np.testing.assert_array_equal(got, sha256_batch_host(msgs))
    for i in (0, 100, 256):
        assert got[i].tobytes() == hashlib.sha256(msgs[i].tobytes()).digest()


def test_sha256_fips_vectors():
    for msg, want in SHA_VECTORS:
        arr = np.frombuffer(msg, dtype=np.uint8).reshape(1, -1)
        assert sha256(_t(arr)).numpy()[0].tobytes().hex() == want, msg


def test_sha256_leading_dims():
    rng = np.random.default_rng(3)
    msgs = rng.integers(0, 256, (3, 5, 181), dtype=np.uint8)
    got = sha256(_t(msgs)).numpy()
    assert got.shape == (3, 5, 32)
    np.testing.assert_array_equal(got.reshape(15, 32), sha256_batch_host(msgs.reshape(15, 181)))


def _eds_and_leaves(k: int):
    eds = _random_eds(k, k)
    return eds, np.asarray(jnmt.eds_prefixed_leaves(jnp.asarray(eds)))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_nmt_leaves_match_jax(k):
    eds, leaves = _eds_and_leaves(k)
    np.testing.assert_array_equal(nmt.eds_prefixed_leaves(_t(eds)).numpy(), leaves)
    jdig = np.asarray(jax.jit(jnmt.leaf_digests)(leaves))
    np.testing.assert_array_equal(nmt.leaf_digests(_t(leaves)).numpy(), jdig)
    # the once-hashed grid is the row-tree leaf digests
    np.testing.assert_array_equal(nmt.eds_leaf_digests(_t(eds)).numpy(), jdig[0])


@pytest.mark.parametrize("k", [1, 2, 4])
def test_nmt_combine_level_matches_jax(k):
    eds, leaves = _eds_and_leaves(k)
    dig = nmt.leaf_digests(_t(leaves)).numpy()
    jlvl = np.asarray(jax.jit(jnmt.combine_level)(dig))
    np.testing.assert_array_equal(nmt.combine_level(_t(dig)).numpy(), jlvl)
    np.testing.assert_array_equal(
        nmt.combine_grid(_t(dig[0])).numpy(), jlvl.reshape(4 * k, k, 90)
    )


@pytest.mark.parametrize("k", [1, 2, 4])
def test_eds_nmt_roots_match_jax(k):
    eds, leaves = _eds_and_leaves(k)
    jroots = np.asarray(jax.jit(jnmt.eds_nmt_roots)(eds))
    np.testing.assert_array_equal(nmt.eds_nmt_roots(_t(eds)).numpy(), jroots)
    np.testing.assert_array_equal(nmt.eds_nmt_roots_plain(_t(eds)).numpy(), jroots)
    np.testing.assert_array_equal(nmt.nmt_roots(_t(leaves)).numpy(), jroots)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_rfc6962_root_matches_jax(k):
    flat = np.random.default_rng(k).integers(0, 256, (4 * k, 90), dtype=np.uint8)
    jroot = np.asarray(jax.jit(jnmt.rfc6962_root_pow2)(flat))
    got = nmt.rfc6962_root_pow2(_t(flat)).numpy()
    np.testing.assert_array_equal(got, jroot)
    assert got.tobytes() == jnmt.rfc6962_root_np(list(flat)).tobytes()


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_rfc6962_matches_host_reference(n):
    rng = np.random.default_rng(n + 11)
    leaves = rng.integers(0, 256, (n, 90), dtype=np.uint8)
    got = nmt.rfc6962_root_pow2(_t(leaves)).numpy().tobytes()
    assert got == nmt.rfc6962_root_np(list(leaves)).tobytes()
    assert got == jnmt.rfc6962_root_np(list(leaves)).tobytes()
    hashes = nmt.rfc6962_leaf_hashes(_t(leaves))
    assert nmt.rfc6962_tree(hashes).numpy().tobytes() == got


def test_host_helpers_match_jax():
    rng = np.random.default_rng(5)
    leaf = rng.integers(0, 256, 541, dtype=np.uint8).tobytes()
    assert nmt.leaf_digest_np(leaf) == jnmt.leaf_digest_np(leaf)
    a, b = (rng.integers(0, 256, 90, dtype=np.uint8).tobytes() for _ in range(2))
    parity_right = b"\xff" * 29 + b[29:]
    for left, right in ((a, b), (a, parity_right)):
        assert nmt.combine_digests_np(left, right) == jnmt.combine_digests_np(left, right)
    np.testing.assert_array_equal(nmt.empty_root_np(), jnmt.empty_root_np())


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_extend_square_matches_jax(codec_pair, k):
    rng = np.random.default_rng(20 + k)
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    got = rs.extend_square(_t(sq)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrs.extend_square(sq)))
    np.testing.assert_array_equal(got, rs.extend_square_ref(sq))


def test_extend_reproduces_leopard_golden_parity():
    for k, (data_hex, parity_hex) in LEO_GOLDEN_PARITY.items():
        data = np.frombuffer(bytes.fromhex(data_hex), dtype=np.uint8).reshape(k, -1)
        want = np.frombuffer(bytes.fromhex(parity_hex), dtype=np.uint8).reshape(k, -1)
        # a k x k square whose first row is the golden data: its row parity
        # (the first row of Q1) is the golden parity
        sq = np.zeros((k, k, data.shape[1]), dtype=np.uint8)
        sq[0] = data
        eds = rs.extend_plain(_t(sq), gf256.CODEC_LEOPARD).numpy()
        np.testing.assert_array_equal(eds[0, k:], want)
        np.testing.assert_array_equal(
            gf256.encode_shares_ref(data, codec=gf256.CODEC_LEOPARD), want
        )


@pytest.mark.parametrize("codec", gf256.CODECS)
def test_codec_constants_equal_jax(codec):
    for a, b in zip(gf256.field_tables(codec), jgf256.field_tables(codec)):
        np.testing.assert_array_equal(a, b)
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        np.testing.assert_array_equal(
            gf256.encode_matrix(k, codec), jgf256.encode_matrix(k, codec)
        )
        np.testing.assert_array_equal(
            gf256.encode_matrix_bits(k, codec), jgf256.encode_matrix_bits(k, codec)
        )


def test_kernel_wrappers_refuse_cpu_only_paths():
    # the kernel wrappers take CUDA tensors only: on a CPU tensor they raise
    # instead of falling back (the dispatching entry points pick the plain
    # version for CPU tensors themselves)
    from celestia_tpu_torch.ops.sha256 import sha256_cuda

    with pytest.raises(ValueError, match="CUDA"):
        sha256_cuda(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        rs.extend_cuda(torch.zeros((2, 2, 512), dtype=torch.uint8), gf256.CODEC_LEOPARD)


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_extend_squares_batched_matches_jax(codec_pair, k):
    rng = np.random.default_rng(40 + k)
    sq = rng.integers(0, 256, (3, k, k, 512), dtype=np.uint8)
    got = rs.extend_squares_batched(_t(sq)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrs.extend_squares_batched(sq)))
    for b in range(3):
        np.testing.assert_array_equal(got[b], rs.extend_square(_t(sq[b])).numpy())


def test_extend_squares_batched_validates_shape():
    with pytest.raises(ValueError, match="power of two"):
        rs.extend_squares_batched(torch.zeros((2, 3, 3, 16), dtype=torch.uint8))
    with pytest.raises(ValueError, match="power of two"):
        rs.extend_squares_batched(torch.zeros((2, 2, 16), dtype=torch.uint8))


@pytest.mark.parametrize("k", [1, 2])
def test_eds_nmt_roots_batched_matches_jax_vmap(k):
    """The catch-up roots (celestia_tpu/node/network.py:407): a batch of EDSs
    through the port against ``jax.vmap(eds_nmt_roots)``, compiled at LLVM
    optimisation level 0 (same bytes, seconds instead of tens)."""
    eds = np.stack([_random_eds(50 + i, k) for i in range(3)])
    run = jax.jit(jax.vmap(jnmt.eds_nmt_roots)).lower(eds).compile(
        compiler_options={"xla_backend_optimization_level": 0}
    )
    want = np.asarray(run(eds))
    got = nmt.eds_nmt_roots(_t(eds)).numpy()
    assert got.shape == (3, 2, 2 * k, 90)
    np.testing.assert_array_equal(got, want)
    for b in range(3):
        np.testing.assert_array_equal(got[b], nmt.eds_nmt_roots(_t(eds[b])).numpy())


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
def test_catch_up_data_roots_match_jax(codec_pair):
    """dah.data_roots_batched (K5b, batched K2/K3, one K4 launch for the batch)
    against the JAX DAH of each block."""
    from celestia_tpu.da import dah as jdah
    from celestia_tpu_torch.da import dah

    rng = np.random.default_rng(60)
    sq = rng.integers(0, 256, (3, 4, 4, 512), dtype=np.uint8)
    sq[..., :29] = 0
    roots, data_roots = dah.data_roots_batched(sq, device="cpu")
    assert roots.shape == (3, 2, 8, 90)
    for b in range(3):
        _, want = jdah.extend_and_header(sq[b])
        assert data_roots[b] == want.hash
        assert [r.tobytes() for r in roots[b, 0]] == list(want.row_roots)
        assert [c.tobytes() for c in roots[b, 1]] == list(want.col_roots)
