"""The port's block extension (celestia_tpu_torch.da.dah) against the JAX
package and the Go-pinned DAH hashes, on the CPU: ``device="cpu"`` at the
dah entry points runs the host regime (the native library's legs), and
the plane on the CPU (``device_plane.extend_and_header(...,
device="cpu")``) the plain PyTorch path.  The bar is byte equality.
"""

import numpy as np
import pytest
import torch

from celestia_tpu.da import dah as jdah
from celestia_tpu.da import golden as jgolden
from celestia_tpu.ops import gf256 as jgf256
from _torch_common import sha_scan_unrolled_once
from _torch_common import codec_pair, torch_one_thread  # noqa: F401 (fixtures)
from celestia_tpu_torch.da import dah, device_plane, golden
from celestia_tpu_torch.ops import gf256


def _random_square(seed: int, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    # sorted version-0 namespaces, as a real square has
    ns = np.sort(rng.integers(0, 256, (k * k, 10), dtype=np.uint8).view("S10").ravel())
    sq.reshape(k * k, 512)[:, :19] = 0
    sq.reshape(k * k, 512)[:, 19:29] = np.frombuffer(ns.tobytes(), np.uint8).reshape(-1, 10)
    return sq


def _jax_program(k: int, codec: str, square: np.ndarray):
    """The JAX package's fused program ``_extend_and_roots_fn(k, codec)``,
    traced with SHA-256's round scans unrolled once (``_SCAN_UNROLL = 1``,
    not 8) and compiled at LLVM optimisation level 0: XLA's compile is
    almost all of a case's time, both shorten it, and the program's integer
    results are the same."""
    with sha_scan_unrolled_once():
        lowered = jdah._extend_and_roots_fn(k, codec).lower(square)
    return lowered.compile(compiler_options={"xla_backend_optimization_level": 0})


@pytest.mark.parametrize("codec_pair", gf256.CODECS, indirect=True)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_extend_and_header_matches_jax(codec_pair, k):
    sq = _random_square(k, k)
    eds_j, rows_j, cols_j, root_j = _jax_program(k, codec_pair, sq)(sq)
    # the plain path (the plane on the CPU), then the host regime
    for extend in (device_plane.extend_and_header, dah.extend_and_header):
        eds, hdr = extend(sq, device="cpu")
        np.testing.assert_array_equal(eds.shares, np.asarray(eds_j))
        assert hdr.row_roots == tuple(r.tobytes() for r in np.asarray(rows_j))
        assert hdr.col_roots == tuple(c.tobytes() for c in np.asarray(cols_j))
        assert hdr.hash == np.asarray(root_j).tobytes()
        hdr.validate_basic()


def test_golden_hashes_shared_with_jax():
    assert golden.MIN_DAH_HASH == jgolden.MIN_DAH_HASH
    assert golden.DAH_2X2_HASH == jgolden.DAH_2X2_HASH
    assert golden.DAH_128_HASH == jgolden.DAH_128_HASH
    np.testing.assert_array_equal(golden.fixture_shares(4), jgolden.fixture_shares(4))


def test_min_dah_hash():
    assert dah.min_data_availability_header(device="cpu").hash == golden.MIN_DAH_HASH


def test_dah_2x2_hash():
    eds = dah.extend_shares(golden.fixture_shares(4), device="cpu")
    assert dah.new_data_availability_header(eds, device="cpu").hash == golden.DAH_2X2_HASH
    _, hdr = dah.extend_and_header(golden.fixture_shares(4).reshape(2, 2, 512), device="cpu")
    assert hdr.hash == golden.DAH_2X2_HASH


def test_dah_128_hash_plain_path():
    square = golden.fixture_shares(128 * 128).reshape(128, 128, 512)
    _, hdr = device_plane.extend_and_header(square, device="cpu")
    assert hdr.hash == golden.DAH_128_HASH


def test_jax_eds_carried_into_the_port():
    sq = _random_square(99, 4)
    eds_j, hdr_j = jdah.extend_and_header(sq)
    eds = dah.ExtendedDataSquare(np.asarray(eds_j.shares))
    hdr = dah.new_data_availability_header(eds, device="cpu")
    assert hdr.hash == hdr_j.hash
    assert hdr.to_bytes() == hdr_j.to_bytes()
    assert dah.DataAvailabilityHeader.from_bytes(hdr_j.to_bytes()) == hdr
    assert jdah.DataAvailabilityHeader.from_bytes(hdr.to_bytes()).hash == hdr_j.hash
    np.testing.assert_array_equal(eds.flattened_original(), eds_j.flattened_original())
    for q in range(4):
        np.testing.assert_array_equal(eds.quadrant(q), eds_j.quadrant(q))


def test_extend_block_matches_jax():
    from celestia_tpu.da.square import build as jbuild
    from celestia_tpu_torch.da.square import build

    txs = [bytes([i]) * (300 + 37 * i) for i in range(40)]
    jsq, _, _ = jbuild(txs)
    sq, _, _ = build(txs)
    _, hdr_j = jdah.extend_block(jsq)
    eds, hdr = dah.extend_block(sq, device="cpu")
    assert (hdr.row_roots, hdr.col_roots, hdr.hash) == (
        hdr_j.row_roots, hdr_j.col_roots, hdr_j.hash
    )
    assert eds.square_size == jsq.size


def test_dah_wire_form_and_validation():
    _, hdr = dah.extend_and_header(_random_square(7, 2), device="cpu")
    assert dah.DataAvailabilityHeader.from_bytes(hdr.to_bytes()) == hdr
    with pytest.raises(ValueError):
        dah.DataAvailabilityHeader.from_bytes(hdr.to_bytes() + b"\x00")
    bad = dah.DataAvailabilityHeader(hdr.row_roots, hdr.col_roots, b"\x00" * 32)
    with pytest.raises(ValueError):
        bad.validate_basic()


def test_eds_rejects_bad_shapes():
    with pytest.raises(ValueError):
        dah.ExtendedDataSquare(np.zeros((3, 3, 512), dtype=np.uint8))
    with pytest.raises(ValueError):
        dah.ExtendedDataSquare(torch.zeros((2, 2, 512), dtype=torch.int32))


def test_entry_points_need_a_device_when_none_is_given():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    square = golden.fixture_shares(4).reshape(2, 2, 512)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dah.extend_and_header(square)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dah.min_data_availability_header()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dah.extend_shares(golden.fixture_shares(4))
