"""The port's bad-encoding fraud proofs (celestia_tpu_torch.da.fraud)
against the JAX package's, on the CPU.

The cases of tests/test_fraud.py (K = 8) run through both packages on the
same corrupted squares: detection gives the same (axis, index), the BEFPs'
wire form (``to_dict``) is byte-equal, ``verify`` gives the same verdicts,
and each package verifies the other's proofs through ``from_dict``.
"""

import numpy as np
import pytest

from celestia_tpu.da import dah as jdah
from celestia_tpu.da import fraud as jfraud
from celestia_tpu.da.dah import ExtendedDataSquare as JExtendedDataSquare
from _torch_common import torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch.da import dah, fraud

K = 8


def _port_dah(j: jdah.DataAvailabilityHeader) -> dah.DataAvailabilityHeader:
    return dah.DataAvailabilityHeader(tuple(j.row_roots), tuple(j.col_roots), j.hash)


@pytest.fixture(scope="module")
def honest_block():
    rng = np.random.default_rng(23)
    square = rng.integers(0, 256, (K, K, 512), dtype=np.uint8)
    square[:, :, :29] = 0
    square[:, :, 28] = np.sort(rng.integers(1, 200, (K, K), dtype=np.uint8), axis=1)
    eds, jd = jdah.extend_and_header(square)
    shares = np.asarray(eds.shares)
    _, pd = dah.extend_and_header(square, device="cpu")
    assert pd.hash == jd.hash
    return shares, jd


def _corrupt(eds_shares, row, col):
    """Flip one committed cell and recommit the DAH over the corrupted
    square (tests/test_fraud.py:31-38); both packages' DAHs."""
    bad = np.array(eds_shares, copy=True)
    bad[row, col, 100] ^= 0x5A
    jd = jdah.new_data_availability_header(JExtendedDataSquare(bad))
    pd = dah.new_data_availability_header(dah.ExtendedDataSquare(bad), device="cpu")
    assert pd.to_bytes() == jd.to_bytes()
    return bad, jd


def _both(bad, axis, idx, **kwargs):
    """(JAX BEFP, port BEFP) of the same axis, after checking their wire
    forms are byte-equal."""
    jb = jfraud.build_befp(bad, axis, idx, **kwargs)
    pb = fraud.build_befp(bad, axis, idx, device="cpu", **kwargs)
    assert pb.to_dict() == jb.to_dict()
    return jb, pb


def test_honest_square_yields_no_fraud(honest_block):
    shares, jd = honest_block
    assert fraud.detect_bad_encoding(shares, device="cpu") is None
    assert jfraud.detect_bad_encoding(shares) is None
    jb, pb = _both(shares, fraud.AXIS_ROW, 3)
    assert not pb.verify(_port_dah(jd)) and not jb.verify(jd)


@pytest.mark.parametrize(
    "cell, axis_idx",
    [
        ((2, K + 2), (fraud.AXIS_ROW, 2)),  # Q1 parity cell
        ((1, 3), (fraud.AXIS_ROW, 1)),  # original-data cell
        ((K + 1, 4), None),  # parity row, Q0 column
        ((0, 1), None),
    ],
)
def test_corruption_detected_and_proven_like_jax(honest_block, cell, axis_idx):
    shares, jd = honest_block
    bad, bad_jd = _corrupt(shares, *cell)
    found = fraud.detect_bad_encoding(bad, device="cpu")
    assert found == jfraud.detect_bad_encoding(bad)
    assert found is not None
    if axis_idx is not None:
        assert found == axis_idx
    jb, pb = _both(bad, *found)
    assert pb.verify(_port_dah(bad_jd)) and jb.verify(bad_jd)
    # the proof does NOT verify against the honest block's DAH
    assert not pb.verify(_port_dah(jd)) and not jb.verify(jd)


def test_befp_from_parity_positions_like_jax(honest_block):
    """Any k positions prove the fraud — including all-parity cells."""
    shares, _ = honest_block
    bad, bad_jd = _corrupt(shares, 2, 5)
    jb, pb = _both(bad, fraud.AXIS_ROW, 2, positions=tuple(range(K, 2 * K)))
    assert pb.verify(_port_dah(bad_jd)) and jb.verify(bad_jd)


def test_column_befp_like_jax(honest_block):
    """A column axis: the orthogonal trees are rows (no transpose)."""
    shares, _ = honest_block
    bad, bad_jd = _corrupt(shares, K + 3, 6)
    jb, pb = _both(bad, fraud.AXIS_COL, 6)
    assert pb.verify(_port_dah(bad_jd)) == jb.verify(bad_jd) is True
    jb, pb = _both(bad, fraud.AXIS_COL, 2, positions=(1, 3, 5, 7, 9, 11, 13, 15))
    assert pb.verify(_port_dah(bad_jd)) == jb.verify(bad_jd) is False


def test_befp_wire_round_trip_across_packages(honest_block):
    shares, _ = honest_block
    bad, bad_jd = _corrupt(shares, 0, 1)
    found = fraud.detect_bad_encoding(bad, device="cpu")
    jb, pb = _both(bad, *found)
    back = fraud.BadEncodingProof.from_dict(pb.to_dict())
    assert back == pb and back.verify(_port_dah(bad_jd))
    # the JAX proof verifies in the port, the port's in JAX
    assert fraud.BadEncodingProof.from_dict(jb.to_dict()).verify(_port_dah(bad_jd))
    assert jfraud.BadEncodingProof.from_dict(pb.to_dict()).verify(bad_jd)


def test_tampered_befp_rejected_like_jax(honest_block):
    """A forged BEFP (wrong shares) cannot frame an honest block."""
    shares, jd = honest_block
    jb, pb = _both(shares, fraud.AXIS_ROW, 3)
    forged = fraud.BadEncodingProof(
        pb.axis, pb.index, pb.square_size, pb.positions,
        (b"\x00" * 512,) + pb.shares[1:], pb.proofs,
    )
    jforged = jfraud.BadEncodingProof.from_dict(forged.to_dict())
    assert not forged.verify(_port_dah(jd)) and not jforged.verify(jd)
    # malformed proofs are refused the same way
    for bad_dict in (
        {**pb.to_dict(), "axis": "diag"},
        {**pb.to_dict(), "index": 2 * K},
        {**pb.to_dict(), "positions": [0] * K},
    ):
        assert fraud.BadEncodingProof.from_dict(bad_dict).verify(_port_dah(jd)) is False
        assert jfraud.BadEncodingProof.from_dict(bad_dict).verify(jd) is False


def test_detect_accepts_a_tensor_and_an_eds(honest_block):
    import torch

    shares, _ = honest_block
    bad, _ = _corrupt(shares, 2, K + 2)
    want = jfraud.detect_bad_encoding(bad)
    assert fraud.detect_bad_encoding(torch.from_numpy(bad)) == want
    assert fraud.detect_bad_encoding(dah.ExtendedDataSquare(bad)) == want
