"""The port's erasure repair (celestia_tpu_torch.ops.rs) against the JAX
package's, on the CPU, byte for byte.

The same seeded partial squares go through JAX ``rs.repair_square_device``
/ ``rs.repair_square`` and the port's ``repair_square_device(...,
device="cpu")`` / ``repair_square``: repaired squares must be equal (0
bytes of tolerance), and the byzantine and insufficient cases must raise
the same exception type with the same message.  On CPU tensors the port's
``repair_square_device`` runs the plain versions of K8a/K8b/K8c, which
keep the JAX GF(2) lift; they are also held against the JAX helpers
directly.  ``repair_square`` is the JAX host repair on the native library
in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.ops import nmt as jnmt
from celestia_tpu.ops import rs as jrs
from _torch_common import codec_pair, torch_one_thread  # noqa: F401 (fixtures)
from celestia_tpu_torch.ops import gf256, rs

CODECS = gf256.CODECS

# A committed deep-peel mask at k = 8 (rows of the 16 x 16 availability
# mask, "1" = available): only k^2 = 64 cells, and a chain in which every
# solved axis brings exactly one orthogonal axis to k available cells, so
# the peeling schedule takes P = 8 phases.  Chain rows/columns 0..7: row i
# lacks columns i-1 and i; row i also holds column 8+i; column j < 7 also
# holds row 8+j; the rest is withheld.  The JAX package repairs masks of
# P > 4 on the host (ops/rs.py:399-404); the port stays on its path.
DEEP_PEEL_K8 = (
    "0111111110000000", "0011111101000000", "1001111100100000", "1100111100010000",
    "1110011100001000", "1111001100000100", "1111100100000010", "1111110000000001",
    "1000000000000000", "0100000000000000", "0010000000000000", "0001000000000000",
    "0000100000000000", "0000010000000000", "0000001000000000", "0000000000000000",
)


def _deep_peel_mask() -> np.ndarray:
    return np.array([[c == "1" for c in row] for row in DEEP_PEEL_K8], dtype=bool)


def _eds(seed: int, k: int, B: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    square = rng.integers(0, 256, (k, k, B), dtype=np.uint8)
    return np.asarray(jrs.extend_square(square))


def _raised(fn, *args, **kwargs):
    """(exception class name, message) of what ``fn`` raises."""
    with pytest.raises(ValueError) as info:
        fn(*args, **kwargs)
    return type(info.value).__name__, str(info.value)


def _port(eds, avail, **kwargs):
    return rs.repair_square_device(eds, avail, device="cpu", **kwargs)


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
@pytest.mark.parametrize("k", [2, 4, 8])
def test_repair_withheld_rows_and_cols_matches_jax(codec_pair, k):
    rng = np.random.default_rng(k * 13)
    eds = _eds(k * 13, k, 32)
    avail = np.ones((2 * k, 2 * k), dtype=bool)
    avail[rng.choice(2 * k, k, replace=False), :] = False
    avail[:, rng.choice(2 * k, k, replace=False)] = False
    corrupted = eds.copy()
    corrupted[~avail] = 0x55
    got = _port(corrupted, avail)
    np.testing.assert_array_equal(got, eds)
    np.testing.assert_array_equal(got, np.asarray(jrs.repair_square_device(corrupted, avail)))
    np.testing.assert_array_equal(rs.repair_square(corrupted, avail), jrs.repair_square(corrupted, avail))
    # the caller's array is not written
    assert (corrupted[~avail] == 0x55).all()


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_repair_random_cells_with_roots_matches_jax(codec_pair):
    rng = np.random.default_rng(31)
    k = 4
    eds = _eds(31, k, 512)
    roots = np.asarray(jnmt.eds_nmt_roots_host(eds))  # the JAX package's host roots
    avail = rng.random((2 * k, 2 * k)) < 0.7
    for r in range(2 * k):
        if avail[r].sum() < k:
            avail[r, rng.choice(2 * k, k, replace=False)] = True
    got = _port(eds.copy(), avail, row_roots=roots[0], col_roots=roots[1])
    want = jrs.repair_square_device(eds.copy(), avail, row_roots=roots[0], col_roots=roots[1])
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, eds)
    np.testing.assert_array_equal(
        rs.repair_square(eds.copy(), avail, roots[0], roots[1]),
        jrs.repair_square(eds.copy(), avail, roots[0], roots[1]),
    )


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_repair_inconsistent_coding_raises_like_jax(codec_pair):
    k = 4
    eds = _eds(33, k, 16)
    avail = np.ones((2 * k, 2 * k), dtype=bool)
    avail[0, :k] = False
    bad = eds.copy()
    bad[0, k] ^= 1  # a provided Q1 cell off the codeword
    want = _raised(jrs.repair_square_device, bad, avail)
    assert want[0] == "ByzantineError" and "inconsistent erasure coding" in want[1]
    assert _raised(_port, bad, avail) == want
    assert _raised(rs.repair_square, bad, avail) == _raised(jrs.repair_square, bad, avail) == want


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_repair_wrong_roots_raise_like_jax(codec_pair):
    k = 2
    eds = _eds(34, k, 512)
    avail = np.ones((2 * k, 2 * k), dtype=bool)
    avail[1, 0] = False
    fake = np.zeros((2 * k, 90), dtype=np.uint8)
    want = _raised(jrs.repair_square_device, eds.copy(), avail, row_roots=fake)
    assert want[0] == "ByzantineError" and "committed NMT roots" in want[1]
    assert _raised(_port, eds.copy(), avail, row_roots=fake) == want
    assert _raised(rs.repair_square, eds.copy(), avail, fake) == want
    assert _raised(jrs.repair_square, eds.copy(), avail, fake) == want


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_repair_insufficient_raises_like_jax(codec_pair):
    k = 2
    eds = np.asarray(jrs.extend_square(np.zeros((k, k, 8), dtype=np.uint8)))
    avail = np.zeros((2 * k, 2 * k), dtype=bool)
    avail[0, 0] = True
    want = _raised(jrs.repair_square_device, eds, avail)
    assert want == ("ValueError", "repair stalled: insufficient available cells to reconstruct")
    assert _raised(_port, eds, avail) == want
    assert _raised(rs.repair_square, eds, avail) == _raised(jrs.repair_square, eds, avail) == want


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_repair_provided_share_mismatch_raises_like_jax(codec_pair):
    """A provided cell that the decode overwrites: the codeword is intact,
    only the provided-share comparison catches it (tests/test_rs.py:295)."""
    k = 4
    eds = _eds(41, k, 16)
    avail = np.ones((2 * k, 2 * k), dtype=bool)
    avail[0, : k - 1] = False
    bad = eds.copy()
    bad[0, 2 * k - 1] ^= 0x04
    want = _raised(jrs.repair_square_device, bad, avail, return_device=True)
    assert want[0] == "ByzantineError" and "provided shares disagree" in want[1]
    assert _raised(_port, bad, avail, return_device=True) == want
    # the host entries (the port's and JAX's: the same native legs) report
    # the same as each other.  Under lagrange-gf256 that is the device
    # path's verdict; under leopard-ff8 the native Leopard decoder writes
    # only erased cells and the flip shows as inconsistent coding instead
    jax_host = _raised(jrs.repair_square, bad, avail)
    assert _raised(rs.repair_square, bad, avail) == jax_host
    if codec_pair == gf256.CODEC_LAGRANGE:
        assert jax_host == want
    else:
        assert jax_host[0] == "ByzantineError" and "inconsistent erasure coding" in jax_host[1]
    # a clean input round-trips and stays a tensor
    out = _port(eds.copy(), avail, return_device=True)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), eds)


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_repair_nothing_missing(codec_pair):
    eds = _eds(35, 2, 8)
    avail = np.ones((4, 4), dtype=bool)
    bd = {}
    got = _port(eds, avail, breakdown=bd)
    np.testing.assert_array_equal(got, eds)
    np.testing.assert_array_equal(got, np.asarray(jrs.repair_square_device(eds, avail)))
    assert {"schedule_ms", "upload_compute_ms", "verdict_fetch_ms", "upload_overlapped",
            "bulk_fetch_ms"} <= set(bd)


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_repair_return_device_from_a_tensor(codec_pair):
    k = 4
    eds = _eds(43, k, 512)
    rng = np.random.default_rng(43)
    avail = rng.random((2 * k, 2 * k)) >= 0.25
    damaged = torch.from_numpy(eds.copy())
    damaged[torch.from_numpy(~avail)] = 0
    before = damaged.clone()
    out = rs.repair_square_device(damaged, avail, return_device=True)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), eds)
    assert torch.equal(damaged, before)  # the input tensor is left as it was
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jrs.repair_square_device(damaged.numpy(), avail))
    )


def test_repair_square_refuses_a_tensor_off_the_host():
    """The host entry never copies a device tensor back to repair it."""
    k = 2
    avail = np.ones((2 * k, 2 * k), dtype=bool)
    before = rs.plain_repairs()
    with pytest.raises(ValueError, match="repairs on the host"):
        rs.repair_square(torch.empty((2 * k, 2 * k, 32), dtype=torch.uint8, device="meta"), avail)
    assert rs.plain_repairs() == before
    eds = _eds(53, k, 32)
    np.testing.assert_array_equal(rs.repair_square(torch.from_numpy(eds.copy()), avail), eds)


@pytest.mark.parametrize("codec_pair", CODECS, indirect=True)
def test_repair_deep_peel_stays_on_its_path(codec_pair, monkeypatch):
    k = 8
    avail = _deep_peel_mask()
    schedule = rs._simulate_schedule(avail, k)
    P = schedule[0].shape[0]
    assert P == 8 > jrs._MAX_DEVICE_PHASES
    for a, b in zip(schedule, jrs._simulate_schedule(avail, k)):
        np.testing.assert_array_equal(a, b)
    eds = _eds(47, k, 32)
    corrupted = eds.copy()
    corrupted[~avail] = 0xA5
    calls = []
    real = rs.decode_axes
    monkeypatch.setattr(rs, "decode_axes", lambda *a: calls.append(a[4]) or real(*a))
    before = rs.plain_repairs()
    got = _port(corrupted, avail)
    np.testing.assert_array_equal(got, eds)
    np.testing.assert_array_equal(got, np.asarray(jrs.repair_square_device(corrupted, avail)))
    np.testing.assert_array_equal(got, jrs.repair_square(corrupted, avail))
    # one decode per (phase, orientation) with solvable axes, in order
    want = [cols for p in range(P) for cols, m in ((False, schedule[1][p]), (True, schedule[3][p]))
            if m.any()]
    assert calls == want and len(calls) >= P
    assert rs.plain_repairs() == before + 1


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_decode_matrices_plain_matches_jax(codec, k):
    rng = np.random.default_rng(500 + k)
    known = np.stack([rng.permutation(2 * k)[:k] for _ in range(7)]).astype(np.uint8)
    got = rs._decode_matrices_dev(torch.from_numpy(known), k, codec).numpy()
    want = np.asarray(jrs._decode_matrices_dev(jnp.asarray(known), k, codec))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gf256.decode_matrices_batch(known, k, codec))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("k", [2, 4, 8])
def test_decode_axes_plain_matches_jax(codec, k):
    """K8b's plain version against JAX ``_decode_axes_dev``: over every axis
    (JAX decodes all 2k), and over a subset of axes in both orientations
    (the decoded axes are JAX's, the others untouched)."""
    rng = np.random.default_rng(600 + k)
    data = rng.integers(0, 256, (2 * k, 2 * k, 24), dtype=np.uint8)
    known = np.stack([np.sort(rng.permutation(2 * k)[:k]) for _ in range(2 * k)]).astype(np.uint8)
    chunk = max(1, k // 2)
    want = np.asarray(jrs._decode_axes_dev(jnp.asarray(data), jnp.asarray(known), k, chunk, codec))
    D = rs._decode_matrices_dev(torch.from_numpy(known), k, codec)
    every = torch.arange(2 * k, dtype=torch.int32)
    got = rs.decode_axes_plain(torch.from_numpy(data.copy()), D, torch.from_numpy(known), every,
                               False, codec)
    np.testing.assert_array_equal(got.numpy(), want)
    axes = np.sort(rng.permutation(2 * k)[:k]).astype(np.int32)
    for cols in (False, True):
        src = data.transpose(1, 0, 2) if cols else data
        want_all = np.asarray(jrs._decode_axes_dev(jnp.asarray(np.ascontiguousarray(src)),
                                                   jnp.asarray(known), k, chunk, codec))
        out = rs.decode_axes_plain(torch.from_numpy(data.copy()), D[axes],
                                   torch.from_numpy(known[axes]), torch.from_numpy(axes),
                                   cols, codec).numpy()
        view = out.transpose(1, 0, 2) if cols else out
        mask = np.zeros(2 * k, dtype=bool)
        mask[axes] = True
        np.testing.assert_array_equal(view[mask], want_all[mask])
        np.testing.assert_array_equal(view[~mask], src[~mask])


def test_repair_verdicts_plain():
    rng = np.random.default_rng(7)
    rep = rng.integers(0, 4, (4, 4, 16), dtype=np.uint8)
    rec, prov = rep.copy(), rep.copy()
    rec[0, 1, 5] ^= 1
    prov[2, 3, 15] ^= 1
    prov[1, 1, 0] ^= 1
    avail = np.ones((4, 4), dtype=np.uint8)
    avail[1, 1] = 0
    mismatch, provided = rs.repair_verdicts(*(torch.from_numpy(a) for a in (rep, rec, prov, avail)))
    assert mismatch.dtype == provided.dtype == torch.uint8
    assert np.argwhere(mismatch.numpy()).tolist() == [[0, 1]]
    assert np.argwhere(provided.numpy()).tolist() == [[2, 3]]


def test_repair_wrappers_refuse_cpu_tensors():
    # the kernel wrappers take CUDA tensors only: on a CPU tensor they
    # raise; the entry points pick the plain versions for CPU tensors
    known = torch.zeros((1, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        rs.decode_matrices_cuda(known, 2, gf256.CODEC_LEOPARD)
    eds = torch.zeros((4, 4, 512), dtype=torch.uint8)
    D = torch.zeros((1, 4, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        rs.decode_axes_cuda(eds, D, known, torch.zeros(1, dtype=torch.int32), False,
                            gf256.CODEC_LEOPARD)
    mask = torch.zeros((4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        rs.repair_verdicts_cuda(eds, eds, eds, mask)
    with pytest.raises(ValueError, match="CUDA"):
        rs.extend_batched_cuda(torch.zeros((1, 2, 2, 512), dtype=torch.uint8),
                               gf256.CODEC_LEOPARD)
