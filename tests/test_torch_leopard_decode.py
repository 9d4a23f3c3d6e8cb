"""K8b under leopard-ff8: Leopard's O(k log k) erasure decode
(celestia_tpu_torch/csrc/rs_leopard_decode.cu), its plain PyTorch version
``rs.decode_axes_fft_plain`` and its per-thread body run on the host
through the g++ CPU twin, held byte for byte against the JAX package's
``_decode_axes_dev`` (the Lagrange bit lift), the port's Lagrange plain
version, the native Leopard decoder the port binds (``utils/native.py``
``leo_decode_axes``, given the known positions alone as present) and K5's
encode; and the wrappers' choice of kernel, which only the codec makes:
under leopard-ff8 a repair and fraud detection build no decode matrix.

The kernel itself runs only on a card: ``chip_smoke.py`` phase 2 holds it
against the plain version and the bit-GEMM kernel there at k = 1..128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celestia_tpu.ops import rs as jrs
from _torch_common import pinned_codec, route_launches_to_twin
from _torch_common import torch_one_thread, twin  # noqa: F401 (fixtures)
from celestia_tpu_torch.da import fraud
from celestia_tpu_torch.ops import gf256, rs
from celestia_tpu_torch.utils import native

LEO = gf256.CODEC_LEOPARD
KINDS = ("data", "parity", "random", "interleaved", "unsorted")
K_SMALL = (1, 2, 4, 8, 16, 32)


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _field():
    return tuple(np.ascontiguousarray(a, dtype=np.uint8) for a in gf256.field_tables(LEO))


def _known(kind: str, k: int, n_axes: int, rng) -> np.ndarray:
    """n_axes known-position sets of one kind: the data half, the parity
    half, random (sorted), every other position, or random unsorted."""
    n = 2 * k
    if kind == "data":
        one = np.arange(k)
    elif kind == "parity":
        one = np.arange(k, n)
    elif kind == "interleaved":
        one = np.arange(0, n, 2)
    else:
        sets = [rng.permutation(n)[:k] for _ in range(n_axes)]
        if kind == "random":
            sets = [np.sort(s) for s in sets]
        return np.stack(sets).astype(np.uint8)
    return np.tile(one, (n_axes, 1)).astype(np.uint8)


def _codeword_case(k: int, kind: str, seed: int):
    """An honest EDS, the decoded orientation's 2k axes' known sets, and a
    damaged copy: every unknown cell garbage except on axis 0, where one
    cell that is provided but not known is the codeword's with a bit
    flipped."""
    rng = np.random.default_rng(seed)
    n = 2 * k
    with pinned_codec(LEO):
        eds = rs.extend_plain(torch.from_numpy(rng.integers(0, 256, (k, k, 512), dtype=np.uint8)),
                              LEO).numpy()
    known = _known(kind, k, n, rng)
    unknown = np.ones((n, n), dtype=bool)
    unknown[np.arange(n)[:, None], known.astype(np.int64)] = False
    damaged = eds.copy()
    damaged[unknown] = rng.integers(0, 256, (int(unknown.sum()), 512), dtype=np.uint8)
    flip = int(np.nonzero(unknown[0])[0][0])
    damaged[0, flip] = eds[0, flip]
    damaged[0, flip, 7] ^= 0x40
    return eds, damaged, known


def _twin_decode(twin, eds: np.ndarray, known: np.ndarray, axes: np.ndarray, cols: bool):
    k = eds.shape[0] // 2
    gexp, glog = _field()
    tab = _tables(twin, k)
    out = np.ascontiguousarray(eds).copy()
    known = np.ascontiguousarray(known, dtype=np.uint8)
    axes = np.ascontiguousarray(axes, dtype=np.int32)
    assert twin.twin_rs_leopard_decode_axes(_ptr(out), _ptr(known), _ptr(axes), _ptr(tab),
                                            _ptr(gexp), _ptr(glog), len(axes), k, int(cols)) == 0
    return out


def _tables(twin, k: int) -> np.ndarray:
    gexp, glog = _field()
    n = 2 * k
    out = np.zeros((n - 1 + n.bit_length() - 1) * 24, dtype=np.uint8)
    assert twin.twin_rs_leopard_decode_tables(_ptr(gexp), _ptr(glog), k, _ptr(out), out.nbytes) == 0
    return out


def _plain(eds: np.ndarray, known: np.ndarray, axes: np.ndarray, cols: bool) -> np.ndarray:
    return rs.decode_axes_fft_plain(torch.from_numpy(eds.copy()), torch.from_numpy(known),
                                    torch.from_numpy(axes.astype(np.int32)), cols).numpy()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", K_SMALL)
def test_plain_fft_decode_matches_jax_and_lagrange_plain(torch_one_thread, k, kind):
    """Over every axis of random bytes (no codeword: the decode is a linear
    map of the k known cells) the plain Leopard decode equals JAX
    ``_decode_axes_dev`` under leopard-ff8 and the port's Lagrange plain
    version; and it restores a damaged codeword (garbage in the unknown
    cells, a flipped provided-but-not-known cell) in both orientations."""
    rng = np.random.default_rng(1000 + 7 * k + KINDS.index(kind))
    n = 2 * k
    data = rng.integers(0, 256, (n, n, 16), dtype=np.uint8)
    known = _known(kind, k, n, rng)
    every = np.arange(n, dtype=np.int32)
    got = _plain(data, known, every, False)
    with pinned_codec(LEO):
        want = np.asarray(jrs._decode_axes_dev(jnp.asarray(data), jnp.asarray(known), k,
                                               max(1, k // 2), LEO))
    np.testing.assert_array_equal(got, want)
    kt = torch.from_numpy(known)
    lagrange = rs.decode_axes_plain(torch.from_numpy(data.copy()),
                                    rs._decode_matrices_dev(kt, k, LEO), kt,
                                    torch.from_numpy(every), False, LEO).numpy()
    np.testing.assert_array_equal(got, lagrange)
    eds, damaged, known = _codeword_case(k, kind, 1100 + k)
    np.testing.assert_array_equal(_plain(damaged, known, every, False), eds)
    # columns of the transposed copy are the rows above
    got_cols = _plain(np.ascontiguousarray(damaged.transpose(1, 0, 2)), known, every, True)
    np.testing.assert_array_equal(got_cols.transpose(1, 0, 2), eds)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", K_SMALL)
def test_plain_fft_decode_matches_native_leopard(k, kind):
    """The native decoder (the JAX package's host repair), given as present
    exactly the k known positions of each axis, writes the other k; the
    plain decode writes the same bytes, garbage in every unknown cell."""
    if not native.available():
        pytest.skip("the port's native library did not build")
    rng = np.random.default_rng(1200 + 7 * k + KINDS.index(kind))
    n = 2 * k
    data = rng.integers(0, 256, (n, n, 64), dtype=np.uint8)
    known = _known(kind, k, n, rng)
    present = np.zeros((n, n), dtype=np.uint8)
    present[np.arange(n)[:, None], known.astype(np.int64)] = 1
    want = data.copy()
    with pinned_codec(LEO):
        assert native.leo_decode_axes(want, present, nthreads=1).all()
    np.testing.assert_array_equal(_plain(data, known, np.arange(n), False), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", K_SMALL)
def test_twin_fft_decode_matches_plain(twin, k, kind):
    """The kernel's body (g++ twin) against the plain version on a damaged
    codeword, rows and columns: a few axes, each restored (the flipped
    provided-but-not-known cell overwritten), beside an axis index past 2k
    and an axis whose known set holds a position past 2k, both left as
    they are; every other axis untouched."""
    eds, damaged, known = _codeword_case(k, kind, 1300 + k)
    n = 2 * k
    for cols in (False, True):
        src = np.ascontiguousarray(damaged.transpose(1, 0, 2)) if cols else damaged
        axes = np.array([0, n + 1, n - 1, 1][: 4 if n > 2 else 3], dtype=np.int32)
        kn = known[np.minimum(axes, n - 1)].copy()
        if n > 2:
            kn[3, 0] = n + 3  # a known position past 2k: axis 1 is left as it is
        got = _twin_decode(twin, src, kn, axes, cols)
        np.testing.assert_array_equal(got, _plain(src, kn, axes, cols))
        view = got.transpose(1, 0, 2) if cols else got
        src_view = src.transpose(1, 0, 2) if cols else src
        decoded = {0, n - 1}
        for a in range(n):
            want = eds[a] if a in decoded else src_view[a]
            np.testing.assert_array_equal(view[a], want, err_msg=f"axis {a} cols={cols}")


def test_twin_and_plain_decode_at_k64_with_eight_warp_blocks(twin):
    """k = 64 over all 128 axes of a damaged codeword (the launch takes its
    8-warp blocks from 66 axes on), random known sets: the twin, the plain
    version and the honest EDS agree."""
    k = 64
    eds, damaged, known = _codeword_case(k, "unsorted", 1400)
    axes = np.arange(2 * k, dtype=np.int32)
    got = _twin_decode(twin, damaged, known, axes, False)
    np.testing.assert_array_equal(got, eds)
    np.testing.assert_array_equal(_plain(damaged, known, axes, False), eds)


@pytest.mark.parametrize("k", [2, 8, 32])
def test_twin_eight_warp_blocks_at_small_k(twin, k):
    """66 axes or more take 8-warp blocks at any k: the 2k axes of a damaged
    codeword and out-of-range axis indices after them."""
    eds, damaged, known = _codeword_case(k, "random", 1450 + k)
    n = 2 * k
    extra = max(0, 70 - n)
    axes = np.concatenate([np.arange(n), n + np.arange(extra)]).astype(np.int32)
    kn = np.concatenate([known, np.tile(known[:1], (extra, 1))])
    got = _twin_decode(twin, damaged, kn, axes, False)
    np.testing.assert_array_equal(got, eds)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64])
def test_decode_from_the_data_half_gives_k5_parity(twin, k):
    """Rows decoded from their data half (known = positions 0..k-1, the
    parity cells garbage) are K5's encode: the EDS's top half."""
    rng = np.random.default_rng(1500 + k)
    square = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    with pinned_codec(LEO):
        eds = rs.extend_plain(torch.from_numpy(square), LEO).numpy()
    damaged = eds.copy()
    damaged[:k, k:] = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    known = np.tile(np.arange(k, dtype=np.uint8), (k, 1))
    axes = np.arange(k, dtype=np.int32)
    np.testing.assert_array_equal(_twin_decode(twin, damaged, known, axes, False)[:k], eds[:k])
    np.testing.assert_array_equal(_plain(damaged, known, axes, False)[:k], eds[:k])


@pytest.mark.parametrize("k", [1, 4, 128])
def test_twin_decode_tables_hold_each_groups_products(twin, k):
    """Group g of layer j of the transform at coset 0: its skew s =
    LEO_SKEW[j][2^(j+1) g] (the plain version's), then the derivative's c_i;
    each 24 bytes: s * v (v < 8), s * (v << 3) (v < 8), s * (v << 6)
    (v < 4), a zero word."""
    tab = _tables(twin, k).reshape(-1, 24)
    skews, derivs, _, _ = rs._leopard_decode_consts(k)
    scalars = [s for layer in skews for s in layer] + list(derivs)
    assert len(tab) == len(scalars) == 2 * k - 1 + (2 * k).bit_length() - 1
    v = np.arange(8, dtype=np.uint8)
    for row, s in zip(tab, scalars):
        want = np.concatenate([gf256.gf_mul(s, v, LEO), gf256.gf_mul(s, v << 3, LEO),
                               gf256.gf_mul(s, v[:4] << 6, LEO), np.zeros(4, np.uint8)])
        np.testing.assert_array_equal(row, want)
    assert not tab[0].any()  # group 0 of layer 0: skew 0


def test_decode_derivative_constants_match_native_definition():
    """c_i = prod(V_i minus 0) / prod(v_i + V_i), V_i the span of the first
    i basis points (native/celestia_native.cpp leo_deriv_init): c_0 = 1,
    and every c_i is nonzero."""
    _, derivs, _, _ = rs._leopard_decode_consts(128)
    assert derivs[0] == 1 and all(derivs)
    for i, c in enumerate(derivs):
        num = den = np.uint8(1)
        for x in range(1, 1 << i):
            num = gf256.gf_mul(num, x, LEO)
        for x in range(1 << i):
            den = gf256.gf_mul(den, (1 << i) ^ x, LEO)
        assert gf256.gf_mul(c, den, LEO) == num


def test_twin_decode_refusals(twin):
    gexp, glog = _field()
    out = np.zeros(24 * 263, dtype=np.uint8)
    for k, nbytes in ((0, out.nbytes), (3, out.nbytes), (256, out.nbytes), (128, out.nbytes - 1)):
        assert twin.twin_rs_leopard_decode_tables(_ptr(gexp), _ptr(glog), k, _ptr(out), nbytes) == 1
    eds = np.zeros((4, 4, 512), dtype=np.uint8)
    known = np.zeros((1, 2), dtype=np.uint8)
    axes = np.zeros(1, dtype=np.int32)
    for k, n in ((3, 1), (256, 1), (2, 65536)):
        assert twin.twin_rs_leopard_decode_axes(_ptr(eds), _ptr(known), _ptr(axes), _ptr(out),
                                                _ptr(gexp), _ptr(glog), n, k, 0) == 1


def test_plain_fft_decode_leaves_repeated_known_positions():
    """An axis whose known positions repeat (fewer than k distinct) is left
    as it is, as the kernel leaves it."""
    k = 4
    rng = np.random.default_rng(1600)
    data = rng.integers(0, 256, (8, 8, 16), dtype=np.uint8)
    known = np.array([[0, 1, 2, 3], [0, 0, 2, 3]], dtype=np.uint8)
    got = _plain(data, known, np.array([2, 5]), False)
    np.testing.assert_array_equal(got[5], data[5])
    assert not np.array_equal(got[2], data[2])


def _deep_mask(k: int) -> np.ndarray:
    """The deep-peel chain mask of tests/test_torch_repair.py at k (P = k
    phases, rows and columns in turn)."""
    n = 2 * k
    i = np.arange(k)
    avail = np.zeros((n, n), dtype=bool)
    avail[:k, :k] = (i[None, :] < i[:, None] - 1) | (i[None, :] > i[:, None])
    avail[i, k + i] = True
    avail[k + i[:-1], i[:-1]] = True
    return avail


@pytest.mark.parametrize("codec", gf256.CODECS)
def test_repair_and_fraud_build_decode_matrices_only_under_lagrange(monkeypatch, codec):
    """A repair and fraud detection on CPU tensors: under leopard-ff8 no
    decode matrix is built (the Leopard decode takes the known positions
    alone), under lagrange-gf256 one batch a repair and one a detection."""
    k = 4
    rng = np.random.default_rng(1700)
    with pinned_codec(codec):
        eds = rs.extend_plain(torch.from_numpy(rng.integers(0, 256, (k, k, 512), dtype=np.uint8)),
                              codec).numpy()
        calls = []
        real = rs.decode_matrices
        monkeypatch.setattr(rs, "decode_matrices",
                            lambda *a: calls.append(a[1]) or real(*a))
        got = rs.repair_square_device(eds, _deep_mask(k), device="cpu")
        bad = eds.copy()
        bad[1, k + 1, 9] ^= 0x11
        found = fraud.detect_bad_encoding(bad, device="cpu")
    np.testing.assert_array_equal(got, eds)
    assert found == (fraud.AXIS_ROW, 1)
    assert calls == ([] if codec == LEO else [k, k])


@pytest.mark.parametrize("codec,entry", [(gf256.CODEC_LEOPARD, "ctt_rs_leopard_decode_axes"),
                                         (gf256.CODEC_LAGRANGE, "ctt_rs_decode_axes")])
def test_wrappers_launch_the_codecs_decode_kernel(twin, monkeypatch, codec, entry):
    """On the card, a repair's decodes launch K8b in its codec's form (their
    CUDA branches on CPU tensors, every launch sent to the twin of its C
    entry): under leopard-ff8 the Leopard kernel and no K8a, under
    lagrange-gf256 K8a once and the bit-GEMM; the plain path's bytes and
    one K8b launch a (phase, orientation) either way."""
    k = 4
    rng = np.random.default_rng(1800)
    avail = _deep_mask(k)
    with pinned_codec(codec):
        eds = rs.extend_plain(torch.from_numpy(rng.integers(0, 256, (k, k, 512), dtype=np.uint8)),
                              codec).numpy()
        damaged = eds.copy()
        damaged[~avail] = 0xA5
        want = rs.repair_square_device(damaged, avail, device="cpu")
        schedule = rs._simulate_schedule(avail, k)
        segments = rs._schedule_tensors(schedule, "cpu")[2]
        launched = route_launches_to_twin(monkeypatch, twin)
        # the entry points' CPU branches lead to the card's
        monkeypatch.setattr(rs, "decode_matrices", rs.decode_matrices_cuda)
        monkeypatch.setattr(rs, "decode_axes_plain", rs.decode_axes_bit_gemm_cuda)
        monkeypatch.setattr(rs, "decode_axes_fft_plain", rs.decode_axes_fft_cuda)
        got = rs.repair_square_device(damaged, avail, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, eds)
    assert launched.get("rs_decode_axes") == len(segments) >= 2
    assert launched.get("rs_decode_matrices", 0) == (0 if codec == LEO else 1)
    assert launched.entries.get(entry) == len(segments)
    other = "ctt_rs_decode_axes" if codec == LEO else "ctt_rs_leopard_decode_axes"
    assert other not in launched.entries
