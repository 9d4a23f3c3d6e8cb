"""K5, K5b and K5's row pass under leopard-ff8: Leopard's O(k log k)
IFFT/FFT kernel (celestia_tpu_torch/csrc/rs_leopard.cu), its per-thread
body run on the host through the g++ CPU twin, held byte for byte against
the JAX package's ``extend_square``, the native Leopard encoder the port
binds (``utils/native.py`` ``leo_extend_square``) and the frozen Go
vectors; and the wrappers' choice of kernel, which only the codec makes.

The kernel itself runs only on a card: ``chip_smoke.py`` phase 2 holds it
against the plain path and the bit-GEMM kernel there at k = 1..128.
"""

import numpy as np
import pytest
import torch

from celestia_tpu.ops import rs as jrs
from _torch_common import pinned_codec, route_launches_to_twin
from _torch_common import torch_one_thread, twin  # noqa: F401 (fixtures)
from celestia_tpu_torch.ops import gf256, rs
from celestia_tpu_torch.utils import native
from test_leopard_codec import LEO_GOLDEN_PARITY

LEO = gf256.CODEC_LEOPARD


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


def _field():
    return tuple(np.ascontiguousarray(a, dtype=np.uint8) for a in gf256.field_tables(LEO))


def _tables(twin, k: int) -> np.ndarray:
    """The encode's skew tables, from the function the C entry runs."""
    gexp, glog = _field()
    out = np.zeros(max(1, 48 * (k - 1)), dtype=np.uint8)
    assert twin.twin_rs_leopard_tables(_ptr(gexp), _ptr(glog), k, _ptr(out), out.nbytes) == 0
    return out


def _extend(twin, sq: np.ndarray) -> np.ndarray:
    k = sq.shape[0]
    out = np.zeros((2 * k, 2 * k, 512), dtype=np.uint8)
    tab = _tables(twin, k)
    twin.twin_rs_leopard_extend(_ptr(sq), _ptr(out), _ptr(tab), k)
    return out


def _square(seed: int, k: int, n=None) -> np.ndarray:
    shape = (k, k, 512) if n is None else (n, k, k, 512)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_twin_fft_extend_matches_jax_extend_square(twin, k):
    sq = _square(1600 + k, k)
    with pinned_codec(LEO):
        want = np.asarray(jrs.extend_square(sq))
    np.testing.assert_array_equal(_extend(twin, sq), want)


@pytest.mark.parametrize("k", [32, 64, 128])
def test_twin_fft_extend_matches_native_leopard(twin, k):
    if not native.available():
        pytest.skip("the port's native library did not build")
    sq = _square(1700 + k, k)
    np.testing.assert_array_equal(_extend(twin, sq), native.leo_extend_square(sq, nthreads=1))


@pytest.mark.parametrize("k", sorted(LEO_GOLDEN_PARITY))
def test_twin_fft_reproduces_golden_parity(twin, k):
    """The frozen Leopard FF8 parity of tests/test_leopard_codec.py: each
    data row's bytes at the head of a 512-byte share (every byte position
    is its own codeword), one row axis through the row pass."""
    data_hex, parity_hex = LEO_GOLDEN_PARITY[k]
    data = np.frombuffer(bytes.fromhex(data_hex), dtype=np.uint8).reshape(k, -1)
    want = np.frombuffer(bytes.fromhex(parity_hex), dtype=np.uint8).reshape(k, -1)
    B = data.shape[1]
    rows = np.zeros((1, k, 512), dtype=np.uint8)
    rows[0, :, :B] = data
    out = np.zeros((1, 2 * k, 512), dtype=np.uint8)
    tab = _tables(twin, k)
    twin.twin_rs_leopard_extend_rows(_ptr(rows), _ptr(out), _ptr(tab), k, 1)
    np.testing.assert_array_equal(out[0, :k], rows[0])
    np.testing.assert_array_equal(out[0, k:, :B], want)
    assert not out[0, k:, B:].any()  # zero columns encode to zero


@pytest.mark.parametrize("k", [1, 4, 16])
def test_twin_fft_batched_and_rows_match_single_square(twin, k):
    n = 3
    sq = _square(1800 + k, k, n)
    tab = _tables(twin, k)
    out = np.zeros((n, 2 * k, 2 * k, 512), dtype=np.uint8)
    twin.twin_rs_leopard_extend_batched(_ptr(sq), _ptr(out), _ptr(tab), k, n)
    for b in range(n):
        one = _extend(twin, np.ascontiguousarray(sq[b]))
        np.testing.assert_array_equal(out[b], one)
        # the row pass over the square's k rows gives the EDS's top half
        rows = np.zeros((k, 2 * k, 512), dtype=np.uint8)
        square = np.ascontiguousarray(sq[b])
        twin.twin_rs_leopard_extend_rows(_ptr(square), _ptr(rows), _ptr(tab), k, k)
        np.testing.assert_array_equal(rows, one[:k])
    np.testing.assert_array_equal(out, rs.extend_batched_plain(torch.from_numpy(sq), LEO).numpy())


def _skews_numpy() -> np.ndarray:
    """LEO_SKEW[j][x] from gf256's Leopard tables, as ``leo_init`` derives it."""
    W = np.arange(256, dtype=np.uint8)
    skew = np.zeros((8, 256), dtype=np.uint8)
    for j in range(8):
        skew[j] = gf256.gf_mul(W, gf256.gf_inv(W[1 << j], LEO), LEO)
        W = gf256.gf_mul(W, W[np.arange(256) ^ (1 << j)], LEO)
    return skew


@pytest.mark.parametrize("k", [2, 8, 128])
def test_twin_fft_tables_hold_each_groups_products(twin, k):
    """Group g of layer j of the IFFT (coset k) and the FFT (coset 0): its
    skew s = LEO_SKEW[j][coset ^ 2^(j+1) g], and the tables s * v (v < 8),
    s * (v << 3) (v < 8), s * (v << 6) (v < 4), then a zero word."""
    tab = _tables(twin, k).reshape(-1, 24)
    skew = _skews_numpy()
    row = 0
    for coset in (k, 0):
        for j in range(k.bit_length() - 1):
            for g in range(k >> (j + 1)):
                s = skew[j][coset ^ (g << (j + 1))]
                v = np.arange(8, dtype=np.uint8)
                want = np.concatenate([gf256.gf_mul(s, v, LEO), gf256.gf_mul(s, v << 3, LEO),
                                       gf256.gf_mul(s, v[:4] << 6, LEO), np.zeros(4, np.uint8)])
                np.testing.assert_array_equal(tab[row], want, err_msg=f"{coset} {j} {g}")
                row += 1
    assert row == len(tab) == 2 * (k - 1)


def test_twin_fft_tables_refusals(twin):
    gexp, glog = _field()
    out = np.zeros(48 * 127, dtype=np.uint8)
    for k, nbytes in ((0, out.nbytes), (3, out.nbytes), (256, out.nbytes), (128, out.nbytes - 1)):
        assert twin.twin_rs_leopard_tables(_ptr(gexp), _ptr(glog), k, _ptr(out), nbytes) == 1


@pytest.mark.parametrize("codec,entries", [
    (gf256.CODEC_LEOPARD, ("ctt_rs_leopard_extend", "ctt_rs_leopard_extend_batched",
                           "ctt_rs_leopard_extend_rows")),
    (gf256.CODEC_LAGRANGE, ("ctt_rs_extend", "ctt_rs_extend_batched", "ctt_rs_extend_rows")),
])
def test_wrappers_launch_the_codecs_kernel(twin, monkeypatch, codec, entries):
    """On the card, K5, K5b and the row pass launch the FFT kernel under
    leopard-ff8 and the bit-GEMM under lagrange-gf256 (their CUDA branches
    on CPU tensors, every launch sent to the twin of its C entry), with
    the plain path's bytes and K5's launch counts either way."""
    k = 8
    sq = torch.from_numpy(_square(1900, k))
    batch = torch.from_numpy(_square(1901, k, 2))
    with pinned_codec(codec):
        want = rs.extend_plain(sq, codec)
        want_b = rs.extend_batched_plain(batch, codec)
        launched = route_launches_to_twin(monkeypatch, twin)
        # the entry points' CPU branches lead to the card's
        monkeypatch.setattr(rs, "extend_plain", rs.extend_cuda)
        monkeypatch.setattr(rs, "extend_batched_plain", rs.extend_batched_cuda)
        got = rs.extend_square(sq)
        got_b = rs.extend_squares_batched(batch)
        got_rows = rs.extend_rows_cuda(sq, codec)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got_b.numpy(), want_b.numpy())
    np.testing.assert_array_equal(got_rows.numpy(), want[:k].numpy())
    assert launched == {"rs_extend": 3, "rs_extend_batched": 2}
    assert launched.entries == {entries[0]: 2, entries[1]: 2, entries[2]: 1}
