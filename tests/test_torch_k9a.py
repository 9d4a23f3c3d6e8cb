"""K9a under leopard-ff8: a row shard's column-parity partial as Leopard's
O(k log k) encode with the shard's zero rows pruned
(celestia_tpu_torch/csrc/rs_leopard_partial.cu), its per-thread body
(csrc/rs_leopard.cuh ``leo_partial_*``) run on the host through the g++
CPU twin, held byte for byte against the JAX package: the bit-lift
partial of ``celestia_tpu/parallel/sharded.py:78-87`` (the ``g_cols``
slice of the bit-expanded encode matrix times the shard's bit planes),
the port's plain version, and the parity rows of JAX's ``extend_square``
that the R partials XOR to.  Every R that divides k, k = 1..32, batches of
one and two squares.  Then the wrappers' choice of kernel, which only the
codec makes.

The kernel itself runs only on a card: ``chip_smoke.py`` phase 2 holds it
against its plain version and the bit-GEMM there at every k = 1..128 and R.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu.ops import rs as jrs
from _torch_common import pinned_codec, route_launches_to_twin
from _torch_common import torch_one_thread, twin  # noqa: F401 (fixtures)
from celestia_tpu_torch.ops import gf256, rs

LEO = gf256.CODEC_LEOPARD
# (k, R, n): every R dividing k, batches of 1 and 2
CASES = [(k, R, n) for k in (1, 2, 4, 8, 16, 32) for R in (1, 2, 4, 8, 16, 32) if R <= k
         for n in (1, 2)]


def _ids(case) -> str:
    return "k%d-R%d-n%d" % case


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


@lru_cache(maxsize=None)
def _eds(k: int, n: int) -> np.ndarray:
    """n seeded squares extended by JAX's ``extend_square`` under
    leopard-ff8: uint8[n, 2k, 2k, 512]."""
    rng = np.random.default_rng(1900 + 10 * k + n)
    sq = rng.integers(0, 256, (n, k, k, 512), dtype=np.uint8)
    with pinned_codec(LEO):
        return np.stack([np.asarray(jrs.extend_square(s)) for s in sq])


def _top(k: int, R: int, n: int, d: int) -> np.ndarray:
    """Shard d's top rows (Q0 | Q1 of its k/R rows): uint8[n, k/R, 2k, 512]."""
    m = k // R
    return np.ascontiguousarray(_eds(k, n)[:, d * m : (d + 1) * m, :])


def _twin_tables(twin, k: int, m: int, j0: int) -> np.ndarray:
    gexp, glog = (np.ascontiguousarray(a, dtype=np.uint8) for a in gf256.field_tables(LEO))
    out = np.zeros(rs._leopard_partial_table_bytes(k, m), dtype=np.uint8)
    assert twin.twin_rs_leopard_partial_tables(_ptr(gexp), _ptr(glog), k, m, j0, _ptr(out),
                                               out.nbytes) == 0
    return out


def _twin_partial(twin, top: np.ndarray, k: int, j0: int) -> np.ndarray:
    n, m = top.shape[:2]
    out = np.zeros((n, k, 2 * k, 512), dtype=np.uint8)
    tab = _twin_tables(twin, k, m, j0)
    assert twin.twin_rs_leopard_col_parity_partial(_ptr(top), _ptr(out), _ptr(tab), k, m, j0,
                                                   n) == 0
    return out


def _jax_bit_lift(top: np.ndarray, k: int, j0: int) -> np.ndarray:
    """The JAX package's partial (sharded.py:82-87), packed, square by square."""
    m = top.shape[1]
    g_cols = jrs.jnp.asarray(jgf256.encode_matrix_bits(k, LEO)[:, 8 * j0 : 8 * (j0 + m)])
    out = []
    for t in top:
        bits = jrs.unpack_bits(jrs.jnp.asarray(t.transpose(1, 0, 2)))  # (2k, 8m, B)
        out.append(np.asarray(jrs.pack_bits(jrs.matmul_gf2(g_cols, bits))).transpose(1, 0, 2))
    return np.stack(out)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_twin_partial_matches_jax_bit_lift(twin, case):
    k, R, n = case
    m = k // R
    for d in range(R):
        top = _top(k, R, n, d)
        np.testing.assert_array_equal(_twin_partial(twin, top, k, d * m),
                                      _jax_bit_lift(top, k, d * m), err_msg=f"shard {d}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_twin_partial_matches_port_plain(twin, case):
    k, R, n = case
    m = k // R
    for d in range(R):
        top = _top(k, R, n, d)
        (g_cols,) = rs.partial_coefficients(k, d * m, m, LEO, "cpu")
        want = rs.col_parity_partial(torch.from_numpy(top), (g_cols,)).numpy()
        np.testing.assert_array_equal(_twin_partial(twin, top, k, d * m), want,
                                      err_msg=f"shard {d}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_twin_partials_xor_to_jax_parity_rows(twin, case):
    k, R, n = case
    m = k // R
    got = np.zeros((n, k, 2 * k, 512), dtype=np.uint8)
    for d in range(R):
        got ^= _twin_partial(twin, _top(k, R, n, d), k, d * m)
    np.testing.assert_array_equal(got, _eds(k, n)[:, k:])


def test_twin_partial_tables_against_the_encode_tables(twin):
    """The whole column's tables (m = k) are K5's; a shard's are its groups
    of K5's IFFT, then K5's FFT."""
    gexp, glog = (np.ascontiguousarray(a, dtype=np.uint8) for a in gf256.field_tables(LEO))
    for k in (2, 8, 32, 128):
        full = np.zeros(48 * (k - 1), dtype=np.uint8)
        assert twin.twin_rs_leopard_tables(_ptr(gexp), _ptr(glog), k, _ptr(full),
                                           full.nbytes) == 0
        groups = full.reshape(2 * (k - 1), 24)
        np.testing.assert_array_equal(_twin_tables(twin, k, k, 0).reshape(-1, 24), groups)
        lg = k.bit_length() - 1
        for m in {1, 2, max(1, k // 4)}:
            for j0 in (0, k - m, (k // 2) & ~(m - 1)):
                got = _twin_tables(twin, k, m, j0).reshape(-1, 24)
                want = []
                for j in range(lg):  # IFFT layer j: group g at k - (k >> j) + g
                    span = 2 << j
                    first = (j0 & ~(span - 1)) // span
                    count = m // span if span <= m else 1
                    want += [groups[k - (k >> j) + first + g] for g in range(count)]
                want += list(groups[k - 1 :])  # the FFT's, K5's
                np.testing.assert_array_equal(got, np.stack(want), err_msg=f"k={k} m={m} j0={j0}")


def test_twin_partial_refusals(twin):
    """The C entries refuse what the kernel does not take: a shard off its
    alignment, past k, not a power of two, k above 128 or not a power of
    two, a batch past 65,535 squares."""
    gexp, glog = (np.ascontiguousarray(a, dtype=np.uint8) for a in gf256.field_tables(LEO))
    out = np.zeros(1 << 16, dtype=np.uint8)
    for k, m, j0 in ((8, 2, 1), (8, 4, 6), (8, 3, 0), (8, 16, 0), (256, 1, 0), (12, 4, 0),
                     (8, 2, -2), (8, 0, 0)):
        assert twin.twin_rs_leopard_partial_tables(_ptr(gexp), _ptr(glog), k, m, j0, _ptr(out),
                                                   out.nbytes) == 1, (k, m, j0)
        assert twin.twin_rs_leopard_col_parity_partial(_ptr(out), _ptr(out), _ptr(out), k, m, j0,
                                                       1) == 1, (k, m, j0)
    assert twin.twin_rs_leopard_partial_tables(_ptr(gexp), _ptr(glog), 8, 2, 2, _ptr(out),
                                               rs._leopard_partial_table_bytes(8, 2) - 1) == 1
    assert twin.twin_rs_leopard_col_parity_partial(_ptr(out), _ptr(out), _ptr(out), 8, 2, 2,
                                                   65536) == 1


@pytest.mark.parametrize("codec", gf256.CODECS)
def test_col_parity_partial_dispatch_by_codec(twin, monkeypatch, codec):
    """``col_parity_partial`` on the card takes the codec's kernel, and no
    other: the FFT form under leopard-ff8, the bit-GEMM under
    lagrange-gf256, each launch counted as ``rs_col_parity_partial``.  The
    launches go to the g++ twin of their C entry; every shard's partial
    equals the plain version's, and their XOR the EDS's parity rows."""
    launched = route_launches_to_twin(monkeypatch, twin)
    k, R, n = 16, 4, 2
    m = k // R
    rng = np.random.default_rng(1990)
    sq = rng.integers(0, 256, (n, k, k, 512), dtype=np.uint8)
    eds = rs.extend_batched_plain(torch.from_numpy(sq), codec)
    total = torch.zeros((n, k, 2 * k, 512), dtype=torch.uint8)
    for d in range(R):
        top = eds[:, d * m : (d + 1) * m].contiguous()
        # the card's coefficients, on a CPU tensor
        card = (codec, *(rs.leopard_partial_coefficients(k, d * m, m, "cpu") if codec == LEO
                         else rs.bit_gemm_partial_coefficients(k, d * m, m, codec, "cpu")))
        got = rs.col_parity_partial_cuda(top, *card)
        plain = rs.col_parity_partial(top, rs.partial_coefficients(k, d * m, m, codec, "cpu"))
        assert torch.equal(got, plain), f"shard {d}"
        total ^= got
    assert torch.equal(total, eds[:, k:])
    fft, gemm = "ctt_rs_leopard_col_parity_partial", "ctt_rs_col_parity_partial"
    assert launched == {"rs_col_parity_partial": R}
    assert launched.entries == ({fft: R} if codec == LEO else {gemm: R})


def test_partial_coefficients_by_device_and_codec():
    """On the CPU the bit-lift's ``g_cols`` whatever the codec; the FFT
    form refuses a shard it cannot prune (off its alignment, not a power of
    two)."""
    for codec in gf256.CODECS:
        (g,) = rs.partial_coefficients(8, 2, 2, codec, "cpu")
        want = rs.encode_matrix_bits_tensor(8, codec, "cpu")[:, 16:32]
        assert torch.equal(g, want)
    for j0, m in ((1, 2), (0, 3)):
        with pytest.raises(ValueError):
            rs.leopard_partial_coefficients(8, j0, m, "cpu")
    with pytest.raises(ValueError):
        rs.partial_coefficients(8, 6, 4, LEO, "cpu")
