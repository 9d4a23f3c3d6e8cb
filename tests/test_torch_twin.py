"""The CUDA kernels' per-thread bodies, run on the host through the g++
CPU twin (celestia_tpu_torch/csrc/cpu_twin.cpp), against the port's plain
PyTorch versions and the JAX package — byte for byte.

The kernels themselves run only on a card (chip_smoke.py holds them
against the plain versions there); this file checks the arithmetic they
share with the twin: SHA-256 with its in-kernel padding and unaligned
big-endian loads, the NMT leaf/node message layouts and the parity rule,
the RFC-6962 level loop and its levels output, the proof-path gather
(K7b) over a device-plane entry's sources, the repair kernels' decode
matrices (K8a) and verdicts (K8c), the XOR of staged slabs (K9b), K2 over
a window of EDS rows, and the tensor-core GF(2) bit-GEMM of K5 (one square
and a batch), K5's row pass, the column-parity partial (K9a) and the
in-place decode of an orientation's axes (K8b): its fragments, lane maps
and padded K through a host emulation of mma.sync in the PTX fragment
layouts (rs_extend.cuh), held against the JAX package at small k.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu.ops import nmt as jnmt
from celestia_tpu.ops import rs as jrs
from _torch_common import pinned_codec, torch_one_thread  # noqa: F401 (fixture)
from celestia_tpu_torch.da import device_plane, proof
from celestia_tpu_torch.ops import gather, gf256, nmt, rs
from celestia_tpu_torch.ops.sha256 import sha256_batch_host, sha256_plain

CSRC = Path(__file__).resolve().parents[1] / "celestia_tpu_torch" / "csrc"

_P = ctypes.c_void_p


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the CPU twin")
    lib = tmp_path_factory.mktemp("twin") / "libtwin.so"
    subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wno-unknown-pragmas",
         str(CSRC / "cpu_twin.cpp"), "-o", str(lib)],
        check=True, capture_output=True,
    )
    t = ctypes.CDLL(str(lib))
    LL, I = ctypes.c_longlong, ctypes.c_int
    t.twin_sha256_batch.argtypes = [_P, _P, LL, I, I]
    t.twin_nmt_leaf_digests.argtypes = [_P, _P, I]
    t.twin_nmt_combine_level.argtypes = [_P, _P, LL, I, LL, LL, LL, LL, LL]
    t.twin_rfc6962_root.argtypes = [_P, _P, I, I]
    t.twin_rfc6962_levels.argtypes = [_P, _P, I, I]
    t.twin_rs_extend.argtypes = [_P, _P, _P, _P, _P, I]
    t.twin_das_proof_gather.argtypes = [_P, I, _P, I, _P]
    t.twin_nmt_leaf_digests_batched.argtypes = [_P, _P, I, I]
    t.twin_nmt_combine_level_batched.argtypes = [_P, _P, LL, I, LL, LL, LL, LL, LL, LL, LL]
    t.twin_rs_extend_batched.argtypes = [_P, _P, _P, _P, _P, I, I]
    t.twin_rs_decode_matrices.argtypes = [_P, _P, _P, _P, I, I, I]
    t.twin_rs_decode_axes.argtypes = [_P, _P, _P, _P, _P, _P, I, I, I]
    t.twin_rs_decode_axes_grouped.argtypes = [_P, _P, _P, _P, _P, _P, I, I, I, I]
    t.twin_rs_repair_verdicts.argtypes = [_P, _P, _P, _P, _P, _P, I]
    t.twin_nmt_leaf_digests_window.argtypes = [_P, _P, I, I, I, I]
    t.twin_rs_extend_rows.argtypes = [_P, _P, _P, _P, _P, I, I]
    t.twin_rs_col_parity_partial.argtypes = [_P, _P, _P, _P, _P, I, I, I]
    t.twin_xor_reduce_slabs.argtypes = [_P, _P, I, LL]
    return t


def _ptr(a: np.ndarray) -> int:
    assert a.flags.c_contiguous
    return a.ctypes.data


@pytest.mark.parametrize("L", [0, 1, 3, 55, 56, 63, 64, 65, 91, 119, 181, 542])
@pytest.mark.parametrize("prefix", [-1, 0, 1])
def test_twin_sha256_batch(twin, L, prefix):
    rng = np.random.default_rng(L * 7 + prefix + 1)
    msgs = rng.integers(0, 256, (33, L), dtype=np.uint8)
    out = np.zeros((33, 32), dtype=np.uint8)
    twin.twin_sha256_batch(_ptr(msgs), _ptr(out), 33, L, prefix)
    full = msgs if prefix < 0 else np.concatenate(
        [np.full((33, 1), prefix, dtype=np.uint8), msgs], axis=1
    )
    np.testing.assert_array_equal(out, sha256_batch_host(full))
    if full.shape[1]:
        np.testing.assert_array_equal(out, sha256_plain(torch.from_numpy(full)).numpy())


def _random_eds(rng, k: int) -> np.ndarray:
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    # some real namespaces, and a parity-namespace cell inside Q0
    sq[..., :18] = 0
    sq[0, -1, :29] = 0xFF
    return rs.extend_square(torch.from_numpy(sq)).numpy()


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_twin_nmt_leaf_and_levels(twin, k):
    rng = np.random.default_rng(k)
    eds = _random_eds(rng, k)
    n2 = 2 * k
    grid = np.zeros((n2, n2, 90), dtype=np.uint8)
    twin.twin_nmt_leaf_digests(_ptr(eds), _ptr(grid), n2)
    want_grid = nmt.eds_leaf_digests(torch.from_numpy(eds))
    np.testing.assert_array_equal(grid, want_grid.numpy())
    # first level from the grid through the two stride sets
    d = 90
    nodes = np.zeros((2 * n2, k, d), dtype=np.uint8)
    twin.twin_nmt_combine_level(
        _ptr(grid), _ptr(nodes), 2 * n2, k, n2, n2 * d, d, d, n2 * d
    )
    np.testing.assert_array_equal(
        nodes, nmt.combine_grid(torch.from_numpy(grid)).numpy()
    )
    while nodes.shape[1] > 1:
        m = nodes.shape[1]
        nxt = np.zeros((2 * n2, m // 2, d), dtype=np.uint8)
        twin.twin_nmt_combine_level(
            _ptr(nodes), _ptr(nxt), 2 * n2, m // 2, 2 * n2, m * d, d, m * d, d
        )
        np.testing.assert_array_equal(
            nxt, nmt.combine_level(torch.from_numpy(nodes)).numpy()
        )
        nodes = nxt
    np.testing.assert_array_equal(
        nodes[:, 0].reshape(2, n2, d),
        nmt.eds_nmt_roots(torch.from_numpy(eds)).numpy(),
    )


@pytest.mark.parametrize("n", [1, 2, 4, 8, 512, 1024])
def test_twin_rfc6962_root(twin, n):
    rng = np.random.default_rng(n)
    roots = rng.integers(0, 256, (n, 90), dtype=np.uint8)
    hashes = np.zeros((n, 32), dtype=np.uint8)
    twin.twin_sha256_batch(_ptr(roots), _ptr(hashes), n, 90, 0)
    out = np.zeros((1, 32), dtype=np.uint8)
    twin.twin_rfc6962_root(_ptr(hashes), _ptr(out), 1, n)
    assert out[0].tobytes() == nmt.rfc6962_root_np(list(roots)).tobytes()
    assert out[0].tobytes() == nmt.rfc6962_tree(torch.from_numpy(hashes)).numpy().tobytes()


@pytest.mark.parametrize("n", [4, 64, 512])
def test_twin_rfc6962_levels_match_plain_and_jax(twin, n):
    rng = np.random.default_rng(600 + n)
    roots = rng.integers(0, 256, (n, 90), dtype=np.uint8)
    hashes = np.zeros((n, 32), dtype=np.uint8)
    twin.twin_sha256_batch(_ptr(roots), _ptr(hashes), n, 90, 0)
    levels = np.zeros((2 * n - 1, 32), dtype=np.uint8)
    twin.twin_rfc6962_levels(_ptr(hashes), _ptr(levels), 1, n)
    plain = nmt.rfc6962_level_stack_plain(torch.from_numpy(roots))
    np.testing.assert_array_equal(levels, torch.cat(plain).numpy())
    np.testing.assert_array_equal(levels, nmt.rfc6962_tree_levels(torch.from_numpy(hashes)).numpy())
    assert levels[-1].tobytes() == nmt.rfc6962_root_np(list(roots)).tobytes()
    # the JAX reference, compiled at LLVM optimisation level 0 (same bytes)
    run = jax.jit(jnmt.rfc6962_level_stack).lower(roots).compile(
        compiler_options={"xla_backend_optimization_level": 0}
    )
    want = [np.asarray(lv) for lv in run(roots)]
    got = nmt.split_tree_levels(torch.from_numpy(levels))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def _random_entry(rng, k: int) -> device_plane.DevicePlaneEntry:
    """An entry of the right shapes filled with random bytes."""
    n2 = 2 * k

    def rand(*shape):
        return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))

    levels, m = [], n2
    while m > 1:
        m //= 2
        levels.append(rand(2 * n2, m, 90))
    return device_plane.DevicePlaneEntry(
        k, b"\0" * 32, rand(n2, n2, 512), rand(n2, n2, 90), levels, rand(2 * 4 * k - 1, 32)
    )


@pytest.mark.parametrize("k", [1, 2, 8, 128])
def test_twin_das_proof_gather_matches_plain(twin, k):
    rng = np.random.default_rng(700 + k)
    entry = _random_entry(rng, k)
    n2 = 2 * k
    edges = [(0, 0), (0, n2 - 1), (n2 - 1, 0), (n2 - 1, n2 - 1)]
    coords = edges + [tuple(int(x) for x in rng.integers(0, n2, 2)) for _ in range(60)]
    sources = entry.gather_sources()
    items = device_plane.proof_items(k, coords)
    nbytes = len(coords) * device_plane._cell_layout(k)[2]
    table = np.array(
        [(s.tensor.data_ptr() + s.offset, s.row_stride, s.item_stride, s.width) for s in sources],
        dtype=np.int64,
    )
    out = np.zeros(nbytes, dtype=np.uint8)
    twin.twin_das_proof_gather(_ptr(table), len(sources), _ptr(items), len(items), _ptr(out))
    np.testing.assert_array_equal(out, gather.das_proof_gather_plain(sources, items, nbytes).numpy())
    # the gathered paths are the proofs read straight off the entry's levels
    dah_roots = [bytes(90)] * n2
    hdr = type("Hdr", (), {"row_roots": dah_roots})()
    levels = [entry.level(j).numpy() for j in range(entry.n_levels)]
    root_levels = [lv.numpy() for lv in entry.root_levels()]
    shares = entry.eds.numpy()
    for (r, c), p in zip(coords, device_plane.assemble_proofs(k, hdr, coords, out)):
        row_levels = [lv[0, r] for lv in levels]
        assert p.nmt_proof == proof.nmt_range_proof_from_levels(row_levels, c, c + 1)
        assert p.root_proof == proof.merkle_proof_from_levels(root_levels, r)
        assert p.share == shares[r, c].tobytes()


def test_gather_rejects_items_out_of_bounds():
    rng = np.random.default_rng(9)
    entry = _random_entry(rng, 2)
    sources = entry.gather_sources()
    items = device_plane.proof_items(2, [(3, 3)])
    nbytes = device_plane._cell_layout(2)[2]
    for col, value in [(1, 4), (2, 9), (0, len(sources)), (3, nbytes)]:
        bad = items.copy()
        bad[-1, col] = value
        with pytest.raises(ValueError):
            gather.das_proof_gather(sources, bad, nbytes)
    with pytest.raises(ValueError):
        gather.das_proof_gather(sources, items.astype(np.int64), nbytes)


@pytest.mark.parametrize("codec", gf256.CODECS)
@pytest.mark.parametrize("k", [1, 2, 4, 8, 16])
def test_twin_rs_extend_matches_jax(twin, codec, k):
    rng = np.random.default_rng(100 + k)
    sq = rng.integers(0, 256, (k, k, 512), dtype=np.uint8)
    exp, log = gf256.field_tables(codec)
    E = np.ascontiguousarray(gf256.encode_matrix(k, codec), dtype=np.uint8)
    gexp = np.ascontiguousarray(exp, dtype=np.uint8)
    glog = np.ascontiguousarray(log, dtype=np.uint8)
    out = np.zeros((2 * k, 2 * k, 512), dtype=np.uint8)
    twin.twin_rs_extend(_ptr(sq), _ptr(out), _ptr(E), _ptr(gexp), _ptr(glog), k)
    G = jrs.jnp.asarray(jgf256.encode_matrix_bits(k, codec))
    want = np.asarray(jrs._extend(jrs.jnp.asarray(sq), G))
    np.testing.assert_array_equal(out, want)


def _tables(codec):
    exp, log = gf256.field_tables(codec)
    return np.ascontiguousarray(exp, dtype=np.uint8), np.ascontiguousarray(log, dtype=np.uint8)


@pytest.mark.parametrize("codec", gf256.CODECS)
def test_twin_rs_extend_batched_matches_k5(twin, codec):
    k, n = 8, 3
    rng = np.random.default_rng(800)
    sq = rng.integers(0, 256, (n, k, k, 512), dtype=np.uint8)
    gexp, glog = _tables(codec)
    E = np.ascontiguousarray(gf256.encode_matrix(k, codec), dtype=np.uint8)
    out = np.zeros((n, 2 * k, 2 * k, 512), dtype=np.uint8)
    twin.twin_rs_extend_batched(_ptr(sq), _ptr(out), _ptr(E), _ptr(gexp), _ptr(glog), k, n)
    for b in range(n):
        one = np.zeros((2 * k, 2 * k, 512), dtype=np.uint8)
        square = np.ascontiguousarray(sq[b])
        twin.twin_rs_extend(_ptr(square), _ptr(one), _ptr(E), _ptr(gexp), _ptr(glog), k)
        np.testing.assert_array_equal(out[b], one)
    np.testing.assert_array_equal(out, rs.extend_batched_plain(torch.from_numpy(sq), codec).numpy())


def test_twin_nmt_batched_levels_match_plain(twin):
    k, n = 4, 3
    rng = np.random.default_rng(801)
    eds = np.stack([_random_eds(rng, k) for _ in range(n)])
    n2, d = 2 * k, 90
    grid = np.zeros((n, n2, n2, d), dtype=np.uint8)
    twin.twin_nmt_leaf_digests_batched(_ptr(eds), _ptr(grid), n2, n)
    np.testing.assert_array_equal(grid, nmt.eds_leaf_digests_plain(torch.from_numpy(eds)).numpy())
    # the first level of every grid in one pass: groups of 4k trees
    nodes = np.zeros((n * 2 * n2, k, d), dtype=np.uint8)
    twin.twin_nmt_combine_level_batched(
        _ptr(grid), _ptr(nodes), n * 2 * n2, k, n2, n2 * d, d, d, n2 * d, 2 * n2, n2 * n2 * d
    )
    np.testing.assert_array_equal(
        nodes.reshape(n, 2 * n2, k, d), nmt.combine_grid_plain(torch.from_numpy(grid)).numpy()
    )


@pytest.mark.parametrize("codec", gf256.CODECS)
@pytest.mark.parametrize("k", [2, 8, 128])
def test_twin_rs_decode_matrices_matches_plain(twin, codec, k):
    rng = np.random.default_rng(810 + k)
    n = 5
    known = np.stack([rng.permutation(2 * k)[:k] for _ in range(n)]).astype(np.uint8)
    known[0] = np.arange(k)  # the first k positions, as fraud detection asks
    gexp, glog = _tables(codec)
    D = np.zeros((n, 2 * k, k), dtype=np.uint8)
    xor_const = k if codec == gf256.CODEC_LEOPARD else 0
    twin.twin_rs_decode_matrices(_ptr(known), _ptr(D), _ptr(gexp), _ptr(glog), n, k, xor_const)
    np.testing.assert_array_equal(D, rs._decode_matrices_dev(torch.from_numpy(known), k, codec).numpy())
    if k <= 8:
        want = np.asarray(jrs._decode_matrices_dev(jrs.jnp.asarray(known), k, codec))
        np.testing.assert_array_equal(D, want)


@pytest.mark.parametrize("codec", gf256.CODECS)
@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("cols", [False, True])
def test_twin_rs_decode_axes_matches_plain(twin, codec, k, cols):
    rng = np.random.default_rng(820 + k + 100 * cols)
    n2 = 2 * k
    eds = rng.integers(0, 256, (n2, n2, 512), dtype=np.uint8)
    n = k + 1
    axes = np.sort(rng.permutation(n2)[:n]).astype(np.int32)
    # known sets that are not the first k positions (but one that is)
    known = np.stack([np.sort(rng.permutation(n2)[:k]) for _ in range(n)]).astype(np.uint8)
    known[-1] = np.arange(k)
    D = rs._decode_matrices_dev(torch.from_numpy(known), k, codec)
    gexp, glog = _tables(codec)
    D_np = np.ascontiguousarray(D.numpy())
    out = eds.copy()
    twin.twin_rs_decode_axes(_ptr(out), _ptr(D_np), _ptr(known), _ptr(axes), _ptr(gexp),
                             _ptr(glog), n, k, int(cols))
    want = rs.decode_axes_plain(torch.from_numpy(eds.copy()), D, torch.from_numpy(known),
                                torch.from_numpy(axes), cols, codec).numpy()
    np.testing.assert_array_equal(out, want)
    # known positions keep their bytes, unknown ones are all rewritten
    view_out = out.transpose(1, 0, 2) if cols else out
    view_in = eds.transpose(1, 0, 2) if cols else eds
    for a, kn in zip(axes, known):
        np.testing.assert_array_equal(view_out[a, kn], view_in[a, kn])


def test_twin_rs_repair_verdicts_match_plain(twin):
    rng = np.random.default_rng(830)
    n2 = 8
    rep = rng.integers(0, 4, (n2, n2, 512), dtype=np.uint8)
    rec, prov = rep.copy(), rep.copy()
    rec[0, 1, 0] ^= 1
    rec[5, 5, 511] ^= 0x80
    prov[2, 3, 17] ^= 1
    prov[4, 4, 300] ^= 1  # not available: no provided mismatch
    prov[6, 7, 496] ^= 1
    avail = (rng.random((n2, n2)) < 0.5).astype(np.uint8)
    avail[2, 3] = avail[6, 7] = 1
    avail[4, 4] = 0
    mismatch = np.zeros((n2, n2), dtype=np.uint8)
    provided = np.zeros_like(mismatch)
    twin.twin_rs_repair_verdicts(_ptr(rep), _ptr(rec), _ptr(prov), _ptr(avail), _ptr(mismatch),
                                 _ptr(provided), n2 * n2)
    want = rs.repair_verdicts_plain(*(torch.from_numpy(a) for a in (rep, rec, prov, avail)))
    np.testing.assert_array_equal(mismatch, want[0].numpy())
    np.testing.assert_array_equal(provided, want[1].numpy())
    assert np.argwhere(mismatch).tolist() == [[0, 1], [5, 5]]
    assert np.argwhere(provided).tolist() == [[2, 3], [6, 7]]


def test_twin_rs_decode_axes_leaves_out_of_range_tables_unwritten(twin):
    codec, k = gf256.CODEC_LEOPARD, 4
    rng = np.random.default_rng(840)
    eds = rng.integers(0, 256, (2 * k, 2 * k, 512), dtype=np.uint8)
    known = np.array([[0, 1, 2, 3], [0, 1, 2, 2 * k], [4, 5, 6, 7]], dtype=np.uint8)
    axes = np.array([2 * k, 1, 3], dtype=np.int32)  # axis past 2k; a position past 2k
    D = np.ascontiguousarray(rs._decode_matrices_dev(torch.from_numpy(known), k, codec).numpy())
    gexp, glog = _tables(codec)
    out = eds.copy()
    twin.twin_rs_decode_axes(_ptr(out), _ptr(D), _ptr(known), _ptr(axes), _ptr(gexp), _ptr(glog),
                             3, k, 0)
    np.testing.assert_array_equal(out[:3], eds[:3])  # rows 0-2 untouched (row 1 refused)
    np.testing.assert_array_equal(out[4:], eds[4:])
    want = rs.decode_axes_plain(torch.from_numpy(eds.copy()), torch.from_numpy(D[2:]),
                                torch.from_numpy(known[2:]), torch.from_numpy(axes[2:]),
                                False, codec).numpy()
    np.testing.assert_array_equal(out[3], want[3])  # the valid axis is decoded


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("window", ["all", "parity", "top", "bottom", "straddle"])
def test_twin_nmt_leaf_digests_window(twin, k, window):
    """K2 over a window of EDS rows, batched, against the plain window and
    the whole EDS's grid: every parity row (row0 = k), windows inside the
    top or the bottom half, and one across the Q0 boundary."""
    n2 = 2 * k
    row0, n_rows = {"all": (0, n2), "parity": (k, k), "top": (k // 2, k // 2),
                    "bottom": (k + k // 2, k // 2), "straddle": (k - 1, 2)}[window]
    rng = np.random.default_rng(900 + k)
    eds = np.stack([_random_eds(rng, k) for _ in range(2)])
    rows = np.ascontiguousarray(eds[:, row0 : row0 + n_rows])
    out = np.zeros((2, n_rows, n2, 90), dtype=np.uint8)
    twin.twin_nmt_leaf_digests_window(_ptr(rows), _ptr(out), n2, 2, row0, n_rows)
    np.testing.assert_array_equal(
        out, nmt.leaf_digests_window(torch.from_numpy(rows), row0).numpy())
    np.testing.assert_array_equal(
        out, nmt.eds_leaf_digests(torch.from_numpy(eds)).numpy()[:, row0 : row0 + n_rows])


@pytest.mark.parametrize("codec", gf256.CODECS)
def test_twin_rs_extend_rows_matches_plain(twin, codec):
    k, n = 8, 5
    rng = np.random.default_rng(901)
    rows = rng.integers(0, 256, (n, k, 512), dtype=np.uint8)
    gexp, glog = _tables(codec)
    E = np.ascontiguousarray(gf256.encode_matrix(k, codec), dtype=np.uint8)
    out = np.zeros((n, 2 * k, 512), dtype=np.uint8)
    twin.twin_rs_extend_rows(_ptr(rows), _ptr(out), _ptr(E), _ptr(gexp), _ptr(glog), k, n)
    np.testing.assert_array_equal(out, rs.extend_rows_plain(torch.from_numpy(rows), codec).numpy())


@pytest.mark.parametrize("codec", gf256.CODECS)
@pytest.mark.parametrize("k,R", [(8, 1), (8, 2), (8, 8), (16, 4)])
def test_twin_col_parity_partial_matches_plain(twin, codec, k, R):
    """K9a's twin against its plain version (JAX's bit-lift), every shard of
    a batch of two squares' top rows, with the kernel's coefficients."""
    rows = k // R
    rng = np.random.default_rng(902 + k + R)
    top_all = rng.integers(0, 256, (2, k, 2 * k, 512), dtype=np.uint8)
    gexp, glog = _tables(codec)
    for d in range(R):
        top = np.ascontiguousarray(top_all[:, d * rows : (d + 1) * rows])
        Es = np.ascontiguousarray(gf256.encode_matrix(k, codec)[:, d * rows : (d + 1) * rows])
        out = np.zeros((2, k, 2 * k, 512), dtype=np.uint8)
        twin.twin_rs_col_parity_partial(_ptr(top), _ptr(out), _ptr(Es), _ptr(gexp), _ptr(glog),
                                        k, rows, 2)
        coeffs = rs.partial_coefficients(k, d * rows, rows, codec, "cpu")
        np.testing.assert_array_equal(
            out, rs.col_parity_partial(torch.from_numpy(top), coeffs).numpy())


@pytest.mark.parametrize("R", [1, 2, 8])
def test_twin_xor_reduce_slabs_matches_plain(twin, R):
    rng = np.random.default_rng(903 + R)
    staged = rng.integers(0, 256, (R, 4, 1024), dtype=np.uint8)
    out = np.zeros((4, 1024), dtype=np.uint8)
    twin.twin_xor_reduce_slabs(_ptr(staged), _ptr(out), R, out.nbytes)
    np.testing.assert_array_equal(
        out, rs.xor_reduce_slabs_plain(torch.from_numpy(staged)).numpy())


def _decode_case(rng, k: int, codec: str, n: int):
    """An EDS of random bytes, n sorted distinct axes, their known sets
    (sorted, one of them the first k positions) and decode matrices."""
    n2 = 2 * k
    eds = rng.integers(0, 256, (n2, n2, 512), dtype=np.uint8)
    axes = np.sort(rng.permutation(n2)[:n]).astype(np.int32)
    known = np.stack([np.sort(rng.permutation(n2)[:k]) for _ in range(n)]).astype(np.uint8)
    known[-1] = np.arange(k)
    D = rs._decode_matrices_dev(torch.from_numpy(known), k, codec)
    return eds, axes, known, np.ascontiguousarray(D.numpy())


@pytest.mark.parametrize("codec", gf256.CODECS)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("cols", [False, True])
def test_twin_rs_decode_axes_matches_jax(twin, codec, k, cols):
    """K8b's bit-GEMM at small k (K = 8k under one 32-deep k-step at k = 1,
    2), both orientations, against the JAX package's decode of every axis
    (celestia_tpu/ops/rs.py:206 `_decode_axes_dev`): the decoded axes equal
    JAX's outright, since D's rows at the known positions are one-hot."""
    rng = np.random.default_rng(1000 + k + 10 * cols)
    n2 = 2 * k
    eds, axes, known, D = _decode_case(rng, k, codec, min(n2, k + 1))
    gexp, glog = _tables(codec)
    out = eds.copy()
    twin.twin_rs_decode_axes(_ptr(out), _ptr(D), _ptr(known), _ptr(axes), _ptr(gexp), _ptr(glog),
                             len(axes), k, int(cols))
    known_all = np.tile(np.arange(k, dtype=np.uint8), (n2, 1))
    known_all[axes] = known
    view_in = np.ascontiguousarray(eds.transpose(1, 0, 2) if cols else eds)
    want = np.asarray(jrs._decode_axes_dev(jrs.jnp.asarray(view_in), jrs.jnp.asarray(known_all), k,
                                           n2, codec))
    view_out = out.transpose(1, 0, 2) if cols else out
    np.testing.assert_array_equal(view_out[axes], want[axes])
    others = np.setdiff1d(np.arange(n2), axes)
    np.testing.assert_array_equal(view_out[others], view_in[others])


@pytest.mark.parametrize("codec", gf256.CODECS)
@pytest.mark.parametrize("gpb", [1, 2, 3])
def test_twin_rs_decode_axes_groups_per_block(twin, codec, gpb):
    """K8b with 1, 2 or 3 output groups of 8 a block at k = 32 (4 groups:
    at 3, a block of 3 and a block of 1), as large launches run it: the
    per-group coefficients and output positions of a block's tiles."""
    k = 32
    rng = np.random.default_rng(1100 + gpb)
    eds, axes, known, D = _decode_case(rng, k, codec, 5)
    gexp, glog = _tables(codec)
    out = eds.copy()
    twin.twin_rs_decode_axes_grouped(_ptr(out), _ptr(D), _ptr(known), _ptr(axes), _ptr(gexp),
                                      _ptr(glog), len(axes), k, 0, gpb)
    want = rs.decode_axes_plain(torch.from_numpy(eds.copy()), torch.from_numpy(D),
                                torch.from_numpy(known), torch.from_numpy(axes), False, codec)
    np.testing.assert_array_equal(out, want.numpy())


@pytest.mark.parametrize("codec", gf256.CODECS)
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_twin_rs_extend_batched_matches_jax(twin, codec, k):
    """K5b's two launches over a batch of 2 squares at small k, against the
    JAX package's `_extend` of each square."""
    rng = np.random.default_rng(1200 + k)
    sq = rng.integers(0, 256, (2, k, k, 512), dtype=np.uint8)
    gexp, glog = _tables(codec)
    E = np.ascontiguousarray(gf256.encode_matrix(k, codec), dtype=np.uint8)
    out = np.zeros((2, 2 * k, 2 * k, 512), dtype=np.uint8)
    twin.twin_rs_extend_batched(_ptr(sq), _ptr(out), _ptr(E), _ptr(gexp), _ptr(glog), k, 2)
    G = jrs.jnp.asarray(jgf256.encode_matrix_bits(k, codec))
    for b in range(2):
        np.testing.assert_array_equal(out[b], np.asarray(jrs._extend(jrs.jnp.asarray(sq[b]), G)))


@pytest.mark.parametrize("codec", gf256.CODECS)
@pytest.mark.parametrize("k,R", [(1, 1), (2, 2), (4, 4), (8, 8), (8, 2)])
def test_twin_col_parity_partial_matches_jax(twin, codec, k, R):
    """K9a at n_in = k/R inputs (1 at every k but the last case: one real
    input in a 32-deep k-step), every shard, against the JAX package's
    partial product (celestia_tpu/parallel/sharded.py:82-87: the `g_cols`
    slice of G times the shard's bit planes by column, & 1), packed."""
    rows = k // R
    rng = np.random.default_rng(1300 + k + R)
    top_all = rng.integers(0, 256, (1, k, 2 * k, 512), dtype=np.uint8)
    gexp, glog = _tables(codec)
    G = jgf256.encode_matrix_bits(k, codec)
    for d in range(R):
        top = np.ascontiguousarray(top_all[:, d * rows : (d + 1) * rows])
        Es = np.ascontiguousarray(gf256.encode_matrix(k, codec)[:, d * rows : (d + 1) * rows])
        out = np.zeros((1, k, 2 * k, 512), dtype=np.uint8)
        twin.twin_rs_col_parity_partial(_ptr(top), _ptr(out), _ptr(Es), _ptr(gexp), _ptr(glog),
                                        k, rows, 1)
        g_cols = jrs.jnp.asarray(G[:, 8 * d * rows : 8 * (d + 1) * rows])
        bits = jrs.unpack_bits(jrs.jnp.asarray(top[0].transpose(1, 0, 2)))  # (2k, 8 rows, B)
        want = np.asarray(jrs.pack_bits(jrs.matmul_gf2(g_cols, bits))).transpose(1, 0, 2)
        np.testing.assert_array_equal(out[0], want)


# C entry -> its twin where the names differ (same arguments, no stream)
_TWIN_OF = {"ctt_nmt_leaf_digests": "twin_nmt_leaf_digests_window",
            "ctt_nmt_combine_level": "twin_nmt_combine_level_batched",
            "ctt_rfc6962_root": "twin_rfc6962_levels"}


@pytest.mark.parametrize("R", [2, 8])
def test_twin_runs_the_sharded_card_path(twin, monkeypatch, R):
    """The sharded extension's card path (parallel/sharded.py with every
    wrapper's CUDA branch: its strides, windows, out= views and launch
    arguments) on CPU tensors, each launch going to the g++ twin of its C
    entry: the same EDS and DAH as the plain single-device path."""
    from celestia_tpu_torch import kernels
    from celestia_tpu_torch.da import dah
    from celestia_tpu_torch.parallel import sharded

    codec, k = gf256.CODEC_LEOPARD, 8
    sq = _random_eds(np.random.default_rng(904 + R), k)[:k, :k].copy()
    eds_1, hdr_1 = dah.extend_and_header(sq, device="cpu")
    launched = {}

    def launch(kernel, device, *args, launches=1, entry=None):
        c_entry = entry or kernels.KERNELS[kernel]
        fn = getattr(twin, _TWIN_OF.get(c_entry, c_entry.replace("ctt_", "twin_")))
        fn.argtypes = list(kernels._SIGNATURES[c_entry][:-1])  # no stream
        fn(*args)
        launched[kernel] = launched.get(kernel, 0) + launches

    def check_tensor(t, name, shape=None):
        assert t.dtype == torch.uint8 and t.is_contiguous(), name
        assert shape is None or tuple(t.shape) == tuple(shape), (name, tuple(t.shape), shape)

    def coefficients(k, j0, n_in, codec, device):
        E = gf256.encode_matrix(k, codec)[:, j0 : j0 + n_in]
        return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8))
                     for a in (E, *gf256.field_tables(codec)))

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "check_cuda_tensor", check_tensor)
    monkeypatch.setattr(nmt, "_is_cpu", lambda t: False)
    monkeypatch.setattr(rs, "extend_rows", rs.extend_rows_cuda)
    monkeypatch.setattr(rs, "partial_coefficients", coefficients)
    monkeypatch.setattr(rs, "col_parity_partial", lambda top, c: rs.col_parity_partial_cuda(top, *c))
    monkeypatch.setattr(rs, "xor_reduce_slabs", rs.xor_reduce_slabs_cuda)
    # sharded.py caches each mesh's K9a coefficients: neither the plain
    # path's form, cached by an earlier test in this process, nor this
    # test's card form may cross the test's edges
    sharded._FN_CACHE.clear()
    try:
        with pinned_codec(codec):
            eds, hdr = sharded.extend_and_header_sharded(sq, sharded.make_mesh(["cpu"] * R))
    finally:
        sharded._FN_CACHE.clear()
    np.testing.assert_array_equal(eds.shares, eds_1.shares)
    assert hdr == hdr_1
    # one launch per shard of the row pass, K9a and K9b, two K2 windows per
    # shard, K3: log2(2k) row-tree levels and log2(k/R) column-subtree levels
    # per shard, then log2(2R) finishing levels once on the one device; K1 + K4
    lg = lambda n: n.bit_length() - 1  # noqa: E731
    assert launched == {
        "rs_extend": R, "rs_col_parity_partial": R, "xor_reduce_slabs": R,
        "nmt_leaf_digests": 2 * R,
        "nmt_combine_level": R * (lg(2 * k) + lg(k // R)) + lg(2 * R),
        "sha256_batch": 1, "rfc6962_root": 1,
    }
