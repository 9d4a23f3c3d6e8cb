"""The CUDA kernels' per-thread bodies, run on the host through the g++
CPU twin (celestia_tpu_torch/csrc/cpu_twin.cpp), against the port's plain
PyTorch versions and the JAX package — byte for byte.

The kernels themselves run only on a card (chip_smoke.py holds them
against the plain versions there); this file checks the arithmetic they
share with the twin: SHA-256 with its in-kernel padding and unaligned
big-endian loads, the NMT leaf/node message layouts and the parity rule,
the RFC-6962 level loop and its levels output, the GF(256) log/antilog
extension, and the proof-path gather (K7b) over a device-plane entry's
sources.
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
from _torch_common import torch_one_thread  # noqa: F401 (fixture)
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
