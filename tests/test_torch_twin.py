"""The CUDA kernels' per-thread bodies, run on the host through the g++
CPU twin (celestia_tpu_torch/csrc/cpu_twin.cpp), against the port's plain
PyTorch versions and the JAX package — byte for byte.

The kernels themselves run only on a card (chip_smoke.py holds them
against the plain versions there); this file checks the arithmetic they
share with the twin: SHA-256 with its in-kernel padding and unaligned
big-endian loads, the NMT leaf/node message layouts and the parity rule,
the RFC-6962 level loop and its levels output, the proof-path gather
(K7b: the cell mode, which derives each cell's items from its
coordinates, and the table mode) over a device-plane entry's sources, the
repair kernels' decode matrices (K8a) and verdicts (K8c), the in-place
XOR reduce-scatter of the partials' slabs (K9b), K2 over
a window of EDS rows and K3's every level in one launch -- both
block-cooperative, run block by block, each step over every thread between
the barriers, with the kernels' own staging, index maps and packed
outputs -- and the tensor-core GF(2) bit-GEMM of K5 (one square
and a batch), K5's row pass, the column-parity partial (K9a) and the
in-place decode of an orientation's axes (K8b): its fragments, lane maps
and padded K through a host emulation of mma.sync in the PTX fragment
layouts (rs_extend.cuh), held against the JAX package at small k.
"""

import numpy as np
import pytest
import torch

import jax

from celestia_tpu.ops import gf256 as jgf256
from celestia_tpu.ops import nmt as jnmt
from celestia_tpu.ops import rs as jrs
from _torch_common import route_launches_to_twin
from _torch_common import pinned_codec, torch_one_thread, twin  # noqa: F401 (fixtures)
from celestia_tpu_torch.da import device_plane, proof
from celestia_tpu_torch.ops import gather, gf256, nmt, rs
from celestia_tpu_torch.ops.sha256 import sha256_batch_host, sha256_plain


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


def _aligned(a: np.ndarray, align: int = 16) -> np.ndarray:
    """A copy of ``a`` whose data starts on an ``align``-byte boundary."""
    buf = np.zeros(a.nbytes + align, dtype=np.uint8)
    off = (-buf.ctypes.data) % align
    out = buf[off : off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 8, 512, 1024])
def test_twin_rfc6962_root(twin, n):
    """K4's blocks, leaves to root in one launch (the leaf pass, 1,024
    leaves in two staging passes), and over given leaf hashes: the host
    tree's root."""
    rng = np.random.default_rng(n)
    roots = rng.integers(0, 256, (n, 90), dtype=np.uint8)
    want = nmt.rfc6962_root_np(list(roots)).tobytes()
    out = np.zeros((1, 32), dtype=np.uint8)
    assert twin.twin_rfc6962_root(_ptr(roots), _ptr(out), 1, n, 90, 1) == 0
    assert out[0].tobytes() == want
    hashes = np.zeros((n, 32), dtype=np.uint8)
    twin.twin_sha256_batch(_ptr(roots), _ptr(hashes), n, 90, 0)
    out[:] = 0
    assert twin.twin_rfc6962_root(_ptr(hashes), _ptr(out), 1, n, 32, 0) == 0
    assert out[0].tobytes() == want
    assert out[0].tobytes() == nmt.rfc6962_tree(torch.from_numpy(hashes)).numpy().tobytes()
    # what the C entry refuses: an odd start, no trees, an empty leaf, given
    # hashes of another width, a tree that is not a power of two or above
    # 1,024 leaves, an output off a 16-byte boundary
    levels = _aligned(np.zeros((1, 2 * n - 1, 32), dtype=np.uint8))
    for args in [(_ptr(roots) + 1, _ptr(levels), 1, n, 90, 1), (_ptr(roots), _ptr(levels), 0, n, 90, 1),
                 (_ptr(roots), _ptr(levels), 1, n, 0, 1), (_ptr(roots), _ptr(levels), 1, n, 90, 0),
                 (_ptr(roots), _ptr(levels), 1, 3 * n, 90, 1), (_ptr(roots), _ptr(levels), 1, 2048, 90, 1),
                 (_ptr(roots), _ptr(levels) + 8, 1, n, 90, 1)]:
        assert twin.twin_rfc6962_levels(*args) == 1, args


# (n, L, batch): the data root's n = 4k axis roots of 90 bytes, other leaf
# lengths, and batches of trees; the first three keep their old ids
_K4_CASES = [(4, 90, 1), (64, 90, 1), (512, 90, 1), (1, 90, 1), (2, 90, 1), (8, 90, 1),
             (8, 32, 3), (64, 200, 3), (512, 32, 1), (2, 200, 1), (1, 32, 3)]


@pytest.mark.parametrize(
    "n,L,batch", _K4_CASES,
    ids=[str(n) if (L, b) == (90, 1) else f"{n}-L{L}-b{b}" for n, L, b in _K4_CASES])
def test_twin_rfc6962_levels_match_plain_and_jax(twin, n, L, batch):
    """K4's blocks from the leaves (leaf pass) and over given hashes (the
    same kernel without it): every level, packed, byte-equal to JAX's
    ``rfc6962_level_stack`` and to the plain twins; the leaves also start 2
    bytes past a 16-byte boundary (the staging's aligned cover)."""
    rng = np.random.default_rng(600 + n + L + batch)
    roots = rng.integers(0, 256, (batch, n, L), dtype=np.uint8)
    # the JAX reference, compiled at LLVM optimisation level 0 (same bytes)
    run = jax.jit(jnmt.rfc6962_level_stack).lower(roots).compile(
        compiler_options={"xla_backend_optimization_level": 0}
    )
    want = [np.asarray(lv) for lv in run(roots)]
    plain = torch.cat(nmt.rfc6962_level_stack_plain(torch.from_numpy(roots)), dim=-2).numpy()
    np.testing.assert_array_equal(plain, np.concatenate(want, axis=-2))
    for skew in (0, 2):
        buf = _aligned(np.zeros(roots.nbytes + skew, dtype=np.uint8))
        buf[skew:] = roots.reshape(-1)
        levels = _aligned(np.full((batch, 2 * n - 1, 32), 0xA5, dtype=np.uint8))
        assert twin.twin_rfc6962_levels(buf.ctypes.data + skew, _ptr(levels), batch, n, L, 1) == 0
        np.testing.assert_array_equal(levels, plain, err_msg=f"leaf pass, skew {skew}")
    got = nmt.split_tree_levels(torch.from_numpy(levels))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # over the given leaf hashes: the same levels
    hashes = _aligned(want[0])
    tree = _aligned(np.zeros((batch, 2 * n - 1, 32), dtype=np.uint8))
    assert twin.twin_rfc6962_levels(_ptr(hashes), _ptr(tree), batch, n, 32, 0) == 0
    np.testing.assert_array_equal(tree, plain)
    np.testing.assert_array_equal(tree, nmt.rfc6962_tree_levels(torch.from_numpy(hashes)).numpy())
    assert levels[0, -1].tobytes() == nmt.rfc6962_root_np(list(roots[0])).tobytes()


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


def _source_table(sources) -> np.ndarray:
    return np.array(
        [(s.tensor.data_ptr() + s.offset, s.row_stride, s.item_stride, s.width) for s in sources],
        dtype=np.int64,
    )


def _twin_cells(twin, sources, k: int, coords, tree_rows=None) -> np.ndarray:
    """K7b's cell mode through the twin: the records of ``coords``."""
    lay = device_plane._cell_layout(k)
    cells = device_plane.cell_table(coords, tree_rows)
    gather.check_cells(sources, lay, cells)
    out = _aligned(np.zeros(len(coords) * lay.cell_bytes, dtype=np.uint8))
    assert twin.twin_das_cell_gather(_ptr(_source_table(sources)), len(sources), *lay, _ptr(cells),
                                     len(cells), _ptr(out)) == 0
    return out


@pytest.mark.parametrize("mode", ["table", "cell"])
@pytest.mark.parametrize("k", [1, 2, 4, 8, 128])
def test_twin_das_proof_gather_matches_plain(twin, mode, k):
    """K7b in either mode against its plain version over the host's item
    table (``proof_items``), the four corners among the cells, each cell's
    tree its own row and then another row of the NMT sources; and the
    records are the proofs read straight off the entry's levels."""
    rng = np.random.default_rng(700 + k)
    entry = _random_entry(rng, k)
    n2 = 2 * k
    edges = [(0, 0), (0, n2 - 1), (n2 - 1, 0), (n2 - 1, n2 - 1)]
    coords = edges + [tuple(int(x) for x in rng.integers(0, n2, 2)) for _ in range(60)]
    sources = entry.gather_sources()
    nbytes = len(coords) * device_plane._cell_layout(k).cell_bytes
    for tree_rows in (None, [(r + 1 + i) % n2 for i, (r, _) in enumerate(coords)]):
        items = device_plane.proof_items(k, coords, tree_rows)
        if mode == "cell":
            out = _twin_cells(twin, sources, k, coords, tree_rows)
        else:
            out = _aligned(np.zeros(nbytes, dtype=np.uint8))
            assert twin.twin_das_proof_gather(_ptr(_source_table(sources)), len(sources),
                                              _ptr(items), len(items), _ptr(out)) == 0
        np.testing.assert_array_equal(
            out, gather.das_proof_gather_plain(sources, items, nbytes).numpy())
        if tree_rows is None:
            got = out
    # the gathered paths are the proofs read straight off the entry's levels
    dah_roots = [bytes(90)] * n2
    hdr = type("Hdr", (), {"row_roots": dah_roots})()
    levels = [entry.level(j).numpy() for j in range(entry.n_levels)]
    root_levels = [lv.numpy() for lv in entry.root_levels()]
    shares = entry.eds.numpy()
    for (r, c), p in zip(coords, device_plane.assemble_proofs(k, hdr, coords, got)):
        row_levels = [lv[0, r] for lv in levels]
        assert p.nmt_proof == proof.nmt_range_proof_from_levels(row_levels, c, c + 1)
        assert p.root_proof == proof.merkle_proof_from_levels(root_levels, r)
        assert p.share == shares[r, c].tobytes()


@pytest.mark.parametrize("dst_skew", [0, 1, 7])
def test_twin_das_proof_gather_any_alignment(twin, dst_skew):
    """The table mode's 16-byte copy at every source and output alignment:
    items of 1..70 bytes from odd offsets of a source, packed at odd output
    offsets with gaps, against the plain version (the gaps stay zero)."""
    rng = np.random.default_rng(710 + dst_skew)
    base = torch.from_numpy(rng.integers(0, 256, 40_000, dtype=np.uint8))
    sources = [gather.GatherSource(base, 3, 1001, 37, width)
               for width in (1, 15, 16, 17, 45, 70)]
    items, off = [], dst_skew
    for _ in range(120):
        s = int(rng.integers(0, len(sources)))
        items.append((s, int(rng.integers(0, 30)), int(rng.integers(0, 25)), off))
        off += sources[s].width + int(rng.integers(0, 3))
    items = np.array(items, dtype=np.int32)
    out = _aligned(np.zeros(off, dtype=np.uint8))
    assert twin.twin_das_proof_gather(_ptr(_source_table(sources)), len(sources), _ptr(items),
                                      len(items), _ptr(out)) == 0
    np.testing.assert_array_equal(out, gather.das_proof_gather_plain(sources, items, off).numpy())


def test_twin_cell_sibling_order_matches_range_proofs(twin):
    """The cell mode's rule for sibling j of column c (its level from the
    bits of c, its node (c >> level) ^ 1) against the range-proof walk
    (``_cell_node_indices``) for every column at every k = 1..128."""
    for k in (1, 2, 4, 8, 16, 32, 64, 128):
        n2 = 2 * k
        n_sib = n2.bit_length() - 1
        got = np.zeros((n_sib, 2), dtype=np.int32)
        for c in range(n2):
            twin.twin_das_cell_siblings(c, n_sib, _ptr(got))
            assert [tuple(x) for x in got.tolist()] == list(
                device_plane._cell_node_indices(n2, c, n_sib + 1)), (k, c)


def test_gather_rejects_items_out_of_bounds(twin):
    """The table mode's host checks, and the cell mode's: a row, column or
    tree row outside the sources, or sources too small for k, raise before
    anything is gathered (``gather_cells`` checks before it picks a path);
    the C entries refuse a layout past their sources."""
    rng = np.random.default_rng(9)
    entry = _random_entry(rng, 2)
    sources = entry.gather_sources()
    items = device_plane.proof_items(2, [(3, 3)])
    nbytes = device_plane._cell_layout(2).cell_bytes
    for col, value in [(1, 4), (2, 9), (0, len(sources)), (3, nbytes)]:
        bad = items.copy()
        bad[-1, col] = value
        with pytest.raises(ValueError):
            gather.das_proof_gather(sources, bad, nbytes)
    with pytest.raises(ValueError):
        gather.das_proof_gather(sources, items.astype(np.int64), nbytes)
    for coords, trees in [([(4, 0)], None), ([(0, 4)], None), ([(-1, 0)], None),
                          ([(0, -1)], None), ([(1, 1)], [4]), ([(1, 1)], [-1])]:
        with pytest.raises(ValueError):
            device_plane.gather_cells(2, sources, coords, trees)
    with pytest.raises(ValueError, match="does not fit"):
        device_plane.gather_cells(4, sources, [(0, 0)])  # an entry of k = 2 read as k = 4
    small = sources[:-1] + [device_plane.eds_source(entry.eds[:2, :2].contiguous())]
    with pytest.raises(ValueError, match="fewer than"):
        device_plane.gather_cells(2, small, [(0, 0)])
    lay = device_plane._cell_layout(2)
    cells = device_plane.cell_table([(0, 0)])
    out = _aligned(np.zeros(lay.cell_bytes, dtype=np.uint8))
    table = _source_table(sources)
    for bad in (lay._replace(share=len(sources)), lay._replace(aunt0=len(sources) - 1),
                lay._replace(n_sib=0)):
        assert twin.twin_das_cell_gather(_ptr(table), len(sources), *bad, _ptr(cells), 1,
                                         _ptr(out)) == 1
    assert twin.twin_das_proof_gather(_ptr(table), 0, _ptr(items), len(items), _ptr(out)) == 1


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
@pytest.mark.parametrize("k", [2, 8, 128, 1, 4, 16, 32, 64])
def test_twin_rs_decode_matrices_matches_plain(twin, codec, k):
    """K8a's blocks (tables and points staged, the sums by groups of 4
    lanes, D by runs of min(16, k) bytes) against the plain twin and JAX's
    ``_decode_matrices_dev``: every known position is also a destination,
    so every axis has one-hot rows; one axis has a repeated point (the raw
    log[0] rule of the denominators); one block of one axis each, as the C
    entry picks at these n, and blocks of 2 and of 128 / k axes."""
    rng = np.random.default_rng(810 + k)
    n = 5
    known = np.stack([rng.permutation(2 * k)[:k] for _ in range(n)]).astype(np.uint8)
    known[0] = np.arange(k)  # the first k positions, as fraud detection asks
    if k > 1:
        known[1, 1] = known[1, 0]  # two points coincide
    gexp, glog = _tables(codec)
    xor_const = k if codec == gf256.CODEC_LEOPARD else 0
    want = rs._decode_matrices_dev(torch.from_numpy(known), k, codec).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(jrs._decode_matrices_dev(jrs.jnp.asarray(known), k, codec)))
    D = _aligned(np.zeros((n, 2 * k, k), dtype=np.uint8))
    twin.twin_rs_decode_matrices(_ptr(known), _ptr(D), _ptr(gexp), _ptr(glog), n, k, xor_const)
    np.testing.assert_array_equal(D, want)
    for apb in sorted({2, 128 // k} - {1}):
        D[:] = 0
        rc = twin.twin_rs_decode_matrices_grouped(_ptr(known), _ptr(D), _ptr(gexp), _ptr(glog),
                                                  n, k, xor_const, apb)
        assert rc == (0 if apb * k <= 128 else 1)
        if rc == 0:
            np.testing.assert_array_equal(D, want, err_msg=f"{apb} axes a block")


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


@pytest.mark.parametrize("R", [1, 2, 4, 8])
def test_twin_xor_reduce_slabs_matches_plain(twin, R):
    """K9b in one launch over every destination shard, reading slab d of
    each peer's partial in place: batches of nb = 3 make each slab three
    runs, one partial row apart.  Against the plain version over the same
    slabs and numpy."""
    rng = np.random.default_rng(903 + R)
    nb, m, W = 3, 2, 1024
    partials = [_aligned(rng.integers(0, 256, (nb, R * m, W), dtype=np.uint8)) for _ in range(R)]
    outs = _aligned(np.zeros((R, nb, m, W), dtype=np.uint8))
    peers = np.array([p.ctypes.data for p in partials], dtype=np.int64)
    dsts = np.array([outs[d].ctypes.data for d in range(R)], dtype=np.int64)
    offs = np.arange(R, dtype=np.int64) * m * W
    assert twin.twin_xor_reduce_scatter(_ptr(peers), R, _ptr(dsts), _ptr(offs), R, m * W, nb,
                                        R * m * W) == 0
    full = np.bitwise_xor.reduce(np.stack(partials), axis=0)
    for d in range(R):
        slabs = torch.stack([torch.from_numpy(p[:, d * m : (d + 1) * m]) for p in partials])
        np.testing.assert_array_equal(outs[d], rs.xor_reduce_slabs_plain(slabs).numpy())
        np.testing.assert_array_equal(outs[d], full[:, d * m : (d + 1) * m])


def test_xor_reduce_scatter_refuses_unsupported_shards(twin):
    """K9b takes R in {1, 2, 4, 8} (a template instance each): any other R
    raises in the wrapper and is refused by the C entry, as are slabs off
    a 16-byte boundary."""
    parts = [torch.zeros((3, 64), dtype=torch.uint8) for _ in range(3)]
    with pytest.raises(ValueError, match="R in"):
        rs.xor_reduce_scatter_cuda(parts, [0], [torch.zeros((1, 64), dtype=torch.uint8)], 0)
    with pytest.raises(ValueError, match="does not split"):
        rs.xor_reduce_scatter_plain(parts[:2], [0], [torch.zeros((1, 64), dtype=torch.uint8)], 0)
    a = _aligned(np.zeros(1024, dtype=np.uint8))
    peers = np.full(16, a.ctypes.data, dtype=np.int64)
    dsts = np.array([a.ctypes.data], dtype=np.int64)
    offs = np.zeros(1, dtype=np.int64)
    for R in (3, 5, 16, 0):
        assert twin.twin_xor_reduce_scatter(_ptr(peers), R, _ptr(dsts), _ptr(offs), 1, 64, 1, 0) == 1
    peers[1] += 8  # a partial off a 16-byte boundary
    assert twin.twin_xor_reduce_scatter(_ptr(peers), 2, _ptr(dsts), _ptr(offs), 1, 64, 1, 0) == 1
    assert twin.twin_xor_reduce_scatter(_ptr(peers), 1, _ptr(dsts), _ptr(offs), 1, 64, 1, 0) == 0


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


@pytest.mark.parametrize("R", [2, 8])
def test_twin_runs_the_sharded_card_path(twin, monkeypatch, R):
    """The sharded extension's card path (parallel/sharded.py with every
    wrapper's CUDA branch: its strides, windows, out= views and launch
    arguments) on CPU tensors, each launch going to the g++ twin of its C
    entry: the same EDS and DAH as the plain single-device path."""
    from celestia_tpu_torch.da import dah
    from celestia_tpu_torch.parallel import collectives, sharded

    codec, k = gf256.CODEC_LEOPARD, 8
    sq = _random_eds(np.random.default_rng(904 + R), k)[:k, :k].copy()
    eds_1, hdr_1 = dah.extend_and_header(sq, device="cpu")
    launched = route_launches_to_twin(monkeypatch, twin)

    def coefficients(k, j0, n_in, codec, device):
        E = gf256.encode_matrix(k, codec)[:, j0 : j0 + n_in]
        return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8))
                     for a in (E, *gf256.field_tables(codec)))

    monkeypatch.setattr(rs, "extend_rows", rs.extend_rows_cuda)
    monkeypatch.setattr(rs, "partial_coefficients", coefficients)
    monkeypatch.setattr(rs, "col_parity_partial", lambda top, c: rs.col_parity_partial_cuda(top, *c))
    monkeypatch.setattr(rs, "xor_reduce_scatter", rs.xor_reduce_scatter_cuda)
    # sharded.py caches each mesh's K9a coefficients: neither the plain
    # path's form, cached by an earlier test in this process, nor this
    # test's card form may cross the test's edges
    sharded._FN_CACHE.clear()
    try:
        with pinned_codec(codec):
            collectives.reset_staged_bytes()
            eds, hdr = sharded.extend_and_header_sharded(sq, sharded.make_mesh(["cpu"] * R))
    finally:
        sharded._FN_CACHE.clear()
    np.testing.assert_array_equal(eds.shares, eds_1.shares)
    assert hdr == hdr_1
    # one launch per shard of the row pass and K9a, one K9b launch for the
    # device (every shard's slabs read in place: nothing staged), two K2
    # windows per shard, K3: one launch for every row-tree level and one for
    # every column-subtree level per shard (none at k/R = 1), then one for
    # the log2(2R) finishing levels on the one device; one K4 launch from
    # the axis roots (no K1)
    assert collectives.staged_bytes() == 0
    assert launched == {
        "rs_extend": R, "rs_col_parity_partial": R, "xor_reduce_slabs": 1,
        "nmt_leaf_digests": 2 * R,
        "nmt_combine_level": R * (1 + (k // R > 1)) + 1,
        "rfc6962_root": 1,
    }


# ---------------------------------------------------------------------------
# K2 and K3 as blocks (csrc/nmt.cuh): every level of a tree set in one
# launch, against the JAX package and the plain twins
# ---------------------------------------------------------------------------

_D = 90


def _lg(n: int) -> int:
    return n.bit_length() - 1


@pytest.fixture(scope="module")
def jax_eds_levels():
    """JAX's level stacks of the 4k trees of an EDS (``nmt_level_stack``
    over ``eds_prefixed_leaves``): [(2, 2k, 2k, 90), (2, 2k, k, 90), ...],
    compiled once per k at LLVM optimisation level 0 (the same bytes)."""
    compiled = {}

    def levels(eds: np.ndarray) -> list:
        n2 = eds.shape[0]
        if n2 not in compiled:
            fn = jax.jit(lambda e: jnmt.nmt_level_stack(jnmt.eds_prefixed_leaves(e)))
            compiled[n2] = fn.lower(eds).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return [np.asarray(lv) for lv in compiled[n2](eds)]

    return levels


def _split_packed(packed: np.ndarray, ntrees: int, m: int, n_levels: int) -> list:
    """The levels of K3's packed output: level j is (ntrees, m >> j, 90)."""
    out, off = [], 0
    for j in range(1, n_levels + 1):
        size = ntrees * (m >> j) * _D
        out.append(packed[off : off + size].reshape(ntrees, m >> j, _D))
        off += size
    assert off == packed.size
    return out


def _twin_grid_levels(twin, grids: np.ndarray, n_levels: int) -> list:
    """K3 over the 4k trees of each leaf grid (n, 2k, 2k, 90): rows by the
    first stride set, columns by the second, groups of 4k trees a grid."""
    n, n2 = grids.shape[0], grids.shape[1]
    ntrees = n * 2 * n2
    packed = np.zeros(ntrees * (n2 - (n2 >> n_levels)) * _D, dtype=np.uint8)
    rc = twin.twin_nmt_reduce_levels(_ptr(grids), _ptr(packed), ntrees, n2, n_levels, n2,
                                     n2 * _D, _D, _D, n2 * _D, 2 * n2, n2 * n2 * _D)
    assert rc == 0
    return [lv.reshape(n, 2 * n2, -1, _D) for lv in _split_packed(packed, ntrees, n2, n_levels)]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_twin_k2_k3_blocks_match_jax_level_stack(twin, jax_eds_levels, k):
    """K2's blocks hash the leaf grid and one K3 launch gives every level
    of all 4k trees, rows and columns, byte-equal to JAX's level stack and
    to the plain twins."""
    rng = np.random.default_rng(1400 + k)
    eds = _random_eds(rng, k)
    n2 = 2 * k
    want = jax_eds_levels(eds)
    grid = np.zeros((n2, n2, _D), dtype=np.uint8)
    assert twin.twin_nmt_leaf_digests(_ptr(eds), _ptr(grid), n2) == 0
    np.testing.assert_array_equal(grid, want[0][0])
    np.testing.assert_array_equal(grid.transpose(1, 0, 2), want[0][1])
    got = _twin_grid_levels(twin, grid[None], _lg(n2))
    plain = nmt.grid_levels_plain(torch.from_numpy(grid))
    assert len(got) == len(want) - 1 == len(plain)
    for j, (g, w, p) in enumerate(zip(got, want[1:], plain), 1):
        np.testing.assert_array_equal(g[0], w.reshape(2 * n2, n2 >> j, _D), err_msg=f"level {j}")
        np.testing.assert_array_equal(g[0], p.numpy(), err_msg=f"level {j}")


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_twin_k3_batch_of_grids_and_partial_reductions(twin, k):
    """The catch-up batch (groups of 4k trees, 3 grids) to the roots,
    against the JAX package's roots of each EDS, and every partial
    reduction (n_levels < log2 2k) against the full one's first levels."""
    rng = np.random.default_rng(1500 + k)
    eds = np.stack([_random_eds(rng, k) for _ in range(3)])
    n2 = 2 * k
    grids = np.zeros((3, n2, n2, _D), dtype=np.uint8)
    assert twin.twin_nmt_leaf_digests_batched(_ptr(eds), _ptr(grids), n2, 3) == 0
    full = _twin_grid_levels(twin, grids, _lg(n2))
    for b in range(3):
        roots = full[-1][b, :, 0].reshape(2, n2, _D)
        np.testing.assert_array_equal(roots, jnmt.eds_nmt_roots_host(eds[b]))
    for n_levels in range(1, _lg(n2)):
        part = _twin_grid_levels(twin, grids, n_levels)
        assert len(part) == n_levels
        for a, b in zip(part, full):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,R", [(2, 2), (8, 2), (8, 4), (16, 4), (16, 2)])
def test_twin_k3_column_subtrees_and_finish(twin, k, R):
    """K9's column trees on the twin: the column subtrees of every shard's
    top and bottom windows (trees down the columns of a (k/R, 2k) leaf
    grid, 2 windows a launch; none at k/R = 1), then the finish over the 2R
    gathered nodes a column, one launch each: the column roots of the
    whole EDS."""
    rng = np.random.default_rng(1600 + k + R)
    eds = _random_eds(rng, k)
    n2, rows = 2 * k, k // R
    grid = np.zeros((n2, n2, _D), dtype=np.uint8)
    assert twin.twin_nmt_leaf_digests(_ptr(eds), _ptr(grid), n2) == 0
    nodes = []
    for d in range(R):
        win = np.ascontiguousarray(np.stack([grid[d * rows : (d + 1) * rows],
                                             grid[k + d * rows : k + (d + 1) * rows]]))
        if rows == 1:  # a subtree of one leaf: no level, nothing launched
            nodes.append(win[:, 0])
            continue
        packed = np.zeros(2 * n2 * (rows - 1) * _D, dtype=np.uint8)
        assert twin.twin_nmt_reduce_levels(_ptr(win), _ptr(packed), 2 * n2, rows, _lg(rows), n2,
                                           _D, n2 * _D, _D, n2 * _D, n2, rows * n2 * _D) == 0
        levels = _split_packed(packed, 2 * n2, rows, _lg(rows))
        plain = nmt.column_levels_plain(torch.from_numpy(win))
        for a, b in zip(levels, plain):
            np.testing.assert_array_equal(a.reshape(2, n2, -1, _D), b.numpy())
        nodes.append(levels[-1][:, 0].reshape(2, n2, _D))
    gathered = np.ascontiguousarray(np.stack(nodes, axis=1).reshape(2 * R, n2, _D))
    packed = np.zeros(n2 * (2 * R - 1) * _D, dtype=np.uint8)
    assert twin.twin_nmt_reduce_levels(_ptr(gathered), _ptr(packed), n2, 2 * R, _lg(2 * R), n2,
                                       _D, n2 * _D, _D, n2 * _D, n2, 0) == 0
    roots = _split_packed(packed, n2, 2 * R, _lg(2 * R))[-1][:, 0]
    np.testing.assert_array_equal(roots, jnmt.eds_nmt_roots_host(eds)[1])


@pytest.mark.parametrize("k,window", [(2, (1, 3)), (4, (3, 2)), (8, (5, 7)), (8, (9, 5))])
def test_twin_k2_odd_row_windows_match_jax(twin, jax_eds_levels, k, window):
    """K2's blocks over a window that starts at an odd EDS row (a batch of
    two EDSs' windows): the Q0 rule at the rows' EDS coordinates, against
    the JAX package's leaf digests of those rows."""
    row0, n_rows = window
    n2 = 2 * k
    rng = np.random.default_rng(1700 + k + row0)
    eds = np.stack([_random_eds(rng, k) for _ in range(2)])
    rows = np.ascontiguousarray(eds[:, row0 : row0 + n_rows])
    out = np.zeros((2, n_rows, n2, _D), dtype=np.uint8)
    assert twin.twin_nmt_leaf_digests_window(_ptr(rows), _ptr(out), n2, 2, row0, n_rows) == 0
    for b in range(2):
        want = jax_eds_levels(eds[b])[0][0, row0 : row0 + n_rows]
        np.testing.assert_array_equal(out[b], want)
    np.testing.assert_array_equal(out, nmt.leaf_digests_window_plain(torch.from_numpy(rows),
                                                                     row0).numpy())


def test_twin_k3_refuses_what_it_cannot_take(twin):
    """The C entries' refusals: m not a power of two or above 512, levels
    outside 1 .. log2 m, trees that interleave neither by rows nor by columns
    several to a block, odd strides or addresses; K2 off a 16-byte
    boundary."""
    buf = np.zeros(1 << 16, dtype=np.uint8)
    out = np.zeros(1 << 16, dtype=np.uint8)
    p, o = _ptr(buf), _ptr(out)
    ok = (p, o, 4, 8, 3, 4, 8 * _D, _D, 8 * _D, _D, 4, 0)
    assert twin.twin_nmt_reduce_levels(*ok) == 0
    bad = [
        (p, o, 4, 6, 1, 4, 6 * _D, _D, 6 * _D, _D, 4, 0),       # m = 6
        (p, o, 4, 8, 0, 4, 8 * _D, _D, 8 * _D, _D, 4, 0),       # no level
        (p, o, 4, 8, 4, 4, 8 * _D, _D, 8 * _D, _D, 4, 0),       # 4 levels of 8 leaves
        (p, o, 2, 1024, 10, 2, 0, _D, 0, _D, 2, 0),             # 10 levels in one launch
        (p, o, 1, 1024, 1, 1, 0, _D, 0, _D, 1, 0),              # 1,024 leaves: above a block
        (p, o, 4, 8, 1, 4, 8 * _D, 2 * _D, 8 * _D, _D, 4, 0),   # strided both ways
        (p, o, 4, 8, 1, 4, 8 * _D + 1, _D, 8 * _D, _D, 4, 0),   # odd stride
        (p + 1, o, 4, 8, 1, 4, 8 * _D, _D, 8 * _D, _D, 4, 0),   # odd address
        (p, o, 4, 8, 1, 4, 8 * _D, _D, 8 * _D, _D, 3, 0),       # groups do not divide
    ]
    for args in bad:
        assert twin.twin_nmt_reduce_levels(*args) == 1, args
    shares = np.zeros(4 * 4 * 512 + 16, dtype=np.uint8)
    digests = np.zeros(4 * 4 * _D, dtype=np.uint8)
    base = _ptr(shares)
    assert twin.twin_nmt_leaf_digests_window(base, _ptr(digests), 4, 1, 0, 4) == 0
    assert twin.twin_nmt_leaf_digests_window(base + 8, _ptr(digests), 4, 1, 0, 4) == 1
    assert twin.twin_nmt_leaf_digests_window(base, _ptr(digests), 6, 1, 0, 4) == 1


@pytest.mark.parametrize("k", [1, 2, 8])
def test_twin_runs_the_card_nmt_paths(twin, monkeypatch, jax_eds_levels, k):
    """The wrappers' CUDA branches on the twin: K7a's levels (one K2, one
    K3 and one K4 launch, the levels views of one packed buffer, the plane
    entry's bytes exact), the data root's wrappers (one K4 launch each,
    from the leaves or over given hashes, a batch of trees), the catch-up
    roots of a batch, a proof's row level stack (K2's row-set mode and K3;
    K1 and K3 over given prefixed leaves) and the one-level functions,
    against JAX and the plain path."""
    rng = np.random.default_rng(1800 + k)
    eds = _random_eds(rng, k)
    n2 = 2 * k
    want = jax_eds_levels(eds)
    plain = device_plane._extend_levels(torch.from_numpy(eds[:k, :k].copy()))
    launched = route_launches_to_twin(monkeypatch, twin)
    sq = torch.from_numpy(eds[:k, :k].copy())
    _, grid, levels, tree = device_plane._extend_levels(sq)
    assert launched == {"nmt_leaf_digests": 1, "nmt_combine_level": 1, "rfc6962_root": 1}
    np.testing.assert_array_equal(grid.numpy(), want[0][0])
    base = levels[0].untyped_storage().data_ptr()
    for j, (lv, w, p) in enumerate(zip(levels, want[1:], plain[2]), 1):
        np.testing.assert_array_equal(lv.numpy(), w.reshape(2 * n2, n2 >> j, _D))
        np.testing.assert_array_equal(lv.numpy(), p.numpy())
        assert lv.untyped_storage().data_ptr() == base  # one packed buffer
    np.testing.assert_array_equal(tree.numpy(), plain[3].numpy())
    entry = device_plane.DevicePlaneEntry(k, bytes(32), torch.from_numpy(eds), grid, levels, tree)
    assert entry.nbytes == eds.nbytes + grid.numel() + levels[0].untyped_storage().nbytes() \
        + tree.numel()
    # the data root's wrappers: one K4 launch each, no K1
    launched.clear()
    roots = torch.from_numpy(rng.integers(0, 256, (3, 4 * k, _D), dtype=np.uint8))
    plain_tree = nmt.rfc6962_levels_plain(roots)
    np.testing.assert_array_equal(nmt.rfc6962_levels(roots).numpy(), plain_tree.numpy())
    np.testing.assert_array_equal(nmt.rfc6962_root_pow2(roots).numpy(), plain_tree[:, -1].numpy())
    for g, w in zip(nmt.rfc6962_level_stack(roots), nmt.rfc6962_level_stack_plain(roots)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    hashes = nmt.rfc6962_leaf_hashes_plain(roots)
    np.testing.assert_array_equal(nmt.rfc6962_tree_levels(hashes).numpy(), plain_tree.numpy())
    assert launched == {"rfc6962_root": 4}
    flat = torch.zeros(4 * k * _D + 1, dtype=torch.uint8)
    with pytest.raises(ValueError, match="odd address"):
        nmt.rfc6962_levels(flat[1:].view(4 * k, _D))
    assert launched == {"rfc6962_root": 4}
    # catch-up: a batch of 2 EDSs, one K2 and one K3 launch
    launched.clear()
    batch = np.stack([eds, _random_eds(rng, k)])
    roots = nmt.eds_nmt_roots(torch.from_numpy(batch)).numpy()
    assert launched == {"nmt_leaf_digests": 1, "nmt_combine_level": 1}
    for b in range(2):
        np.testing.assert_array_equal(roots[b], jnmt.eds_nmt_roots_host(batch[b]))
    # a proof's rows: K2's row-set mode from the EDS rows, one K3 launch
    launched.clear()
    stack = nmt.eds_row_level_stack(torch.from_numpy(eds), range(min(3, n2)))
    assert launched == {"nmt_leaf_digests": 1, "nmt_combine_level": 1}
    for j, (g, w) in enumerate(zip(stack, want)):
        np.testing.assert_array_equal(g.numpy(), w[0, : min(3, n2)], err_msg=f"level {j}")
    # any prefixed leaves: K1 leaf digests, one K3 launch
    launched.clear()
    leaves = nmt.eds_row_leaves(torch.from_numpy(eds), range(min(3, n2)))
    for j, (g, w) in enumerate(zip(nmt.nmt_level_stack(leaves), want)):
        np.testing.assert_array_equal(g.numpy(), w[0, : min(3, n2)], err_msg=f"level {j}")
    assert launched == {"sha256_batch": 1, "nmt_combine_level": 1}
    # the one-level functions are K3 with one level
    launched.clear()
    nodes = want[0][0]
    np.testing.assert_array_equal(nmt.combine_level(torch.from_numpy(nodes.copy())).numpy(),
                                  want[1][0])
    np.testing.assert_array_equal(nmt.combine_grid(torch.from_numpy(grid.numpy())).numpy(),
                                  want[1].reshape(2 * n2, k, _D))
    np.testing.assert_array_equal(nmt.combine_columns(torch.from_numpy(grid.numpy())).numpy(),
                                  want[1][1])
    assert launched == {"nmt_combine_level": 3}


def test_twin_k3_trees_taller_than_a_block(twin, monkeypatch):
    """A block holds one tree of 512 leaves at most (an EDS axis has 256):
    trees of 512 give every level equal to the plain twin's in one launch,
    by rows and by columns; trees of 1,024 are refused by the wrappers
    before any launch, and by the C entry."""
    rng = np.random.default_rng(1900)
    nodes = rng.integers(0, 256, (2, 512, _D), dtype=np.uint8)
    nodes[:, 1::3, :29] = 0xFF  # parity right children for IgnoreMaxNamespace
    want = nmt.reduce_levels_plain(torch.from_numpy(nodes))
    launched = route_launches_to_twin(monkeypatch, twin)
    got = nmt.reduce_levels(torch.from_numpy(nodes))
    assert launched == {"nmt_combine_level": 1}
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    cols = np.ascontiguousarray(nodes.transpose(1, 0, 2))  # (512, 2, 90): 2 column trees
    got = nmt.column_levels(torch.from_numpy(cols))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    tall = torch.zeros(2, 1024, _D, dtype=torch.uint8)
    launched.clear()
    for fn in (nmt.reduce_levels, lambda t: nmt.column_levels(t.transpose(0, 1).contiguous())):
        with pytest.raises(ValueError, match="at most 512 leaves"):
            fn(tall)
    assert launched == {}
    out = np.zeros(2 * 1023 * _D, dtype=np.uint8)
    assert twin.twin_nmt_reduce_levels(_ptr(tall.numpy()), _ptr(out), 2, 1024, 1, 2,
                                       1024 * _D, _D, 1024 * _D, _D, 2, 0) == 1
    with pytest.raises(ValueError, match="16-byte boundary"):
        flat = torch.zeros(4 * 4 * 512 + 8, dtype=torch.uint8)
        nmt.leaf_digests_window(flat[8:].view(4, 4, 512), 0)
