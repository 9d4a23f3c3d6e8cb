"""K3, the NMT level reduction (``csrc/nmt.cu`` ``ctt_nmt_reduce_levels``),
on its word-plane node path, through the g++ twin (``csrc/cpu_twin.cpp``),
which runs the kernel's own steps block by block: the staging of level 0
from each run's aligned 16-byte cover, the unpack into word planes, the
parent's pair loads and PRMT-built message, the IgnoreMaxNamespace test on
words, the stores of finished levels as 16-byte words with 2-byte ends,
and the levels warp 0 runs alone; the tile the launch picks from the
card's SM count changes no byte.  Every case is byte-equal to the JAX
package's ``combine_level`` chain (or ``eds_nmt_roots`` /
``nmt_level_stack``) on the same seeded numpy inputs, and writes no byte
outside its packed output.
"""

import numpy as np
import pytest
import torch

import jax

from celestia_tpu.ops import nmt as jnmt
from _torch_common import twin  # noqa: F401 (fixture)
from celestia_tpu_torch.ops import rs

_D = 90
_GUARD = 0xA5  # the output buffer's bytes outside the packed levels
_PARITY = np.full(29, 0xFF, dtype=np.uint8)

_COMBINE = {}  # pairs a batch -> JAX's combine_level, compiled once


def _jax_combine(nodes: np.ndarray) -> np.ndarray:
    """JAX's ``combine_level`` over uint8[..., m, 90]: every pair of the
    level in one batch, padded to a power of two so that each size
    compiles once (at optimisation level 0: the same bytes)."""
    lead, m = nodes.shape[:-2], nodes.shape[-2]
    pairs = nodes.reshape(-1, 2, _D)
    size = 1 << max(0, (len(pairs) - 1).bit_length())
    if size not in _COMBINE:
        _COMBINE[size] = jax.jit(jnmt.combine_level).lower(
            np.zeros((size, 2, _D), np.uint8)).compile(
            compiler_options={"xla_backend_optimization_level": 0})
    padded = np.zeros((size, 2, _D), np.uint8)
    padded[: len(pairs)] = pairs
    return np.asarray(_COMBINE[size](padded))[: len(pairs), 0].reshape(lead + (m // 2, _D))


def _jax_levels(nodes: np.ndarray, n_levels=None) -> list:
    """Levels 1 .. n_levels of JAX's reduction of the trees uint8[..., m, 90]."""
    n_levels = nodes.shape[-2].bit_length() - 1 if n_levels is None else n_levels
    out = []
    for _ in range(n_levels):
        nodes = _jax_combine(nodes)
        out.append(nodes)
    return out


def _digests(rng, shape, parity_every=3) -> np.ndarray:
    """Seeded 90-byte nodes with ordered namespace ranges; every
    ``parity_every``-th node carries the parity namespace as its min and
    max, as the EDS's parity leaves do."""
    d = rng.integers(0, 256, shape + (_D,), dtype=np.uint8)
    d[..., :58] = np.sort(d[..., :58], axis=-1)
    flat = d.reshape(-1, _D)
    flat[::parity_every, :58] = 0xFF
    return d


def _buffer(nbytes: int, skew: int, fill: int = 0):
    """A buffer whose byte ``skew`` lies on a 16-byte boundary + skew, and
    that address."""
    buf = np.full(nbytes + 64, fill, dtype=np.uint8)
    off = (-buf.ctypes.data) % 16 + skew
    return buf, off


def _place(nodes: np.ndarray, ts: int, ns: int, skew: int):
    """The trees uint8[T, m, 90] laid out with node (t, i) at t*ts + i*ns from
    a 16-byte boundary + skew; returns the buffer and the input address."""
    T, m = nodes.shape[:2]
    span = (T - 1) * ts + (m - 1) * ns + _D
    buf, off = _buffer(span, skew)
    at = off + np.arange(T)[:, None, None] * ts + np.arange(m)[None, :, None] * ns \
        + np.arange(_D)[None, None, :]
    buf[at] = nodes
    return buf, buf.ctypes.data + off


def _reduce(twin, in_ptr: int, ntrees: int, m: int, n_levels: int, split: int, sets,
            group=None, out_skew: int = 0) -> list:
    """K3 on the twin; the packed output (at a 16-byte boundary + out_skew,
    guarded on both sides) split into its levels uint8[ntrees, m >> j, 90]."""
    (ts0, ns0), (ts1, ns1) = sets
    tpb, bs = group if group is not None else (ntrees, 0)
    size = ntrees * (m - (m >> n_levels)) * _D
    buf, off = _buffer(size + 32, 16 + out_skew, fill=_GUARD)
    rc = twin.twin_nmt_reduce_levels(in_ptr, buf.ctypes.data + off, ntrees, m, n_levels, split,
                                     ts0, ns0, ts1, ns1, tpb, bs)
    assert rc == 0
    assert (buf[:off] == _GUARD).all() and (buf[off + size :] == _GUARD).all(), \
        "K3 wrote outside its packed output"
    packed, levels, at = buf[off : off + size], [], 0
    for j in range(1, n_levels + 1):
        n = ntrees * (m >> j) * _D
        levels.append(packed[at : at + n].reshape(ntrees, m >> j, _D))
        at += n
    return levels


def _assert_levels(got: list, want: list, what: str) -> None:
    assert len(got) == len(want), what
    for j, (g, w) in enumerate(zip(got, want), 1):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}, level {j}")


@pytest.mark.parametrize("skew", range(0, 16, 2))
def test_k3_planes_from_every_two_byte_alignment(twin, skew):
    """Level 0 unpacked into planes from inputs at every 2-byte alignment
    of a 16-byte word: adjacent row trees (one run), row trees with gaps
    (a run each, each at its own alignment) and column trees (a run a
    leaf, each at its own alignment); the output at another alignment, its
    first and last 16-byte words written in 2-byte stores."""
    rng = np.random.default_rng(1100 + skew)
    trees = _digests(rng, (6, 32))
    want = _jax_levels(trees)
    for what, ts, ns in (("rows, one run", 32 * _D, _D), ("rows with gaps", 32 * _D + 6, _D),
                         ("columns", _D, 6 * _D + 10)):
        buf, ptr = _place(trees, ts, ns, skew)
        got = _reduce(twin, ptr, 6, 32, 5, 6, ((ts, ns), (ts, ns)), out_skew=(3 * skew + 2) % 16)
        _assert_levels(got, want, f"{what} at skew {skew}")


def _rows_and_columns(twin, m: int, rows: int, seed: int) -> None:
    """K3 over the rows and over the columns of a (rows, m) grid of nodes,
    each set in one launch, against JAX."""
    rng = np.random.default_rng(seed)
    grid = _digests(rng, (rows, m))  # rows trees of m leaves; columns: m trees of rows
    cols_m = 1 << (rows.bit_length() - 1)  # the column trees: the first cols_m rows
    sub = np.ascontiguousarray(grid[:cols_m])
    buf, ptr = _place(grid.reshape(1, -1, _D), 0, _D, 2)  # packed, 2 bytes into a word
    got = _reduce(twin, ptr, rows, m, m.bit_length() - 1, rows,
                  ((m * _D, _D), (m * _D, _D)))
    _assert_levels(got, _jax_levels(grid), f"{rows} row trees of {m}")
    if cols_m >= 2:
        cols = _reduce(twin, ptr, m, cols_m, cols_m.bit_length() - 1, 0,
                       ((m * _D, _D), (_D, m * _D)))
        _assert_levels(cols, _jax_levels(sub.transpose(1, 0, 2)), f"{m} column trees of {cols_m}")


@pytest.mark.parametrize("m,rows", [(512, 2), (256, 5), (128, 6), (64, 19), (8, 130), (2, 300)])
def test_k3_tiles_of_one_two_and_many_trees(twin, m, rows):
    """The rows and the columns of a (rows, m) grid of nodes, each set in
    one launch on the H100's 132 SMs: a block holds one tree of 512 leaves
    (a tile of 512), one of 256 (a tile of 256), two of 128 or 256 / m, the
    last block of each set partial; the column trees' tiles are runs of one
    node (one tree a block) up to runs of many adjacent columns."""
    _rows_and_columns(twin, m, rows, 1200 + m)


@pytest.mark.parametrize("sms", [1, 3, 16, 1 << 20])
def test_k3_tile_follows_the_sm_count(twin, sms):
    """The tile (256, 512 or 1,024 leaves) is picked from the launch's
    leaves over the card's SMs: on 1 or 3 SMs every launch here takes tiles
    of 1,024 (four trees of 256 a block, two of 512, 128 of 8), on 16 the
    middle sizes, on very many the smallest that holds a tree; the bytes
    never change."""
    twin.twin_nmt_set_sm_count(sms)
    try:
        for m, rows in ((256, 5), (512, 2), (64, 19), (8, 130)):
            _rows_and_columns(twin, m, rows, 1250 + m + sms % 97)
    finally:
        twin.twin_nmt_set_sm_count(132)


@pytest.mark.parametrize("k", [128, 4])
def test_k3_grid_rows_and_columns_match_jax(twin, k):
    """A leaf grid's 4k trees in one launch (rows by stride set 0, columns
    by set 1): at k = 128 four trees a block (a tile of 1,024), a column
    tile 256 runs of four adjacent columns; against JAX's reduction of the
    rows and the columns."""
    rng = np.random.default_rng(1300 + k)
    n2 = 2 * k
    grid = _digests(rng, (n2, n2))
    grid[k:, :, :58] = 0xFF  # the parity half, as the EDS's leaf grid has it
    grid[:, k:, :58] = 0xFF
    buf, ptr = _place(grid, n2 * _D, _D, 0)
    got = _reduce(twin, ptr, 2 * n2, n2, n2.bit_length() - 1, n2,
                  ((n2 * _D, _D), (_D, n2 * _D)))
    want = [np.concatenate([r, c]) for r, c in zip(_jax_levels(grid),
                                                   _jax_levels(grid.transpose(1, 0, 2)))]
    _assert_levels(got, want, f"k={k} grid")


@pytest.mark.parametrize("m", [2, 4, 8, 16, 32, 64, 128, 256, 512])
def test_k3_warp_alone_at_every_tree_height(twin, m):
    """The switch to warp 0 alone (at most 32 parents left): one tree of m
    leaves (warp 0 from the level with <= 32 parents on), a full block of
    the smallest tile (256 / m trees, one of 512), and a full block plus one
    tree (a second block of one tree), each against JAX."""
    rng = np.random.default_rng(1400 + m)
    per_block = max(1, 256 // m)
    for T in sorted({1, per_block, per_block + 1}):
        trees = _digests(rng, (T, m))
        buf, ptr = _place(trees, m * _D, _D, 4)
        got = _reduce(twin, ptr, T, m, m.bit_length() - 1, T, ((m * _D, _D), (m * _D, _D)),
                      out_skew=6)
        _assert_levels(got, _jax_levels(trees), f"{T} trees of {m}")


@pytest.mark.parametrize("n_levels", range(1, 9))
def test_k3_partial_reductions(twin, n_levels):
    """Levels 1 .. n_levels of 6 trees of 256 leaves, one a block (the
    block-wide levels only, or some of warp 0's too), equal to the first
    n_levels levels of JAX's reduction."""
    rng = np.random.default_rng(1500 + n_levels)
    trees = _digests(rng, (6, 256))
    buf, ptr = _place(trees, 256 * _D, _D, 10)
    got = _reduce(twin, ptr, 6, 256, n_levels, 6, ((256 * _D, _D), (256 * _D, _D)))
    _assert_levels(got, _jax_levels(trees, n_levels), f"{n_levels} levels")


@pytest.mark.parametrize("k", [2, 16])
def test_k3_batch_of_grids_matches_jax_eds_roots(twin, k):
    """The catch-up batch: 3 EDSs' leaf grids (the port's K2 twin) in one
    launch, groups of 4k trees a grid; every level against JAX's
    ``nmt_level_stack`` of each EDS and the roots against its
    ``eds_nmt_roots_host``."""
    rng = np.random.default_rng(1600 + k)
    n2 = 2 * k
    sq = rng.integers(0, 256, (3, k, k, 512), dtype=np.uint8)
    sq[..., :18] = 0
    sq[:, 0, -1, :29] = 0xFF  # a parity-namespace share inside Q0
    eds = np.stack([rs.extend_square(torch.from_numpy(s)).numpy() for s in sq])
    grids = np.zeros((3, n2, n2, _D), dtype=np.uint8)
    assert twin.twin_nmt_leaf_digests_batched(eds.ctypes.data, grids.ctypes.data, n2, 3) == 0
    buf, ptr = _place(grids.reshape(1, -1, _D), 0, _D, 8)
    got = _reduce(twin, ptr, 3 * 2 * n2, n2, n2.bit_length() - 1, n2,
                  ((n2 * _D, _D), (_D, n2 * _D)), group=(2 * n2, n2 * n2 * _D))
    stack = jax.jit(lambda e: jnmt.nmt_level_stack(jnmt.eds_prefixed_leaves(e))).lower(
        eds[0]).compile(compiler_options={"xla_backend_optimization_level": 0})
    for b in range(3):
        want = [np.asarray(lv) for lv in stack(eds[b])]
        np.testing.assert_array_equal(grids[b], want[0][0])
        for j, w in enumerate(want[1:], 1):
            np.testing.assert_array_equal(got[j - 1][b * 2 * n2 : (b + 1) * 2 * n2],
                                          w.reshape(2 * n2, n2 >> j, _D), err_msg=f"level {j}")
        np.testing.assert_array_equal(got[-1][b * 2 * n2 : (b + 1) * 2 * n2, 0],
                                      jnmt.eds_nmt_roots_host(eds[b]).reshape(2 * n2, _D))


@pytest.mark.parametrize("k,R", [(8, 2), (16, 4), (32, 8)])
def test_k3_column_subtrees_and_finish_match_jax(twin, k, R):
    """K9's column trees: each shard's top and bottom windows of a leaf grid
    reduced down their columns (2 windows a launch, groups of 2k columns),
    then the finish over the 2R subtree roots a column; every subtree level
    against JAX's reduction of the window's columns and the finish's roots
    against JAX's column roots of the grid."""
    rng = np.random.default_rng(1700 + k + R)
    n2, rows = 2 * k, k // R
    grid = _digests(rng, (n2, n2))
    tops = []
    for d in range(R):
        win = np.ascontiguousarray(np.stack([grid[d * rows : (d + 1) * rows],
                                             grid[k + d * rows : k + (d + 1) * rows]]))
        buf, ptr = _place(win.reshape(1, -1, _D), 0, _D, 2 * d % 16)
        got = _reduce(twin, ptr, 2 * n2, rows, rows.bit_length() - 1, n2,
                      ((_D, n2 * _D), (_D, n2 * _D)), group=(n2, rows * n2 * _D))
        want = [lv.reshape(2 * n2, rows >> j, _D) for j, lv in enumerate(
            _jax_levels(win.transpose(0, 2, 1, 3)), 1)]
        _assert_levels(got, want, f"shard {d}'s column subtrees")
        tops.append(got[-1][:, 0].reshape(2, n2, _D))
    gathered = np.ascontiguousarray(np.stack(tops, axis=1).reshape(2 * R, n2, _D))
    buf, ptr = _place(gathered.reshape(1, -1, _D), 0, _D, 0)
    fin = _reduce(twin, ptr, n2, 2 * R, (2 * R).bit_length() - 1, n2,
                  ((_D, n2 * _D), (_D, n2 * _D)))
    np.testing.assert_array_equal(fin[-1][:, 0], _jax_levels(grid.transpose(1, 0, 2))[-1][:, 0])


def test_k3_ignore_max_namespace_on_parity_leaves(twin):
    """IgnoreMaxNamespace as word compares: right children whose min is the
    parity namespace (the parent keeps l.max), and near misses that must
    take r.max -- the min's last byte (the top byte of word 7) or its first
    byte one short of 0xFF -- in every position of a tree, against JAX."""
    rng = np.random.default_rng(1800)
    trees = _digests(rng, (8, 64), parity_every=1000)
    flat = trees.reshape(-1, _D)
    flat[1::4, :58] = 0xFF                 # parity right children
    flat[3::8, :29] = 0xFF                 # the min parity, the max not
    flat[3::8, 29:58] = rng.integers(0, 256, (len(flat[3::8]), 29), dtype=np.uint8)
    flat[5::16, :29] = _PARITY
    flat[5::16, 28] = 0xFE                 # a near miss in word 7's top byte
    flat[7::16, :29] = _PARITY
    flat[7::16, 0] = 0xFE                  # a near miss in word 0
    buf, ptr = _place(trees, 64 * _D, _D, 14)
    got = _reduce(twin, ptr, 8, 64, 6, 8, ((64 * _D, _D), (64 * _D, _D)), out_skew=14)
    want = _jax_levels(trees)
    _assert_levels(got, want, "parity and near-miss right children")
    left, right = trees[:, 0::2], trees[:, 1::2]
    parity = (right[..., :29] == 0xFF).all(-1)
    assert parity.any() and (~parity).any()
    np.testing.assert_array_equal(got[0][..., 29:58],
                                  np.where(parity[..., None], left[..., 29:58], right[..., 29:58]))
