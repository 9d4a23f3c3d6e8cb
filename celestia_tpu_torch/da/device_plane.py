"""Device-resident DA plane: EDS, NMT levels and the root tree stay on the card.

Re-homed from ``celestia_tpu/da/device_plane.py``.  One composition
(:func:`_extend_levels`, the JAX package's ``_extend_levels_fn`` :169,
here K7a) takes the original square and leaves on its device the EDS,
every level of the 4k NMT axis trees and every level of the RFC-6962 tree
over the 4k axis roots:

    K5 rs_extend -> K2 nmt_leaf_digests -> K3 nmt_combine_level (one
    launch, every level kept) -> K4 rfc6962_root (one launch: the axis
    roots' leaf hashes and every level above them)

Only the 4k axis roots and the 32-byte data root cross to the host (one
copy), to build the DAH.  The tensors ride a :class:`DevicePlaneEntry`
parked in da/eds_cache.py under the data root, so DAS serving finds the
block warm: :func:`sample_proofs_batch` sends each cell's (row, tree_row,
col) to the card, and one launch of K7b ``das_proof_gather`` (its cell
mode) derives every proof-path item there and copies the shares, root
aunts and siblings into one buffer that the host fetches with one copy --
never a re-hash.  Proofs are byte-identical to the host
prover (da/das.py ``_sample_proof_uncached``).

The port runs the plane on every device (``device="cpu"`` runs the plain
twins), which is the JAX package's routing with an accelerator attached.
It keeps none of the JAX module's degradation ladder (``poison`` /
``clear_poison``), mode switch (``CELESTIA_TPU_DEVICE_PLANE``,
``forced``), buffer donation or devprof/tracing calls: a kernel, build or
gather that fails raises.  A block whose entry is not cached on the EDS's
device (evicted, never extended there) is served from the EDS:
:func:`sample_proofs_from_eds` rebuilds the touched rows' level stacks and
the root tree on the EDS's device and gathers with K7b; da/das.py keeps the
host prover for an EDS on the CPU only.

Layout.  The JAX entry holds NMT level ``j`` as uint8[2, 2k, 2k>>j, 90]
(axis 0: row trees, column trees).  The port keeps the leaf digests once,
as K2's (2k, 2k, 90) grid (column tree c's leaf r is grid[r, c]), and
level ``j >= 1`` as K3's uint8[4k, 2k>>j, 90] (trees 0..2k the rows), on
the card views of the one packed buffer K3 writes every level into;
:meth:`DevicePlaneEntry.level` gives the JAX layout.  The root-tree levels
are K4's packed uint8[2*4k - 1, 32] (leaf hashes first, the data root last).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from celestia_tpu_torch.appconsts import SHARE_SIZE as SHARE
from celestia_tpu_torch.ops import gather
from celestia_tpu_torch.ops import nmt as nmt_ops
from celestia_tpu_torch.ops import rs
from celestia_tpu_torch.utils.device import resolve_device

DIGEST = nmt_ops.NMT_DIGEST_SIZE  # 90
HASH = 32  # an RFC-6962 node


def _extend_levels(square: torch.Tensor):
    """K7a on the square's device: uint8[k, k, 512] ->
    (eds (2k, 2k, 512), grid (2k, 2k, 90), levels tuple of (4k, 2k>>j, 90)
    for j = 1..log2(2k), root tree (2*4k - 1, 32) packed)."""
    k = square.shape[0]
    eds = rs.extend_square(square)
    grid = nmt_ops.eds_leaf_digests(eds)
    levels = nmt_ops.grid_levels(grid)  # on the card: views of one K3 launch's packed output
    roots = levels[-1].reshape(4 * k, DIGEST)
    root_tree = nmt_ops.rfc6962_levels(roots)  # one K4 launch, axis roots to data root
    return eds, grid, tuple(levels), root_tree


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DevicePlaneEntry:
    """The tensors of one extended block, cached beside its data root: the
    EDS, the NMT leaf grid and upper levels, and the packed root tree, all
    on one device.  ``nbytes`` is computed from shapes -- weighing an entry
    never forces a transfer -- and counts what the port holds (the leaf
    digests once), so the same byte budget holds more port entries than
    JAX ones."""

    __slots__ = ("k", "data_root", "eds", "grid", "levels", "root_tree", "nbytes")

    def __init__(self, k, data_root, eds, grid, levels, root_tree):
        self.k = int(k)
        self.data_root = bytes(data_root)
        self.eds = eds
        self.grid = grid
        self.levels = tuple(levels)
        self.root_tree = root_tree
        self.nbytes = sum(_nbytes(t) for t in (eds, grid, *self.levels, root_tree))

    @property
    def device(self) -> torch.device:
        return self.eds.device

    @property
    def n_levels(self) -> int:
        """NMT levels, leaves to root: log2(2k) + 1."""
        return 1 + len(self.levels)

    def level(self, j: int) -> torch.Tensor:
        """NMT level ``j`` in the JAX layout, uint8[2, 2k, 2k>>j, 90]: a
        view for j >= 1, a copy for the leaf grid (j = 0)."""
        n2 = 2 * self.k
        if j == 0:
            return torch.stack([self.grid, self.grid.transpose(0, 1)])
        lv = self.levels[j - 1]
        return lv.view(2, n2, lv.shape[1], DIGEST)

    def root_levels(self) -> List[torch.Tensor]:
        """Views of the root-tree levels: (4k, 32), (2k, 32), ..., (1, 32)."""
        return nmt_ops.split_tree_levels(self.root_tree)

    def gather_sources(self) -> List[gather.GatherSource]:
        """K7b's sources, checked against the entry's own shapes and device:
        NMT level j is source j (row r = row tree r), root-tree level j is
        source n_levels + j, the EDS is the last."""
        k, n2 = self.k, 2 * self.k
        want = [(self.eds, (n2, n2, SHARE)), (self.grid, (n2, n2, DIGEST))]
        m = n2
        for lv in self.levels:
            m //= 2
            want.append((lv, (2 * n2, m, DIGEST)))
        want.append((self.root_tree, (2 * 4 * k - 1, HASH)))
        if m != 1:
            raise ValueError(f"entry for k={k} holds {len(self.levels)} NMT levels above the leaves")
        for t, shape in want:
            if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
                got = tuple(t.shape) if isinstance(t, torch.Tensor) else type(t).__name__
                raise ValueError(f"malformed device-plane entry: {got}, expected {shape}")
            if t.device != self.device:
                raise ValueError(f"device-plane entry spans {t.device} and {self.device}")
        return (nmt_sources([self.grid, *self.levels]) + root_sources(self.root_tree)
                + [eds_source(self.eds)])


def nmt_sources(levels: Sequence[torch.Tensor]) -> List[gather.GatherSource]:
    """K7b sources of NMT levels uint8[trees, m, 90]: item (row t, idx i) of
    source j is node i of tree t at level j."""
    return [gather.GatherSource(lv, 0, lv.shape[-2] * DIGEST, DIGEST, DIGEST) for lv in levels]


def root_sources(root_tree: torch.Tensor) -> List[gather.GatherSource]:
    """K7b sources of a packed root tree uint8[2n - 1, 32], one per level
    (row 0, idx i = node i of that level)."""
    sources, off, n = [], 0, (root_tree.shape[0] + 1) // 2
    while n >= 1:
        sources.append(gather.GatherSource(root_tree, off * HASH, 0, HASH, HASH))
        off += n
        n //= 2
    return sources


def eds_source(eds: torch.Tensor) -> gather.GatherSource:
    """The K7b source of an EDS uint8[2k, 2k, 512], or of rows of one
    uint8[R, 2k, 512]: item (row r, idx c) is the share at (r, c)."""
    return gather.GatherSource(eds, 0, eds.shape[1] * SHARE, SHARE, SHARE)


def entry_from_arrays(k, data_root, eds, levels, root_levels, device=None) -> DevicePlaneEntry:
    """A port entry from numpy arrays laid out as the JAX entry's:
    ``eds`` uint8[2k, 2k, 512], ``levels[j]`` uint8[2, 2k, 2k>>j, 90],
    ``root_levels[j]`` uint8[4k>>j, 32].  The column trees' leaves must be
    the transpose of the row trees' (one grid holds both)."""
    dev = resolve_device(device)
    k = int(k)
    n2 = 2 * k

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.uint8, order="C")).to(dev)

    leaves = np.asarray(levels[0], dtype=np.uint8)
    if leaves.shape != (2, n2, n2, DIGEST):
        raise ValueError(f"levels[0] must be (2, {n2}, {n2}, {DIGEST}), got {leaves.shape}")
    if not np.array_equal(leaves[1], leaves[0].transpose(1, 0, 2)):
        raise ValueError("column-tree leaves are not the transpose of the row-tree leaves")
    upper = []
    for lv in levels[1:]:
        lv = np.asarray(lv, dtype=np.uint8)
        upper.append(tensor(lv.reshape(2 * n2, lv.shape[2], DIGEST)))
    entry = DevicePlaneEntry(
        k, data_root, tensor(eds), tensor(leaves[0]), upper,
        tensor(np.concatenate([np.asarray(r, dtype=np.uint8) for r in root_levels])),
    )
    entry.gather_sources()  # raises on a malformed layout
    return entry


def extend_and_header(square, device=None):
    """The plane's extend: square uint8[k, k, 512] -> (ExtendedDataSquare,
    DataAvailabilityHeader), byte-identical to the JAX package.

    One upload of the square; one device->host copy of the 4k axis roots
    and the data root.  The EDS and the level stacks stay on the device in
    a :class:`DevicePlaneEntry` parked in da/eds_cache.py under the data
    root."""
    from celestia_tpu_torch.da import eds_cache
    from celestia_tpu_torch.da.dah import (
        DataAvailabilityHeader,
        ExtendedDataSquare,
        _square_tensor,
    )

    dev = resolve_device(device)
    sq = _square_tensor(square, dev)
    k = sq.shape[0]
    n2 = 2 * k
    eds, grid, levels, root_tree = _extend_levels(sq)
    host = torch.cat([levels[-1].reshape(-1), root_tree[-1]]).cpu().numpy()
    rr = host[: 2 * n2 * DIGEST].reshape(2, n2, DIGEST)
    data_root = host[2 * n2 * DIGEST :].tobytes()
    dah = DataAvailabilityHeader(
        tuple(rr[0, i].tobytes() for i in range(n2)),
        tuple(rr[1, i].tobytes() for i in range(n2)),
        data_root,
    )
    eds_cache.put_device_entry(data_root, DevicePlaneEntry(k, data_root, eds, grid, levels, root_tree))
    return ExtendedDataSquare(eds), dah


@lru_cache(maxsize=4096)
def _cell_node_indices(n: int, col: int, n_levels: int) -> tuple:
    """(level, index) of every sibling digest of the single-cell NMT
    range proof [col, col+1), in the EXACT traversal order
    da/proof.py nmt_range_proof_from_levels records them."""
    out: List[Tuple[int, int]] = []
    start, end = col, col + 1

    def walk(lo: int, hi: int, level: int) -> None:
        if lo >= end or hi <= start:
            out.append((level, lo >> level))
            return
        if hi - lo == 1:
            return
        mid = (lo + hi) // 2
        walk(lo, mid, level - 1)
        walk(mid, hi, level - 1)

    walk(0, n, n_levels - 1)
    return tuple(out)


@lru_cache(maxsize=16)
def _node_table(n: int, n_levels: int) -> np.ndarray:
    """int64[n, n_levels - 1, 2]: :func:`_cell_node_indices` of every column."""
    return np.array([_cell_node_indices(n, c, n_levels) for c in range(n)], dtype=np.int64)


def _cell_layout(k: int) -> gather.CellLayout:
    """Where a cell's items lie among sources laid out as
    :meth:`DevicePlaneEntry.gather_sources` (the log2(2k) + 1 NMT levels,
    the log2(4k) + 1 root-tree levels, the EDS), and its record in the
    gather output: the share, the aunts' hashes, the siblings' digests,
    zeros up to a multiple of 16 bytes."""
    siblings = (2 * k).bit_length() - 1
    aunts = (4 * k).bit_length() - 1
    return gather.CellLayout(siblings, 0, aunts, siblings + 1, siblings + aunts + 2)


def proof_items(k: int, coords: Sequence[Tuple[int, int]], tree_rows=None) -> np.ndarray:
    """The host derivation of the cell mode's items, for its plain version
    and the tests: int32[n * (1 + aunts + siblings), 4] of (source, row,
    idx, output offset), cell i's record at i * cell_bytes onwards
    (:func:`_cell_layout`), over sources laid out as
    :meth:`DevicePlaneEntry.gather_sources`.  ``tree_rows[i]`` is the row of
    cell i's tree in the NMT sources (default: its EDS row).  The siblings
    come from the range-proof walk (:func:`_cell_node_indices`), not the
    kernel's bit rule.  Host integer arithmetic only."""
    n2 = 2 * k
    lay = _cell_layout(k)
    rows = np.fromiter((r for r, _ in coords), dtype=np.int64, count=len(coords))
    cols = np.fromiter((c for _, c in coords), dtype=np.int64, count=len(coords))
    trees = rows if tree_rows is None else np.asarray(tree_rows, dtype=np.int64)
    base = np.arange(len(coords), dtype=np.int64)[:, None] * lay.cell_bytes
    nodes = _node_table(n2, lay.n_sib + 1)[cols]  # (n, siblings, 2)
    j = np.arange(lay.n_aunt, dtype=np.int64)[None, :]
    shape = (len(coords), 1)
    items = np.concatenate([
        np.stack([np.full(shape, lay.share), rows[:, None], cols[:, None], base], axis=-1),
        np.stack(np.broadcast_arrays(lay.aunt0 + j, 0 * j, (rows[:, None] >> j) ^ 1,
                                     base + lay.aunts_at + HASH * j), axis=-1),
        np.stack([lay.sib0 + nodes[..., 0], np.broadcast_to(trees[:, None], nodes.shape[:2]),
                  nodes[..., 1], base + lay.siblings_at + DIGEST * np.arange(lay.n_sib)], axis=-1),
    ], axis=1)
    return np.ascontiguousarray(items.reshape(-1, 4), dtype=np.int32)


def cell_table(coords: Sequence[Tuple[int, int]], tree_rows=None) -> np.ndarray:
    """The cell mode's int32[n, 3] of (row, tree_row, col); ``tree_rows``
    as :func:`proof_items` takes it."""
    cells = np.array([(r, r, c) for r, c in coords], dtype=np.int64).reshape(-1, 3)
    if tree_rows is not None:
        cells[:, 1] = np.asarray(tree_rows, dtype=np.int64)
    if len(cells) and (cells.min() < -(1 << 31) or cells.max() >= 1 << 31):
        raise ValueError("a cell coordinate outside int32")
    return cells.astype(np.int32)


def gather_cells(k: int, sources, coords: Sequence[Tuple[int, int]],
                 tree_rows=None) -> torch.Tensor:
    """The proof paths of ``coords`` (records of :func:`_cell_layout`) on
    the sources' device: on the card only the (row, tree_row, col)
    triples go up and K7b's cell mode derives every item
    (``gather.das_cell_gather_cuda``); on the CPU the plain version gathers
    :func:`proof_items`.  Raises on a cell outside the EDS or the NMT
    sources."""
    lay = _cell_layout(k)
    cells = cell_table(coords, tree_rows)
    if not gather._is_cpu(sources[0].tensor):
        return gather.das_cell_gather_cuda(sources, lay, cells)
    gather.check_cells(sources, lay, cells)
    return gather.das_proof_gather_plain(sources, proof_items(k, coords, tree_rows),
                                         len(coords) * lay.cell_bytes)


def assemble_proofs(k: int, dah, coords, gathered: np.ndarray) -> list:
    """SampleProofs from the fetched gather output (coords order kept)."""
    from celestia_tpu_torch.da.das import SampleProof
    from celestia_tpu_torch.da.proof import MerkleProof, NmtRangeProof

    lay = _cell_layout(k)
    a0, s0, cell = lay.aunts_at, lay.siblings_at, lay.cell_bytes
    raw = gathered.tobytes()
    out = []
    for i, (row, col) in enumerate(coords):
        b = raw[i * cell : (i + 1) * cell]
        out.append(
            SampleProof(
                row=row,
                col=col,
                square_size=k,
                share=b[:SHARE],
                nmt_proof=NmtRangeProof(
                    col, col + 1,
                    tuple(b[s0 + j * DIGEST : s0 + (j + 1) * DIGEST] for j in range(lay.n_sib)),
                ),
                row_root=dah.row_roots[row],
                root_proof=MerkleProof(
                    index=row,
                    total=4 * k,
                    aunts=tuple(b[a0 + j * HASH : a0 + (j + 1) * HASH] for j in range(lay.n_aunt)),
                ),
            )
        )
    return out


def _serve(k: int, dah, coords, sources, tree_rows=None) -> list:
    out = gather_cells(k, sources, coords, tree_rows)
    return assemble_proofs(k, dah, coords, out.cpu().numpy())


def sample_proofs_batch(entry: DevicePlaneEntry, dah, coords: Sequence[Tuple[int, int]]) -> list:
    """Serve n DAS proofs from a cached entry: on the card the cells'
    (row, tree_row, col) triples go up, one K7b launch derives and gathers
    every share, aunt and sibling on the entry's device, and one copy
    fetches them.  Byte-identical to the host prover.  Raises on a
    malformed entry or a failed launch; nothing falls back."""
    return _serve(entry.k, dah, coords, entry.gather_sources())


def root_tree(dah, device) -> torch.Tensor:
    """The packed RFC-6962 tree uint8[2 * 4k - 1, 32] over the DAH's 4k axis
    roots on ``device``: the cached entry's when the block is parked there,
    else one K4 launch over the roots, uploaded once (46 KB at k = 128)."""
    from celestia_tpu_torch.da import eds_cache

    k = len(dah.row_roots) // 2
    entry = eds_cache.get_device_entry(dah.hash, device)
    if entry is not None and entry.k == k:
        return entry.root_tree
    roots = np.frombuffer(b"".join([*dah.row_roots, *dah.col_roots]), dtype=np.uint8)
    roots = torch.from_numpy(roots.reshape(4 * k, DIGEST).copy()).to(device)
    return nmt_ops.rfc6962_levels(roots)


def sample_proofs_from_eds(eds: torch.Tensor, dah, coords: Sequence[Tuple[int, int]]) -> list:
    """Serve n DAS proofs of a block with no cached entry, on the EDS's
    device: the touched rows' level stacks (one K2 launch in its row-set
    mode, reading those rows of the EDS in place, then one K3 launch for
    every level, over those rows only), the root tree (:func:`root_tree`),
    and one K7b gather of every sibling, aunt and share.  Byte-identical to
    :func:`sample_proofs_batch` and the host prover."""
    k = eds.shape[0] // 2
    rows = sorted({r for r, _ in coords})
    tree_of = {r: i for i, r in enumerate(rows)}
    eds = eds.contiguous()
    stack = nmt_ops.eds_row_level_stack(eds, rows)
    sources = nmt_sources(stack) + root_sources(root_tree(dah, eds.device)) + [eds_source(eds)]
    return _serve(k, dah, coords, sources, [tree_of[r] for r, _ in coords])
