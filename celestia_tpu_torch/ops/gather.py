"""K7b ``das_proof_gather``: proof paths copied out of device-resident tensors.

Counterpart of the eager gathers of ``celestia_tpu/da/device_plane.py``
``sample_proofs_batch`` (:318-334), which index every NMT level, every
root-tree level and the EDS separately and fetch the results as a tuple.
On a CUDA tensor one launch of ``csrc/das_gather.cu`` copies every item a
batch of proofs needs into one packed uint8 output, which the caller
fetches with one copy.  Two modes:

* the **cell mode** (:func:`das_cell_gather_cuda`, the DAS path: its
  device routing is da/device_plane.py ``gather_cells``) uploads only
  an int32 ``(row, tree_row, col)`` triple a cell; the kernel derives each
  cell's share, aunts and siblings from its coordinates and writes the
  cell's record (:class:`CellLayout`);
* the **table mode** (:func:`das_proof_gather`, range proofs) uploads a
  host-built int32 table of ``(source, row, idx, offset)`` items.

On CPU tensors the plain version (:func:`das_proof_gather_plain`, torch
indexing over an item table) runs instead.

A source is a contiguous uint8 tensor of fixed-width items laid out in
rows: item ``(row, idx)`` is the ``width`` bytes at byte ``offset + row *
row_stride + idx * item_stride`` of the tensor.  Everything the kernel
will read is checked on the host before anything is launched -- every item
of a table; the sources' extents and every cell's coordinates in the cell
mode -- so a malformed call raises instead of reading out of bounds.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from celestia_tpu_torch import kernels

MAX_SOURCES = 32  # ctt::kMaxGatherSrcs
DIGEST, HASH, SHARE = 90, 32, 512  # a cell's sibling, aunt and share widths


class GatherSource(NamedTuple):
    tensor: torch.Tensor
    offset: int  # bytes to item (0, 0)
    row_stride: int  # bytes
    item_stride: int  # bytes
    width: int  # bytes copied per item


class CellLayout(NamedTuple):
    """Where the cell mode finds a cell's items: NMT level l (of ``n_sib =
    log2(2k)``) is source ``sib0 + l``, read at the cell's tree row;
    root-tree level j (of ``n_aunt = log2(4k)``) is source ``aunt0 + j``,
    row 0; the EDS is source ``share``.  A cell's record is its share, its
    aunts, its siblings in proof order, zeros up to :attr:`cell_bytes`."""

    n_sib: int
    sib0: int
    n_aunt: int
    aunt0: int
    share: int

    @property
    def aunts_at(self) -> int:
        return SHARE

    @property
    def siblings_at(self) -> int:
        return SHARE + HASH * self.n_aunt

    @property
    def cell_bytes(self) -> int:
        return (self.siblings_at + DIGEST * self.n_sib + 15) // 16 * 16


def _is_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def check_sources(sources: Sequence[GatherSource]) -> torch.device:
    """Raise unless the sources are 1..32 contiguous uint8 tensors on one
    device; return that device."""
    if not 1 <= len(sources) <= MAX_SOURCES:
        raise ValueError(f"between 1 and {MAX_SOURCES} sources, got {len(sources)}")
    device = sources[0].tensor.device
    for i, s in enumerate(sources):
        t = s.tensor
        if t.device != device:
            raise ValueError(f"source {i} lies on {t.device}, source 0 on {device}")
        if t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"source {i} must be a contiguous uint8 tensor")
    return device


def check_items(
    sources: Sequence[GatherSource], items: np.ndarray, out_bytes: int
) -> torch.device:
    """Raise unless every item lies inside its source and the output; return
    the sources' (common) device."""
    if items.dtype != np.int32 or items.ndim != 2 or items.shape[1] != 4:
        raise ValueError(f"items must be int32[n, 4], got {items.dtype}{list(items.shape)}")
    device = check_sources(sources)
    if not len(items):
        return device
    src, row, idx, off = (items[:, j].astype(np.int64) for j in range(4))
    if src.min() < 0 or src.max() >= len(sources):
        raise ValueError("item names a source that does not exist")
    if row.min() < 0 or idx.min() < 0 or off.min() < 0:
        raise ValueError("negative row, index or offset in the gather table")
    meta = np.array(
        [(s.offset, s.row_stride, s.item_stride, s.width, s.tensor.numel()) for s in sources],
        dtype=np.int64,
    )
    m = meta[src]
    if np.any(m[:, 0] + row * m[:, 1] + idx * m[:, 2] + m[:, 3] > m[:, 4]):
        raise ValueError("gather item past the end of its source")
    if np.any(off + m[:, 3] > out_bytes):
        raise ValueError("gather item past the end of the output")
    return device


def check_cells(sources: Sequence[GatherSource], layout: CellLayout,
                cells: np.ndarray) -> torch.device:
    """Raise unless the cell mode's reads stay inside the sources: each
    source of ``layout`` has its item width and holds every node of its
    level (2k >> l nodes of an NMT level for each of its trees, 4k >> j of
    a root-tree level, 2k x 2k shares), and every cell has 0 <= row, col <
    2k and a tree row that the NMT sources hold.  Host arithmetic over the
    sources and the triples only; returns the sources' device."""
    if cells.dtype != np.int32 or cells.ndim != 2 or cells.shape[1] != 3:
        raise ValueError(f"cells must be int32[n, 3], got {cells.dtype}{list(cells.shape)}")
    device = check_sources(sources)
    n2 = 1 << layout.n_sib
    if layout.n_aunt != layout.n_sib + 1 or not (
        0 <= layout.sib0 and layout.sib0 + layout.n_sib <= len(sources)
        and 0 <= layout.aunt0 and layout.aunt0 + layout.n_aunt <= len(sources)
        and 0 <= layout.share < len(sources)
    ):
        raise ValueError(f"cell layout {tuple(layout)} does not fit {len(sources)} sources")

    def last_item(s: GatherSource, width: int, row: int, idx: int) -> int:
        if s.width != width:
            raise ValueError(f"a cell source of {s.width}-byte items, expected {width}")
        return s.offset + row * s.row_stride + idx * s.item_stride + width

    trees = None
    for lvl in range(layout.n_sib):
        s = sources[layout.sib0 + lvl]
        spare = s.tensor.numel() - last_item(s, DIGEST, 0, (n2 >> lvl) - 1)
        if spare < 0:
            raise ValueError(f"NMT level {lvl} holds fewer than {n2 >> lvl} nodes a tree")
        held = spare // s.row_stride + 1 if s.row_stride else 1
        trees = held if trees is None else min(trees, held)
    for j in range(layout.n_aunt):
        s = sources[layout.aunt0 + j]
        if last_item(s, HASH, 0, (2 * n2 >> j) - 1) > s.tensor.numel():
            raise ValueError(f"root-tree level {j} holds fewer than {2 * n2 >> j} nodes")
    s = sources[layout.share]
    if last_item(s, SHARE, n2 - 1, n2 - 1) > s.tensor.numel():
        raise ValueError(f"the EDS source holds fewer than {n2} x {n2} shares")
    if len(cells):
        lo, hi = cells.min(axis=0), cells.max(axis=0)
        if lo.min() < 0 or hi[0] >= n2 or hi[2] >= n2:
            raise ValueError(f"a cell outside the {n2} x {n2} EDS")
        if hi[1] >= trees:
            raise ValueError(f"a cell's tree row {int(hi[1])} past the {trees} NMT trees")
    return device


def das_proof_gather_plain(
    sources: Sequence[GatherSource], items: np.ndarray, out_bytes: int
) -> torch.Tensor:
    """Plain twin of K7b on any device: the same copy by torch indexing.
    Bytes no item covers are zero."""
    device = check_items(sources, items, out_bytes)
    out = torch.zeros(out_bytes, dtype=torch.uint8, device=device)
    table = torch.from_numpy(np.ascontiguousarray(items, dtype=np.int32)).to(device).long()
    for i, s in enumerate(sources):
        it = table[table[:, 0] == i]
        if not len(it):
            continue
        span = torch.arange(s.width, device=device)
        start = s.offset + it[:, 1] * s.row_stride + it[:, 2] * s.item_stride
        out[it[:, 3, None] + span] = s.tensor.reshape(-1)[start[:, None] + span]
    return out


def _check_cuda_sources(sources: Sequence[GatherSource]) -> None:
    for i, s in enumerate(sources):
        kernels.check_cuda_tensor(s.tensor, f"source {i}")


def _source_table(sources: Sequence[GatherSource]) -> np.ndarray:
    """The C entries' int64[n, 4] of (base pointer, row stride, item
    stride, width)."""
    return np.array(
        [(s.tensor.data_ptr() + s.offset, s.row_stride, s.item_stride, s.width) for s in sources],
        dtype=np.int64,
    )


def launch_gather(
    sources: Sequence[GatherSource], items_dev: torch.Tensor, out: torch.Tensor
) -> None:
    """Launch K7b's table mode on an index table already on the card
    (checked by the caller, as :func:`das_proof_gather` does)."""
    table = _source_table(sources)
    kernels.launch(
        "das_proof_gather", out.device, table.ctypes.data_as(ctypes.c_void_p), len(sources),
        items_dev.data_ptr(), items_dev.shape[0], out.data_ptr(),
    )


def das_proof_gather(
    sources: Sequence[GatherSource], items: np.ndarray, out_bytes: int
) -> torch.Tensor:
    """The table mode: copy every item of ``items`` (int32[n, 4]: source,
    row, idx, output offset) into one packed uint8[out_bytes] tensor on the
    sources' device.

    On the card: one upload of the table, one launch of K7b; the caller
    fetches the result with one copy.  Bytes no item covers are zero, as
    in the plain twin, which runs on the CPU."""
    device = check_items(sources, items, out_bytes)
    if _is_cpu(sources[0].tensor):
        return das_proof_gather_plain(sources, items, out_bytes)
    _check_cuda_sources(sources)
    out = torch.zeros(out_bytes, dtype=torch.uint8, device=device)
    if len(items):
        items_dev = torch.from_numpy(np.ascontiguousarray(items)).to(device)
        launch_gather(sources, items_dev, out)
    return out


def launch_cells(sources: Sequence[GatherSource], layout: CellLayout, cells_dev: torch.Tensor,
                 out: torch.Tensor) -> None:
    """Launch K7b's cell mode on triples already on the card (checked by
    the caller, as :func:`das_cell_gather_cuda` does) into ``out``, uint8[n *
    cell_bytes]."""
    table = _source_table(sources)
    kernels.launch(
        "das_proof_gather", out.device, table.ctypes.data_as(ctypes.c_void_p), len(sources),
        *layout, cells_dev.data_ptr(), cells_dev.shape[0], out.data_ptr(),
        entry="ctt_das_cell_gather",
    )


def das_cell_gather_cuda(sources: Sequence[GatherSource], layout: CellLayout,
                         cells: np.ndarray) -> torch.Tensor:
    """The cell mode on the card: ``cells`` int32[n, 3] of (row, tree_row,
    col) -> uint8[n * cell_bytes], cell i's record at i * cell_bytes.  One
    upload of the triples (12 bytes a cell), one launch.  Its plain version
    is :func:`das_proof_gather_plain` over the same cells' item table
    (da/device_plane.py ``proof_items``, which ``gather_cells`` runs for
    sources on the CPU); a CPU tensor raises here."""
    device = check_cells(sources, layout, cells)
    if _is_cpu(sources[0].tensor):
        raise ValueError("the cell mode runs on the card; on the CPU gather an item table")
    _check_cuda_sources(sources)
    out = torch.empty(len(cells) * layout.cell_bytes, dtype=torch.uint8, device=device)
    if len(cells):
        cells_dev = torch.from_numpy(np.ascontiguousarray(cells)).to(device)
        launch_cells(sources, layout, cells_dev, out)
    return out


def dependent_load_probe(src: torch.Tensor, dst: torch.Tensor, loads: int) -> None:
    """K7b's latency floor, a measurement probe and no kernel of the port's
    paths (its launches are not counted): one warp that loads 32 x 16
    bytes of ``src`` and stores them to ``dst`` (``loads`` = 1), or an empty
    launch (``loads`` = 0)."""
    for name, t in (("src", src), ("dst", dst)):
        kernels.check_cuda_tensor(t, name)
        if t.numel() < 512:
            raise ValueError(f"{name} must hold 512 bytes")
    kernels.call("ctt_dependent_load_probe", dst.device, src.data_ptr(), dst.data_ptr(), loads)
