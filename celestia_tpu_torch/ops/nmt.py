"""Namespaced Merkle Trees and the RFC-6962 data-root tree over an EDS.

Counterpart of ``celestia_tpu/ops/nmt.py``, with the same digest format
(test/util/malicious/hasher.go:1-71):

* leaf digest  = ns || ns || sha256(0x00 || ns || data)
* node digest  = minNs || maxNs || sha256(0x01 || left || right)
  with minNs = left.min and, because IgnoreMaxNamespace=true, maxNs =
  left.max when right.min == 0xFF..FF (an all-parity right subtree), else
  right.max.
* empty root   = zeros(29) || zeros(29) || sha256("")

Digests are 29+29+32 = 90 bytes.  All 4k axis trees of the extended
square reduce together, level by level.  The leaf prefix rule mirrors
nmt_wrapper.go:93-114: Q0 cells are prefixed with their own namespace,
every cell outside Q0 with the parity namespace.

On a CUDA tensor the EDS passes go through the kernels of ``csrc/nmt.cu``
(K2 ``nmt_leaf_digests``, K3 ``nmt_combine_level``) and the data root
through one launch of ``csrc/rfc6962.cu`` (K4 ``rfc6962_root``), from the
axis roots to the root.
On a CPU tensor each runs its plain PyTorch twin in this module.  Each EDS
cell is hashed once, into a (2k, 2k, 90) grid that row trees read by rows
and column trees by columns — the bytes the JAX program gets by hashing
every cell twice.  K2 also hashes a window of EDS rows
(:func:`leaf_digests_window`).

K3 runs every level of a set of trees in one launch and writes them all
into one packed buffer; the levels are views of it (:func:`grid_levels`
from a leaf grid, :func:`reduce_levels` over contiguous trees,
:func:`column_levels` down a grid's columns — the sharded extension's
column subtrees and their finish, parallel/sharded.py).  The one-level
functions (:func:`combine_level`, :func:`combine_grid`,
:func:`combine_columns`) are the same kernel with one level.

The level stacks that proofs are served from: :func:`row_level_stack` /
:func:`eds_row_level_stack` (a set of EDS row trees hashed straight from
the rows by K2's row-set mode, :func:`row_leaf_digests`, then one K3 launch
for every level) and :func:`rfc6962_level_stack` (one K4 launch that hashes
the leaves and writes every level into one packed buffer,
:func:`rfc6962_levels`; :func:`rfc6962_tree_levels` is the same kernel
over given leaf hashes).  :func:`nmt_level_stack` takes any prefixed
leaves (K1 leaf digests, then one K3 launch, over any leading batch
dimension); no serving path builds such leaves.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from celestia_tpu_torch import kernels
from celestia_tpu_torch.appconsts import (
    NAMESPACE_SIZE,
    PARITY_SHARE_NAMESPACE_RAW,
    SHARE_SIZE,
)
from celestia_tpu_torch.ops.sha256 import sha256, sha256_cuda, sha256_plain

NMT_DIGEST_SIZE = 2 * NAMESPACE_SIZE + 32  # 90

_PARITY_NS = np.frombuffer(PARITY_SHARE_NAMESPACE_RAW, dtype=np.uint8)

# one K4 block holds the whole tree in shared memory, and stages its leaves
# in passes of at most 64 KiB (csrc/nmt.cuh kRfcMaxLeaves, kRfcStageBudget)
RFC6962_MAX_LEAVES = 1024
RFC6962_MAX_LEAF_BYTES = 65536


def _is_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def _check_pow2(n: int, what: str = "leaf count") -> None:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")


def _byte_column(t: torch.Tensor, value: int) -> torch.Tensor:
    return torch.full(t.shape[:-1] + (1,), value, dtype=torch.uint8, device=t.device)


def _leaf_digests_with(hash0_fn, leaves: torch.Tensor) -> torch.Tensor:
    ns = leaves[..., :NAMESPACE_SIZE]
    return torch.cat([ns, ns, hash0_fn(leaves)], dim=-1)


def leaf_digests(leaves: torch.Tensor) -> torch.Tensor:
    """Hash namespaced leaves: uint8[..., L] -> uint8[..., 90].

    ``leaves`` already carry their namespace prefix (ns || data).  On the
    card the hash is K1 with a 0x00 prefix, reading the leaves in place."""
    return _leaf_digests_with(rfc6962_leaf_hashes, leaves)


def combine_level_plain(nodes: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: uint8[..., m, 90] -> uint8[..., m//2, 90]."""
    left = nodes[..., 0::2, :]
    right = nodes[..., 1::2, :]
    l_min = left[..., :NAMESPACE_SIZE]
    l_max = left[..., NAMESPACE_SIZE : 2 * NAMESPACE_SIZE]
    r_min = right[..., :NAMESPACE_SIZE]
    r_max = right[..., NAMESPACE_SIZE : 2 * NAMESPACE_SIZE]
    r_is_parity = (r_min == 0xFF).all(dim=-1, keepdim=True)  # IgnoreMaxNamespace
    max_ns = torch.where(r_is_parity, l_max, r_max)
    h = sha256_plain(torch.cat([_byte_column(left, 1), left, right], dim=-1))
    return torch.cat([l_min, max_ns, h], dim=-1)


# one K3 block holds a whole tree in shared memory (csrc/nmt.cuh
# kNmtTileLeaves); an EDS axis has at most 256 leaves
NMT_MAX_LEAVES = 512


def _lg(n: int) -> int:
    return n.bit_length() - 1


def _reduce_cuda(src, trees: tuple, m, n_levels, split, strides0, strides1, group=None) -> list:
    """K3 over the trees ``trees`` (a shape: ntrees = its product) of ``m``
    leaves: levels 1 .. ``n_levels``, views uint8[*trees, m >> j, 90] of one
    packed buffer, in one launch.  ``strides0`` / ``strides1`` = (bytes
    between trees, bytes between nodes) of trees below / from ``split`` in a
    group; ``group`` = (trees per group, bytes between groups) for a batch
    of grids, else one group of all."""
    if m > NMT_MAX_LEAVES:
        raise ValueError(f"K3 reduces trees of at most {NMT_MAX_LEAVES} leaves, got {m}")
    if src.data_ptr() % 2:
        raise ValueError("K3 reads 90-byte nodes 2 bytes at a time at least: the input "
                         "starts at an odd address")
    ntrees = math.prod(trees)
    tpb, bs = group if group is not None else (ntrees, 0)
    d = NMT_DIGEST_SIZE
    packed = torch.empty(ntrees * (m - (m >> n_levels)) * d, dtype=torch.uint8, device=src.device)
    kernels.launch("nmt_combine_level", src.device, src.data_ptr(), packed.data_ptr(), ntrees, m,
                   n_levels, split, *strides0, *strides1, tpb, bs)
    sizes = [ntrees * (m >> j) * d for j in range(1, n_levels + 1)]
    return [lv.view(trees + (m >> j, d)) for j, lv in enumerate(packed.split(sizes), 1)]


def _level_count(m: int, n_levels) -> int:
    _check_pow2(m)
    if n_levels is None:
        return _lg(m)
    if not 0 <= n_levels <= _lg(m):
        raise ValueError(f"n_levels must be in 0..{_lg(m)} for {m} leaves, got {n_levels}")
    return n_levels


def _empty_levels(lead: tuple, m: int, n_levels: int, device) -> list:
    """Levels 1 .. n_levels of no trees: uint8[*lead, m >> j, 90] each."""
    return [torch.empty(lead + (m >> j, NMT_DIGEST_SIZE), dtype=torch.uint8, device=device)
            for j in range(1, n_levels + 1)]


def _plain_chain(nodes: torch.Tensor, n_levels: int) -> list:
    levels = []
    for _ in range(n_levels):
        nodes = combine_level_plain(nodes)
        levels.append(nodes)
    return levels


def reduce_levels_plain(nodes: torch.Tensor, n_levels=None) -> list:
    """Plain twin of :func:`reduce_levels` on any device."""
    return _plain_chain(nodes, _level_count(nodes.shape[-2], n_levels))


def reduce_levels(nodes: torch.Tensor, n_levels=None) -> list:
    """Levels 1 .. ``n_levels`` (default: to the root) of the trees
    uint8[..., m, 90]: ``[(..., m/2, 90), (..., m/4, 90), ...]``.  On the
    card one K3 launch for every level of every tree (views of one packed
    buffer), m <= 512."""
    n_levels = _level_count(nodes.shape[-2], n_levels)
    if _is_cpu(nodes):
        return _plain_chain(nodes, n_levels)
    kernels.check_cuda_tensor(nodes, "nodes")
    m = nodes.shape[-2]
    if nodes.shape[-1] != NMT_DIGEST_SIZE:
        raise ValueError(f"nodes must be [..., m, 90], got {tuple(nodes.shape)}")
    lead = tuple(nodes.shape[:-2])
    ntrees = math.prod(lead)
    if n_levels == 0 or ntrees == 0:
        return _empty_levels(lead, m, n_levels, nodes.device)
    stride = (m * NMT_DIGEST_SIZE, NMT_DIGEST_SIZE)
    return _reduce_cuda(nodes, lead, m, n_levels, ntrees, stride, stride)


def combine_level(nodes: torch.Tensor) -> torch.Tensor:
    """One reduction level: uint8[..., m, 90] -> uint8[..., m//2, 90]."""
    m = nodes.shape[-2]
    if m < 2 or m % 2:
        raise ValueError(f"nodes must be [..., even m, 90], got {tuple(nodes.shape)}")
    if _is_cpu(nodes):
        return combine_level_plain(nodes)
    kernels.check_cuda_tensor(nodes, "nodes")
    # K3 with one level over the m/2 pairs as trees of two leaves
    pairs = nodes.view(nodes.shape[:-2] + (m // 2, 2, NMT_DIGEST_SIZE))
    return reduce_levels(pairs, 1)[0].view(nodes.shape[:-2] + (m // 2, NMT_DIGEST_SIZE))


def nmt_level_stack_plain(leaves: torch.Tensor) -> list:
    """Plain twin of :func:`nmt_level_stack` on any device."""
    _check_pow2(leaves.shape[-2])
    digests = _leaf_digests_with(rfc6962_leaf_hashes_plain, leaves)
    return [digests] + reduce_levels_plain(digests)


def nmt_level_stack(leaves: torch.Tensor) -> list:
    """All levels of the NMT: uint8[..., n, L] namespaced leaves ->
    ``[leaf digests (..., n, 90), (..., n/2, 90), ..., root (..., 1, 90)]``.

    Counterpart of ``celestia_tpu/ops/nmt.py:326`` for any prefixed leaves
    (the sibling at every aligned span).  On the card: one K1 launch for the
    leaf digests, then one K3 launch for every level of every tree of the
    leading dimensions.  The EDS's row trees, which proofs read, go through
    :func:`row_level_stack` instead: no prefixed leaf is built there."""
    if _is_cpu(leaves):
        return nmt_level_stack_plain(leaves)
    kernels.check_cuda_tensor(leaves, "leaves")
    _check_pow2(leaves.shape[-2])
    digests = leaf_digests(leaves)
    return [digests] + reduce_levels(digests)


def nmt_roots(leaves: torch.Tensor) -> torch.Tensor:
    """Full NMT reduction: uint8[..., n, L] namespaced leaves -> uint8[..., 90].

    n must be a power of two (EDS axes always are)."""
    _check_pow2(leaves.shape[-2])
    digests = leaf_digests(leaves)
    levels = reduce_levels(digests)
    return (levels[-1] if levels else digests)[..., 0, :]


def _prefix_leaves(block: torch.Tensor, row_ids: torch.Tensor, k: int) -> torch.Tensor:
    """EDS rows uint8[(n,) R, 2k, 512] (EDS row indices ``row_ids``) ->
    uint8[(n,) R, 2k, 29+512]: each cell with its prefix."""
    own_ns = block[..., :NAMESPACE_SIZE]
    parity = torch.from_numpy(_PARITY_NS.copy()).to(block.device).expand_as(own_ns)
    c = torch.arange(block.shape[-2], device=block.device)
    in_q0 = (row_ids[:, None] < k) & (c[None, :] < k)
    prefix = torch.where(in_q0[..., None], own_ns, parity)
    return torch.cat([prefix, block], dim=-1)


def _prefixed_rows(eds: torch.Tensor) -> torch.Tensor:
    """uint8[..., 2k, 2k, 512] -> uint8[..., 2k, 2k, 29+512]: each cell with
    its prefix."""
    n2 = eds.shape[-2]
    return _prefix_leaves(eds, torch.arange(n2, device=eds.device), n2 // 2)


def eds_rows(eds: torch.Tensor, rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows ``rows`` of an EDS (any strides, e.g. a transposed view),
    gathered on its device into uint8[R, 2k, 512], and their indices."""
    n2 = _check_eds(eds)
    rows = [int(r) for r in rows]
    if not rows or min(rows) < 0 or max(rows) >= n2:
        raise ValueError(f"rows must be a non-empty subset of 0..{n2 - 1}, got {rows}")
    idx = torch.tensor(rows, device=eds.device)
    return eds.index_select(0, idx), idx


def row_leaves(block: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The namespace-prefixed leaves of the EDS rows ``block`` (indices
    ``idx``, as :func:`eds_rows` returns them): uint8[R, 2k, 29+512]."""
    return _prefix_leaves(block, idx, block.shape[1] // 2)


def eds_row_leaves(eds: torch.Tensor, rows) -> torch.Tensor:
    """The namespace-prefixed leaves of the row trees ``rows`` of an EDS,
    built on its device from those rows alone: uint8[R, 2k, 29+512]."""
    return row_leaves(*eds_rows(eds, rows))


def _row_set(src: torch.Tensor, rows, in_place: bool) -> Tuple[np.ndarray, int]:
    """The EDS row ids ``rows`` as uint16, and 2k, of a row set read from
    ``src``: the EDS itself uint8[2k, 2k, 512] (``in_place``) or the rows
    gathered into a block uint8[R, 2k, 512]."""
    n2 = src.shape[-2] if src.dim() == 3 else 0
    if src.dim() != 3 or src.shape[-1] != SHARE_SIZE or n2 % 2 or (in_place and src.shape[0] != n2):
        want = "an EDS [2k, 2k" if in_place else "rows [R, 2k"
        raise ValueError(f"src must be {want}, {SHARE_SIZE}], got {tuple(src.shape)}")
    _check_pow2(n2 // 2, "square size")
    ids = np.asarray([int(r) for r in rows], dtype=np.int64)
    if not 0 < len(ids) <= n2 or ids.min() < 0 or ids.max() >= n2:
        raise ValueError(f"rows must be 1 to {n2} EDS row ids in 0..{n2 - 1}, got {ids.tolist()}")
    if not in_place and len(ids) != src.shape[0]:
        raise ValueError(f"{src.shape[0]} gathered rows, {len(ids)} row ids")
    return ids.astype(np.uint16), n2


def row_leaf_digests_plain(src: torch.Tensor, rows, in_place: bool = False) -> torch.Tensor:
    """Plain twin of :func:`row_leaf_digests` on any device."""
    ids, n2 = _row_set(src, rows, in_place)
    idx = torch.from_numpy(ids.astype(np.int64)).to(src.device)
    block = src.index_select(0, idx) if in_place else src
    return _leaf_digests_with(rfc6962_leaf_hashes_plain, _prefix_leaves(block, idx, n2 // 2))


def row_leaf_digests(src: torch.Tensor, rows, in_place: bool = False) -> torch.Tensor:
    """K2's row-set mode: the leaf digests uint8[R, 2k, 90] of the row trees
    of the EDS rows ``rows`` (R <= 2k ids, any order), the Q0 prefix rule
    read at those ids, the bytes of ``leaf_digests(eds_row_leaves(eds,
    rows))``.  ``src`` holds the rows gathered into a block uint8[R, 2k, 512]
    (tree i is ``src[i]``: :func:`eds_rows`'s block, e.g. of a transposed
    view), or, with ``in_place``, is the EDS itself (tree i is
    ``src[rows[i]]``, read where it lies); either contiguous.  On the card one launch; the
    ids travel in its parameters."""
    ids, n2 = _row_set(src, rows, in_place)
    if _is_cpu(src):
        return row_leaf_digests_plain(src, rows, in_place)
    kernels.check_cuda_tensor(src, "src")
    if src.data_ptr() % 16:
        raise ValueError("K2 loads shares 16 bytes at a time: src must start on a 16-byte "
                         "boundary")
    out = torch.empty((len(ids), n2, NMT_DIGEST_SIZE), dtype=torch.uint8, device=src.device)
    kernels.launch("nmt_leaf_digests", src.device, src.data_ptr(), out.data_ptr(), n2, len(ids),
                   ids.ctypes.data, int(in_place), entry="ctt_nmt_leaf_digests_rows")
    return out


def row_level_stack_plain(src: torch.Tensor, rows, in_place: bool = False) -> list:
    """Plain twin of :func:`row_level_stack` on any device."""
    digests = row_leaf_digests_plain(src, rows, in_place)
    return [digests] + reduce_levels_plain(digests)


def row_level_stack(src: torch.Tensor, rows, in_place: bool = False) -> list:
    """All levels of the row trees of the EDS rows ``rows``, read from
    ``src`` as :func:`row_leaf_digests` reads it: ``[leaf digests (R, 2k,
    90), (R, k, 90), ..., roots (R, 1, 90)]``, the levels of
    ``nmt_level_stack(eds_row_leaves(eds, rows))``.  On the card one K2 launch
    in its row-set mode, then one K3 launch for every level of the R trees;
    no prefixed leaf is built."""
    digests = row_leaf_digests(src, rows, in_place)
    return [digests] + reduce_levels(digests)


def eds_row_level_stack_plain(eds: torch.Tensor, rows) -> list:
    """Plain twin of :func:`eds_row_level_stack` on any device."""
    return nmt_level_stack_plain(eds_row_leaves(eds, rows))


def eds_row_level_stack(eds: torch.Tensor, rows) -> list:
    """The level stacks of the row trees ``rows`` of an EDS uint8[2k, 2k,
    512] (any strides): :func:`row_level_stack` over the EDS read in place
    when it is contiguous (a plane entry's EDS, a DAS miss's), else over
    those rows gathered by :func:`eds_rows` (e.g. a transposed view)."""
    _check_eds(eds)
    if _is_cpu(eds):
        return eds_row_level_stack_plain(eds, rows)
    if eds.is_contiguous() and eds.data_ptr() % 16 == 0:
        return row_level_stack(eds, rows, in_place=True)
    return row_level_stack(eds_rows(eds, rows)[0], rows)


def eds_prefixed_leaves(eds: torch.Tensor) -> torch.Tensor:
    """The namespace-prefixed leaves of all row and column trees.

    eds: uint8[2k, 2k, SHARE_SIZE] -> uint8[2, 2k, 2k, 29+SHARE_SIZE]
    (axis 0: 0=row trees, 1=column trees; leaves ordered along each axis)."""
    rows = _prefixed_rows(eds)
    return torch.stack([rows, rows.transpose(0, 1)], dim=0)


def _check_eds(eds: torch.Tensor, batched: bool = False) -> int:
    n2 = eds.shape[-2] if eds.dim() >= 2 else 0
    lead = "n, " if batched else ""
    if (
        eds.dim() != 3 + batched
        or tuple(eds.shape[-3:]) != (n2, n2, SHARE_SIZE)
        or n2 % 2
    ):
        raise ValueError(f"EDS must be [{lead}2k, 2k, {SHARE_SIZE}], got {tuple(eds.shape)}")
    _check_pow2(n2 // 2, "square size")
    return n2


def eds_leaf_digests_plain(eds: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2 on any device (one EDS or a batch)."""
    _check_eds(eds, batched=eds.dim() == 4)
    return leaf_digests_window_plain(eds, 0)


def _check_window(rows: torch.Tensor, row0: int) -> Tuple[int, int]:
    """(n_rows, n2) of a window uint8[(n,) n_rows, 2k, 512] of EDS rows
    starting at EDS row ``row0``."""
    n2 = rows.shape[-2] if rows.dim() >= 2 else 0
    if rows.dim() not in (3, 4) or rows.shape[-1] != SHARE_SIZE or n2 % 2:
        raise ValueError(f"rows must be [(n,) n_rows, 2k, {SHARE_SIZE}], got {tuple(rows.shape)}")
    _check_pow2(n2 // 2, "square size")
    n_rows = rows.shape[-3]
    if row0 < 0 or row0 + n_rows > n2:
        raise ValueError(f"rows {row0}..{row0 + n_rows - 1} lie outside an EDS of {n2} rows")
    return n_rows, n2


def leaf_digests_window_plain(rows: torch.Tensor, row0: int) -> torch.Tensor:
    """Plain twin of K2's row window on any device."""
    n_rows, n2 = _check_window(rows, row0)
    ids = torch.arange(row0, row0 + n_rows, device=rows.device)
    return _leaf_digests_with(rfc6962_leaf_hashes_plain, _prefix_leaves(rows, ids, n2 // 2))


def leaf_digests_window(rows: torch.Tensor, row0: int, out: torch.Tensor = None) -> torch.Tensor:
    """K2 over a window of EDS rows: uint8[(n,) n_rows, 2k, 512], rows
    ``row0`` .. ``row0 + n_rows - 1`` of each EDS -> their leaf digests
    uint8[(n,) n_rows, 2k, 90] (into ``out`` when given), the Q0 prefix rule
    read at the rows' EDS coordinates.  A K9 shard hashes its top and its
    bottom rows this way (parallel/sharded.py); a whole EDS is the window
    ``row0 = 0``, ``n_rows = 2k``."""
    n_rows, n2 = _check_window(rows, row0)
    shape = tuple(rows.shape[:-1]) + (NMT_DIGEST_SIZE,)
    if _is_cpu(rows):
        digests = leaf_digests_window_plain(rows, row0)
        return digests if out is None else out.copy_(digests)
    kernels.check_cuda_tensor(rows, "rows")
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=rows.device)
    kernels.check_cuda_tensor(out, "out", shape)
    if rows.data_ptr() % 16 or out.data_ptr() % 2:
        raise ValueError("K2 loads shares 16 bytes at a time and stores digests 2 bytes at a "
                         "time at least: rows must start on a 16-byte boundary, out on an even "
                         "address")
    batch = rows.shape[0] if rows.dim() == 4 else 1
    kernels.launch("nmt_leaf_digests", rows.device, rows.data_ptr(), out.data_ptr(), n2, batch,
                   row0, n_rows)
    return out


def eds_leaf_digests(eds: torch.Tensor) -> torch.Tensor:
    """K2: the leaf digest of every EDS cell, uint8[..., 2k, 2k, 512] ->
    uint8[..., 2k, 2k, 90] (row r, column c = leaf c of row tree r = leaf r
    of column tree c), for one EDS or a batch uint8[n, 2k, 2k, 512] in one
    launch."""
    _check_eds(eds, batched=eds.dim() == 4)
    return leaf_digests_window(eds, 0)


def column_levels_plain(grid: torch.Tensor, n_levels=None) -> list:
    """Plain twin of :func:`column_levels` on any device."""
    return reduce_levels_plain(grid.transpose(-3, -2), n_levels)


def column_levels(grid: torch.Tensor, n_levels=None) -> list:
    """K3 over the trees that run down the columns of leaf grids (tree c's
    leaf i is ``grid[..., i, c]``): uint8[..., m, n, 90] -> levels 1 ..
    ``n_levels`` (default: to the root), uint8[..., n, m >> j, 90], one
    launch for every grid of the batch and every level.  A K9 shard's
    column subtrees read its slab's leaf grid this way, and the finish
    reads the gathered subtree nodes (parallel/sharded.py)."""
    m, n = grid.shape[-3], grid.shape[-2]
    n_levels = _level_count(m, n_levels)
    if _is_cpu(grid):
        return column_levels_plain(grid, n_levels)
    lead = tuple(grid.shape[:-3])
    d = NMT_DIGEST_SIZE
    kernels.check_cuda_tensor(grid, "grid", lead + (m, n, d))
    batch = math.prod(lead)
    if n_levels == 0 or batch * n == 0:
        return _empty_levels(lead + (n,), m, n_levels, grid.device)
    return _reduce_cuda(grid, lead + (n,), m, n_levels, n, (d, n * d), (d, n * d),
                        group=(n, m * n * d))


def combine_columns(grid: torch.Tensor) -> torch.Tensor:
    """The first level of :func:`column_levels`: uint8[..., m, n, 90] ->
    uint8[..., n, m/2, 90]."""
    return column_levels(grid, 1)[0]


def grid_levels_plain(grid: torch.Tensor, n_levels=None) -> list:
    """Plain twin of :func:`grid_levels` on any device."""
    n_levels = _level_count(grid.shape[-2], n_levels)
    if n_levels == 0:
        return []
    first = combine_grid_plain(grid)
    return [first] + reduce_levels_plain(first, n_levels - 1)


def grid_levels(grid: torch.Tensor, n_levels=None) -> list:
    """K3 over the 4k trees of leaf grids uint8[..., 2k, 2k, 90] (trees
    0..2k the rows, 2k..4k the columns): levels j = 1 .. ``n_levels``
    (default: to the roots) as uint8[..., 4k, 2k >> j, 90], views of one
    packed buffer, in one launch for one grid or a batch."""
    n2 = grid.shape[-2]
    n_levels = _level_count(n2, n_levels)
    if _is_cpu(grid):
        return grid_levels_plain(grid, n_levels)
    lead = tuple(grid.shape[:-3])
    d = NMT_DIGEST_SIZE
    kernels.check_cuda_tensor(grid, "grid", lead + (n2, n2, d))
    batch = math.prod(lead)
    if n_levels == 0 or batch == 0:
        return _empty_levels(lead + (2 * n2,), n2, n_levels, grid.device)
    return _reduce_cuda(grid, lead + (2 * n2,), n2, n_levels, n2, (n2 * d, d), (d, n2 * d),
                        group=(2 * n2, n2 * n2 * d))


def combine_grid_plain(grid: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3's first level on any device."""
    return combine_level_plain(torch.cat([grid, grid.transpose(-3, -2)], dim=-3))


def combine_grid(grid: torch.Tensor) -> torch.Tensor:
    """K3's first level, read from the leaf grid: uint8[..., 2k, 2k, 90] ->
    uint8[..., 4k, k, 90] (trees 0..2k are the rows, 2k..4k the columns),
    for one grid or a batch uint8[n, 2k, 2k, 90] in one launch."""
    return grid_levels(grid, 1)[0]


def _eds_roots(eds, leaf_fn, levels_fn) -> torch.Tensor:
    n2 = _check_eds(eds, batched=eds.dim() == 4)
    roots = levels_fn(leaf_fn(eds))[-1]
    return roots[..., 0, :].reshape(eds.shape[:-3] + (2, n2, NMT_DIGEST_SIZE))


def eds_nmt_roots_plain(eds: torch.Tensor) -> torch.Tensor:
    """Plain twin of K2 + K3 on any device: uint8[..., 2k, 2k, 512] ->
    uint8[..., 2, 2k, 90]."""
    return _eds_roots(eds, eds_leaf_digests_plain, grid_levels_plain)


def eds_nmt_roots(eds: torch.Tensor) -> torch.Tensor:
    """All 4k NMT axis roots of an EDS: uint8[2k,2k,512] -> uint8[2, 2k, 90].

    A batch uint8[n, 2k, 2k, 512] gives uint8[n, 2, 2k, 90] (JAX
    ``jax.vmap(eds_nmt_roots)``, celestia_tpu/node/network.py:407): on the
    card one K2 launch for the batch and one K3 launch for every level of
    all n * 4k trees."""
    return _eds_roots(eds, eds_leaf_digests, grid_levels)


def empty_root_np() -> np.ndarray:
    """EmptyRoot: zeros ns range + sha256 of the empty string."""
    import hashlib

    return np.frombuffer(
        b"\x00" * (2 * NAMESPACE_SIZE) + hashlib.sha256(b"").digest(), dtype=np.uint8
    )


# ---------------------------------------------------------------------------
# RFC-6962-style binary Merkle tree (tendermint/go-square merkle parity)
# used for the data root over the 4k NMT axis roots
# (pkg/da/data_availability_header.go:92-108).
# ---------------------------------------------------------------------------


def rfc6962_leaf_hashes_plain(leaves: torch.Tensor) -> torch.Tensor:
    """Plain twin of the K1 leaf-hash launch on any device."""
    return sha256_plain(torch.cat([_byte_column(leaves, 0), leaves], dim=-1))


def rfc6962_leaf_hashes(leaves: torch.Tensor) -> torch.Tensor:
    """uint8[..., n, L] -> uint8[..., n, 32]: sha256(0x00 || leaf).

    On the card: K1 with a 0x00 prefix, reading the leaves in place."""
    if _is_cpu(leaves):
        return rfc6962_leaf_hashes_plain(leaves)
    return sha256_cuda(leaves, prefix=0)


def rfc6962_inner(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    return sha256(torch.cat([_byte_column(left, 1), left, right], dim=-1))


def _tree_levels_plain(hashes: torch.Tensor) -> list:
    levels = [hashes]
    while levels[-1].shape[-2] > 1:
        nodes = levels[-1]
        left, right = nodes[..., 0::2, :], nodes[..., 1::2, :]
        levels.append(sha256_plain(torch.cat([_byte_column(left, 1), left, right], dim=-1)))
    return levels


def _rfc6962_cuda(src: torch.Tensor, leaf_pass: bool) -> torch.Tensor:
    """One K4 launch: the packed tree uint8[..., 2n - 1, 32] over src
    uint8[..., n, L], from the leaves (``leaf_pass``: level 0 is
    sha256(0x00 || leaf)) or over given level-0 hashes (L = 32)."""
    n = src.shape[-2]
    _check_pow2(n)
    kernels.check_cuda_tensor(src, "leaves" if leaf_pass else "hashes")
    L = src.shape[-1]
    if n > RFC6962_MAX_LEAVES or L < 1 or (not leaf_pass and L != 32):
        want = "L >= 1" if leaf_pass else "32"
        raise ValueError(f"K4 takes [..., n <= {RFC6962_MAX_LEAVES}, {want}], "
                         f"got {tuple(src.shape)}")
    if L > RFC6962_MAX_LEAF_BYTES:
        raise ValueError(f"K4 stages leaves of at most {RFC6962_MAX_LEAF_BYTES} bytes, got {L}")
    if (src.data_ptr() | n * L) % 2:
        raise ValueError("K4 takes trees whose leaves start at even addresses: the input "
                         "starts at an odd address or a tree has an odd byte count")
    lead = tuple(src.shape[:-2])
    batch = math.prod(lead)
    levels = torch.empty(lead + (2 * n - 1, 32), dtype=torch.uint8, device=src.device)
    if batch:
        kernels.launch("rfc6962_root", src.device, src.data_ptr(), levels.data_ptr(), batch, n,
                       L, int(leaf_pass))
    return levels


def rfc6962_tree_levels_plain(hashes: torch.Tensor) -> torch.Tensor:
    """Plain twin of K4 over given leaf hashes, on any device."""
    _check_pow2(hashes.shape[-2])
    return torch.cat(_tree_levels_plain(hashes), dim=-2)


def rfc6962_tree_levels(hashes: torch.Tensor) -> torch.Tensor:
    """The RFC-6962 tree over a power-of-two count of given leaf hashes,
    uint8[..., n, 32] -> uint8[..., 2n - 1, 32], every level packed (the n
    leaf hashes first, then n/2, ..., the root last); on the card one K4
    launch without its leaf pass, n <= 1024."""
    if _is_cpu(hashes):
        return rfc6962_tree_levels_plain(hashes)
    return _rfc6962_cuda(hashes, leaf_pass=False)


def rfc6962_tree_plain(hashes: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`rfc6962_tree` on any device."""
    return rfc6962_tree_levels_plain(hashes)[..., -1, :]


def rfc6962_tree(hashes: torch.Tensor) -> torch.Tensor:
    """The RFC-6962 root over a power-of-two count of leaf hashes,
    uint8[..., n, 32] -> uint8[..., 32]: the last row of K4's levels."""
    return rfc6962_tree_levels(hashes)[..., -1, :]


def split_tree_levels(packed: torch.Tensor) -> list:
    """Views of each level of a packed uint8[..., 2n - 1, 32] tree:
    ``[(..., n, 32), (..., n/2, 32), ..., (..., 1, 32)]``."""
    n = (packed.shape[-2] + 1) // 2
    _check_pow2(n)
    levels, off = [], 0
    while n >= 1:
        levels.append(packed[..., off : off + n, :])
        off += n
        n //= 2
    return levels


def rfc6962_levels_plain(leaves: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`rfc6962_levels` on any device."""
    return rfc6962_tree_levels_plain(rfc6962_leaf_hashes_plain(leaves))


def rfc6962_levels(leaves: torch.Tensor) -> torch.Tensor:
    """The RFC-6962 tree over a power-of-two count of equal-length leaves,
    packed: uint8[..., n, L] -> uint8[..., 2n - 1, 32], the leaf hashes
    sha256(0x00 || leaf) first, the root last (``celestia_tpu/ops/
    nmt.py:272`` and ``:287`` as a whole).  On the card one K4 launch,
    leaves to root; n <= 1024."""
    if _is_cpu(leaves):
        return rfc6962_levels_plain(leaves)
    return _rfc6962_cuda(leaves, leaf_pass=True)


def rfc6962_level_stack_plain(leaves: torch.Tensor) -> list:
    """Plain twin of :func:`rfc6962_level_stack` on any device."""
    _check_pow2(leaves.shape[-2])
    return _tree_levels_plain(rfc6962_leaf_hashes_plain(leaves))


def rfc6962_level_stack(leaves: torch.Tensor) -> list:
    """All levels of the RFC-6962 tree over a power-of-two count of
    equal-length leaves: ``[leaf hashes (..., n, 32), ..., root (..., 1,
    32)]`` (``celestia_tpu/ops/nmt.py:287``).  On the card one K4 launch
    from the leaves; the levels are views of its packed output."""
    _check_pow2(leaves.shape[-2])
    if _is_cpu(leaves):
        return rfc6962_level_stack_plain(leaves)
    return split_tree_levels(rfc6962_levels(leaves))


def rfc6962_root_pow2(leaves: torch.Tensor) -> torch.Tensor:
    """Merkle root of a power-of-two number of equal-length leaves.

    uint8[..., n, L] -> uint8[..., 32].  Matches tendermint's simple merkle
    for power-of-two counts (split point = n/2 at every level).  On the
    card the last row of one K4 launch from the leaves."""
    _check_pow2(leaves.shape[-2])
    return rfc6962_levels(leaves)[..., -1, :]


def rfc6962_root_np(leaves: list) -> np.ndarray:
    """Host reference for arbitrary leaf counts (tendermint split rule:
    largest power of two strictly less than n)."""
    import hashlib

    def rec(items):
        if len(items) == 0:
            return hashlib.sha256(b"").digest()
        if len(items) == 1:
            return hashlib.sha256(b"\x00" + items[0]).digest()
        split = 1
        while split * 2 < len(items):
            split *= 2
        left = rec(items[:split])
        right = rec(items[split:])
        return hashlib.sha256(b"\x01" + left + right).digest()

    return np.frombuffer(rec([bytes(x) for x in leaves]), dtype=np.uint8)


def combine_digests_np(left: bytes, right: bytes) -> bytes:
    """Host-side NMT node combine (for proof verification)."""
    import hashlib

    l_min, l_max = left[:NAMESPACE_SIZE], left[NAMESPACE_SIZE : 2 * NAMESPACE_SIZE]
    r_min, r_max = right[:NAMESPACE_SIZE], right[NAMESPACE_SIZE : 2 * NAMESPACE_SIZE]
    max_ns = l_max if r_min == bytes(_PARITY_NS) else r_max
    h = hashlib.sha256(b"\x01" + left + right).digest()
    return l_min + max_ns + h


def leaf_digest_np(ns_prefixed_leaf: bytes) -> bytes:
    """Host-side NMT leaf digest (for proof verification)."""
    import hashlib

    ns = ns_prefixed_leaf[:NAMESPACE_SIZE]
    return ns + ns + hashlib.sha256(b"\x00" + ns_prefixed_leaf).digest()
