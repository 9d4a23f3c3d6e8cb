"""The sharded block extension (K9) over a mesh of devices, one controller.

Re-homed from ``celestia_tpu/parallel/sharded.py``, whose ``shard_map``
program ``_sharded_extend_and_roots`` (:65, built by ``_build_sharded_fn``
:168) this module runs as a launch sequence.  Rows of the original square
are sharded over the mesh's ``row`` axis; whole squares are batched over
its ``data`` axis (validator catch-up).  One process drives every shard,
as ``shard_map`` does: each phase below runs on every shard in turn, each
shard's launches on its own device, and the collectives are copies between
the shards' devices (parallel/collectives.py).  A mesh may repeat a device
(``make_mesh(["cuda:0"] * 8)``, or ``["cpu"] * R`` in the tests), the way
XLA forces host devices: that is how one card runs, and checks, every
kernel and every collective of an R-shard mesh.

Shard (g, d) of an R-row mesh holds rows ``d k/R .. (d+1) k/R - 1`` of the
squares of data group g, and computes, in order:

1. its top rows: those rows and their row parity, K5's row pass
   (``rs.extend_rows``; sharded.py:74-75);
2. its column-parity partial (K9a ``rs_col_parity_partial``;
   sharded.py:78-87);
3. the reduce-scatter of the partials into its parity rows: slab d of every
   shard's partial, XORed by K9b ``xor_reduce_slabs`` where it lies (one
   launch per group and device; only a peer on another card has its slab
   copied over; ``collectives.reduce_scatter_xor``; sharded.py:89-97);
4. the leaf digests of its 2 x k/R x 2k cells, each hashed once (K2 over
   its top rows from EDS row d k/R and its bottom rows from k + d k/R;
   sharded.py:99-114), its k/R x 2 row trees and, per column, the two
   subtrees over its top and its bottom rows (K3 by rows and by columns,
   one launch each for all their levels, none for the columns at k/R = 1;
   sharded.py:116-142);
5. ``all_gather`` of the row roots (tiled) and of the 2R subtree nodes per
   column (sharded.py:119-146), and the log2(2R) levels that finish the
   column trees (one K3 launch; sharded.py:147-150), once per device;
6. the data root (one K4 launch; sharded.py:153-154), once, on the group's
   first device (JAX computes it on every device: the bytes are the same).

A shard keeps its rows as a slab uint8[2, n, k/R, 2k, 512] (top rows, then
bottom rows, of its n squares); :meth:`ShardedRun.shard_eds` gives JAX's
per-shard layout (n, k/R, 2, 2k, 512) as a view (sharded.py:156-157).  The
EDS is reassembled on the mesh's first device (sharded.py:253-255).

Nothing falls back: a failing build or launch raises, a square whose size
does not split over the row axis raises, and no code moves the path to the
CPU when the mesh is on cards.  The JAX module's ``extend.sharded`` span and
devprof brackets are kept: the ``extend_sharded`` / ``extend_sharded_batch``
upload and dispatch (on every device of the groups it runs on), and the
``sharded_roots`` / ``sharded_results`` fetch legs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from celestia_tpu_torch.appconsts import SHARE_SIZE, is_power_of_two
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.ops import nmt as nmt_ops
from celestia_tpu_torch.ops import rs
from celestia_tpu_torch.parallel import collectives
from celestia_tpu_torch.parallel import mesh as mesh_mod
from celestia_tpu_torch.utils import devprof, tracing
from celestia_tpu_torch.utils.device import resolve_device
from celestia_tpu_torch.utils.lru import LruCache

DIGEST = nmt_ops.NMT_DIGEST_SIZE  # 90


@dataclass(frozen=True)
class Mesh:
    """A ("data", "row") array of torch devices: ``devices[g][d]`` is shard
    d of data group g.  ``shape`` reads as JAX's ``Mesh.shape``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "row": len(self.devices[0])}

    @property
    def first_device(self) -> torch.device:
        return self.devices[0][0]


def _normalize(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None, data: int = 1, row: int = None) -> Mesh:
    """A ("data", "row") mesh over ``devices`` (default: every visible card),
    data-major.  Devices may repeat.  Raises when ``data * row`` is not the
    device count, on a mix of device types, and, with no devices given,
    when there is no card."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device to mesh over; pass the devices (e.g. ['cpu'] * R)"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_normalize(d) for d in devices]
    n = len(devices)
    if row is None:
        row = n // data if data >= 1 else 0
    if data < 1 or row < 1 or data * row != n:
        raise ValueError(f"data*row = {data}*{row} != device count {n}")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a mesh spans devices of one type, got {sorted({str(d) for d in devices})}")
    return Mesh(tuple(tuple(devices[g * row : (g + 1) * row]) for g in range(data)))


# per-(mesh, k, codec) constants on the unified LRU: each shard's K9a
# coefficients on its device (rs.partial_coefficients).  There is no
# program to cache, and the batched leg uses the same constants as the
# single-square one; an eviction only costs a rebuild.
_FN_CACHE = LruCache("sharded_fns", 64)


def _shard_coefficients(mesh: Mesh, k: int, codec: str) -> List[tuple]:
    """K9a's coefficients of every shard of one data group, in shard order
    (the same for every group: they depend on the row shard alone)."""
    key = (mesh, k, codec)
    coeffs = _FN_CACHE.get(key)
    if coeffs is None:
        R = mesh.shape["row"]
        rows = k // R
        coeffs = [
            [rs.partial_coefficients(k, d * rows, rows, codec, dev) for d, dev in enumerate(group)]
            for group in mesh.devices
        ]
        _FN_CACHE.put(key, coeffs)
    return coeffs


class _Phases:
    """Phase boundaries of one run: CUDA events on the mesh's first device
    (on one card, every shard's work; with several cards, the first card's
    stream) or, on the CPU, the host clock."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.marks: List[Tuple[str, object]] = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def ms(self) -> Dict[str, float]:
        if self.cuda:
            self.marks[-1][1].synchronize()
            return {f"{name}_ms": a.elapsed_time(b)
                    for (_, a), (name, b) in zip(self.marks, self.marks[1:])}
        return {f"{name}_ms": (b - a) * 1e3 for (_, a), (name, b) in zip(self.marks, self.marks[1:])}


@dataclass
class ShardedRun:
    """The device-resident results of one sharded extension of n squares:
    ``eds`` uint8[n, 2k, 2k, 512], ``row_roots`` / ``col_roots`` uint8[n, 2k,
    90] and ``data_roots`` uint8[n, 32] on the mesh's first device;
    ``slabs[g][d]`` shard (g, d)'s rows, uint8[2, n/D, k/R, 2k, 512] on its
    device; ``shard_row_roots[g][d]`` / ``shard_col_roots[g][d]`` the roots
    as that shard holds them after the gathers, uint8[n/D, 2k, 90]."""

    eds: torch.Tensor
    row_roots: torch.Tensor
    col_roots: torch.Tensor
    data_roots: torch.Tensor
    slabs: List[List[torch.Tensor]]
    shard_row_roots: List[List[torch.Tensor]]
    shard_col_roots: List[List[torch.Tensor]]

    def shard_eds(self, g: int, d: int) -> torch.Tensor:
        """Shard (g, d)'s rows in JAX's per-shard layout, uint8[n/D, k/R, 2,
        2k, 512] (a view): [:, :, 0] its top rows, [:, :, 1] its bottom rows."""
        return self.slabs[g][d].permute(1, 2, 0, 3, 4)


def _writable(arr: np.ndarray) -> np.ndarray:
    """A contiguous array torch may wrap: a read-only one (a Square's frozen
    view) is copied, as da/dah.py uploads it."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    return arr if arr.flags.writeable else arr.copy()


def _reduce_rows(nodes: torch.Tensor) -> torch.Tensor:
    """The roots of the trees uint8[..., m, 90] -> uint8[..., 90]: every
    level in one K3 launch."""
    levels = nmt_ops.reduce_levels(nodes)
    return (levels[-1] if levels else nodes)[..., 0, :]


def _column_roots(grid: torch.Tensor) -> torch.Tensor:
    """The roots of the trees down the columns of grids uint8[..., m, n,
    90] -> uint8[..., n, 90]: every level in one K3 launch, none for m = 1."""
    levels = nmt_ops.column_levels(grid)
    return levels[-1][..., 0, :] if levels else grid[..., 0, :, :]


def _finish_columns(nodes: torch.Tensor) -> torch.Tensor:
    """The gathered subtree nodes uint8[2, R, n, 2k, 90] (top subtrees of
    shards 0..R-1, then bottom ones: a column's 2R nodes in EDS row order)
    -> the column roots uint8[n, 2k, 90]: log2(2R) levels, one K3 launch."""
    _, R, n, n2, _ = nodes.shape
    return _column_roots(nodes.reshape(2 * R, n * n2, DIGEST)).reshape(n, n2, DIGEST)


def _extend_sharded(squares: np.ndarray, mesh: Mesh, groups: int,
                    breakdown: dict = None) -> ShardedRun:
    """Squares uint8[n, k, k, 512] (host) over the first ``groups`` data
    groups of ``mesh``, n/groups squares each."""
    n, k = squares.shape[0], squares.shape[1]
    if (
        squares.ndim != 4
        or squares.shape[1:] != (k, k, SHARE_SIZE)
        or not is_power_of_two(k)
        or k > 128
    ):
        raise ValueError(
            f"squares must be (n, k, k, {SHARE_SIZE}) with k a power of two <= 128, "
            f"got {squares.shape}"
        )
    R = mesh.shape["row"]
    if k % R:
        raise ValueError(f"square size {k} not divisible by row shards {R}")
    if n == 0 or n % groups:
        raise ValueError(f"a batch of {n} squares does not split over {groups} data groups")
    codec = gf256.active_codec()
    gf256.mark_codec_used()
    nb, rows, n2 = n // groups, k // R, 2 * k
    coeffs = _shard_coefficients(mesh, k, codec)
    shards = [(g, d, mesh.devices[g][d]) for g in range(groups) for d in range(R)]
    phases = _Phases(mesh.first_device) if breakdown is not None else None

    def mark(name: str) -> None:
        if phases is not None:
            phases.mark(name)

    x = {(g, d): torch.from_numpy(_writable(squares[g * nb : (g + 1) * nb, d * rows : (d + 1) * rows]))
         .to(dev) for g, d, dev in shards}
    mark("upload")
    slabs = {(g, d): torch.empty((2, nb, rows, n2, SHARE_SIZE), dtype=torch.uint8, device=dev)
             for g, d, dev in shards}
    for g, d, _ in shards:  # Q0 | Q1 of the shard's rows
        rs.extend_rows(x[g, d].view(nb * rows, k, SHARE_SIZE), codec,
                       out=slabs[g, d][0].view(nb * rows, n2, SHARE_SIZE))
    mark("row_pass")
    partials = {(g, d): rs.col_parity_partial(slabs[g, d][0], coeffs[g][d]) for g, d, _ in shards}
    mark("col_parity")
    for g in range(groups):  # Q2 | Q3: the shard's parity rows
        collectives.reduce_scatter_xor([partials[g, d] for d in range(R)], axis=1,
                                       outs=[slabs[g, d][1] for d in range(R)])
    del partials
    mark("reduce_scatter")
    row_part, col_part = {}, {}
    for g, d, dev in shards:
        grid = torch.empty((2, nb, rows, n2, DIGEST), dtype=torch.uint8, device=dev)
        nmt_ops.leaf_digests_window(slabs[g, d][0], d * rows, out=grid[0])
        nmt_ops.leaf_digests_window(slabs[g, d][1], k + d * rows, out=grid[1])
        row_part[g, d] = _reduce_rows(grid.view(2 * nb * rows, n2, DIGEST)).view(2, nb, rows, DIGEST)
        col_part[g, d] = _column_roots(grid.view(2 * nb, rows, n2, DIGEST)).view(2, nb, n2, DIGEST)
    mark("hashing")
    gathered_rows, gathered_nodes = [], []
    for g in range(groups):
        gathered_rows.append(collectives.all_gather([row_part[g, d] for d in range(R)],
                                                    axis=2, tiled=True))
        gathered_nodes.append(collectives.all_gather([col_part[g, d] for d in range(R)], axis=1))
    mark("gathers")
    shard_rr, shard_cc, data_roots = [], [], []
    for g in range(groups):
        finished = {}
        for nodes in gathered_nodes[g]:
            if nodes.device not in finished:
                finished[nodes.device] = _finish_columns(nodes)
        shard_cc.append([finished[nodes.device] for nodes in gathered_nodes[g]])
        # (2, nb, k, 90) -> a square's row roots in EDS row order
        shard_rr.append([r.transpose(0, 1).reshape(nb, n2, DIGEST) for r in gathered_rows[g]])
        all_roots = torch.cat([shard_rr[g][0], shard_cc[g][0]], dim=1)  # (nb, 4k, 90)
        data_roots.append(nmt_ops.rfc6962_root_pow2(all_roots))
    mark("finish")
    first = mesh.first_device
    eds = torch.empty((n, 2, k, n2, SHARE_SIZE), dtype=torch.uint8, device=first)
    for g in range(groups):
        collectives.gather_to([slabs[g, d].transpose(0, 1) for d in range(R)], first, axis=2,
                              out=eds[g * nb : (g + 1) * nb])
    run = ShardedRun(
        eds=eds.view(n, n2, n2, SHARE_SIZE),
        row_roots=collectives.gather_to([rr[0] for rr in shard_rr], first),
        col_roots=collectives.gather_to([cc[0] for cc in shard_cc], first),
        data_roots=collectives.gather_to(data_roots, first),
        slabs=[[slabs[g, d] for d in range(R)] for g in range(groups)],
        shard_row_roots=shard_rr,
        shard_col_roots=shard_cc,
    )
    mark("assemble")
    if phases is not None:
        breakdown.update(phases.ms())
    return run


def _bracketed(name: str, squares: np.ndarray, mesh: Mesh, groups: int,
               breakdown: dict = None) -> ShardedRun:
    """:func:`_extend_sharded` under the ``extend.sharded`` span, its upload
    charged to the ledger's ``name`` leg and the run bracketed as one
    dispatch on every device of its groups (JAX :232-254, :296-316)."""
    n, k = squares.shape[0], squares.shape[1]
    codec = gf256.active_codec()
    data_ax, row_ax = mesh.shape["data"], mesh.shape["row"]
    args = dict(k=k, mesh=f"{data_ax}x{row_ax}", codec=codec)
    if name == "extend_sharded_batch":
        args["batch"] = n
    with tracing.span("extend.sharded", mesh_data=data_ax, mesh_row=row_ax, **args):
        devprof.record_transfer(name, "h2d", int(squares.nbytes))
        d = devprof.dispatch(name, [dev for g in range(groups) for dev in mesh.devices[g]],
                             multi_device=True, **args)
        return d.done(_extend_sharded(squares, mesh, groups, breakdown))


def _extend_and_roots_sharded_device(square: np.ndarray, mesh: Mesh, *,
                                     record_stats: bool = True,
                                     breakdown: dict = None) -> ShardedRun:
    """One square uint8[k, k, 512] through the mesh, results on the devices
    (:class:`ShardedRun`, n = 1).  The square runs on the first data group:
    one controller needs no copy of it per group (``shard_map`` computes it
    on every group, replicated).  ``breakdown`` receives each phase's ms
    (``upload``, ``row_pass``, ``col_parity``, ``reduce_scatter``,
    ``hashing``, ``gathers``, ``finish``, ``assemble``).
    ``record_stats=False`` keeps warm-up extends out of the provider's
    sharded-extends counter."""
    square = np.asarray(square, dtype=np.uint8)
    if square.ndim != 3:
        raise ValueError(f"square must be (k, k, {SHARE_SIZE}), got {square.shape}")
    run = _bracketed("extend_sharded", square[None], mesh, 1, breakdown)
    if record_stats:
        mesh_mod.record_sharded_extend()
    return run


def _fetch(leg: str, *tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors on the host in one device-to-host copy, charged to the
    transfer ledger's ``leg``."""
    host = devprof.fetch(leg, torch.cat([t.reshape(-1) for t in tensors])).numpy()
    out, off = [], 0
    for t in tensors:
        out.append(host[off : off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


def extend_and_roots_sharded(square: np.ndarray, mesh: Mesh, *, record_stats: bool = True):
    """Sharded extension with host results: square uint8[k, k, 512] ->
    (eds uint8[2k, 2k, 512], row_roots uint8[2k, 90], col_roots uint8[2k,
    90], data_root uint8[32]), all four in one copy.
    :func:`extend_and_header_sharded` keeps the EDS on the device."""
    run = _extend_and_roots_sharded_device(square, mesh, record_stats=record_stats)
    eds, rr, cc, dr = _fetch("sharded_results", run.eds, run.row_roots, run.col_roots, run.data_roots)
    return eds[0], rr[0], cc[0], dr[0]


def _extend_and_roots_sharded_batch_device(squares: np.ndarray, mesh: Mesh, *,
                                           count_squares: int = None,
                                           breakdown: dict = None) -> ShardedRun:
    """A batch uint8[n, k, k, 512], n divisible by the ``data`` axis, over
    the whole mesh: n/D squares per data group (the catch-up leg).
    ``count_squares``: how many of the n are real squares (the rest are the
    caller's padding), for the provider's counter."""
    squares = np.asarray(squares, dtype=np.uint8)
    if squares.ndim != 4:
        raise ValueError(f"squares must be (n, k, k, {SHARE_SIZE}), got {squares.shape}")
    run = _bracketed("extend_sharded_batch", squares, mesh, mesh.shape["data"], breakdown)
    mesh_mod.record_sharded_extend(
        batched=True, squares=squares.shape[0] if count_squares is None else count_squares
    )
    return run


def extend_and_roots_sharded_batch(squares: np.ndarray, mesh: Mesh, *,
                                   count_squares: int = None):
    """The batched sharded extension with host results: (eds uint8[n, 2k,
    2k, 512], row_roots uint8[n, 2k, 90], col_roots uint8[n, 2k, 90],
    data_roots uint8[n, 32]), in one copy."""
    run = _extend_and_roots_sharded_batch_device(squares, mesh, count_squares=count_squares)
    return tuple(_fetch("sharded_results", run.eds, run.row_roots, run.col_roots, run.data_roots))


# ---------------------------------------------------------------------------
# (EDS, DAH) entries for the proposal lifecycle
# ---------------------------------------------------------------------------


def _header_from_roots(row_roots: np.ndarray, col_roots: np.ndarray, data_root: np.ndarray):
    """A DataAvailabilityHeader from the sharded roots, its hash the data
    root the mesh computed (the tests hold it against the host fold)."""
    from celestia_tpu_torch.da.dah import DataAvailabilityHeader

    n2 = row_roots.shape[0]
    return DataAvailabilityHeader(
        tuple(row_roots[i].tobytes() for i in range(n2)),
        tuple(col_roots[i].tobytes() for i in range(n2)),
        np.asarray(data_root).tobytes(),
    )


def extend_and_header_sharded(square: np.ndarray, mesh: Mesh):
    """The mesh twin of da/dah.extend_and_header: square uint8[k, k, 512] ->
    (ExtendedDataSquare on the mesh's first device, DataAvailabilityHeader),
    byte-identical to the single-device path.  Only the roots cross to the
    host, in one copy."""
    from celestia_tpu_torch.da.dah import ExtendedDataSquare

    run = _extend_and_roots_sharded_device(square, mesh)
    rr, cc, dr = _fetch("sharded_roots", run.row_roots, run.col_roots, run.data_roots)
    return ExtendedDataSquare(run.eds[0]), _header_from_roots(rr[0], cc[0], dr[0])


def extend_block_sharded(square, mesh: Mesh):
    """The mesh twin of da/dah.extend_block: a da.square.Square in, (EDS,
    DAH) out."""
    k = square.size
    return extend_and_header_sharded(square.to_array().reshape(k, k, SHARE_SIZE), mesh)


def extend_and_headers_sharded_batch(squares: np.ndarray, mesh: Mesh, *,
                                     count_squares: int = None) -> list:
    """(EDS, DAH) of each of n same-k squares, n a multiple of the ``data``
    axis (the caller pads the batch and drops the pads' results, passing
    ``count_squares`` so pads never count).  The roots of the whole batch
    cross in one copy; each EDS stays on the mesh's first device."""
    from celestia_tpu_torch.da.dah import ExtendedDataSquare

    run = _extend_and_roots_sharded_batch_device(squares, mesh, count_squares=count_squares)
    rr, cc, drs = _fetch("sharded_roots", run.row_roots, run.col_roots, run.data_roots)
    return [
        (ExtendedDataSquare(run.eds[i]), _header_from_roots(rr[i], cc[i], drs[i]))
        for i in range(run.eds.shape[0])
    ]
