"""2D Reed-Solomon extension: the CUDA kernel K5 and its plain PyTorch twin.

Counterpart of the extension half of ``celestia_tpu/ops/rs.py``
(``rsmt2d.ComputeExtendedDataSquare``, pkg/da/data_availability_header.go:65-75).
Everything is integer arithmetic, bit-exact across devices — a consensus
requirement.

Representation: a square is ``uint8[k, k, 512]`` (row, column, byte).
Quadrant layout of the extended square (2k x 2k):

    Q0 | Q1        Q0 = original, Q1 = row parity,
    -------        Q2 = column parity, Q3 = column parity of Q1
    Q2 | Q3

* On a CUDA tensor :func:`extend_square` launches ``rs_extend``
  (``csrc/rs_extend.cu``), the JAX package's formulation on the int8
  tensor cores: the GF(256) map lifted to GF(2), ``(G @ bits) & 1``, with
  G built in the kernel from the codec's encode matrix
  E = ``gf256.encode_matrix(k, codec)`` and field tables
  (``csrc/rs_extend.cuh``).
* On a CPU tensor it runs :func:`_extend`, the same lift in PyTorch, with
  G = ``gf256.encode_matrix_bits(k, codec)`` (see :func:`matmul_gf2`).
Both give the same bytes: G is E lifted bit by bit (gf256.py
``bit_expand_matrix``) either way.

:func:`extend_squares_batched` extends a batch of squares (K5b
``rs_extend_batched`` on the card).  The sharded extension
(parallel/sharded.py, K9) runs K5's row pass on a shard's rows
(:func:`extend_rows`), its column-parity partial (K9a
``rs_col_parity_partial``, :func:`col_parity_partial`) and the XOR of the
partials' slabs, read where they lie (K9b ``xor_reduce_slabs``,
:func:`xor_reduce_scatter`).  The repair half (``rsmt2d.Repair``,
:func:`repair_square_device`) peels the availability mask on the host
(:func:`_simulate_schedule`, bools only), then on the square's device
builds every Lagrange decode matrix in one launch (K8a
``rs_decode_matrices``), decodes the solvable axes of each phase and
orientation in place (K8b ``rs_decode_axes``), re-extends Q0 (K5), flags
the cells that disagree (K8c ``rs_repair_verdicts``) and hashes the axis
roots (K2 + K3), then fetches the verdicts once.  On CPU tensors the same
host loop runs the plain versions, which keep the JAX package's GF(2)
lift (:func:`_bit_expand_dev`).
"""

from __future__ import annotations

import ctypes
import threading
import time
from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from celestia_tpu_torch import kernels
from celestia_tpu_torch.appconsts import SHARE_SIZE, is_power_of_two
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.ops import nmt as nmt_ops
from celestia_tpu_torch.utils.device import resolve_device


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """uint8[..., n, B] -> int8 bits[..., 8n, B]; bit row j*8+t = bit t of byte row j."""
    t = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x[..., :, None, :] >> t[None, :, None]) & 1  # (..., n, 8, B)
    shape = tuple(x.shape[:-2]) + (8 * x.shape[-2], x.shape[-1])
    return bits.reshape(shape).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """int bits[..., 8n, B] -> uint8[..., n, B] (inverse of unpack_bits)."""
    shape = tuple(bits.shape[:-2]) + (bits.shape[-2] // 8, 8, bits.shape[-1])
    b = bits.reshape(shape).to(torch.uint8)
    out = b[..., 0, :].clone()
    for t in range(1, 8):
        out |= b[..., t, :] << t
    return out


def matmul_gf2(G: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(G @ bits) mod 2 for 0/1 operands: G [m, 8k], bits [..., 8k, B].

    On the CPU the product is int8 x int8 -> int32 (``torch._int_mm``), the
    JAX formulation exactly and ~8x faster there than a float product.  On
    the card ``_int_mm`` refuses m <= 16 (k < 4), so the product runs in
    float32, which is exact too: the sums are at most 8k <= 1024 < 2**24,
    and TF32 keeps 0 and 1 exact."""
    n, B = bits.shape[-2:]
    lead = tuple(bits.shape[:-2])
    flat = bits.reshape(-1, n, B)
    if bits.device.type == "cpu":
        acc = torch._int_mm(G.to(torch.int8), flat.transpose(0, 1).reshape(n, -1))
        acc = acc.reshape(G.shape[0], -1, B).transpose(0, 1)
    else:
        acc = torch.matmul(G.to(torch.float32), flat.to(torch.float32)).to(torch.int32)
    return (acc & 1).to(torch.int8).reshape(lead + (G.shape[0], B))


# rows per product in _row_parity: bounds the bit planes' memory (16 rows of
# a k = 128 square are 8 MiB of int8 bits)
_ROW_CHUNK = 16


def _row_parity(square: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """(r, k, B) uint8 -> (r, k, B) uint8 parity of each row."""
    return torch.cat(
        [pack_bits(matmul_gf2(G, unpack_bits(rows))) for rows in square.split(_ROW_CHUNK)]
    )


def _extend(square: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Plain twin of K5: uint8[k, k, B] -> uint8[2k, 2k, B]."""
    q0 = square
    q1 = _row_parity(q0, G)  # row parity
    q2 = _row_parity(q0.transpose(0, 1), G).transpose(0, 1)  # col parity
    q3 = _row_parity(q1.transpose(0, 1), G).transpose(0, 1)  # parity of parity
    top = torch.cat([q0, q1], dim=1)
    bottom = torch.cat([q2, q3], dim=1)
    return torch.cat([top, bottom], dim=0)


@lru_cache(maxsize=None)
def encode_matrix_bits_tensor(k: int, codec: str, device: str) -> torch.Tensor:
    """G = gf256.encode_matrix_bits(k, codec) as an int8 tensor on ``device``."""
    return torch.from_numpy(gf256.encode_matrix_bits(k, codec).copy()).to(device)


@lru_cache(maxsize=None)
def _kernel_constants(k: int, codec: str, device: str):
    """(E, exp, log) uint8 tensors on the card for K5."""
    exp, log = gf256.field_tables(codec)
    E = np.ascontiguousarray(gf256.encode_matrix(k, codec), dtype=np.uint8)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(device)
        for a in (E, exp, log)
    )


def _check_square(square: torch.Tensor, share_size=None) -> int:
    """k of a uint8[k, k, B] square (B = ``share_size`` when given)."""
    k = square.shape[0]
    if (
        square.dim() != 3
        or square.shape[1] != k
        or (share_size is not None and square.shape[2] != share_size)
        or not is_power_of_two(k)
        or k > 128
    ):
        raise ValueError(
            f"square must be (k, k, {share_size or 'B'}) with k a power of two "
            f"<= 128, got {tuple(square.shape)}"
        )
    if square.dtype != torch.uint8:
        raise ValueError(f"square must be uint8, got {square.dtype}")
    return k


def _check_aligned(t: torch.Tensor, name: str) -> None:
    """The bit-GEMM kernels move 8 and 16 bytes a lane: raise unless ``t``
    starts on a 16-byte boundary."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch_extend(kernel: str, src: torch.Tensor, k: int, n: int, codec: str, *extra):
    """uint8[n, 2k, 2k, 512] from ``kernel`` (K5 or K5b) on ``src``, the
    checked square or batch; ``extra`` follows k in the C entry's arguments."""
    E, exp, log = _kernel_constants(k, codec, str(src.device))
    eds = torch.empty((n, 2 * k, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=src.device)
    if n:
        kernels.launch(
            kernel, src.device, src.data_ptr(), eds.data_ptr(),
            E.data_ptr(), exp.data_ptr(), log.data_ptr(), k, *extra,
            launches=2,  # Q1+Q2 of every square, then Q3 (Q0 is a 2D device copy)
        )
    return eds


def extend_cuda(square: torch.Tensor, codec: str) -> torch.Tensor:
    """Launch K5 ``rs_extend`` on a square on the card with ``codec``."""
    k = _check_square(square, SHARE_SIZE)
    kernels.check_cuda_tensor(square, "square")
    _check_aligned(square, "square")
    return _launch_extend("rs_extend", square, k, 1, codec)[0]


def extend_plain(square: torch.Tensor, codec: str) -> torch.Tensor:
    """The plain twin of K5 with ``codec``, on the square's device."""
    k = _check_square(square)
    return _extend(square, encode_matrix_bits_tensor(k, codec, str(square.device)))


def extend_square(square: torch.Tensor) -> torch.Tensor:
    """Extend an original square uint8[k, k, 512] to its EDS uint8[2k, 2k, 512]
    with the active codec: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    codec = gf256.active_codec()
    gf256.mark_codec_used()
    if square.device.type == "cpu":
        return extend_plain(square, codec)
    return extend_cuda(square, codec)


def _check_batch(squares: torch.Tensor, share_size=None) -> int:
    """k of a uint8[n, k, k, B] batch (B = ``share_size`` when given)."""
    k = squares.shape[1] if squares.dim() == 4 else 0
    if (
        squares.dim() != 4
        or squares.shape[2] != k
        or (share_size is not None and squares.shape[3] != share_size)
        or not is_power_of_two(k)
        or k > 128
    ):
        raise ValueError(
            f"batch must be (n, k, k, {share_size or 'B'}) with k a power of two "
            f"<= 128, got {tuple(squares.shape)}"
        )
    if squares.dtype != torch.uint8:
        raise ValueError(f"batch must be uint8, got {squares.dtype}")
    return k


def extend_batched_cuda(squares: torch.Tensor, codec: str) -> torch.Tensor:
    """Launch K5b ``rs_extend_batched`` on a batch of squares on the card."""
    k = _check_batch(squares, SHARE_SIZE)
    kernels.check_cuda_tensor(squares, "squares")
    _check_aligned(squares, "squares")
    n = squares.shape[0]
    return _launch_extend("rs_extend_batched", squares, k, n, codec, n)


def extend_batched_plain(squares: torch.Tensor, codec: str) -> torch.Tensor:
    """The plain twin of K5b: the plain twin of K5 on each square."""
    k = _check_batch(squares)
    G = encode_matrix_bits_tensor(k, codec, str(squares.device))
    n, B = squares.shape[0], squares.shape[3]
    if not n:
        return torch.empty((0, 2 * k, 2 * k, B), dtype=torch.uint8, device=squares.device)
    return torch.stack([_extend(sq, G) for sq in squares])


def extend_squares_batched(squares: torch.Tensor) -> torch.Tensor:
    """Extend a batch uint8[n, k, k, 512] -> uint8[n, 2k, 2k, 512] with the
    active codec (JAX ``extend_squares_batched``, celestia_tpu/ops/rs.py:107):
    K5b on a CUDA tensor, the plain version on a CPU tensor."""
    codec = gf256.active_codec()
    gf256.mark_codec_used()
    if squares.device.type == "cpu":
        return extend_batched_plain(squares, codec)
    return extend_batched_cuda(squares, codec)


# ---------------------------------------------------------------------------
# The sharded extension's pieces (parallel/sharded.py, K9): K5's row pass
# over a shard's rows, the shard's column-parity partial (K9a
# ``rs_col_parity_partial``) and the XOR of the partials' slabs (K9b
# ``xor_reduce_slabs``).  The plain versions keep the JAX package's forms
# (celestia_tpu/parallel/sharded.py:60-95).
# ---------------------------------------------------------------------------

# gridDim.y of K5's row pass (one row axis per block row)
_MAX_ROW_AXES = 65535


def _check_rows(rows: torch.Tensor, share_size=None) -> int:
    """k of rows uint8[n, k, B] of a square (B = ``share_size`` when given)."""
    if rows.dim() != 3:
        raise ValueError(f"rows must be (n, k, B), got {tuple(rows.shape)}")
    k = rows.shape[1]
    if (
        not is_power_of_two(k)
        or k > 128
        or (share_size is not None and rows.shape[2] != share_size)
    ):
        raise ValueError(
            f"rows must be (n, k, {share_size or 'B'}) with k a power of two <= 128, "
            f"got {tuple(rows.shape)}"
        )
    if rows.dtype != torch.uint8:
        raise ValueError(f"rows must be uint8, got {rows.dtype}")
    return k


def extend_rows_plain(rows: torch.Tensor, codec: str) -> torch.Tensor:
    """Plain twin of K5's row pass: uint8[n, k, B] -> uint8[n, 2k, B], each
    row followed by its parity (JAX ``_extend_rows_local``, sharded.py:60)."""
    k = _check_rows(rows)
    G = encode_matrix_bits_tensor(k, codec, str(rows.device))
    return torch.cat([rows, _row_parity(rows, G)], dim=1)


def extend_rows_cuda(rows: torch.Tensor, codec: str, out: torch.Tensor = None) -> torch.Tensor:
    """K5's row pass on the card (``ctt_rs_extend_rows``, counted as
    ``rs_extend``): one 2D copy and one launch, into ``out`` when given."""
    k = _check_rows(rows, SHARE_SIZE)
    kernels.check_cuda_tensor(rows, "rows")
    n = rows.shape[0]
    if n > _MAX_ROW_AXES:
        raise ValueError(f"K5's row pass takes at most {_MAX_ROW_AXES} rows, got {n}")
    shape = (n, 2 * k, SHARE_SIZE)
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=rows.device)
    kernels.check_cuda_tensor(out, "out", shape)
    _check_aligned(rows, "rows")
    _check_aligned(out, "out")
    E, exp, log = _kernel_constants(k, codec, str(rows.device))
    if n:
        kernels.launch(
            "rs_extend", rows.device, rows.data_ptr(), out.data_ptr(), E.data_ptr(),
            exp.data_ptr(), log.data_ptr(), k, n, entry="ctt_rs_extend_rows",
        )
    return out


def extend_rows(rows: torch.Tensor, codec: str, out: torch.Tensor = None) -> torch.Tensor:
    """Rows uint8[n, k, 512] of squares -> uint8[n, 2k, 512] (into ``out``
    when given): K5's row pass on a CUDA tensor, the plain version on a
    CPU tensor."""
    if rows.device.type == "cpu":
        top = extend_rows_plain(rows, codec)
        return top if out is None else out.copy_(top)
    return extend_rows_cuda(rows, codec, out)


def partial_coefficients(k: int, j0: int, n_in: int, codec: str, device) -> tuple:
    """K9a's coefficients for the shard whose rows start at ``j0``, on
    ``device``: on the card the shard's column slice of
    ``gf256.encode_matrix(k, codec)`` (uint8[k, n_in]) and the codec's
    (exp, log) tables; on the CPU the same slice of the bit-expanded matrix,
    ``G[:, 8 j0 : 8 (j0 + n_in)]`` (JAX's ``g_cols``, sharded.py:83)."""
    device = torch.device(device)
    if not (0 <= j0 and n_in >= 1 and j0 + n_in <= k):
        raise ValueError(f"rows {j0}..{j0 + n_in - 1} are not rows of a square of {k}")
    if device.type == "cpu":
        return (encode_matrix_bits_tensor(k, codec, "cpu")[:, 8 * j0 : 8 * (j0 + n_in)],)
    E = np.ascontiguousarray(gf256.encode_matrix(k, codec)[:, j0 : j0 + n_in], dtype=np.uint8)
    exp, log = gf256.field_tables(codec)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(device) for a in (E, exp, log)
    )


def _check_top(top: torch.Tensor, k: int) -> int:
    """n_in of a shard's top rows uint8[n, n_in, 2k, B]."""
    if top.dim() != 4 or top.shape[2] != 2 * k or top.dtype != torch.uint8:
        raise ValueError(f"top must be uint8 (n, n_in, {2 * k}, B), got {tuple(top.shape)} "
                         f"{top.dtype}")
    return top.shape[1]


def col_parity_partial_plain(top: torch.Tensor, g_cols: torch.Tensor) -> torch.Tensor:
    """Plain twin of K9a, the JAX bit-lift (sharded.py:82-87, packed):
    top uint8[n, n_in, 2k, B] and ``g_cols`` int8[8k, 8 n_in] ->
    partial uint8[n, k, 2k, B] = pack((g_cols @ bits(top by column)) & 1)."""
    k = g_cols.shape[0] // 8
    n_in = _check_top(top, k)
    if g_cols.shape[1] != 8 * n_in:
        raise ValueError(f"g_cols must be (8k, {8 * n_in}), got {tuple(g_cols.shape)}")
    bits = unpack_bits(top.transpose(1, 2))  # (n, 2k, 8 n_in, B)
    return pack_bits(matmul_gf2(g_cols, bits)).transpose(1, 2).contiguous()


def col_parity_partial_cuda(top: torch.Tensor, Es: torch.Tensor, exp: torch.Tensor,
                            log: torch.Tensor) -> torch.Tensor:
    """Launch K9a ``rs_col_parity_partial``: top uint8[n, n_in, 2k, 512] on
    the card with the shard's slice ``Es`` uint8[k, n_in] of the encode
    matrix -> partial uint8[n, k, 2k, 512]."""
    k, n_in = Es.shape
    if not is_power_of_two(k) or k > 128 or _check_top(top, k) != n_in:
        raise ValueError(f"top {tuple(top.shape)} and Es {tuple(Es.shape)} disagree")
    n = top.shape[0]
    kernels.check_cuda_tensor(top, "top", (n, n_in, 2 * k, SHARE_SIZE))
    _check_aligned(top, "top")
    for t, name in ((Es, "Es"), (exp, "exp"), (log, "log")):
        kernels.check_cuda_tensor(t, name)
        if t.device != top.device:
            raise ValueError(f"{name} is on {t.device}, top on {top.device}")
    partial = torch.empty((n, k, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=top.device)
    if n:
        kernels.launch(
            "rs_col_parity_partial", top.device, top.data_ptr(), partial.data_ptr(),
            Es.data_ptr(), exp.data_ptr(), log.data_ptr(), k, n_in, n,
        )
    return partial


def col_parity_partial(top: torch.Tensor, coefficients: tuple) -> torch.Tensor:
    """A shard's share of every column-parity row: top uint8[n, n_in, 2k,
    512] -> uint8[n, k, 2k, 512], with the shard's
    :func:`partial_coefficients`: K9a on a CUDA tensor, the plain version
    on a CPU tensor."""
    if top.device.type == "cpu":
        return col_parity_partial_plain(top, *coefficients)
    return col_parity_partial_cuda(top, *coefficients)


def xor_reduce_slabs_plain(staged: torch.Tensor) -> torch.Tensor:
    """Plain twin of K9b: uint8[R, ...] -> uint8[...], a loop of
    ``torch.bitwise_xor``."""
    out = staged[0].clone()
    for slab in staged[1:]:
        torch.bitwise_xor(out, slab, out=out)
    return out


# K9b's shard counts (a template parameter of the kernel each) and its most
# destinations a launch (csrc/rs_sharded.cuh kXorMaxShards)
XOR_SHARDS = (1, 2, 4, 8)
_XOR_MAX_DSTS = 8


def _check_partials(partials: Sequence[torch.Tensor], axis: int):
    """Raise unless the partials are R equal uint8 tensors on one device
    whose ``axis`` splits into R slabs; return (slab shape, slab length)."""
    R = len(partials)
    if not R:
        raise ValueError("a reduce-scatter needs at least one partial")
    shape = tuple(partials[0].shape)
    for p in partials:
        if tuple(p.shape) != shape or p.dtype != torch.uint8 or p.device != partials[0].device:
            raise ValueError(f"partials disagree: uint8{shape} on {partials[0].device} against "
                             f"{p.dtype}{tuple(p.shape)} on {p.device}")
    if not 0 <= axis < len(shape) or shape[axis] % R:
        raise ValueError(f"axis {axis} of {shape} does not split over {R} shards")
    m = shape[axis] // R
    return shape[:axis] + (m,) + shape[axis + 1:], m


def xor_reduce_scatter_plain(partials: Sequence[torch.Tensor], dests: Sequence[int],
                             outs: Sequence[torch.Tensor], axis: int) -> None:
    """Plain twin of K9b's reduce-scatter: ``outs[i]`` = the XOR of slab
    ``dests[i]`` (along ``axis``) of every partial, by
    :func:`xor_reduce_slabs_plain`."""
    _, m = _check_partials(partials, axis)
    for d, out in zip(dests, outs):
        out.copy_(xor_reduce_slabs_plain(torch.stack([p.narrow(axis, d * m, m) for p in partials])))


def xor_reduce_scatter_cuda(partials: Sequence[torch.Tensor], dests: Sequence[int],
                            outs: Sequence[torch.Tensor], axis: int) -> None:
    """Launch K9b once: ``outs[i]`` (contiguous) = the XOR of slab
    ``dests[i]`` along ``axis`` of the R contiguous ``partials``, read in
    place (their base pointers, the slabs' offsets and the batch stride by
    value).  R in :data:`XOR_SHARDS`, at most 8 outputs, everything on one
    card and 16-byte aligned; anything else raises."""
    R, n_dst = len(partials), len(outs)
    if R not in XOR_SHARDS:
        raise ValueError(f"K9b reduces R in {XOR_SHARDS} shards, got {R}")
    if not 1 <= n_dst <= _XOR_MAX_DSTS or len(dests) != n_dst:
        raise ValueError(f"K9b takes 1..{_XOR_MAX_DSTS} destinations, each with its slab")
    slab_shape, m = _check_partials(partials, axis)
    for i, p in enumerate(partials):
        kernels.check_cuda_tensor(p, f"partial {i}")
    for i, out in enumerate(outs):
        kernels.check_cuda_tensor(out, f"out {i}", slab_shape)
        if out.device != partials[0].device:
            raise ValueError(f"out {i} is on {out.device}, the partials on {partials[0].device}")
    if not all(0 <= d < R for d in dests):
        raise ValueError(f"destination slabs {list(dests)} outside 0..{R - 1}")
    shape = partials[0].shape
    nb = int(np.prod(shape[:axis], dtype=np.int64))
    post = int(np.prod(shape[axis + 1:], dtype=np.int64))
    slab_bytes, bstride = m * post, shape[axis] * post
    peers = np.array([p.data_ptr() for p in partials], dtype=np.int64)
    dsts = np.array([o.data_ptr() for o in outs], dtype=np.int64)
    offs = np.array(dests, dtype=np.int64) * slab_bytes
    if nb > 65535:
        raise ValueError(f"K9b takes at most 65535 batches, got {nb}")
    if slab_bytes % 16 or np.any(peers % 16) or np.any(dsts % 16):
        raise ValueError("K9b moves 16-byte words: slabs and addresses must be multiples of "
                         "16 bytes")
    if slab_bytes and nb:
        kernels.launch("xor_reduce_slabs", outs[0].device, peers.ctypes.data_as(ctypes.c_void_p),
                       R, dsts.ctypes.data_as(ctypes.c_void_p),
                       offs.ctypes.data_as(ctypes.c_void_p), n_dst, slab_bytes, nb, bstride)


def xor_reduce_scatter(partials: Sequence[torch.Tensor], dests: Sequence[int],
                       outs: Sequence[torch.Tensor], axis: int) -> None:
    """``outs[i]`` = the XOR of slab ``dests[i]`` (along ``axis``) of every
    partial: K9b (one launch for all the destinations, the partials read in
    place) on CUDA tensors, the plain version on CPU tensors."""
    if partials[0].device.type == "cpu":
        xor_reduce_scatter_plain(partials, dests, outs, axis)
    else:
        xor_reduce_scatter_cuda(partials, dests, outs, axis)


# ---------------------------------------------------------------------------
# Repair (rsmt2d.Repair): the host peels the availability mask, the
# square's device decodes, re-extends and checks
#
# Which axes become solvable in which order depends only on the boolean
# availability mask, never on share values, so the host simulates the
# peeling schedule on bools and ships only the solvable axes' known
# positions.  The plain versions below mirror the JAX program
# (celestia_tpu/ops/rs.py:138-284): decode matrices in the log domain, the
# GF(2) lift, bit products.  K8b runs the same lift on the tensor cores
# (K5's kernel with per-axis coefficients); both give the same bytes.
# ---------------------------------------------------------------------------


def _gf_tables_dev(codec: str = None, device="cpu"):
    """The codec's (exp, log) tables as int64 tensors on ``device``."""
    exp, log = gf256.field_tables(codec)
    return (
        torch.from_numpy(np.asarray(exp, dtype=np.int64)).to(device),
        torch.from_numpy(np.asarray(log, dtype=np.int64)).to(device),
    )


def _decode_matrices_dev(known: torch.Tensor, k: int, codec: str = None) -> torch.Tensor:
    """Plain twin of K8a (JAX :150): known uint8[n, k] (distinct POSITIONS
    per row) -> D uint8[n, 2k, k].  Position -> field point is XOR with k
    under the leopard codec (gf256.position_points)."""
    codec = gf256._resolve(codec)
    exp, log = _gf_tables_dev(codec, known.device)
    xor_const = k if codec == gf256.CODEC_LEOPARD else 0
    src = known.to(torch.int64) ^ xor_const  # [n, k]
    dst = torch.arange(2 * k, dtype=torch.int64, device=known.device) ^ xor_const
    diff_ss = src[:, None, :] ^ src[:, :, None]  # [n, j, m]
    diag = torch.arange(k, device=known.device)
    diff_ss[:, diag, diag] = 1
    denom_log = log[diff_ss].sum(dim=2) % 255  # [n, j]
    diff_ds = dst[None, :, None] ^ src[:, None, :]  # [n, i, m]
    zero_mask = diff_ds == 0
    safe = torch.where(zero_mask, torch.ones_like(diff_ds), diff_ds)
    log_all = log[safe]  # [n, i, m]
    total_log = log_all.sum(dim=2)  # [n, i]
    has_zero = zero_mask.any(dim=2)  # [n, i]
    num_log = (total_log[:, :, None] - log_all) % 255  # [n, i, j]
    lagrange = exp[(num_log - denom_log[:, None, :]) % 255]
    return torch.where(
        has_zero[:, :, None], zero_mask.to(torch.int64), lagrange
    ).to(torch.uint8)


@lru_cache(maxsize=None)
def _bit_basis(codec: str) -> np.ndarray:
    """B[u, s, t] = bit s of gf_mul(2^u, 2^t) — the GF(2) lift is LINEAR
    in the operand's bits: M(a)[s,t] = XOR_u a_u * B[u,s,t].  Expanding a
    matrix therefore needs no table gathers (slow on TPU), just one tiny
    contraction over u against this 8x8x8 constant.  Holds in both codec
    representations (the Cantor-index map is GF(2)-linear)."""
    powers = np.uint8(1) << np.arange(8, dtype=np.uint8)
    prod = gf256.gf_mul(powers[:, None], powers[None, :], codec)  # [u, t]
    s = np.arange(8, dtype=np.uint8)
    return ((prod[:, None, :] >> s[None, :, None]) & 1).astype(np.int8)


def _bit_expand_dev(D: torch.Tensor, codec: str = None) -> torch.Tensor:
    """Port of gf256.bit_expand_matrix, batched (JAX :191): uint8[n, m, c]
    -> int8 0/1 [n, 8m, 8c].  The contraction runs in float32, exact for
    sums of at most 8 ones."""
    n, m, c = D.shape
    u = torch.arange(8, dtype=torch.uint8, device=D.device)
    a_bits = ((D[:, :, :, None] >> u) & 1).to(torch.float32)  # [n, m, c, u]
    B = torch.from_numpy(_bit_basis(gf256._resolve(codec))).to(D.device, torch.float32)
    acc = torch.einsum("nmcu,ust->nmsct", a_bits, B).to(torch.int32)
    return (acc & 1).to(torch.int8).reshape(n, 8 * m, 8 * c)


def _gf_product_bits(D: torch.Tensor, X: torch.Tensor, codec: str) -> torch.Tensor:
    """out[a] = D[a] X[a] over GF(256) through the GF(2) lift: D uint8[n, R,
    k], X uint8[n, k, B] -> uint8[n, R, B].  The bit product runs in
    float32, exact: the sums are at most 8k <= 1024 < 2**24."""
    D_bits = _bit_expand_dev(D, codec).to(torch.float32)  # [n, 8R, 8k]
    X_bits = unpack_bits(X).to(torch.float32)  # [n, 8k, B]
    return pack_bits(torch.bmm(D_bits, X_bits).to(torch.int32) & 1)


def _gather_known(data: torch.Tensor, known: torch.Tensor) -> torch.Tensor:
    """X[a, j] = data[a, known[a, j]]: uint8[n, 2k, B], [n, k] -> [n, k, B]."""
    idx = known.to(torch.int64)[:, :, None].expand(-1, -1, data.shape[2])
    return torch.gather(data, 1, idx)


# axes per bit product in decode_axes_plain: bounds the float32 bit planes
# (D_bits is 16k x 8k floats per axis, 8 MiB at k = 128)
def _plain_chunk(k: int) -> int:
    return max(1, 1024 // k)


def decode_matrices_cuda(known: torch.Tensor, k: int, codec: str) -> torch.Tensor:
    """Launch K8a ``rs_decode_matrices``: known uint8[n, k] on the card ->
    D uint8[n, 2k, k]."""
    kernels.check_cuda_tensor(known, "known")
    n = known.shape[0]
    if known.dim() != 2 or known.shape[1] != k or not is_power_of_two(k) or k > 128:
        raise ValueError(f"known must be (n, {k}) with k a power of two <= 128, "
                         f"got {tuple(known.shape)}")
    _, exp, log = _kernel_constants(k, codec, str(known.device))
    D = torch.empty((n, 2 * k, k), dtype=torch.uint8, device=known.device)
    if n:
        xor_const = k if codec == gf256.CODEC_LEOPARD else 0
        kernels.launch(
            "rs_decode_matrices", known.device, known.data_ptr(), D.data_ptr(),
            exp.data_ptr(), log.data_ptr(), n, k, xor_const,
        )
    return D


def decode_matrices(known: torch.Tensor, k: int, codec: str) -> torch.Tensor:
    """The Lagrange decode matrices of a batch of known-position sets: K8a
    on a CUDA tensor, the plain version on a CPU tensor."""
    if known.device.type == "cpu":
        return _decode_matrices_dev(known, k, codec)
    return decode_matrices_cuda(known, k, codec)


def _check_decode_args(eds, D, known, axes) -> int:
    n2 = eds.shape[0]
    k = n2 // 2
    n = axes.shape[0]
    if (
        eds.dim() != 3
        or eds.shape[1] != n2
        or tuple(D.shape) != (n, n2, k)
        or tuple(known.shape) != (n, k)
        or axes.dim() != 1
    ):
        raise ValueError(
            f"decode_axes takes eds (2k, 2k, B), D (n, 2k, k), known (n, k), axes (n,); "
            f"got {tuple(eds.shape)}, {tuple(D.shape)}, {tuple(known.shape)}, "
            f"{tuple(axes.shape)}"
        )
    return k


def decode_axes_plain(
    eds: torch.Tensor, D: torch.Tensor, known: torch.Tensor, axes: torch.Tensor,
    cols: bool, codec: str,
) -> torch.Tensor:
    """Plain twin of K8b: decode axes ``axes`` of one orientation of ``eds``
    (rows, or columns when ``cols``) from their known positions with D, as
    JAX ``_decode_axes_dev`` (:206) does for every axis, and write each
    whole axis back, as JAX ``_repair_phases`` (:249, :252) does for the
    solvable ones.  In place, chunked over axes; returns ``eds``."""
    k = _check_decode_args(eds, D, known, axes)
    view = eds.transpose(0, 1) if cols else eds
    idx = axes.to(torch.int64)
    X = _gather_known(view[idx], known)
    chunk = _plain_chunk(k)
    if idx.numel():
        view[idx] = torch.cat([
            _gf_product_bits(Dc, Xc, codec) for Dc, Xc in zip(D.split(chunk), X.split(chunk))
        ])
    return eds


def decode_axes_cuda(
    eds: torch.Tensor, D: torch.Tensor, known: torch.Tensor, axes: torch.Tensor,
    cols: bool, codec: str,
) -> torch.Tensor:
    """Launch K8b ``rs_decode_axes``: decode axes ``axes`` (int32) of one
    orientation of an EDS on the card in place, writing only the positions
    that are not known.  ``known`` holds k distinct positions per axis (the
    schedule's); an axis whose index or positions lie past 2k is left
    unwritten by the kernel rather than read or written out of bounds."""
    k = _check_decode_args(eds, D, known, axes)
    kernels.check_cuda_tensor(eds, "eds", (2 * k, 2 * k, SHARE_SIZE))
    _check_aligned(eds, "eds")
    kernels.check_cuda_tensor(D, "D")
    kernels.check_cuda_tensor(known, "known")
    if axes.dtype != torch.int32 or axes.device != eds.device or not axes.is_contiguous():
        raise ValueError("axes must be a contiguous int32 tensor on the EDS's device")
    if not is_power_of_two(k) or k > 128:
        raise ValueError(f"k must be a power of two <= 128, got {k}")
    _, exp, log = _kernel_constants(k, codec, str(eds.device))
    if axes.numel():
        kernels.launch(
            "rs_decode_axes", eds.device, eds.data_ptr(), D.data_ptr(), known.data_ptr(),
            axes.data_ptr(), exp.data_ptr(), log.data_ptr(), axes.numel(), k, int(cols),
        )
    return eds


def decode_axes(eds, D, known, axes, cols: bool, codec: str) -> torch.Tensor:
    """Decode axes of one orientation in place: K8b on a CUDA tensor, the
    plain version on a CPU tensor."""
    if eds.device.type == "cpu":
        return decode_axes_plain(eds, D, known, axes, cols, codec)
    return decode_axes_cuda(eds, D, known, axes, cols, codec)


def repair_verdicts_plain(repaired, recomputed, provided, avail):
    """Plain twin of K8c (JAX :276-277): uint8[2k, 2k] masks ``mismatch``
    (repaired != recomputed) and ``provided_mismatch`` (avail and repaired
    != provided)."""
    mismatch = (repaired != recomputed).any(dim=-1)
    provided_mismatch = avail.to(torch.bool) & (repaired != provided).any(dim=-1)
    return mismatch.to(torch.uint8), provided_mismatch.to(torch.uint8)


def repair_verdicts_cuda(repaired, recomputed, provided, avail):
    """Launch K8c ``rs_repair_verdicts`` over every cell."""
    n2 = repaired.shape[0]
    for t, name in ((repaired, "repaired"), (recomputed, "recomputed"), (provided, "provided")):
        kernels.check_cuda_tensor(t, name, (n2, n2, SHARE_SIZE))
    kernels.check_cuda_tensor(avail, "avail", (n2, n2))
    mismatch = torch.empty((n2, n2), dtype=torch.uint8, device=repaired.device)
    provided_mismatch = torch.empty_like(mismatch)
    kernels.launch(
        "rs_repair_verdicts", repaired.device, repaired.data_ptr(), recomputed.data_ptr(),
        provided.data_ptr(), avail.data_ptr(), mismatch.data_ptr(),
        provided_mismatch.data_ptr(), n2 * n2,
    )
    return mismatch, provided_mismatch


def repair_verdicts(repaired, recomputed, provided, avail):
    """The two verdict masks of a repair: K8c on CUDA tensors, the plain
    version on CPU tensors."""
    if repaired.device.type == "cpu":
        return repair_verdicts_plain(repaired, recomputed, provided, avail)
    return repair_verdicts_cuda(repaired, recomputed, provided, avail)


def _simulate_schedule(avail: np.ndarray, k: int):
    """Peel the availability mask on the host (bools only): returns the
    per-phase (row_known, row_mask, col_known, col_mask) tensors the
    device program consumes.  Raises if the mask cannot reconstruct."""
    n2 = 2 * k
    avail = avail.copy()
    row_known, row_mask, col_known, col_mask = [], [], [], []

    def plan(mask2d):
        counts = mask2d.sum(axis=1)
        solvable = (counts >= k) & (counts < n2)
        # first k available positions per axis (arbitrary valid points for
        # unsolvable axes — their results are masked out)
        order = np.argsort(~mask2d, axis=1, kind="stable")
        known = np.sort(order[:, :k], axis=1).astype(np.uint8)
        known[~solvable] = np.arange(k, dtype=np.uint8)[None, :]
        return known, solvable

    while not avail.all():
        rk, rm = plan(avail)
        avail[rm] = True
        ck, cm = plan(avail.T)
        avail[:, cm] = True
        if not (rm.any() or cm.any()):
            raise ValueError(
                "repair stalled: insufficient available cells to reconstruct"
            )
        row_known.append(rk)
        row_mask.append(rm)
        col_known.append(ck)
        col_mask.append(cm)
    if not row_known:  # nothing missing: zero phases
        return None
    return (
        np.stack(row_known),
        np.stack(row_mask),
        np.stack(col_known),
        np.stack(col_mask),
    )


def _schedule_tensors(schedule, device):
    """The solvable axes of every phase and orientation, in launch order:
    (known uint8[N, k], axes int32[N]) on ``device`` and the segments
    (offset, count, cols) of each (phase, orientation) that has any."""
    rk, rm, ck, cm = schedule
    knowns, axes, segments, off = [], [], [], 0
    for p in range(rk.shape[0]):
        for cols, (kn, mask) in enumerate(((rk[p], rm[p]), (ck[p], cm[p]))):
            idx = np.nonzero(mask)[0]
            if len(idx):
                knowns.append(kn[idx])
                axes.append(idx.astype(np.int32))
                segments.append((off, len(idx), bool(cols)))
                off += len(idx)
    known = torch.from_numpy(np.ascontiguousarray(np.concatenate(knowns))).to(device)
    axes_t = torch.from_numpy(np.concatenate(axes)).to(device)
    return known, axes_t, segments


def _repair_phases(eds: torch.Tensor, schedule, k: int, codec: str) -> torch.Tensor:
    """The P peeling phases (rows then columns each) on ``eds`` in place,
    as a host loop of launches: one decode-matrix launch (K8a) for every
    phase and orientation (D depends only on the schedule), then one
    decode launch (K8b) per (phase, orientation) with solvable axes.  On a
    CPU tensor the plain versions run."""
    if schedule is None:
        return eds
    known, axes, segments = _schedule_tensors(schedule, eds.device)
    D = decode_matrices(known, k, codec)
    for off, count, cols in segments:
        sl = slice(off, off + count)
        decode_axes(eds, D[sl], known[sl], axes[sl], cols, codec)
    return eds


def _repair_verify(repaired, provided, avail, k: int, with_roots: bool):
    """The checks of JAX ``_repair_verify`` (:257) on the repaired square's
    device: re-extension of its Q0 (K5), both verdict masks (K8c) and,
    when asked, the axis roots (K2 + K3)."""
    recomputed = extend_square(repaired[:k, :k].contiguous())
    mismatch, provided_mismatch = repair_verdicts(repaired, recomputed, provided, avail)
    roots = nmt_ops.eds_nmt_roots(repaired) if with_roots else None
    return mismatch, provided_mismatch, roots


class ByzantineError(ValueError):
    """The available shares are not a consistent Reed-Solomon codeword
    (rsmt2d ErrByzantine parity): a malicious proposer published shares that
    disagree with the polynomial through the rest of their row/column."""


_plain_lock = threading.Lock()
_plain_repairs = 0  # guarded by _plain_lock


def plain_repairs() -> int:
    """Repairs run on the host through the plain versions in this process."""
    with _plain_lock:
        return _plain_repairs


def _count_plain_repair() -> None:
    global _plain_repairs
    with _plain_lock:
        _plain_repairs += 1


def _host_array(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def repair_square_device(
    eds,
    available,
    row_roots: np.ndarray = None,
    col_roots: np.ndarray = None,
    breakdown: dict = None,
    return_device: bool = False,
    device=None,
):
    """rsmt2d.Repair on the square's device (JAX :350).

    Reconstruct, then prove the result is the unique codeword matching
    everything the caller provided (:class:`ByzantineError` otherwise) and
    the committed DAH roots when given.  A numpy ``eds`` is uploaded to
    ``device`` (``None``: the card; ``"cpu"``: the plain versions on the
    host); a tensor is repaired on its own device and left unchanged.  On
    the card every phase count runs there (the JAX package hands P > 4 to
    the host, :399-404) and share size must be 512; nothing falls back.

    ``return_device=True`` returns the repaired tensor on its device (no
    bulk fetch).  ``breakdown`` receives ``schedule_ms`` (the host peel,
    before the upload), ``upload_compute_ms``, ``verdict_fetch_ms``,
    ``upload_overlapped`` (False: a pageable upload blocks the host, so the
    peel runs first), ``bulk_fetch_ms`` when the square is fetched, and on
    the card ``kernels_ms``, the launch sequence timed with CUDA events."""
    t0 = time.perf_counter()
    avail = np.asarray(_host_array(available), dtype=bool)
    if isinstance(eds, torch.Tensor):
        if eds.dtype != torch.uint8:
            raise ValueError(f"eds must be uint8, got {eds.dtype}")
        dev = eds.device
        host = None
    else:
        dev = resolve_device(device)
        host = np.ascontiguousarray(eds, dtype=np.uint8)
    shape = tuple(eds.shape)
    n2 = shape[0]
    k = n2 // 2
    if len(shape) != 3 or shape[:2] != (n2, n2) or avail.shape != (n2, n2):
        raise ValueError("eds must be (2k, 2k, B) with matching availability mask")
    if dev.type == "cuda" and shape[2] != SHARE_SIZE:
        raise ValueError(
            f"repair on the card takes {SHARE_SIZE}-byte shares, got {shape[2]}"
        )
    codec = gf256.active_codec()
    schedule = _simulate_schedule(avail, k)  # bools only; raises when stalled
    t1 = time.perf_counter()
    if dev.type == "cpu":
        _count_plain_repair()
    events = None
    if dev.type == "cuda" and breakdown is not None:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    if host is not None:
        provided = torch.from_numpy(host if host.flags.writeable else host.copy()).to(dev)
    else:
        provided = eds.contiguous()
    avail_dev = torch.from_numpy(avail.astype(np.uint8)).to(dev)
    with_roots = row_roots is not None or col_roots is not None
    if events:
        events[0].record()
    # every unavailable cell is written by the decode before any axis reads
    # it, so the repair starts from the provided bytes as they are (JAX
    # zeroes them first, :387: the same result)
    repaired = _repair_phases(provided.clone(), schedule, k, codec)
    mismatch_dev, provided_dev, roots_dev = _repair_verify(
        repaired, provided, avail_dev, k, with_roots
    )
    if events:
        events[1].record()
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    t2 = time.perf_counter()
    # ONE fetch of every verdict (and the roots)
    parts = [mismatch_dev.reshape(-1), provided_dev.reshape(-1)]
    if with_roots:
        parts.append(roots_dev.reshape(-1))
    fetched = torch.cat(parts).cpu().numpy()
    cells = n2 * n2
    mismatch_axes = fetched[:cells].reshape(n2, n2).astype(bool)
    provided_mismatch = fetched[cells : 2 * cells].reshape(n2, n2).astype(bool)
    roots = fetched[2 * cells :].reshape(2, n2, -1) if with_roots else None
    t3 = time.perf_counter()
    if breakdown is not None:
        breakdown.update(
            schedule_ms=(t1 - t0) * 1000.0,
            upload_compute_ms=(t2 - t1) * 1000.0,
            verdict_fetch_ms=(t3 - t2) * 1000.0,
            upload_overlapped=False,
        )
        if events:
            breakdown["kernels_ms"] = events[0].elapsed_time(events[1])
    if mismatch_axes.any():
        bad = np.nonzero(mismatch_axes)
        raise ByzantineError(
            f"inconsistent erasure coding at cells {list(zip(*bad))[:8]}"
        )
    if provided_mismatch.any():
        bad = np.nonzero(provided_mismatch)
        raise ByzantineError(
            f"provided shares disagree with the reconstructed codeword at "
            f"cells {list(zip(*bad))[:8]}"
        )
    if with_roots:
        for name, axis_roots, got in (
            ("row", row_roots, roots[0]),
            ("col", col_roots, roots[1]),
        ):
            if axis_roots is None:
                continue
            axis_roots = np.asarray(_host_array(axis_roots), dtype=np.uint8)
            if axis_roots.shape != got.shape:
                raise ValueError(
                    f"{name}_roots must be {got.shape}, got {axis_roots.shape}"
                )
            bad = np.nonzero((axis_roots != got).any(axis=1))[0]
            if len(bad):
                raise ByzantineError(
                    f"reconstructed {name} axes {bad.tolist()[:8]} do not "
                    f"match the committed NMT roots"
                )
    if return_device:
        return repaired
    t5 = time.perf_counter()
    out = repaired.cpu().numpy()
    if breakdown is not None:
        breakdown["bulk_fetch_ms"] = (time.perf_counter() - t5) * 1000.0
    return out


def repair_square(
    eds,
    available,
    row_roots: np.ndarray = None,
    col_roots: np.ndarray = None,
) -> np.ndarray:
    """Reconstruct a full EDS from a partial one on the host (rsmt2d.Repair
    parity, JAX :531): :func:`repair_square_device` with ``device="cpu"``,
    through the plain versions.

    eds: uint8[2k, 2k, B] with garbage in unavailable cells; available:
    bool[2k, 2k]; row_roots / col_roots: optional uint8[2k, 90] committed
    NMT axis roots.  Raises ValueError when the repair stalls and
    :class:`ByzantineError` when the provided shares are not a consistent
    codeword or do not match the roots.  The JAX package's native host legs
    (its Leopard FFT decoder, which writes only erased cells) are not
    ported; the plain path overwrites each solved axis whole, as the
    JAX device program does.  A tensor on another device raises
    ValueError: repair it with :func:`repair_square_device` there."""
    if isinstance(eds, torch.Tensor) and eds.device.type != "cpu":
        raise ValueError(f"repair_square repairs on the host, got eds on {eds.device}")
    return repair_square_device(np.asarray(eds), available, row_roots, col_roots, device="cpu")


# ---------------------------------------------------------------------------
# Host reference (numpy) for bit-exactness tests
# ---------------------------------------------------------------------------


def extend_square_ref(square: np.ndarray) -> np.ndarray:
    """Pure-numpy reference of extend_square; the device must match exactly."""
    square = np.asarray(square, dtype=np.uint8)
    k = square.shape[0]
    B = square.shape[2]
    out = np.zeros((2 * k, 2 * k, B), dtype=np.uint8)
    out[:k, :k] = square
    for r in range(k):  # row parity
        out[r, k:] = gf256.encode_shares_ref(square[r])
    for c in range(2 * k):  # column parity (over the top half)
        out[k:, c] = gf256.encode_shares_ref(out[:k, c])
    return out
