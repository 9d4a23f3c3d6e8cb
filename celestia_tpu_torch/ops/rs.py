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

* On a CUDA tensor :func:`extend_square` launches K5 ``rs_extend``, whose
  kernel the codec picks, and nothing else: under ``leopard-ff8`` (the
  chain's codec) Leopard's O(k log k) IFFT/FFT (``csrc/rs_leopard.cu``,
  the encode of ``native/celestia_native.cpp`` ``leo_encode``, with the
  skew tables of :func:`_leopard_tables`); under ``lagrange-gf256`` the
  JAX package's formulation on the int8 tensor cores
  (``csrc/rs_extend.cu``): the GF(256) map lifted to GF(2),
  ``(G @ bits) & 1``, with G built in the kernel from the codec's encode
  matrix E = ``gf256.encode_matrix(k, codec)`` and field tables
  (``csrc/rs_extend.cuh``).  K5b and K5's row pass follow the same rule.
* On a CPU tensor it runs :func:`_extend`, the bit lift in PyTorch, with
  G = ``gf256.encode_matrix_bits(k, codec)`` (see :func:`matmul_gf2`).
All give the same bytes: a systematic MDS code's parity is fixed by its
field, points and layout, whatever computes it (gf256.py "codec
selection").

:func:`extend_squares_batched` extends a batch of squares (K5b
``rs_extend_batched`` on the card).  The sharded extension
(parallel/sharded.py, K9) runs K5's row pass on a shard's rows
(:func:`extend_rows`), its column-parity partial (K9a
``rs_col_parity_partial``, :func:`col_parity_partial`; its kernel the
codec's, as K5's: under ``leopard-ff8`` Leopard's encode with the shard's
zero rows pruned, ``csrc/rs_leopard_partial.cu``; under ``lagrange-gf256``
the bit-GEMM) and the XOR of the partials' slabs, read where they lie (K9b
``xor_reduce_slabs``, :func:`xor_reduce_scatter`).  The repair half
(``rsmt2d.Repair``, :func:`repair_square_device`) peels the availability
mask on the host (:func:`_simulate_schedule`, bools only), then on the
square's device decodes the solvable axes of each phase and orientation in
place (K8b ``rs_decode_axes``), re-extends Q0 (K5), flags the cells that
disagree (K8c ``rs_repair_verdicts``) and hashes the axis roots (K2 + K3),
then fetches the verdicts once.  K8b's kernel is the codec's, as K5's:
under ``leopard-ff8`` Leopard's O(k log k) erasure decode from each axis's
k known positions (``csrc/rs_leopard_decode.cu``, its plain version
:func:`decode_axes_fft_plain`); under ``lagrange-gf256`` every Lagrange
decode matrix built in one launch first (K8a ``rs_decode_matrices``) and
the bit-GEMM (``csrc/rs_decode.cu``, its plain version the JAX package's
GF(2) lift, :func:`_bit_expand_dev`).  On CPU tensors the same host loop
runs the plain versions.  :func:`repair_square` is the JAX package's host
repair on the native library: Leopard's erasure decoder under
``leopard-ff8``, the Lagrange matrices and a GF matmul under
``lagrange-gf256``, a native re-extension and root pass to check.
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
from celestia_tpu_torch.utils import devprof
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
def _field_tensors(codec: str, device: str):
    """The codec's (exp uint8[512], log uint8[256]) tables on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8)).to(device)
                 for a in gf256.field_tables(codec))


@lru_cache(maxsize=None)
def _kernel_constants(k: int, codec: str, device: str):
    """(E, exp, log) uint8 tensors on the card for the bit-GEMM kernels."""
    E = np.ascontiguousarray(gf256.encode_matrix(k, codec), dtype=np.uint8)
    return (torch.from_numpy(E).to(device), *_field_tensors(codec, device))


# bytes of a group's skew tables (csrc/rs_leopard.cuh kLeoGroupWords words)
_LEO_GROUP_BYTES = 24


@lru_cache(maxsize=None)
def _leopard_tables(k: int, device: str) -> torch.Tensor:
    """The skew tables of the FFT kernel's k-share encode under
    leopard-ff8 (``ctt_rs_leopard_tables``, whose function the g++ twin runs
    too: 2(k - 1) groups of 24 bytes) as a uint8 tensor on ``device``,
    built and uploaded once per (k, device)."""
    exp, log = (np.ascontiguousarray(a, dtype=np.uint8)
                for a in gf256.field_tables(gf256.CODEC_LEOPARD))
    out = np.zeros(max(1, 2 * (k - 1) * _LEO_GROUP_BYTES), dtype=np.uint8)
    kernels.host_call("ctt_rs_leopard_tables", exp.ctypes.data, log.ctypes.data, k,
                      out.ctypes.data, out.nbytes)
    return torch.from_numpy(out).to(device)


def _fft_form(codec: str) -> bool:
    """K5's and K8b's kernel by codec: Leopard's FFT form under leopard-ff8,
    the bit-GEMM under lagrange-gf256."""
    if codec not in gf256.CODECS:
        raise ValueError(f"unknown codec {codec!r}; expected one of {gf256.CODECS}")
    return codec == gf256.CODEC_LEOPARD


# K5 and K5b: kernel name -> the FFT kernel's C entry
_FFT_ENTRIES = {"rs_extend": "ctt_rs_leopard_extend",
                "rs_extend_batched": "ctt_rs_leopard_extend_batched"}


def _k5_tables(k: int, codec: str, device: torch.device, fft: bool) -> tuple:
    """The table pointers K5's kernel takes after k's data: the FFT's skew
    tables, or the bit-GEMM's (E, exp, log)."""
    if fft:
        return (_leopard_tables(k, str(device)).data_ptr(),)
    return tuple(t.data_ptr() for t in _kernel_constants(k, codec, str(device)))


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
    """The Reed-Solomon kernels move 4, 8 and 16 bytes a lane: raise unless
    ``t`` starts on a 16-byte boundary."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _launch_extend(kernel: str, src: torch.Tensor, k: int, n: int, codec: str, fft: bool,
                   *extra):
    """uint8[n, 2k, 2k, 512] from ``kernel`` (K5 or K5b) on ``src``, the
    checked square or batch, by its FFT entry (``fft``, under leopard-ff8)
    or its bit-GEMM entry; ``extra`` follows k in the C entry's arguments."""
    eds = torch.empty((n, 2 * k, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=src.device)
    if not n:
        return eds
    kernels.launch(
        kernel, src.device, src.data_ptr(), eds.data_ptr(), *_k5_tables(k, codec, src.device, fft),
        k, *extra,
        launches=2,  # Q1+Q2 of every square, then Q3 (Q0 is a 2D device copy)
        entry=_FFT_ENTRIES[kernel] if fft else None,
    )
    return eds


def extend_cuda(square: torch.Tensor, codec: str) -> torch.Tensor:
    """Launch K5 ``rs_extend`` on a square on the card with ``codec``: the
    FFT kernel under leopard-ff8, the bit-GEMM under lagrange-gf256."""
    return _extend_cuda(square, codec, _fft_form(codec))


def extend_bit_gemm_cuda(square: torch.Tensor, codec: str) -> torch.Tensor:
    """K5's bit-GEMM kernel (``ctt_rs_extend``) with ``codec``'s encode
    matrix whatever the codec: what :func:`extend_cuda` runs under
    lagrange-gf256, and under leopard-ff8 the yardstick ``chip_smoke.py``
    holds the FFT kernel against.  No path calls it."""
    return _extend_cuda(square, codec, False)


def _extend_cuda(square: torch.Tensor, codec: str, fft: bool) -> torch.Tensor:
    k = _check_square(square, SHARE_SIZE)
    kernels.check_cuda_tensor(square, "square")
    _check_aligned(square, "square")
    return _launch_extend("rs_extend", square, k, 1, codec, fft)[0]


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
    """Launch K5b ``rs_extend_batched`` on a batch of squares on the card:
    the FFT kernel under leopard-ff8, the bit-GEMM under lagrange-gf256."""
    return _extend_batched_cuda(squares, codec, _fft_form(codec))


def extend_batched_bit_gemm_cuda(squares: torch.Tensor, codec: str) -> torch.Tensor:
    """K5b's bit-GEMM kernel whatever the codec (as
    :func:`extend_bit_gemm_cuda`); no path calls it."""
    return _extend_batched_cuda(squares, codec, False)


def _extend_batched_cuda(squares: torch.Tensor, codec: str, fft: bool) -> torch.Tensor:
    k = _check_batch(squares, SHARE_SIZE)
    kernels.check_cuda_tensor(squares, "squares")
    _check_aligned(squares, "squares")
    n = squares.shape[0]
    return _launch_extend("rs_extend_batched", squares, k, n, codec, fft, n)


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
    d = devprof.dispatch("rs_extend_batched", squares.device, k=int(squares.shape[1]),
                         n=int(squares.shape[0]))
    if squares.device.type == "cpu":
        return d.done(extend_batched_plain(squares, codec))
    return d.done(extend_batched_cuda(squares, codec))


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
    """K5's row pass on the card (counted as ``rs_extend``): one 2D copy and
    one launch, into ``out`` when given; the FFT kernel
    (``ctt_rs_leopard_extend_rows``) under leopard-ff8, the bit-GEMM
    (``ctt_rs_extend_rows``) under lagrange-gf256."""
    return _extend_rows_cuda(rows, codec, out, _fft_form(codec))


def extend_rows_bit_gemm_cuda(rows: torch.Tensor, codec: str,
                              out: torch.Tensor = None) -> torch.Tensor:
    """K5's row pass by the bit-GEMM kernel whatever the codec (as
    :func:`extend_bit_gemm_cuda`); no path calls it."""
    return _extend_rows_cuda(rows, codec, out, False)


def _extend_rows_cuda(rows: torch.Tensor, codec: str, out, fft: bool) -> torch.Tensor:
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
    if n:
        kernels.launch(
            "rs_extend", rows.device, rows.data_ptr(), out.data_ptr(),
            *_k5_tables(k, codec, rows.device, fft), k, n,
            entry="ctt_rs_leopard_extend_rows" if fft else "ctt_rs_extend_rows",
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


def _check_shard(k: int, j0: int, n_in: int) -> None:
    if not (0 <= j0 and n_in >= 1 and j0 + n_in <= k):
        raise ValueError(f"rows {j0}..{j0 + n_in - 1} are not rows of a square of {k}")


def partial_coefficients(k: int, j0: int, n_in: int, codec: str, device) -> tuple:
    """K9a's coefficients for the shard whose rows start at ``j0``, on
    ``device``.  On the CPU the shard's column slice of the bit-expanded
    matrix, ``(G[:, 8 j0 : 8 (j0 + n_in)],)`` (JAX's ``g_cols``,
    sharded.py:83).  On the card the codec and its form's constants,
    which :func:`col_parity_partial_cuda` takes: under leopard-ff8 the
    shard's skew tables and j0 (:func:`leopard_partial_coefficients`),
    under lagrange-gf256 the shard's column slice of the encode matrix and
    the field tables (:func:`bit_gemm_partial_coefficients`)."""
    device = torch.device(device)
    _check_shard(k, j0, n_in)
    if device.type == "cpu":
        return (encode_matrix_bits_tensor(k, codec, "cpu")[:, 8 * j0 : 8 * (j0 + n_in)],)
    if _fft_form(codec):
        return (codec, *leopard_partial_coefficients(k, j0, n_in, device))
    return (codec, *bit_gemm_partial_coefficients(k, j0, n_in, codec, device))


def _leopard_partial_table_bytes(k: int, n_in: int) -> int:
    """Bytes of the FFT form's tables for a shard of n_in rows of k
    (csrc/rs_leopard.cuh ``leo_partial_table_bytes``; at least 1)."""
    groups = (n_in - 1) + (k.bit_length() - n_in.bit_length()) + (k - 1) if k > 1 else 0
    return max(1, groups * _LEO_GROUP_BYTES)


def leopard_partial_coefficients(k: int, j0: int, n_in: int, device) -> tuple:
    """The FFT form's constants for the shard at ``j0`` of ``n_in`` rows
    (a power of two dividing j0): its skew tables
    (``ctt_rs_leopard_partial_tables``, whose function the g++ twin runs
    too: the block's n_in - 1 groups, one a later IFFT layer, the FFT's k
    - 1, 24 bytes each) as a uint8 tensor on ``device``, and j0."""
    _check_shard(k, j0, n_in)
    if not is_power_of_two(n_in) or j0 % n_in:
        raise ValueError(f"the FFT form takes a power-of-two shard at a multiple of its rows, "
                         f"got rows {j0}..{j0 + n_in - 1}")
    exp, log = (np.ascontiguousarray(a, dtype=np.uint8)
                for a in gf256.field_tables(gf256.CODEC_LEOPARD))
    out = np.zeros(_leopard_partial_table_bytes(k, n_in), dtype=np.uint8)
    kernels.host_call("ctt_rs_leopard_partial_tables", exp.ctypes.data, log.ctypes.data, k, n_in,
                      j0, out.ctypes.data, out.nbytes)
    return torch.from_numpy(out).to(device), j0


def bit_gemm_partial_coefficients(k: int, j0: int, n_in: int, codec: str, device) -> tuple:
    """The bit-GEMM form's constants for the shard at ``j0``, on
    ``device``: the shard's column slice of ``gf256.encode_matrix(k,
    codec)`` (uint8[k, n_in]) and the codec's (exp, log) tables."""
    _check_shard(k, j0, n_in)
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


def _partial_out(top: torch.Tensor, k: int, n_in: int) -> torch.Tensor:
    """Check a shard's top rows on the card for a K9a launch and allocate
    its partial uint8[n, k, 2k, 512]."""
    if not is_power_of_two(k) or k > 128 or _check_top(top, k) != n_in:
        raise ValueError(f"top {tuple(top.shape)} is no shard of {n_in} rows of a square of {k}")
    n = top.shape[0]
    kernels.check_cuda_tensor(top, "top", (n, n_in, 2 * k, SHARE_SIZE))
    _check_aligned(top, "top")
    return torch.empty((n, k, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=top.device)


def col_parity_partial_fft_cuda(top: torch.Tensor, tab: torch.Tensor, j0: int) -> torch.Tensor:
    """Launch K9a ``rs_col_parity_partial`` in its leopard-ff8 form,
    Leopard's O(k log k) encode with the shard's zero rows pruned
    (``ctt_rs_leopard_col_parity_partial``, csrc/rs_leopard_partial.cu):
    top uint8[n, n_in, 2k, 512] on the card, the shard's rows from ``j0``,
    with its :func:`leopard_partial_coefficients` tables ``tab`` ->
    partial uint8[n, k, 2k, 512]."""
    if top.dim() != 4:
        raise ValueError(f"top must be (n, n_in, 2k, 512), got {tuple(top.shape)}")
    k, n_in = top.shape[2] // 2, top.shape[1]
    partial = _partial_out(top, k, n_in)
    kernels.check_cuda_tensor(tab, "tab", (_leopard_partial_table_bytes(k, n_in),))
    if tab.device != top.device:
        raise ValueError(f"tab is on {tab.device}, top on {top.device}")
    if top.shape[0]:
        kernels.launch(
            "rs_col_parity_partial", top.device, top.data_ptr(), partial.data_ptr(),
            tab.data_ptr(), k, n_in, j0, top.shape[0], entry="ctt_rs_leopard_col_parity_partial",
        )
    return partial


def col_parity_partial_bit_gemm_cuda(top: torch.Tensor, Es: torch.Tensor, exp: torch.Tensor,
                                     log: torch.Tensor) -> torch.Tensor:
    """Launch K9a ``rs_col_parity_partial`` in its bit-GEMM form
    (``ctt_rs_col_parity_partial``, csrc/rs_extend.cu) whatever the codec:
    top uint8[n, n_in, 2k, 512] on the card with the shard's slice ``Es``
    uint8[k, n_in] of the encode matrix -> partial uint8[n, k, 2k, 512].
    What :func:`col_parity_partial_cuda` runs under lagrange-gf256; under
    leopard-ff8 the yardstick ``chip_smoke.py`` holds the FFT form
    against, on no path."""
    k, n_in = Es.shape
    partial = _partial_out(top, k, n_in)
    for t, name in ((Es, "Es"), (exp, "exp"), (log, "log")):
        kernels.check_cuda_tensor(t, name)
        if t.device != top.device:
            raise ValueError(f"{name} is on {t.device}, top on {top.device}")
    if top.shape[0]:
        kernels.launch(
            "rs_col_parity_partial", top.device, top.data_ptr(), partial.data_ptr(),
            Es.data_ptr(), exp.data_ptr(), log.data_ptr(), k, n_in, top.shape[0],
        )
    return partial


def col_parity_partial_cuda(top: torch.Tensor, codec: str, *constants) -> torch.Tensor:
    """Launch K9a in ``codec``'s form with the form's ``constants`` (the
    card's :func:`partial_coefficients` after its codec): the FFT form
    under leopard-ff8, the bit-GEMM under lagrange-gf256."""
    if _fft_form(codec):
        return col_parity_partial_fft_cuda(top, *constants)
    return col_parity_partial_bit_gemm_cuda(top, *constants)


def col_parity_partial(top: torch.Tensor, coefficients: tuple) -> torch.Tensor:
    """A shard's share of every column-parity row: top uint8[n, n_in, 2k,
    512] -> uint8[n, k, 2k, 512], with the shard's
    :func:`partial_coefficients` on top's device: K9a in the codec's form
    on a CUDA tensor, the plain bit-lift on a CPU tensor."""
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
# positions.  Under lagrange-gf256 the plain versions below mirror the JAX
# program (celestia_tpu/ops/rs.py:138-284): decode matrices in the log
# domain, the GF(2) lift, bit products, and K8b runs the same lift on the
# tensor cores (K5's kernel with per-axis coefficients).  Under leopard-ff8
# K8b is Leopard's erasure decode, which needs no matrix.  All give the
# same bytes: the unique polynomial of degree < k through the known cells.
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
    """k of a decode's arguments; D (n, 2k, k) is checked unless None."""
    n2 = eds.shape[0]
    k = n2 // 2
    n = axes.shape[0]
    if (
        eds.dim() != 3
        or eds.shape[1] != n2
        or (D is not None and tuple(D.shape) != (n, n2, k))
        or tuple(known.shape) != (n, k)
        or axes.dim() != 1
    ):
        raise ValueError(
            f"decode_axes takes eds (2k, 2k, B), D (n, 2k, k) or none, known (n, k), axes (n,); "
            f"got {tuple(eds.shape)}, {None if D is None else tuple(D.shape)}, "
            f"{tuple(known.shape)}, {tuple(axes.shape)}"
        )
    return k


def decode_axes_plain(
    eds: torch.Tensor, D: torch.Tensor, known: torch.Tensor, axes: torch.Tensor,
    cols: bool, codec: str,
) -> torch.Tensor:
    """Plain twin of K8b's bit-GEMM form: decode axes ``axes`` of one
    orientation of ``eds`` (rows, or columns when ``cols``) from their known
    positions with D, as JAX ``_decode_axes_dev`` (:206) does for every
    axis, and write each whole axis back, as JAX ``_repair_phases`` (:249,
    :252) does for the solvable ones.  In place, chunked over axes; returns
    ``eds``."""
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


@lru_cache(maxsize=None)
def _leopard_decode_consts(k: int):
    """The constants of the plain Leopard decode over n = 2k points, as
    numpy arrays: the skew of each group of each transform layer (coset 0:
    LEO_SKEW[j][2^(j+1) g]), the derivative's constants c_i = W_i'(0) /
    W_i(v_i), the codec's product table, and log(x_p ^ x_m) for every
    point pair with a point's own term 0."""
    codec = gf256.CODEC_LEOPARD
    n = 2 * k
    log_n = n.bit_length() - 1
    W = np.arange(256, dtype=np.uint8)
    skews = []
    for j in range(log_n):
        skew = gf256.gf_mul(W, gf256.gf_inv(W[1 << j], codec), codec)
        skews.append(skew[(np.arange(n >> (j + 1)) << (j + 1)) & 255])
        W = gf256.gf_mul(W, W[np.arange(256) ^ (1 << j)], codec)
    derivs = []
    for i in range(log_n):
        num = den = np.uint8(1)
        for v in range(1, 1 << i):
            num = gf256.gf_mul(num, v, codec)
        for v in range(1 << i):
            den = gf256.gf_mul(den, (1 << i) ^ v, codec)
        derivs.append(int(gf256.gf_div(num, den, codec)))
    _, log = gf256.field_tables(codec)
    diff = np.arange(n)[:, None] ^ np.arange(n)[None, :]
    log_diff = np.where(diff == 0, 0, log[diff])
    return skews, derivs, gf256.mul_table(codec), log_diff


def _leopard_layer(w: torch.Tensor, j: int, skew: torch.Tensor, fft: bool, mul) -> None:
    """Layer j of the IFFT (``fft`` False) or the FFT over w [c, n, B] in
    place: group g pairs points 2^(j+1) g + m and that + 2^j, skew[g]."""
    c, n, B = w.shape
    d = 1 << j
    v = w.view(c, n // (2 * d), 2, d, B)
    a, b = v[:, :, 0], v[:, :, 1]
    s = skew.view(1, -1, 1, 1)
    if fft:
        a ^= mul[s, b.long()]
        b ^= a
    else:
        b ^= a
        a ^= mul[s, b.long()]


def _leopard_decode_block(X: torch.Tensor, known: torch.Tensor, k: int) -> torch.Tensor:
    """Leopard's erasure decode of c axes X uint8[c, 2k, B] (positions)
    whose known positions are the True ones of ``known`` bool[c, 2k]
    (exactly k an axis): the axes with every unknown position decoded."""
    skews, derivs, mul_np, log_diff = _leopard_decode_consts(k)
    dev = X.device
    n = 2 * k
    exp, _ = _gf_tables_dev(gf256.CODEC_LEOPARD, dev)
    mul = torch.from_numpy(mul_np).to(dev)
    perm = torch.arange(n, device=dev) ^ k  # point j is position j ^ k
    Xp, kp = X[:, perm], known[:, perm]
    # the locator in the log domain: L[j] = sum over erased m of log(x_j ^ x_m)
    L = (~kp).double() @ torch.from_numpy(log_diff).to(dev, torch.float64)
    L = L.round().long() % 255
    scale = exp[torch.where(kp, L, (255 - L) % 255)][:, :, None]  # E(x_j), or 1 / E'(x_j)
    w = torch.where(kp[:, :, None], mul[scale, Xp.long()], torch.zeros_like(Xp))
    for j, skew in enumerate(skews):
        _leopard_layer(w, j, torch.from_numpy(skew).to(dev, torch.long), False, mul)
    deriv = torch.zeros_like(w)
    m = torch.arange(n, device=dev)
    for i, c in enumerate(derivs):
        lo = m[(m & (1 << i)) == 0]
        deriv[:, lo] ^= mul[c, w[:, lo | (1 << i)].long()]
    for j in reversed(range(len(skews))):
        _leopard_layer(deriv, j, torch.from_numpy(skews[j]).to(dev, torch.long), True, mul)
    out = torch.where(kp[:, :, None], Xp, mul[scale, deriv.long()])
    return out[:, perm]


def _check_fft_decode_args(eds, known, axes) -> int:
    k = _check_decode_args(eds, None, known, axes)
    if not is_power_of_two(k) or k > 128:
        raise ValueError(f"k must be a power of two <= 128, got {k}")
    return k


def decode_axes_fft_plain(eds: torch.Tensor, known: torch.Tensor, axes: torch.Tensor,
                          cols: bool) -> torch.Tensor:
    """Plain twin of K8b's leopard-ff8 form: Leopard's erasure decode
    (csrc/rs_leopard_decode.cuh's steps on tensors) of axes ``axes`` of one
    orientation of ``eds`` (rows, or columns when ``cols``), each from its k
    known positions ``known``.  Every other position is written with the
    unique polynomial of degree < k through the k known cells (those that
    were provided but not chosen too); the known cells are left.  An axis
    whose index or a known position lies past 2k, or whose known positions
    repeat, is left as it is, as the kernel leaves it.  In place, chunked
    over axes; returns ``eds``."""
    k = _check_fft_decode_args(eds, known, axes)
    n = 2 * k
    if not axes.numel():
        return eds
    dev = eds.device
    pos = known.to(torch.int64)
    ax = axes.to(torch.int64)
    mask = torch.zeros((len(ax), n + 1), dtype=torch.bool, device=dev)
    mask.scatter_(1, pos.clamp(max=n), True)
    mask = mask[:, :n]
    ok = (ax >= 0) & (ax < n) & (pos < n).all(dim=1) & (mask.sum(dim=1) == k)
    view = eds.transpose(0, 1) if cols else eds
    # bounds the long index tensors of the product-table lookups
    chunk = max(1, (1 << 22) // (n * eds.shape[2]))
    for sel in torch.nonzero(ok).flatten().split(chunk):
        rows = ax[sel]
        view[rows] = _leopard_decode_block(view[rows], mask[sel], k)
    return eds


@lru_cache(maxsize=None)
def _leopard_decode_tables(k: int, device: str) -> torch.Tensor:
    """The Leopard decode kernel's tables for k (``ctt_rs_leopard_decode_tables``,
    whose function the g++ twin runs too: the 2k - 1 skew groups of the
    transform at coset 0 and the log2 2k derivative constants, 24 bytes
    each) as a uint8 tensor on ``device``, built and uploaded once per (k,
    device)."""
    exp, log = (np.ascontiguousarray(a, dtype=np.uint8)
                for a in gf256.field_tables(gf256.CODEC_LEOPARD))
    n = 2 * k
    out = np.zeros((n - 1 + n.bit_length() - 1) * _LEO_GROUP_BYTES, dtype=np.uint8)
    kernels.host_call("ctt_rs_leopard_decode_tables", exp.ctypes.data, log.ctypes.data, k,
                      out.ctypes.data, out.nbytes)
    return torch.from_numpy(out).to(device)


def _check_decode_launch(eds, known, axes, k) -> None:
    kernels.check_cuda_tensor(eds, "eds", (2 * k, 2 * k, SHARE_SIZE))
    _check_aligned(eds, "eds")
    kernels.check_cuda_tensor(known, "known")
    if axes.dtype != torch.int32 or axes.device != eds.device or not axes.is_contiguous():
        raise ValueError("axes must be a contiguous int32 tensor on the EDS's device")
    if not is_power_of_two(k) or k > 128:
        raise ValueError(f"k must be a power of two <= 128, got {k}")


def decode_axes_fft_cuda(eds: torch.Tensor, known: torch.Tensor, axes: torch.Tensor,
                         cols: bool) -> torch.Tensor:
    """Launch K8b ``rs_decode_axes`` in its leopard-ff8 form, Leopard's
    O(k log k) erasure decode (``ctt_rs_leopard_decode_axes``,
    csrc/rs_leopard_decode.cu): decode axes ``axes`` (int32) of one
    orientation of an EDS on the card in place from their k known positions,
    writing every other position.  No decode matrix is read.  An axis whose
    index or positions lie past 2k, or whose positions repeat, is left
    unwritten by the kernel rather than read or written out of bounds."""
    k = _check_decode_args(eds, None, known, axes)
    _check_decode_launch(eds, known, axes, k)
    if axes.numel():
        exp, log = _field_tensors(gf256.CODEC_LEOPARD, str(eds.device))
        kernels.launch(
            "rs_decode_axes", eds.device, eds.data_ptr(), known.data_ptr(), axes.data_ptr(),
            _leopard_decode_tables(k, str(eds.device)).data_ptr(), exp.data_ptr(),
            log.data_ptr(), axes.numel(), k, int(cols), entry="ctt_rs_leopard_decode_axes",
        )
    return eds


def decode_axes_bit_gemm_cuda(
    eds: torch.Tensor, D: torch.Tensor, known: torch.Tensor, axes: torch.Tensor,
    cols: bool, codec: str,
) -> torch.Tensor:
    """Launch K8b ``rs_decode_axes`` in its bit-GEMM form
    (``ctt_rs_decode_axes``, csrc/rs_decode.cu) whatever the codec: decode
    axes ``axes`` (int32) of one orientation of an EDS on the card in place
    with K8a's matrices D, writing only the positions that are not known.
    What :func:`decode_axes_cuda` runs under lagrange-gf256; under
    leopard-ff8 the yardstick ``chip_smoke.py`` times the Leopard kernel
    against, on no path.  ``known`` holds k distinct positions per axis (the
    schedule's); an axis whose index or positions lie past 2k is left
    unwritten by the kernel rather than read or written out of bounds."""
    k = _check_decode_args(eds, D, known, axes)
    _check_decode_launch(eds, known, axes, k)
    kernels.check_cuda_tensor(D, "D")
    _, exp, log = _kernel_constants(k, codec, str(eds.device))
    if axes.numel():
        kernels.launch(
            "rs_decode_axes", eds.device, eds.data_ptr(), D.data_ptr(), known.data_ptr(),
            axes.data_ptr(), exp.data_ptr(), log.data_ptr(), axes.numel(), k, int(cols),
        )
    return eds


def decode_axes_cuda(eds, D, known, axes, cols: bool, codec: str) -> torch.Tensor:
    """Launch K8b ``rs_decode_axes`` in ``codec``'s form: Leopard's decode
    under leopard-ff8 (D is not read and may be None), the bit-GEMM with
    K8a's matrices D under lagrange-gf256."""
    if _fft_form(codec):
        return decode_axes_fft_cuda(eds, known, axes, cols)
    return decode_axes_bit_gemm_cuda(eds, D, known, axes, cols, codec)


def decode_axes(eds, D, known, axes, cols: bool, codec: str) -> torch.Tensor:
    """Decode axes of one orientation in place in ``codec``'s form: K8b on a
    CUDA tensor, the plain version of the same form on a CPU tensor
    (:func:`decode_axes_fft_plain` under leopard-ff8, which takes no D;
    :func:`decode_axes_plain` with D under lagrange-gf256)."""
    if eds.device.type == "cpu":
        if _fft_form(codec):
            return decode_axes_fft_plain(eds, known, axes, cols)
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
    as a host loop of launches: one decode launch (K8b) per (phase,
    orientation) with solvable axes.  Under leopard-ff8 K8b is Leopard's
    decode and takes the known positions alone; under lagrange-gf256 one
    decode-matrix launch (K8a) for every phase and orientation (D depends
    only on the schedule) comes first.  On a CPU tensor the plain versions
    run."""
    if schedule is None:
        return eds
    known, axes, segments = _schedule_tensors(schedule, eds.device)
    D = None if _fft_form(codec) else decode_matrices(known, k, codec)
    for off, count, cols in segments:
        sl = slice(off, off + count)
        decode_axes(eds, None if D is None else D[sl], known[sl], axes[sl], cols, codec)
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
    d = devprof.dispatch(
        "rs_repair_verify", dev, k=k, phases=0 if schedule is None else len(schedule[0]),
        axes=0 if schedule is None else int(schedule[1].sum() + schedule[3].sum()),
        roots=with_roots,
    )
    # every unavailable cell is written by the decode before any axis reads
    # it, so the repair starts from the provided bytes as they are (JAX
    # zeroes them first, :387: the same result)
    repaired = _repair_phases(provided.clone(), schedule, k, codec)
    mismatch_dev, provided_dev, roots_dev = d.done(_repair_verify(
        repaired, provided, avail_dev, k, with_roots
    ))
    if events:
        events[1].record()
    if dev.type == "cuda":
        # celint: allow(host-sync) — t2 is the compute/fetch timing boundary of the repair breakdown; d.done() above only drains when profiling is armed, this sync must hold either way (JAX ops/rs.py:427)
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
    # celint: allow(host-sync) — the repaired square's bulk fetch, after the verdicts' copy drained the stream; host callers take numpy (JAX np.asarray of the drained repaired_dev), return_device=True skips it
    out = repaired.cpu().numpy()
    if breakdown is not None:
        breakdown["bulk_fetch_ms"] = (time.perf_counter() - t5) * 1000.0
    return out


def _gf_matmul_axes_host(D: np.ndarray, X: np.ndarray, nthreads=None) -> np.ndarray:
    """out[i] = D[i] x X[i] over GF(256), threaded in the native library
    (JAX :494, its native branch)."""
    from celestia_tpu_torch.utils import native

    return native.gf_matmul_axes(D, X, nthreads=nthreads)


def repair_square(
    eds,
    available,
    row_roots: np.ndarray = None,
    col_roots: np.ndarray = None,
    nthreads: int = None,
) -> np.ndarray:
    """Reconstruct a full EDS from a partial one on the host (rsmt2d.Repair
    parity): the JAX package's host repair (:531-740) on the native library.

    eds: uint8[2k, 2k, B] with garbage in unavailable cells; available:
    bool[2k, 2k]; row_roots / col_roots: optional uint8[2k, 90] committed
    NMT axis roots.  Every row, then column, with >= k available cells is
    solved, phase by phase, until the square is complete: under
    ``leopard-ff8`` by the native Leopard erasure decoder, in place (it
    writes only erased cells), under ``lagrange-gf256`` by one Lagrange
    decode matrix per axis and the native GF matmul (which overwrites each
    solved axis whole).  The result is re-extended natively from Q0 and
    checked cell by cell, then against the roots when given.  Raises
    ValueError when the repair stalls and :class:`ByzantineError` when the
    provided shares are not a consistent codeword or do not match the
    roots, with JAX's messages.  ``nthreads`` (None: the host pool's size)
    threads the decode, the re-extension and the roots; the bytes do not
    depend on it.  Raises RuntimeError without the native library, and
    ValueError for a tensor that is not on the host: repair it with
    :func:`repair_square_device` there."""
    from celestia_tpu_torch.utils import native

    if isinstance(eds, torch.Tensor) and eds.device.type != "cpu":
        raise ValueError(f"repair_square repairs on the host, got eds on {eds.device}")
    native.require()
    # the provided shares are snapshot lazily: the Leopard decoder writes
    # only erased cells, so the final eds == recomputed check covers them;
    # the matrix path snapshots before its first write
    original_eds: np.ndarray = None
    eds = np.array(eds, dtype=np.uint8, copy=True)
    avail = np.array(_host_array(available), dtype=bool, copy=True)
    n2 = eds.shape[0]
    k = n2 // 2
    if eds.ndim != 3 or eds.shape[:2] != (n2, n2) or avail.shape != (n2, n2):
        raise ValueError("eds must be (2k, 2k, B) with matching availability mask")
    eds[~avail] = 0  # garbage cannot leak through the masks
    leopard = gf256.active_codec() == gf256.CODEC_LEOPARD

    while not avail.all():
        progress = False
        for axis in (0, 1):  # rows then columns
            data = eds if axis == 0 else eds.transpose(1, 0, 2)
            mask = avail if axis == 0 else avail.T
            counts = mask.sum(axis=1)
            idxs = np.nonzero((counts >= k) & (counts < n2))[0]
            if len(idxs) == 0:
                continue
            if leopard:
                if axis == 0 and bool((counts >= k).all()):
                    # every row holds >= k cells: decode the whole
                    # contiguous square in place (complete rows are no-ops)
                    ok = native.leo_decode_axes(eds, avail.astype(np.uint8), nthreads=nthreads)
                    if not ok.all():
                        raise RuntimeError("leo_decode_axes rejected a solvable axis")
                    avail[:, :] = True
                    progress = True
                    continue
                block = np.ascontiguousarray(data[idxs])
                ok = native.leo_decode_axes(block, mask[idxs].astype(np.uint8), nthreads=nthreads)
                if not ok.all():
                    raise RuntimeError("leo_decode_axes rejected a solvable axis")
                decoded = block
            else:
                if original_eds is None:
                    original_eds = eds.copy()
                order = np.argsort(~mask[idxs], axis=1, kind="stable")
                known_idx = np.sort(order[:, :k], axis=1)  # [n_axes, k]
                D = gf256.decode_matrices_batch(known_idx.astype(np.uint8), k)
                X = np.take_along_axis(data[idxs], known_idx[:, :, None], axis=1)
                decoded = _gf_matmul_axes_host(D, X, nthreads)  # [n_axes, 2k, B]
            if axis == 0:
                eds[idxs] = decoded
                avail[idxs] = True
            else:
                eds[:, idxs] = decoded.transpose(1, 0, 2)
                avail[:, idxs] = True
            progress = True
        if not progress:
            raise ValueError("repair stalled: insufficient available cells to reconstruct")

    # the completed square must be the unique codeword extending its Q0,
    # and every provided share must agree with it (rsmt2d ErrByzantine)
    orig_avail = np.asarray(_host_array(available), dtype=bool)
    provided = original_eds if original_eds is not None else eds
    native_roots = None
    if row_roots is not None or col_roots is not None:
        # one threaded pass gives the re-extension and the axis roots
        extend = native.extend_block_leopard_cpu if leopard else native.extend_block_cpu
        recomputed, native_roots, _ = extend(eds[:k, :k], nthreads=nthreads)
    elif leopard:
        recomputed = native.leo_extend_square(eds[:k, :k], nthreads=nthreads)
    else:
        recomputed = native.rs_extend_square(eds[:k, :k])
    if not np.array_equal(eds, recomputed):
        bad = np.nonzero((eds != recomputed).any(axis=2))
        raise ByzantineError(f"inconsistent erasure coding at cells {list(zip(*bad))[:8]}")
    mismatch = orig_avail & (provided != recomputed).any(axis=2)
    if mismatch.any():
        bad = np.nonzero(mismatch)
        raise ByzantineError(
            f"provided shares disagree with the reconstructed codeword at "
            f"cells {list(zip(*bad))[:8]}"
        )
    if native_roots is not None:
        # eds == recomputed here, so the pipeline's roots are the repaired
        # square's
        roots = native_roots.reshape(2, n2, 90)
        for name, axis_roots, got in (("row", row_roots, roots[0]), ("col", col_roots, roots[1])):
            if axis_roots is None:
                continue
            axis_roots = np.asarray(_host_array(axis_roots), dtype=np.uint8)
            if axis_roots.shape != got.shape:
                raise ValueError(f"{name}_roots must be {got.shape}, got {axis_roots.shape}")
            bad = np.nonzero((axis_roots != got).any(axis=1))[0]
            if len(bad):
                raise ByzantineError(
                    f"reconstructed {name} axes {bad.tolist()[:8]} do not "
                    f"match the committed NMT roots"
                )
    return eds


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
