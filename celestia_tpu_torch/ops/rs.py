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
  (``csrc/rs_extend.cu``): GF(256) products by log/antilog tables with
  the codec's encode matrix E = ``gf256.encode_matrix(k, codec)``.
* On a CPU tensor it runs :func:`_extend`, the JAX package's formulation:
  the GF(256) map lifted to GF(2), ``(G @ bits) & 1`` with
  G = ``gf256.encode_matrix_bits(k, codec)`` (see :func:`matmul_gf2`).
Both give the same bytes, because G is E lifted bit by bit (gf256.py
``bit_expand_matrix``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from celestia_tpu_torch import kernels
from celestia_tpu_torch.appconsts import SHARE_SIZE, is_power_of_two
from celestia_tpu_torch.ops import gf256


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


def extend_cuda(square: torch.Tensor, codec: str) -> torch.Tensor:
    """Launch K5 ``rs_extend`` on a square on the card with ``codec``."""
    k = _check_square(square, SHARE_SIZE)
    kernels.check_cuda_tensor(square, "square")
    E, exp, log = _kernel_constants(k, codec, str(square.device))
    eds = torch.empty((2 * k, 2 * k, SHARE_SIZE), dtype=torch.uint8, device=square.device)
    kernels.launch(
        "rs_extend", square.device, square.data_ptr(), eds.data_ptr(),
        E.data_ptr(), exp.data_ptr(), log.data_ptr(), k,
        launches=2,  # Q1+Q2, then Q3 (Q0 is a 2D device copy)
    )
    return eds


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
