"""Extended data square + DataAvailabilityHeader: the block-extension hot path.

Counterpart of ``celestia_tpu/da/dah.py`` with behavioral parity with
pkg/da/data_availability_header.go (ExtendShares :65-75,
NewDataAvailabilityHeader :44-63, Hash :92-108, ValidateBasic :134-177,
MinDataAvailabilityHeader :179) and app/extend_block.go:14-32.

:func:`extend_and_header` goes through the device-resident plane
(da/device_plane.py) on every device, as the JAX package does with an
accelerator attached (its dah.py:540): the square is uploaded once, RS
extension (K5) -> NMT leaf digests (K2) -> every NMT level in one launch
(K3) -> the root tree from the axis roots in one launch (K4) run on the current
stream with no host sync between them, only the 4k axis roots and the
32-byte data root come back to the host, and the EDS and every level stay
on the card, cached under the data root for DAS serving.  With
``device="cpu"`` the same composition runs the plain PyTorch twins.

An EDS on the card is fetched whole only when :attr:`ExtendedDataSquare.shares`
is read; :meth:`ExtendedDataSquare.rows` copies only the rows asked for.
:func:`full_eds_fetches` counts the whole-square fetches, so a run can show
that a serving path never made one.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from celestia_tpu_torch.appconsts import (
    DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    SHARE_SIZE,
    is_power_of_two,
)
from celestia_tpu_torch.da.square import Square
from celestia_tpu_torch.ops import gf256
from celestia_tpu_torch.ops import nmt as nmt_ops
from celestia_tpu_torch.ops import rs
from celestia_tpu_torch.utils.device import resolve_device

NMT_ROOT_SIZE = nmt_ops.NMT_DIGEST_SIZE  # 90

_fetch_lock = threading.Lock()
_full_fetches = 0  # guarded by _fetch_lock


def full_eds_fetches() -> int:
    """Whole EDSs copied from a device to the host in this process."""
    with _fetch_lock:
        return _full_fetches


def reset_full_eds_fetches() -> None:
    global _full_fetches
    with _fetch_lock:
        _full_fetches = 0


def _writable(arr) -> np.ndarray:
    """A contiguous uint8 array torch may wrap: read-only arrays (a Square's
    frozen view) are copied, since torch tensors have no read-only flag."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    return arr if arr.flags.writeable else arr.copy()


class ExtendedDataSquare:
    """A 2k x 2k erasure-extended share square (rsmt2d.ExtendedDataSquare parity).

    Holds the share tensor uint8[2k, 2k, 512] (on the card or the CPU); Q0
    (top-left k x k) is the original data square.  Accepts a numpy array
    (for instance the JAX package's EDS) or a torch tensor; a tensor on the
    card stays there until :attr:`shares` is read.
    """

    def __init__(self, shares):
        if isinstance(shares, torch.Tensor):
            if shares.dtype != torch.uint8:
                raise ValueError(f"EDS shares must be uint8, got {shares.dtype}")
            tensor = shares
        else:
            tensor = torch.from_numpy(_writable(shares))
        n = tensor.shape[0]
        if (
            tensor.dim() != 3
            or tuple(tensor.shape) != (n, n, SHARE_SIZE)
            or n % 2
            or not is_power_of_two(n // 2)
        ):
            raise ValueError(f"invalid EDS shape {tuple(tensor.shape)}")
        self._tensor = tensor
        self._shares = tensor.numpy() if tensor.device.type == "cpu" else None

    @property
    def tensor(self) -> torch.Tensor:
        """The share tensor where it lies (no transfer)."""
        return self._tensor

    @property
    def shares(self) -> np.ndarray:
        """All shares on the host (a whole-square copy from a device, once)."""
        global _full_fetches
        if self._shares is None:
            self._shares = self._tensor.cpu().numpy()
            with _fetch_lock:
                _full_fetches += 1
        return self._shares

    def rows(self, idxs) -> np.ndarray:
        """Rows ``idxs`` on the host, uint8[len(idxs), 2k, 512]: from a
        device only those rows are copied, in one transfer."""
        idxs = [int(r) for r in idxs]
        if self._shares is not None:
            return self._shares[idxs]
        index = torch.tensor(idxs, dtype=torch.long, device=self._tensor.device)
        return self._tensor.index_select(0, index).cpu().numpy()

    @property
    def width(self) -> int:
        # shape is metadata — never forces a device->host transfer
        return self._tensor.shape[0]

    @property
    def square_size(self) -> int:
        """Original (unextended) square width k."""
        return self.width // 2

    def row(self, r: int) -> np.ndarray:
        return self.rows([r])[0]

    def col(self, c: int) -> np.ndarray:
        return self.shares[:, c]

    def quadrant(self, q: int) -> np.ndarray:
        k = self.square_size
        r, c = divmod(q, 2)
        return self.shares[r * k : (r + 1) * k, c * k : (c + 1) * k]

    def flattened_original(self) -> np.ndarray:
        """Q0 as uint8[k*k, 512] (row-major original shares)."""
        k = self.square_size
        return self.quadrant(0).reshape(k * k, SHARE_SIZE)


@dataclass(frozen=True)
class DataAvailabilityHeader:
    """Row/column NMT roots + memoized hash (= the block's data root)."""

    row_roots: Tuple[bytes, ...]
    col_roots: Tuple[bytes, ...]
    _hash: bytes

    @property
    def hash(self) -> bytes:
        return self._hash

    @property
    def square_size(self) -> int:
        return len(self.row_roots) // 2

    def validate_basic(self) -> None:
        """dah ValidateBasic parity: extended square bounds + root shapes +
        hash consistency (data_availability_header.go:134-177)."""
        n = len(self.row_roots)
        if n == 0 or n != len(self.col_roots):
            raise ValueError("row/col root counts must match and be non-empty")
        k = n // 2
        if n % 2 or not is_power_of_two(k):
            raise ValueError(f"extended square width {n} must be 2 * power-of-two")
        if k > DEFAULT_SQUARE_SIZE_UPPER_BOUND:
            raise ValueError(
                f"square size {k} exceeds upper bound {DEFAULT_SQUARE_SIZE_UPPER_BOUND}"
            )
        for r in (*self.row_roots, *self.col_roots):
            if len(r) != NMT_ROOT_SIZE:
                raise ValueError(f"NMT root must be {NMT_ROOT_SIZE} bytes")
        if self.compute_hash(self.row_roots, self.col_roots) != self._hash:
            raise ValueError("DAH hash does not match its roots")

    @staticmethod
    def compute_hash(row_roots, col_roots) -> bytes:
        return nmt_ops.rfc6962_root_np(list(row_roots) + list(col_roots)).tobytes()

    def to_bytes(self) -> bytes:
        """Deterministic wire form: counts + concatenated roots."""
        out = bytearray()
        out += len(self.row_roots).to_bytes(4, "big")
        for r in self.row_roots:
            out += r
        out += len(self.col_roots).to_bytes(4, "big")
        for c in self.col_roots:
            out += c
        return bytes(out)

    @classmethod
    def from_bytes(cls, raw: bytes) -> "DataAvailabilityHeader":
        n_rows = int.from_bytes(raw[:4], "big")
        pos = 4
        rows = []
        for _ in range(n_rows):
            rows.append(raw[pos : pos + NMT_ROOT_SIZE])
            pos += NMT_ROOT_SIZE
        n_cols = int.from_bytes(raw[pos : pos + 4], "big")
        pos += 4
        cols = []
        for _ in range(n_cols):
            cols.append(raw[pos : pos + NMT_ROOT_SIZE])
            pos += NMT_ROOT_SIZE
        if pos != len(raw):
            raise ValueError("trailing bytes in DAH encoding")
        dah = cls(tuple(rows), tuple(cols), cls.compute_hash(rows, cols))
        dah.validate_basic()
        return dah


def _square_tensor(square, device: torch.device) -> torch.Tensor:
    """One upload of a host square (numpy, uint8[k, k, 512]) to ``device``."""
    arr = _writable(square)
    k = arr.shape[0]
    if arr.shape != (k, k, SHARE_SIZE) or not is_power_of_two(k):
        raise ValueError(
            f"square must be (k, k, {SHARE_SIZE}) with k a power of two, got {arr.shape}"
        )
    return torch.from_numpy(arr).to(device)


def extend_shares(shares: np.ndarray, device=None) -> ExtendedDataSquare:
    """da.ExtendShares parity: uint8[n, 512] (n a perfect power-of-4 count)
    -> ExtendedDataSquare."""
    dev = resolve_device(device)
    shares = np.asarray(shares, dtype=np.uint8)
    n = shares.shape[0]
    k = int(round(n**0.5))
    if k * k != n or not is_power_of_two(k):
        raise ValueError(f"share count {n} must be a square of a power of two")
    square = _square_tensor(shares.reshape(k, k, SHARE_SIZE), dev)
    return ExtendedDataSquare(rs.extend_square(square))


def extend_and_header(
    square: np.ndarray, device=None
) -> Tuple[ExtendedDataSquare, DataAvailabilityHeader]:
    """The fused hot path: original square uint8[k,k,512] -> (EDS, DAH),
    through the device-resident plane (the block stays cached on its
    device for DAS serving).

    ``device=None`` runs on the card and raises when there is none;
    ``device="cpu"`` runs the plain PyTorch twins.  The devprof brackets
    are the plane's (``extend_levels``); JAX's ``extend_and_roots`` bracket
    (:585) sits on its non-plane leg, which the port does not have."""
    from celestia_tpu_torch.da import device_plane

    return device_plane.extend_and_header(square, device=device)


def new_data_availability_header(
    eds: ExtendedDataSquare, device=None
) -> DataAvailabilityHeader:
    """da.NewDataAvailabilityHeader parity: roots + hash from an existing EDS."""
    dev = resolve_device(device)
    roots = nmt_ops.eds_nmt_roots_device(eds.tensor.to(dev).contiguous()).cpu().numpy()
    rows = tuple(roots[0, i].tobytes() for i in range(roots.shape[1]))
    cols = tuple(roots[1, i].tobytes() for i in range(roots.shape[1]))
    return DataAvailabilityHeader(
        rows, cols, DataAvailabilityHeader.compute_hash(rows, cols)
    )


def extend_block(
    square: Square, device=None
) -> Tuple[ExtendedDataSquare, DataAvailabilityHeader]:
    """app.ExtendBlock parity (extend_block.go:14-26): square -> (EDS, DAH)."""
    k = square.size
    arr = square.to_array().reshape(k, k, SHARE_SIZE)
    return extend_and_header(arr, device=device)


def data_roots_batched(squares, device=None) -> Tuple[np.ndarray, Tuple[bytes, ...]]:
    """Catch-up validation of a batch of same-size blocks (the JAX
    package's ``node/network.py:396-417``): squares uint8[n, k, k, 512] ->
    (axis roots uint8[n, 2, 2k, 90], the n data roots).

    On the card: one K5b launch pair extends the batch, one K2 launch and
    one K3 launch hash all n * 4k trees to their roots, then one K4 launch
    gives every block's data root there (the JAX caller hashes the roots on the host);
    roots and data roots come back in one copy.  A numpy batch is uploaded
    to ``device`` (None: the card); a tensor stays on its device."""
    if isinstance(squares, torch.Tensor):
        batch = squares
    else:
        batch = torch.from_numpy(_writable(squares)).to(resolve_device(device))
    eds = rs.extend_squares_batched(batch)
    roots = nmt_ops.eds_nmt_roots(eds)  # (n, 2, 2k, 90)
    n, _, n2, _ = roots.shape
    data = nmt_ops.rfc6962_root_pow2(roots.reshape(n, 2 * n2, NMT_ROOT_SIZE))  # (n, 32)
    host = torch.cat([roots.reshape(-1), data.reshape(-1)]).cpu().numpy()
    split = roots.numel()
    return (
        host[:split].reshape(tuple(roots.shape)),
        tuple(host[split:].reshape(n, 32)[i].tobytes() for i in range(n)),
    )


# codec -> min DAH; the lock serializes the first computation per codec so
# concurrent callers neither race it nor the insert
_min_dah_lock = threading.Lock()
_min_dah: Dict[str, DataAvailabilityHeader] = {}


def min_data_availability_header(device=None) -> DataAvailabilityHeader:
    """DAH of the minimal (empty) square: one tail-padding share
    (data_availability_header.go:179), cached per codec."""
    dev = resolve_device(device)
    codec = gf256.active_codec()
    with _min_dah_lock:
        hit = _min_dah.get(codec)
        if hit is None:
            from celestia_tpu_torch.da.square import build

            square, _, _ = build([])
            _, hit = extend_block(square, device=dev)
            _min_dah[codec] = hit
        return hit
