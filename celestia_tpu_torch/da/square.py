"""Deterministic data-square construction (build for proposers, construct for
validators).

Behavioral parity with go-square's ``square.Build`` / ``square.Construct`` as
used at app/prepare_proposal.go:54 and
app/process_proposal.go:121, following the layout rules of
specs/src/specs/data_square_layout.md and ADR-020 (deterministic square
construction):

* shares ordered by namespace: TX ns < PFB ns < primary-reserved padding <
  user blobs (ns-sorted) < tail padding;
* blobs start at a multiple of their subtree width (non-interactive default
  rules, ADR-013), with namespace padding in the gaps;
* the square is the smallest power-of-two size that fits, capped by
  ``max_square_size``; Build drops overflowing txs, Construct errors.

The layout is square-size independent (subtree width depends only on blob
length), so placement indexes are stable across the fit search.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from celestia_tpu_torch.appconsts import (
    DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    DEFAULT_SUBTREE_ROOT_THRESHOLD,
    SUPPORTED_SHARE_VERSIONS,
    round_up_power_of_two,
)
from celestia_tpu_torch.da.blob import (
    Blob,
    BlobTx,
    IndexWrapper,
    unmarshal_blob_tx,
)
from celestia_tpu_torch.da.namespace import (
    Namespace,
    PAY_FOR_BLOB_NAMESPACE,
    PRIMARY_RESERVED_PADDING_NAMESPACE,
    TAIL_PADDING_NAMESPACE,
    TRANSACTION_NAMESPACE,
)
from celestia_tpu_torch.da.shares import (
    SHARE_SIZE,
    Share,
    blob_shares_array,
    padding_share,
    parse_compact_shares,
    parse_sparse_shares,
    shares_to_array,
    split_txs_into_shares,
)


def min_square_size(share_count: int) -> int:
    """Smallest power-of-two width whose square holds ``share_count`` shares."""
    if share_count <= 1:
        return 1
    ceil_sqrt = math.isqrt(share_count - 1) + 1
    return round_up_power_of_two(ceil_sqrt)


def subtree_width(share_count: int, threshold: int = DEFAULT_SUBTREE_ROOT_THRESHOLD) -> int:
    """Width of the subtree-root mountains for a blob (ADR-013).

    min(RoundUpPowerOfTwo(ceil(n / threshold)), MinSquareSize(n)).
    """
    q = -(-share_count // threshold)
    return min(round_up_power_of_two(q), min_square_size(share_count))


def next_share_index(cursor: int, blob_share_len: int, threshold: int = DEFAULT_SUBTREE_ROOT_THRESHOLD) -> int:
    """First aligned index >= cursor where a blob may start."""
    width = subtree_width(blob_share_len, threshold)
    return -(-cursor // width) * width


class Square:
    """An original (unextended) data square of k*k shares, row-major.

    Backed by EITHER a Share tuple or a uint8[k*k, 512] array; the other
    representation materializes lazily.  The builder's export writes the
    array directly (one numpy pass), so the PrepareProposal hot path
    never creates the 16k Share objects a k=128 square would need — the
    object view exists for proofs, parsers and tests that want it.
    """

    __slots__ = ("size", "_shares", "_array")

    def __init__(
        self,
        shares: Optional[Sequence[Share]] = None,
        size: int = 0,
        array: Optional[np.ndarray] = None,
    ):
        if shares is None and array is None:
            raise ValueError("Square needs shares or an array")
        if shares is not None:
            shares = tuple(shares)
            if len(shares) != size * size:
                raise ValueError(
                    f"square size {size} needs {size**2} shares, "
                    f"got {len(shares)}"
                )
        if array is not None:
            array = np.ascontiguousarray(array, dtype=np.uint8)
            if array.shape != (size * size, 512):
                raise ValueError(
                    f"square size {size} needs uint8[{size**2}, 512], "
                    f"got {array.shape}"
                )
            # freeze OUR view only — ascontiguousarray may return the
            # caller's own object, whose flags are not ours to change
            array = array.view()
            array.flags.writeable = False  # shared view; see to_array
        self.size = size
        self._shares = shares
        self._array = array

    @property
    def shares(self) -> Tuple[Share, ...]:
        if self._shares is None:
            from celestia_tpu_torch.da.shares import array_to_shares

            self._shares = tuple(array_to_shares(self._array))
        return self._shares

    def to_array(self) -> np.ndarray:
        """uint8[k*k, 512] for the device pipeline.  Read-only: the array
        is shared with the Square (copy before mutating)."""
        if self._array is None:
            arr = shares_to_array(self._shares)
            arr.flags.writeable = False
            self._array = arr
        return self._array

    def is_empty(self) -> bool:
        return self.size == 1 and self.shares[0].namespace.is_padding()


@dataclass
class _PlacedBlob:
    blob: Blob
    order: int  # position in priority (input) order — stable sort key
    start: int = -1


def validate_blob_tx_layout(blob_tx: BlobTx) -> None:
    """Layout-level BlobTx validity: namespaces usable, versions supported,
    data non-empty.  The proposer drops violators; the validator rejects the
    proposal (x/blob/types/blob_tx.go ValidateBlobTx parity, layout subset)."""
    if not blob_tx.blobs:
        raise ValueError("blob tx carries no blobs")
    for b in blob_tx.blobs:
        b.namespace.validate_for_blob()
        if b.share_version not in SUPPORTED_SHARE_VERSIONS:
            raise ValueError(f"unsupported share version {b.share_version}")
        if len(b.data) == 0:
            raise ValueError("blob data must be non-empty")


@dataclass
class Builder:
    """Incremental square builder with fit checking.

    Mirrors go-square's Builder: txs and blob-txs are appended in priority
    order; ``export`` lays out the final square and returns the block tx list
    (normal txs raw, PFB txs wrapped as :class:`IndexWrapper`).

    ``fits`` is O(1) in the common case: exact running compact-share counts
    plus lower/upper bounds on blob placement (upper bound counts each blob's
    worst-case alignment gap of subtree_width-1); the exact O(n) layout only
    runs when the bounds disagree about fitting, and is memoized by revision
    for reuse in ``export``.
    """

    max_square_size: int = DEFAULT_SQUARE_SIZE_UPPER_BOUND
    subtree_root_threshold: int = DEFAULT_SUBTREE_ROOT_THRESHOLD
    txs: List[bytes] = field(default_factory=list)
    pfb_txs: List[bytes] = field(default_factory=list)  # unwrapped PFB tx bytes
    pfb_blob_counts: List[int] = field(default_factory=list)
    blobs: List[_PlacedBlob] = field(default_factory=list)
    # kept original raw txs (normal raws + BlobTx envelopes) in append order —
    # this is the block tx list validators re-construct the square from
    block_txs: List[bytes] = field(default_factory=list)
    # running byte totals of the two compact sequences (varint-delimited units)
    _tx_seq_len: int = 0
    _pfb_seq_len: int = 0
    # blob share totals: exact sum and worst-case alignment waste
    _blob_shares: int = 0
    _blob_waste_bound: int = 0
    _revision: int = 0
    _layout_cache: Optional[Tuple[int, Tuple[int, List[_PlacedBlob], int, int]]] = None

    @staticmethod
    def _unit_len(tx_len: int) -> int:
        from celestia_tpu_torch.da.shares import _varint

        return len(_varint(tx_len)) + tx_len

    @staticmethod
    def _compact_shares_for_len(seq_len: int) -> int:
        from celestia_tpu_torch.appconsts import (
            CONTINUATION_COMPACT_SHARE_CONTENT_SIZE,
            FIRST_COMPACT_SHARE_CONTENT_SIZE,
        )

        if seq_len == 0:
            return 0
        if seq_len <= FIRST_COMPACT_SHARE_CONTENT_SIZE:
            return 1
        rem = seq_len - FIRST_COMPACT_SHARE_CONTENT_SIZE
        return 1 + -(-rem // CONTINUATION_COMPACT_SHARE_CONTENT_SIZE)

    def _layout(self) -> Tuple[int, List[_PlacedBlob], int, int]:
        """Exact layout: (total shares used, placed blobs, n_tx, n_pfb)."""
        if self._layout_cache is not None and self._layout_cache[0] == self._revision:
            return self._layout_cache[1]
        n_tx = self._compact_shares_for_len(self._tx_seq_len)
        n_pfb = self._compact_shares_for_len(self._pfb_seq_len)
        cursor = n_tx + n_pfb
        placed = sorted(self.blobs, key=lambda p: (p.blob.namespace.raw, p.order))
        out: List[_PlacedBlob] = []
        for p in placed:
            ln = p.blob.shares_needed()
            start = next_share_index(cursor, ln, self.subtree_root_threshold)
            out.append(_PlacedBlob(p.blob, p.order, start))
            cursor = start + ln
        result = (cursor, out, n_tx, n_pfb)
        self._layout_cache = (self._revision, result)
        return result

    def current_size(self) -> int:
        total, _, _, _ = self._layout()
        return min_square_size(max(total, 1))

    def fits(self) -> bool:
        max_shares = self.max_square_size * self.max_square_size
        reserved = self._compact_shares_for_len(
            self._tx_seq_len
        ) + self._compact_shares_for_len(self._pfb_seq_len)
        lower = reserved + self._blob_shares
        if lower > max_shares:
            return False
        upper = reserved + self._blob_shares + self._blob_waste_bound
        if upper <= max_shares:
            return True
        total, _, _, _ = self._layout()
        return total <= max_shares

    def append_tx(self, tx: bytes) -> bool:
        """Tentatively add a normal tx; False (and rollback) if it overflows."""
        self.txs.append(tx)
        self._tx_seq_len += self._unit_len(len(tx))
        self._revision += 1
        if not self.fits():
            self.txs.pop()
            self._tx_seq_len -= self._unit_len(len(tx))
            self._revision += 1
            return False
        self.block_txs.append(tx)
        return True

    def append_blob_tx(self, blob_tx: BlobTx, raw: Optional[bytes] = None) -> bool:
        """Tentatively add a BlobTx; False (and rollback) if it overflows.

        Raises ValueError on an invalid BlobTx (caller decides drop vs reject).
        ``raw`` is the marshalled envelope recorded in the block tx list
        (re-marshalled if omitted).
        """
        validate_blob_tx_layout(blob_tx)
        order0 = len(self.blobs)
        wrapper_len = IndexWrapper.marshalled_size(len(blob_tx.tx), len(blob_tx.blobs))
        d_pfb = self._unit_len(wrapper_len)
        d_shares = 0
        d_waste = 0
        for b in blob_tx.blobs:
            n = b.shares_needed()
            d_shares += n
            d_waste += subtree_width(n, self.subtree_root_threshold) - 1
        self.pfb_txs.append(blob_tx.tx)
        self.pfb_blob_counts.append(len(blob_tx.blobs))
        for b in blob_tx.blobs:
            self.blobs.append(_PlacedBlob(b, len(self.blobs)))
        self._pfb_seq_len += d_pfb
        self._blob_shares += d_shares
        self._blob_waste_bound += d_waste
        self._revision += 1
        if not self.fits():
            self.pfb_txs.pop()
            self.pfb_blob_counts.pop()
            del self.blobs[order0:]
            self._pfb_seq_len -= d_pfb
            self._blob_shares -= d_shares
            self._blob_waste_bound -= d_waste
            self._revision += 1
            return False
        self.block_txs.append(raw if raw is not None else blob_tx.marshal())
        return True

    def export(self) -> Tuple[Square, List[bytes], List[IndexWrapper]]:
        """Lay out the final square.

        Returns ``(square, block_txs, wrappers)``: the block tx list is the
        kept *original* raw txs (normal txs and BlobTx envelopes, priority
        order) — feeding it back through :func:`construct` reproduces the
        square byte-for-byte on the validator side; ``wrappers`` are the
        share-index-annotated PFB txs as written into the square's
        PAY_FOR_BLOB namespace (used at execution time).
        """
        total, placed, n_tx, n_pfb = self._layout()
        size = min_square_size(max(total, 1))
        if size > self.max_square_size:
            raise ValueError(
                f"square overflow: need size {size} > max {self.max_square_size}"
            )

        # Share indexes per PFB, in pfb_txs order.
        start_by_order = {p.order: p.start for p in placed}
        wrappers: List[IndexWrapper] = []
        order = 0
        for tx, n_blobs in zip(self.pfb_txs, self.pfb_blob_counts):
            idxs = tuple(start_by_order[order + i] for i in range(n_blobs))
            wrappers.append(IndexWrapper(tx, idxs))
            order += n_blobs

        # One numpy pass straight into the square tensor: compact shares
        # (small count) via the Share path, blob sequences via the
        # vectorized splitter, padding by broadcast — no per-share Python
        # objects (16k of them at k=128 dominated the build phase).
        compact: List[Share] = []
        if self.txs:
            compact.extend(split_txs_into_shares(TRANSACTION_NAMESPACE, self.txs))
        if wrappers:
            compact.extend(
                split_txs_into_shares(
                    PAY_FOR_BLOB_NAMESPACE, [w.marshal() for w in wrappers]
                )
            )
        assert len(compact) == n_tx + n_pfb, "compact share count drifted from layout"

        arr = np.zeros((size * size, SHARE_SIZE), dtype=np.uint8)
        if compact:
            arr[: len(compact)] = np.frombuffer(
                b"".join(s.raw for s in compact), dtype=np.uint8
            ).reshape(len(compact), SHARE_SIZE)
        cursor = len(compact)
        prev_ns: Optional[Namespace] = None
        for p in placed:
            if p.start > cursor:
                pad_ns = (
                    prev_ns
                    if prev_ns is not None
                    else PRIMARY_RESERVED_PADDING_NAMESPACE
                )
                arr[cursor : p.start] = np.frombuffer(
                    padding_share(pad_ns).raw, dtype=np.uint8
                )
            blob_arr = blob_shares_array(
                p.blob.namespace, p.blob.data, p.blob.share_version
            )
            arr[p.start : p.start + blob_arr.shape[0]] = blob_arr
            cursor = p.start + blob_arr.shape[0]
            prev_ns = p.blob.namespace
        if cursor < size * size:
            arr[cursor:] = np.frombuffer(
                padding_share(TAIL_PADDING_NAMESPACE).raw, dtype=np.uint8
            )

        return Square(size=size, array=arr), list(self.block_txs), wrappers


def build(
    txs: Sequence[bytes],
    max_square_size: int = DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    subtree_root_threshold: int = DEFAULT_SUBTREE_ROOT_THRESHOLD,
) -> Tuple[Square, List[bytes], List[IndexWrapper]]:
    """Proposer path (app/prepare_proposal.go:54): lay out as many priority-
    ordered txs as fit; overflowing txs are dropped, never reordered."""
    b = Builder(max_square_size, subtree_root_threshold)
    for raw in txs:
        btx = unmarshal_blob_tx(raw)
        if btx is not None:
            try:
                b.append_blob_tx(btx, raw=raw)
            except ValueError:
                continue  # invalid BlobTx: proposer drops it
        else:
            b.append_tx(raw)
    return b.export()


def construct(
    txs: Sequence[bytes],
    max_square_size: int = DEFAULT_SQUARE_SIZE_UPPER_BOUND,
    subtree_root_threshold: int = DEFAULT_SUBTREE_ROOT_THRESHOLD,
) -> Tuple[Square, List[bytes], List[IndexWrapper]]:
    """Validator path (app/process_proposal.go:121): re-lay out the proposed
    txs strictly; any overflow is an error (proposal rejected)."""
    b = Builder(max_square_size, subtree_root_threshold)
    for raw in txs:
        btx = unmarshal_blob_tx(raw)
        if btx is not None:
            ok = b.append_blob_tx(btx, raw=raw)
        else:
            ok = b.append_tx(raw)
        if not ok:
            raise ValueError("square construction overflow: proposal exceeds max square size")
    return b.export()


def extract_txs_and_blobs(
    square: Square,
) -> Tuple[List[bytes], List[bytes], List[Tuple[Namespace, bytes]]]:
    """Parse a square back into (normal txs, wrapped PFB txs, blobs)."""
    tx_shares = [s for s in square.shares if s.namespace.raw == TRANSACTION_NAMESPACE.raw]
    pfb_shares = [s for s in square.shares if s.namespace.raw == PAY_FOR_BLOB_NAMESPACE.raw]
    blob_shares = [
        s
        for s in square.shares
        if s.namespace.is_usable_by_users()
    ]
    txs = parse_compact_shares(tx_shares) if tx_shares else []
    pfbs = parse_compact_shares(pfb_shares) if pfb_shares else []
    blobs = parse_sparse_shares(blob_shares)
    return txs, pfbs, blobs
